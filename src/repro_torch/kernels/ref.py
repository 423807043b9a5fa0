"""Plain-PyTorch versions of the port's CUDA kernels.

They are the semantic ground truth for ``kernels/fused_update.py``,
``kernels/lowrank_update.py``, ``kernels/srsi_matmul.py``,
``kernels/sketch_update.py``, ``kernels/flash_attention.py`` and
``kernels/ssd_chunk.py``: the dispatch in ``kernels/ops.py`` runs them
for tensors that lie on the CPU, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  The update and matmul functions take
arbitrary leading batch dims; their reductions are per matrix (over the
trailing two axes).

``1 - b2`` is rounded as the JAX function each one copies rounds it:
``fused_precond`` and ``sketch_update`` subtract in float32
(:func:`f32_one_minus`); ``lowrank_update`` and ``one_sided_fold`` take the
Python double ``1.0 - b2``, which PyTorch, like JAX, rounds to float32
once.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def f32_one_minus(b: float) -> float:
    """``1 - b`` rounded in float32, returned as an exactly representable
    Python float: ImplicitV.materialize subtracts a float32 ``b2``, and the
    fused pass 1 must produce the same coefficient."""
    return float(np.float32(1.0) - np.float32(b))


def f32(x: float) -> float:
    return float(np.float32(x))


def lowrank_update(q: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                   b2: float, eps: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The single-pass Adapprox update:

        V    = b2 * max(Q @ U^T, 0) + (1 - b2) * G^2
        out  = G / (sqrt(V) + eps)
        vfro = ||V||_F^2

    q: (..., m, r), u: (..., n, r), g: (..., m, n).  Returns ``(out (...,
    m, n) f32, vfro (...,) f32)``.
    """
    g32 = g.float()
    v = (b2 * torch.clamp_min(q.float() @ u.float().transpose(-1, -2), 0.0)
         + (1.0 - b2) * g32 * g32)
    out = g32 / (torch.sqrt(v) + eps)
    return out, torch.sum(v * v, dim=(-2, -1))


def sq_matmul(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = (G * G) @ X.   g: (..., m, n), x: (..., n, s) -> (..., m, s)."""
    g32 = g.float()
    return (g32 * g32) @ x.float()


def sq_matmul_t(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Z = (G * G)^T @ Y.   g: (..., m, n), y: (..., m, s) -> (..., n, s)."""
    g32 = g.float()
    return (g32 * g32).transpose(-1, -2) @ y.float()


def one_sided_fold(u: torch.Tensor, q: torch.Tensor, g: torch.Tensor,
                   b2: float, col_mask: torch.Tensor | None = None,
                   reduce=None) -> torch.Tensor:
    """The amortized-refresh fold under a frozen basis Q:

        U_t = mask * (b2 * U_{t-1} + (1 - b2) * (G^2)^T @ Q)

    u: (..., n, r), q: (..., m, r), g: (..., m, n), col_mask: (..., r) or
    None; ``reduce`` sums the product over the ranks holding the other
    row blocks of a row-split G (on a mesh).  Returns (..., n, r) f32.
    """
    y = sq_matmul_t(g, q)
    folded = b2 * u.float() + (1.0 - b2) * (y if reduce is None
                                            else reduce(y))
    if col_mask is not None:
        folded = folded * col_mask.unsqueeze(-2)
    return folded


def fused_precond(q: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                  b2: float, eps: float, m1: torch.Tensor | None = None,
                  with_vfro: bool = True, with_fold: bool = False):
    """Pass 1 of the fused two-pass update:

        V     = b2 * max(Q @ U^T, 0) + (1 - b2) * G^2      (never stored)
        u_hat = G / (sqrt(V) + eps)                        (unclipped)
        vfro  = ||V||_F^2              [with_vfro]
        usq   = sum(u_hat^2)
        m1dot = sum(m1 * u_hat), m1sq = sum(m1^2)          [m1 given]
        yfold = (G^2)^T @ Q            [with_fold]

    q: (..., m, r), u: (..., n, r), g / m1: (..., m, n).  Returns
    ``(u_hat, vfro, usq, m1dot, m1sq, yfold)`` with the sums of shape
    (...,); absent outputs are None.
    """
    g32 = g.float()
    q32 = q.float()
    b2f = f32(b2)
    low = q32 @ u.float().transpose(-1, -2)
    v = b2f * torch.clamp_min(low, 0.0) + f32_one_minus(b2) * g32 * g32
    out = g32 / (torch.sqrt(v) + eps)
    dims = (-2, -1)
    vfro = torch.sum(v * v, dim=dims) if with_vfro else None
    usq = torch.sum(torch.square(out), dim=dims)
    yfold = sq_matmul_t(g32, q32) if with_fold else None
    if m1 is None:
        return out, vfro, usq, None, None, yfold
    m1f = m1.float()
    return (out, vfro, usq, torch.sum(m1f * out, dim=dims),
            torch.sum(torch.square(m1f), dim=dims), yfold)


def fused_apply(u_hat: torch.Tensor, m1: torch.Tensor | None,
                denom: torch.Tensor, b1: float,
                out_scale: torch.Tensor, store_scale: torch.Tensor):
    """Pass 2: clip by division (not reciprocal-multiply, for parity with
    the unfused path), update-EMA first moment, guidance scales:

        u_c    = u_hat / denom
        acc    = b1 * m1 + (1 - b1) * u_c
        m_out  = acc * out_scale
        m1_new = acc * store_scale

    ``denom`` / ``out_scale`` / ``store_scale`` have the batch shape of
    ``u_hat`` without its trailing two axes.  With ``m1`` None (b1 = 0)
    the EMA collapses to ``m_out = u_c * out_scale``.  Returns
    ``(m_out, m1_new)``.
    """
    bc = lambda s: s.reshape(s.shape + (1, 1))
    u_c = u_hat / bc(denom)
    if m1 is None:
        return u_c * bc(out_scale), None
    acc = b1 * m1 + (1.0 - b1) * u_c
    return acc * bc(out_scale), acc * bc(store_scale)


def sketch_update(table: torch.Tensor, g: torch.Tensor, idx: torch.Tensor,
                  b2: float, reduce=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Count-min second-moment EMA update + per-row query:

        S_t[j, b, :] = b2 * S_{t-1}[j, b, :]
                       + (1 - b2) * sum_{i : idx[j, i] = b} G[i, :]^2
        vhat[i, :]   = min_j S_t[j, idx[j, i], :]

    table: (depth, width, d) f32, g: (rows, d) any float, idx: (depth,
    rows) integer bucket per row per depth.  Returns ``(S_t (depth, width,
    d) f32, vhat (rows, d) f32)``.  ``b2`` and ``1 - b2`` are float32, as
    in the JAX package's ``ref.sketch_update``.  ``reduce`` adds the
    per-bucket sums of the ranks holding the other row blocks of a
    row-split g (on a mesh) before the EMA.
    """
    g32 = g.float()
    gsq = g32 * g32
    tab = table.float()
    width = tab.shape[1]
    idx = idx.long()
    sums = torch.stack([
        torch.zeros((width, gsq.shape[1]), dtype=torch.float32,
                    device=gsq.device).index_add_(0, idx[j], gsq)
        for j in range(tab.shape[0])])
    if reduce is not None:
        sums = reduce(sums)
    new = f32(b2) * tab + f32_one_minus(b2) * sums
    gathered = torch.stack([new[j][idx[j]] for j in range(new.shape[0])])
    return new, torch.amin(gathered, dim=0)


NEG_INF = -1e30
# The JAX package's K_CHUNK: keys per step of the plain forward's online
# softmax, as in its ``_sdpa_chunked`` (it bounds the score block held at
# once to (Sq, 1024) a head), and the divisor of Sk in the model's
# dispatch (``models/attention.py``).
K_CHUNK = 1024


def attn_scale(dh: int) -> float:
    """``1 / sqrt(dh)`` as the JAX package's ``_sdpa_chunked`` rounds it:
    the float32 square root, then a float32 division."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _gqa(q: torch.Tensor, k: torch.Tensor) -> tuple[int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or q.shape[-1] != k.shape[-1] \
            or q.shape[0] != k.shape[0] or q.shape[2] % k.shape[2]:
        raise ValueError(f"expected q (B, Sq, H, dh) and k / v (B, Sk, KV, "
                         f"dh) with H % KV == 0, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, _, h, dh = q.shape
    kv = k.shape[2]
    return kv, h // kv, dh


def _scores(qs, k, causal: bool, k0: int = 0):
    """Scaled scores of fp32 ``qs`` (B, Sq, KV, G, dh) against keys
    ``k0 ..`` of ``k`` (B, Sc, KV, dh), (B, KV, G, Sq, Sc) fp32, with
    ``NEG_INF`` where ``k_pos > q_pos`` (both counted from 0) if causal."""
    s = torch.einsum("bqkgh,bskh->bkgqs", qs, k.float())
    if causal:
        q_pos = torch.arange(qs.shape[1], device=qs.device)
        k_pos = k0 + torch.arange(k.shape[1], device=qs.device)
        s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
    return s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True):
    """Exact attention by the running (max, sum, acc) online softmax of
    the JAX package's ``_sdpa_chunked``, over key chunks of ``K_CHUNK``:

        s    = (fp32(q) * scale) k^T, scale = attn_scale(dh);
               NEG_INF where k_pos > q_pos (causal)
        m'   = max(m, rowmax s);  p = exp(s - m');  corr = exp(m - m')
        l'   = l corr + rowsum p;  acc' = acc corr + p v     (p in fp32)
        out  = acc / max(l, 1e-30)  in v's dtype;  lse = m + log l  (fp32)

    q: (B, Sq, H, dh), k / v: (B, Sk, KV, dh); query head h reads KV head
    ``h // (H // KV)`` (no copy of k or v).  Returns ``(out (B, Sq, H,
    dh), lse (B, H, Sq) fp32)``."""
    kv, groups, dh = _gqa(q, k)
    b, sq, h, _ = q.shape
    scale = attn_scale(dh)
    qs = q.reshape(b, sq, kv, groups, dh).float() * scale
    m = torch.full((b, kv, groups, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, kv, groups, sq), device=q.device)
    acc = torch.zeros((b, kv, groups, sq, dh), device=q.device)
    for k0 in range(0, k.shape[1], K_CHUNK):
        s = _scores(qs, k[:, k0:k0 + K_CHUNK], causal, k0)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p, v[:, k0:k0 + K_CHUNK].float())
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(v.dtype)
    return out, (m + torch.log(l)).reshape(b, h, sq)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """The recompute backward of :func:`flash_attention`, in fp32:

        D  = rowsum(dO * O);   P = exp(s - lse)   (s as in the forward)
        dV = P^T dO;  dP = dO V^T;  dS = P * (dP - D)
        dQ = dS K * scale;  dK = dS^T (fp32(Q) * scale)

    dK and dV summed over each KV head's group of query heads.  Shapes as
    :func:`flash_attention`, ``o`` / ``do`` like q, ``lse`` (B, H, Sq).
    Returns ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    kv, groups, dh = _gqa(q, k)
    b, sq, h, _ = q.shape
    scale = attn_scale(dh)
    qs = q.reshape(b, sq, kv, groups, dh).float() * scale
    do32 = do.reshape(b, sq, kv, groups, dh).float()
    d = (do32 * o.reshape(b, sq, kv, groups, dh).float()).sum(dim=-1)
    p = torch.exp(_scores(qs, k, causal)
                  - lse.reshape(b, kv, groups, sq)[..., None])
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, do32)
    dp = torch.einsum("bqkgh,bskh->bkgqs", do32, v.float())
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qs)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the SSD's accumulation type: fp32 for fp32 and bf16, fp64
    for fp64 (gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def expand_groups(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N), as the JAX model's ``_expand_groups``
    (``jnp.repeat`` on the group axis): head h reads group
    ``h // (H // G)``."""
    return torch.repeat_interleave(t, n_heads // t.shape[2], dim=2)


def _ssd_chunks(x, b, c, dt, cums, h_in):
    """The inputs of :func:`ssd_chunk` cut into chunks, in the
    accumulation type, with the decay ``L`` and ``CB = C (dt B)^T``:
    x (Bt, nc, q, H, P); b, c, bx = dt b (Bt, nc, q, H, N); dt, cums (Bt,
    nc, q, H); L, cb (Bt, nc, q_i, q_j, H)."""
    bt, s, h, p = x.shape
    g, n = b.shape[2:]
    nc = h_in.shape[1]
    q = s // nc
    if (s % nc or h % g or tuple(c.shape) != tuple(b.shape)
            or b.shape[:2] != x.shape[:2] or tuple(dt.shape) != (bt, s, h)
            or tuple(cums.shape) != (bt, s, h)
            or tuple(h_in.shape) != (bt, nc, h, n, p)):
        raise ValueError(
            f"ssd_chunk: expected x (B, S, H, P), b / c (B, S, G, N), dt / "
            f"cums (B, S, H), h_in (B, nc, H, N, P) with nc | S and G | H; "
            f"got x {tuple(x.shape)}, b {tuple(b.shape)}, c "
            f"{tuple(c.shape)}, dt {tuple(dt.shape)}, cums "
            f"{tuple(cums.shape)}, h_in {tuple(h_in.shape)}")
    chunked = lambda t, *tail: t.reshape((bt, nc, q) + tail)
    xc = chunked(_acc(x), h, p)
    bc = chunked(expand_groups(_acc(b), h), h, n)
    cc = chunked(expand_groups(_acc(c), h), h, n)
    dtc, cm = chunked(_acc(dt), h), chunked(_acc(cums), h)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    diff = cm[:, :, :, None, :] - cm[:, :, None, :, :]
    # masked before the exp: above the diagonal diff > 0 grows with the
    # chunk and overflows, and exp's backward would meet inf there
    ldec = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                 torch.full((), -math.inf, dtype=diff.dtype,
                                            device=diff.device)))
    bx = bc * dtc[..., None]
    cb = torch.einsum("zcihn,zcjhn->zcijh", cc, bx)
    return xc, bc, cc, dtc, cm, ldec, bx, cb


def ssd_chunk(x, b, c, dt, cums, h_in, d_skip):
    """The SSD intra-chunk block with the skip term, per chunk and head:

        Y = (C (dt B)^T * L) X + exp(cums) * (C h_in) + d_skip X
        L[i, j] = exp(cums_i - cums_j) for j <= i, else 0

    x (B, S, H, P); b, c (B, S, G, N), head h reading group h // (H / G);
    dt, cums (B, S, H) with cums the within-chunk cumsum of dt a; h_in (B,
    nc, H, N, P) the state entering each chunk; d_skip (H,).  The chunk
    length is S / nc.  Returns y (B, S, H, P) in the accumulation type
    (fp32 for fp32 or bf16 inputs)."""
    xc, _, cc, _, cm, ldec, _, cb = _ssd_chunks(x, b, c, dt, cums, h_in)
    y = (torch.einsum("zcijh,zcjhp->zcihp", cb * ldec, xc)
         + torch.exp(cm)[..., None] * torch.einsum(
             "zcihn,zchnp->zcihp", cc, _acc(h_in))
         + _acc(d_skip)[:, None] * xc)
    return y.reshape(x.shape)


def ssd_chunk_bwd(x, b, c, dt, cums, h_in, d_skip, dy):
    """The backward of :func:`ssd_chunk`, from its inputs and dY (B, S, H,
    P), with M = CB * L, dM = dY X^T, dS = dM * L, T = dS * CB:

        dX     = M^T dY + d_skip dY
        d(dtB) = dS^T C            -> dB = dt d(dtB), ddt = sum_n d(dtB) B
        dC     = dS (dt B) + exp(cums) (dY h_in^T)
        dcums  = rowsum T - colsum T + exp(cums) sum_n C (dY h_in^T)
        dh_in  = C^T (exp(cums) dY);   dd_skip = sum dY X

    dB and dC summed over each group's heads.  Returns ``(dx, db, dc, ddt,
    dcums, dh_in, dd_skip)`` in the dtypes of the inputs."""
    bt, s, h, p = x.shape
    g, n = b.shape[2:]
    xc, bc, cc, dtc, cm, ldec, bx, cb = _ssd_chunks(x, b, c, dt, cums, h_in)
    dyc = _acc(dy).reshape(xc.shape)
    hin = _acc(h_in)
    e = torch.exp(cm)
    dm = torch.einsum("zcihp,zcjhp->zcijh", dyc, xc)
    ds = dm * ldec
    t = ds * cb
    dx = (torch.einsum("zcijh,zcihp->zcjhp", cb * ldec, dyc)
          + _acc(d_skip)[:, None] * dyc)
    dbx = torch.einsum("zcijh,zcihn->zcjhn", ds, cc)
    z = torch.einsum("zcihp,zchnp->zcihn", dyc, hin)
    dc = torch.einsum("zcijh,zcjhn->zcihn", ds, bx) + e[..., None] * z
    dcums = t.sum(3) - t.sum(2) + e * (cc * z).sum(-1)
    dh = torch.einsum("zcih,zcihn,zcihp->zchnp", e, cc, dyc)
    grouped = lambda t_: t_.reshape(bt, s, g, h // g, n).sum(3)
    return (dx.reshape(x.shape).to(x.dtype),
            grouped(dbx * dtc[..., None]).to(b.dtype),
            grouped(dc).to(c.dtype),
            (dbx * bc).sum(-1).reshape(bt, s, h).to(dt.dtype),
            dcums.reshape(bt, s, h).to(cums.dtype), dh.to(h_in.dtype),
            (dyc * xc).sum((0, 1, 2, 4)).to(d_skip.dtype))
