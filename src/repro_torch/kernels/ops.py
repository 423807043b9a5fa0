"""Dispatch for the port's CUDA kernels, by the device of the tensors.

A tensor on the CPU takes the plain version in ``kernels/ref.py``; a CUDA
tensor launches the hand-written kernel in ``kernels/fused_update.py``,
``kernels/lowrank_update.py``, ``kernels/srsi_matmul.py``,
``kernels/sketch_update.py``, ``kernels/flash_attention.py`` or
``kernels/ssd_chunk.py`` (or the launch raises); any other device raises.
There is no mode switch and no fallback.  For the update and
matmul kernels the dispatch owns what the kernels do not: the leading
batch axes of stacked ``(..., m, n)`` leaves are flattened into one grid
axis (one launch per leaf), ``r`` is zero-padded to the update kernels'
16-deep slices (zero columns add nothing to Q U^T or to the fold; an int8
factor pads q8, scale and zero with 0, so a padded column dequantizes to
0), and the ragged edges of ``m``, ``n`` and ``s`` are masked inside the
kernels instead of padded here, so G is never copied.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantized import QuantizedMatrix, dequantize
from repro_torch.kernels import ref

def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _flat(t: torch.Tensor) -> torch.Tensor:
    """(..., a, b) -> (B, a, b) contiguous, one batch axis."""
    return t.reshape((-1,) + tuple(t.shape[-2:])).contiguous()


def _rpad(t: torch.Tensor, r_align: int) -> torch.Tensor:
    """Zero-pad the last axis to a multiple of ``r_align``."""
    pad = (-t.shape[-1]) % r_align
    return F.pad(t, (0, pad)) if pad else t


def fold_in_pass1(r: int) -> bool:
    """Whether pass 1 computes the fold (G^2)^T Q itself at factor width
    ``r``: up to ``fused_update.R_MAX`` once r is padded to 16.  Wider
    factors (the paper's k_max = min(m, n) / 4 gives r = 192 on GPT-2
    117M's block matrices and 256 on Mamba2-370m's) take the fold from
    the square-and-matmul kernel instead, see :func:`fused_precond`."""
    from repro_torch.kernels import fused_update as K
    return -(-r // K.R_ALIGN) * K.R_ALIGN <= K.R_MAX


def fused_precond(q, u, g: torch.Tensor, b2: float, eps: float,
                  m1: torch.Tensor | None = None, with_vfro: bool = True,
                  with_fold: bool = False):
    """Pass 1 of the fused update (see ``ref.fused_precond``) over any
    leading batch dims of (q, u, g, m1).  ``q`` / ``u`` are fp32 tensors or
    :class:`QuantizedMatrix` int8 factors: on the CPU those are
    dequantized and the plain version runs, on the card the int8 variant
    of the kernel dequantizes them as it loads them.  Returns ``(u_hat,
    vfro, usq, m1dot, m1sq, yfold)``; vfro is None unless ``with_vfro``,
    m1dot / m1sq are None without ``m1``, yfold is None unless
    ``with_fold``.

    On the card the fold is pass 1's rider while :func:`fold_in_pass1`
    holds.  Past it (pass 1 stages Q^T whole in shared memory and would
    refuse the width), pass 1 runs without the fold and the fold is
    ``sq_matmul_t(G, Q)``, the square-and-matmul kernel, on Q as pass 1
    reads it (int8 factors dequantized once): the product the JAX
    package's unfused and use_kernels branches compute, at the cost of a
    second read of G."""
    quant = isinstance(q, QuantizedMatrix)
    if not _on_cuda(g):
        if quant:
            q, u = dequantize(q), dequantize(u)
        return ref.fused_precond(q, u, g, b2, eps, m1=m1,
                                 with_vfro=with_vfro, with_fold=with_fold)
    from repro_torch.kernels import fused_update as K
    bd = tuple(g.shape[:-2])
    m, n = g.shape[-2:]
    if quant:
        r = q.q8.shape[-1]
        qp, up = ([_flat(_rpad(t, K.R_ALIGN)) for t in f] for f in (q, u))
    else:
        r = q.shape[-1]
        qp, up = (_flat(_rpad(f.float(), K.R_ALIGN)) for f in (q, u))
    rider = with_fold and fold_in_pass1(r)
    out, sums, yfold = K.fused_precond(
        qp, up, _flat(g.float()), b2, eps,
        m1=None if m1 is None else _flat(m1.float()), with_fold=rider)
    col = lambda i: sums[:, i].reshape(bd)
    if rider:
        yfold = yfold[..., :r].reshape(bd + (n, r))
    elif with_fold:
        yfold = sq_matmul_t(g, dequantize(q) if quant else q)
    return (out.reshape(bd + (m, n)),
            col(0) if with_vfro else None, col(1),
            None if m1 is None else col(2), None if m1 is None else col(3),
            yfold)


def lowrank_update(q: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                   b2: float, eps: float, with_frob: bool = False):
    """The single-pass update (see ``ref.lowrank_update``) over any leading
    batch dims of (q, u, g).  Returns ``out``, or ``(out, vfro)`` with
    ``with_frob``."""
    if not _on_cuda(g):
        out, fro = ref.lowrank_update(q, u, g, b2, eps)
    else:
        from repro_torch.kernels import fused_update as K
        from repro_torch.kernels import lowrank_update as LU
        bd = tuple(g.shape[:-2])
        out, fro = LU.lowrank_update(
            _flat(_rpad(q.float(), K.R_ALIGN)),
            _flat(_rpad(u.float(), K.R_ALIGN)), _flat(g.float()), b2, eps)
        out, fro = out.reshape(g.shape), fro.reshape(bd)
    return (out, fro) if with_frob else out


def _sq_matmul(g: torch.Tensor, x: torch.Tensor, transposed: bool):
    from repro_torch.kernels import srsi_matmul as SM
    bd = tuple(g.shape[:-2])
    y = SM.sq_matmul(_flat(g.float()), _flat(x.float()), transposed)
    return y.reshape(bd + tuple(y.shape[-2:]))


def sq_matmul(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(G * G) @ X with G^2 never stored (see ``ref.sq_matmul``).  g (...,
    m, n), x (..., n, s) -> (..., m, s)."""
    if not _on_cuda(g):
        return ref.sq_matmul(g, x)
    return _sq_matmul(g, x, transposed=False)


def sq_matmul_t(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(G * G)^T @ Y (see ``ref.sq_matmul_t``); on the card G is read in
    its own layout, never transposed in memory.  g (..., m, n), y (..., m,
    s) -> (..., n, s)."""
    if not _on_cuda(g):
        return ref.sq_matmul_t(g, y)
    return _sq_matmul(g, y, transposed=True)


def one_sided_fold(u: torch.Tensor, q: torch.Tensor, g: torch.Tensor,
                   b2: float, col_mask: torch.Tensor | None = None,
                   reduce=None) -> torch.Tensor:
    """The rank-projected fold ``mask * (b2 U + (1 - b2) (G^2)^T Q)`` (see
    ``ref.one_sided_fold``): the product goes through :func:`sq_matmul_t`,
    summed by ``reduce`` over the row axis of a row-split G (on a mesh);
    the rank-r EMA and mask are tensor code on any device.  col_mask
    (..., r) or None."""
    y = sq_matmul_t(g, q)
    folded = b2 * u.float() + (1.0 - b2) * (y if reduce is None
                                            else reduce(y))
    if col_mask is not None:
        folded = folded * col_mask.unsqueeze(-2)
    return folded


def fused_apply(u_hat: torch.Tensor, m1: torch.Tensor | None,
                denom: torch.Tensor, b1: float,
                out_scale: torch.Tensor, store_scale: torch.Tensor,
                shared_out: bool = False, in_place: bool = True):
    """Pass 2 of the fused update (see ``ref.fused_apply``).  ``u_hat`` /
    ``m1``: (*batch, m, n); the three scalars: (*batch,).  On the card
    ``m1`` is updated in place; ``in_place=False`` writes the new first
    moment into a fresh buffer and leaves ``m1`` as it was (the same bytes
    move; a guarded Adapprox passes it, so a step the skip-step guard
    rejects keeps its pre-step state, see ``resilience/guards.py``).  The
    CPU's plain version always returns new tensors.  ``shared_out=True``
    (valid when out_scale == store_scale, i.e. guidance "off" or "stored")
    returns the same tensor as m_out and m1_new.  With ``m1``
    None (b1 = 0) the pass is one scaled copy, which is plain tensor code
    on every device as in the JAX package's dispatch.  Returns ``(m_out,
    m1_new)``."""
    if m1 is None:
        return ref.fused_apply(u_hat, None, denom, b1, out_scale,
                               store_scale)
    if not _on_cuda(u_hat):
        out, m1n = ref.fused_apply(u_hat, m1, denom, b1, out_scale,
                                   store_scale)
        return (m1n, m1n) if shared_out else (out, m1n)
    from repro_torch.kernels import fused_update as K
    shape = u_hat.shape
    bsz = denom.numel()
    if not m1.is_contiguous():
        raise ValueError("m1: pass 2 updates it in place and needs a "
                         "contiguous tensor")
    f = lambda s: s.float().reshape(bsz)
    scalars = torch.stack([f(denom),
                           torch.full((bsz,), b1, dtype=torch.float32,
                                      device=m1.device),
                           torch.full((bsz,), 1.0 - b1, dtype=torch.float32,
                                      device=m1.device),
                           f(out_scale), f(store_scale)], dim=-1)
    m1_new = m1 if in_place else torch.empty_like(m1)
    m_out, _ = K.fused_apply(
        u_hat.float().reshape(bsz, -1).contiguous(), m1.view(bsz, -1),
        scalars, shared_out, m1_out=m1_new.view(bsz, -1))
    return (m1_new if shared_out else m_out.view(shape)), m1_new


def bucket_order(idx: torch.Tensor, width: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sketch scatter's index buffers for ``idx`` (depth, rows): the
    rows of each depth sorted by bucket, ascending within a bucket, and the
    bucket offsets (depth, width + 1), bucket b of depth j holding
    ``order[j, offsets[j, b]:offsets[j, b + 1]]``.  int32, on idx's
    device."""
    idx = idx.long()
    order = torch.sort(idx, dim=1, stable=True).indices
    counts = torch.zeros((idx.shape[0], width + 1), dtype=torch.long,
                         device=idx.device)
    counts[:, 1:].scatter_add_(1, idx, torch.ones_like(idx))
    offsets = torch.cumsum(counts, dim=1)
    return order.int().contiguous(), offsets.int().contiguous()


def sketch_update(table: torch.Tensor, g: torch.Tensor, idx: torch.Tensor,
                  b2: float, order: torch.Tensor | None = None,
                  offsets: torch.Tensor | None = None, reduce=None):
    """Count-min EMA scatter + min-over-depth query (see
    ``ref.sketch_update``).  table (depth, width, d) f32, g (rows, d), idx
    (depth, rows) int32.  On the card, ``order`` / ``offsets`` (from
    :func:`bucket_order`, built once per leaf) feed the scatter; they are
    built here when not given.  ``reduce`` sums the per-bucket sums over
    the ranks holding a row-split leaf's other rows (on a mesh).  Returns
    ``(table_new, vhat)``."""
    if not _on_cuda(g):
        return ref.sketch_update(table, g, idx, b2, reduce=reduce)
    from repro_torch.kernels import sketch_update as SK
    if order is None or offsets is None:
        order, offsets = bucket_order(idx, table.shape[1])
    return SK.sketch_update(table.float().contiguous(),
                            g.float().contiguous(), idx.int().contiguous(),
                            order, offsets, b2, reduce=reduce)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """Online-softmax attention forward (see ``ref.flash_attention``).  q
    (B, Sq, H, dh), k / v (B, Sk, KV, dh), H % KV == 0.  Returns ``(out
    (B, Sq, H, dh) in v's dtype, lse (B, H, Sq) fp32)``."""
    if not _on_cuda(q):
        return ref.flash_attention(q, k, v, causal)
    from repro_torch.kernels import flash_attention as FA
    return FA.forward(q.contiguous(), k.contiguous(), v.contiguous(), causal)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """The recompute backward (see ``ref.flash_attention_bwd``).  Returns
    ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    if not _on_cuda(q):
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal)
    from repro_torch.kernels import flash_attention as FA
    return FA.backward(q.contiguous(), k.contiguous(), v.contiguous(),
                       o.contiguous(), lse.contiguous(),
                       do.to(q.dtype).contiguous(), causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention in the model's layout, q (B, Sq, H, dh), k / v (B,
    Sk, KV, dh) with H % KV == 0 -> (B, Sq, H, dh): the counterpart of the
    JAX package's ``ops.flash_attention``, differentiable through
    :class:`FlashAttention`.  Unlike the TPU wrapper it neither pads dh
    nor copies k and v per query head."""
    return FlashAttention.apply(q, k, v, causal)


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward both go through the device
    dispatch above; it saves q, k, v, the output and the log-sum-exp, never
    a score matrix."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal)
        return dq, dk, dv, None


def ssd_chunk_fwd(x, b, c, dt, cums, h_in, d_skip) -> torch.Tensor:
    """The SSD intra-chunk block with its skip term (see
    ``ref.ssd_chunk``): x (B, S, H, P), b / c (B, S, G, N), dt / cums (B,
    S, H), h_in (B, nc, H, N, P), d_skip (H,).  Returns y (B, S, H, P)
    fp32."""
    if not _on_cuda(x):
        return ref.ssd_chunk(x, b, c, dt, cums, h_in, d_skip)
    from repro_torch.kernels import ssd_chunk as SSD
    return SSD.forward(*_ssd_inputs(x, b, c, dt, cums, h_in, d_skip))


def ssd_chunk_bwd(x, b, c, dt, cums, h_in, d_skip, dy):
    """The recompute backward (see ``ref.ssd_chunk_bwd``).  Returns ``(dx,
    db, dc, ddt, dcums, dh_in, dd_skip)`` in the dtypes of the inputs."""
    if not _on_cuda(x):
        return ref.ssd_chunk_bwd(x, b, c, dt, cums, h_in, d_skip, dy)
    from repro_torch.kernels import ssd_chunk as SSD
    return SSD.backward(*_ssd_inputs(x, b, c, dt, cums, h_in, d_skip),
                        dy.float().contiguous())


def _ssd_inputs(x, b, c, dt, cums, h_in, d_skip):
    """The kernels' operands: x, b, c contiguous in x's dtype, the rest
    contiguous fp32 (a no-op for what the model passes but the slices of
    its projection, which are copied)."""
    dense = lambda t, dtype: t.to(dtype).contiguous()
    return (dense(x, x.dtype), dense(b, x.dtype), dense(c, x.dtype),
            *(dense(t, torch.float32) for t in (dt, cums, h_in, d_skip)))


class SSDChunk(torch.autograd.Function):
    """The SSD intra-chunk block, forward and backward through the device
    dispatch above: the counterpart of the JAX package's
    ``ssd_chunk_pallas`` plus the skip term, differentiable in all seven
    inputs.  It saves its inputs only, never a (q, q) tensor."""

    @staticmethod
    def forward(ctx, x, b, c, dt, cums, h_in, d_skip):
        ctx.save_for_backward(x, b, c, dt, cums, h_in, d_skip)
        return ssd_chunk_fwd(x, b, c, dt, cums, h_in, d_skip)

    @staticmethod
    def backward(ctx, dy):
        return ssd_chunk_bwd(*ctx.saved_tensors, dy)
