"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) block, the
full-sequence (training) path of the JAX package's ``models/mamba2.py``.

The sequence is cut into chunks of ``ssm.chunk`` tokens.  Inside a chunk
the SSD is a masked ``(C (dt B)^T * L) X`` product, which here is the
``ssd_chunk`` kernel (``kernels/ops.py::SSDChunk``: hand-written CUDA on
the card, its plain version on the CPU), the skip term ``d_skip X``
included; the cumsum of ``dt a``, each chunk's state and the inter-chunk
recurrence over the ``S / chunk`` chunks stay plain tensor code, and
autograd differentiates through them.  B and C keep their ``n_groups``
heads: the op's head h reads group ``h // (H / G)``, as the JAX model's
``_expand_groups`` (``jnp.repeat``) copies them.

Serving: ``mamba_apply`` with a ``MambaCache`` also returns the cache
after the sequence (the conv tail, the last ``d_conv`` pre-conv ``xbc``
rows left-padded with zeros, and the final SSD state), and
``mamba_decode`` is the O(1) one-token step: the conv over the rolled
buffer as one fp32 einsum, and the state update h <- h exp(dt a) +
dt x B^T.  The state is (B, H, P, N) fp32, the JAX package's layout.

On a model axis (``split``, a ``layers.ModelSplit``: the ``tp`` strategy
in the mesh step and in serving) the block runs Megatron-style by SSM
heads: rank r of M takes heads ``[h0, h1) = split.span(H)`` and computes
only their columns of ``in_proj`` (their z, x and dt, and every B / C
column its heads read: with one group, all of them, on every rank), their
conv channels, B7 on their heads, the gated RMSNorm over the whole
``d_inner`` (the rank's sum of squares summed over ``model``) and their
rows of ``out_proj``, whose parts ``comm.reduce_from`` adds; the input
enters through ``comm.copy_to``.  ``in_proj`` and the conv leaves are
stored split over ``model`` in blocks that are not a rank's heads (z |
xBC | dt are concatenated), so training and prefill take them whole
(the hook's "slice" route) and the rank takes its columns; the decode
step moves no weight: it multiplies the token by the stored column block
of ``in_proj``, gathers the (B, d_in_proj) row, convolves its stored
channel block (the conv is channel-local) against its block of the conv
state and gathers that row too (:func:`mamba_split_ranges`,
:func:`serve_params`).  The ssm state's heads are split over ``model``
as the rank's heads, written in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def mamba_init(gen: torch.Generator, cfg, n_layers: int) -> dict:
    """Stacked ``(n_layers, ...)`` fp32 parameters of the Mamba2 block,
    with the JAX init's distributions (its random numbers differ)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nh, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + nh
    dev = gen.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = torch.exp(lo + (hi - lo) * torch.rand((n_layers, nh),
                                                generator=gen, device=dev))
    stack = lambda t: t.expand((n_layers,) + tuple(t.shape)).clone()
    return {
        "in_proj": L.dense_init(gen, (n_layers, d, d_in_proj), d),
        "conv_w": torch.randn((n_layers, conv_dim, s.d_conv), generator=gen,
                              device=dev) / math.sqrt(s.d_conv),
        "conv_b": torch.zeros((n_layers, conv_dim), device=dev),
        "a_log": stack(torch.log(torch.arange(1, nh + 1, device=dev,
                                              dtype=torch.float32))),
        "d_skip": torch.ones((n_layers, nh), device=dev),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm_w": torch.ones((n_layers, d_inner), device=dev),
        "out_proj": L.dense_init(gen, (n_layers, d_inner, d), d_inner),
    }


def mamba_specs(cfg) -> dict:
    """Logical axes of one Mamba2 layer's weights."""
    return {"in_proj": ("embed", "ssm_proj"), "conv_w": ("ssm_conv", None),
            "conv_b": ("ssm_conv",), "a_log": (None,), "d_skip": (None,),
            "dt_bias": (None,), "norm_w": ("ssm_inner",),
            "out_proj": ("ssm_inner", "embed")}


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv, conv_dim) in the compute dtype
    ssm: torch.Tensor     # (B, H, P, N) fp32


def init_mamba_cache(batch: int, cfg, dtype, device=None,
                     layers: Optional[int] = None) -> MambaCache:
    """Zeros, or ``(layers, ...)`` stacks of them (the JAX package's
    per-layer caches stacked)."""
    s = cfg.ssm
    _, nh, conv_dim = _dims(cfg)
    lead = (batch,) if layers is None else (layers, batch)
    return MambaCache(
        conv=torch.zeros(lead + (s.d_conv, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros(lead + (nh, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device))


def _split_proj(cfg, zxbcdt):
    d_inner, _, conv_dim = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, conv_dim,
                                zxbcdt.shape[-1] - d_inner - conv_dim],
                       dim=-1)


def _split_xbc(cfg, xbc):
    d_inner, _, _ = _dims(cfg)
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    return torch.split(xbc, [d_inner, gn, gn], dim=-1)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, xbc (B, S, C), w (C, K): the sum over k of
    K shifted products in fp32, in the JAX model's order (cuDNN's conv1d
    would run TF32 by default), then SiLU, in xbc's dtype."""
    k, s = w.shape[1], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    w32 = w.float()
    out = pad[:, 0:s, :].float() * w32[:, 0]
    for j in range(1, k):
        out = out + pad[:, j:j + s, :].float() * w32[:, j]
    return F.silu(out + b.float()).to(xbc.dtype)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    threshold (torch's ``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssd_chunked(xs, b, c, dt, a, d_skip, chunk: int):
    """Chunked SSD with the skip term, the JAX model's ``ssd_chunked``
    plus ``d_skip xs``.  xs (Bt, S, H, P); b, c (Bt, S, G, N); dt (Bt, S,
    H) fp32; a (H,) < 0; d_skip (H,).  Returns y (Bt, S, H, P) fp32 and
    the state after the last chunk, (Bt, H, P, N) fp32 (the JAX layout;
    the recurrence here carries it as (Bt, H, N, P))."""
    bt, s, h, p = xs.shape
    g, n = b.shape[2:]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not a multiple of chunk {q}")
    nc = s // q
    cums = torch.cumsum((dt * a).reshape(bt, nc, q, h), dim=2)
    # each chunk's state S_c = sum_i exp(cums[-1] - cums[i]) dt_i B_i X_i,
    # the heads of a group against the group's B
    w = (torch.exp(cums[:, :, -1:, :] - cums) * dt.reshape(bt, nc, q, h))
    wx = (w[..., None] * xs.float().reshape(bt, nc, q, h, p)).reshape(
        bt, nc, q, g, h // g, p)
    s_chunk = torch.einsum("zcqgn,zcqgrp->zcgrnp",
                           b.float().reshape(bt, nc, q, g, n),
                           wx).reshape(bt, nc, h, n, p)
    decay = torch.exp(cums[:, :, -1, :])                        # (Bt, nc, H)
    # inter-chunk recurrence: the state entering each chunk
    state = torch.zeros((bt, h, n, p), dtype=torch.float32, device=xs.device)
    h_in = []
    for ci in range(nc):
        h_in.append(state)
        state = state * decay[:, ci, :, None, None] + s_chunk[:, ci]
    y = ops.SSDChunk.apply(xs, b, c, dt, cums.reshape(bt, s, h),
                           torch.stack(h_in, dim=1), d_skip)
    return y, state.transpose(-1, -2)


def mamba_apply(cfg, p: dict, x: torch.Tensor,
                cache: Optional[MambaCache] = None, split=None):
    """Full-sequence forward of one layer's block, x (B, S, D) in the
    compute dtype -> (B, S, D); with ``cache``, ``(out, the cache after
    the sequence)`` (a new one; ``cache`` gives its conv dtype).  Under
    ``split`` the rank's heads (:func:`_split_apply`)."""
    if split is not None:
        return _split_apply(cfg, p, x, cache, split)
    s_cfg = cfg.ssm
    bt, s, _ = x.shape
    d_inner, nh, _ = _dims(cfg)
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"].to(x.dtype))
    xs, b, c = _split_xbc(cfg, _causal_conv(xbc, p["conv_w"], p["conv_b"]))
    dt = _softplus(dt.float() + p["dt_bias"])                   # (Bt, S, H)
    a = -torch.exp(p["a_log"])
    y, h_final = ssd_chunked(
        xs.reshape(bt, s, nh, s_cfg.head_dim),
        b.reshape(bt, s, s_cfg.n_groups, s_cfg.d_state),
        c.reshape(bt, s, s_cfg.n_groups, s_cfg.d_state),
        dt, a, p["d_skip"], s_cfg.chunk)
    y = y.reshape(bt, s, d_inner).to(x.dtype)
    # gated RMSNorm, then the output projection
    y = L.rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if cache is None:
        return out
    tail = xbc[:, -s_cfg.d_conv:, :]
    tail = F.pad(tail, (0, 0, s_cfg.d_conv - tail.shape[1], 0))
    return out, MambaCache(conv=tail.to(cache.conv.dtype), ssm=h_final)


def mamba_decode(cfg, p: dict, x: torch.Tensor, cache: MambaCache,
                 split=None):
    """One-token step, x (B, 1, D) -> ``(out (B, 1, D), the new cache)``.
    Under ``split`` the rank's heads (:func:`_split_decode`; ``p`` from
    :func:`serve_params`)."""
    if split is not None:
        return _split_decode(cfg, p, x, cache, split)
    s_cfg = cfg.ssm
    bt = x.shape[0]
    d_inner, nh, _ = _dims(cfg)
    g, n, hp = s_cfg.n_groups, s_cfg.d_state, s_cfg.head_dim
    z, xbc, dt = _split_proj(cfg, x[:, 0, :] @ p["in_proj"].to(x.dtype))
    conv_buf = torch.cat([cache.conv[:, 1:, :],
                          xbc[:, None, :].to(cache.conv.dtype)], dim=1)
    xbc_c = torch.einsum("bkc,ck->bc", conv_buf.float(), p["conv_w"].float())
    xs, b, c = _split_xbc(cfg, F.silu(xbc_c + p["conv_b"]).to(x.dtype))
    dt = _softplus(dt.float() + p["dt_bias"])                   # (B, H)
    dec = torch.exp(dt * -torch.exp(p["a_log"]))
    xs = xs.reshape(bt, nh, hp).float()
    # each group's B and C repeated over its heads (the JAX _expand_groups)
    b = b.reshape(bt, g, n).repeat_interleave(nh // g, dim=1).float()
    c = c.reshape(bt, g, n).repeat_interleave(nh // g, dim=1).float()
    h = cache.ssm * dec[:, :, None, None] + (
        dt[:, :, None, None] * xs[:, :, :, None] * b[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h, c)
    y = y + p["d_skip"][None, :, None] * xs
    y = y.reshape(bt, d_inner).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return (y @ p["out_proj"].to(x.dtype))[:, None, :], MambaCache(
        conv=conv_buf, ssm=h)


# -- the heads split over a model axis ----------------------------------------

# the leaves the decode step takes as stored over ``model`` (serve_params)
STORED = ("in_proj", "conv_w", "conv_b")


def mamba_split_ranges(cfg, split) -> dict:
    """``{leaf: (dim, lo, hi)}``: the range of each Mamba2 leaf's dimension
    ``dim`` that rank ``split.rank`` uses, its heads ``split.span(H)``
    times the head dimension for ``norm_w`` and ``out_proj``; the rest
    (``dim`` None) are used whole, their gradient a part on each rank:
    ``in_proj`` and the conv leaves (the rank's columns and channels are
    not a contiguous range) and the replicated per-head ``a_log``,
    ``d_skip`` and ``dt_bias``."""
    h0, h1 = split.span(_dims(cfg)[1])
    rows = (h0 * cfg.ssm.head_dim, h1 * cfg.ssm.head_dim)
    out = {k: (None, 0, 0) for k in STORED + ("a_log", "d_skip",
                                              "dt_bias")}
    out.update(norm_w=(-1,) + rows, out_proj=(-2,) + rows)
    return out


def serve_params(use, lp: dict, path: str, decode: bool) -> dict:
    """A layer's parameters (``{"norm", "mamba"}`` at ``path``) through the
    gather hook ``use``; for the decode step under a split, the Mamba
    block's :data:`STORED` leaves as stored over ``model``
    (``layers.use_stored``: no weight moves over the axis)."""
    from repro_torch.models import layers as L
    if not decode or L.model_split(use) is None:
        return use(lp, path)
    m = lp["mamba"]
    out = use(dict(lp, mamba={k: v for k, v in m.items()
                              if k not in STORED}), path)
    out["mamba"].update(L.use_stored(use, {k: m[k] for k in STORED},
                                     f"{path}/mamba"))
    return out


def _rank_groups(cfg, h0: int, h1: int) -> tuple:
    """``(g0, g1, sel)``: the groups ``[g0, g1)`` the heads ``[h0, h1)``
    read, and None where local head i reads local group ``i // (H_r /
    G_r)`` (B7's own mapping), else each head's local group (B7 then
    takes the groups expanded per head)."""
    hpg = _dims(cfg)[1] // cfg.ssm.n_groups
    hl = h1 - h0
    if hl == 0:
        return 0, 0, None
    g0, g1 = h0 // hpg, (h1 - 1) // hpg + 1
    gl = g1 - g0
    sel = [(h0 + i) // hpg - g0 for i in range(hl)]
    if hl % gl == 0 and sel == [i // (hl // gl) for i in range(hl)]:
        return g0, g1, None
    return g0, g1, sel


def _rank_ranges(cfg, h0: int, h1: int, g0: int, g1: int) -> tuple:
    """``(in_proj columns, conv channels)``: lists of ``[lo, hi)`` ranges
    of the heads ``[h0, h1)`` and the groups ``[g0, g1)``, in the z | x |
    B | C | dt and x | B | C layouts."""
    d_inner, _, _ = _dims(cfg)
    p, n = cfg.ssm.head_dim, cfg.ssm.d_state
    gn = cfg.ssm.n_groups * n
    conv = [(h0 * p, h1 * p), (d_inner + g0 * n, d_inner + g1 * n),
            (d_inner + gn + g0 * n, d_inner + gn + g1 * n)]
    dt0 = 2 * d_inner + 2 * gn
    proj = ([(h0 * p, h1 * p)] + [(d_inner + a, d_inner + b)
                                  for a, b in conv] + [(dt0 + h0, dt0 + h1)])
    return proj, conv


def _cols(t: torch.Tensor, dim: int, ranges: list) -> torch.Tensor:
    return torch.cat([t.narrow(dim, a, b - a) for a, b in ranges], dim)


def _rank_ssd(cfg, p: dict, xs, b, c, dt, h0: int, h1: int, sel):
    """B7 on the heads ``[h0, h1)``: xs (Bt, S, H_r P), b / c (Bt, S,
    G_r N), dt (Bt, S, H_r) before the softplus -> ``(y (Bt, S, H_r P)
    fp32, the state after the sequence (Bt, H_r, P, N))``.  A rank
    without a head runs no kernel: its empty output still reads
    ``a_log``, ``d_skip`` and ``dt_bias``, so every leaf's gradient (and
    the collective behind it) runs on every rank."""
    s_cfg = cfg.ssm
    bt, s, _ = xs.shape
    hl, hp, n = h1 - h0, s_cfg.head_dim, s_cfg.d_state
    dt = _softplus(dt.float() + p["dt_bias"][h0:h1])
    a, d_skip = p["a_log"][h0:h1], p["d_skip"][h0:h1]
    if hl == 0:
        y = xs.float() * (dt + a + d_skip)
        return y, xs.new_zeros((bt, 0, hp, n), dtype=torch.float32)
    b = b.reshape(bt, s, -1, n)
    c = c.reshape(bt, s, -1, n)
    if sel is not None:
        idx = torch.tensor(sel, device=xs.device)
        b, c = b.index_select(2, idx), c.index_select(2, idx)
    y, h = ssd_chunked(xs.reshape(bt, s, hl, hp), b, c, dt, -torch.exp(a),
                       d_skip, s_cfg.chunk)
    return y.reshape(bt, s, hl * hp), h


def _gated_out(cfg, p: dict, y, z, split, dtype, rows: tuple):
    """The gated RMSNorm over the whole ``d_inner`` of the rank's slice
    ``rows`` of it (its sum of squares summed over the model axis, the
    gradient of that sum summed back), then the rank's rows of
    ``out_proj``, the parts summed over the axis."""
    from repro_torch.distributed import comm
    from repro_torch.models import layers as L
    g = (y.to(dtype) * F.silu(z)).float()
    ss = torch.sum(torch.square(g), dim=-1, keepdim=True)
    ss = comm.reduce_from(comm.copy_to(ss, split.group), split.group)
    yn = (g * torch.rsqrt(ss / _dims(cfg)[0] + cfg.norm_eps)
          * L.take(p["norm_w"], -1, *rows).float()).to(dtype)
    return comm.reduce_from(yn @ L.take(p["out_proj"], -2, *rows).to(dtype),
                            split.group)


def _every_head(t: torch.Tensor, nh: int, split) -> torch.Tensor:
    """t (B, H_r, ...) of the rank's heads ``split.span(nh)`` -> every
    head, concatenated over the model axis in rank order (each rank's
    padded to the widest span for the all-gather)."""
    from repro_torch.distributed import comm
    w = -(-nh // split.size)
    pad = t.new_zeros((t.shape[0], w - t.shape[1]) + tuple(t.shape[2:]))
    parts = comm.all_concat(torch.cat([t, pad], 1), 1, split.group).split(
        w, 1)
    spans = [split._replace(rank=r).span(nh) for r in range(split.size)]
    return torch.cat([q[:, :hi - lo] for q, (lo, hi) in zip(parts, spans)],
                     1)


def _state(h: torch.Tensor, cache: MambaCache, nh: int, split):
    """The rank's heads' state ``h`` as the cache holds it: its block
    (the rank's heads, where ``model`` divides them), or every head."""
    return _every_head(h, nh, split) if cache.ssm.shape[1] == nh else h


def _conv_block(cfg, width: int, split) -> int:
    """The first conv channel of the rank's stored block of ``width``
    channels (0 where it holds them all)."""
    return 0 if width == _dims(cfg)[2] else split.rank * width


def _split_apply(cfg, p: dict, x: torch.Tensor, cache, split):
    """:func:`mamba_apply` on rank ``split.rank``'s heads (see the module
    docstring): ``in_proj`` and the conv leaves whole, the rest each the
    rank's block or whole (``layers.take``).  With ``cache`` (its blocks
    over ``model``), the rank's block of the conv tail (its stored
    channels' last ``d_conv`` pre-conv rows, from ``in_proj``) and of the
    state."""
    from repro_torch.distributed import comm
    s_cfg = cfg.ssm
    d_inner, nh, _ = _dims(cfg)
    hp, k = s_cfg.head_dim, s_cfg.d_conv
    h0, h1 = split.span(nh)
    hl = h1 - h0
    g0, g1, sel = _rank_groups(cfg, h0, h1)
    proj, conv = _rank_ranges(cfg, h0, h1, g0, g1)
    xin = comm.copy_to(x, split.group)
    zxbcdt = xin @ _cols(p["in_proj"], -1, proj).to(x.dtype)
    gn = (g1 - g0) * s_cfg.d_state
    z, xbc, dt = torch.split(zxbcdt, [hl * hp, hl * hp + 2 * gn, hl], -1)
    xs, b, c = torch.split(_causal_conv(xbc, _cols(p["conv_w"], 0, conv),
                                        _cols(p["conv_b"], 0, conv)),
                           [hl * hp, gn, gn], -1)
    y, h = _rank_ssd(cfg, p, xs, b, c, dt, h0, h1, sel)
    out = _gated_out(cfg, p, y, z, split, x.dtype, (h0 * hp, h1 * hp))
    if cache is None:
        return out
    width = cache.conv.shape[-1]
    c0 = d_inner + _conv_block(cfg, width, split)
    tail = x[:, -k:, :] @ p["in_proj"][:, c0:c0 + width].to(x.dtype)
    tail = F.pad(tail, (0, 0, k - tail.shape[1], 0))
    return out, MambaCache(conv=tail.to(cache.conv.dtype),
                           ssm=_state(h, cache, nh, split))


def _split_decode(cfg, p: dict, x: torch.Tensor, cache: MambaCache, split):
    """:func:`mamba_decode` on rank ``split.rank``'s heads, no weight moved
    over the model axis: the token times the stored column block of
    ``in_proj`` (or every column, where it is stored whole), the row
    all-gathered; the depthwise conv of the rank's stored channel block
    against its block of the conv state (written in place), that row
    all-gathered; then the rank's heads of the state (its block, or its
    heads of a whole one, every rank's heads then concatenated), the
    gated norm and ``out_proj`` as :func:`_gated_out`."""
    from repro_torch.distributed import comm
    s_cfg = cfg.ssm
    bt = x.shape[0]
    d_inner, nh, conv_dim = _dims(cfg)
    g, n, hp = s_cfg.n_groups, s_cfg.d_state, s_cfg.head_dim
    h0, h1 = split.span(nh)
    row = x[:, 0, :] @ p["in_proj"].to(x.dtype)
    if row.shape[-1] != 2 * d_inner + 2 * g * n + nh:
        row = comm.all_concat(row, -1, split.group)
    z, xbc, dt = _split_proj(cfg, row)
    cw = p["conv_w"]
    width = cw.shape[0]
    if cache.conv.shape[-1] != width:
        raise ValueError(f"conv state block {tuple(cache.conv.shape)} vs "
                         f"conv_w {tuple(cw.shape)}")
    c0 = _conv_block(cfg, width, split)
    conv_buf = torch.cat([cache.conv[:, 1:, :], xbc[:, None, c0:c0 + width]
                          .to(cache.conv.dtype)], dim=1)
    xbc_c = torch.einsum("bkc,ck->bc", conv_buf.float(), cw.float())
    xbc_c = F.silu(xbc_c + p["conv_b"]).to(x.dtype)
    if width != conv_dim:
        xbc_c = comm.all_concat(xbc_c, -1, split.group)
    xs, b, c = _split_xbc(cfg, xbc_c)
    dt = _softplus(dt[:, h0:h1].float() + p["dt_bias"][h0:h1])   # (B, H_r)
    dec = torch.exp(dt * -torch.exp(p["a_log"][h0:h1]))
    xs = xs.reshape(bt, nh, hp)[:, h0:h1].float()
    grp = torch.arange(h0, h1, device=x.device) // (nh // g)
    b = b.reshape(bt, g, n)[:, grp].float()
    c = c.reshape(bt, g, n)[:, grp].float()
    prev = cache.ssm[:, h0:h1] if cache.ssm.shape[1] == nh else cache.ssm
    h = prev * dec[:, :, None, None] + (
        dt[:, :, None, None] * xs[:, :, :, None] * b[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h, c)
    y = (y + p["d_skip"][h0:h1][None, :, None] * xs).reshape(bt, -1)
    out = _gated_out(cfg, p, y, z[:, h0 * hp:h1 * hp], split, x.dtype,
                     (h0 * hp, h1 * hp))
    return out[:, None, :], MambaCache(conv=conv_buf,
                                       ssm=_state(h, cache, nh, split))
