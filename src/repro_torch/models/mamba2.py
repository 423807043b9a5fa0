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
                cache: Optional[MambaCache] = None):
    """Full-sequence forward of one layer's block, x (B, S, D) in the
    compute dtype -> (B, S, D); with ``cache``, ``(out, the cache after
    the sequence)`` (a new one; ``cache`` gives its conv dtype)."""
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


def mamba_decode(cfg, p: dict, x: torch.Tensor, cache: MambaCache):
    """One-token step, x (B, 1, D) -> ``(out (B, 1, D), the new cache)``."""
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
