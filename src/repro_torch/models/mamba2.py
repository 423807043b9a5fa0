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

Decode, the ``MambaCache`` and prefill belong to serving and are not
ported yet (ROADMAP.md Queue A, serving).
"""
from __future__ import annotations

import math

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
    H) fp32; a (H,) < 0; d_skip (H,).  Returns y (Bt, S, H, P) fp32."""
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
    return ops.SSDChunk.apply(xs, b, c, dt, cums.reshape(bt, s, h),
                              torch.stack(h_in, dim=1), d_skip)


def mamba_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward of one layer's block, x (B, S, D) in the
    compute dtype -> (B, S, D)."""
    s_cfg = cfg.ssm
    bt, s, _ = x.shape
    d_inner, nh, _ = _dims(cfg)
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"].to(x.dtype))
    xs, b, c = _split_xbc(cfg, _causal_conv(xbc, p["conv_w"], p["conv_b"]))
    dt = _softplus(dt.float() + p["dt_bias"])                   # (Bt, S, H)
    a = -torch.exp(p["a_log"])
    y = ssd_chunked(xs.reshape(bt, s, nh, s_cfg.head_dim),
                    b.reshape(bt, s, s_cfg.n_groups, s_cfg.d_state),
                    c.reshape(bt, s, s_cfg.n_groups, s_cfg.d_state),
                    dt, a, p["d_skip"], s_cfg.chunk)
    y = y.reshape(bt, s, d_inner).to(x.dtype)
    # gated RMSNorm, then the output projection
    y = L.rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype)
