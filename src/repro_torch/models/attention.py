"""Grouped-query attention over a whole sequence (training; causal, or
full for an encoder and cross-attention), dispatched as the JAX package's
``sdpa_auto`` does: the naive score matrix upcast to fp32
(``_sdpa``) or the chunked online-softmax path (``_sdpa_chunked``), which
here is the flash-attention kernel (``kernels/ops.py::FlashAttention``).
The decode and paged paths are not ported yet (see ROADMAP.md)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import K_CHUNK, NEG_INF
from repro_torch.models import layers as L
from repro_torch.models.layers import dense_init

# The JAX package's dispatch constants: the chunked path above this many
# query tokens under attn_impl "auto", and only for lengths that divide
# into its chunks.  The kernel tiles as it likes; the dispatch keeps the
# divisibility so both packages take the same path on the same shapes.
CHUNK_THRESHOLD = 4096
Q_CHUNK = 1024


def attn_init(gen: torch.Generator, cfg, n_layers: int) -> dict:
    """Stacked projections; zero q / k / v biases under ``qkv_bias`` and
    per-head RMSNorm scales (hd,) under ``qk_norm``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (n_layers, d, cfg.n_heads * hd), d),
        "wk": dense_init(gen, (n_layers, d, cfg.n_kv_heads * hd), d),
        "wv": dense_init(gen, (n_layers, d, cfg.n_kv_heads * hd), d),
        "wo": dense_init(gen, (n_layers, cfg.n_heads * hd, d),
                         cfg.n_heads * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n_layers, cfg.n_heads * hd), device=dev)
        p["bk"] = torch.zeros((n_layers, cfg.n_kv_heads * hd), device=dev)
        p["bv"] = torch.zeros((n_layers, cfg.n_kv_heads * hd), device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((n_layers, hd), device=dev)
        p["k_norm"] = torch.ones((n_layers, hd), device=dev)
    return p


def _project_qkv(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """q (B, S, H, dh), k / v (B, S, KV, dh): the projections, then the
    biases, then RMSNorm of q and k per head, then RoPE at ``positions``,
    in the JAX package's order."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_embedding == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(cfg, q, k, v, mask):
    """q: (B, Sq, H, dh), k/v: (B, Sk, KV, dh), mask: (B|1, Sq, Sk) bool."""
    hd = q.shape[-1]
    groups = cfg.n_heads // cfg.n_kv_heads
    b, sq = q.shape[:2]
    q = q.reshape(b, sq, cfg.n_kv_heads, groups, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(),
                          k.float()) / math.sqrt(float(hd))
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full((), NEG_INF, dtype=logits.dtype,
                                    device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(b, sq, cfg.n_heads * hd)


def _sdpa_chunked(cfg, q, k, v, *, causal: bool):
    """Exact attention without a score matrix: the flash-attention forward
    and recompute backward (fp32 scores and ``p v``), q (B, Sq, H, dh),
    k / v (B, Sk, KV, dh) -> (B, Sq, H * dh)."""
    b, sq = q.shape[:2]
    return ops.FlashAttention.apply(q, k, v, causal).reshape(
        b, sq, cfg.n_heads * q.shape[-1])


def sdpa_auto(cfg, q, k, v, *, causal: bool):
    """Dispatch: chunked for long sequences, naive otherwise; the
    ``attn_impl`` config knob forces either path."""
    sq, sk = q.shape[1], k.shape[1]
    impl = cfg.attn_impl
    divisible = sq % Q_CHUNK == 0 and sk % K_CHUNK == 0
    if impl == "chunked" and divisible:
        return _sdpa_chunked(cfg, q, k, v, causal=causal)
    if impl != "naive" and sq > CHUNK_THRESHOLD and divisible:
        return _sdpa_chunked(cfg, q, k, v, causal=causal)
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, None, :]
                <= torch.arange(sq, device=q.device)[None, :, None])
    else:
        mask = torch.ones((1, sq, sk), dtype=torch.bool, device=q.device)
    return _sdpa(cfg, q, k, v, mask)


def attn_apply_full(cfg, p: dict, x: torch.Tensor, *, causal: bool,
                    positions: Optional[torch.Tensor] = None,
                    kv_override: Optional[tuple] = None) -> torch.Tensor:
    """Full-sequence attention (training, the encoder): causal or not,
    positions ``arange(S)`` unless given; ``kv_override`` (k, v) replaces
    the projected keys and values (cross-attention on the encoder's)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project_qkv(cfg, p, x, positions)
    if kv_override is not None:
        k, v = kv_override
    return sdpa_auto(cfg, q, k, v, causal=causal) @ p["wo"].to(x.dtype)
