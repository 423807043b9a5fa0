"""Causal grouped-query attention for training, with the naive score
matrix upcast to fp32 as in the JAX package's ``_sdpa``.  The chunked,
decode and paged paths are not ported yet (see ROADMAP.md)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense_init

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg, n_layers: int) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (n_layers, d, cfg.n_heads * hd), d),
        "wk": dense_init(gen, (n_layers, d, cfg.n_kv_heads * hd), d),
        "wv": dense_init(gen, (n_layers, d, cfg.n_kv_heads * hd), d),
        "wo": dense_init(gen, (n_layers, cfg.n_heads * hd, d),
                         cfg.n_heads * hd),
    }


def _project_qkv(cfg, p: dict, x: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
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


def attn_apply_causal(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal self-attention (training)."""
    s = x.shape[1]
    q, k, v = _project_qkv(cfg, p, x)
    pos = torch.arange(s, device=x.device)
    mask = (pos[None, None, :] <= pos[None, :, None])
    return _sdpa(cfg, q, k, v, mask) @ p["wo"].to(x.dtype)
