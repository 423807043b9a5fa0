"""Grouped-query attention, the JAX package's ``models/attention.py``:
over a whole sequence (training, prefill; causal, or full for an encoder
and cross-attention), dispatched as its ``sdpa_auto`` does: the naive
score matrix upcast to fp32 (``_sdpa``) or the chunked online-softmax path
(``_sdpa_chunked``), which here is the flash-attention kernel
(``kernels/ops.py::FlashAttention``); and the serving paths against a
dense KV cache (``attn_prefill``, ``attn_decode``) or a paged block pool
(``attn_decode_paged``, ``attn_prefill_paged``), which run the naive
``_sdpa`` as in JAX.

The serving paths write the cache in place (the JAX functions return an
updated copy, which the engines donate); they return the cache all the
same, so the call sites read as JAX's.  Where JAX clamps an index that a
serving path can push out of range, the port clamps it too: the dense
decode's write position to the cache's last row (``dynamic_update_slice``),
the paged prefill's block index to the table's last column (a gather).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

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


def attn_specs(cfg) -> dict:
    """Logical axes of one layer's attention weights."""
    s = {"wq": ("embed", "q_heads"), "wk": ("embed", "kv_heads"),
         "wv": ("embed", "kv_heads"), "wo": ("q_heads", "embed")}
    if cfg.qkv_bias:
        s["bq"] = ("q_heads",)
        s["bk"] = ("kv_heads",)
        s["bv"] = ("kv_heads",)
    if cfg.qk_norm:
        s["q_norm"] = (None,)
        s["k_norm"] = (None,)
    return s


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, KV, dh)
    v: torch.Tensor       # (B, S_max, KV, dh)


def init_kv_cache(batch: int, cache_len: int, cfg, dtype,
                  device=None, layers: Optional[int] = None) -> KVCache:
    """Zeros (B, S_max, KV, dh), or ``(layers, B, S_max, KV, dh)``: the
    JAX package's per-layer caches stacked."""
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    if layers is not None:
        shape = (layers,) + shape
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


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


def attn_prefill(cfg, p: dict, x: torch.Tensor, cache: KVCache):
    """Causal attention over the prompt x (B, S, D) through ``sdpa_auto``
    (the flash kernel where JAX takes ``_sdpa_chunked``); fills
    ``cache[:, :S]``.  Returns ``(out, cache)``."""
    s = x.shape[1]
    q, k, v = _project_qkv(cfg, p, x, torch.arange(s, device=x.device)[None])
    out = sdpa_auto(cfg, q, k, v, causal=True)
    cache.k[:, :s] = k.to(cache.k.dtype)
    cache.v[:, :s] = v.to(cache.v.dtype)
    return out @ p["wo"].to(x.dtype), cache


def attn_decode(cfg, p: dict, x: torch.Tensor, cache: KVCache, pos: int):
    """One-token step, x (B, 1, D) at position ``pos`` (an int): its k / v
    written at row ``min(pos, S_max - 1)`` (JAX's clamp), attention over
    rows ``<= pos``.  Returns ``(out, cache)``."""
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, torch.full((b, 1), pos,
                                                 device=x.device))
    s_max = cache.k.shape[1]
    row = min(max(pos, 0), s_max - 1)
    cache.k[:, row] = k[:, 0].to(cache.k.dtype)
    cache.v[:, row] = v[:, 0].to(cache.v.dtype)
    mask = torch.arange(s_max, device=x.device)[None, None, :] <= pos
    out = _sdpa(cfg, q, cache.k, cache.v, mask)
    return out @ p["wo"].to(x.dtype), cache


# -- paged (block-table) KV cache ---------------------------------------------
# One layer's pool is (num_blocks, block_size, KV, dh); a sequence owns an
# ordered list of block ids (its block table) and a position.  The read
# gathers the pool through the table into the logical dense layout (B,
# n_blocks_per_slot * block_size, KV, dh) and runs the same ``_sdpa`` as
# the dense cache, positions past each row's masked to NEG_INF, whose
# softmax weight underflows to exactly 0.0: with the logical length equal
# to ``cache_len`` this is bitwise ``attn_decode`` on a dense cache holding
# the same tokens.  Block 0 is the null block (serve/kv_cache.py): rows
# parked on it write garbage there with duplicate indices (an index_put_
# whose winner is unspecified on the card), which is only ever read masked.


def _paged_gather(pool: torch.Tensor, block_tables: torch.Tensor):
    """pool (NB, bs, KV, dh), block_tables (B, nbt) -> (B, nbt * bs, KV,
    dh)."""
    g = pool[block_tables]
    b, nbt, bs = g.shape[:3]
    return g.reshape(b, nbt * bs, *g.shape[3:])


def attn_decode_paged(cfg, p: dict, x: torch.Tensor, pk: torch.Tensor,
                      pv: torch.Tensor, block_tables: torch.Tensor,
                      positions: torch.Tensor):
    """One-token step against one layer's pool, per-row positions: x (B,
    1, D), pk / pv (NB, bs, KV, dh), block_tables (B, nbt) int, positions
    (B,) int.  Row i's k / v land in block ``block_tables[i, pos // bs]``
    at offset ``pos % bs``.  Returns ``(out, pk, pv)``."""
    bs = pk.shape[1]
    q, k, v = _project_qkv(cfg, p, x, positions[:, None])
    bids = torch.gather(block_tables, 1, (positions // bs)[:, None])[:, 0]
    offs = positions % bs
    pk[bids, offs] = k[:, 0].to(pk.dtype)
    pv[bids, offs] = v[:, 0].to(pv.dtype)
    kall = _paged_gather(pk, block_tables)
    vall = _paged_gather(pv, block_tables)
    mask = (torch.arange(kall.shape[1], device=x.device)[None, None, :]
            <= positions[:, None, None])
    out = _sdpa(cfg, q, kall, vall, mask)
    return out @ p["wo"].to(x.dtype), pk, pv


def attn_prefill_paged(cfg, p: dict, x: torch.Tensor, pk: torch.Tensor,
                       pv: torch.Tensor, block_table: torch.Tensor, p0: int):
    """Causal attention over one prompt chunk x (1, C, D) at logical
    positions p0 .. p0 + C - 1 of one slot (``block_table`` (nbt,)),
    written through the table; the chunk attends to the slot's earlier
    chunks and itself.  Chunk padding writes throwaway k / v that the next
    chunk or decode overwrites before it is ever unmasked.  Returns
    ``(out, pk, pv)``."""
    c = x.shape[1]
    bs = pk.shape[1]
    tok_pos = p0 + torch.arange(c, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, tok_pos[None, :])
    col = torch.clamp(tok_pos // bs, max=block_table.shape[0] - 1)
    bids = block_table[col]
    offs = tok_pos % bs
    pk[bids, offs] = k[0].to(pk.dtype)
    pv[bids, offs] = v[0].to(pv.dtype)
    kall = _paged_gather(pk, block_table[None, :])
    vall = _paged_gather(pv, block_table[None, :])
    mask = (torch.arange(kall.shape[1], device=x.device)[None, None, :]
            <= tok_pos[None, :, None])
    out = _sdpa(cfg, q, kall, vall, mask)
    return out @ p["wo"].to(x.dtype), pk, pv
