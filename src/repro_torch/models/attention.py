"""Grouped-query attention, the JAX package's ``models/attention.py``:
over a whole sequence (training, prefill; causal, or full for an encoder
and cross-attention), dispatched as its ``sdpa_auto`` does: the naive
score matrix upcast to fp32 (``_sdpa``) or the chunked online-softmax path
(``_sdpa_chunked``), which here is the flash-attention kernel
(``kernels/ops.py::FlashAttention``); and the serving paths against a
dense KV cache (``attn_prefill``, ``attn_decode``) or a paged block pool
(``attn_decode_paged``, ``attn_prefill_paged``), which run the naive
``_sdpa`` as in JAX.

Under a ``layers.ModelSplit`` (the train step's ``tp`` strategy on a
model axis of more than one rank) ``attn_apply_full`` runs the heads
split over ``model``, Megatron-style: rank r of M takes the contiguous q
heads ``[floor(r H / M), floor((r + 1) H / M))`` and the KV heads they
read (:func:`head_split`), the input entering through ``comm.copy_to``
and the output product's partial sums added by ``comm.reduce_from``.
The projections, norms, RoPE and both attention paths take their head
counts and the q-to-kv grouping from the tensors they are given.

Cross attention (the encoder-decoder's) splits the same way
(:func:`cross_attn_split`): the rank's q heads of the decoder's stream
over its kv heads of the encoder's output.

Serving on a mesh (``split`` given to ``attn_prefill`` / ``attn_decode``)
splits the heads the same way and keeps the KV cache's sequence split
over ``model``, or over the dp axes and ``model`` (flash-decoding): the
prefill's rank heads attend through ``sdpa_auto`` and each rank writes
its rows of the cache for every kv head; a decode step attends every head
over the rank's rows and combines the ranks' parts by log-sum-exp (see
"serving on a mesh" below).  A cross cache keeps its encoder rows over
``model`` where they divide, else whole (:func:`cross_cache_rows`,
:func:`cross_decode_rows`).

The serving paths write the cache in place (the JAX functions return an
updated copy, which the engines donate); they return the cache all the
same, so the call sites read as JAX's.  Where JAX clamps an index that a
serving path can push out of range, the port clamps it too: the dense
decode's write position to the cache's last row (``dynamic_update_slice``),
the paged prefill's block index to the table's last column (a gather).
"""
from __future__ import annotations

import functools
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


def _project(cfg, p: dict, x: torch.Tensor, name: str,
             positions: torch.Tensor) -> torch.Tensor:
    """One of q, k, v (``name``), (B, S, n, dh): the projection, then the
    bias, then (q and k) RMSNorm per head, then RoPE at ``positions``, in
    the JAX package's order; n the heads the weight holds (a rank's range
    under a split, or every head)."""
    hd = cfg.resolved_head_dim
    dt = x.dtype
    t = x @ p["w" + name].to(dt)
    if cfg.qkv_bias:
        t = t + p["b" + name].to(dt)
    t = t.reshape(*x.shape[:2], t.shape[-1] // hd, hd)
    if name == "v":
        return t
    if cfg.qk_norm:
        t = L.rms_norm(t, p[name + "_norm"], cfg.norm_eps)
    if cfg.pos_embedding == "rope":
        t = L.apply_rope(t, positions, cfg.rope_theta)
    return t


def _project_qkv(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """q (B, S, H, dh), k / v (B, S, KV, dh) (:func:`_project`); H and KV
    are the heads the weights hold (a rank's range under a split)."""
    return tuple(_project(cfg, p, x, name, positions) for name in "qkv")


def _sdpa(cfg, q, k, v, mask):
    """q: (B, Sq, H, dh), k/v: (B, Sk, KV, dh), mask: (B|1, Sq, Sk) bool;
    q head h reads kv head h // (H / KV)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(b, sq, kv, h // kv if kv else 1, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(),
                          k.float()) / math.sqrt(float(hd))
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full((), NEG_INF, dtype=logits.dtype,
                                    device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(b, sq, h * hd)


def _sdpa_chunked(cfg, q, k, v, *, causal: bool):
    """Exact attention without a score matrix: the flash-attention forward
    and recompute backward (fp32 scores and ``p v``), q (B, Sq, H, dh),
    k / v (B, Sk, KV, dh) -> (B, Sq, H * dh)."""
    b, sq, h, hd = q.shape
    return ops.FlashAttention.apply(q, k, v, causal).reshape(b, sq, h * hd)


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


def head_split(cfg, split) -> tuple:
    """``(h0, h1, kv0, kv1)``: the q heads ``[h0, h1)`` rank
    ``split.rank`` takes (``split.span(H)``) and the KV heads ``[kv0,
    kv1)`` they read (q head h reads kv head h // (H / KV))."""
    h0, h1 = split.span(cfg.n_heads)
    g = cfg.n_heads // cfg.n_kv_heads
    kv0 = h0 // g
    return h0, h1, kv0, -(-h1 // g) if h1 > h0 else kv0


def attn_split_ranges(cfg, split) -> dict:
    """``{leaf: (dim, lo, hi)}``: the range of each attention leaf's
    dimension ``dim`` that rank ``split.rank`` uses (:func:`head_split`'s
    heads times the head dimension); the per-head q / k norm scales
    (``dim`` None) are used whole, their gradient a part on each rank."""
    h0, h1, kv0, kv1 = head_split(cfg, split)
    hd = cfg.resolved_head_dim
    q, kv = (-1, h0 * hd, h1 * hd), (-1, kv0 * hd, kv1 * hd)
    out = {"wq": q, "wk": kv, "wv": kv, "wo": (-2, h0 * hd, h1 * hd)}
    if cfg.qkv_bias:
        out.update(bq=q, bk=kv, bv=kv)
    if cfg.qk_norm:
        out.update(q_norm=(None, 0, 0), k_norm=(None, 0, 0))
    return out


def _rank_params(cfg, p: dict, split) -> dict:
    """``p`` with each leaf rank ``split.rank``'s range
    (:func:`attn_split_ranges`): the rank's block, or a view of the leaf
    given whole (``layers.take``)."""
    ranges = attn_split_ranges(cfg, split)
    return {k: L.take(v, *ranges[k]) if ranges.get(k, (None,))[0] is not None
            else v for k, v in p.items()}


def _rank_kv(cfg, split, hl: int, k: torch.Tensor, v: torch.Tensor):
    """k / v of the rank's kv heads (B, S, KV_r, dh) as its ``hl`` q heads
    read them: as they are where the q heads map onto them in equal
    groups, else (a range that straddles a group boundary unevenly) each
    q head its own copy of the kv head it reads."""
    if hl == 0:
        return k, v
    h0, _, kv0, _ = head_split(cfg, split)
    g = cfg.n_heads // cfg.n_kv_heads
    idx = [(h0 + i) // g - kv0 for i in range(hl)]
    kvl = k.shape[2]
    if hl % kvl or idx != [i // (hl // kvl) for i in range(hl)]:
        sel = torch.tensor(idx, device=k.device)
        return k.index_select(2, sel), v.index_select(2, sel)
    return k, v


def _rank_heads(cfg, p: dict, x: torch.Tensor, positions, causal: bool,
                split):
    """Rank ``split.rank``'s heads over the whole sequence: ``(out (B, S,
    H_r dh) before the output product, k / v of its kv heads (B, S, KV_r,
    dh), p with each leaf the rank's range)`` (:func:`_rank_params`,
    :func:`_rank_kv`), the input entering through ``copy_to``."""
    from repro_torch.distributed import comm
    p = _rank_params(cfg, p, split)
    x = comm.copy_to(x, split.group)
    q, k, v = _project_qkv(cfg, p, x, positions)
    b, s, hl, hd = q.shape
    if hl == 0:     # more ranks than heads: empty, but in the graph alike
        return _sdpa(cfg, q, k, v, torch.ones(
            (1, s, s), dtype=torch.bool, device=x.device)), k, v, p
    kq, vq = _rank_kv(cfg, split, hl, k, v)
    return sdpa_auto(cfg, q, kq, vq, causal=causal), k, v, p


def _split_heads(cfg, p: dict, x: torch.Tensor, positions, causal: bool,
                 split) -> torch.Tensor:
    """:func:`attn_apply_full` on rank ``split.rank``'s heads (see the
    module docstring and :func:`_rank_heads`), the output product's parts
    summed over the model axis."""
    from repro_torch.distributed import comm
    out, _, _, p = _rank_heads(cfg, p, x, positions, causal, split)
    return comm.reduce_from(out @ p["wo"].to(x.dtype), split.group)


def attn_apply_full(cfg, p: dict, x: torch.Tensor, *, causal: bool,
                    positions: Optional[torch.Tensor] = None,
                    kv_override: Optional[tuple] = None,
                    split=None) -> torch.Tensor:
    """Full-sequence attention (training, the encoder): causal or not,
    positions ``arange(S)`` unless given; ``kv_override`` (k, v) replaces
    the projected keys and values (cross-attention on the encoder's);
    ``split`` (a ``layers.ModelSplit``, no ``kv_override``: the split
    cross attention is :func:`cross_attn_split`) runs this rank's heads
    and sums the output over the model axis."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if split is not None:
        if kv_override is not None:
            raise ValueError("kv_override under a split: use "
                             "cross_attn_split")
        return _split_heads(cfg, p, x, positions, causal, split)
    q, k, v = _project_qkv(cfg, p, x, positions)
    if kv_override is not None:
        k, v = kv_override
    return sdpa_auto(cfg, q, k, v, causal=causal) @ p["wo"].to(x.dtype)


def _plain_project(p: dict, x: torch.Tensor, name: str,
                   hd: int) -> torch.Tensor:
    """``x @ w<name>`` as (B, S, n, dh): a cross attention's projection,
    as JAX's encoder-decoder projects it (no bias, norm or position)."""
    t = x @ p["w" + name].to(x.dtype)
    return t.reshape(*x.shape[:2], t.shape[-1] // hd, hd)


def cross_attn_split(cfg, p: dict, h: torch.Tensor, split,
                     enc: Optional[torch.Tensor] = None,
                     kv: Optional[tuple] = None):
    """Cross attention (the JAX encoder-decoder's ``_cross_attend``: plain
    projections, the naive ``_sdpa`` under an all-true mask) on rank
    ``split.rank``'s heads: q of its heads of ``h`` (B, S, D); k / v of
    its kv heads projected from ``enc`` (the encoder's output, (B, S_enc,
    D)) or read from ``kv`` ((k, v) of every kv head over every encoder
    row: a cross cache the rank holds whole); ``h`` and ``enc`` entering
    through ``copy_to`` (so each decoder layer's use of the encoder's
    output sums its gradient over ``model``), the output through the
    rank's rows of ``wo``, the parts summed by ``reduce_from``.  Each
    leaf the rank's block or whole; the q-to-kv mapping and a headless
    rank's empty output as :func:`_rank_heads`'.  Returns ``(out, k, v)``,
    k / v the rank's kv heads (B, S_enc, KV_r, dh)."""
    from repro_torch.distributed import comm
    hd = cfg.resolved_head_dim
    p = _rank_params(cfg, p, split)
    h = comm.copy_to(h, split.group)
    q = _plain_project(p, h, "q", hd)
    if kv is None:
        enc = comm.copy_to(enc, split.group)
        k, v = _plain_project(p, enc, "k", hd), _plain_project(p, enc, "v",
                                                               hd)
    else:
        _, _, kv0, kv1 = head_split(cfg, split)
        k, v = kv[0][:, :, kv0:kv1], kv[1][:, :, kv0:kv1]
    kq, vq = _rank_kv(cfg, split, q.shape[2], k, v)
    mask = torch.ones((1, h.shape[1], k.shape[1]), dtype=torch.bool,
                      device=h.device)
    out = _sdpa(cfg, q, kq, vq, mask)
    return comm.reduce_from(out @ p["wo"].to(h.dtype), split.group), k, v


def attn_prefill(cfg, p: dict, x: torch.Tensor, cache: KVCache,
                 split=None, seq=None):
    """Causal attention over the prompt x (B, S, D) through ``sdpa_auto``
    (the flash kernel where JAX takes ``_sdpa_chunked``); fills
    ``cache[:, :S]``.  Returns ``(out, cache)``.  Under ``split`` (a
    ``layers.ModelSplit``; serving on a mesh) the rank's heads attend and
    ``cache`` is the rank's block, of rows split over ``seq``
    (``layers.cache_seq_split``; :func:`_prefill_split`)."""
    if split is not None:
        return _prefill_split(cfg, p, x, cache, split, seq)
    s = x.shape[1]
    q, k, v = _project_qkv(cfg, p, x, torch.arange(s, device=x.device)[None])
    out = sdpa_auto(cfg, q, k, v, causal=True)
    cache.k[:, :s] = k.to(cache.k.dtype)
    cache.v[:, :s] = v.to(cache.v.dtype)
    return out @ p["wo"].to(x.dtype), cache


def attn_decode(cfg, p: dict, x: torch.Tensor, cache: KVCache, pos: int,
                split=None, seq=None):
    """One-token step, x (B, 1, D) at position ``pos`` (an int): its k / v
    written at row ``min(pos, S_max - 1)`` (JAX's clamp), attention over
    rows ``<= pos``.  Returns ``(out, cache)``.  Under ``split`` ``cache``
    is the rank's block, of rows split over ``seq``
    (:func:`_decode_split`)."""
    if split is not None:
        return _decode_split(cfg, p, x, cache, pos, split, seq)
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


# -- serving on a mesh --------------------------------------------------------
# Megatron's heads over ``model`` with the KV cache's sequence split too
# (flash-decoding): over ``seq`` (``layers.cache_seq_split``), the model
# group, or the dp axes and ``model`` (the ``long_500k`` cells: B = 1, the
# batch not split), the dp axes the major ones, so each model group holds
# one contiguous segment of the sequence.  The rank of index i in ``seq``
# holds cache rows [i n, (i + 1) n) of every kv head (n the block's rows;
# all of them where the sequence is not split, ``seq`` None) for its batch
# block, and the residual stream is whole on every rank of the model group.

def _cache_rows(cache: KVCache, seq) -> tuple:
    """``(first row, rows of the whole cache)`` of the rank's block."""
    n = cache.k.shape[1]
    return (seq.rank * n, n * seq.size) if seq is not None else (0, n)


def _all_heads(t: torch.Tensor, n: int, split) -> torch.Tensor:
    """(B, S, h, dh) of the rank's block of ``n`` heads (a "block" leaf's
    projection) -> every head, concatenated over the model axis in rank
    order; ``t`` itself where it holds them all (a leaf given whole)."""
    from repro_torch.distributed import comm
    return t if t.shape[2] == n else comm.all_concat(t, 2, split.group)


def _prompt_rows(cfg, p: dict, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, c0: int, n: int, split, seq,
                 project=None):
    """k / v of every kv head at the prompt's rows ``[c0, c0 + n)`` (fewer
    where the prompt ends first; None where it ends before ``c0``).

    Two routes, by what the rank holds.  Where ``wk`` / ``wv`` reach the
    rank whole (the "slice" route: kv heads fewer than the model ranks, or
    not aligned with them; or replicated), the rank projects its rows of
    the residual, which every rank holds whole, at their positions
    (``project(rows, name, positions)``, :func:`_project` by default): no
    collective.  Where they are the rank's block of kv heads (the "block"
    route: each rank owns KV / M heads, and gathering the weights would
    move them), the rank has projected its heads at every position for its
    own attention already, and one ``all_to_all`` over ``model`` turns the
    head blocks of the model group's segment of the prompt (its rows
    ``[c0 - r n, c0 + (M - r) n)``, padded to ``M n``) into the ranks'
    sequence blocks, a tensor the size of the rank's cache block; with the
    sequence not split (``seq`` None), the heads are all-gathered instead.
    A rank whose rows lie past the prompt gets none and still takes part
    in the collective."""
    from repro_torch.distributed import comm
    s = x.shape[1]
    e = min(c0 + n, s)
    if p["wk"].shape[-1] == cfg.n_kv_heads * cfg.resolved_head_dim:
        if e <= c0:
            return None
        rows = x[:, c0:e]
        pos = torch.arange(c0, e, device=x.device)[None]
        if project is None:
            project = functools.partial(_project, cfg, p)
        return project(rows, "k", pos), project(rows, "v", pos)
    if seq is None:
        return (comm.all_concat(k, 2, split.group),
                comm.all_concat(v, 2, split.group))
    if seq.rank % split.size != split.rank:
        raise ValueError(f"the sequence group's index {seq.rank} does not "
                         f"put model rank {split.rank} of {split.size} "
                         f"minor")
    g0, m = c0 - split.rank * n, n * split.size

    def rows_of(t):       # every rank of the group takes part
        t = t[:, g0:g0 + m]
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, m - t.shape[1]))
        return comm.all_to_all(t, 1, 2, split.group)[:, :max(e - c0, 0)]

    return rows_of(k), rows_of(v)


def _prefill_split(cfg, p: dict, x: torch.Tensor, cache: KVCache, split,
                   seq):
    """:func:`attn_prefill` on rank ``split.rank``'s heads
    (:func:`_rank_heads`, so past ``CHUNK_THRESHOLD`` tokens the flash
    kernel runs on the rank's heads), the output product's parts summed
    over the model axis; the rank writes its block of the cache, the
    prompt's rows it holds for every kv head (:func:`_prompt_rows`)."""
    from repro_torch.distributed import comm
    s = x.shape[1]
    out, k, v, pr = _rank_heads(cfg, p, x, torch.arange(
        s, device=x.device)[None], True, split)
    c0, _ = _cache_rows(cache, seq)
    rows = _prompt_rows(cfg, p, x, k, v, c0, cache.k.shape[1], split, seq)
    if rows is not None:
        m = rows[0].shape[1]        # 0: the prompt ends before the block
        cache.k[:, :m] = rows[0].to(cache.k.dtype)
        cache.v[:, :m] = rows[1].to(cache.v.dtype)
    return comm.reduce_from(out @ pr["wo"].to(x.dtype), split.group), cache


def _sdpa_rows(q, k, v, mask, group) -> torch.Tensor:
    """``_sdpa`` of q (B, Sq, H, dh) over the cache rows each rank of
    ``group`` holds (k / v (B, n, KV, dh), ``mask`` (B|1, Sq, n)), the
    ranks' parts combined by log-sum-exp: the maximum score over every
    rank's unmasked rows, then the values they weight and the sums of
    the exponentials, summed over the group in one collective (each
    entry's sum as two would give it).  fp32 scores and sums, as
    ``_sdpa``; a rank whose rows are all masked adds exact zeros."""
    from repro_torch.distributed import comm
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(b, sq, kv, h // kv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(),
                     k.float()) / math.sqrt(float(hd))
    s = torch.where(mask[:, None, None, :, :], s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    m = comm.all_max(s.amax(dim=-1, keepdim=True), group)
    e = torch.exp(s - m)
    num = torch.einsum("bkgqs,bskh->bqkgh", e, v.float())
    den = e.sum(dim=-1).permute(0, 3, 1, 2)[..., None]    # (b, q, kv, g, 1)
    both = comm.all_sum(torch.cat([num, den], dim=-1), group)
    out = both[..., :hd] / both[..., hd:]
    return out.to(v.dtype).reshape(b, sq, h * hd)


def _heads_out(cfg, p: dict, out: torch.Tensor, dt, split) -> torch.Tensor:
    """Every head's attention output (B, S, H dh) -> the slice of the
    rank's heads through its rows of ``wo``, the parts summed over the
    model axis."""
    from repro_torch.distributed import comm
    hd = cfg.resolved_head_dim
    h0, h1, _, _ = head_split(cfg, split)
    wo = L.take(p["wo"], -2, h0 * hd, h1 * hd)
    return comm.reduce_from(out[..., h0 * hd:h1 * hd] @ wo.to(dt),
                            split.group)


def _decode_split(cfg, p: dict, x: torch.Tensor, cache: KVCache, pos: int,
                  split, seq):
    """:func:`attn_decode` on the rank's block of the cache: q, k and v of
    every head (the rank's heads projected and all-gathered over the model
    axis, a few hundred bytes a token; or projected whole where the
    weights reach the rank whole); the new row written only by the rank
    of ``seq`` that holds row ``min(pos, S_max - 1)``; every head attends
    over the rank's rows and the parts of ``seq``'s ranks combine by
    log-sum-exp (:func:`_sdpa_rows`; where the sequence is not split,
    every rank holds every row and attends alone); the output's slice of
    the rank's heads goes through its rows of ``wo``, the parts summed
    over the model axis.  A rank without a head takes part in every
    collective."""
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, torch.full((b, 1), pos,
                                                 device=x.device))
    q = _all_heads(q, cfg.n_heads, split)
    k = _all_heads(k, cfg.n_kv_heads, split)
    v = _all_heads(v, cfg.n_kv_heads, split)
    c0, s_max = _cache_rows(cache, seq)
    n = cache.k.shape[1]
    row = min(max(pos, 0), s_max - 1) - c0
    if 0 <= row < n:
        cache.k[:, row] = k[:, 0].to(cache.k.dtype)
        cache.v[:, row] = v[:, 0].to(cache.v.dtype)
    mask = (c0 + torch.arange(n, device=x.device))[None, None, :] <= pos
    if seq is not None:
        out = _sdpa_rows(q, cache.k, cache.v, mask, seq.group)
    else:
        out = _sdpa(cfg, q, cache.k, cache.v, mask)
    return _heads_out(cfg, p, out, x.dtype, split), cache


# A cross cache (L, 2, B, S_enc, KV, dh) holds the encoder rows over
# ``model`` where M divides S_enc (rank r its rows [r n, (r + 1) n) of
# every kv head), else every row on every rank; the two routes below.

def cross_cache_rows(cfg, p: dict, enc: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, n: int, split) -> tuple:
    """k / v of every kv head at the rank's ``n`` rows of the cross cache:
    its block ``[r n, (r + 1) n)`` where ``n`` is less than the encoder's
    rows, else all of them; from ``enc`` (B, S_enc, D) and the rank's kv
    heads ``k`` / ``v`` of it (:func:`cross_attn_split`), by
    :func:`_prompt_rows`' two routes on the plain projections."""
    hd = cfg.resolved_head_dim
    seq = split if n < enc.shape[1] else None
    return _prompt_rows(cfg, p, enc, k, v, split.rank * n if seq else 0, n,
                        split, seq, lambda rows, name, _:
                        _plain_project(p, rows, name, hd))


def cross_decode_rows(cfg, p: dict, h: torch.Tensor, ck: torch.Tensor,
                      cv: torch.Tensor, split) -> torch.Tensor:
    """One token's cross attention over the rank's rows of a cross cache
    split over ``model`` (``ck`` / ``cv`` (B, n, KV, dh) of every kv
    head): every head's q (the rank's heads projected and all-gathered
    over the model axis, or projected whole where ``wq`` reaches the rank
    whole) attends over the rank's rows, the ranks' parts combined by
    log-sum-exp (:func:`_sdpa_rows`, every row unmasked), the rank's
    heads' slice through its rows of ``wo``, summed over the model axis.
    No cache row moves."""
    q = _all_heads(_plain_project(p, h, "q", cfg.resolved_head_dim),
                   cfg.n_heads, split)
    mask = torch.ones((1, h.shape[1], ck.shape[1]), dtype=torch.bool,
                      device=h.device)
    return _heads_out(cfg, p, _sdpa_rows(q, ck, cv, mask, split.group),
                      h.dtype, split)


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
