"""Building blocks of the dense decoder, as functions on tensors.

Weights keep the JAX package's layout ``(d_in, d_out)`` with ``x @ W``
(not ``nn.Linear``'s ``(out, in)``), so leaf shapes, the factored (m, n)
orientation and the side S-RSI sketches all match the reference.  Master
weights are fp32; compute casts them to the activation dtype, as the JAX
models do with ``.astype(dt)``.

On a mesh the train step hands the models each rank's blocks of the
parameters and a gather-at-use hook (:func:`gather_hook`): a model passes
each layer's parameters through it inside the layer's remat body, and
the leaves outside the layers where it uses them.  Under the ``tp``
strategy the hook also carries a :class:`ModelSplit` (:func:`model_split`),
and the products split over the mesh's ``model`` axis, Megatron-style:
each rank of a model group computes its range of the MLP's hidden units
(:func:`mlp_apply`, column then row), of the heads
(``attention.attn_apply_full``) and of the vocabulary
(:func:`embed_rows`, :func:`softmax_xent`, :func:`fused_xent_from_hidden`),
the input entering through ``comm.copy_to`` and the partial results
summed by ``comm.reduce_from``, so the residual stream is whole and the
same on every rank of the group between the split products.  Serving on a
mesh takes the same hook and split (``distributed.sharding.serving_view``),
forward only, with the KV cache's sequence split too, over ``model`` or
over the dp axes and ``model`` (:func:`cache_seq_split`).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

_aten = torch.ops.aten
# jax.checkpoint_policies.checkpoint_dots: keep the matmul outputs
_DOTS = (_aten.mm.default, _aten.bmm.default, _aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def no_gather(tree, path: str, stack: bool = False):
    """The gather-at-use hook off a mesh: ``tree`` as it is."""
    return tree


_USE: list = [no_gather]


def gather_hook() -> Callable:
    """``use(tree, path) -> tree``: the parameters ``tree`` (a tensor or a
    nested dict, at ``path`` in the flat parameter paths; a per-layer
    view of a stack takes the stack's path) whole; ``stack=True`` only
    over a stack's leading axis, before :func:`unstack`.  The identity, but
    under :func:`gathering`, which the train step on a mesh sets around
    its forward and backward (``distributed.sharding.GatherAtUse``).  A
    model reads it once a forward and calls it inside each layer's remat
    body, so that a recomputed body gathers again."""
    return _USE[0]


class ModelSplit(NamedTuple):
    """The products split over the mesh's ``model`` axis: its process
    group, this rank's index on it and its size."""
    group: Any
    rank: int
    size: int

    def span(self, n: int) -> tuple:
        """This rank's contiguous range ``[floor(r n / M), floor((r + 1) n
        / M))`` of ``n`` units (heads, hidden units, vocabulary rows): the
        stored block when M divides n."""
        return self.rank * n // self.size, (self.rank + 1) * n // self.size


def model_split(use: Callable) -> Optional[ModelSplit]:
    """The :class:`ModelSplit` the gather hook ``use`` carries (the train
    step's under the ``tp`` strategy on a model axis of more than one
    rank), else None: every product whole."""
    return getattr(use, "split", None)


def use_stored(use: Callable, tree, path: str):
    """``tree`` (at ``path``) as the hook ``use`` stores it over the model
    axis: each leaf split over ``model`` its stored block there, whatever
    range of it the split products use (``sharding.GatherAtUse.stored``;
    the Mamba2 decode step's ``in_proj`` and conv); as it is under a hook
    without that method."""
    stored = getattr(use, "stored", None)
    return tree if stored is None else stored(tree, path)


def cache_seq_split(use: Callable) -> Optional[ModelSplit]:
    """The ranks the serving hook ``use``'s KV cache splits its sequence
    over (flash-decoding, ``distributed.sharding.serving_view``), as a
    :class:`ModelSplit`: their process group, this rank's index in it (its
    block holds rows ``[index n, (index + 1) n)`` of a block of n rows)
    and their count; the model group itself where the sequence splits
    over ``model`` alone, a group of the dp axes and ``model`` where it
    splits over both (the ``long_500k`` cells); None where the rank holds
    every row."""
    return getattr(use, "seq", None)


def take(t: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """``t``'s range ``[lo, hi)`` along ``dim``: ``t`` itself where it holds
    just that range (the rank's block), else a view of it (a leaf given
    whole)."""
    return t if t.shape[dim] == hi - lo else t.narrow(dim, lo, hi - lo)


@contextlib.contextmanager
def gathering(use: Callable):
    prev = _USE[0]
    _USE[0] = use
    try:
        yield
    finally:
        _USE[0] = prev


def remat(mode: str, fn: Callable, *args):
    """``fn(*args)`` under the JAX package's ``remat`` choice: ``"none"``
    keeps every activation for the backward, ``"full"`` keeps only the
    inputs and recomputes the body in the backward, ``"dots"`` keeps the
    matmul outputs and recomputes the rest."""
    if mode == "none":
        return fn(*args)
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def layer_remat(cfg) -> str:
    """The remat mode of a model whose layer body the JAX package
    checkpoints whole under any ``remat`` but "none" (the ssm, hybrid and
    encdec families): "dots" is taken as "full"."""
    return "none" if cfg.remat == "none" else "full"


def unstack(tree: dict, n: int) -> list:
    """The ``n`` per-layer trees of a tree of ``(n, ...)`` stacks, as
    ``torch.unbind`` views: the backward stacks every layer's gradient
    once (indexing each layer instead would write each layer's gradient
    into a zero stack of its own)."""
    flat = {k: unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def dense_init(gen: torch.Generator, shape: tuple, d_in: int,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal weights of ``shape`` (trailing dims (d_in, d_out)) with
    std ``1/sqrt(d_in)`` unless ``scale`` is given."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device) * 0.02


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm computed in fp32, returned in ``x``'s dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computed in fp32, returned in ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def make_norm_params(cfg, shape: tuple, device) -> dict:
    """Norm parameters of ``shape`` (leading stack dims, then d): a scale
    of ones, and a zero shift under ``cfg.norm == "layernorm"``."""
    if cfg.norm == "layernorm":
        return {"w": torch.ones(shape, device=device),
                "b": torch.zeros(shape, device=device)}
    return {"w": torch.ones(shape, device=device)}


def norm_specs(cfg) -> dict:
    """Logical axes of one norm's parameters (``distributed/sharding.py``
    maps them to mesh axes)."""
    if cfg.norm == "layernorm":
        return {"w": ("embed",), "b": ("embed",)}
    return {"w": ("embed",)}


def stacked_specs(name: str, specs: dict) -> dict:
    """``specs`` with the stack axis ``name`` ahead of every leaf's axes."""
    return {k: stacked_specs(name, v) if isinstance(v, dict)
            else (name,) + tuple(v) for k, v in specs.items()}


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """``cfg.norm`` (LayerNorm or RMSNorm) with ``cfg.norm_eps``."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    """The MLP activations.  ``jax.nn.gelu`` defaults to the tanh
    approximation, so the port uses it too; relu2 is relu(x)^2."""
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        r = F.relu(x)
        return r * r
    if name == "silu":
        return F.silu(x)
    raise ValueError(name)


def mlp_init(gen: torch.Generator, cfg, n_layers: int, d: int,
             f: int) -> dict:
    """Stacked MLP weights: gate / up / down under SwiGLU, else up / down;
    zero biases of up and down under ``cfg.mlp_bias``."""
    p = {}
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(gen, (n_layers, d, f), d)
    p["w_up"] = dense_init(gen, (n_layers, d, f), d)
    p["w_down"] = dense_init(gen, (n_layers, f, d), f)
    if cfg.mlp_bias:
        p["b_up"] = torch.zeros((n_layers, f), device=gen.device)
        p["b_down"] = torch.zeros((n_layers, d), device=gen.device)
    return p


def mlp_specs(cfg) -> dict:
    """Logical axes of one layer's MLP weights."""
    s = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if cfg.act == "swiglu":
        s["w_gate"] = ("embed", "mlp")
    if cfg.mlp_bias:
        s["b_up"] = ("mlp",)
        s["b_down"] = ("embed",)
    return s


def mlp_split_ranges(cfg, split: ModelSplit) -> dict:
    """``{leaf: (dim, lo, hi)}``: the range of each MLP leaf's dimension
    ``dim`` that rank ``split.rank`` uses under :func:`mlp_apply`'s split,
    its hidden units ``split.span(d_ff)``."""
    f0, f1 = split.span(cfg.d_ff)
    out = {"w_up": (-1, f0, f1), "w_down": (-2, f0, f1)}
    if cfg.act == "swiglu":
        out["w_gate"] = (-1, f0, f1)
    elif cfg.mlp_bias:
        out["b_up"] = (-1, f0, f1)
    return out


def mlp_apply(cfg, p: dict, x: torch.Tensor,
              split: Optional[ModelSplit] = None) -> torch.Tensor:
    """SwiGLU, or up -> ``cfg.act`` -> down.  As in the JAX package, the
    SwiGLU branch never adds ``b_up``, even under ``mlp_bias``.  Under
    ``split`` the rank computes its range of the hidden units (column-split
    gate / up, row-split down) on ``x`` entering through ``copy_to``, the
    parts are summed over the model axis (one all-reduce) and ``b_down``
    is added once, after the sum; each leaf may be the rank's block or
    whole (:func:`take`)."""
    if split is not None:
        from repro_torch.distributed import comm
        ranges = mlp_split_ranges(cfg, split)
        p = {k: take(v, *ranges[k]) if k in ranges else v
             for k, v in p.items()}
        x = comm.copy_to(x, split.group)
    dt = x.dtype
    if cfg.act == "swiglu":
        gate = x @ p["w_gate"].to(dt)
        up = x @ p["w_up"].to(dt)
        h = F.silu(gate) * up
    else:
        h = x @ p["w_up"].to(dt)
        if cfg.mlp_bias:
            h = h + p["b_up"].to(dt)
        h = _act(cfg.act, h)
    out = h @ p["w_down"].to(dt)
    if split is not None:
        out = comm.reduce_from(out, split.group)
    if cfg.mlp_bias and "b_down" in p:
        out = out + p["b_down"].to(dt)
    return out


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S).  Rotates
    the interleaved pairs (x[..., ::2], x[..., 1::2]) by angles taken in
    fp32 from the positions, as the JAX package does (not the half-split
    ``rotate_half`` of other codebases)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (dh/2,)
    angles = positions[..., None].float() * freqs           # (..., S, dh/2)
    cos = torch.cos(angles)[..., :, None, :]                # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., ::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor,
               split: Optional[ModelSplit] = None) -> torch.Tensor:
    """``table[tokens]``.  Under ``split`` ``table`` is this rank's block of
    the vocabulary's rows (``split.rank``-th of ``split.size``): a token
    outside it gives a zero row, and the rows are summed over the model
    axis (``reduce_from``: one nonzero term each, so the sum is exact)."""
    if split is None:
        return table[tokens]
    from repro_torch.distributed import comm
    n = table.shape[0]
    local = tokens - split.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, 0)]
    rows = torch.where(inside[..., None], rows, torch.zeros(
        (), dtype=rows.dtype, device=rows.device))
    return comm.reduce_from(rows, split.group)


def vocab_split(cfg, use: Callable) -> Optional[ModelSplit]:
    """The hook ``use``'s split where the vocabulary splits under it (the
    model axis divides it), else None."""
    split = model_split(use)
    if split is None or cfg.vocab % split.size:
        return None
    return split


def vocab_split_ranges(cfg, split: ModelSplit) -> dict:
    """The split products of an untied ``embed`` / ``lm_head`` pair: the
    rank's rows of the vocabulary, where the model axis divides it."""
    if cfg.vocab % split.size:
        return {}
    v0, v1 = split.span(cfg.vocab)
    return {"embed": (-2, v0, v1), "lm_head": (-1, v0, v1)}


def head_logits(x: torch.Tensor, head: torch.Tensor,
                split: Optional[ModelSplit] = None) -> torch.Tensor:
    """``x @ head`` in ``x``'s dtype; under ``split`` ``head`` is the rank's
    block of the vocabulary's columns and ``x`` enters through
    ``copy_to``."""
    if split is not None:
        from repro_torch.distributed import comm
        x = comm.copy_to(x, split.group)
    return x @ head.to(x.dtype)


def whole_logits(logits: torch.Tensor,
                 split: Optional[ModelSplit] = None) -> torch.Tensor:
    """The serving paths' logits: under the vocabulary's ``split`` every
    rank's block concatenated over the model axis, so each rank returns
    the whole (B, S, V)."""
    if split is None:
        return logits
    from repro_torch.distributed import comm
    return comm.all_concat(logits, -1, split.group)


def _nll(logits: torch.Tensor, targets: torch.Tensor,
         split: Optional[ModelSplit] = None) -> torch.Tensor:
    """Each position's ``logsumexp(logits) - logits[target]``, ``logits``
    fp32.  Under ``split`` they are this rank's block of the vocabulary:
    the max (held fixed), the sum of exponentials and the gold logit are
    each reduced over the model axis, so every rank returns the same
    values and its backward reaches its own block's logits only."""
    if split is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long().unsqueeze(-1))[..., 0]
        return logz - gold
    from repro_torch.distributed import comm
    n = logits.shape[-1]
    with torch.no_grad():
        m = comm.all_max(torch.amax(logits, dim=-1), split.group)
    sumexp = comm.reduce_from(torch.sum(torch.exp(logits - m[..., None]),
                                        dim=-1), split.group)
    local = targets.long() - split.rank * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)
                        .unsqueeze(-1))[..., 0]
    gold = comm.reduce_from(torch.where(inside, gold, torch.zeros(
        (), dtype=gold.dtype, device=gold.device)), split.group)
    return m + torch.log(sumexp) - gold


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 split: Optional[ModelSplit] = None) -> torch.Tensor:
    """Mean token-level cross entropy, logits upcast to fp32; under
    ``split`` the logits are this rank's vocabulary block (:func:`_nll`)."""
    return torch.mean(_nll(logits.float(), targets, split))


def _chunk_nll(xc: torch.Tensor, head: torch.Tensor, tc: torch.Tensor,
               mc: torch.Tensor, split: Optional[ModelSplit] = None
               ) -> torch.Tensor:
    logits = (xc @ head.to(xc.dtype)).float()
    return torch.sum(_nll(logits, tc, split) * mc)


def fused_xent_from_hidden(x: torch.Tensor, head: torch.Tensor,
                           targets: torch.Tensor, chunk: int = 512,
                           split: Optional[ModelSplit] = None
                           ) -> torch.Tensor:
    """Cross entropy from the pre-head hiddens in sequence chunks, each
    chunk's logits recomputed in the backward, so the (B, S, V) fp32
    logits never exist.  x: (B, S, D); head: (D, V); targets: (B, S);
    returns the mean nll over the first S-1 positions (next-token), padded
    to whole chunks with target 0 and mask 0, as the JAX package's
    ``fused_xent_from_hidden``.  Under ``split`` ``head`` is this rank's
    block of the vocabulary's columns and ``x`` enters through
    ``copy_to`` (:func:`_nll`)."""
    if split is not None:
        from repro_torch.distributed import comm
        x = comm.copy_to(x, split.group)
    b, s, d = x.shape
    s_eff = s - 1
    n_chunks = max(1, (s_eff + chunk - 1) // chunk)
    pad = n_chunks * chunk - s_eff
    xs = F.pad(x[:, :s_eff, :], (0, 0, 0, pad))
    ts = F.pad(targets[:, 1:s_eff + 1], (0, pad))
    msk = F.pad(torch.ones((b, s_eff), dtype=torch.float32,
                           device=x.device), (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + ckpt.checkpoint(_chunk_nll, xs[:, sl], head,
                                        ts[:, sl], msk[:, sl], split,
                                        use_reentrant=False)
    return total / (b * s_eff)
