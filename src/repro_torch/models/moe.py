"""Mixture-of-experts block: top-k routing with capacity and drops, the
single-shard path of the JAX package's ``models/moe.py``.  The
expert-parallel mesh paths (``moe_apply_sharded``, ``moe_apply_ep_tp``)
belong with the distributed modules (ROADMAP.md Queue A).

Two implementations sharing the router:

* ``dense``: every expert on every token, exact weighted combine.  O(E)
  compute: only for tiny configs and as the correctness oracle.
* ``sort``: tokens sorted by expert id, packed into fixed-capacity
  per-expert buffers, batched expert GEMMs, combine.  Pairs past an
  expert's capacity are dropped (zero output, zero gradient).

The sort path is deterministic on the card, with no float atomics
forward or backward, so a step repeats bitwise: every kept (token, k)
pair has a slot of its own and every dropped pair goes to one discarded
sentinel row, so the dispatch is an index write, not an accumulate; the
combine takes the (T, k) layout back through the inverse permutation and
sums the k contributions of each token in a fixed order.  Every gather
is a permutation or lands its repeats only on the sentinel row, so its
backward adds each gradient once to zero.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def moe_init(gen: torch.Generator, cfg, n_layers: int) -> dict:
    """Stacked router (L, D, E) and expert weights (L, E, D, F) /
    (L, E, F, D), fp32."""
    spec = cfg.moe
    d, e, fe = cfg.d_model, spec.n_experts, spec.d_ff_expert
    dev = gen.device
    s = 1.0 / math.sqrt(d)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return {
        "router": dense_init(gen, (n_layers, d, e), d),
        "w_gate": randn(n_layers, e, d, fe) * s,
        "w_up": randn(n_layers, e, d, fe) * s,
        "w_down": randn(n_layers, e, fe, d) * (1.0 / math.sqrt(fe)),
    }


def _route(cfg, router_w: torch.Tensor, xf: torch.Tensor):
    """xf: (T, D) -> (gates (T, k), idx (T, k), aux_loss scalar): the
    router in fp32, softmax, top-k renormalised, and the Switch-style
    load-balance loss E * sum_e f_e * p_e from the top-1 assignment.
    ``jax.lax.top_k`` breaks ties toward the lower index and
    ``torch.topk`` promises no order; fp32 probabilities tie with
    probability zero, so the two agree on real inputs."""
    spec = cfg.moe
    logits = xf.float() @ router_w.float()                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, spec.top_k, dim=-1)
    gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
    e = spec.n_experts
    me = torch.mean(probs, dim=0)                                 # (E,)
    fe = torch.mean(F.one_hot(idx[:, 0], e).float(), dim=0)
    aux = e * torch.sum(me * fe)
    return gates, idx, aux


def _expert_mlp(cfg, p: dict, h: torch.Tensor) -> torch.Tensor:
    """h: (E, C, D) -> (E, C, D): each expert's SwiGLU as batched GEMMs in
    the compute dtype."""
    dt = h.dtype
    gate = torch.bmm(h, p["w_gate"].to(dt))
    up = torch.bmm(h, p["w_up"].to(dt))
    return torch.bmm(F.silu(gate) * up, p["w_down"].to(dt))


def _capacity(t: int, cfg) -> int:
    spec = cfg.moe
    return max(1, int(math.ceil(t * spec.top_k / spec.n_experts
                                * spec.capacity_factor)))


def _moe_core_sort(cfg, p: dict, xf: torch.Tensor, capacity: int):
    """Sort-based dispatch over all experts.  xf: (T, D) -> (y (T, D),
    aux)."""
    spec = cfg.moe
    t, d = xf.shape
    k, e = spec.top_k, spec.n_experts
    dev = xf.device
    gates, idx, aux = _route(cfg, p["router"], xf)

    flat_e = idx.reshape(-1)                                      # (T*k,)
    # stable, as jnp.argsort: within an expert, pairs keep token order
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order)              # sorted position of each pair
    se = flat_e[order]
    sg = gates.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[se]
    keep = pos < capacity
    sentinel = e * capacity
    slot = torch.where(keep, se * capacity + pos,
                       torch.full_like(se, sentinel))

    # dispatch: each kept pair writes its own slot; the sentinel row
    # (every dropped pair) is cut off
    # (expand's backward is a sum over k; repeat_interleave's would be a
    # float index_add)
    x_sorted = xf[:, None, :].expand(t, k, d).reshape(t * k, d)[order]
    buf = torch.zeros((sentinel + 1, d), dtype=xf.dtype,
                      device=dev).index_put((slot,), x_sorted)
    out = _expert_mlp(cfg, p, buf[:-1].reshape(e, capacity, d))
    out = torch.cat([out.reshape(sentinel, d),
                     torch.zeros((1, d), dtype=out.dtype, device=dev)])
    w = (sg * keep.float())[:, None].to(out.dtype)
    contrib = out[slot] * w                          # sorted order
    # combine: back to the (T, k) layout, the k terms summed in order
    y = contrib[inv].reshape(t, k, d).sum(dim=1)
    return y.to(xf.dtype), aux


def moe_apply_local(cfg, p: dict, x: torch.Tensor):
    """Single-shard MoE.  x: (B, S, D) -> (y (B, S, D), aux_loss)."""
    spec = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    if spec.impl == "dense":
        gates, idx, aux = _route(cfg, p["router"], xf)
        outs = _expert_mlp(cfg, p, xf[None].expand(spec.n_experts, -1, -1)
                           .contiguous())                         # (E, T, D)
        onehot = F.one_hot(idx, spec.n_experts).float()           # (T, k, E)
        w = torch.einsum("tk,tke->te", gates, onehot)             # (T, E)
        y = torch.einsum("te,etd->td", w.to(outs.dtype), outs)
    else:
        y, aux = _moe_core_sort(cfg, p, xf, _capacity(b * s, cfg))
    return y.reshape(b, s, d), aux
