"""Mixture-of-experts block: top-k routing with capacity and drops, the
JAX package's ``models/moe.py``: the single-shard path and the two
expert-parallel mesh paths (``moe_apply_sharded`` for training,
``moe_apply_ep_tp`` weights-stationary for decode).  On a mesh each rank
routes its tokens over every expert, computes its own slice of experts
(``_moe_core_sort``'s ``e0, e_local``) and the slices' outputs are summed
over the mesh (``distributed/comm.py``, a fixed-order sum).

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


def moe_specs(cfg) -> dict:
    """Logical axes of one layer's router and expert weights."""
    return {"router": ("embed", "experts_router"),
            "w_gate": ("experts", "embed", "expert_mlp"),
            "w_up": ("experts", "embed", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "embed")}


def _moe_core_sort(cfg, p: dict, xf: torch.Tensor, capacity: int,
                   e0: int = 0, e_local: int | None = None):
    """Sort-based dispatch for experts [e0, e0 + e_local) (all of them by
    default); ``p``'s expert weights hold just those.  xf: (T, D) -> (y
    (T, D), aux): y sums the contributions of those experts only, aux is
    the router's over all of them.  A pair routed elsewhere sorts into a
    sentinel segment after the local experts and is dropped there; over
    every expert the sort key is the expert id itself, so the full path
    is unchanged."""
    spec = cfg.moe
    t, d = xf.shape
    k = spec.top_k
    e = spec.n_experts if e_local is None else e_local
    dev = xf.device
    gates, idx, aux = _route(cfg, p["router"], xf)

    flat_e = idx.reshape(-1)                                      # (T*k,)
    if e0 or e != spec.n_experts:
        local = flat_e - e0
        flat_e = torch.where((local >= 0) & (local < e), local,
                             torch.full_like(local, e))
    # stable, as jnp.argsort: within an expert, pairs keep token order
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order)              # sorted position of each pair
    se = flat_e[order]
    sg = gates.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(e + 1, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[se]
    keep = (pos < capacity) & (se < e)
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


def moe_apply_sharded(cfg, p: dict, x: torch.Tensor, mesh,
                      dp_axes: tuple = ("data",), model_axis: str = "model",
                      gather_axes: tuple = ("data",)):
    """Expert-parallel MoE over ``model_axis`` (training).

    x: (B, S, D), this rank's block of the batch (split over ``dp_axes``,
    the same on every rank of the model axis).  ``p["router"]`` is whole;
    the expert weights are this rank's blocks, as shard_map hands them to
    the JAX body: experts split over ``model_axis``, d_model over
    ``gather_axes`` (FSDP storage), so w_gate / w_up are (E/M, D/G, F)
    and w_down (E/M, F, D/G).  The d_model blocks are all-gathered inside
    the body, one layer at a time.  Each rank routes its tokens over all
    experts, computes its own slice and the slices' outputs are summed
    over the model axis; every rank then holds the same y.  The router
    and x enter through ``copy_to``, so their gradients sum the slices'
    parts, and the load-balance loss, which every rank computes whole,
    passes 1/M of its gradient on each.  Returns ``(y, aux)``."""
    from repro_torch.distributed import comm
    del dp_axes          # the batch split is the caller's; x is the block
    gather = comm.axis_groups(mesh, [a for a in gather_axes
                                     if comm.axis_size(mesh, (a,)) > 1])
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    for g in reversed(gather):         # the major axis gathers last
        wg = comm.gather_dim(wg, 1, g)
        wu = comm.gather_dim(wu, 1, g)
        wd = comm.gather_dim(wd, 2, g)
    return _ep_body(cfg, p["router"], wg, wu, wd, x, mesh, (model_axis,))


def moe_apply_ep_tp(cfg, p: dict, x: torch.Tensor, mesh,
                    model_axis: str = "model", ff_axis: str = "data",
                    batch_axes: tuple = ()):
    """Weights-stationary MoE for decode: experts split over
    ``model_axis`` and each expert's FFN dimension over ``ff_axis``, so
    no weight moves.  x (B, S, D) is the same on every rank; the expert
    weights are this rank's blocks (w_gate / w_up (E/M, D, F/Df), w_down
    (E/M, F/Df, D)).  SiLU(gate) * up is elementwise in F, so each rank's
    FFN block gives a partial sum of its experts' outputs; one sum over
    both axes combines them.  Where x is this rank's block of a batch
    split over ``batch_axes`` (the serving step's dp axes), x is
    all-gathered over them first, as JAX's shard_map takes it replicated
    (a few KB a token), and the rank's block of y taken back.  Returns
    ``(y, aux)``."""
    from repro_torch.distributed import comm
    axes = [a for a in batch_axes if comm.axis_size(mesh, (a,)) > 1]
    b, block = x.shape[0], 0
    for a in reversed(axes):            # the major axis gathers last
        x = comm.all_concat(x, 0, mesh.get_group(a))
    for a in axes:
        block = block * comm.axis_size(mesh, (a,)) + mesh.get_local_rank(a)
    y, aux = _ep_body(cfg, p["router"], p["w_gate"], p["w_up"],
                      p["w_down"], x, mesh, (ff_axis, model_axis))
    return y.narrow(0, block * b, b), aux


def _ep_body(cfg, router, wg, wu, wd, x, mesh, sum_axes: tuple):
    """The body both mesh paths share: route this rank's tokens, compute
    its expert slice (the model-axis coordinate picks it), sum over
    ``sum_axes`` (the last is the model axis)."""
    from repro_torch.distributed import comm
    spec = cfg.moe
    if spec.impl != "sort":
        raise ValueError("the MoE mesh paths run the sort dispatch only")
    model_axis = sum_axes[-1]
    n_model = comm.axis_size(mesh, (model_axis,))
    e_local = wg.shape[0]
    if e_local * n_model != spec.n_experts:
        raise ValueError(f"{e_local} experts on each of {n_model} ranks of "
                         f"{model_axis!r}, but the config has "
                         f"{spec.n_experts}")
    if wg.shape[1] != cfg.d_model:
        raise ValueError(f"expert weights of d_model {wg.shape[1]} after "
                         f"the gather, the config has {cfg.d_model}: the "
                         f"blocks do not follow the mesh paths' layout")
    names = mesh.mesh_dim_names or ()
    e0 = (mesh.get_local_rank(model_axis) * e_local
          if model_axis in names else 0)
    groups = comm.axis_groups(mesh, sum_axes)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    for g in groups:
        xf = comm.copy_to(xf, g)
        router = comm.copy_to(router, g)
    y, aux = _moe_core_sort(cfg, {"router": router, "w_gate": wg,
                                  "w_up": wu, "w_down": wd}, xf,
                            _capacity(b * s, cfg), e0, e_local)
    for g in groups:
        y = comm.reduce_from(y, g)
    n = comm.axis_size(mesh, sum_axes)
    if n > 1:
        aux = comm.scale_grad(aux, 1.0 / n)
    return y.reshape(b, s, d), aux
