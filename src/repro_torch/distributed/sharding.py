"""Logical-axis -> mesh-axis sharding rules, per cell kind, and their
binding to a torch ``DeviceMesh``: the JAX package's
``distributed/sharding.py``.

Parallelism map (production mesh (pod, data, model) = (2, 16, 16)):

  * pod   -- pure data parallelism between pods (only the gradient
             all-reduce crosses it).
  * data  -- data parallelism + FSDP (params and optimizer state split
             over it).
  * model -- tensor parallelism (heads / mlp / vocab / ssm-inner), expert
             parallelism (MoE) and the sequence axis of KV caches at
             decode.

The rule tables map each logical axis of the models' ``param_specs()`` to
a mesh axis per cell kind, exactly as in JAX, so a leaf's spec, and hence
the bytes each rank stores, is JAX's.  Optimizer-state specs come from the
param specs through each transformation's ``state_sharding_spec`` hook
(``core/types.py``); this module knows no optimizer state class.

A spec (``core.types.PartitionSpec``) is a tuple with one entry per tensor
dimension: ``None``, a mesh-axis name, or a tuple of names.  Every
``*_pspecs`` function works from mesh axis sizes alone (a ``{axis:
size}`` dict or a ``DeviceMesh``), so planning and accounting need no
process group; :class:`NamedSharding` binds a spec to a live mesh as
DTensor placements: a mesh dimension named in entry d is ``Shard(d)``,
every other one ``Replicate()``.  An entry that names several mesh axes
splits its dimension over their product, the first the major one, as
JAX's tiling does; DTensor nests the shards of one dimension in mesh-
dimension order, so the names must come in the mesh's order (every rule
here produces them so, and :func:`placements_for` raises otherwise).

How the port's training step uses the placement (``train/steps.py``):
every parameter and optimizer-state leaf whose spec names a mesh axis is
stored as a DTensor, so a rank's bytes follow JAX's layout.  The step
hands the model each rank's blocks and splits the batch over the dp axes;
the model gathers a leaf where it uses it, one layer's slice at a time
(:class:`GatherAtUse`), and the backward hands back the gradient's block,
summed over the dp axes in a fixed order and sliced over the others; the
optimizer updates the blocks (``core/blocks.py``: :func:`leaf_splits`).
No leaf is held whole outside the layer that uses it, and no optimizer
state at all.  Under the ``tp`` strategy the products split over
``model``, Megatron-style (the heads, the MLP's hidden units, the
vocabulary, the SSM heads of the Mamba2 blocks; the MoE mesh paths split
the experts): those leaves reach the model as this rank's block over
``model``, gathered over the dp axes only, or whole where the rank uses a
part of the block's range, their gradient then summed over ``model``
(:class:`GatherAtUse`'s routes).

Serving on a mesh (:func:`serving_view`): every family takes the same
hook in ``prefill`` and ``decode_step``, forward only, on each rank's
parameter blocks (a serving kind has no FSDP axis, so a "block" leaf is
used as it is stored and nothing moves) and on the rank's blocks of the
caches: the KV cache's sequence stays split over ``model``, or over the
dp axes and ``model`` in the ``long_500k`` cells (flash-decoding), the
Mamba states' heads too, a cross cache's encoder rows over ``model``
where they divide.  The ``fsdp`` strategy gathers every leaf and the
cache's sequence whole first (:func:`model_params`,
:func:`gather_tree_except`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree as TREE
from repro_torch.config import ModelConfig
from repro_torch.core.types import P, map_state, state_sharding_spec


def mesh_axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh``; a mapping passes through."""
    if isinstance(mesh, dict):
        return mesh
    return {name: mesh.size(i)
            for i, name in enumerate(mesh.mesh_dim_names)}


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_axis_sizes(mesh))


# ---------------------------------------------------------------------------
# Logical -> mesh rules
# ---------------------------------------------------------------------------

def rules_for(cfg: ModelConfig, kind: str, mesh, fsdp: bool = True) -> dict:
    """kind: train | prefill | decode."""
    has_data = "data" in mesh_axis_sizes(mesh)
    fsdp_axis = "data" if (fsdp and has_data and kind == "train") else None
    return {
        # tensor-parallel dims
        "q_heads": "model", "kv_heads": "model", "mlp": "model",
        "vocab": "model", "experts_router": "model",
        "ssm_proj": "model", "ssm_inner": "model", "ssm_conv": "model",
        # FSDP dim of dense weights
        "embed": fsdp_axis,
        # MoE expert stacks: experts -> EP axis, d_model dim -> FSDP
        "experts": "model",
        "expert_mlp": None,
        # stacking dims never split
        "layers": None, "shared": None,
    }


def spec_from_axes(axes: tuple, rules: dict) -> P:
    return P(*(rules.get(ax) if ax is not None else None for ax in axes))


def sanitize_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop mesh axes whose size does not divide the dimension.  A single
    axis falls back to replicated; a tuple reduces to its largest-product
    contiguous sub-tuple that divides (batch 256 over (pod, data, model) =
    512 ranks -> (data, model)).  An axis the mesh lacks is dropped the
    same way, so the rule tables stay mesh-agnostic."""
    sizes = mesh_axis_sizes(mesh)

    def axsize(axes):
        n = 1
        for a in axes:
            if a not in sizes:
                return 0               # unknown axis: never divides
            n *= sizes[a]
        return n

    parts = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            parts.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n_all = axsize(axes)
        if n_all and dim % n_all == 0:
            parts.append(ax)
            continue
        best, best_n = None, 1
        for i in range(len(axes)):
            for j in range(i + 1, len(axes) + 1):
                sub = axes[i:j]
                n = axsize(sub)
                if n and dim % n == 0 and n > best_n:
                    best, best_n = sub, n
        parts.append(best if best else None)
    return P(*parts)


def param_structs(model, params: Optional[dict] = None) -> dict:
    """``{path: meta tensor}`` of the model's parameters in flatten order,
    their shapes and dtypes without storage: from ``params`` (nested or
    flat; tensors on any device, fake ones included, or shapes, which
    take ``cfg.param_dtype``) or, without them, from the model's init
    under a ``FakeTensorMode``, so that no size of model is allocated."""
    if params is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            params = model.init(torch.Generator().manual_seed(0))
    flat = TREE.flatten(params) if any(
        isinstance(v, dict) for v in params.values()) else params
    dt = getattr(torch, model.cfg.param_dtype)

    def meta(v):
        if isinstance(v, torch.Tensor):
            return torch.empty(v.shape, dtype=v.dtype, device="meta")
        return torch.empty(tuple(v), dtype=dt, device="meta")

    return {k: meta(v) for k, v in flat.items()}


def _param_shapes(model, params: Optional[dict]) -> dict:
    """``{path: shape}`` of the model's parameters in flatten order
    (:func:`param_structs`)."""
    return {k: tuple(v.shape) for k, v in param_structs(model, params)
            .items()}


def param_pspecs(model, mesh, kind: str = "train", fsdp: bool = True,
                 params: Optional[dict] = None) -> dict:
    """``{path: PartitionSpec}`` of the parameters, in flatten order, each
    sanitized against its shape.  ``mesh`` may be a ``DeviceMesh`` or a
    ``{axis: size}`` mapping; ``params`` gives the shapes (tensors or
    shapes; default: the model's init without storage,
    :func:`param_structs`)."""
    cfg = model.cfg
    shapes = _param_shapes(model, params)
    if getattr(cfg, "parallel_strategy", "tp") == "fsdp":
        return _fsdp_param_pspecs(shapes, mesh)
    rules = rules_for(cfg, kind, mesh, fsdp)
    # expert stacks keep FSDP storage even outside train
    moe_rules = dict(rules)
    if "data" in mesh_axis_sizes(mesh):
        if kind == "decode":
            # weights-stationary EP-TP layout (moe_apply_ep_tp): experts
            # over model, FFN dim over data
            moe_rules["embed"] = None
            moe_rules["expert_mlp"] = "data"
        else:
            moe_rules["embed"] = "data"
    axes = TREE.flatten(model.param_specs())
    if list(axes) != list(shapes):
        raise ValueError(f"param_specs() and the params differ: "
                         f"{sorted(set(axes) ^ set(shapes))}")

    def one(ax, shape):
        table = (moe_rules if "experts" in ax or "expert_mlp" in ax
                 else rules)
        return sanitize_spec(spec_from_axes(ax, table), shape, mesh)

    return {k: one(axes[k], shape) for k, shape in shapes.items()}


def _fsdp_param_pspecs(shapes: dict, mesh) -> dict:
    """Pure ZeRO-3: every >= 2-D leaf splits its -2 dim over all mesh axes
    (flattened); 1-D leaves split over the same when it divides."""
    all_axes = tuple(mesh_axis_sizes(mesh))

    def one(shape):
        nd = len(shape)
        if nd >= 2:
            parts = [None] * nd
            parts[-2] = all_axes
            spec = P(*parts)
        elif nd == 1:
            spec = P(all_axes)
        else:
            spec = P()
        return sanitize_spec(spec, shape, mesh)

    return {k: one(shape) for k, shape in shapes.items()}


# ---------------------------------------------------------------------------
# Binding to a DeviceMesh
# ---------------------------------------------------------------------------

def placements_for(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension
    (see the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        idx = [names.index(a) for a in (ax if isinstance(ax, tuple)
                                         else (ax,))]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of one dimension must come "
                             f"in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} splits "
                                 f"two dimensions")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a ``DeviceMesh``; the counterpart of JAX's."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)

    @property
    def is_fully_replicated(self) -> bool:
        return all(ax is None for ax in self.spec)


def local_block(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` (a view)."""
    mesh = sharding.mesh
    for i, pl in enumerate(sharding.placements):
        dim = getattr(pl, "dim", None)
        if dim is not None:
            t = t.chunk(mesh.size(i), dim=dim)[mesh.get_local_rank(i)]
    return t


def place(t, sharding: Optional[NamedSharding]):
    """The whole tensor ``t``, the same on every rank, stored by
    ``sharding``: a DTensor holding this rank's block (a copy, so ``t``
    can be freed, unless the block is all of ``t``) when the spec names a
    mesh axis, else ``t`` itself.
    Python numbers, tensors off the mesh's device type (the guards' host
    counters) and DTensors (placed already) stay as they are.  No
    communication."""
    if (not isinstance(t, torch.Tensor) or sharding is None
            or hasattr(t, "full_tensor") or sharding.is_fully_replicated
            or t.device.type != sharding.mesh.device_type):
        return t
    from torch.distributed.tensor import DTensor
    t = t.detach().contiguous()
    block = local_block(t, sharding)
    if block.numel() != t.numel():      # (a mesh of one rank keeps t)
        block = block.clone()
    return DTensor.from_local(block, sharding.mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def gather(t):
    """The whole tensor of a DTensor (an all-gather over the mesh axes its
    placement splits); anything else as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.full_tensor()
    return t


def place_tree(state, shardings):
    """``state`` with every tensor leaf placed by the matching leaf of
    ``shardings`` (a tree of the same structure)."""
    from repro_torch.checkpoint.serialization import _map, spec_leaves
    pairs = iter(spec_leaves(shardings))
    return _map(state, "", lambda path, leaf: place(leaf, next(pairs)[1]))


def gather_tree(state):
    return map_state(state, gather)


def place_state(state, shardings):
    """A ``TrainState`` with its parameters and optimizer state placed by
    the matching leaves of ``shardings`` (:func:`train_shardings`' state
    shardings); its step as it is."""
    with torch.no_grad():
        return dataclasses.replace(
            state, params={k: place(v, shardings.params[k])
                           for k, v in state.params.items()},
            opt_state=place_tree(state.opt_state, shardings.opt_state))


def model_params(params: dict, local=()) -> dict:
    """The parameters a model serves with over a mesh where its products
    do not split (:func:`serving_view` gives None: the ``fsdp`` strategy,
    a model that declares no split products): every leaf whole
    (gathered), but the leaves named in ``local`` (the model's
    ``mesh_local_leaves``: the MoE mesh paths' expert stacks) as this
    rank's block.  (The train step and :func:`serving_view`'s serving
    gather at use instead, :class:`GatherAtUse`.)"""
    out = {}
    with torch.no_grad():
        for k, v in params.items():
            if k in local:
                out[k] = to_local(v)
            else:
                out[k] = gather(v)
    return out


def to_local(t):
    """A DTensor's block on this rank; anything else as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def local_tree(state):
    """``state`` with every DTensor leaf replaced by this rank's block (no
    copy)."""
    return map_state(state, to_local)


def wrap(t, sharding: Optional[NamedSharding]):
    """This rank's block ``t`` as the DTensor ``sharding`` stores (no copy,
    no communication); as :func:`place`, other leaves stay as they
    are."""
    if (not isinstance(t, torch.Tensor) or sharding is None
            or hasattr(t, "full_tensor") or sharding.is_fully_replicated
            or t.device.type != sharding.mesh.device_type):
        return t
    from torch.distributed.tensor import DTensor
    # the whole shape follows from the block's (every spec divides its
    # dimension evenly)
    return DTensor.from_local(t.detach(), sharding.mesh,
                              sharding.placements, run_check=False)


def wrap_state(state, shardings):
    """A ``TrainState`` of this rank's blocks as the DTensors of
    ``shardings`` (:func:`train_shardings`' state shardings), no copy."""
    from repro_torch.checkpoint.serialization import _map, spec_leaves
    pairs = iter(spec_leaves(shardings.opt_state))
    return dataclasses.replace(
        state, params={k: wrap(v, shardings.params[k])
                       for k, v in state.params.items()},
        opt_state=_map(state.opt_state, "",
                       lambda path, leaf: wrap(leaf, next(pairs)[1])))


def gather_tree_except(state, shardings, keep: tuple):
    """``state`` with each DTensor leaf replaced by this rank's block over
    the mesh axes in ``keep`` only (the matching leaf of ``shardings``
    gives its spec): all-gathered over every other axis the spec splits,
    a dimension split over ``keep`` axes alone staying split (a cache
    keeps its batch block over the dp axes and gathers its sequence: the
    serving cells whose model takes :func:`model_params`; under
    :func:`serving_view` the cache stays the rank's block).  Other leaves
    as they are."""
    from repro_torch.checkpoint.serialization import _map, spec_leaves
    pairs = iter(spec_leaves(shardings))

    def one(path, t):
        sharding = next(pairs)[1]
        if not hasattr(t, "redistribute") or sharding is None:
            return t
        kept = P(*(ax if ax is not None and set(
            ax if isinstance(ax, tuple) else (ax,)) <= set(keep) else None
            for ax in sharding.spec))
        return t.redistribute(sharding.mesh, placements_for(
            kept, sharding.mesh)).to_local()

    return _map(state, "", one)


def bind(specs, mesh):
    """A tree of specs as :class:`NamedSharding` on ``mesh``."""
    return map_state(specs, lambda s: NamedSharding(mesh, s),
                     is_leaf=lambda x: isinstance(x, P))


def param_shardings(model, mesh, kind: str = "train", fsdp: bool = True,
                    params: Optional[dict] = None) -> dict:
    """:func:`param_pspecs` bound to a live mesh."""
    return {k: NamedSharding(mesh, s) for k, s in
            param_pspecs(model, mesh, kind, fsdp, params).items()}


# ---------------------------------------------------------------------------
# Optimizer state
# ---------------------------------------------------------------------------

def opt_state_pspecs(opt, opt_state, param_specs: dict):
    """The optimizer state's specs, through the transformation's
    ``state_sharding_spec`` hook (replicated without one)."""
    return state_sharding_spec(opt, opt_state, param_specs)


def opt_state_shardings(opt, opt_state, param_specs: dict, mesh):
    return bind(opt_state_pspecs(opt, opt_state, param_specs), mesh)


def train_shardings(model, opt, mesh, batch_struct: Optional[dict] = None,
                    *, kind: str = "train", fsdp: bool = True,
                    params: Optional[dict] = None):
    """The sharded training run's placement: ``(state_shardings,
    batch_shardings)``; ``state_shardings`` is a ``TrainState`` of
    :class:`NamedSharding` (params by the rule tables, the optimizer
    state through its hook, a replicated step counter), and
    ``batch_shardings`` places ``{"tokens": shape}`` batches over the dp
    axes (None without ``batch_struct``).  The optimizer state's
    structure comes from ``opt.init`` on meta tensors of the parameters'
    shapes and dtypes (:func:`param_structs` of ``params``: tensors, fake
    ones included, or shapes; default: the model's init without
    storage), so nothing is allocated at any size."""
    from repro_torch.train.steps import TrainState   # import cycle
    structs = param_structs(model, params)
    pspecs = param_pspecs(model, mesh, kind, fsdp, structs)
    with torch.no_grad():
        opt_state = opt.init(structs)
    state = TrainState(
        params={k: NamedSharding(mesh, s) for k, s in pspecs.items()},
        opt_state=opt_state_shardings(opt, opt_state, pspecs, mesh),
        step=NamedSharding(mesh, P()))
    bshard = (batch_shardings(model.cfg, kind, mesh, batch_struct)
              if batch_struct is not None else None)
    return state, bshard


# ---------------------------------------------------------------------------
# Activations / batch / cache
# ---------------------------------------------------------------------------

def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def batch_pspecs(cfg: ModelConfig, kind: str, mesh, batch_specs: dict
                 ) -> dict:
    """tokens (B, S) -> B over the dp axes; under the fsdp strategy the
    batch spreads over every mesh axis.  ``batch_specs`` maps a name to a
    shape (or anything with ``.shape``)."""
    del kind
    if getattr(cfg, "parallel_strategy", "tp") == "fsdp":
        dp = tuple(mesh_axis_sizes(mesh))
    else:
        dp = dp_axes(mesh)
    dpp = dp if dp else None
    out = {}
    for name, sds in batch_specs.items():
        spec = P(dpp, None) if name == "tokens" else P(dpp, None, None)
        out[name] = sanitize_spec(spec, _shape(sds), mesh)
    return out


def batch_shardings(cfg: ModelConfig, kind: str, mesh, batch_specs: dict
                    ) -> dict:
    return {k: NamedSharding(mesh, s) for k, s in
            batch_pspecs(cfg, kind, mesh, batch_specs).items()}


def cache_pspecs(cfg: ModelConfig, mesh, cache_struct,
                 long_context: bool):
    """KV caches: batch over dp, sequence over model (flash-decoding);
    long context (B = 1): sequence over (data, model).  Mamba states:
    heads over model.  ``cache_struct`` is a model's ``init_cache``
    result (a dict of named tuples of tensors and the int ``pos``)."""
    del cfg
    dp = dp_axes(mesh)
    dpp = dp if dp else None
    seq_ax = (tuple(dp) + ("model",)) if long_context else "model"
    b_ax = None if long_context else dpp

    def one(name, leaf):
        shape = _shape(leaf) if hasattr(leaf, "shape") else ()
        nd = len(shape)
        if name.endswith("pos"):
            return P()
        if "mamba" in name and nd == 5:    # ssm state (L, B, H, P, N)
            spec = P(None, b_ax, "model", None, None)
        elif "mamba" in name and nd == 4:  # conv state (L, B, K, C)
            spec = P(None, b_ax, None, "model")
        elif "cross" in name and nd == 6:  # whisper (L, 2, B, S_enc, KV, dh)
            spec = P(None, None, b_ax, "model", None, None)
        elif nd == 5:                      # kv cache (L, B, S, KV, dh)
            spec = P(None, b_ax, seq_ax, None, None)
        else:
            spec = P()
        return sanitize_spec(spec, shape, mesh)

    def walk(node, name):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(getattr(node, f), f"{name}/{f}")
                                for f in node._fields))
        if isinstance(node, dict):
            return {k: walk(v, f"{name}/{k}" if name else k)
                    for k, v in node.items()}
        return one(name, node)

    return walk(cache_struct, "")


def cache_shardings(cfg: ModelConfig, mesh, cache_struct,
                    long_context: bool):
    return bind(cache_pspecs(cfg, mesh, cache_struct, long_context), mesh)


def make_act_constrainer(mesh, kind: str, long_context: bool = False,
                         all_axes_batch: bool = False):
    """The activation hook the models apply to their residual stream
    (``TransformerLM.constrain``).  In JAX it pins the batch split for
    GSPMD; the port's step hands the model this rank's block of the batch
    as a plain tensor, and its split products sum their parts over
    ``model`` themselves (``comm.reduce_from``), so the residual stream is
    whole between them and the hook returns its input unchanged."""
    del mesh, kind, long_context, all_axes_batch
    return lambda x, *_, **__: x


def logits_pspec(mesh, long_context: bool = False) -> P:
    dp = dp_axes(mesh)
    return P(dp if (dp and not long_context) else None, None, "model")


def logits_sharding(mesh, long_context: bool = False) -> NamedSharding:
    return NamedSharding(mesh, logits_pspec(mesh, long_context))


# ---------------------------------------------------------------------------
# The train step's blocks: gathered at use, updated as blocks
# ---------------------------------------------------------------------------

class _Plan(NamedTuple):
    """How one leaf's block (of ``shape``) becomes what the model uses
    (``whole``: the whole leaf, or, for a leaf a split product uses as its
    block, the block over the model axis gathered over the others), and
    that one's gradient the block's: ``gather`` the (dim, group)
    all-gathers in order; the gradient, viewed as ``expand`` (each
    gathered dim as its axes' sizes, major first, then the block's
    length), takes its index on every gathered axis it is not summed over
    (``narrow``: (expanded dim, index)) and is summed over the ``total``
    axes (the model axis of a leaf a split product uses a part of), then
    over every dp axis, the minor first (``reduce``: (expanded dim or
    None, group), a reduce-scatter there or an all-sum of an axis the
    leaf is not split over)."""
    shape: tuple
    whole: tuple
    gather: tuple
    expand: tuple
    narrow: tuple
    reduce: tuple


def _leaf_plan(mesh, spec: P, whole: tuple, dp: tuple, keep: tuple = (),
               total: tuple = ()) -> Optional[_Plan]:
    """The plan of a leaf of whole shape ``whole`` stored by ``spec``: a
    dimension split over an axis in ``keep`` alone stays the block (not
    gathered, its gradient not narrowed); the gradient is summed over the
    ``total`` axes before the dp axes."""
    names = tuple(mesh.mesh_dim_names)
    size = lambda a: mesh.size(names.index(a))
    gathers, expand, block, use, where = [], [], [], [], {}
    for d, n in enumerate(whole):
        ax = spec[d] if d < len(spec) else None
        axes = tuple(a for a in (() if ax is None else ax if isinstance(
            ax, tuple) else (ax,)) if size(a) > 1)
        if len(axes) == 1 and axes[0] in keep:
            n //= size(axes[0])
            expand.append(n)
            block.append(n)
            use.append(n)
            continue
        use.append(n)
        for a in reversed(axes):             # the major axis gathers last
            gathers.append((d, mesh.get_group(a)))
        for a in axes:
            where[a] = len(expand)
            expand.append(size(a))
            n //= size(a)
        expand.append(n)
        block.append(n)
    sums = [a for a in total if a in names and size(a) > 1]
    sums += [a for a in reversed(dp) if a in names and size(a) > 1]
    reduce = tuple((where.get(a), mesh.get_group(a)) for a in sums)
    if not gathers and not reduce:
        return None
    narrow = tuple((e, mesh.get_local_rank(a)) for a, e in where.items()
                   if a not in dp and a not in total)
    return _Plan(tuple(block), tuple(use), tuple(gathers), tuple(expand),
                 narrow, reduce)


def _gather(x: torch.Tensor, gathers: tuple) -> torch.Tensor:
    from repro_torch.distributed import comm
    if not gathers:          # a leaf used whole, its gradient summed
        return x.view_as(x)
    for dim, group in gathers:
        x = comm.all_concat(x, dim, group)
    return x


class _GatherLeaf(torch.autograd.Function):
    """A leaf's block -> the whole leaf; its gradient -> the gradient's
    block (see :class:`_Plan`).  Keeps only the block."""

    @staticmethod
    def forward(ctx, block, plan):
        ctx.block, ctx.plan = block.detach(), plan
        return _gather(block, plan.gather)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed import comm
        plan = ctx.plan
        x = g.reshape(plan.expand)
        for e, i in plan.narrow:
            x = x.narrow(e, i, 1)
        for e, group in plan.reduce:
            x = (comm.all_sum(x, group) if e is None
                 else comm.reduce_scatter(x, e, group))
        return x.reshape(plan.shape), None

    @staticmethod
    def regather(ctx) -> torch.Tensor:
        """The forward's output, gathered again from the block."""
        return _gather(ctx.block, ctx.plan.gather)


class _GatherStack(torch.autograd.Function):
    """A stacked leaf split on its stack axis (the fsdp rule's (L, d)
    leaves) -> the whole stack; the gradient -> this rank's slice of it,
    not summed: the per-layer gathers' backward has summed it over the dp
    axes already."""

    @staticmethod
    def forward(ctx, block, gathers, first):
        ctx.first, ctx.n = first, block.shape[0]
        return _gather(block, gathers)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.first, ctx.n), None, None


class GatherAtUse:
    """The train step's gather-at-use hook (``models.layers.gathering``):
    ``use(tree, path)`` returns the leaves of ``tree`` (a tensor, or a
    nested dict of them, at ``path`` in the flat parameter paths) whole,
    each gathered from this rank's block over the mesh axes its spec
    (``shardings[path]``, of a leaf of whole shape ``shapes[path]``)
    splits; a per-layer view of a stacked leaf takes its spec without the
    stack axis.  The backward hands back each block's gradient summed
    over the ``dp`` axes, the minor first, as the gather design's
    ``all_sum`` order: the same terms in the same order, so the blocks
    are that design's gradient sliced, bit for bit.  Leaves in ``local``
    (the MoE mesh paths' expert stacks), replicated ones and a leaf given
    whole already (or this hook's output) stay as they are: the step sums
    the others' gradients itself (:meth:`gathers` says which).
    ``use(tree, path, stack=True)`` gathers a stack's leaves over their
    stack axis only, before the model takes the layers apart (the fsdp
    rule splits the stack axis of (L, d) leaves; JAX's scan gathers them
    whole too).

    Under ``split`` (a ``models.layers.ModelSplit`` over the mesh's
    ``model`` axis; the hook carries it to the model) the leaves in
    ``products`` (the model's ``split_products``: ``{path: (dim, lo,
    hi)}``, the range of ``dim`` this rank's split products use) take one
    of two other routes (:meth:`route`): "block" where the leaf's ``dim``
    is split over ``model`` alone and this rank's block is that range:
    gathered over the dp axes only, its gradient this rank's own block,
    summed over the dp axes; "slice" otherwise: gathered whole (the model
    takes its range), its gradient summed over ``model`` (reduce-scattered
    to the block where the leaf is split over it) before the dp axes, as
    the model ranks' gradients differ.  Every other leaf takes the
    "gather" route above ("local" and "whole" where nothing is
    gathered).

    ``seq`` (serving, :func:`serving_view`; a ``layers.ModelSplit`` of
    the ranks the KV cache's sequence splits over): the KV cache the model
    is handed holds this rank's block of the sequence, the rows ``[i n,
    (i + 1) n)`` of a block of n rows, i its index ``seq.rank`` (the hook
    carries it to the model, ``layers.cache_seq_split``)."""

    def __init__(self, shardings: dict, shapes: dict, dp: tuple,
                 local=(), products: Optional[dict] = None, split=None,
                 seq=None):
        self.shardings, self.shapes = shardings, shapes
        self.dp, self.local = tuple(dp), set(local)
        self.split, self.seq = split, seq
        self.products = dict(products or {}) if split is not None else {}
        self._plans: dict = {}

    @property
    def seq_split(self) -> bool:
        """Whether the KV cache the model is handed holds a block of the
        sequence (``seq``) rather than every row."""
        return self.seq is not None

    def route(self, path: str) -> str:
        """How the leaf at ``path`` reaches the model: "block", "slice" or
        "gather" (see the class docstring), "local" (a ``local`` leaf) or
        "whole" (nothing to gather: replicated, or split over axes of one
        rank)."""
        if path in self.local:
            return "local"
        if path in self.products:
            return "block" if self._kept(path, len(self.shapes[path])) \
                else "slice"
        return "gather" if self.plan(path) is not None else "whole"

    def routes(self) -> dict:
        """``{path: route}`` of every parameter (:meth:`route`)."""
        return {k: self.route(k) for k in self.shapes}

    def _kept(self, path: str, ndim: int) -> bool:
        """Whether the leaf at ``path`` (viewed with ``ndim`` dims) is used
        as its block over the model axis: its product's dimension split
        over ``model`` alone, the block this rank's range of it."""
        dim, lo, hi = self.products[path]
        sh = self.shardings.get(path)
        if dim is None or sh is None:
            return False
        full = tuple(self.shapes[path])
        cut = len(full) - ndim
        spec = (tuple(sh.spec) + (None,) * len(full))[cut:cut + ndim]
        d = dim % ndim
        m, n = self.split.size, full[cut + d]
        return spec[d] in ("model", ("model",)) and n % m == 0 \
            and (lo, hi) == (self.split.rank * n // m,
                             (self.split.rank + 1) * n // m)

    def plan(self, path: str, ndim: Optional[int] = None,
             stored: bool = False) -> Optional[_Plan]:
        """The plan of the leaf at ``path``, or of its per-layer slices
        (``ndim`` dims); None where nothing is gathered or summed.
        ``stored``: the leaf used as its stored block over ``model``
        (:meth:`stored`)."""
        whole = tuple(self.shapes[path])
        ndim = len(whole) if ndim is None else ndim
        key = (path, ndim, stored)
        if key not in self._plans:
            sh = self.shardings.get(path)
            plan = None
            product = path in self.products
            if sh is not None and path not in self.local and (
                    product or not sh.is_fully_replicated):
                spec = tuple(sh.spec) + (None,) * (len(whole) - len(sh.spec))
                cut = len(whole) - ndim
                keep = total = ()
                if stored or (product and self._kept(path, ndim)):
                    keep = ("model",)
                elif product:
                    total = ("model",)
                plan = _leaf_plan(sh.mesh, P(*spec[cut:]), whole[cut:],
                                  self.dp, keep, total)
            self._plans[key] = plan
        return self._plans[key]

    def gathers(self, path: str) -> bool:
        """Whether the leaf at ``path`` is gathered at use (or summed over
        the model axis), its gradient summed in the backward."""
        return self.plan(path) is not None

    def __call__(self, tree, path: str, stack: bool = False):
        if isinstance(tree, dict):
            return {k: self(v, f"{path}/{k}", stack)
                    for k, v in tree.items()}
        if stack:
            return self._stack(tree, path)
        return self._leaf(tree, path, self.plan(path, tree.dim()))

    def _leaf(self, tree: torch.Tensor, path: str, plan) -> torch.Tensor:
        if plan is None or isinstance(tree.grad_fn, _GatherLeaf._backward_cls) \
                or (plan.gather and tuple(tree.shape) == plan.whole):
            return tree
        if tuple(tree.shape) != plan.shape:
            raise ValueError(f"{path}: a block of {tuple(tree.shape)}, the "
                             f"spec gives {plan.shape}")
        return _GatherLeaf.apply(tree, plan)

    def stored(self, tree, path: str):
        """``tree`` (as :meth:`__call__` takes it) with each leaf split over
        ``model`` as its stored block there, gathered over the other axes
        only, whatever range the split products use: a serving kind
        stores no leaf over a dp axis, so nothing moves (the Mamba2 decode
        step's ``in_proj`` and conv, ``layers.use_stored``)."""
        if isinstance(tree, dict):
            return {k: self.stored(v, f"{path}/{k}") for k, v in tree.items()}
        return self._leaf(tree, path, self.plan(path, tree.dim(), True))

    def _stack(self, t: torch.Tensor, path: str) -> torch.Tensor:
        from repro_torch.core.blocks import Split
        sh = self.shardings.get(path)
        if sh is None or path in self.local or not sh.spec \
                or sh.spec[0] is None:
            return t
        whole = tuple(self.shapes[path])
        plan = _leaf_plan(sh.mesh, P(sh.spec[0]), whole[:1], ())
        if plan is None or t.shape[0] == whole[0]:
            return t
        first, _ = Split(whole, sh.spec, sh.mesh).start(0)
        return _GatherStack.apply(t, plan.gather, first)


def model_products(model, mesh) -> tuple:
    """``(split, products)``: the ``layers.ModelSplit`` of ``mesh``'s model
    axis and the model's ``split_products`` under it, where the strategy
    is ``tp``, the axis has more than one rank and the model declares them
    (every family; None to keep every leaf on the gather route); else
    ``(None, {})``.  The train step (``train/steps.py``) and
    :func:`serving_view` take it."""
    from repro_torch.models.layers import ModelSplit
    names = mesh.mesh_dim_names or ()
    declare = getattr(model, "split_products", None)
    if (declare is None or "model" not in names or getattr(
            model.cfg, "parallel_strategy", "tp") != "tp"
            or mesh.size(names.index("model")) == 1):
        return None, {}
    split = ModelSplit(mesh.get_group("model"), mesh.get_local_rank("model"),
                       mesh.size(names.index("model")))
    products = declare(split)
    return (split, products) if products else (None, {})


def _kv_specs(cache_shardings) -> list:
    """The specs of the cache's KV leaves: every (L, B, S, KV, dh) leaf of
    its ``kv``.  Other 5-d leaves (the Mamba ssm state (L, B, H, P, N),
    whose axis 2 is heads) are not KV caches."""
    from repro_torch.checkpoint.serialization import spec_leaves
    return [sh.spec for path, sh in spec_leaves(cache_shardings)
            if sh is not None and path.startswith("['kv']")
            and len(sh.spec) == 5]


def _cache_seq_axis(cache_shardings) -> tuple:
    """The mesh axes the KV caches' sequence dimension splits over (every
    KV leaf's, :func:`_kv_specs`, which must agree); () where none splits
    it or the cache has no KV leaf."""
    found = {() if ax is None else ax if isinstance(ax, tuple) else (ax,)
             for ax in (spec[2] for spec in _kv_specs(cache_shardings))}
    if len(found) > 1:
        raise ValueError(f"KV caches split their sequence differently: "
                         f"{sorted(found)}")
    return found.pop() if found else ()


_SEQ_GROUPS: dict = {}


def _seq_split(mesh, spec: P, axes: tuple, split):
    """The ``layers.ModelSplit`` of the ranks a KV cache of ``spec``
    splits its sequence over (``axes``: the dp axes, then ``model``):
    their process group (the model group itself where ``axes`` is
    ``("model",)``; else the mesh's dimensions ``axes`` flattened, made
    once a mesh), this rank's index, taken from the cache's own layout
    (``core.blocks.Split.start``: the axes in mesh order, the first the
    major one), and their count.  Raises where the group disagrees with
    the layout on this rank's index."""
    import math
    import torch.distributed as dist
    from repro_torch.core.blocks import Split
    from repro_torch.models.layers import ModelSplit
    names = tuple(mesh.mesh_dim_names)
    size = math.prod(mesh.size(names.index(a)) for a in axes)
    first, n = Split((1, 1, size, 1, 1), spec, mesh).start(2)
    if axes == ("model",):
        return ModelSplit(split.group, first // n, size)
    key = (id(mesh), axes)
    if key not in _SEQ_GROUPS:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():     # (the dry run's fake mode)
            _SEQ_GROUPS[key] = (mesh, mesh[axes]._flatten().get_group())
    group = _SEQ_GROUPS[key][1]
    if dist.get_group_rank(group, dist.get_rank()) != first // n:
        raise ValueError(f"the group of {axes} puts this rank at "
                         f"{dist.get_group_rank(group, dist.get_rank())}, "
                         f"the cache's layout at {first // n}")
    return ModelSplit(group, first // n, size)


def serving_view(model, mesh, shardings: dict, shapes: dict,
                 cache_shardings=None) -> Optional[GatherAtUse]:
    """The serving hook of a model on ``mesh`` (set it with
    ``models.layers.gathering`` around ``prefill`` / ``decode_step``, under
    ``torch.inference_mode``), or None where the model's products do not
    split (:func:`model_products`: the ``fsdp`` strategy, a model axis of
    one rank) or the KV cache's sequence splits over axes other than
    ``model`` alone or the dp axes followed by ``model``: those serve on
    :func:`model_params` and the cache gathered over every axis but the
    dp axes (:func:`gather_tree_except`).

    The hook is the train step's :class:`GatherAtUse` on the parameters'
    serving shardings (``shardings``, of whole shapes ``shapes``), forward
    only: a "block" leaf is used as it is stored (a serving kind has no
    FSDP axis, so no collective moves it), a "slice" leaf (the rank uses
    part of its range: kv heads fewer than the model ranks) is gathered
    whole, a replicated one used as it is, the MoE mesh paths' expert
    stacks as the rank's blocks, and the leaves the Mamba2 decode step
    takes as stored (:meth:`GatherAtUse.stored`) as they are.  The model
    is handed the rank's parameter blocks and its block of the cache
    (``cache_shardings``: the batch over the dp axes, the KV sequence
    over ``model``, over (data, model) or (pod, data, model) for the
    ``long_500k`` cells (B = 1), or whole; the Mamba states' heads and
    conv channels over ``model``; a cross cache's encoder rows over
    ``model`` where they divide), which it writes in place; the hook's
    ``seq`` names the ranks the KV sequence splits over
    (:func:`_seq_split`)."""
    split, products = model_products(model, mesh)
    if split is None:
        return None
    axes = _cache_seq_axis(cache_shardings) if cache_shardings else ()
    dp = dp_axes(mesh)
    if axes and (axes[-1] != "model" or not set(axes[:-1]) <= set(dp)):
        return None
    seq = (_seq_split(mesh, _kv_specs(cache_shardings)[0], axes, split)
           if axes else None)
    return GatherAtUse(shardings, shapes, dp,
                       getattr(model, "mesh_local_leaves", tuple)(),
                       products, split, seq=seq)


class _Regather(NamedTuple):
    node: Any
    fwd: Any
    cast: Optional[torch.dtype]
    size: tuple
    stride: tuple
    offset: int


def _pack(t: torch.Tensor):
    """A saved tensor that is a gathered leaf (a gather's output, its cast
    to another dtype, or a view of either) is saved as the way to gather
    it again, not as itself."""
    base = t if t._base is None else t._base
    node, cast = base.grad_fn, None
    if node is not None and type(node).__name__ == "ToCopyBackward0":
        node, cast = node.next_functions[0][0], base.dtype
    fwd = getattr(type(node), "_forward_cls", None)
    if fwd is None or not hasattr(fwd, "regather") \
            or not base.is_contiguous():
        return t
    return _Regather(node, fwd, cast, tuple(t.size()), tuple(t.stride()),
                     t.storage_offset())


def _unpack(x):
    if not isinstance(x, _Regather):
        return x
    with torch.no_grad():
        whole = x.fwd.regather(x.node)
        if x.cast is not None:
            whole = whole.to(x.cast)
    return whole.as_strided(x.size, x.stride, x.offset)


@contextlib.contextmanager
def gathering(use: GatherAtUse):
    """The models gather at use through ``use`` (``models.layers``), and
    the autograd graph keeps no gathered leaf: the backward gathers it
    again from the block (under ``remat="none"`` too), so the peak holds
    at most the layer being computed whole."""
    from repro_torch.models import layers as L
    with L.gathering(use), torch.autograd.graph.saved_tensors_hooks(
            _pack, _unpack):
        yield


def leaf_splits(shardings: dict, shapes: dict) -> dict:
    """``{path: core.blocks.Split}`` of the parameters' shardings and whole
    shapes: how the optimizer's reductions cross each leaf's split
    axes."""
    from repro_torch.core.blocks import Split
    return {k: Split(shapes[k], sh.spec, sh.mesh)
            for k, sh in shardings.items()}
