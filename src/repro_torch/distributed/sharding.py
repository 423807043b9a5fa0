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
stored as a DTensor, so a rank's bytes follow JAX's layout; the step
gathers the leaves it computes with, splits the batch over the dp axes,
sums the gradients over them in a fixed order, runs the same optimizer
update on every rank and keeps each rank's blocks.  Products are not
split over ``model`` (Megatron-style TP is not ported; the MoE mesh paths
split the experts over it for real).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

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


def model_params(params: dict, local=(), whole: Optional[dict] = None
                 ) -> dict:
    """The parameters a model runs on over a mesh: every leaf whole
    (``whole``'s, where given, else gathered), but the leaves named in
    ``local`` (the model's ``mesh_local_leaves``: the MoE mesh paths'
    expert stacks) as this rank's block."""
    out = {}
    with torch.no_grad():
        for k, v in params.items():
            if k in local:
                out[k] = v.to_local() if hasattr(v, "to_local") else v
            else:
                out[k] = whole[k] if whole is not None else gather(v)
    return out


def gather_tree_except(state, shardings, keep: tuple):
    """``state`` with each DTensor leaf replaced by this rank's block over
    the mesh axes in ``keep`` only (the matching leaf of ``shardings``
    gives its spec): all-gathered over every other axis the spec splits,
    a dimension split over ``keep`` axes alone staying split (a cache
    keeps its batch block over the dp axes and gathers its sequence).
    Other leaves as they are."""
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
    as a plain tensor, so the hook returns its input unchanged: it stays
    as the place where split products would place their activations."""
    del mesh, kind, long_context, all_axes_batch
    return lambda x, *_, **__: x


def logits_pspec(mesh, long_context: bool = False) -> P:
    dp = dp_axes(mesh)
    return P(dp if (dp and not long_context) else None, None, "model")


def logits_sharding(mesh, long_context: bool = False) -> NamedSharding:
    return NamedSharding(mesh, logits_pspec(mesh, long_context))
