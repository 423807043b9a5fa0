"""Optimizer protocol: optax-style gradient transformations on tensors.

Parameters, gradients and updates are flat ``{name: tensor}`` dicts in the
order of :func:`repro_torch.tree.flatten` (JAX's flatten order), so the
state of every stage lines up leaf by leaf with the JAX package's.  A
``GradientTransformation`` is a pair of functions, ``init(params) ->
state`` and ``update(grads, state, params) -> (updates, state)``; updates
are additive (the caller applies ``params + updates``).

A transformation may carry a third function, ``state_sharding_spec(state,
param_specs) -> state-like tree of PartitionSpec``: given its state and a
``{name: PartitionSpec}`` dict mirroring the parameters, it returns the
state with every leaf (tensor, Python-int counter) replaced by the spec
it is placed with on a device mesh.  ``distributed/sharding.py`` derives
the optimizer state's placement through this hook and knows no state
class; a transformation without one has its state replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

Params = dict  # {name: tensor}


class PartitionSpec(tuple):
    """Per tensor dimension, the mesh axes it is split over: a mesh-axis
    name, a tuple of names (split over their product, the first the
    major one), or ``None`` (not split); the counterpart of
    ``jax.sharding.PartitionSpec``, whose ``str`` it prints (a tuple of
    one name is that name, an empty one ``None``, as there)."""

    def __new__(cls, *parts):
        def canon(ax):
            if isinstance(ax, tuple) and len(ax) <= 1:
                return ax[0] if ax else None
            return ax
        return super().__new__(cls, tuple(canon(ax) for ax in parts))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


class GradientTransformation(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Params, Any]]
    state_sharding_spec: Optional[Callable[[Any, dict], Any]] = None


def map_state(state, fn: Callable, is_leaf: Callable = lambda x: False):
    """``state`` with every leaf (a tensor, a Python int or float, or what
    ``is_leaf`` accepts) replaced by ``fn(leaf)``: dataclasses (their
    static fields kept as they are), named tuples, tuples and dicts are
    rebuilt, ``None`` stays."""
    if state is None:
        return None
    if is_leaf(state) or isinstance(state, (torch.Tensor, float, int)):
        return fn(state)
    rec = lambda x: map_state(x, fn, is_leaf)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*map(rec, state))
    if isinstance(state, (tuple, list)):
        return type(state)(map(rec, state))
    if isinstance(state, dict):
        return {k: rec(v) for k, v in state.items()}
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return dataclasses.replace(state, **{
            f.name: rec(getattr(state, f.name))
            for f in dataclasses.fields(state)
            if f.init and not f.metadata.get("static")})
    raise TypeError(f"no state layout for {type(state).__name__}")


def replicate_state_spec(state):
    """Default sharding spec: every leaf of ``state`` replicated."""
    return map_state(state, lambda _: P())


def state_sharding_spec(transform: GradientTransformation, state,
                        param_specs: dict):
    """A transformation's state specs through its hook, or replicated for
    a transformation without one."""
    if transform.state_sharding_spec is None:
        return replicate_state_spec(state)
    return transform.state_sharding_spec(state, param_specs)


@dataclasses.dataclass
class EmptyState:
    """State of a stateless transformation."""


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Compose transformations left to right (like ``optax.chain``)."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_states = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_states.append(s)
        return grads, tuple(new_states)

    def spec(state, param_specs):
        return tuple(state_sharding_spec(t, s, param_specs)
                     for t, s in zip(transforms, state))

    return GradientTransformation(init, update, spec)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """``params += updates`` in place, the update cast to the parameter's
    dtype first, as the JAX package's ``p + u.astype(p.dtype)``: fp32
    master copies by default, bf16 under ``param_dtype="bfloat16"``."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))


def find_states(state, cls):
    """Yield every ``cls`` instance inside an optimizer state: chains are
    tuples, partitions carry a dict of group states in ``inner``."""
    if isinstance(state, cls):
        yield state
    elif isinstance(state, (tuple, list)):
        for s in state:
            yield from find_states(s, cls)
    elif isinstance(state, dict):
        for s in state.values():
            yield from find_states(s, cls)
    elif hasattr(state, "inner"):
        yield from find_states(state.inner, cls)


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in an optimizer state (dataclasses, tuples --
    named tuples such as int8 ``QuantizedMatrix`` factors included -- and
    dicts) at its element size (int8: 1 byte), the counterpart of the JAX
    package's ``tree_nbytes`` over the state's array leaves; Python-int
    step counters are not counted, and a DTensor counts this rank's
    block."""
    if isinstance(tree, torch.Tensor):
        if hasattr(tree, "to_local"):     # a DTensor: this rank's block
            tree = tree.to_local()
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(x) for x in tree)
    return 0


def global_norm(tree: Params) -> torch.Tensor:
    """The 2-norm over every leaf; of blocks on a mesh (``core/blocks.py``)
    each leaf's sum of squares summed over the ranks holding its other
    blocks."""
    from repro_torch.core.blocks import split_of
    sq = [split_of(k, x).sum(torch.square(x.float()), None)
          for k, x in tree.items()]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every gradient by ``min(1, max_norm / (||g||_2 + 1e-12))``,
    the norm over all leaves together."""

    def init(params):
        del params
        return EmptyState()

    def update(grads, state, params):
        del params
        norm = global_norm(grads)
        s = torch.clamp_max(max_norm / (norm + 1e-12), 1.0)
        return {k: g * s for k, g in grads.items()}, state

    return GradientTransformation(init, update)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Linear warmup followed by cosine decay to ``min_lr`` (Megatron-style),
    evaluated in float32 like the JAX package's."""

    peak_lr: float
    warmup_steps: int = 1000
    total_steps: int = 100_000
    min_lr: float = 0.0

    def __call__(self, step: int) -> torch.Tensor:
        f = lambda x: torch.tensor(x, dtype=torch.float32)
        step = f(step)
        warm = self.peak_lr * step / max(1.0, self.warmup_steps)
        denom = max(1.0, self.total_steps - self.warmup_steps)
        frac = torch.clamp((step - self.warmup_steps) / denom, 0.0, 1.0)
        cos = self.min_lr + 0.5 * (self.peak_lr - self.min_lr) * (
            1 + torch.cos(math.pi * frac))
        return warm if step < self.warmup_steps else cos


def constant_schedule(lr: float) -> Callable[[int], torch.Tensor]:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def resolve_schedule(lr: "float | Callable") -> Callable:
    return lr if callable(lr) else constant_schedule(float(lr))
