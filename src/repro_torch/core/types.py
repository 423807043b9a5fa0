"""Optimizer protocol: optax-style gradient transformations on tensors.

Parameters, gradients and updates are flat ``{name: tensor}`` dicts in the
order of :func:`repro_torch.tree.flatten` (JAX's flatten order), so the
state of every stage lines up leaf by leaf with the JAX package's.  A
``GradientTransformation`` is a pair of functions, ``init(params) ->
state`` and ``update(grads, state, params) -> (updates, state)``; updates
are additive (the caller applies ``params + updates``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

Params = dict  # {name: tensor}


class GradientTransformation(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Params, Any]]


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

    return GradientTransformation(init, update)


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
    step counters are not counted."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(x) for x in tree)
    return 0


def global_norm(tree: Params) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree.values()]
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
