"""Composable gradient-transformation stages (optax-style).

The named optimizers are chains of small stages::

    chain(scale_by_<preconditioner>(cfg),   # grads -> update direction
          add_decayed_weights(wd, mask),    # + wd * W   (decoupled decay)
          scale_by_schedule(schedule),      # * lr_t
          scale(-1.0))                      # descent sign

Every stage returns new update tensors and never writes into the ones it
was given: the preconditioner's output may be its own first-moment buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.blocks import WHOLE, Split, split_of
from repro_torch.core.types import (EmptyState, GradientTransformation,
                                    resolve_schedule, state_sharding_spec)


@dataclasses.dataclass
class CountState:
    """A bare step counter (counts from 0)."""

    count: int


def _empty_init(params):
    del params
    return EmptyState()


def scale(factor: float) -> GradientTransformation:
    """Multiply every update by a static ``factor`` (e.g. -1.0 for the
    descent sign at the end of a chain)."""

    def update(updates, state, params):
        del params
        return {k: u * factor for k, u in updates.items()}, state

    return GradientTransformation(_empty_init, update)


def mask_nd(min_ndim: int = 2) -> Callable:
    """Decay mask: keep only leaves with ``ndim >= min_ndim``."""
    return lambda params: {k: p.dim() >= min_ndim for k, p in params.items()}


def resolve_decay_mask(mask):
    """None / callable / ``{name: bool}`` pass through; the strings
    ``"all"`` (decay everything) and ``"no_1d"`` (exempt 1-D leaves)
    resolve to their masks."""
    if isinstance(mask, str):
        if mask == "all":
            return None
        if mask == "no_1d":
            return mask_nd(2)
        raise ValueError(f"unknown decay_mask {mask!r} "
                         f"(expected 'all', 'no_1d', a callable, or a "
                         f"dict of bools)")
    return mask


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Callable] = None
                        ) -> GradientTransformation:
    """Decoupled weight decay: ``u <- u + wd * W`` (the chain's trailing
    schedule and sign stages turn it into AdamW-style ``-lr * wd * W``)."""
    mask = resolve_decay_mask(mask)

    def update(updates, state, params):
        if weight_decay == 0.0:
            return updates, state
        keep = (mask(params) if callable(mask) else mask) or {}
        return {k: (u + weight_decay * params[k].float()
                    if keep.get(k, True) else u)
                for k, u in updates.items()}, state

    return GradientTransformation(_empty_init, update)


def rms(x: torch.Tensor, split: Split = WHOLE) -> torch.Tensor:
    """RMS over every entry of a leaf, as ``sqrt(mean(x^2) + 1e-30)``; of
    the whole leaf for a block on a mesh (its ``split``,
    ``core/blocks.py``)."""
    return torch.sqrt(split.mean(torch.square(x)) + 1e-30)


def clip_update_rms(d: float) -> GradientTransformation:
    """Per-leaf RMS clipping ``u <- u / max(1, RMS(u) / d)`` (Shazeer &
    Stern), by division."""

    def update(updates, state, params):
        del params
        return {k: u / torch.clamp_min(rms(u, split_of(k, u)) / d, 1.0)
                for k, u in updates.items()}, state

    return GradientTransformation(_empty_init, update)


def scale_by_schedule(schedule: "float | Callable",
                      lr_scale: float = 1.0) -> GradientTransformation:
    """Multiply updates by ``schedule(t)`` with ``t`` counting from 1.
    ``lr_scale`` is a per-group multiplier on top of the shared schedule
    (inside :func:`partition` chains), applied in float32 as in the JAX
    package; 1.0 leaves the arithmetic unchanged."""
    sched = resolve_schedule(schedule)

    def init(params):
        del params
        return CountState(count=0)

    def update(updates, state, params):
        del params
        count = state.count + 1
        lr = sched(count)            # a float32 scalar
        if lr_scale != 1.0:
            lr = lr * lr_scale
        lr = float(lr)               # exact as a double
        return ({k: u * lr for k, u in updates.items()},
                CountState(count=count))

    return GradientTransformation(init, update)


def scale_by_relative_step(eps2: float = 1e-3,
                           lr_scale: float = 1.0) -> GradientTransformation:
    """Adafactor's relative step size, per leaf
    ``alpha_t = max(eps2, RMS(W)) * min(1e-2, 1 / sqrt(t))`` with ``t``
    counting from 1, in float32; it takes the place of
    :func:`scale_by_schedule` when ``relative_step`` is set."""

    def init(params):
        del params
        return CountState(count=0)

    def update(updates, state, params):
        count = state.count + 1
        t = torch.tensor(float(count), dtype=torch.float32)
        rho = torch.clamp_max(1.0 / torch.sqrt(t), 1e-2)
        if lr_scale != 1.0:
            rho = rho * lr_scale
        out = {}
        for k, u in updates.items():
            alpha = torch.clamp_min(rms(params[k].float(),
                                        split_of(k, params[k])), eps2) \
                * rho.to(u.device)
            out[k] = u * alpha
        return out, CountState(count=count)

    return GradientTransformation(init, update)


# ---------------------------------------------------------------------------
# Parameter-group partitioning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PartitionState:
    """State of :func:`partition`: ``inner`` maps each label to its
    transform's state; ``labels`` holds one label per parameter leaf, in
    flatten order, fixed at init (static: not a checkpoint leaf)."""

    inner: dict
    labels: tuple = dataclasses.field(metadata=dict(static=True))


def partition(labeler: "Callable | dict",
              transforms: "dict[str, GradientTransformation]"
              ) -> GradientTransformation:
    """Route parameter groups through per-label transforms.

    ``labeler``: ``{name: label}`` for the params, or a callable ``params
    -> {name: label}``.  Every label must be a key of ``transforms``.
    Each transform sees a dict of only the leaves it owns, in flatten
    order, so a leaf's position inside its group (which keys the S-RSI
    sketch and the count-min hash seeds) is its position among that
    group's leaves, as in the JAX package, where the other leaves are
    ``None`` and drop out of the flatten.  Updates are merged back by
    name.  A group that owns no leaf gets an empty dict."""
    items = tuple(sorted(transforms.items()))
    known = {label for label, _ in items}

    def own(tree: dict, params: dict, labels: tuple, label: str) -> dict:
        return {k: tree[k] for k, l in zip(params, labels) if l == label}

    def init(params):
        labels = labeler(params) if callable(labeler) else labeler
        labels = tuple(labels[k] for k in params)
        if not set(labels) <= known:
            raise ValueError(f"labeler produced labels "
                             f"{sorted(set(labels) - known)} with no "
                             f"transform; known: {sorted(known)}")
        return PartitionState(
            inner={label: t.init(own(params, params, labels, label))
                   for label, t in items},
            labels=labels)

    def update(grads, state: PartitionState, params):
        labels = state.labels       # ownership fixed at init
        merged, inner = {}, {}
        for label, t in items:
            upd, inner[label] = t.update(
                own(grads, params, labels, label), state.inner[label],
                own(params, params, labels, label))
            merged.update(upd)
        return ({k: merged[k] for k in params},
                PartitionState(inner=inner, labels=labels))

    def spec(state: PartitionState, param_specs: dict):
        # each group's hook sees the specs of the leaves it owns, in
        # flatten order, as its init saw the leaves
        return PartitionState(
            inner={label: state_sharding_spec(
                t, state.inner[label],
                own(param_specs, param_specs, state.labels, label))
                for label, t in items},
            labels=state.labels)

    return GradientTransformation(init, update, spec)
