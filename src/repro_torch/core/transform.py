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

from repro_torch.core.types import (EmptyState, GradientTransformation,
                                    resolve_schedule)


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


def scale_by_schedule(schedule: "float | Callable") -> GradientTransformation:
    """Multiply updates by ``schedule(t)`` with ``t`` counting from 1."""
    sched = resolve_schedule(schedule)

    def init(params):
        del params
        return CountState(count=0)

    def update(updates, state, params):
        del params
        count = state.count + 1
        lr = float(sched(count))     # a float32 value, exact as a double
        return ({k: u * lr for k, u in updates.items()},
                CountState(count=count))

    return GradientTransformation(init, update)
