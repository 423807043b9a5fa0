"""Adafactor (Shazeer & Stern, 2018), one of the paper's baselines.

Port of the JAX package's ``core/adafactor.py``: a rank-1 row / column
factored second moment for matrices, ``V ~ R C / mean(R)`` (dense for the
rest), the optional schedule ``b2_t = 1 - t^-0.8``, RMS update clipping
over the whole leaf, an optional first moment, decoupled weight decay and
optional relative step sizes.  :func:`adafactor` is the chain

    chain(scale_by_factored_rms(cfg),
          add_decayed_weights(wd),
          scale_by_schedule(lr) | scale_by_relative_step(eps2),
          scale(-1.0))

The row and column means are tensor code on every device: the JAX package
has no kernel for them either.  On a mesh (``core/blocks.py``) a block's
row and column means, the mean of R and the RMS clip add over the split
axis they cross.  ``b2_t`` is a float32 power taken as the
port's Adam takes ``b ** t`` (``adamw.float32_pow``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.adamw import float32_pow
from repro_torch.core.blocks import WHOLE, Split, split_of
from repro_torch.core.factored import should_factor
from repro_torch.core.transform import (add_decayed_weights, rms, scale,
                                        scale_by_relative_step,
                                        scale_by_schedule)
from repro_torch.core.types import GradientTransformation, P, chain
from repro_torch.kernels.ref import f32_one_minus


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: "float | Callable" = 1e-3
    b1: float = 0.0                  # Adafactor default: first moment off
    b2: float = 0.999
    b2_schedule: bool = True         # b2_t = 1 - t^decay_exponent
    decay_exponent: float = -0.8
    eps1: float = 1e-30              # regulariser inside the factored stats
    eps2: float = 1e-3               # relative-step floor (only if relative)
    clip_d: float = 1.0
    weight_decay: float = 0.0
    relative_step: bool = False
    min_dim_factor: int = 128


@dataclasses.dataclass
class AdafactorLeaf:
    r: Optional[torch.Tensor]     # (*batch, m) row stats  | None if dense
    c: Optional[torch.Tensor]     # (*batch, n) col stats  | None if dense
    v: Optional[torch.Tensor]     # dense second moment    | None if factored
    m1: Optional[torch.Tensor]


@dataclasses.dataclass
class AdafactorState:
    step: int                     # counts from 0
    leaves: tuple                 # AdafactorLeaf per param, flatten order


def factored_vhat(r: torch.Tensor, c: torch.Tensor,
                  split: Split = WHOLE) -> torch.Tensor:
    """``outer(r, c) / mean(r)`` over the trailing axis of r and c (r's
    mean over the whole rows of a row-split block)."""
    denom = split.mean(r, -1, (-2,)).unsqueeze(-1).unsqueeze(-1)
    return (r.unsqueeze(-1) * c.unsqueeze(-2)) / (denom + 1e-30)


def ema_rowcol(r, c, gsq, b: float, omb: float, split: Split = WHOLE):
    """The row and column statistics' EMA of ``gsq`` (*batch, m, n)."""
    return (b * r + omb * split.mean(gsq, -1),
            b * c + omb * split.mean(gsq, -2))


def scale_by_factored_rms(cfg: AdafactorConfig) -> GradientTransformation:
    """Adafactor's preconditioner: factored (or dense) second moment, RMS
    clipping and the optional first-moment EMA."""

    def init(params):
        def mk(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            m1 = z(p.shape) if cfg.b1 > 0 else None
            if should_factor(tuple(p.shape), cfg.min_dim_factor):
                bd = tuple(p.shape[:-2])
                return AdafactorLeaf(r=z(bd + (p.shape[-2],)),
                                     c=z(bd + (p.shape[-1],)), v=None, m1=m1)
            return AdafactorLeaf(r=None, c=None, v=z(p.shape), m1=m1)
        return AdafactorState(step=0, leaves=tuple(
            mk(p) for p in params.values()))

    def update(grads, state: AdafactorState, params):
        del params
        step = state.step + 1
        b2t = (f32_one_minus(float32_pow(step, cfg.decay_exponent))
               if cfg.b2_schedule else cfg.b2)
        omb2 = f32_one_minus(b2t) if cfg.b2_schedule else 1.0 - cfg.b2
        outs, new_leaves = {}, []
        for (name, g), leaf in zip(grads.items(), state.leaves):
            split = split_of(name, g)
            g32 = g.float()
            gsq = torch.square(g32) + cfg.eps1
            if leaf.r is not None:
                r, c = ema_rowcol(leaf.r, leaf.c, gsq, b2t, omb2, split)
                u = g32 / (torch.sqrt(factored_vhat(r, c, split)) + 1e-30)
                new = AdafactorLeaf(r=r, c=c, v=None, m1=leaf.m1)
            else:
                v = b2t * leaf.v + omb2 * gsq
                u = g32 / (torch.sqrt(v) + 1e-30)
                new = AdafactorLeaf(r=None, c=None, v=v, m1=leaf.m1)
            u = u / torch.clamp_min(rms(u, split) / cfg.clip_d, 1.0)
            if leaf.m1 is not None:
                u = cfg.b1 * leaf.m1 + (1.0 - cfg.b1) * u
                new.m1 = u
            outs[name] = u
            new_leaves.append(new)
        return outs, AdafactorState(step=step, leaves=tuple(new_leaves))

    return GradientTransformation(init, update, _adafactor_state_spec)


def rowcol_spec(pspec: P) -> tuple[P, P]:
    """Row and column stat specs of a param (..., m, n) with spec (..., a,
    b): (..., a) and (..., b)."""
    parts = list(pspec)
    bd, a, b = parts[:-2], parts[-2], parts[-1]
    return P(*bd, a), P(*bd, b)


def _adafactor_state_spec(state: AdafactorState, param_specs: dict):
    leaves = []
    for pspec, leaf in zip(param_specs.values(), state.leaves):
        m1 = pspec if leaf.m1 is not None else None
        if leaf.r is not None:
            rs, cs = rowcol_spec(pspec)
            leaves.append(AdafactorLeaf(r=rs, c=cs, v=None, m1=m1))
        else:
            leaves.append(AdafactorLeaf(r=None, c=None, v=pspec, m1=m1))
    return AdafactorState(step=P(), leaves=tuple(leaves))


def adafactor(cfg: AdafactorConfig,
              decay_mask: Optional[Callable] = None
              ) -> GradientTransformation:
    """Adafactor as a chain (see module docstring)."""
    step_stage = (scale_by_relative_step(cfg.eps2) if cfg.relative_step
                  else scale_by_schedule(cfg.lr))
    return chain(
        scale_by_factored_rms(cfg),
        add_decayed_weights(cfg.weight_decay, decay_mask),
        step_stage,
        scale(-1.0),
    )
