"""CAME (Luo et al., ACL 2023): Confidence-guided Adaptive Memory
Efficient optimization, one of the paper's baselines.

Port of the JAX package's ``core/came.py``: Adafactor's factored second
moment, plus a factored instability statistic ``S_t = (u_t - m_t)^2``
whose inverse square root scales the first moment (confidence guidance).
CAME needs ``b1 > 0`` and refuses anything else.  :func:`came` is the
chain

    chain(scale_by_came(cfg),
          add_decayed_weights(wd),
          scale_by_schedule(lr),
          scale(-1.0))

The row and column means are tensor code on every device, as in the JAX
package; on a mesh they add over the split axis they cross, as
Adafactor's do.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.adafactor import ema_rowcol, factored_vhat, rowcol_spec
from repro_torch.core.blocks import split_of
from repro_torch.core.factored import should_factor
from repro_torch.core.transform import (add_decayed_weights, rms, scale,
                                        scale_by_schedule)
from repro_torch.core.types import GradientTransformation, P, chain


@dataclasses.dataclass(frozen=True)
class CAMEConfig:
    lr: "float | Callable" = 1e-3
    b1: float = 0.9
    b2: float = 0.999      # second-moment decay
    b3: float = 0.9999     # instability-statistic decay
    eps1: float = 1e-30
    eps2: float = 1e-16
    clip_d: float = 1.0
    weight_decay: float = 0.0
    min_dim_factor: int = 128


@dataclasses.dataclass
class CAMELeaf:
    r: Optional[torch.Tensor]      # second-moment row stats
    c: Optional[torch.Tensor]
    v: Optional[torch.Tensor]      # dense second moment
    rs: Optional[torch.Tensor]     # instability row stats
    cs: Optional[torch.Tensor]
    m1: torch.Tensor               # first moment (required)


@dataclasses.dataclass
class CAMEState:
    step: int                      # counts from 0
    leaves: tuple                  # CAMELeaf per param, flatten order


def scale_by_came(cfg: CAMEConfig) -> GradientTransformation:
    """CAME's preconditioner: factored second moment, RMS clip, first
    moment and the factored instability's confidence scaling."""
    if cfg.b1 <= 0:
        raise ValueError("CAME requires b1 > 0 (confidence guidance depends "
                         "on the first moment; see Adapprox Table 2).")

    def init(params):
        def mk(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            m1 = z(p.shape)
            if should_factor(tuple(p.shape), cfg.min_dim_factor):
                bd = tuple(p.shape[:-2])
                zr, zc = z(bd + (p.shape[-2],)), z(bd + (p.shape[-1],))
                return CAMELeaf(r=zr, c=zc, v=None, rs=zr.clone(),
                                cs=zc.clone(), m1=m1)
            return CAMELeaf(r=None, c=None, v=z(p.shape), rs=None, cs=None,
                            m1=m1)
        return CAMEState(step=0, leaves=tuple(mk(p)
                                              for p in params.values()))

    def update(grads, state: CAMEState, params):
        del params
        outs, new_leaves = {}, []
        for (name, g), leaf in zip(grads.items(), state.leaves):
            split = split_of(name, g)
            g32 = g.float()
            gsq = torch.square(g32) + cfg.eps1
            if leaf.r is not None:
                r, c = ema_rowcol(leaf.r, leaf.c, gsq, cfg.b2, 1.0 - cfg.b2,
                                  split)
                u = g32 / (torch.sqrt(factored_vhat(r, c, split)) + 1e-30)
            else:
                v = cfg.b2 * leaf.v + (1.0 - cfg.b2) * gsq
                u = g32 / (torch.sqrt(v) + 1e-30)
            u = u / torch.clamp_min(rms(u, split) / cfg.clip_d, 1.0)
            m1 = cfg.b1 * leaf.m1 + (1.0 - cfg.b1) * u
            if leaf.r is not None:
                s = torch.square(u - m1) + cfg.eps2
                rs, cs = ema_rowcol(leaf.rs, leaf.cs, s, cfg.b3,
                                    1.0 - cfg.b3, split)
                outs[name] = m1 / (torch.sqrt(factored_vhat(rs, cs, split))
                                   + 1e-30)
                new = CAMELeaf(r=r, c=c, v=None, rs=rs, cs=cs, m1=m1)
            else:
                outs[name] = m1
                new = CAMELeaf(r=None, c=None, v=v, rs=None, cs=None, m1=m1)
            new_leaves.append(new)
        return outs, CAMEState(step=state.step + 1,
                               leaves=tuple(new_leaves))

    return GradientTransformation(init, update, _came_state_spec)


def _came_state_spec(state: CAMEState, param_specs: dict):
    leaves = []
    for pspec, leaf in zip(param_specs.values(), state.leaves):
        if leaf.r is not None:
            rs, cs = rowcol_spec(pspec)
            leaves.append(CAMELeaf(r=rs, c=cs, v=None, rs=rs, cs=cs,
                                   m1=pspec))
        else:
            leaves.append(CAMELeaf(r=None, c=None, v=pspec, rs=None,
                                   cs=None, m1=pspec))
    return CAMEState(step=P(), leaves=tuple(leaves))


def came(cfg: CAMEConfig,
         decay_mask: Optional[Callable] = None) -> GradientTransformation:
    """CAME as a chain (see module docstring)."""
    return chain(
        scale_by_came(cfg),
        add_decayed_weights(cfg.weight_decay, decay_mask),
        scale_by_schedule(cfg.lr),
        scale(-1.0),
    )
