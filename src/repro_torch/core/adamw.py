"""AdamW (Loshchilov & Hutter), the paper's baseline, and the bias-corrected
dense-Adam preconditioner that the mixed groups' ``"dense"`` family runs.

Port of the JAX package's ``core/adamw.py``.  As there, the first moment is
allocated even when ``b1 = 0`` (the paper's memory accounting), and
:func:`adamw` is the chain

    chain(scale_by_adam(b1, b2, eps),
          add_decayed_weights(wd),
          scale_by_schedule(lr),
          scale(-1.0))

Rounding follows the JAX package: the step ``t`` is a float32 scalar, so
``b1 ** t`` and ``b2 ** t`` are float32 powers, and ``1 - b`` is a Python
double rounded once to float32 where it multiplies a tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.transform import (add_decayed_weights, scale,
                                        scale_by_schedule)
from repro_torch.core.types import GradientTransformation, P, chain
from repro_torch.kernels.ref import f32_one_minus


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: "float | Callable" = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


@dataclasses.dataclass
class AdamWState:
    step: int           # counts from 0
    m: dict             # {name: fp32 tensor}, like params
    v: dict


def float32_pow(base: float, exponent: float) -> float:
    """``base ** exponent`` of the two rounded to float32, taken in double
    and rounded once to float32, as an exact Python float: what XLA's
    float32 ``pow`` gives on the CPU (libm's ``powf`` is off by an ulp for
    some arguments, and ``1 - b2 ** t`` magnifies that a thousandfold)."""
    return float(np.float32(float(np.float32(base))
                            ** float(np.float32(exponent))))


def bias_corrections(b1: float, b2: float, step: int) -> tuple[float, float]:
    """``(1 - b1 ** t, 1 - b2 ** t)`` in float32, as exact Python floats."""
    return (f32_one_minus(float32_pow(b1, step)),
            f32_one_minus(float32_pow(b2, step)))


def adam_leaf(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, b1: float,
              b2: float, eps: float, bc1: float, bc2: float):
    """One leaf of bias-corrected Adam: returns ``(direction, m, v)``.
    Shared by :func:`scale_by_adam` and the sketch family's dense leaves,
    which must agree bit for bit."""
    g32 = g.float()
    m = b1 * m + (1.0 - b1) * g32
    v = b2 * v + (1.0 - b2) * torch.square(g32)
    return (m / bc1) / (torch.sqrt(v / bc2) + eps), m, v


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """Bias-corrected Adam direction ``m_hat / (sqrt(v_hat) + eps)``."""

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        return AdamWState(step=0, m={k: z(p) for k, p in params.items()},
                          v={k: z(p) for k, p in params.items()})

    def update(grads, state: AdamWState, params):
        del params
        step = state.step + 1
        bc1, bc2 = bias_corrections(b1, b2, step)
        dirs, ms, vs = {}, {}, {}
        for k, g in grads.items():
            dirs[k], ms[k], vs[k] = adam_leaf(g, state.m[k], state.v[k], b1,
                                              b2, eps, bc1, bc2)
        return dirs, AdamWState(step=step, m=ms, v=vs)

    def spec(state: AdamWState, param_specs: dict):
        del state
        return AdamWState(step=P(), m=dict(param_specs), v=dict(param_specs))

    return GradientTransformation(init, update, spec)


def adamw(cfg: AdamWConfig,
          decay_mask: Optional[Callable] = None) -> GradientTransformation:
    """AdamW as a chain (see module docstring)."""
    return chain(
        scale_by_adam(cfg.b1, cfg.b2, cfg.eps),
        add_decayed_weights(cfg.weight_decay, decay_mask),
        scale_by_schedule(cfg.lr),
        scale(-1.0),
    )
