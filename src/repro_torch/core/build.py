"""``build_optimizer(OptimizerConfig)``: the one optimizer-construction path
of the port.  Lowers the config to the documented chain

    adapprox : scale_by_adapprox -> +wd*W -> *lr_t -> *(-1)

Other families and parameter groups (the launcher's mixed-groups
partition) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.config import OptimizerConfig
from repro_torch.core.adapprox import AdapproxConfig, adapprox
from repro_torch.core.rank import RankConfig
from repro_torch.core.srsi import SketchSource
from repro_torch.core.transform import resolve_decay_mask
from repro_torch.core.types import (GradientTransformation, Schedule,
                                    constant_schedule)


def _schedule_of(cfg: OptimizerConfig) -> Callable:
    if cfg.schedule == "constant":
        return constant_schedule(cfg.lr)
    if cfg.schedule == "cosine":
        return Schedule(cfg.lr, warmup_steps=cfg.warmup_steps,
                        total_steps=cfg.total_steps, min_lr=cfg.min_lr)
    raise ValueError(f"unknown schedule {cfg.schedule!r} "
                     f"(expected 'cosine' or 'constant')")


def build_optimizer(cfg: OptimizerConfig,
                    sketch: Optional[SketchSource] = None
                    ) -> GradientTransformation:
    """Build the configured chain.  ``sketch`` replaces the Gaussian sketch
    source of S-RSI (see ``core/srsi.py``); None draws seeded torch
    normals."""
    if cfg.groups:
        raise NotImplementedError(
            "parameter groups (the mixed-groups partition with the sketch "
            "family) are not ported to PyTorch yet; see ROADMAP.md Queue A "
            "item 9")
    if cfg.name != "adapprox":
        raise NotImplementedError(
            f"optimizer family {cfg.name!r} is not ported to PyTorch yet; "
            f"the port builds 'adapprox' (see ROADMAP.md Queue A)")
    if cfg.guards:
        raise NotImplementedError("guards are not ported to PyTorch yet; "
                                  "see ROADMAP.md Queue A")
    sched = _schedule_of(cfg)
    acfg = AdapproxConfig(
        lr=sched, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, clip_d=cfg.clip_d,
        weight_decay=cfg.weight_decay,
        rank=RankConfig(k_init=cfg.k, k_max=cfg.k_max,
                        xi_thresh=cfg.xi_thresh, delta_s=cfg.delta_s,
                        mode=cfg.rank_mode),
        oversample=cfg.oversample, n_iter=cfg.n_iter,
        min_dim_factor=cfg.min_dim_factor, guidance=cfg.guidance,
        implicit=cfg.implicit, use_kernels=cfg.use_kernels,
        factor_dtype="int8" if cfg.quantize_factors else cfg.factor_dtype,
        seed=cfg.seed, refresh_every=cfg.refresh_every,
        warm_start=cfg.warm_start, bucketed=cfg.bucketed,
        fused_update=cfg.fused_update, telemetry=cfg.telemetry,
        dynamic_refresh=cfg.dynamic_refresh, sketch=sketch)
    return adapprox(acfg, resolve_decay_mask(cfg.decay_mask))
