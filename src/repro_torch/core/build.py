"""``build_optimizer(OptimizerConfig)``: the one optimizer-construction path
of the port.  Lowers the config to the documented chains

    adapprox : scale_by_adapprox     -> +wd*W -> *lr_t -> *(-1)
    adamw    : scale_by_adam         -> +wd*W -> *lr_t -> *(-1)
    adafactor: scale_by_factored_rms -> +wd*W -> *lr_t | *alpha_t -> *(-1)
    came     : scale_by_came         -> +wd*W -> *lr_t -> *(-1)
    sketch   : scale_by_sketch       -> +wd*W -> *lr_t -> *(-1)

``cfg.groups`` lowers to :func:`repro_torch.core.transform.partition`:
each ``(label, GroupSpec)`` pair becomes its own chain (the group's family,
the shared decay mask, the shared schedule scaled by ``lr_scale``, the
descent sign), and a shape-based labeler routes every leaf to the first
group whose ``select`` matches.  The launcher's default,
``default_mixed_groups()``, runs the count-min sketch on embedding tables,
Adapprox on factorable matrices and dense Adam on the rest.

``cfg.guards`` wraps the outermost transform, chain or partition, in the
non-finite skip-step guard (``resilience.guards.guard_updates``), so a
tripped step freezes the parameters through every stage, weight decay
included, and arms the xi watchdog of every Adapprox stage
(``GuardConfig(xi_trip=guard_xi_trip, max_demotions=max_demotions)``),
whose counters the wrapper advances in its one host read a step.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.config import GroupSpec, OptimizerConfig
from repro_torch.core.adafactor import AdafactorConfig, scale_by_factored_rms
from repro_torch.core.adamw import scale_by_adam
from repro_torch.core.adapprox import AdapproxConfig, scale_by_adapprox
from repro_torch.core.came import CAMEConfig, scale_by_came
from repro_torch.core.factored import should_factor
from repro_torch.core.rank import RankConfig
from repro_torch.core.sketch import (SketchConfig, scale_by_sketch,
                                     should_sketch)
from repro_torch.core.srsi import SketchSource
from repro_torch.core.transform import (add_decayed_weights, partition,
                                        resolve_decay_mask, scale,
                                        scale_by_relative_step,
                                        scale_by_schedule)
from repro_torch.core.types import (GradientTransformation, Schedule, chain,
                                    constant_schedule)
from repro_torch.resilience.guards import GuardConfig, guard_updates


def _schedule_of(cfg: OptimizerConfig) -> Callable:
    if cfg.schedule == "constant":
        return constant_schedule(cfg.lr)
    if cfg.schedule == "cosine":
        return Schedule(cfg.lr, warmup_steps=cfg.warmup_steps,
                        total_steps=cfg.total_steps, min_lr=cfg.min_lr)
    raise ValueError(f"unknown schedule {cfg.schedule!r} "
                     f"(expected 'cosine' or 'constant')")


def _preconditioner(cfg: OptimizerConfig, name: str, sched: Callable,
                    sketch: Optional[SketchSource]) -> GradientTransformation:
    """The ``scale_by_*`` stage of one optimizer family."""
    if name == "adapprox":
        return scale_by_adapprox(AdapproxConfig(
            lr=sched, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, clip_d=cfg.clip_d,
            weight_decay=cfg.weight_decay,
            rank=RankConfig(k_init=cfg.k, k_max=cfg.k_max,
                            xi_thresh=cfg.xi_thresh, delta_s=cfg.delta_s,
                            mode=cfg.rank_mode),
            oversample=cfg.oversample, n_iter=cfg.n_iter,
            min_dim_factor=cfg.min_dim_factor, guidance=cfg.guidance,
            implicit=cfg.implicit, use_kernels=cfg.use_kernels,
            factor_dtype=("int8" if cfg.quantize_factors
                          else cfg.factor_dtype),
            seed=cfg.seed, refresh_every=cfg.refresh_every,
            warm_start=cfg.warm_start, n_iter_warm=cfg.n_iter_warm,
            warm_drift_xi=cfg.warm_drift_xi, bucketed=cfg.bucketed,
            fused_update=cfg.fused_update, telemetry=cfg.telemetry,
            dynamic_refresh=cfg.dynamic_refresh,
            guards=(GuardConfig(xi_trip=cfg.guard_xi_trip,
                                max_demotions=cfg.max_demotions)
                    if cfg.guards else None), sketch=sketch))
    if name == "adamw":
        return scale_by_adam(cfg.b1, cfg.b2, cfg.eps)
    if name == "sketch":
        return scale_by_sketch(SketchConfig(
            lr=sched, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
            weight_decay=cfg.weight_decay, depth=cfg.sketch_depth,
            width=cfg.sketch_width, min_rows=cfg.embedding_min_rows,
            seed=cfg.seed, telemetry=cfg.telemetry))
    if name == "adafactor":
        return scale_by_factored_rms(AdafactorConfig(
            lr=sched, b1=cfg.b1, b2=cfg.b2, b2_schedule=cfg.b2_schedule,
            clip_d=cfg.clip_d, weight_decay=cfg.weight_decay,
            relative_step=cfg.relative_step,
            min_dim_factor=cfg.min_dim_factor))
    if name == "came":
        return scale_by_came(CAMEConfig(
            lr=sched, b1=cfg.b1, b2=cfg.b2, b3=cfg.b3, clip_d=cfg.clip_d,
            weight_decay=cfg.weight_decay,
            min_dim_factor=cfg.min_dim_factor))
    raise ValueError(f"unknown optimizer {name!r}; "
                     f"available: adapprox, adamw, adafactor, came, sketch")


def _chain_for(cfg: OptimizerConfig, name: str, sched: Callable, mask,
               sketch: Optional[SketchSource],
               lr_scale: float = 1.0) -> GradientTransformation:
    """preconditioner -> +wd*W -> *lr_t -> *(-1); Adafactor with
    ``relative_step`` scales by its relative step size instead of lr_t."""
    if name == "adafactor" and cfg.relative_step:
        step_stage = scale_by_relative_step(lr_scale=lr_scale)
    else:
        step_stage = scale_by_schedule(sched, lr_scale=lr_scale)
    return chain(
        _preconditioner(cfg, name, sched, sketch),
        add_decayed_weights(cfg.weight_decay, mask),
        step_stage,
        scale(-1.0),
    )


def _select_matches(select: str, shape: tuple, min_dim_factor: int,
                    embedding_min_rows: int) -> bool:
    if select == "embeddings":
        return should_sketch(tuple(shape), embedding_min_rows)
    if select == "factored":
        return should_factor(tuple(shape), min_dim_factor)
    if select == "matrices":
        return len(shape) >= 2
    if select == "vectors":
        return len(shape) < 2
    if select == "rest":
        return True
    raise ValueError(f"unknown GroupSpec.select {select!r} (expected "
                     f"'embeddings', 'factored', 'matrices', 'vectors' "
                     f"or 'rest')")


def group_labeler(groups: tuple, min_dim_factor: int,
                  embedding_min_rows: int = 1024) -> Callable:
    """params -> {name: label}, the first matching group (declaration
    order) wins.  Looks at leaf shapes only."""

    def label_of(p):
        for label, g in groups:
            if _select_matches(g.select, tuple(p.shape), min_dim_factor,
                               embedding_min_rows):
                return label
        raise ValueError(
            f"no group matches leaf of shape {tuple(p.shape)}; add a "
            f"catch-all (label, GroupSpec(select='rest')) group")

    return lambda params: {k: label_of(p) for k, p in params.items()}


def _build_partitioned(cfg: OptimizerConfig, sched: Callable, mask,
                       sketch: Optional[SketchSource]
                       ) -> GradientTransformation:
    groups = tuple(cfg.groups)
    seen = set()
    for label, g in groups:
        if not isinstance(g, GroupSpec):
            raise TypeError(f"group {label!r}: expected GroupSpec, got "
                            f"{type(g).__name__}")
        if label in seen:
            raise ValueError(f"duplicate group label {label!r}")
        seen.add(label)
    if groups[-1][1].select != "rest":
        raise ValueError("the last group must be a catch-all "
                         "GroupSpec(select='rest') so every leaf is owned")
    transforms = {
        label: _chain_for(cfg, g.name or cfg.name, sched, mask, sketch,
                          g.lr_scale)
        for label, g in groups}
    return partition(group_labeler(groups, cfg.min_dim_factor,
                                   cfg.embedding_min_rows), transforms)


def build_optimizer(cfg: OptimizerConfig,
                    sketch: Optional[SketchSource] = None
                    ) -> GradientTransformation:
    """Build the configured chain, or with ``cfg.groups`` the partitioned
    per-group chains.  ``sketch`` replaces the Gaussian sketch source of
    S-RSI in every Adapprox stage (see ``core/srsi.py``); None draws
    seeded torch normals."""
    sched = _schedule_of(cfg)
    mask = resolve_decay_mask(cfg.decay_mask)
    if cfg.groups:
        opt = _build_partitioned(cfg, sched, mask, sketch)
    else:
        opt = _chain_for(cfg, cfg.name, sched, mask, sketch)
    if cfg.guards:
        opt = guard_updates(opt)
    return opt
