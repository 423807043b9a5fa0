"""Adapprox (Algorithm 3): Adam with a randomized-low-rank second moment.

Port of the JAX package's ``core/adapprox.py`` for the paper-faithful
update and its engineered knobs on the GPT-2 path:

  * no bias correction; update clipping ``u <- u / max(1, RMS(u)/d)``; the
    first moment is an EMA of *updates*; decoupled weight decay;
  * the second moment lives as factors (Q, U) between steps:
    ``V_t = b2 * max(Q U^T, 0) + (1 - b2) * G_t^2`` is rebuilt each step
    and re-factored by S-RSI with adaptive rank; optional cosine guidance;
  * ``refresh_every=T``: full S-RSI at t = 1, 1+T, 1+2T, ...; in between
    the factors absorb G^2 by the one-sided fold
    ``U <- b2 U + (1 - b2) (G^2)^T Q`` under the frozen basis Q;
  * ``fused_update``: the elementwise tail runs as two passes (pass 1:
    u_hat plus every reduction the tail needs, V never stored; pass 2:
    clip + first-moment EMA + guidance in one read-modify-write), through
    ``kernels/ops.py`` -- CUDA kernels on the card, their plain versions on
    the CPU.  Equal to the unfused tail for ``guidance="off"``;
  * ``use_kernels`` (without ``fused_update``): the single-pass update
    ``ops.lowrank_update`` rebuilds V per tile (V is formed only on
    refresh steps, for S-RSI) and the fold's (G^2)^T Q goes through
    ``ops.one_sided_fold``;
  * ``factor_dtype="int8"``: the factors are stored as the int8 codec of
    ``core/quantized.py`` and requantized after every step.  With
    ``fused_update`` they go into pass 1 as they are (dequantized in the
    kernel) and the refresh or fold takes them dequantized once; otherwise
    they are dequantized before the step;
  * ``implicit``: S-RSI applies V through ``ImplicitV.mv`` / ``rmv``
    without forming it; ||V||_F^2 comes from pass 1's ``vfro`` on the
    fused path, else from the V the step formed, else streamed;
  * ``warm_start``: a refresh after step 1 seeds S-RSI from the stored U
    (the one the last fold left) and runs ``n_iter_warm`` power
    iterations; a matrix whose stored xi exceeds ``warm_drift_xi`` keeps
    the Gaussian sketch;
  * ``bucketed``: factored leaves of one shape and gradient dtype run as
    one stacked call (a singleton runs alone);
  * ``telemetry``: the state carries a
    ``telemetry.snapshot.TelemetrySnapshot`` of the step, assembled from
    values the update already has (per-leaf means of xi and k, the clip
    denominator each path computes anyway, the host's refresh decision),
    so the updates are bitwise those with it off;
  * ``dynamic_refresh``: the cadence lives on the state
    (``AdapproxState.refresh_every``, a host int the closed-loop
    controller retunes between steps, ``telemetry.set_refresh_every``) and
    replaces ``cfg.refresh_every`` everywhere the step reads the cadence:
    the refresh-or-fold choice and the rank's re-selection period.  The
    JAX package computes pass 1's fold on every step in this mode, because
    its ``lax.cond`` needs both branches; the port decides on the host and
    folds on fold steps only, as with a static cadence;
  * ``guards`` (a ``resilience.guards.GuardConfig``): the xi watchdog.  A
    factored leaf whose worst xi exceeds ``xi_trip`` refreshes on the next
    step whatever the cadence; after ``max_demotions`` consecutive trips
    it runs the exact dense second moment on a shadow buffer seeded from
    ``max(Q U^T, 0)`` (plain tensor code on every device: a demoted leaf
    launches no kernel), with the factors, k and guidance frozen and xi
    pinned to 0.  Guards run every factored leaf alone, even under
    ``bucketed``.  A guarded stage runs inside
    ``resilience.guards.guard_updates`` (``build_optimizer`` builds both
    under ``OptimizerConfig.guards``): it writes each new first moment
    into a fresh buffer, never over the ``m1`` it was given, so a step the
    skip-step guard rejects leaves the state intact, and it leaves this
    step's worst xi per factored leaf on its state (``pending``) for the
    wrapper, which reads it with its all-finite flag in one transfer and
    advances the host counters (:func:`settle_guards`).

Stacked ``(L, m, n)`` leaves are batched: each leaf is one batched call,
not a loop over its matrices.  Leaves are walked in JAX's flatten order;
leaf ``i``'s sketch at step ``t`` is drawn from a generator seeded by
``(seed, t, i)``, so the draws are a pure function of the step, as in the
JAX package (whose threefry numbers the port does not reproduce).  On a
refresh step every factored leaf's sketch (on any step, every leaf the
watchdog forces; never a demoted leaf's) is drawn, in flatten order,
before any leaf or bucket runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import factored as F
from repro_torch.core import quantized as QZ
from repro_torch.core import rank as R
from repro_torch.core import srsi as S
from repro_torch.core.transform import (add_decayed_weights, scale,
                                        scale_by_schedule)
from repro_torch.core.types import (GradientTransformation, P, chain,
                                    find_states)
from repro_torch.kernels import ops, ref
from repro_torch.resilience.guards import (GuardConfig, GuardState,
                                           advance_counters, guard_spec,
                                           init_guard_state)
from repro_torch.telemetry.snapshot import (TelemetrySnapshot, init_snapshot,
                                            snapshot_spec)


@dataclasses.dataclass(frozen=True)
class AdapproxConfig:
    lr: "float | Callable" = 1e-3          # float or schedule(step) -> lr
    b1: float = 0.9                        # 0.0 disables the first moment
    b2: float = 0.999
    eps: float = 1e-8
    clip_d: float = 1.0                    # RMS clip threshold d
    weight_decay: float = 0.0
    rank: R.RankConfig = dataclasses.field(default_factory=R.RankConfig)
    k_max_frac: float = 0.25               # k_max = frac * min(m, n)
    oversample: int = 5                    # p
    n_iter: int = 5                        # l (power iterations)
    min_dim_factor: int = 128              # factor only if min(m,n) >= this
    guidance: str = "off"                  # "off" | "update" | "stored"
    guidance_max_scale: float = 10.0       # clamp on 1/(1-theta+eps)
    implicit: bool = False
    use_kernels: bool = False
    factor_dtype: str = "float32"
    seed: int = 0
    refresh_every: int = 1                 # full S-RSI every T steps
    warm_start: bool = False               # seed S-RSI from the stored U
    n_iter_warm: int = 1                   # l when warm-started
    warm_drift_xi: float = 0.5             # cold sketch above this xi
    bucketed: bool = False                 # same-shape leaves stacked
    fused_update: bool = False             # two-pass fused elementwise tail
    telemetry: bool = False                # carry a TelemetrySnapshot
    dynamic_refresh: bool = False          # the cadence on the state
    guards: Optional[GuardConfig] = None     # the xi watchdog
    sketch: Optional[S.SketchSource] = None  # None: seeded torch normals


def _check_config(cfg: AdapproxConfig) -> None:
    if cfg.factor_dtype not in ("float32", "int8"):
        raise ValueError(f"unknown factor_dtype {cfg.factor_dtype!r} "
                         f"(expected 'float32' or 'int8')")
    if cfg.guards is not None and not isinstance(cfg.guards, GuardConfig):
        raise TypeError(f"AdapproxConfig.guards: expected a GuardConfig, "
                        f"got {type(cfg.guards).__name__}")
    if cfg.guidance not in ("off", "update", "stored"):
        raise ValueError(f"unknown guidance {cfg.guidance!r}")


def prng_key_words(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as its two uint32 words (32-bit seeds,
    as the JAX package runs them)."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


class PendingGuards(NamedTuple):
    """A guarded step's xi, left on the state until :func:`settle_guards`
    advances the counters from it."""
    xi_max: torch.Tensor      # (n_factored,) worst xi per leaf, on device
    cfg: GuardConfig


@dataclasses.dataclass
class AdapproxState:
    step: int                         # counts from 0
    leaves: tuple                     # FactoredLeaf | DenseLeaf per param,
                                      # in flatten order
    telemetry: Optional[TelemetrySnapshot] = None   # cfg.telemetry
    refresh_every: Optional[int] = None   # cfg.dynamic_refresh: the cadence
    guards: Optional[GuardState] = None   # cfg.guards: the xi watchdog
    # cfg.seed, which the JAX state carries as its PRNG key (the leaf
    # ``key`` after ``step``); the port draws from (seed, t, i) generators
    # instead, and checkpoints write and check the key derived from it
    seed: int = dataclasses.field(default=0, metadata=dict(
        static=True, derived_leaf=("key", "step", prng_key_words)))
    # set between a guarded update and settle_guards only
    pending: Optional[PendingGuards] = dataclasses.field(
        default=None, metadata=dict(static=True))


def _refresh_pred(step: int, refresh_t: int) -> bool:
    """Full S-RSI at t = 1, 1+T, 1+2T, ..."""
    return (step % refresh_t) == (1 % refresh_t)


def _sketch_generator(seed: int, step: int, leaf: int,
                      device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence([seed, step, leaf]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def _drawn(draw: torch.Tensor) -> S.SketchSource:
    """A sketch source that returns a sketch drawn beforehand."""
    return lambda shape, generator: draw


def _bc(s: torch.Tensor) -> torch.Tensor:
    """(*batch,) -> (*batch, 1, 1) for per-matrix scalars."""
    return s.reshape(s.shape + (1, 1))


def _rms(x: torch.Tensor) -> torch.Tensor:
    """Per-matrix RMS over the trailing two axes, as sum / size (the same
    rounding as the fused path's usq / size)."""
    size = x.shape[-2] * x.shape[-1]
    return torch.sqrt(torch.sum(torch.square(x), dim=(-2, -1)) / size
                      + 1e-30)


def _fused_scalars(usq, m1dot, m1sq, size: int, cfg: AdapproxConfig,
                   guidance: bool):
    """Combine the pass-1 reductions into ``(denom, out_scale,
    store_scale)`` for pass 2.  The guidance scalars are recovered
    algebraically from the unclipped partials (c = 1/denom):

        sum(u_c^2) = usq / denom^2,   dot(u_c, m1) = m1dot / denom
        num        = b1 dot(u_c, m1) + (1-b1) sum(u_c^2)
        sum(acc^2) = b1^2 m1sq + 2 b1 (1-b1) dot(u_c, m1)
                     + (1-b1)^2 sum(u_c^2)
    """
    rms = torch.sqrt(usq / size + 1e-30)
    denom = torch.clamp_min(rms / cfg.clip_d, 1.0)
    one = torch.ones_like(denom)
    if not guidance:
        return denom, one, one
    su = usq / (denom * denom)
    du = m1dot / denom
    b1 = cfg.b1
    num = b1 * du + (1.0 - b1) * su
    accsq = (b1 * b1) * m1sq + 2.0 * b1 * (1.0 - b1) * du \
        + (1.0 - b1) ** 2 * su
    den = torch.sqrt(su) * torch.sqrt(accsq)
    theta = num / (den + 1e-30)
    gscale = torch.clamp(1.0 / (1.0 - theta + cfg.eps), 0.0,
                         cfg.guidance_max_scale)
    if cfg.guidance == "stored":
        return denom, gscale, gscale
    return denom, gscale, one


def _leaf_r_store(shape: tuple, cfg: AdapproxConfig) -> int:
    m, n = shape[-2], shape[-1]
    if cfg.rank.mode == "static":
        r = min(cfg.rank.k_init, min(m, n))
    else:
        r = R.resolve_k_max(shape, cfg.rank, cfg.k_max_frac)
    return max(1, r)


def _leaf_meta(shape: tuple, r_store: int, cfg: AdapproxConfig):
    """(oversample p, k_max) for one leaf; paper constraint k + p <= min."""
    m, n = shape[-2], shape[-1]
    p_eff = max(0, min(cfg.oversample, min(m, n) - r_store))
    k_max_leaf = (r_store if cfg.rank.mode == "static"
                  else R.resolve_k_max(shape, cfg.rank, cfg.k_max_frac))
    return p_eff, k_max_leaf


def _init_leaf(p: torch.Tensor, cfg: AdapproxConfig):
    zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
    m1 = zeros(p.shape) if cfg.b1 > 0 else None
    if F.should_factor(tuple(p.shape), cfg.min_dim_factor):
        bd = F.batch_dims(tuple(p.shape))
        m, n = p.shape[-2], p.shape[-1]
        r = _leaf_r_store(tuple(p.shape), cfg)
        k0 = cfg.rank.k_init if cfg.rank.mode != "static" else r
        q0, u0 = zeros(bd + (m, r)), zeros(bd + (n, r))
        if cfg.factor_dtype == "int8":
            q0, u0 = QZ.quantize_tree_factors(q0, u0)
        return F.FactoredLeaf(
            q=q0, u=u0,
            k=torch.full(bd, min(k0, r), dtype=torch.int32, device=p.device),
            xi=zeros(bd), m1=m1)
    return F.DenseLeaf(v=zeros(p.shape), m1=m1)


# ---------------------------------------------------------------------------
# Factored update, batched over leading dims
# ---------------------------------------------------------------------------

def _factored_update(g, leaf: F.FactoredLeaf, step: int,
                     sketch: Optional[S.SketchSource], cfg: AdapproxConfig,
                     r_store: int, p_eff: int, k_max_leaf: int,
                     refresh_t: int, force_refresh: bool = False):
    """One step of a factored leaf.  ``leaf.q`` / ``leaf.u`` are fp32, or
    int8 :class:`QuantizedMatrix` factors on the fused path (pass 1 takes
    them as they are; the refresh or fold takes them dequantized once).
    ``sketch`` returns this step's Gaussian sketch on refresh steps;
    ``refresh_t`` is the cadence in effect; ``force_refresh`` (the xi
    watchdog's) makes a fold step a refresh.  Returns ``(m_out, new_leaf,
    denom)``, ``denom`` the per-matrix clip denominator ``max(1,
    RMS(u) / d)`` the step divided by (telemetry reads it)."""
    q, u, k, xi_prev, m1 = leaf.q, leaf.u, leaf.k, leaf.xi, leaf.m1
    g32 = g.float()
    q32, u32 = ((QZ.dequantize(q), QZ.dequantize(u))
                if isinstance(q, QZ.QuantizedMatrix) else (q, u))
    v_op = S.make_implicit_v(q32, u32, g32, cfg.b2)
    # Paper-faithful: V_t is formed every step for the elementwise update.
    # The fused pipeline and the use_kernels update reconstruct it
    # tile-wise instead, and the refresh branch forms it only when it runs.
    vmat = (None if cfg.fused_update or cfg.use_kernels
            else v_op.materialize())

    refresh = (refresh_t <= 1 or force_refresh
               or _refresh_pred(step, refresh_t))
    yfold = vfro = None
    if cfg.fused_update:
        need_guid = cfg.b1 > 0 and cfg.guidance != "off"
        # On fold steps pass 1 also emits the fold projection (G^2)^T Q
        # from the G tiles it already holds (past ``R_MAX`` columns the
        # dispatch takes it from sq_matmul_t).  The JAX package computes it
        # every step and drops it on refresh steps, where it is not used.
        (u_hat_raw, vfro, usq, m1dot, m1sq, yfold) = ops.fused_precond(
            q, u, g32, cfg.b2, cfg.eps, m1=m1 if need_guid else None,
            with_vfro=cfg.implicit, with_fold=not refresh)

    if refresh:
        # Step 1 has no subspace to inherit and runs cold; the drift guard
        # is per matrix of a stacked leaf.
        warm = cfg.warm_start and step != 1
        n_it = cfg.n_iter_warm if warm else cfg.n_iter
        u0 = u32 if warm else None
        use_warm = xi_prev <= cfg.warm_drift_xi if warm else None
        if cfg.implicit:
            # ||V||_F^2 from pass 1, or from the V formed above; else the
            # streaming frob_sq
            fs = vfro
            if fs is None and vmat is not None:
                fs = torch.sum(torch.square(vmat), dim=(-2, -1))
            res = S.srsi_implicit(v_op, r_store, p_eff, n_it, sketch,
                                  frob_sq=fs, u0=u0, use_warm=use_warm)
        else:
            vm = vmat if vmat is not None else v_op.materialize()
            res = S.srsi_dense(vm, r_store, p_eff, n_it, sketch, u0=u0,
                               use_warm=use_warm)
        k_new = R.select_rank(res.cum_energy, res.frob_sq, cfg.rank,
                              k_max_leaf, step,
                              torch.clamp_max(k, k_max_leaf),
                              refresh_every=refresh_t)
        xi = R.xi_of_k(res.cum_energy, res.frob_sq, k_new)
        mask = S.col_mask(r_store, k_new).unsqueeze(-2)
        q_new, u_new = res.q * mask, res.u * mask
    else:
        mask = S.col_mask(r_store, torch.clamp_max(k, k_max_leaf))
        q_new, k_new, xi = q32, k, xi_prev
        if yfold is not None:
            u_new = (cfg.b2 * u32 + (1.0 - cfg.b2) * yfold
                     ) * mask.unsqueeze(-2)
        else:
            u_new = (ops if cfg.use_kernels else ref).one_sided_fold(
                u32, q32, g32, cfg.b2, mask)

    size = g32.shape[-2] * g32.shape[-1]
    if cfg.fused_update:
        denom, out_scale, store_scale = _fused_scalars(
            usq, m1dot, m1sq, size, cfg, need_guid)
        # guidance "off" / "stored": out_scale == store_scale, so the step
        # direction IS the new first moment and pass 2 writes it once.
        m_out, m1_new = ops.fused_apply(
            u_hat_raw, m1, denom, cfg.b1, out_scale, store_scale,
            shared_out=cfg.b1 > 0 and cfg.guidance != "update",
            in_place=cfg.guards is None)
        return m_out, F.FactoredLeaf(q=q_new, u=u_new, k=k_new, xi=xi,
                                     m1=m1_new), denom

    if cfg.use_kernels:
        u_hat = ops.lowrank_update(q32, u32, g32, cfg.b2, cfg.eps)
    else:
        u_hat = g32 / (torch.sqrt(vmat) + cfg.eps)
    denom = torch.clamp_min(_rms(u_hat) / cfg.clip_d, 1.0)
    u_hat = u_hat / _bc(denom)
    if cfg.b1 > 0:
        m1_acc = cfg.b1 * m1 + (1.0 - cfg.b1) * u_hat
        m_out = m1_acc
        if cfg.guidance != "off":
            dims = (-2, -1)
            num = torch.sum(u_hat * m1_acc, dim=dims)
            den = (torch.sqrt(torch.sum(u_hat ** 2, dim=dims))
                   * torch.sqrt(torch.sum(m1_acc ** 2, dim=dims)))
            theta = num / (den + 1e-30)
            gscale = _bc(torch.clamp(1.0 / (1.0 - theta + cfg.eps), 0.0,
                                     cfg.guidance_max_scale))
            if cfg.guidance == "stored":
                m1_acc = m1_acc * gscale          # Eq. (18) literally
                m_out = m1_acc
            else:                                 # "update": step only
                m_out = m1_acc * gscale
        m1_new = m1_acc
    else:
        m_out, m1_new = u_hat, None
    return (m_out, F.FactoredLeaf(q=q_new, u=u_new, k=k_new, xi=xi,
                                  m1=m1_new), denom)


def _r_store(leaf: F.FactoredLeaf) -> int:
    return (leaf.q.q8 if isinstance(leaf.q, QZ.QuantizedMatrix)
            else leaf.q).shape[-1]


def _update_factored(g, leaf: F.FactoredLeaf, shape: tuple, step: int,
                     sketch: Optional[S.SketchSource], cfg: AdapproxConfig,
                     refresh_t: int, force_refresh: bool = False):
    """A factored leaf's step around :func:`_factored_update`: int8 factors
    are dequantized first unless the fused pass 1 takes them as they are;
    they are requantized after the step, on fold steps too.  ``shape`` is the
    parameter's, or a bucket's stacked shape.  Returns ``(m_out,
    new_leaf, denom)``, the new factors fp32: the caller requantizes int8
    ones (:func:`_requant`), per leaf of a bucket."""
    int8 = cfg.factor_dtype == "int8"
    if int8 and not cfg.fused_update:
        leaf = dataclasses.replace(leaf, q=QZ.dequantize(leaf.q),
                                   u=QZ.dequantize(leaf.u))
    r_store = _r_store(leaf)
    p_eff, k_max_leaf = _leaf_meta(shape, r_store, cfg)
    return _factored_update(g, leaf, step, sketch, cfg, r_store, p_eff,
                            k_max_leaf, refresh_t, force_refresh)


def _requant(nl: F.FactoredLeaf, cfg: AdapproxConfig) -> F.FactoredLeaf:
    if cfg.factor_dtype != "int8":
        return nl
    q, u = QZ.quantize_tree_factors(nl.q, nl.u)
    return dataclasses.replace(nl, q=q, u=u)


def _stack(xs: list):
    """Stack same-shaped leaf fields along a new leading axis (int8
    factors field by field); None stays None."""
    if xs[0] is None:
        return None
    if isinstance(xs[0], QZ.QuantizedMatrix):
        return QZ.QuantizedMatrix(*(torch.stack(f) for f in zip(*xs)))
    return torch.stack(xs)


def _update_bucket(gs: list, leaves: list, shape: tuple, step: int,
                   draws: Optional[list], cfg: AdapproxConfig,
                   refresh_t: int) -> list:
    """One stacked step for a bucket of same-signature factored leaves:
    their gradients, state and (on refresh steps) their sketches, each
    drawn from its own leaf's generator, stack along a new leading axis,
    so every slice sees the per-leaf arithmetic, batched.  Returns
    ``[(m_out, new_leaf, denom)]`` in the bucket's order."""
    stacked = F.FactoredLeaf(
        **{f.name: _stack([getattr(leaf, f.name) for leaf in leaves])
           for f in dataclasses.fields(F.FactoredLeaf)})
    sketch = None if draws is None else _drawn(torch.stack(draws))
    m_out, nl, denom = _update_factored(torch.stack(gs), stacked,
                                        (len(leaves),) + tuple(shape), step,
                                        sketch, cfg, refresh_t)
    return [(m_out[j], _requant(F.FactoredLeaf(
        q=nl.q[j], u=nl.u[j], k=nl.k[j], xi=nl.xi[j],
        m1=None if nl.m1 is None else nl.m1[j]), cfg), denom[j])
        for j in range(len(leaves))]


def _update_demoted(g, leaf: F.FactoredLeaf, dense_v: torch.Tensor,
                    cfg: AdapproxConfig):
    """A demoted factored leaf's step: the exact dense second moment on
    its shadow buffer, with the factored path's per-matrix RMS clip (over
    the trailing two axes), guidance off, the factors and k frozen and xi
    pinned to 0, in plain tensor code on every device (the JAX package's
    dense branch is jnp too).  Returns ``(m_out, new_leaf, dense_v,
    denom)``."""
    g32 = g.float()
    v = cfg.b2 * dense_v + (1.0 - cfg.b2) * torch.square(g32)
    u_hat = g32 / (torch.sqrt(v) + cfg.eps)
    rms = torch.sqrt(torch.mean(torch.square(u_hat), dim=(-2, -1)) + 1e-30)
    denom = torch.clamp_min(rms / cfg.clip_d, 1.0)
    u_hat = u_hat / _bc(denom)
    if leaf.m1 is not None:
        m1 = cfg.b1 * leaf.m1 + (1.0 - cfg.b1) * u_hat
        m_out = m1
    else:
        m1, m_out = None, u_hat
    return m_out, dataclasses.replace(leaf, xi=torch.zeros_like(leaf.xi),
                                      m1=m1), v, denom


def _seed_dense_v(leaf: F.FactoredLeaf) -> torch.Tensor:
    """A newly demoted leaf's shadow buffer, ``max(Q U^T, 0)`` of its
    just-refreshed factors (the reconstruction can go epsilon-negative)."""
    q, u = leaf.q, leaf.u
    if isinstance(q, QZ.QuantizedMatrix):
        q, u = QZ.dequantize(q), QZ.dequantize(u)
    return torch.clamp_min(q @ u.transpose(-1, -2), 0.0)


def settle_guards(state: AdapproxState, xi_max: np.ndarray) -> None:
    """Advance a guarded step's :class:`GuardState` in place from its
    worst xi per factored leaf (``state.pending``, read to the host as
    ``xi_max``) and clear ``pending``: the counters by
    ``guards.advance_counters``; a leaf demoted now gets its shadow buffer
    seeded from its new factors, the others keep their step's buffers."""
    gcfg, gstate = state.pending.cfg, state.guards
    counters, newly = advance_counters(gstate, gcfg, xi_max)
    dense_v = gstate.dense_v
    if gcfg.max_demotions > 0:
        fact = [leaf for leaf in state.leaves
                if isinstance(leaf, F.FactoredLeaf)]
        dense_v = tuple(_seed_dense_v(leaf) if new else dv
                        for leaf, new, dv in zip(fact, newly, dense_v))
    state.guards = GuardState(**counters, dense_v=tuple(dense_v))
    state.pending = None


def _update_dense(g, leaf: F.DenseLeaf, cfg: AdapproxConfig):
    """A dense leaf's step; returns ``(m_out, new_leaf, denom)``."""
    g32 = g.float()
    v = cfg.b2 * leaf.v + (1.0 - cfg.b2) * torch.square(g32)
    u_hat = g32 / (torch.sqrt(v) + cfg.eps)
    if cfg.fused_update:
        # Same pass 2 as the factored leaves (no guidance): the leaf is
        # viewed as one (1, size) row.
        denom, out_scale, store_scale = _fused_scalars(
            torch.sum(torch.square(u_hat)), None, None, u_hat.numel(), cfg,
            guidance=False)
        m1 = None if leaf.m1 is None else leaf.m1.reshape(1, -1)
        m_out, m1_new = ops.fused_apply(
            u_hat.reshape(1, -1), m1, denom, cfg.b1, out_scale, store_scale,
            shared_out=True, in_place=cfg.guards is None)
        return (m_out.reshape(u_hat.shape),
                F.DenseLeaf(v=v, m1=None if m1_new is None
                            else m1_new.reshape(u_hat.shape)), denom)
    denom = torch.clamp_min(
        torch.sqrt(torch.sum(torch.square(u_hat)) / u_hat.numel() + 1e-30)
        / cfg.clip_d, 1.0)
    u_hat = u_hat / denom
    if leaf.m1 is not None:
        m1 = cfg.b1 * leaf.m1 + (1.0 - cfg.b1) * u_hat
        return m1, F.DenseLeaf(v=v, m1=m1), denom
    return u_hat, F.DenseLeaf(v=v, m1=None), denom


# ---------------------------------------------------------------------------
# Telemetry (cfg.telemetry; repro_torch.telemetry.snapshot)
# ---------------------------------------------------------------------------

def _assemble_snapshot(prev: TelemetrySnapshot, step: int, new_leaves,
                       denoms, k_max: dict, refresh_t: int,
                       did_refresh: bool) -> TelemetrySnapshot:
    """This step's snapshot, as the JAX package's ``_assemble_snapshot``:
    per factored leaf the mean of its xi, of ``min(k, k_max)`` and of that
    over k_max; per leaf the fraction of its matrices whose clip
    denominator exceeded 1; the counters from the host's refresh decision
    (the cadence's, not a refresh the xi watchdog forces).  Only means of
    per-matrix values the update already holds run on the device."""
    xi, k, k_frac = [], [], []
    for i, leaf in enumerate(new_leaves):
        if i not in k_max:
            continue
        kf = torch.clamp_max(leaf.k, k_max[i]).float()
        xi.append(torch.mean(leaf.xi.float()))
        k.append(torch.mean(kf))
        k_frac.append(torch.mean(kf / k_max[i]))
    clip = [torch.mean((d > 1.0).float()) for d in denoms]
    stack = lambda xs: (torch.stack(xs) if xs else
                        torch.zeros((0,), dtype=torch.float32,
                                    device=prev.clip_rate.device))
    did = 1.0 if did_refresh else 0.0
    return TelemetrySnapshot(
        step=step, xi=stack(xi), k=stack(k), k_frac=stack(k_frac),
        clip_rate=stack(clip), did_refresh=did,
        refresh_steps=prev.refresh_steps + int(did),
        fold_steps=prev.fold_steps + 1 - int(did), refresh_every=refresh_t,
        leaf_indices=prev.leaf_indices, dense_indices=prev.dense_indices)


# ---------------------------------------------------------------------------
# Public factories
# ---------------------------------------------------------------------------

def scale_by_adapprox(cfg: AdapproxConfig) -> GradientTransformation:
    """The Adapprox preconditioner: gradients -> update direction.  Owns
    the factored / dense second moment, the update-EMA first moment,
    per-matrix RMS clipping and cosine guidance; learning rate, weight
    decay and the descent sign are later stages (see :func:`adapprox`).
    With ``cfg.guards`` it runs inside ``resilience.guards.guard_updates``,
    which settles each step's ``pending`` xi; a pending state given back
    raises."""
    _check_config(cfg)

    def init(params):
        leaves = tuple(_init_leaf(p, cfg) for p in params.values())
        fidx = tuple(i for i, leaf in enumerate(leaves)
                     if isinstance(leaf, F.FactoredLeaf))
        device = next(iter(params.values())).device if params else "cpu"
        tel = None
        if cfg.telemetry:
            tel = init_snapshot(
                len(fidx), len(leaves), cfg.refresh_every, leaf_indices=fidx,
                dense_indices=tuple(i for i in range(len(leaves))
                                    if i not in fidx), device=device)
        gstate = None
        if cfg.guards is not None:
            fact = [p for p, leaf in zip(params.values(), leaves)
                    if isinstance(leaf, F.FactoredLeaf)]
            gstate = init_guard_state(
                [tuple(p.shape) for p in fact], cfg.guards.max_demotions,
                fact[0].device if fact else "cpu")
        return AdapproxState(
            step=0, leaves=leaves, telemetry=tel,
            refresh_every=cfg.refresh_every if cfg.dynamic_refresh else None,
            guards=gstate, seed=cfg.seed)

    def update(grads, state: AdapproxState, params):
        if state.pending is not None:
            raise ValueError(
                "AdapproxState with unsettled guard counters: an Adapprox "
                "with AdapproxConfig.guards runs inside guards.guard_updates")
        step = state.step + 1              # paper counts from t = 1
        names = list(params)
        shapes = [tuple(w.shape) for w in params.values()]
        fact = [i for i, leaf in enumerate(state.leaves)
                if isinstance(leaf, F.FactoredLeaf)]
        ordinal = {i: j for j, i in enumerate(fact)}
        gcfg, gstate = cfg.guards, state.guards
        # the cadence in effect: the state's under dynamic_refresh
        refresh_t = (state.refresh_every if cfg.dynamic_refresh
                     and state.refresh_every is not None
                     else cfg.refresh_every)
        cadence = refresh_t <= 1 or _refresh_pred(step, refresh_t)
        # the xi watchdog's decisions for this step, from the host counters
        force = demoted = [0] * len(fact)
        dense_v = None
        if gcfg is not None:
            force = gstate.force_refresh.tolist()
            if gstate.dense_v:          # demotion needs its shadow buffers
                demoted = gstate.demoted.tolist()
                dense_v = list(gstate.dense_v)
        draws = {}
        for i in fact:
            j = ordinal[i]
            if demoted[j] or not (cadence or force[j]):
                continue
            g, leaf = grads[names[i]], state.leaves[i]
            r = _r_store(leaf)
            p_eff, _ = _leaf_meta(shapes[i], r, cfg)
            draw = (cfg.sketch or S.torch_normal(g.device))(
                F.batch_dims(shapes[i]) + (shapes[i][-1], r + p_eff),
                _sketch_generator(cfg.seed, step, i, g.device))
            draws[i] = draw.to(device=g.device, dtype=torch.float32)
        outs, new_leaves = [None] * len(names), [None] * len(names)
        denoms = [None] * len(names)     # each leaf's clip denominator
        buckets: dict = {}
        for i, leaf in enumerate(state.leaves):
            g = grads[names[i]]
            if not isinstance(leaf, F.FactoredLeaf):
                outs[i], new_leaves[i], denoms[i] = _update_dense(g, leaf,
                                                                  cfg)
            elif cfg.bucketed and gcfg is None:
                buckets.setdefault(F.leaf_signature(shapes[i], g.dtype),
                                   []).append(i)
            else:
                buckets[i] = [i]
        for idxs in buckets.values():
            if len(idxs) == 1:
                i = idxs[0]
                j = ordinal[i]
                if demoted[j]:
                    (outs[i], new_leaves[i], dense_v[j],
                     denoms[i]) = _update_demoted(
                        grads[names[i]], state.leaves[i], dense_v[j], cfg)
                    continue
                sketch = _drawn(draws[i]) if i in draws else None
                m_out, nl, denoms[i] = _update_factored(
                    grads[names[i]], state.leaves[i], shapes[i], step,
                    sketch, cfg, refresh_t, force_refresh=force[j] > 0)
                outs[i], new_leaves[i] = m_out, _requant(nl, cfg)
                continue
            res = _update_bucket(
                [grads[names[i]] for i in idxs],
                [state.leaves[i] for i in idxs], shapes[idxs[0]], step,
                [draws[i] for i in idxs] if draws else None, cfg, refresh_t)
            for i, (m_out, nl, denom) in zip(idxs, res):
                outs[i], new_leaves[i], denoms[i] = m_out, nl, denom
        tel = None
        if cfg.telemetry:
            k_max = {i: _leaf_meta(shapes[i], _r_store(state.leaves[i]),
                                   cfg)[1] for i in fact}
            tel = _assemble_snapshot(state.telemetry, step, new_leaves,
                                     denoms, k_max, refresh_t, cadence)
        new_state = AdapproxState(step=step, leaves=tuple(new_leaves),
                                  telemetry=tel,
                                  refresh_every=state.refresh_every,
                                  guards=gstate, seed=cfg.seed)
        if gcfg is not None and fact:
            if dense_v is not None:       # the demoted leaves' new buffers
                new_state.guards = dataclasses.replace(
                    gstate, dense_v=tuple(dense_v))
            new_state.pending = PendingGuards(torch.stack([
                new_leaves[i].xi.float().amax() for i in fact]), gcfg)
        return dict(zip(names, outs)), new_state

    return GradientTransformation(init, update, _state_spec)


def _factored_leaf_spec(leaf: F.FactoredLeaf, pspec: P) -> F.FactoredLeaf:
    """Param (..., m, n) with spec (..., a, b): q (..., m, r) -> (..., a,
    None), u (..., n, r) -> (..., b, None), k and xi the batch part, m1
    the param's spec; the factors of a split matrix split along the same
    axes as the matrix.  An int8 factor's scale and zero take its spec."""
    parts = list(pspec)
    bd, a, b = parts[:-2], parts[-2], parts[-1]

    def factor(x, spec):
        if isinstance(x, QZ.QuantizedMatrix):
            return QZ.QuantizedMatrix(spec, spec, spec)
        return spec

    return F.FactoredLeaf(
        q=factor(leaf.q, P(*bd, a, None)), u=factor(leaf.u, P(*bd, b, None)),
        k=P(*bd), xi=P(*bd), m1=P(*parts) if leaf.m1 is not None else None)


def _state_spec(state: AdapproxState, param_specs: dict) -> AdapproxState:
    """The JAX package's ``_state_spec``: per-leaf specs from the param
    specs; the telemetry snapshot, the dynamic cadence and the guard
    counters replicated; the guards' dense shadow buffers split like the
    factored params they mirror."""
    specs = list(param_specs.values())
    leaves = []
    for pspec, leaf in zip(specs, state.leaves):
        if isinstance(leaf, F.FactoredLeaf):
            leaves.append(_factored_leaf_spec(leaf, pspec))
        else:
            leaves.append(F.DenseLeaf(
                v=pspec, m1=pspec if leaf.m1 is not None else None))
    guards = None
    if state.guards is not None:
        guards = guard_spec(state.guards, [
            s for s, leaf in zip(specs, state.leaves)
            if isinstance(leaf, F.FactoredLeaf)])
    return AdapproxState(
        step=P(), leaves=tuple(leaves),
        telemetry=snapshot_spec(state.telemetry),
        refresh_every=P() if state.refresh_every is not None else None,
        guards=guards, seed=state.seed)


def adapprox(cfg: AdapproxConfig,
             decay_mask: Optional[Callable] = None) -> GradientTransformation:
    """Algorithm 3 as a chain: preconditioner -> + wd*W -> * lr_t -> * (-1)."""
    return chain(
        scale_by_adapprox(cfg),
        add_decayed_weights(cfg.weight_decay, decay_mask),
        scale_by_schedule(cfg.lr),
        scale(-1.0),
    )


def adapprox_state(state) -> AdapproxState:
    """The ``AdapproxState`` inside a chain or partition state."""
    for sub in find_states(state, AdapproxState):
        return sub
    raise ValueError("no AdapproxState found in optimizer state")
