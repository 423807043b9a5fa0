"""Numerical health guards with graceful degradation: the port of the JAX
package's ``resilience/guards.py``.

Two levels, as there:

  * :func:`guard_updates`, the chain-level **skip-step** wrapper.  It
    checks every gradient leaf and every final update leaf for non-finite
    values; on a trip the updates are zeros and the whole inner optimizer
    state reverts, so the parameters and every EMA (weight decay
    included: the wrapper sits outside the chain) are exactly what they
    were before the poisoned step.  Only the :class:`GuardedState`
    counters advance.
  * ``scale_by_adapprox``'s xi guard, driven by :class:`GuardState`
    (``AdapproxState.guards`` when ``AdapproxConfig.guards`` is set): a
    factored leaf whose approximation error xi exceeds ``xi_trip`` gets a
    forced full S-RSI refresh on the next step, off the fold cadence, and
    after ``max_demotions`` consecutive trips it runs the exact dense
    second moment from then on, seeded from ``max(Q U^T, 0)``.

How an eager port keeps the JAX semantics.  JAX decides inside the jitted
step with ``jnp.where`` on immutable arrays; here the decisions are Python
branches, and two things differ:

  * **State identity.**  Parameters are updated in place, and pass 2 of
    the fused update writes the new first moment over ``m1`` on the card
    (``kernels/ops.py``).  Reverting to the old state object would then
    revert to a NaN ``m1``.  So a guarded Adapprox (``AdapproxConfig.
    guards``, which ``build_optimizer`` sets with the wrapper) has pass 2
    write a fresh buffer (the same bytes; the old and new ``m1`` are both
    resident until the step is decided), and no stage writes into the
    state it was given.  The parameters move only after the wrapper has
    decided, by ``apply_updates`` of its zeros.
  * **Host reads.**  The decisions need host values: the all-finite flag
    here, each factored leaf's worst xi for the watchdog.  The counters of
    :class:`GuardState` live on the host (CPU int32 tensors, the JAX
    leaves' shapes and dtypes), and every value a decision needs is read
    in one device-to-host transfer a step: a guarded Adapprox stage leaves
    its xi on its new state (``pending``), and the wrapper reads it with
    the all-finite flag and advances the counters
    (``core.adapprox.settle_guards``) before it returns.  The telemetry
    snapshots' device vectors (``telemetry.snapshot``) ride the same
    transfer, so telemetry under the guards adds none.  So the two
    halves go together: the wrapper refuses an unguarded Adapprox, and a
    guarded one refuses a state that no wrapper settled.

Semantics kept exactly: updates are zeroed on a trip; the inner state
reverts, its step counters (which seed the ``(seed, t, i)`` sketch draws)
included; only ``steps``, ``skipped`` and ``last_skip`` advance; a healthy
step is a bitwise no-op, so a guards-on run equals a guards-off run.  The
guard catches non-finite values, never an exception from a kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.types import (GradientTransformation, P, find_states,
                                    state_sharding_spec)


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Numerical-guard policy of the xi watchdog.

    xi_trip: per-leaf xi threshold; above it the leaf's factorization is
        considered blown and a full S-RSI refresh is forced next step.
    max_demotions: consecutive xi trips before the leaf is demoted to the
        exact dense second moment.  0 disables demotion (and the dense
        shadow buffers it needs); forced refreshes still apply.
    """

    xi_trip: float = 0.75
    max_demotions: int = 0


@dataclasses.dataclass
class GuardState:
    """Per-factored-leaf degradation state of one Adapprox instance.

    trips:         (n_factored,) int32, consecutive xi trips per leaf.
    force_refresh: (n_factored,) int32, 1 when the leaf's next step must
                   run a full S-RSI refresh whatever the cadence.
    demoted:       (n_factored,) int32, 1 once the leaf runs the exact
                   dense second moment (for the rest of the run).
    trip_total:    () int32, cumulative trips.
    demotions:     () int32, cumulative demotions.
    dense_v:       one param-shaped fp32 dense second moment per factored
                   leaf, on the parameters' device, only when
                   ``max_demotions > 0`` (else empty).

    The counters are CPU tensors: the Python branches read them without a
    device round trip.
    """

    trips: torch.Tensor
    force_refresh: torch.Tensor
    demoted: torch.Tensor
    trip_total: torch.Tensor
    demotions: torch.Tensor
    dense_v: tuple = ()


def _counter(values) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.int32))


def init_guard_state(factored_shapes, max_demotions: int,
                     device: "str | torch.device" = "cpu") -> GuardState:
    """Fresh guard state for ``len(factored_shapes)`` factored leaves; the
    dense shadow buffers go on ``device``."""
    n = len(factored_shapes)
    dense_v = ()
    if max_demotions > 0:
        dense_v = tuple(torch.zeros(tuple(s), dtype=torch.float32,
                                    device=device) for s in factored_shapes)
    return GuardState(trips=_counter([0] * n),
                      force_refresh=_counter([0] * n),
                      demoted=_counter([0] * n), trip_total=_counter(0),
                      demotions=_counter(0), dense_v=dense_v)


def guard_spec(gstate: GuardState, factored_pspecs) -> GuardState:
    """Sharding spec of a ``GuardState``: the counters replicated, each
    dense shadow buffer split like the factored parameter it mirrors
    (``factored_pspecs``, in factored-leaf order), as in the JAX
    package."""
    return GuardState(trips=P(), force_refresh=P(), demoted=P(),
                      trip_total=P(), demotions=P(),
                      dense_v=tuple(factored_pspecs[:len(gstate.dense_v)]))


def advance_counters(gstate: GuardState, gcfg: GuardConfig,
                     xi_max: np.ndarray):
    """The counter half of the JAX package's ``_advance_guard_state`` on
    the host.  ``xi_max``: each factored leaf's worst xi over its batch
    slices this step, float32.  A leaf trips when it exceeds ``xi_trip``
    and is not demoted; trips are consecutive (a calm step resets them); a
    trip forces a refresh next step, unless it is the ``max_demotions``-th,
    which demotes the leaf instead.  Returns ``(counters, newly)``: the
    new state's fields but ``dense_v``, and the mask of leaves demoted
    now, whose shadow buffers the caller seeds."""
    xi = np.asarray(xi_max, np.float32)
    already = gstate.demoted.numpy() > 0
    tripped = (xi > np.float32(gcfg.xi_trip)) & ~already
    trips = np.where(tripped, gstate.trips.numpy() + 1, 0)
    newly = np.zeros_like(tripped)
    demoted = gstate.demoted.numpy()
    demotions = int(gstate.demotions)
    if gcfg.max_demotions > 0:
        newly = ~already & (trips >= gcfg.max_demotions)
        demoted = np.maximum(demoted, newly.astype(np.int32))
        force = tripped & ~newly
        demotions += int(newly.sum())
    else:
        force = tripped
    return dict(trips=_counter(trips), force_refresh=_counter(force),
                demoted=_counter(demoted),
                trip_total=_counter(int(gstate.trip_total)
                                    + int(tripped.sum())),
                demotions=_counter(demotions)), newly


@dataclasses.dataclass
class GuardedState:
    """State of :func:`guard_updates`.

    inner:     the wrapped transformation's state (reverted wholesale on a
               skipped step).
    steps:     steps the guard has seen (the inner step counters do not
               advance on skips).
    skipped:   cumulative skipped steps.
    last_skip: ``steps`` at the most recent skip (0 = never).
    """

    inner: Any
    steps: int
    skipped: int
    last_skip: int


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def tree_all_finite(tree) -> torch.Tensor:
    """Scalar bool tensor, on the device of the tree's first floating
    leaf: every floating leaf is entirely finite.  Integer leaves are
    finite by definition; an empty tree is finite.  Nothing is read back
    to the host."""
    checks = [torch.isfinite(x).all() for x in _tensors(tree)
              if x.is_floating_point()]
    if not checks:
        return torch.tensor(True)
    dev = checks[0].device
    return torch.stack([c.to(dev) for c in checks]).all()


def guard_updates(inner: GradientTransformation) -> GradientTransformation:
    """Wrap a whole optimizer chain (or partition) in the non-finite
    skip-step guard.  On a healthy step it passes the inner updates and
    state through unchanged, its Adapprox stages' watchdog counters
    advanced; on a tripped step the updates are zeros (so
    ``apply_updates`` leaves the parameters as they were) and the inner
    state is the pre-step one, untouched (see the module docstring).
    Unlike the JAX package's it takes no ``GuardConfig``: the skip-step
    guard has no setting, and each Adapprox stage keeps its watchdog's.
    It forwards the ``state_sharding_spec`` protocol, its own counters
    replicated."""
    from repro_torch.core.adapprox import AdapproxState, settle_guards
    from repro_torch.telemetry import collect
    from repro_torch.telemetry import snapshot as SN

    def init(params):
        istate = inner.init(params)
        if any(s.guards is None for s in find_states(istate, AdapproxState)):
            raise ValueError(
                "guard_updates: an Adapprox stage without AdapproxConfig."
                "guards writes m1 in place on the card, which a skipped "
                "step could not revert")
        return GuardedState(inner=istate, steps=0, skipped=0, last_skip=0)

    def update(grads, state: GuardedState, params):
        steps = state.steps + 1
        upd, new_inner = inner.update(grads, state.inner, params)
        pending = [s for s in find_states(new_inner, AdapproxState)
                   if s.pending is not None]
        snaps = SN.pending(
            list(collect.named_snapshots(new_inner).values())
            + list(collect.named_sketch_snapshots(new_inner).values()))
        tel = SN.packed(snaps)
        finite = torch.logical_and(tree_all_finite(grads),
                                   tree_all_finite(upd))
        # one device-to-host transfer: the flag, each stage's xi, then
        # the telemetry snapshots' vectors
        dev = pending[0].pending.xi_max.device if pending else finite.device
        host = torch.cat([finite.reshape(1).float().to(dev)] + [
            s.pending.xi_max.float() for s in pending]
            + ([] if tel is None else [tel.to(dev)])).cpu().numpy()
        n_xi = 1 + sum(s.pending.xi_max.numel() for s in pending)
        SN.set_host(snaps, host[n_xi:])
        if not host[0]:
            zeros = {k: torch.zeros_like(u) for k, u in upd.items()}
            return zeros, GuardedState(inner=state.inner, steps=steps,
                                       skipped=state.skipped + 1,
                                       last_skip=steps)
        off = 1
        for s in pending:
            n = s.pending.xi_max.numel()
            settle_guards(s, host[off:off + n])
            off += n
        return upd, GuardedState(inner=new_inner, steps=steps,
                                 skipped=state.skipped,
                                 last_skip=state.last_skip)

    def spec(state: GuardedState, param_specs: dict):
        return GuardedState(
            inner=state_sharding_spec(inner, state.inner, param_specs),
            steps=P(), skipped=P(), last_skip=P())

    return GradientTransformation(init, update, spec)
