"""Walk optimizer states for telemetry: the port of the JAX package's
``telemetry/collect.py``.  Finds every Adapprox and sketch instance
(chains, ``partition`` groups, the skip-step guard, any nesting), names it
by its parameter group, reads its snapshot, and gets or sets its dynamic
refresh cadence.

Group naming is JAX's: states inside a ``partition`` are named by their
group label (the ``PartitionState.inner`` dict key, e.g. ``"factored"`` in
the launcher's mixed groups); a bare chain's single instance is
``"default"``.  The walk is that of ``core.types.find_states``: chains are
tuples, partitions and the guard carry their inner states in ``inner``.
The ``core`` and ``resilience`` imports are deferred to call time, as in
JAX, because ``core`` imports the snapshot module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch


def _adapprox_cls():
    from repro_torch.core.adapprox import AdapproxState
    return AdapproxState


def _sketch_cls():
    from repro_torch.core.sketch import SketchState
    return SketchState


def _guarded_cls():
    from repro_torch.resilience.guards import GuardedState
    return GuardedState


def _named(state, cls, name: str = "default"):
    """Yield ``(group name, instance)`` for every ``cls`` inside ``state``
    in ``find_states`` order; the name is the last string dict key on the
    way down."""
    if isinstance(state, cls):
        yield name, state
    elif isinstance(state, (tuple, list)):
        for s in state:
            yield from _named(s, cls, name)
    elif isinstance(state, dict):
        for key, s in state.items():
            yield from _named(s, cls, key if isinstance(key, str) else name)
    elif hasattr(state, "inner"):
        yield from _named(state.inner, cls, name)


def _rebuild(state, cls, fn: Callable, name: str = "default"):
    """``state`` with every ``cls`` instance replaced by ``fn(name,
    instance)``, the containers on the way rebuilt, everything else
    shared."""
    if isinstance(state, cls):
        return fn(name, state)
    if isinstance(state, list):
        return [_rebuild(s, cls, fn, name) for s in state]
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return tuple(_rebuild(s, cls, fn, name) for s in state)
    if isinstance(state, dict):
        return {key: _rebuild(s, cls, fn,
                              key if isinstance(key, str) else name)
                for key, s in state.items()}
    if hasattr(state, "inner") and dataclasses.is_dataclass(state):
        return dataclasses.replace(state,
                                   inner=_rebuild(state.inner, cls, fn, name))
    return state


def named_states(opt_state) -> "dict[str, Any]":
    """``{group_name: AdapproxState}`` for every Adapprox instance inside
    an (arbitrarily nested) optimizer state."""
    return dict(_named(opt_state, _adapprox_cls()))


def named_snapshots(opt_state) -> "dict[str, Any]":
    """``{group_name: TelemetrySnapshot}`` for every Adapprox instance
    that carries one (``cfg.telemetry``); empty when telemetry is off
    everywhere.  Sketch instances have their own walker
    (:func:`named_sketch_snapshots`): their snapshot schema differs."""
    return {name: st.telemetry for name, st in named_states(opt_state).items()
            if st.telemetry is not None}


def named_sketch_states(opt_state) -> "dict[str, Any]":
    """``{group_name: SketchState}`` for every ``scale_by_sketch``
    instance inside an (arbitrarily nested) optimizer state."""
    return dict(_named(opt_state, _sketch_cls()))


def named_sketch_snapshots(opt_state) -> "dict[str, Any]":
    """``{group_name: SketchSnapshot}`` for every sketch instance that
    carries one (``cfg.telemetry``); empty when telemetry is off."""
    return {name: st.telemetry
            for name, st in named_sketch_states(opt_state).items()
            if st.telemetry is not None}


def named_guard_states(opt_state) -> "dict[str, Any]":
    """``{group_name: GuardState}`` for every Adapprox instance carrying
    xi-watchdog state (``AdapproxConfig.guards``); empty when guards are
    off everywhere."""
    return {name: st.guards for name, st in named_states(opt_state).items()
            if st.guards is not None}


def chain_guard_state(opt_state):
    """The outermost :class:`~repro_torch.resilience.guards.GuardedState`
    (the chain-level skip-step wrapper) inside ``opt_state``, or ``None``
    when the chain is unguarded."""
    for _, gs in _named(opt_state, _guarded_cls()):
        return gs
    return None


def get_refresh_every(opt_state) -> "dict[str, Optional[int]]":
    """The refresh cadence per group; ``None`` for groups whose cadence is
    the config's constant (``dynamic_refresh`` off)."""
    return {name: (int(st.refresh_every) if st.refresh_every is not None
                   else None)
            for name, st in named_states(opt_state).items()}


def set_refresh_every(opt_state, changes: "dict[str, int] | int"):
    """Return a copy of ``opt_state`` with the dynamic refresh cadence of
    the named groups replaced (an int applies to every dynamic group).
    The cadence is a host int on the state, read by the next step's
    refresh-or-fold decision.  Groups without a dynamic cadence
    (``dynamic_refresh`` off) raise ``ValueError`` when named
    explicitly."""
    if not isinstance(changes, dict):
        changes = {name: int(changes)
                   for name, st in named_states(opt_state).items()
                   if st.refresh_every is not None}
    applied = set()

    def one(name, leaf):
        if name not in changes:
            return leaf
        if leaf.refresh_every is None:
            raise ValueError(
                f"group {name!r} has no dynamic refresh cadence; build it "
                f"with dynamic_refresh=True to control it at runtime")
        value = int(changes[name])
        if value < 1:
            raise ValueError(f"refresh_every must be >= 1, got {value}")
        applied.add(name)
        return dataclasses.replace(leaf, refresh_every=value)

    out = _rebuild(opt_state, _adapprox_cls(), one)
    missing = set(changes) - applied
    if missing:
        raise ValueError(f"no Adapprox group named {sorted(missing)}; "
                         f"known: {sorted(named_states(opt_state))}")
    return out


def _mean_max(snap, name: str):
    """``(mean, max)`` of a snapshot vector: Python floats from its host
    copy when it has one, else 0-d tensors on its device (no transfer)."""
    if snap.on_host:
        v = snap.host(name)
        return float(np.mean(v)), float(np.max(v))
    v = getattr(snap, name)
    return torch.mean(v), torch.amax(v)


def telemetry_metrics(opt_state) -> dict:
    """Scalar per-group aggregates of every snapshot in ``opt_state``,
    which ``train/steps.py`` merges into the step metrics (empty when
    telemetry is off).  The counters and the cadence are the host's
    numbers; the means of the device vectors come from the snapshot's host
    copy when the guards' transfer has given it one, else they are 0-d
    device tensors, which the train loop reads with the loss."""
    out = {}
    for name, snap in named_snapshots(opt_state).items():
        pre = f"telemetry/{name}/"
        if snap.xi.shape[0] > 0:
            out[pre + "mean_xi"], out[pre + "max_xi"] = _mean_max(snap, "xi")
            out[pre + "mean_k"] = _mean_max(snap, "k")[0]
            out[pre + "mean_k_frac"] = _mean_max(snap, "k_frac")[0]
        out[pre + "clip_rate"] = _mean_max(snap, "clip_rate")[0]
        out[pre + "refresh_every"] = snap.refresh_every
        out[pre + "did_refresh"] = snap.did_refresh
    for name, snap in named_sketch_snapshots(opt_state).items():
        pre = f"telemetry/{name}/"
        if snap.occupancy.shape[0] > 0:
            (out[pre + "mean_occupancy"],
             out[pre + "max_occupancy"]) = _mean_max(snap, "occupancy")
            out[pre + "mean_overestimate"] = _mean_max(snap,
                                                       "overestimate")[0]
    gs = chain_guard_state(opt_state)
    if gs is not None:
        out["guard/skipped"] = gs.skipped
        out["guard/last_skip"] = gs.last_skip
    for name, g in named_guard_states(opt_state).items():
        pre = f"guard/{name}/"
        out[pre + "trip_total"] = int(g.trip_total)
        out[pre + "demotions"] = int(g.demotions)
    return out
