"""``TelemetryRuntime``: the train loop's one telemetry handle, the port of
the JAX package's ``telemetry/runtime.py``.

Owns the JSONL sink and the closed-loop refresh controller, and runs the
host side of the subsystem once a step:

    state, metrics = step_fn(state, batch)      # the snapshot rides inside
    torch.cuda.synchronize()
    state = runtime.on_step(step, state)        # read -> emit -> control

``on_step`` reads the snapshots' device vectors to the host, emits one
``optimizer`` (and ``sketch``) event per group every ``emit_every``
steps, feeds the controller and, when it moves a group's cadence, returns
the state with the new cadence (:func:`collect.set_refresh_every`), which
the next step's refresh-or-fold decision reads.

Host transfers.  Telemetry and the guards together make at most one
device-to-host copy a step.  Under the guards the skip-step wrapper's one
transfer has already brought the snapshots' vectors over with its
all-finite flag, and the runtime makes none; otherwise it makes one
``.cpu()`` of one packed vector of every snapshot
(``snapshot.fetch_host``); and it makes none on a step where nothing
reads the vectors (no controller, and not an ``emit_every`` step).  The
counters, the cadence and the guards' fault counters are host numbers.

Checkpoints: :meth:`manifest_meta` returns the controller state and the
cadences for the checkpoint manifest, in the JAX package's layout, and
:meth:`restore_meta` reloads them, so a run killed and restored
reproduces the same cadence changes (the cadence itself is optimizer
state and restores with it).  :meth:`flush` rides the preemption path.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

from repro_torch.config import TelemetryConfig
from repro_torch.telemetry import collect
from repro_torch.telemetry.controller import ControllerConfig, RefreshController
from repro_torch.telemetry.sink import SinkConfig, TelemetrySink
from repro_torch.telemetry.snapshot import fetch_host

log = logging.getLogger(__name__)


def _controller_cfg(cfg: TelemetryConfig) -> ControllerConfig:
    return ControllerConfig(
        interval=cfg.interval, t_min=cfg.t_min, t_max=cfg.t_max,
        xi_high=cfg.xi_high, xi_low=cfg.xi_low,
        relax_patience=cfg.relax_patience, tighten_div=cfg.tighten_div,
        relax_add=cfg.relax_add)


class TelemetryRuntime:
    def __init__(self, cfg: TelemetryConfig,
                 sink: Optional[TelemetrySink] = None):
        self.cfg = cfg
        if sink is None and cfg.dir is not None:
            sink = TelemetrySink(SinkConfig(directory=cfg.dir,
                                            rotate_bytes=cfg.rotate_bytes))
        self.sink = sink
        self.controller = (RefreshController(_controller_cfg(cfg))
                           if cfg.auto_refresh else None)
        self.cadence_log: "list[tuple[int, str, int, int]]" = []
        self.transfers = 0            # device-to-host copies it made
        self._cadence: "dict[str, int]" = {}
        self._checked_dynamic = False
        self._warned_no_snaps = False
        # last-seen cumulative guard counters, so fault events fire only
        # on transitions (the counters ride the state every step)
        self._fault_seen: "dict[tuple, int]" = {}

    # -- resilience guards -------------------------------------------------
    def _observe_faults(self, step: int, opt_state) -> bool:
        """Diff the guard counters (host numbers) against the last step,
        emit one ``kind="fault"`` event per transition (whatever
        ``emit_every``), and return whether any guard activity happened
        this step (the controller's anomaly flag)."""
        gs = collect.chain_guard_state(opt_state)
        guards = collect.named_guard_states(opt_state)
        if gs is None and not guards:
            return False
        anomaly = False

        def bump(key, now, event: dict) -> None:
            nonlocal anomaly
            prev = self._fault_seen.get(key, 0)
            if now > prev:
                anomaly = True
                if self.sink is not None:
                    self.sink.emit(event)
            self._fault_seen[key] = now

        if gs is not None:
            skipped = int(gs.skipped)
            bump(("skip",), skipped, {
                "kind": "fault", "step": int(step), "group": "chain",
                "event": "skip", "skipped": skipped,
                "last_skip": int(gs.last_skip)})
        for name, g in sorted(guards.items()):
            trips = int(g.trip_total)
            demos = int(g.demotions)
            bump(("trip", name), trips, {
                "kind": "fault", "step": int(step), "group": name,
                "event": "xi_trip", "trips": trips})
            bump(("demote", name), demos, {
                "kind": "fault", "step": int(step), "group": name,
                "event": "demote", "demotions": demos})
        return anomaly

    # -- per-step ----------------------------------------------------------
    def on_step(self, step: int, state):
        """Process one completed step.  ``state`` is the ``TrainState``
        the step returned (or a bare optimizer state); returns it, with
        retuned cadences where the controller moved one."""
        opt_state = getattr(state, "opt_state", state)
        anomaly = self._observe_faults(step, opt_state)
        emit = self.sink is not None and step % self.cfg.emit_every == 0
        sketch_snaps = collect.named_sketch_snapshots(opt_state)
        snaps = collect.named_snapshots(opt_state)
        if self.controller is not None and not self._checked_dynamic:
            # fail on the first step, not at the first cadence decision
            # (interval steps in): the controller needs snapshots to see
            # xi and a group with a dynamic cadence to act on
            if not snaps:
                raise ValueError(
                    "auto_refresh is on but the optimizer carries no "
                    "telemetry snapshots; build it with telemetry=True")
            if all(v is None
                   for v in collect.get_refresh_every(opt_state).values()):
                raise ValueError(
                    "auto_refresh is on but no optimizer group carries a "
                    "dynamic refresh cadence; build the optimizer with "
                    "dynamic_refresh=True")
            self._checked_dynamic = True
        if not snaps and not sketch_snaps:
            if not self._warned_no_snaps and self.cfg.enabled:
                # a sink without collection is legal (straggler events
                # for other optimizers), but say so once
                log.warning(
                    "telemetry runtime is enabled but the optimizer "
                    "carries no snapshots; no optimizer events will be "
                    "emitted (build it with telemetry=True to collect)")
                self._warned_no_snaps = True
            return state
        if self.controller is None and not emit:
            # nothing reads the vectors this step: no transfer
            return state
        wanted = list(sketch_snaps.values()) if emit else []
        wanted += list(snaps.values())
        self.transfers += fetch_host(wanted)
        if emit:
            for name, snap in sorted(sketch_snaps.items()):
                self.sink.emit(self._sketch_event(step, name, snap))
        changes = {}
        for name in sorted(snaps):
            snap = snaps[name]
            t_now = int(snap.refresh_every)
            self._cadence[name] = t_now
            if emit:
                self.sink.emit(self._optimizer_event(step, name, snap))
            if self.controller is not None and snap.xi.shape[0] > 0:
                # guard activity anywhere this step pauses relaxation for
                # every group's current interval
                change = self.controller.observe(
                    step, name, float(np.mean(snap.host("xi"))), t_now,
                    anomaly=anomaly)
                if change is not None:
                    changes[name] = change.new
                    self.cadence_log.append(
                        (change.step, name, change.old, change.new))
                    if self.sink is not None:
                        self.sink.emit({
                            "kind": "cadence", "step": change.step,
                            "group": name, "old": change.old,
                            "new": change.new,
                            "interval_mean_xi": change.interval_mean_xi})
        if changes:
            new_opt = collect.set_refresh_every(opt_state, changes)
            self._cadence.update(changes)
            if opt_state is state:
                return new_opt
            return dataclasses.replace(state, opt_state=new_opt)
        return state

    @staticmethod
    def _optimizer_event(step: int, group: str, snap) -> dict:
        ev = {
            "kind": "optimizer", "step": int(step), "group": group,
            "refresh_every": int(snap.refresh_every),
            "did_refresh": bool(snap.did_refresh > 0),
            "refresh_steps": int(snap.refresh_steps),
            "fold_steps": int(snap.fold_steps),
            "clip_rate": float(np.mean(snap.host("clip_rate"))),
        }
        if snap.xi.shape[0] > 0:
            xi, k, kf = snap.host("xi"), snap.host("k"), snap.host("k_frac")
            ev.update(xi=xi.tolist(), k=k.tolist(), k_frac=kf.tolist(),
                      mean_xi=float(xi.mean()), max_xi=float(xi.max()),
                      mean_k=float(k.mean()), mean_k_frac=float(kf.mean()),
                      leaf_indices=list(snap.leaf_indices))
        return ev

    @staticmethod
    def _sketch_event(step: int, group: str, snap) -> dict:
        ev = {"kind": "sketch", "step": int(step), "group": group}
        occ, over = snap.host("occupancy"), snap.host("overestimate")
        if occ.shape[0] > 0:
            ev.update(occupancy=occ.tolist(), overestimate=over.tolist(),
                      mean_occupancy=float(occ.mean()),
                      max_occupancy=float(occ.max()),
                      mean_overestimate=float(over.mean()),
                      max_overestimate=float(over.max()),
                      leaf_indices=list(snap.leaf_indices))
        else:
            # the group exists but owns no sketched leaves this run
            ev.update(mean_occupancy=0.0, mean_overestimate=1.0)
        return ev

    # -- checkpoint integration --------------------------------------------
    def manifest_meta(self) -> dict:
        """Controller state and dynamic cadences for the checkpoint
        manifest (JSON-safe)."""
        meta = {"cadence": dict(self._cadence),
                "cadence_log": [list(c) for c in self.cadence_log]}
        if self.controller is not None:
            meta["controller"] = self.controller.state_dict()
        return {"telemetry": meta}

    def restore_meta(self, meta: Optional[dict]) -> None:
        tel = (meta or {}).get("telemetry")
        if not tel:
            return
        self._cadence = {k: int(v) for k, v in tel.get("cadence", {}).items()}
        self.cadence_log = [tuple(c) for c in tel.get("cadence_log", [])]
        if self.controller is not None and "controller" in tel:
            self.controller.load_state_dict(tel["controller"])

    # -- lifecycle -----------------------------------------------------------
    def flush(self) -> None:
        if self.sink is not None:
            self.sink.flush()

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()
