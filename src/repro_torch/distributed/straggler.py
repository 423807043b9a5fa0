"""Straggler detection, a copy of the JAX package's
``distributed/straggler.py`` (it imports neither JAX nor torch).

Stragglers show up as step-time outliers.  Detection is a robust z-score
(median / MAD) over a sliding window of step durations; a flagged step is
logged, and a straggler that persists for ``persist`` steps escalates (to
``escalate``, by default the ``escalations`` list), the hook where a
cluster integration requests a replacement and a checkpoint-restart.
The train loop times its steps with it.  ``sink`` takes an event sink
with ``emit(dict)`` for ``kind="straggler"`` events: the train loop passes
its ``TelemetryRuntime``'s, so flags land on the optimizer's stream.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Callable, Deque, Optional


@dataclasses.dataclass
class StragglerConfig:
    window: int = 50              # sliding window of step times
    z_thresh: float = 4.0         # robust z-score to flag
    persist: int = 10             # consecutive flags before escalation
    min_steps: int = 20           # warmup before judging


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig(),
                 escalate: Optional[Callable[[str], None]] = None,
                 sink=None):
        self.cfg = cfg
        self.times: Deque[float] = collections.deque(maxlen=cfg.window)
        self.flags = 0
        self.n_steps = 0
        self.escalations: list[str] = []
        self._escalate = escalate or self.escalations.append
        self._sink = sink
        self._t0: Optional[float] = None

    def _emit(self, event: str, step_time: float, z: float):
        if self._sink is None:
            return
        self._sink.emit({
            "kind": "straggler", "event": event, "n_steps": self.n_steps,
            "step_time_s": float(step_time), "median_s": self.median,
            "z": float(z), "flags": self.flags})

    # -- timing helpers -----------------------------------------------------
    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.observe(dt)
        return dt

    # -- policy ---------------------------------------------------------------
    def observe(self, step_time: float) -> bool:
        """Feed one step duration; returns True if this step is flagged."""
        flagged = False
        z = 0.0
        if len(self.times) >= self.cfg.min_steps:
            med = statistics.median(self.times)
            mad = statistics.median(abs(t - med) for t in self.times) + 1e-9
            z = 0.6745 * (step_time - med) / mad
            flagged = z > self.cfg.z_thresh
        self.times.append(step_time)
        self.n_steps += 1
        if flagged:
            self.flags += 1
            self._emit("flagged", step_time, z)
            if self.flags >= self.cfg.persist:
                self._escalate(
                    f"straggler persisted {self.flags} steps "
                    f"(last={step_time:.3f}s median="
                    f"{statistics.median(self.times):.3f}s)")
                self._emit("escalated", step_time, z)
                self.flags = 0
        else:
            self.flags = 0
        return flagged

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0
