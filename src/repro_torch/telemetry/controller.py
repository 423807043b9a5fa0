"""Closed-loop refresh-cadence controller: a copy of the JAX package's
``telemetry/controller.py`` (pure Python; the port keeps its own copy).

The paper's mechanism is *adaptive* approximation: rank follows the
observed relative error xi.  The amortized-refresh runtime added a
second lever — ``refresh_every``, how often the basis Q is re-computed —
but left it a static constant.  This controller closes that loop: it
watches the per-group interval-mean xi that the optimizer's snapshot
already carries and retunes the cadence per parameter group.

Policy (hysteresis band, per group, evaluated every ``interval`` steps):

  * TIGHTEN — interval-mean xi >= ``xi_high`` (the approximation is
    drifting toward the warm-start guard ``warm_drift_xi``): divide the
    cadence by ``tighten_div`` (refresh more often).  Tightening reacts
    immediately (error is expensive) and resets the relax streak.
  * RELAX — interval-mean xi <= ``xi_low`` for ``relax_patience``
    CONSECUTIVE intervals (the frozen basis is tracking well): add
    ``relax_add`` to the cadence (refresh less often).  Relaxing is slow
    and additive; tightening is fast and multiplicative — the usual
    AIMD-style asymmetry that keeps the loop stable.
  * In the dead band between the thresholds nothing moves (and the relax
    streak resets), so the cadence cannot oscillate on noise.
  * ANOMALY PAUSE — when the runtime reports guard activity in an
    interval (skip-steps, xi trips, demotions; ``observe(...,
    anomaly=True)``), relaxation is suppressed for that interval and the
    calm streak resets: an xi average over steps where the guard was
    skipping poisoned updates says nothing about how well the frozen
    basis tracks.  Tightening stays armed — a fault burst is exactly
    when refreshing MORE often helps.

Cadences are clamped to ``[t_min, t_max]``.

Determinism: the controller is a pure fold over the observed
``(step, group, xi)`` sequence — no wall-clock, no RNG — and its full
state round-trips through :meth:`state_dict` (stored in checkpoint
manifests by the train loop).  A run killed and restored mid-interval
therefore reproduces the identical cadence-change sequence
(tests/test_torch_telemetry.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    interval: int = 25            # steps between cadence decisions
    t_min: int = 1
    t_max: int = 50
    xi_high: float = 0.25         # tighten when interval-mean xi >= this
    xi_low: float = 0.10          # relax when <= this (with patience)
    relax_patience: int = 2       # consecutive calm intervals before relaxing
    tighten_div: int = 2          # T <- max(t_min, T // tighten_div)
    relax_add: int = 1            # T <- min(t_max, T + relax_add)

    def __post_init__(self):
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")
        if not (1 <= self.t_min <= self.t_max):
            raise ValueError(f"need 1 <= t_min <= t_max, "
                             f"got [{self.t_min}, {self.t_max}]")
        if self.xi_low > self.xi_high:
            raise ValueError(f"hysteresis band inverted: xi_low "
                             f"{self.xi_low} > xi_high {self.xi_high}")
        if self.tighten_div < 2:
            raise ValueError("tighten_div must be >= 2")


@dataclasses.dataclass
class CadenceChange:
    step: int
    group: str
    old: int
    new: int
    interval_mean_xi: float


class RefreshController:
    """Deterministic per-group cadence feedback.  Feed
    :meth:`observe` once per step per group; it returns a
    :class:`CadenceChange` on the interval boundaries where the policy
    decides to move, else ``None``."""

    def __init__(self, cfg: ControllerConfig = ControllerConfig()):
        self.cfg = cfg
        # group -> {"xi_sum": float, "n": int, "calm": int}
        self._groups: dict = {}

    def _g(self, group: str) -> dict:
        return self._groups.setdefault(
            group, {"xi_sum": 0.0, "n": 0, "calm": 0, "anomalies": 0})

    def observe(self, step: int, group: str, xi: float, t_now: int,
                anomaly: bool = False) -> Optional[CadenceChange]:
        """``anomaly=True`` flags guard activity at this step (skip-step,
        xi trip or demotion): the current interval will not relax."""
        cfg = self.cfg
        g = self._g(group)
        g["xi_sum"] += float(xi)
        g["n"] += 1
        if anomaly:
            g["anomalies"] = g.get("anomalies", 0) + 1
        if step % cfg.interval != 0:
            return None
        mean = g["xi_sum"] / max(g["n"], 1)
        burst = g.get("anomalies", 0) > 0
        g["xi_sum"], g["n"], g["anomalies"] = 0.0, 0, 0
        if mean >= cfg.xi_high:
            g["calm"] = 0
            new_t = max(cfg.t_min, min(cfg.t_max,
                                       int(t_now) // cfg.tighten_div))
        elif burst:
            # faults this interval: hold the cadence, reset the streak
            g["calm"] = 0
            return None
        elif mean <= cfg.xi_low:
            g["calm"] += 1
            if g["calm"] < cfg.relax_patience:
                return None
            g["calm"] = 0
            new_t = max(cfg.t_min, min(cfg.t_max, int(t_now) + cfg.relax_add))
        else:
            g["calm"] = 0
            return None
        if new_t == int(t_now):
            return None
        return CadenceChange(step=int(step), group=group, old=int(t_now),
                             new=new_t, interval_mean_xi=mean)

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe full state (floats round-trip exactly through JSON)."""
        return {"groups": {k: dict(v) for k, v in self._groups.items()}}

    def load_state_dict(self, state: dict) -> None:
        # ``anomalies`` entered the state with the resilience layer;
        # manifests written before it load as 0 (no anomaly observed).
        self._groups = {k: {"xi_sum": float(v["xi_sum"]), "n": int(v["n"]),
                            "calm": int(v["calm"]),
                            "anomalies": int(v.get("anomalies", 0))}
                        for k, v in state.get("groups", {}).items()}
