"""Optimizer telemetry state: ``TelemetrySnapshot`` and ``SketchSnapshot``,
the port of the JAX package's ``telemetry/snapshot.py``.

One snapshot per ``scale_by_adapprox`` instance (a ``partition`` carries
one per group that runs Adapprox) and one per ``scale_by_sketch``
instance with ``telemetry``.  It is assembled inside the optimizer's
update from values the update already computes (per-leaf means of xi and
k, the clip denominator each path computes anyway) and rides in the
optimizer state, so it checkpoints with it: its fields are the JAX
snapshot's, in its order, under its key paths, with its dtypes.

Where the values live.  The port decides refresh or fold on the host, so
the counters (``step``, ``did_refresh``, ``refresh_steps``,
``fold_steps``, ``refresh_every``) are Python numbers, never read back
from the device; a checkpoint writes them as JAX's int32 scalars
(``did_refresh`` as its float32 scalar).  The per-leaf vectors (``xi``,
``k``, ``k_frac``, ``clip_rate``; the sketch's ``occupancy``,
``overestimate``) are float32 tensors on the parameters' device.  They
reach the host in at most one copy a step, shared by every snapshot:
under the guards the skip-step wrapper's one transfer carries them
(``resilience/guards.py``), otherwise ``TelemetryRuntime`` makes one
``.cpu()`` of one packed vector (:func:`fetch_host`), and only on a step
where something reads them.  The host copy is cached on the snapshot
object, not in a field, so a restored or rebuilt snapshot starts without
one.

``leaf_indices`` / ``dense_indices`` are static: flat parameter indices
(flatten order) of the vector entries, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Iterable, Optional

import numpy as np
import torch


class _HostCopy:
    """The host copy of a snapshot's device vectors (``VECTORS``)."""

    VECTORS: ClassVar[tuple] = ()

    def __post_init__(self):
        self._host: Optional[dict] = None

    @property
    def on_host(self) -> bool:
        return self._host is not None

    def host(self, name: str) -> np.ndarray:
        """A device vector's float32 host copy; :func:`fetch_host` (or the
        guards' transfer) must have run for this snapshot."""
        if self._host is None:
            raise RuntimeError(f"{type(self).__name__} at step {self.step} "
                               f"has not been read to the host")
        return self._host[name]

    def _set_host(self, values: dict) -> None:
        self._host = values


@dataclasses.dataclass
class TelemetrySnapshot(_HostCopy):
    """Per-step telemetry of one Adapprox instance.

    step:          optimizer step described (from 1; 0 = nothing ran).
    xi:            (n_factored,) f32, per factored leaf its mean
                   approximation error rate over its batch dims.
    k:             (n_factored,) f32, per factored leaf its mean effective
                   rank, ``min(k, k_max)``.
    k_frac:        (n_factored,) f32, rank occupancy k / k_max.
    clip_rate:     (n_leaves,) f32, flatten order: the fraction of the
                   leaf's matrices whose update-RMS clip was active.
    did_refresh:   1.0 if the cadence made this step a full S-RSI refresh,
                   0.0 if it folded (a refresh the xi watchdog forces is
                   not counted, as in JAX).
    refresh_steps: cumulative refresh steps.
    fold_steps:    cumulative fold steps (refresh + fold == step).
    refresh_every: the cadence in effect this step.
    """

    VECTORS: ClassVar[tuple] = ("xi", "k", "k_frac", "clip_rate")

    step: int
    xi: torch.Tensor
    k: torch.Tensor
    k_frac: torch.Tensor
    clip_rate: torch.Tensor
    did_refresh: float
    refresh_steps: int
    fold_steps: int
    refresh_every: int
    leaf_indices: tuple = dataclasses.field(
        default=(), metadata=dict(static=True))
    dense_indices: tuple = dataclasses.field(
        default=(), metadata=dict(static=True))


@dataclasses.dataclass
class SketchSnapshot(_HostCopy):
    """Per-step telemetry of one ``scale_by_sketch`` instance.

    step:         optimizer step described.
    occupancy:    (n_sketched,) f32, per sketched leaf the fraction of
                  (depth x width) buckets holding any mass.
    overestimate: (n_sketched,) f32, queried mass over table mass (one
                  depth row holds the whole EMA'd G^2 mass): >= 1, and 1
                  exactly when no rows collide.
    """

    VECTORS: ClassVar[tuple] = ("occupancy", "overestimate")

    step: int
    occupancy: torch.Tensor
    overestimate: torch.Tensor
    leaf_indices: tuple = dataclasses.field(
        default=(), metadata=dict(static=True))


def _placed(snap: _HostCopy, device) -> _HostCopy:
    """A snapshot built on the CPU with its values as its host copy (no
    transfer), its vectors then moved to ``device``."""
    snap._set_host({name: getattr(snap, name).numpy()
                    for name in snap.VECTORS})
    for name in snap.VECTORS:
        setattr(snap, name, getattr(snap, name).to(device))
    return snap


def init_snapshot(n_factored: int, n_leaves: int, refresh_every: int,
                  leaf_indices: tuple = (), dense_indices: tuple = (),
                  device: "str | torch.device" = "cpu"
                  ) -> TelemetrySnapshot:
    """The step-0 snapshot: zeros, the configured cadence.  Its host copy
    is known without a transfer."""
    z = lambda n: torch.zeros((n,), dtype=torch.float32)
    return _placed(TelemetrySnapshot(
        step=0, xi=z(n_factored), k=z(n_factored), k_frac=z(n_factored),
        clip_rate=z(n_leaves), did_refresh=0.0, refresh_steps=0,
        fold_steps=0, refresh_every=int(refresh_every),
        leaf_indices=tuple(leaf_indices),
        dense_indices=tuple(dense_indices)), device)


def init_sketch_snapshot(n_sketched: int, leaf_indices: tuple = (),
                         device: "str | torch.device" = "cpu"
                         ) -> SketchSnapshot:
    """The step-0 sketch snapshot: empty tables (occupancy 0, ratio 1)."""
    return _placed(SketchSnapshot(
        step=0, occupancy=torch.zeros((n_sketched,), dtype=torch.float32),
        overestimate=torch.ones((n_sketched,), dtype=torch.float32),
        leaf_indices=tuple(leaf_indices)), device)


def snapshot_spec(snap):
    """Sharding spec of a ``TelemetrySnapshot`` or ``SketchSnapshot``:
    every leaf replicated (scalars and per-leaf vectors, nothing worth
    splitting), as in the JAX package; ``None`` (telemetry off) stays
    ``None``."""
    from repro_torch.core.types import replicate_state_spec  # core imports us
    return replicate_state_spec(snap)


def pending(snaps: Iterable[_HostCopy]) -> list:
    """The snapshots of ``snaps`` without a host copy yet."""
    return [s for s in snaps if not s.on_host]


def packed(snaps: list) -> Optional[torch.Tensor]:
    """The device vectors of ``snaps`` concatenated, in order (None when
    there are none); :func:`set_host` takes their host copy back."""
    parts = [getattr(s, name).reshape(-1).float() for s in snaps
             for name in s.VECTORS]
    if not parts:
        return None
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts])


def set_host(snaps: list, flat: np.ndarray) -> None:
    """Split the host copy of :func:`packed` ``(snaps)`` into each
    snapshot's cache."""
    off = 0
    for s in snaps:
        values = {}
        for name in s.VECTORS:
            n = getattr(s, name).numel()
            values[name] = np.asarray(flat[off:off + n], np.float32)
            off += n
        s._set_host(values)
    if off != len(flat):
        raise ValueError(f"packed telemetry: {len(flat)} values for {off}")


def fetch_host(snaps: Iterable[_HostCopy]) -> int:
    """Give every snapshot of ``snaps`` its host copy, in one device-to-
    host transfer for all those that lack one.  Returns the number of
    transfers made (0 or 1)."""
    todo = pending(snaps)
    if not todo:
        return 0
    set_host(todo, packed(todo).cpu().numpy())
    return 1
