"""Carry state across from the JAX package, through numpy.

``params_from_numpy`` takes the JAX parameter pytree (nested dicts of
numpy arrays, e.g. from ``jax.device_get``) and returns the port's
parameters; ``adapprox_state_from_numpy``, ``sketch_state_from_numpy``,
``adam_state_from_numpy`` and ``baseline_state_from_numpy`` do the same
for an ``AdapproxState``, a ``SketchState``, an ``AdamWState`` and an
``AdafactorState`` or ``CAMEState``, int8 factors included
(``quantized_from_numpy``), and ``guard_state_from_numpy`` /
``guarded_state_from_numpy`` for the guards' ``GuardState`` and
``GuardedState``; an Adapprox state's telemetry snapshot and dynamic
cadence, and a sketch state's snapshot, come across with it
(``snapshot_from_numpy``, ``sketch_snapshot_from_numpy``).  With them, a test can start the two packages from the
same mid-run state.  ``train_state_from_checkpoint`` turns a checkpoint
directory the JAX package wrote into the port's ``TrainState``, reading
its files with numpy alone.  ``cache_from_numpy`` carries a serving
cache across (each family's dense cache dict: the KV caches, the Mamba
caches, the cross K / V and the position) and ``pool_from_numpy`` a paged
block pool, so a test can start both packages' decode from one cache.
Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.adafactor import AdafactorLeaf, AdafactorState
from repro_torch.core.adamw import AdamWState
from repro_torch.core.adapprox import AdapproxState
from repro_torch.core.came import CAMELeaf, CAMEState
from repro_torch.core.factored import DenseLeaf, FactoredLeaf
from repro_torch.core.quantized import QuantizedMatrix
from repro_torch.core.sketch import SketchDense, SketchLeaf, SketchState
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import MambaCache
from repro_torch.resilience.guards import GuardedState, GuardState
from repro_torch.telemetry.snapshot import SketchSnapshot, TelemetrySnapshot
from repro_torch.train.steps import TrainState


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def params_from_numpy(tree: dict, device: str | torch.device = "cpu") -> dict:
    """Nested dict of arrays -> nested dict of fp32 tensors on ``device``."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else _t(v, device, torch.float32) for k, v in tree.items()}


def _array(x, device) -> torch.Tensor:
    """A numpy array (bf16 as ml_dtypes or JAX give it) -> a tensor of the
    same dtype on ``device``."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return _t(a.astype(np.float32), device).to(torch.bfloat16)
    return _t(a, device)


def cache_from_numpy(cache: dict, device: str | torch.device = "cpu"
                     ) -> dict:
    """A JAX serving cache after ``device_get`` -> the port's: ``kv`` (a
    ``KVCache`` of (L, B, S, KV, dh)), ``mamba`` (a ``MambaCache`` of (L,
    B, d_conv, conv_dim) and (L, B, H, P, N)), ``cross`` ((L, 2, B,
    enc_seq, KV, dh)) as tensors of their dtypes, ``pos`` an int."""
    out = {}
    for key, val in cache.items():
        if key == "pos":
            out[key] = int(val)
        elif key == "kv":
            out[key] = KVCache(k=_array(val.k, device),
                               v=_array(val.v, device))
        elif key == "mamba":
            out[key] = MambaCache(conv=_array(val.conv, device),
                                  ssm=_array(val.ssm, device))
        else:
            out[key] = _array(val, device)
    return out


def pool_from_numpy(pool: dict, device: str | torch.device = "cpu") -> dict:
    """A JAX paged pool ``{"k", "v"}`` of (L, NB, bs, KV, dh) -> the
    port's."""
    return {k: _array(v, device) for k, v in pool.items()}


def quantized_from_numpy(qm, device: str | torch.device = "cpu"
                         ) -> QuantizedMatrix:
    """A JAX ``QuantizedMatrix`` of numpy arrays (``q8`` int8, ``scale``,
    ``zero`` fp32) -> the port's."""
    return QuantizedMatrix(q8=_t(qm.q8, device, torch.int8),
                           scale=_t(qm.scale, device, torch.float32),
                           zero=_t(qm.zero, device, torch.float32))


def snapshot_from_numpy(snap, device: str | torch.device = "cpu"
                        ) -> TelemetrySnapshot:
    """A JAX ``TelemetrySnapshot`` after ``device_get`` -> the port's: the
    per-leaf vectors fp32 on ``device``, the counters host numbers."""
    f32 = lambda x: _t(x, device, torch.float32)
    return TelemetrySnapshot(
        step=int(snap.step), xi=f32(snap.xi), k=f32(snap.k),
        k_frac=f32(snap.k_frac), clip_rate=f32(snap.clip_rate),
        did_refresh=float(snap.did_refresh),
        refresh_steps=int(snap.refresh_steps),
        fold_steps=int(snap.fold_steps),
        refresh_every=int(snap.refresh_every),
        leaf_indices=tuple(int(i) for i in snap.leaf_indices),
        dense_indices=tuple(int(i) for i in snap.dense_indices))


def sketch_snapshot_from_numpy(snap, device: str | torch.device = "cpu"
                               ) -> SketchSnapshot:
    """A JAX ``SketchSnapshot`` after ``device_get`` -> the port's."""
    return SketchSnapshot(
        step=int(snap.step),
        occupancy=_t(snap.occupancy, device, torch.float32),
        overestimate=_t(snap.overestimate, device, torch.float32),
        leaf_indices=tuple(int(i) for i in snap.leaf_indices))


def adapprox_state_from_numpy(step: int, leaves: Sequence,
                              device: str | torch.device = "cpu",
                              guards=None, seed: int = 0, telemetry=None,
                              refresh_every=None) -> AdapproxState:
    """``leaves``: per-parameter objects in flatten order carrying numpy
    fields ``q, u, k, xi, m1`` (factored) or ``v, m1`` (dense), as the JAX
    package's ``FactoredLeaf`` / ``DenseLeaf`` do after ``device_get``;
    int8 factors (``QuantizedMatrix``) stay int8.  ``guards``: the JAX
    ``GuardState`` after ``device_get`` (see
    :func:`guard_state_from_numpy`), or None; ``seed``: the config's;
    ``telemetry``: the JAX ``TelemetrySnapshot`` after ``device_get``
    (:func:`snapshot_from_numpy`), or None; ``refresh_every``: the JAX
    state's dynamic cadence (an int32 scalar), or None."""
    f32 = lambda x: None if x is None else _t(x, device, torch.float32)
    fac = lambda x: (quantized_from_numpy(x, device) if hasattr(x, "q8")
                     else f32(x))
    out = []
    for leaf in leaves:
        if hasattr(leaf, "q"):
            out.append(FactoredLeaf(q=fac(leaf.q), u=fac(leaf.u),
                                    k=_t(leaf.k, device, torch.int32),
                                    xi=f32(leaf.xi), m1=f32(leaf.m1)))
        else:
            out.append(DenseLeaf(v=f32(leaf.v), m1=f32(leaf.m1)))
    if guards is not None:
        guards = guard_state_from_numpy(
            guards.trips, guards.force_refresh, guards.demoted,
            guards.trip_total, guards.demotions, guards.dense_v, device)
    return AdapproxState(
        step=int(step), leaves=tuple(out),
        telemetry=(None if telemetry is None
                   else snapshot_from_numpy(telemetry, device)),
        refresh_every=None if refresh_every is None else int(refresh_every),
        guards=guards, seed=seed)


def guard_state_from_numpy(trips, force_refresh, demoted, trip_total,
                           demotions, dense_v: Sequence = (),
                           device: str | torch.device = "cpu"
                           ) -> GuardState:
    """The JAX ``GuardState``'s fields (numpy) -> the port's: the counters
    as CPU int32 tensors, the dense shadow buffers fp32 on ``device``."""
    i32 = lambda x: torch.tensor(np.asarray(x, np.int32))
    return GuardState(trips=i32(trips), force_refresh=i32(force_refresh),
                      demoted=i32(demoted), trip_total=i32(trip_total),
                      demotions=i32(demotions),
                      dense_v=tuple(_t(v, device, torch.float32)
                                    for v in dense_v))


def guarded_state_from_numpy(steps, skipped, last_skip,
                             inner) -> GuardedState:
    """The JAX ``GuardedState``'s int32 counters -> the port's, around the
    already converted ``inner`` state."""
    return GuardedState(inner=inner, steps=int(steps), skipped=int(skipped),
                        last_skip=int(last_skip))


def train_state_from_checkpoint(ckpt_dir, like: TrainState) -> TrainState:
    """A checkpoint directory (``step_*``) the JAX package wrote -> the
    port's ``TrainState``, with the structure, devices and dtypes of
    ``like`` (the port's state for the same run, e.g. ``TrainState.create``
    of the same model and optimizer config).  The files are read with
    numpy alone and checked as the port's own restore checks them: the
    checksums, every leaf's JAX key path, shape and dtype, and the leaves
    the port derives (the PRNG key against the config's seed)."""
    from repro_torch.checkpoint.serialization import restore_pytree
    return restore_pytree(ckpt_dir, like)


def sketch_state_from_numpy(step: int, leaves: Sequence,
                            device: str | torch.device = "cpu",
                            telemetry=None) -> SketchState:
    """``leaves``: per-parameter objects in flatten order carrying ``table,
    m, seeds, shape`` (sketched) or ``m, v`` (dense), as the JAX package's
    ``SketchLeaf`` / ``SketchDense`` do after ``device_get``;
    ``telemetry``: its ``SketchSnapshot`` after ``device_get``, or None."""
    f32 = lambda x: None if x is None else _t(x, device, torch.float32)
    out = []
    for leaf in leaves:
        if hasattr(leaf, "table"):
            out.append(SketchLeaf(table=f32(leaf.table), m=f32(leaf.m),
                                  seeds=tuple(tuple(int(v) for v in ab)
                                              for ab in leaf.seeds),
                                  shape=tuple(int(d) for d in leaf.shape)))
        else:
            out.append(SketchDense(m=f32(leaf.m), v=f32(leaf.v)))
    return SketchState(step=int(step), leaves=tuple(out),
                       telemetry=(None if telemetry is None else
                                  sketch_snapshot_from_numpy(telemetry,
                                                             device)))


def adam_state_from_numpy(step: int, m: dict, v: dict,
                          device: str | torch.device = "cpu") -> AdamWState:
    """``m`` / ``v``: the JAX ``AdamWState``'s moment pytrees as (nested)
    dicts of arrays; the port keys them by flattened path.  ``None``
    entries (leaves of other groups inside a partition) are dropped."""
    f32 = lambda d: {k: _t(x, device, torch.float32)
                     for k, x in tree.flatten(d).items() if x is not None}
    return AdamWState(step=int(step), m=f32(m), v=f32(v))


def baseline_state_from_numpy(step: int, leaves: Sequence,
                              device: str | torch.device = "cpu"
                              ) -> "AdafactorState | CAMEState":
    """``leaves``: per-parameter objects in flatten order carrying numpy
    fields ``r, c, v, m1`` (Adafactor) or ``r, c, v, rs, cs, m1`` (CAME),
    ``None`` where the JAX leaf has none, as the JAX package's
    ``AdafactorLeaf`` / ``CAMELeaf`` do after ``device_get``.  Returns the
    family's state, told apart by the instability statistics ``rs``."""
    f32 = lambda x: None if x is None else _t(x, device, torch.float32)
    came = bool(leaves) and hasattr(leaves[0], "rs")
    cls, state = (CAMELeaf, CAMEState) if came else (AdafactorLeaf,
                                                    AdafactorState)
    names = [f.name for f in dataclasses.fields(cls)]
    return state(step=int(step), leaves=tuple(
        cls(**{n: f32(getattr(leaf, n)) for n in names}) for leaf in leaves))
