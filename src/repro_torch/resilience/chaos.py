"""Deterministic fault injection: the port of the JAX package's
``resilience/chaos.py``.

Every injector is a pure function of explicit inputs (the step counter, a
byte offset), never of wall-clock or RNG, so a chaos run replays
bit-identically and tests can hold counters to the schedule exactly:

  * ``inject_faults(FaultPlan)``: a ``GradientTransformation`` that
    poisons the gradients with NaN / Inf at the steps listed in the plan.
    Chain it before the guarded optimizer, so the guard sees the poisoned
    gradients the way a real overflow would arrive.
  * ``truncate_file`` / ``flip_bit`` / ``corrupt_latest_checkpoint``:
    checkpoint corruption on the host, a kill mid-write (truncation) and
    silent media corruption (a bit flip);
  * ``remesh_after_loss``: simulated device loss, the mesh plan the
    restarted job builds for the survivors.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from repro_torch.core.types import GradientTransformation, P


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic NaN / Inf gradient schedule.  Steps are 1-based (the
    injector's own counter, incremented before the check: step 1 is the
    first update), matching the train loop's reported step numbers."""

    nan_steps: Tuple[int, ...] = ()
    inf_steps: Tuple[int, ...] = ()

    @property
    def fault_steps(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.nan_steps) | set(self.inf_steps)))


def inject_faults(plan: FaultPlan) -> GradientTransformation:
    """Gradient transformation that fills every gradient with NaN at the
    plan's ``nan_steps`` and with +Inf at its ``inf_steps`` (NaN wins when
    a step is in both).  Its state is the step counter, a Python int; with
    an empty plan, or off the schedule, the gradients pass through as they
    are."""

    def init(params):
        del params
        return 0

    def update(grads, state, params=None):
        del params
        step = state + 1
        fill = (float("nan") if step in plan.nan_steps
                else float("inf") if step in plan.inf_steps else None)
        if fill is None:
            return grads, step
        return {k: torch.full_like(g, fill) for k, g in grads.items()}, step

    def spec(state, param_specs):
        del state, param_specs
        return P()

    return GradientTransformation(init, update, spec)


def truncate_file(path: str, keep_bytes: int) -> None:
    """Cut ``path`` down to its first ``keep_bytes`` bytes (kill mid-write)."""
    with open(path, "r+b") as f:
        f.truncate(max(0, keep_bytes))


def flip_bit(path: str, byte_offset: int, bit: int = 0) -> None:
    """Flip one bit in place (silent media corruption)."""
    with open(path, "r+b") as f:
        f.seek(byte_offset)
        b = f.read(1)
        if not b:
            raise ValueError(f"{path}: offset {byte_offset} past EOF")
        f.seek(byte_offset)
        f.write(bytes([b[0] ^ (1 << bit)]))


def corrupt_latest_checkpoint(directory: str, kind: str = "truncate") -> str:
    """Damage the newest committed checkpoint's largest leaf file.

    kind="truncate": cut the file in half (the cheap structural size check
    sees it, so even ``latest_step()`` skips it).
    kind="bitflip": flip one payload bit (sizes stay right; only the deep
    sha256 verify in ``restore()`` catches it).
    kind="manifest": truncate manifest.json itself.
    Returns the path of the file that was damaged.
    """
    from repro_torch.checkpoint.serialization import list_checkpoints

    committed = list_checkpoints(directory)
    if not committed:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    step_dir = str(committed[-1])
    if kind == "manifest":
        target = os.path.join(step_dir, "manifest.json")
        truncate_file(target, os.path.getsize(target) // 2)
        return target
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    files = [os.path.join(step_dir, leaf["file"])
             for leaf in manifest["leaves"]]
    target = max(files, key=os.path.getsize)
    if kind == "truncate":
        truncate_file(target, os.path.getsize(target) // 2)
    elif kind == "bitflip":
        # flip inside the payload, past the .npy header
        flip_bit(target, os.path.getsize(target) - 1, bit=3)
    else:
        raise ValueError(f"unknown corruption kind: {kind!r}")
    return target


# ---------------------------------------------------------------------------
# Device loss
# ---------------------------------------------------------------------------

def remesh_after_loss(lost: int, target_model: int = 16,
                      available_devices: Optional[int] = None):
    """Mesh plan for the survivors after losing ``lost`` devices: the
    chaos harness shrinks the device count and asks
    ``distributed.elastic`` for the mesh the restarted job builds, then
    restores the checkpoint under it (``elastic_restore``; placement
    happens at load).  The count defaults to the process group's world
    size, else the visible GPUs."""
    import torch.distributed as dist

    from repro_torch.distributed.elastic import plan_remesh
    if available_devices is not None:
        n = available_devices
    elif dist.is_initialized():
        n = dist.get_world_size()
    else:
        n = torch.cuda.device_count()
    survivors = n - lost
    if survivors < 1:
        raise ValueError(f"lost {lost} of {n} devices -- nothing left")
    return plan_remesh(survivors, target_model=target_model)
