"""Elastic scaling: resume a checkpoint under a different mesh; the JAX
package's ``distributed/elastic.py``.

Checkpoints store whole (logical) arrays, so elasticity is:
  1. read the world size at start-up,
  2. build the new mesh and its shardings,
  3. restore and place under them (``CheckpointManager.restore(...,
     shardings=...)``).

The data stream is a pure function of (seed, step), so the survivors
re-derive their batches after re-partitioning.

``plan_remesh`` is the policy: given a device count (possibly after losing
nodes) choose the nearest valid (pod, data, model) factorisation,
preferring to shrink the data axis (tensor-parallel shard shapes stay as
they were; only the FSDP blocks move).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    pods: int
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.pods * self.data * self.model

    def axes(self) -> tuple:
        if self.pods > 1:
            return ("pod", "data", "model")
        return ("data", "model")

    def shape(self) -> tuple:
        if self.pods > 1:
            return (self.pods, self.data, self.model)
        return (self.data, self.model)


def plan_remesh(available_devices: int, target_model: int = 16,
                max_pod_data: int = 16) -> MeshPlan:
    """Largest usable mesh with the given TP degree.

    Keeps ``model`` fixed (parameter shard shapes stay stable across the
    restart) and re-factorises the rest into (pods, data).  Devices that
    do not fit the factorisation are left idle."""
    if available_devices < target_model:
        # degrade TP as the last resort (power of two below the count)
        tm = 1
        while tm * 2 <= available_devices:
            tm *= 2
        target_model = tm
    usable = available_devices // target_model
    data = min(usable, max_pod_data)
    pods = usable // data
    return MeshPlan(pods=max(pods, 1), data=max(data, 1),
                    model=target_model)


def build_mesh(plan: MeshPlan, device_type: str = "cuda"):
    """A ``DeviceMesh`` of the plan's shape over ranks 0 .. devices - 1 of
    the default process group; every rank of the group calls it, and the
    ranks past the plan are left idle (no coordinate on the mesh)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type,
                      torch.arange(plan.devices).reshape(plan.shape()),
                      mesh_dim_names=plan.axes())


def _device_type(tree) -> str:
    from repro_torch.checkpoint.serialization import leaves_with_paths
    for _, leaf in leaves_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device.type
    return "cpu"


def elastic_restore(ckpt_manager, like, make_shardings, *,
                    available_devices: Optional[int] = None,
                    target_model: int = 16):
    """End-to-end elastic resume: plan the mesh, build its shardings
    (``make_shardings(mesh)`` -> a tree mirroring ``like``), restore the
    newest good checkpoint under them.  Returns ``(state, step, mesh)``;
    on a rank the plan leaves idle ``state`` is None."""
    import torch.distributed as dist
    n = available_devices or dist.get_world_size()
    plan = plan_remesh(n, target_model=target_model)
    mesh = build_mesh(plan, _device_type(like))
    shardings = make_shardings(mesh)
    if mesh.get_coordinate() is None:       # left idle by the plan
        return None, ckpt_manager.restore(like)[1], mesh
    state, step = ckpt_manager.restore(like, shardings=shardings)
    return state, step, mesh
