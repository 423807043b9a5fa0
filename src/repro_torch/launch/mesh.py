"""Device meshes over ``torch.distributed``: the JAX package's
``launch/mesh.py``.

Functions, not module-level constants, so importing this module touches
no process group.  A rank is one process on one device: under ``torchrun``
the process group comes from ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
(and ``MASTER_ADDR`` / ``MASTER_PORT``); without them a mesh of one
device starts a one-rank group itself.  The backend is NCCL on
``cuda:LOCAL_RANK`` and gloo on the CPU.  A mesh larger than one needs as
many ranks, one per GPU.

:func:`make_fake_mesh` (and ``make_production_mesh(fake=True)``) is the
dry run's mesh: every rank of a production mesh in one process, rank 0 of
a process group over PyTorch's ``"fake"`` backend, whose collectives
return at once and move nothing; on fake tensors (``FakeTensorMode``) a
collective gives outputs of the right shapes and no storage.  The fake
backend and its store live in ``torch.testing._internal.distributed.
fake_pg``, an internal API of PyTorch: this is the one module of the port
that imports it, inside the function.  A fake group cannot share the
process with a real default group.
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device_type: str, need: int = 1) -> torch.device:
    """Join (or start) the default process group and return this rank's
    device.  Raises ``ValueError`` unless the group has ``need`` ranks."""
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        elif need == 1:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                rank=0, world_size=1)
        else:
            raise ValueError(
                f"a mesh of {need} devices needs {need} ranks, one process "
                f"each: start them with torchrun --nproc-per-node {need}")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"the mesh needs {need} devices but the process "
                         f"group has {world} ranks")
    if device_type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cpu")


def make_mesh(shape: tuple, axes: tuple, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (started if need be)."""
    from torch.distributed.device_mesh import init_device_mesh
    init_process_group(device_type, math.prod(shape))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_fake_mesh(shape: tuple, axes: tuple):
    """A CPU ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process
    group of ``prod(shape)`` ranks, this process rank 0 (see the module
    docstring).  It starts the fake group, or restarts one of another
    size; it raises if a real default group is up."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group is up: a fake mesh "
                f"needs a process of its own")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda", fake: bool = False):
    """One pod: (data=16, model=16) = 256 devices.  Two pods: (pod=2,
    data=16, model=16) = 512; the ``pod`` axis is data parallelism across
    the slow link (only gradient sums cross it).  ``fake=True`` builds it
    over the fake backend in this process (:func:`make_fake_mesh`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if fake:
        return make_fake_mesh(shape, axes)
    return make_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cpu"):
    """A small mesh for tests (gloo ranks on the CPU by default)."""
    return make_mesh(shape, axes, device_type)
