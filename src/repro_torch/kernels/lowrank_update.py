"""CUDA kernel of the single-pass Adapprox update, bound with ctypes.

``csrc/lowrank_update.cu`` holds the kernel and a note on its design (its
tile loop is pass 1's, on the tensor cores in 3xTF32, ``csrc/pass1.cuh``);
it replaces ``lowrank_update_pallas`` of the JAX package's
``kernels/lowrank_update.py``, the update of the ``use_kernels`` path
without ``fused_update``.  The library is built by ``nvcc`` at first use
(``kernels/cuda.py``); nothing is compiled or imported from CUDA when this
module is imported.

The wrapper takes CUDA tensors only, checks them, allocates the outputs,
raises if the launch reports an error, and adds one to
``LAUNCHES["lowrank_update"]``.  The plain version is
``kernels/ref.py::lowrank_update``; ``kernels/ops.py`` picks between them
by device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.fused_update import BN, R_ALIGN, row_groups
from repro_torch.kernels.ref import f32

SOURCE = Path(__file__).resolve().parent / "csrc" / "lowrank_update.cu"

# Launch counts, for showing that a run went through the kernel.
LAUNCHES = {"lowrank_update": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda.build(SOURCE)[0]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lowrank_update_f32.argtypes = [p] * 5 + [i] * 6 + [f, f, f, p]
        lib.lowrank_update_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def lowrank_update(q: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                   b2: float, eps: float):
    """On the card.  q (B, m, r), u (B, n, r), g (B, m, n), fp32
    contiguous, r a multiple of 16.  ``1 - b2`` is the Python double
    rounded once, as in the plain version.  Returns ``(out (B, m, n),
    vfro (B,))``."""
    if q.dim() != 3:
        raise ValueError(f"q: expected (batch, m, r), got {tuple(q.shape)}")
    bsz, m, r = q.shape
    n = g.shape[-1]
    if r % R_ALIGN:
        raise ValueError(f"r = {r}: the kernel takes a multiple of "
                         f"{R_ALIGN}")
    cuda.check("q", q, (bsz, m, r))
    cuda.check("u", u, (bsz, n, r))
    cuda.check("g", g, (bsz, m, n))
    groups, per = row_groups(m, n, bsz, cuda.sm_count(g))
    out = torch.empty_like(g)
    part = torch.empty((bsz, groups, -(-n // BN)), dtype=torch.float32,
                       device=g.device)
    err = _lib().lowrank_update_f32(
        q.data_ptr(), u.data_ptr(), g.data_ptr(), out.data_ptr(),
        part.data_ptr(), bsz, m, n, r, groups, per, f32(b2), f32(1.0 - b2),
        f32(eps), cuda.stream(g))
    cuda.raise_on(err, "lowrank_update")
    LAUNCHES["lowrank_update"] += 1
    return out, part.sum(dim=(1, 2))
