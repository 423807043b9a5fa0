"""CUDA kernel of the square-and-matmul ``(G * G) @ X`` and its transposed
form ``(G * G)^T @ Y``, bound with ctypes.

``csrc/srsi_matmul.cu`` holds the kernel (3xTF32 on the tensor cores) and
a note on its design; it
replaces ``sq_matmul_pallas`` of the JAX package's
``kernels/srsi_matmul.py`` and, in its transposed variant, the transpose
copy that the JAX package's ``ops.sq_matmul_t`` makes in front of it.  The
library is built by ``nvcc`` at first use (``kernels/cuda.py``); nothing
is compiled or imported from CUDA when this module is imported.

The wrapper takes CUDA tensors only, checks them, allocates the output,
raises if the launch reports an error, and adds one to
``LAUNCHES["sq_matmul"]`` or ``LAUNCHES["sq_matmul_t"]``.  The plain
versions are ``kernels/ref.py::sq_matmul`` / ``sq_matmul_t``;
``kernels/ops.py`` picks between them by device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import cuda

SOURCE = Path(__file__).resolve().parent / "csrc" / "srsi_matmul.cu"

BO = 64                 # output rows per block (csrc BO)
KC = 32                 # contraction slice (csrc KC)

# Launch counts per orientation, for showing that a run went through them.
LAUNCHES = {"sq_matmul": 0, "sq_matmul_t": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda.build(SOURCE)[0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sq_matmul_f32.argtypes = [p, p, p] + [i] * 7 + [p]
        lib.sq_matmul_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def sq_matmul(g: torch.Tensor, x: torch.Tensor, transposed: bool = False):
    """On the card.  g (B, m, n) and x (B, n, s) -> (G * G) @ X (B, m, s);
    with ``transposed``, x (B, m, s) -> (G * G)^T @ X (B, n, s).  fp32
    contiguous."""
    if g.dim() != 3 or x.dim() != 3:
        raise ValueError(f"expected g (batch, m, n) and x (batch, ., s), "
                         f"got {tuple(g.shape)} and {tuple(x.shape)}")
    bsz, m, n = g.shape
    s = x.shape[-1]
    out_rows, depth = (n, m) if transposed else (m, n)
    cuda.check("g", g, (bsz, m, n))
    cuda.check("x", x, (bsz, depth, s))
    groups, per = cuda.split(-(-depth // KC), -(-out_rows // BO) * bsz,
                             cuda.sm_count(g))
    y = torch.empty((bsz, groups, out_rows, s), dtype=torch.float32,
                    device=g.device)
    err = _lib().sq_matmul_f32(g.data_ptr(), x.data_ptr(), y.data_ptr(), bsz,
                               m, n, s, int(transposed), groups, per,
                               cuda.stream(g))
    name = "sq_matmul_t" if transposed else "sq_matmul"
    cuda.raise_on(err, name)
    LAUNCHES[name] += 1
    return y[:, 0] if groups == 1 else y.sum(dim=1)
