"""CUDA kernels of the fused two-pass Adapprox update, bound with ctypes.

``csrc/fused_update.cu`` holds both kernels and a note on their design;
they replace ``fused_precond_pallas`` and ``fused_apply_pallas`` /
``fused_apply_shared_pallas`` of the JAX package's
``kernels/fused_update.py``.  The shared library is compiled by ``nvcc``
for ``sm_90a`` at first use (``kernels/cuda.py``) and loaded with
``ctypes``; nothing is compiled or imported from CUDA when this module is
imported.

The wrappers take CUDA tensors only: each checks dtype, device, contiguity,
alignment and shape, allocates the outputs, launches on
``torch.cuda.current_stream()``, raises if the launch reports an error,
and adds one to ``LAUNCHES[<kernel>]``.  The plain versions live in
``kernels/ref.py``; ``kernels/ops.py`` picks between them by device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import f32, f32_one_minus

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_update.cu"

BM = 64                 # rows of one pass-1 tile (csrc BM)
BN = 64                 # columns owned by one pass-1 block (csrc BN)
R_ALIGN = 16            # pass 1 takes r in 16-deep slices (csrc KC)
R_MAX = 704             # the fold accumulator must fit in shared memory
THREADS = 256

# Launch counts per kernel, for showing that a run went through them.
LAUNCHES = {"fused_precond": 0, "fused_apply": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda.build(SOURCE)[0]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_precond_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                          i, i, f, f, f, i, p]
        lib.fused_precond_f32.restype = ctypes.c_int
        lib.fused_apply_f32.argtypes = [p, p, p, p, i, ctypes.c_longlong, i,
                                        p]
        lib.fused_apply_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def row_groups(m: int, n: int, batch: int, sm_count: int) -> tuple[int, int]:
    """(groups, tiles_per_group) for pass 1: enough 64-row groups per
    column strip that about two blocks per SM are in flight, and no more
    (every group writes one fold partial of n * r words)."""
    tiles_m = -(-m // BM)
    strips = -(-n // BN) * batch
    groups = min(tiles_m, max(1, -(-2 * sm_count // strips)))
    per = -(-tiles_m // groups)
    return -(-tiles_m // per), per


def fused_precond(q: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                  b2: float, eps: float, m1: torch.Tensor | None = None,
                  with_fold: bool = False):
    """Pass 1 on the card.  q (B, m, r), u (B, n, r), g / m1 (B, m, n),
    fp32 contiguous, r a multiple of 16.  Returns ``(u_hat (B, m, n),
    sums (B, 4) = [vfro, usq, m1dot, m1sq], yfold (B, n, r) | None)``."""
    if q.dim() != 3:
        raise ValueError(f"q: expected (batch, m, r), got {tuple(q.shape)}")
    bsz, m, r = q.shape
    n = u.shape[1]
    if r % R_ALIGN or r > R_MAX:
        raise ValueError(f"r = {r}: pass 1 takes a multiple of {R_ALIGN} "
                         f"up to {R_MAX}")
    cuda.check("q", q, (bsz, m, r))
    cuda.check("u", u, (bsz, n, r))
    cuda.check("g", g, (bsz, m, n))
    if m1 is not None:
        cuda.check("m1", m1, (bsz, m, n))
    dev = g.device
    groups, per = row_groups(
        m, n, bsz, torch.cuda.get_device_properties(dev).multi_processor_count)
    gn = -(-n // BN)
    out = torch.empty_like(g)
    part = torch.empty((bsz, groups, gn, 4), dtype=torch.float32, device=dev)
    yfold = (torch.empty((bsz, groups, n, r), dtype=torch.float32,
                         device=dev) if with_fold else None)
    err = _lib().fused_precond_f32(
        q.data_ptr(), u.data_ptr(), g.data_ptr(),
        None if m1 is None else m1.data_ptr(), out.data_ptr(),
        part.data_ptr(), None if yfold is None else yfold.data_ptr(),
        bsz, m, n, r, groups, per, f32(b2), f32_one_minus(b2), f32(eps),
        int(with_fold), cuda.stream(g))
    cuda.raise_on(err, "fused_precond")
    LAUNCHES["fused_precond"] += 1
    sums = part.sum(dim=(1, 2))
    if yfold is not None:
        yfold = yfold[:, 0] if groups == 1 else yfold.sum(dim=1)
    return out, sums, yfold


def fused_apply(u_hat: torch.Tensor, m1: torch.Tensor,
                scalars: torch.Tensor, shared_out: bool):
    """Pass 2 on the card.  u_hat / m1 (B, size) fp32 contiguous, scalars
    (B, 5) = [denom, b1, 1 - b1, out_scale, store_scale].  ``m1`` is
    updated in place to ``acc * store_scale``.  Returns ``(m_out, m1)``;
    with ``shared_out`` m_out IS m1 (one write instead of two)."""
    if u_hat.dim() != 2:
        raise ValueError(f"u_hat: expected (batch, size), got "
                         f"{tuple(u_hat.shape)}")
    bsz, size = u_hat.shape
    cuda.check("u_hat", u_hat, (bsz, size))
    cuda.check("m1", m1, (bsz, size))
    cuda.check("scalars", scalars, (bsz, 5))
    out = None if shared_out else torch.empty_like(m1)
    blocks = max(1, min(-(-size // (4 * THREADS)), 4096))
    err = _lib().fused_apply_f32(
        u_hat.data_ptr(), m1.data_ptr(),
        None if out is None else out.data_ptr(), scalars.data_ptr(),
        bsz, size, blocks, cuda.stream(m1))
    cuda.raise_on(err, "fused_apply")
    LAUNCHES["fused_apply"] += 1
    return (m1 if out is None else out), m1
