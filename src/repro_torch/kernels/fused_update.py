"""CUDA kernels of the fused two-pass Adapprox update, bound with ctypes.

``csrc/fused_update.cu`` holds both kernels and a note on their design
(pass 1's tile loop, on the tensor cores in 3xTF32, is
``csrc/pass1.cuh``); they replace
``fused_precond_pallas`` (its fp32 and int8 variants) and
``fused_apply_pallas`` / ``fused_apply_shared_pallas`` of the JAX
package's ``kernels/fused_update.py``.  The shared library is compiled by ``nvcc``
for ``sm_90a`` at first use (``kernels/cuda.py``) and loaded with
``ctypes``; nothing is compiled or imported from CUDA when this module is
imported.

The wrappers take CUDA tensors only: each checks dtype, device, contiguity,
alignment and shape, allocates the outputs, launches on
``torch.cuda.current_stream()``, raises if the launch reports an error,
and adds one to ``LAUNCHES[<kernel>]`` (the int8 pass 1 adds one to
``fused_precond`` and one to ``fused_precond_int8``).  The plain versions live in
``kernels/ref.py``; ``kernels/ops.py`` picks between them by device.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.quantized import BLOCK_ROWS
from repro_torch.kernels import cuda
from repro_torch.kernels.ref import f32, f32_one_minus

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_update.cu"

BM = 64                 # rows of one pass-1 tile (csrc BM)
BN = 128                # columns owned by one pass-1 block (csrc BN)
R_ALIGN = 16            # pass 1 takes r in multiples of 16
R_MAX = 128             # with the fold: its N, Q^T staged whole (csrc);
                        # ops.fused_precond takes wider folds from B3
APPLY_THREADS = 256     # threads of a pass-2 block (csrc APPLY_THREADS)

# Launch counts per kernel, for showing that a run went through them.
LAUNCHES = {"fused_precond": 0, "fused_precond_int8": 0, "fused_apply": 0}

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
        lib.fused_precond_int8.argtypes = [p] * 11 + [i] * 6 + [f, f, f, i,
                                                             p]
        lib.fused_precond_int8.restype = ctypes.c_int
        lib.fused_apply_f32.argtypes = [p, p, p, p, p, i, ctypes.c_longlong,
                                        i, p]
        lib.fused_apply_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def row_groups(m: int, n: int, batch: int, sm_count: int,
               fold: bool = False) -> tuple[int, int]:
    """(groups, tiles_per_group) for pass 1.  A block takes one group of
    64-row tiles of one 128-column strip of one matrix, and one block fits
    an SM (255 registers a thread), so the blocks run in waves of
    ``sm_count``: the split whose waves take the fewest tile times, with
    a fold partial counted as one more tile of its group; ties go to
    fewer groups (every group writes one fold partial of n * r words)."""
    tiles, strips = -(-m // BM), -(-n // BN) * batch
    best = None
    for per in range(tiles, 0, -1):
        groups = -(-tiles // per)
        cost = -(-strips * groups // sm_count) * (per + int(fold))
        if best is None or cost < best[0]:
            best = (cost, groups, per)
    return best[1], best[2]


def _factor_ptrs(name: str, f, rows: int, bsz: int, r: int) -> list:
    """Check one factor, fp32 (B, rows, r) or an int8 codec triple (q8 (B,
    rows, r) int8, scale / zero (B, ceil(rows / 256), r) fp32), and return
    its pointers."""
    if isinstance(f, torch.Tensor):
        cuda.check(name, f, (bsz, rows, r))
        return [f.data_ptr()]
    q8, scale, zero = f
    cells = (bsz, -(-rows // BLOCK_ROWS), r)
    cuda.check(f"{name}.q8", q8, (bsz, rows, r), torch.int8)
    cuda.check(f"{name}.scale", scale, cells)
    cuda.check(f"{name}.zero", zero, cells)
    return [q8.data_ptr(), scale.data_ptr(), zero.data_ptr()]


def fused_precond(q, u, g: torch.Tensor, b2: float, eps: float,
                  m1: torch.Tensor | None = None, with_fold: bool = False):
    """Pass 1 on the card.  q (B, m, r), u (B, n, r) fp32, or both int8
    codec triples ``(q8, scale, zero)`` (``core/quantized.py``'s layout,
    dequantized in the kernel); g / m1 (B, m, n) fp32; all contiguous, r a
    multiple of 16 (with the fold at most ``R_MAX``).  Returns ``(u_hat
    (B, m, n), sums (B, 4) = [vfro, usq, m1dot, m1sq], yfold (B, n, r) |
    None)``."""
    quant = not isinstance(q, torch.Tensor)
    q0 = q[0] if quant else q
    if q0.dim() != 3:
        raise ValueError(f"q: expected (batch, m, r), got {tuple(q0.shape)}")
    bsz, m, r = q0.shape
    n = g.shape[-1]
    # ops.fused_precond never asks for a fold wider than R_MAX: it runs
    # pass 1 without it and the fold through sq_matmul_t (ops.fold_in_pass1)
    if r % R_ALIGN or (with_fold and r > R_MAX):
        raise ValueError(f"r = {r}: pass 1 takes a multiple of {R_ALIGN}, "
                         f"with the fold up to {R_MAX}")
    if quant == isinstance(u, torch.Tensor):
        raise ValueError("q and u: both fp32 or both int8 codec triples")
    factors = (_factor_ptrs("q", q, m, bsz, r)
               + _factor_ptrs("u", u, n, bsz, r))
    cuda.check("g", g, (bsz, m, n))
    if m1 is not None:
        cuda.check("m1", m1, (bsz, m, n))
    dev = g.device
    groups, per = row_groups(m, n, bsz, cuda.sm_count(g), with_fold)
    gn = -(-n // BN)
    out = torch.empty_like(g)
    part = torch.empty((bsz, groups, gn, 4), dtype=torch.float32, device=dev)
    yfold = (torch.empty((bsz, groups, n, r), dtype=torch.float32,
                         device=dev) if with_fold else None)
    entry = _lib().fused_precond_int8 if quant else _lib().fused_precond_f32
    err = entry(
        *factors, g.data_ptr(), None if m1 is None else m1.data_ptr(),
        out.data_ptr(), part.data_ptr(),
        None if yfold is None else yfold.data_ptr(),
        bsz, m, n, r, groups, per, f32(b2), f32_one_minus(b2), f32(eps),
        int(with_fold), cuda.stream(g))
    cuda.raise_on(err, "fused_precond")
    LAUNCHES["fused_precond"] += 1
    if quant:
        LAUNCHES["fused_precond_int8"] += 1
    sums = part.sum(dim=(1, 2))
    if yfold is not None:
        yfold = yfold[:, 0] if groups == 1 else yfold.sum(dim=1)
    return out, sums, yfold


def fused_apply(u_hat: torch.Tensor, m1: torch.Tensor,
                scalars: torch.Tensor, shared_out: bool,
                m1_out: torch.Tensor | None = None):
    """Pass 2 on the card.  u_hat / m1 (B, size) fp32 contiguous, scalars
    (B, 5) = [denom, b1, 1 - b1, out_scale, store_scale].  The new first
    moment ``acc * store_scale`` is written into ``m1_out`` (B, size), or
    over ``m1`` in place when it is None.  Returns ``(m_out, m1_new)``;
    with ``shared_out`` m_out IS m1_new (one write instead of two)."""
    if u_hat.dim() != 2:
        raise ValueError(f"u_hat: expected (batch, size), got "
                         f"{tuple(u_hat.shape)}")
    bsz, size = u_hat.shape
    cuda.check("u_hat", u_hat, (bsz, size))
    cuda.check("m1", m1, (bsz, size))
    cuda.check("scalars", scalars, (bsz, 5))
    m1_new = m1 if m1_out is None else m1_out
    cuda.check("m1_out", m1_new, (bsz, size))
    out = None if shared_out else torch.empty_like(m1)
    blocks = max(1, min(-(-size // (4 * APPLY_THREADS)), 4096))
    err = _lib().fused_apply_f32(
        u_hat.data_ptr(), m1.data_ptr(), m1_new.data_ptr(),
        None if out is None else out.data_ptr(), scalars.data_ptr(),
        bsz, size, blocks, cuda.stream(m1))
    cuda.raise_on(err, "fused_apply")
    LAUNCHES["fused_apply"] += 1
    return (m1_new if out is None else out), m1_new
