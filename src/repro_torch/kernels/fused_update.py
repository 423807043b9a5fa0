"""CUDA kernels of the fused two-pass Adapprox update, bound with ctypes.

``csrc/fused_update.cu`` holds both kernels and a note on their design;
they replace ``fused_precond_pallas`` and ``fused_apply_pallas`` /
``fused_apply_shared_pallas`` of the JAX package's
``kernels/fused_update.py``.  The shared library is compiled by ``nvcc``
for ``sm_90a`` at first use into ``build/kernels/`` under the checkout
(listed in ``.gitignore``) and loaded with ``ctypes``; nothing is compiled
or imported from CUDA when this module is imported.

The wrappers take CUDA tensors only: each checks dtype, device, contiguity,
alignment and shape, allocates the outputs, launches on
``torch.cuda.current_stream()``, raises if the launch reports an error,
and adds one to ``LAUNCHES[<kernel>]``.  The plain versions live in
``kernels/ref.py``; ``kernels/ops.py`` picks between them by device.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels.ref import f32, f32_one_minus

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_update.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BM = 64                 # rows of one pass-1 tile (csrc BM)
BN = 64                 # columns owned by one pass-1 block (csrc BN)
R_ALIGN = 16            # pass 1 takes r in 16-deep slices (csrc KC)
R_MAX = 704             # the fold accumulator must fit in shared memory
THREADS = 256

# Launch counts per kernel, for showing that a run went through them.
LAUNCHES = {"fused_precond": 0, "fused_apply": 0}

_LIB = None
BUILD_LOG: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused-update kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/fused_update.cu`` unless an up-to-date library is
    already in ``build/kernels/``.  Returns the library path; the compiler's
    output (``-Xptxas -v`` register and spill report) and the build time
    land in ``BUILD_LOG``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / "libfused_update.so"
    if lib.exists() and lib.stat().st_mtime >= SOURCE.stat().st_mtime:
        BUILD_LOG.update(seconds=0.0, output="(cached)")
        return lib
    tmp = BUILD_DIR / f"libfused_update.{os.getpid()}.so"
    t0 = time.monotonic()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    BUILD_LOG.update(seconds=time.monotonic() - t0,
                     output=proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_precond_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                          i, i, f, f, f, i, p]
        lib.fused_precond_f32.restype = ctypes.c_int
        lib.fused_apply_f32.argtypes = [p, p, p, p, i, ctypes.c_longlong, i,
                                        p]
        lib.fused_apply_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    _check("q", q, (bsz, m, r))
    _check("u", u, (bsz, n, r))
    _check("g", g, (bsz, m, n))
    if m1 is not None:
        _check("m1", m1, (bsz, m, n))
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
        int(with_fold), _stream(g))
    _raise_on(err, "fused_precond")
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
    _check("u_hat", u_hat, (bsz, size))
    _check("m1", m1, (bsz, size))
    _check("scalars", scalars, (bsz, 5))
    out = None if shared_out else torch.empty_like(m1)
    blocks = max(1, min(-(-size // (4 * THREADS)), 4096))
    err = _lib().fused_apply_f32(
        u_hat.data_ptr(), m1.data_ptr(),
        None if out is None else out.data_ptr(), scalars.data_ptr(),
        bsz, size, blocks, _stream(m1))
    _raise_on(err, "fused_apply")
    LAUNCHES["fused_apply"] += 1
    return (m1 if out is None else out), m1
