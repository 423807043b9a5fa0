"""What the port's CUDA kernel wrappers share: the ``nvcc`` build and the
checks around a launch.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>.so`` under the
checkout (listed in ``.gitignore``), compiled for ``sm_90a`` with a plain C
interface that the kernel modules load with ``ctypes``.  A library newer
than its source and than every header beside it (``csrc/*.cuh``) is
reused.  :func:`build` starts one ``nvcc`` per source
that needs it, all at once, and waits for them together; nothing is built
when this module is imported.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Per source stem: {"seconds": build time, "output": nvcc's output (the
# -Xptxas -v register and spill report)}, or "(cached)".
BUILD_LOG: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def library(source: Path) -> Path:
    return BUILD_DIR / f"lib{source.stem}.so"


def build(*sources: Path) -> list[Path]:
    """Compile every source whose library is missing or older than it, one
    ``nvcc`` process each, all started together.  Returns the libraries'
    paths in the order of ``sources``; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        lib = library(src)
        newest = max(p.stat().st_mtime
                     for p in [src, *src.parent.glob("*.cuh")])
        if lib.exists() and lib.stat().st_mtime >= newest:
            BUILD_LOG[src.stem] = dict(seconds=0.0, output="(cached)")
            continue
        tmp = BUILD_DIR / f"lib{src.stem}.{os.getpid()}.so"
        log = BUILD_DIR / f"lib{src.stem}.{os.getpid()}.log"
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=out, stderr=subprocess.STDOUT)
        jobs.append((src, lib, tmp, log, proc, time.monotonic()))
    failed = []
    for src, lib, tmp, log, proc, t0 in jobs:
        rc = proc.wait()
        output = log.read_text()
        log.unlink()
        BUILD_LOG[src.stem] = dict(seconds=time.monotonic() - t0,
                                   output=output)
        if rc != 0:
            failed.append(f"nvcc failed on {src}:\n{output}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library(s) for s in sources]


def split(work: int, blocks: int, sm_count: int) -> tuple[int, int]:
    """Split ``work`` units (row tiles, contraction slices) of each of
    ``blocks`` blocks into groups, each its own block, so that about two
    blocks per SM are in flight, and no more (every group writes a partial
    that is summed after the launch).  Returns ``(groups,
    units_per_group)``; the last group may hold fewer."""
    groups = min(work, max(1, -(-2 * sm_count // blocks)))
    per = -(-work // groups)
    return -(-work // per), per


def sm_count(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def check(name: str, t: torch.Tensor, shape: tuple,
          dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` and ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the pointer ctypes takes."""
    return torch.cuda.current_stream(t.device).cuda_stream
