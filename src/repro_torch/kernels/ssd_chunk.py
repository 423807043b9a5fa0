"""CUDA kernels of the Mamba2 SSD intra-chunk block (forward and recompute
backward), bound with ctypes.

``csrc/ssd_chunk.cu`` holds the three kernels and a note on their design;
together they replace ``ssd_chunk_pallas`` of the JAX package's
``kernels/ssd_chunk.py`` (a forward only) and the differentiated jnp path
of its ``models/mamba2.py::ssd_chunked``: the forward, then for the
backward the rows kernel (dC, dh_in and the row part of dcums) and the
columns kernel (dX, dB, ddt, dcums and the partials of dd_skip), two
launches on the current stream.  The library is built by ``nvcc`` at
first use (``kernels/cuda.py``); nothing is compiled or imported from CUDA
when this module is imported.

The wrappers take contiguous CUDA tensors in the model's layout (x (B, S,
H, P) and b / c (B, S, G, N) fp32 or bf16 alike, dt / cums (B, S, H), h_in
(B, nc, H, N, P) and d_skip (H,) fp32; P, N <= 128), check them, allocate
the outputs, raise if a launch reports an error, and add one to
``LAUNCHES["ssd_fwd"]``, ``["ssd_bwd_rows"]`` or ``["ssd_bwd_cols"]`` as
they launch each.  The per-head dB and dC are summed over each group's
heads, and the dd_skip partials over the tiles, here by torch's sums,
which repeat bit for bit.  The plain versions are
``kernels/ref.py::ssd_chunk`` and ``ssd_chunk_bwd``; ``kernels/ops.py``
picks between them by device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import cuda

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"

# Launch counts per kernel, for showing that a run went through them.
LAUNCHES = {"ssd_fwd": 0, "ssd_bwd_rows": 0, "ssd_bwd_cols": 0}

MAX_WIDTH = 128         # P and N
TILE = 64               # rows of the kernels' tiles
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda.build(SOURCE)[0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        dims = [i] * 7 + [p]
        lib.ssd_fwd.argtypes = [i] + [p] * 8 + dims
        lib.ssd_bwd.argtypes = [i, i] + [p] * 16 + dims
        lib.ssd_fwd.restype = lib.ssd_bwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _dims(x, b, c, dt, cums, h_in, d_skip):
    """Check the inputs and return (dtype code, B, S, H, G, P, N, nc)."""
    if x.dim() != 4 or b.dim() != 4 or h_in.dim() != 5:
        raise ValueError(f"expected x (B, S, H, P), b / c (B, S, G, N), "
                         f"h_in (B, nc, H, N, P), got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}, {tuple(h_in.shape)}")
    bt, s, h, p = x.shape
    g, n = b.shape[2:]
    nc = h_in.shape[1]
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_chunk takes fp32 or bf16 x / b / c, got "
                         f"{x.dtype}")
    if (min(bt, s, h, g, p, n, nc) < 1 or h % g or s % nc
            or max(p, n) > MAX_WIDTH):
        raise ValueError(f"ssd_chunk: B {bt}, S {s}, H {h}, G {g}, P {p}, "
                         f"N {n}, nc {nc}: needs G | H, nc | S and P, N <= "
                         f"{MAX_WIDTH}")
    cuda.check("x", x, (bt, s, h, p), x.dtype)
    cuda.check("b", b, (bt, s, g, n), x.dtype)
    cuda.check("c", c, (bt, s, g, n), x.dtype)
    cuda.check("dt", dt, (bt, s, h))
    cuda.check("cums", cums, (bt, s, h))
    cuda.check("h_in", h_in, (bt, nc, h, n, p))
    cuda.check("d_skip", d_skip, (h,))
    return DTYPES[x.dtype], bt, s, h, g, p, n, nc


def forward(x, b, c, dt, cums, h_in, d_skip) -> torch.Tensor:
    """Returns y (B, S, H, P) fp32, the skip term included."""
    code, *dims = _dims(x, b, c, dt, cums, h_in, d_skip)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    err = _lib().ssd_fwd(code, x.data_ptr(), b.data_ptr(), c.data_ptr(),
                         dt.data_ptr(), cums.data_ptr(), h_in.data_ptr(),
                         d_skip.data_ptr(), y.data_ptr(), *dims,
                         cuda.stream(x))
    cuda.raise_on(err, "ssd_fwd")
    LAUNCHES["ssd_fwd"] += 1
    return y


def backward(x, b, c, dt, cums, h_in, d_skip, dy):
    """The rows kernel, then the columns kernel, from the forward's inputs
    and the output's gradient ``dy`` (B, S, H, P) fp32.  Returns ``(dx,
    db, dc, ddt, dcums, dh_in, dd_skip)`` in the dtypes of the inputs."""
    code, bt, s, h, g, p, n, nc = _dims(x, b, c, dt, cums, h_in, d_skip)
    cuda.check("dy", dy, tuple(x.shape))
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=x.device)
    tiles = -(-(s // nc) // TILE)
    dc_h, db_h = f32(bt, s, h, n), f32(bt, s, h, n)
    dcums_row, ddt, dcums = f32(bt, s, h), f32(bt, s, h), f32(bt, s, h)
    dh_in = torch.empty_like(h_in)
    dx = torch.empty_like(x)
    skip = f32(bt * nc, h, tiles)
    ptrs = [t.data_ptr() for t in (x, b, c, dt, cums, h_in, d_skip, dy,
                                   dc_h, dcums_row, dh_in, dx, db_h, ddt,
                                   dcums, skip)]
    lib = _lib()
    for which, name in enumerate(("ssd_bwd_rows", "ssd_bwd_cols")):
        err = lib.ssd_bwd(code, which, *ptrs, bt, s, h, g, p, n, nc,
                          cuda.stream(x))
        cuda.raise_on(err, name)
        LAUNCHES[name] += 1
    group = lambda t: t.view(bt, s, g, h // g, n).sum(3).to(x.dtype)
    return (dx, group(db_h), group(dc_h), ddt, dcums, dh_in,
            skip.sum((0, 2)))
