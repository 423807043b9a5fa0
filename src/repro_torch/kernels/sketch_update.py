"""CUDA kernels of the count-min sketch second moment, bound with ctypes.

``csrc/sketch_update.cu`` holds the two kernels and a note on their
design; together they replace ``sketch_update_pallas`` of the JAX
package's ``kernels/sketch_update.py``: the scatter (the sketch's EMA
update, one owner per bucket, no float atomics) and then the query (the
min over depth per row), two launches on the current stream, each over
64-column slices of d (:func:`column_slices`) in slice-major order.  The
library is built by ``nvcc`` at first use (``kernels/cuda.py``); nothing
is compiled or imported from CUDA when this module is imported.

The wrapper takes CUDA tensors only, checks them, allocates the outputs,
raises if a launch reports an error, and adds one to
``LAUNCHES["sketch_scatter"]`` and ``LAUNCHES["sketch_query"]`` as it
launches each.  The plain version is ``kernels/ref.py::sketch_update``;
``kernels/ops.py`` picks between them by device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import f32, f32_one_minus

SOURCE = Path(__file__).resolve().parent / "csrc" / "sketch_update.cu"

# Launch counts per kernel, for showing that a run went through them.
LAUNCHES = {"sketch_scatter": 0, "sketch_query": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda.build(SOURCE)[0]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sketch_scatter_f32.argtypes = [p, p, p, p, p, i, i, i, i, f, f,
                                           i, p]
        lib.sketch_scatter_f32.restype = ctypes.c_int
        lib.sketch_query_f32.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.sketch_query_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


SLICE = 64   # columns of d a slice: 16 lanes of 4 (csrc SW)


def column_slices(d: int) -> list[tuple[int, int]]:
    """The column ranges ``[start, stop)`` of d that the kernels' slices
    cover, in grid order: each at most ``SLICE`` wide, starting at a
    multiple of ``SLICE`` (of 4, so a lane's four columns are one 16-byte
    load when d % 4 == 0)."""
    return [(c, min(c + SLICE, d)) for c in range(0, d, SLICE)]


def sketch_update(table: torch.Tensor, g: torch.Tensor, idx: torch.Tensor,
                  order: torch.Tensor, offsets: torch.Tensor, b2: float,
                  reduce=None):
    """Scatter then query on the card.  table (depth, width, d) fp32, g
    (rows, d) fp32, idx / order (depth, rows) int32, offsets (depth, width
    + 1) int32 (see ``ops.bucket_order``), all contiguous.  Returns
    ``(table_new (depth, width, d), vhat (rows, d))``.

    ``reduce`` (g a row block of a leaf split over a mesh): the scatter
    sums this rank's rows into their buckets (b2 = 0 on a zero table, so
    the kernel's EMA is the sum itself), ``reduce`` adds the ranks' sums,
    the EMA is tensor code as in ``ref.sketch_update``, and the query
    reads the new table."""
    if table.dim() != 3 or g.dim() != 2:
        raise ValueError(f"expected table (depth, width, d) and g (rows, "
                         f"d), got {tuple(table.shape)} and "
                         f"{tuple(g.shape)}")
    depth, width, d = table.shape
    rows = g.shape[0]
    if min(depth, width, d, rows) < 1:
        raise ValueError(f"empty sketch: depth {depth}, width {width}, "
                         f"d {d}, rows {rows}")
    cuda.check("table", table, (depth, width, d))
    cuda.check("g", g, (rows, d))
    cuda.check("idx", idx, (depth, rows), torch.int32)
    cuda.check("order", order, (depth, rows), torch.int32)
    cuda.check("offsets", offsets, (depth, width + 1), torch.int32)
    vhat = torch.empty_like(g)
    slices, s = len(column_slices(d)), cuda.stream(g)
    lib = _lib()

    def scatter(tab, b, omb):
        out = torch.empty_like(tab)
        err = lib.sketch_scatter_f32(
            tab.data_ptr(), g.data_ptr(), order.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), rows, width, depth, d, b,
            omb, slices, s)
        cuda.raise_on(err, "sketch_scatter")
        LAUNCHES["sketch_scatter"] += 1
        return out

    if reduce is None:
        new = scatter(table, f32(b2), f32_one_minus(b2))
    else:
        sums = reduce(scatter(torch.zeros_like(table), 0.0, 1.0))
        new = f32(b2) * table + f32_one_minus(b2) * sums
    err = lib.sketch_query_f32(new.data_ptr(), idx.data_ptr(),
                               vhat.data_ptr(), rows, width, depth, d,
                               slices, s)
    cuda.raise_on(err, "sketch_query")
    LAUNCHES["sketch_query"] += 1
    return new, vhat
