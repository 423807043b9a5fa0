"""Int8 storage of the Adapprox factors (the JAX package's
``core/quantized.py``, copied arithmetic for arithmetic).

The stored factors Q (m, r) and U (n, r) are kept as int8 with one fp32
(scale, zero) pair per (block of ``BLOCK_ROWS`` rows, column):

    scale = (amax - amin) / 254 + 1e-30
    zero  = amin
    q8    = clip(round((x - zero) / scale), 0, 254) - 127     (int8)
    deq   = (q8 + 127) * scale + zero

The ragged last block takes its min and max over zero-padded rows, so the
all-zero init is exact (scale = 1e-30, zero = 0, deq == 0).  ``round`` is
half to even in both frameworks.  On the card the int8 pass 1
(``kernels/csrc/fused_update.cu``) dequantizes its factor slices with this
formula as it loads them, a row's cell at ``row // BLOCK_ROWS``, with
``__fmul_rn`` / ``__fadd_rn`` so that no fma contraction separates it from
:func:`dequantize`; a change here must be made there too.

Plain tensor code on any device, with leading batch dims.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

BLOCK_ROWS = 256


class QuantizedMatrix(NamedTuple):
    q8: torch.Tensor       # (..., m, r) int8, offset by -127
    scale: torch.Tensor    # (..., nb, r) f32, nb = ceil(m / BLOCK_ROWS)
    zero: torch.Tensor     # (..., nb, r) f32 per-block per-column minimum


def _expand(blocked: torch.Tensor, m: int) -> torch.Tensor:
    """(..., nb, r) block cells -> (..., m, r) per-row broadcast."""
    return torch.repeat_interleave(blocked, BLOCK_ROWS, dim=-2)[..., :m, :]


def quantize(x: torch.Tensor) -> QuantizedMatrix:
    """Asymmetric per-(row-block, column) affine int8 of (..., m, r)."""
    m, r = x.shape[-2], x.shape[-1]
    x = x.float()
    xp = F.pad(x, (0, 0, 0, (-m) % BLOCK_ROWS))
    nb = xp.shape[-2] // BLOCK_ROWS
    blocks = xp.reshape(xp.shape[:-2] + (nb, BLOCK_ROWS, r))
    amin = torch.amin(blocks, dim=-2)
    amax = torch.amax(blocks, dim=-2)
    scale = (amax - amin) / 254.0 + 1e-30
    q = torch.round((x - _expand(amin, m)) / _expand(scale, m))
    q8 = (torch.clamp(q, 0.0, 254.0) - 127.0).to(torch.int8)
    return QuantizedMatrix(q8=q8, scale=scale, zero=amin)


def dequantize(qm: QuantizedMatrix) -> torch.Tensor:
    m = qm.q8.shape[-2]
    return ((qm.q8.float() + 127.0) * _expand(qm.scale, m)
            + _expand(qm.zero, m))


def quantize_tree_factors(q: torch.Tensor, u: torch.Tensor
                          ) -> tuple[QuantizedMatrix, QuantizedMatrix]:
    """Both factors of a leaf, as the optimizer stores them after a step."""
    return quantize(q), quantize(u)
