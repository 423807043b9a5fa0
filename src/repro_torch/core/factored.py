"""Per-leaf state layout and factorisation policy for Adapprox.

A parameter with >= 2 trailing dims whose smaller trailing dim is at least
``min_dim`` gets a factored second moment (Q, U, k); everything else
(biases, norms, scalars) keeps a dense second moment.  Leading dims
(scan-stacked layers ``(L, m, n)``) are batch dims: one batched call covers
the whole stack.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quantized import QuantizedMatrix


@dataclasses.dataclass
class FactoredLeaf:
    """q: (*batch, m, r_store) f32 left factor (columns past k zeroed);
    u: (*batch, n, r_store) f32 right factor -- with int8 factors both are
    ``core.quantized.QuantizedMatrix``; k: (*batch,) int32 effective
    rank; xi: (*batch,) f32 last approximation error rate; m1: (*batch, m,
    n) f32 running average of updates, or None (b1 = 0)."""

    q: torch.Tensor | QuantizedMatrix
    u: torch.Tensor | QuantizedMatrix
    k: torch.Tensor
    xi: torch.Tensor
    m1: Optional[torch.Tensor]


@dataclasses.dataclass
class DenseLeaf:
    """Dense second moment ``v`` and first moment ``m1`` (or None)."""

    v: torch.Tensor
    m1: Optional[torch.Tensor]


def should_factor(shape: tuple[int, ...], min_dim: int) -> bool:
    if len(shape) < 2:
        return False
    return min(shape[-2], shape[-1]) >= min_dim


def batch_dims(shape: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(shape[:-2])


def leaf_signature(shape: tuple[int, ...], g_dtype: torch.dtype) -> tuple:
    """Bucketing key of a factored leaf: two leaves can run as one stacked
    call iff their shapes (batch dims included) and gradient dtypes
    agree; r_store, the oversample and k_max follow from the shape."""
    return (tuple(shape), str(g_dtype).removeprefix("torch."))
