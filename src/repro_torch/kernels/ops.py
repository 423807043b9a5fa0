"""Dispatch for the port's CUDA kernels, by the device of the tensors.

A tensor on the CPU takes the plain version in ``kernels/ref.py``; a CUDA
tensor launches the hand-written kernel in ``kernels/fused_update.py`` or
``kernels/sketch_update.py`` (or the launch raises); any other device
raises.  There is no mode switch and no fallback.  For the fused update,
the dispatch owns what the kernels do not: the leading batch axes of
stacked ``(..., m, n)`` leaves are flattened into one grid axis (one
launch per leaf), ``r`` is zero-padded to the kernel's 16-deep slices
(zero columns add nothing to Q U^T or to the fold), and the ragged edges of
``m`` and ``n`` are masked inside the kernel instead of padded here, so G
is never copied.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {t.device}")


def fused_precond(q: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                  b2: float, eps: float, m1: torch.Tensor | None = None,
                  with_vfro: bool = True, with_fold: bool = False):
    """Pass 1 of the fused update (see ``ref.fused_precond``) over any
    leading batch dims of (q, u, g, m1).  Returns ``(u_hat, vfro, usq,
    m1dot, m1sq, yfold)``; vfro is None unless ``with_vfro``, m1dot / m1sq
    are None without ``m1``, yfold is None unless ``with_fold``."""
    if not _on_cuda(g):
        return ref.fused_precond(q, u, g, b2, eps, m1=m1,
                                 with_vfro=with_vfro, with_fold=with_fold)
    from repro_torch.kernels import fused_update as K
    bd = tuple(g.shape[:-2])
    m, n = g.shape[-2:]
    r = q.shape[-1]
    pad = (-r) % K.R_ALIGN
    flat = lambda t: t.float().reshape((-1,) + tuple(t.shape[-2:]))
    rpad = lambda t: (F.pad(flat(t), (0, pad)) if pad else flat(t)
                      ).contiguous()
    qp, up = rpad(q), rpad(u)
    gp = flat(g).contiguous()
    mp = None if m1 is None else flat(m1).contiguous()
    out, sums, yfold = K.fused_precond(qp, up, gp, b2, eps, m1=mp,
                                       with_fold=with_fold)
    col = lambda i: sums[:, i].reshape(bd)
    return (out.reshape(bd + (m, n)),
            col(0) if with_vfro else None, col(1),
            None if m1 is None else col(2), None if m1 is None else col(3),
            None if yfold is None else yfold[..., :r].reshape(bd + (n, r)))


def fused_apply(u_hat: torch.Tensor, m1: torch.Tensor | None,
                denom: torch.Tensor, b1: float,
                out_scale: torch.Tensor, store_scale: torch.Tensor,
                shared_out: bool = False):
    """Pass 2 of the fused update (see ``ref.fused_apply``).  ``u_hat`` /
    ``m1``: (*batch, m, n); the three scalars: (*batch,).  On the card
    ``m1`` is updated in place.  ``shared_out=True`` (valid when
    out_scale == store_scale, i.e. guidance "off" or "stored") returns the
    same tensor as m_out and m1_new.  With ``m1`` None (b1 = 0) the pass is
    one scaled copy, which is plain tensor code on every device as in the
    JAX package's dispatch.  Returns ``(m_out, m1_new)``."""
    if m1 is None:
        return ref.fused_apply(u_hat, None, denom, b1, out_scale,
                               store_scale)
    if not _on_cuda(u_hat):
        out, m1n = ref.fused_apply(u_hat, m1, denom, b1, out_scale,
                                   store_scale)
        return (m1n, m1n) if shared_out else (out, m1n)
    from repro_torch.kernels import fused_update as K
    shape = u_hat.shape
    bsz = denom.numel()
    if not m1.is_contiguous():
        raise ValueError("m1: pass 2 updates it in place and needs a "
                         "contiguous tensor")
    f = lambda s: s.float().reshape(bsz)
    scalars = torch.stack([f(denom),
                           torch.full((bsz,), b1, dtype=torch.float32,
                                      device=m1.device),
                           torch.full((bsz,), 1.0 - b1, dtype=torch.float32,
                                      device=m1.device),
                           f(out_scale), f(store_scale)], dim=-1)
    m_out, _ = K.fused_apply(
        u_hat.float().reshape(bsz, -1).contiguous(), m1.view(bsz, -1),
        scalars, shared_out)
    return (m1 if shared_out else m_out.view(shape)), m1


def bucket_order(idx: torch.Tensor, width: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sketch scatter's index buffers for ``idx`` (depth, rows): the
    rows of each depth sorted by bucket, ascending within a bucket, and the
    bucket offsets (depth, width + 1), bucket b of depth j holding
    ``order[j, offsets[j, b]:offsets[j, b + 1]]``.  int32, on idx's
    device."""
    idx = idx.long()
    order = torch.sort(idx, dim=1, stable=True).indices
    counts = torch.zeros((idx.shape[0], width + 1), dtype=torch.long,
                         device=idx.device)
    counts[:, 1:].scatter_add_(1, idx, torch.ones_like(idx))
    offsets = torch.cumsum(counts, dim=1)
    return order.int().contiguous(), offsets.int().contiguous()


def sketch_update(table: torch.Tensor, g: torch.Tensor, idx: torch.Tensor,
                  b2: float, order: torch.Tensor | None = None,
                  offsets: torch.Tensor | None = None):
    """Count-min EMA scatter + min-over-depth query (see
    ``ref.sketch_update``).  table (depth, width, d) f32, g (rows, d), idx
    (depth, rows) int32.  On the card, ``order`` / ``offsets`` (from
    :func:`bucket_order`, built once per leaf) feed the scatter; they are
    built here when not given.  Returns ``(table_new, vhat)``."""
    if not _on_cuda(g):
        return ref.sketch_update(table, g, idx, b2)
    from repro_torch.kernels import sketch_update as SK
    if order is None or offsets is None:
        order, offsets = bucket_order(idx, table.shape[1])
    return SK.sketch_update(table.float().contiguous(),
                            g.float().contiguous(), idx.int().contiguous(),
                            order, offsets, b2)
