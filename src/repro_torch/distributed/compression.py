"""Low-rank gradient compression for the data-parallel sum: the JAX
package's ``distributed/compression.py`` on the port's S-RSI.

PowerSGD-style (Vogels et al.) rank-r compression with error feedback:

    g_hat = Q U^T          Q, U from S-RSI on (g + error)
    error <- g + error - g_hat            (error feedback keeps it unbiased
                                           in the long run)

A matrix's sum then moves O(r (m + n)) numbers instead of O(mn).  The
sketch comes from a pluggable ``SketchSource`` (``core/srsi.py``), called
once a compressed leaf and step with ``(*batch, n, rank)`` and a
generator seeded from ``(seed, step, leaf)``, so a test can feed it the
JAX package's draws (``fold_in(fold_in(PRNGKey(seed), step), leaf)``,
split once a matrix of a stacked leaf).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import srsi as S
from repro_torch.core.types import GradientTransformation


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    rank: int = 8
    min_dim: int = 128          # compress only matrices with min dim >= this
    n_iter: int = 1             # subspace iterations (PowerSGD uses 1)
    seed: int = 0


@dataclasses.dataclass
class CompressionState:
    step: int                   # counts from 0
    error: dict                 # {name: fp32 residual, or None}


def _compressible(shape, min_dim: int) -> bool:
    return len(shape) >= 2 and min(shape[-2], shape[-1]) >= min_dim


def sketch_generator(seed: int, step: int, leaf: int,
                     device) -> torch.Generator:
    """The generator the sketch of ``leaf`` at ``step`` is drawn from."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) * 1_000_003 + leaf + 1)


def compress_gradients(cfg: CompressionConfig,
                       sketch: Optional[S.SketchSource] = None
                       ) -> GradientTransformation:
    """A ``GradientTransformation`` that replaces each large matrix's
    gradient by its rank-``cfg.rank`` approximation plus error feedback.
    Chain it before the optimizer.  ``sketch`` replaces the Gaussian
    sketch source.  Its state is replicated on a mesh (no sharding hook,
    as in JAX)."""

    def init(params):
        return CompressionState(step=0, error={
            k: (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                if _compressible(p.shape, cfg.min_dim) else None)
            for k, p in params.items()})

    def update(grads, state: CompressionState, params):
        del params
        step = state.step + 1
        out, err = {}, {}
        for i, (k, g) in enumerate(grads.items()):
            e = state.error[k]
            if e is None:
                out[k], err[k] = g, None
                continue
            g32 = g.float() + e
            res = S.srsi_dense(
                g32, cfg.rank, 0, cfg.n_iter,
                sketch or S.torch_normal(g.device),
                sketch_generator(cfg.seed, step, i, g.device))
            g_hat = res.q @ res.u.transpose(-1, -2)
            out[k] = g_hat.to(g.dtype)
            err[k] = g32 - g_hat
        return out, CompressionState(step=step, error=err)

    return GradientTransformation(init, update)
