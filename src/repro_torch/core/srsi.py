"""Streamlined Randomized Subspace Iteration (S-RSI), Algorithm 1 of
Adapprox: feature matrices ``Q (m, k)``, ``U (n, k)`` with ``A ~= Q U^T``
for an elementwise non-negative target ``A`` (the second moment ``V_t``).

Orthonormalisation is shifted CholeskyQR3 (matmuls plus a small Cholesky),
as in the JAX package.  Every function takes leading batch dims: a stacked
``(L, m, n)`` leaf is one batched call.

The Gaussian sketch comes from a pluggable source, a callable
``(shape, generator) -> tensor``.  The default draws from the caller's
seeded ``torch.Generator``; tests inject the JAX package's own threefry
draws (through numpy) to hold the two packages against each other.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

SketchSource = Callable[[tuple, Optional[torch.Generator]], torch.Tensor]


def torch_normal(device: torch.device) -> SketchSource:
    """The default sketch source: standard normals from ``generator``."""
    return lambda shape, generator: torch.randn(
        shape, generator=generator, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Orthonormalisation: CholeskyQR3
# ---------------------------------------------------------------------------

def _tri_inv_lower(l: torch.Tensor) -> torch.Tensor:
    """Inverse of (*batch, r, r) lower-triangular matrices by row-wise
    forward substitution:  X[i] = (e_i - L[i] @ X) / L[i, i].

    The JAX package uses substitution rather than trsm so that batched and
    unbatched runs agree bitwise; the port keeps the same arithmetic so the
    two packages round alike.  r is the sketch width (<= k_max + p)."""
    r = l.shape[-1]
    eye = torch.eye(r, dtype=l.dtype, device=l.device)
    x = torch.zeros_like(l)
    for i in range(r):
        row = (eye[i] - (l[..., i:i + 1, :] @ x)[..., 0, :]) / l[..., i, i:i + 1]
        x[..., i, :] = row
    return x


def _cholesky(gram: torch.Tensor) -> torch.Tensor:
    """Cholesky factor that, like ``jnp.linalg.cholesky``, is all-NaN for a
    matrix that is not positive definite instead of raising."""
    chol, info = torch.linalg.cholesky_ex(gram)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)


def _cholesky_qr(y: torch.Tensor, shift_rel: float = 1e-5) -> torch.Tensor:
    """One shifted CholeskyQR pass over (*batch, m, r): column scaling with
    a relative clamp at 1e-6 * max column norm, a trace-relative diagonal
    shift, and non-finite entries of Q zeroed (a collapsed sketch column is
    dropped)."""
    y32 = y.float()
    col = torch.sqrt(torch.sum(torch.square(y32), dim=-2) + 1e-30)
    col = torch.maximum(col, 1e-6 * torch.amax(col, dim=-1, keepdim=True)
                        + 1e-30)
    ys = y32 / col.unsqueeze(-2)
    gram = ys.transpose(-1, -2) @ ys
    r = gram.shape[-1]
    gram = gram + (shift_rel + 1e-30) * torch.eye(
        r, dtype=torch.float32, device=y.device)
    q = ys @ _tri_inv_lower(_cholesky(gram)).transpose(-1, -2)
    return torch.where(torch.isfinite(q), q, torch.zeros_like(q))


def cholesky_qr2(y: torch.Tensor) -> torch.Tensor:
    """Shifted CholeskyQR3: three passes, shifts 1e-5, 1e-6, 1e-6."""
    return _cholesky_qr(_cholesky_qr(_cholesky_qr(y, 1e-5), 1e-6), 1e-6)


# ---------------------------------------------------------------------------
# Second-moment operator
# ---------------------------------------------------------------------------

class ImplicitV(NamedTuple):
    """``V = b2 * (Q U^T) + (1 - b2) * G * G`` over (*batch, ...) factors,
    with ``b2`` a float32 scalar and ``col_mask`` (r,) selecting the active
    factor columns."""

    q: torch.Tensor
    u: torch.Tensor
    g: torch.Tensor
    b2: torch.Tensor
    col_mask: torch.Tensor

    def materialize(self) -> torch.Tensor:
        """Clamp the low-rank term (not the sum) at zero before adding the
        fresh G^2, which keeps the floor V >= (1 - b2) G^2."""
        g32 = self.g.float()
        qm = self.q * self.col_mask
        low = torch.clamp_min(qm @ self.u.transpose(-1, -2), 0.0)
        return self.b2 * low + (1.0 - self.b2) * g32 * g32


def make_implicit_v(q, u, g, b2, col_mask=None) -> ImplicitV:
    if col_mask is None:
        col_mask = torch.ones(q.shape[-1], dtype=torch.float32,
                              device=q.device)
    return ImplicitV(q.float(), u.float(), g,
                     torch.tensor(b2, dtype=torch.float32, device=q.device),
                     col_mask.float())


# ---------------------------------------------------------------------------
# S-RSI proper
# ---------------------------------------------------------------------------

class SRSIResult(NamedTuple):
    q: torch.Tensor            # (*batch, m, r_store)
    u: torch.Tensor            # (*batch, n, r_store)
    cum_energy: torch.Tensor   # (*batch, r_store): ||U[:, :j+1]||_F^2
    frob_sq: torch.Tensor      # (*batch,) ||A||_F^2


def _srsi_core(a: torch.Tensor, frob_sq: torch.Tensor, r_store: int,
               oversample: int, n_iter: int, sketch: SketchSource,
               generator: Optional[torch.Generator]) -> SRSIResult:
    """l rounds of  Q <- orth(A U); U <- A^T Q  on A / ||A||_F, sampling
    ``r_store + oversample`` Gaussian columns and truncating to
    ``r_store``.  Outputs are rescaled to A's units."""
    bd = tuple(a.shape[:-2])
    n = a.shape[-1]
    scale = torch.sqrt(frob_sq) + 1e-30
    inv = (1.0 / scale).reshape(bd + (1, 1))
    u = sketch(bd + (n, r_store + oversample), generator)
    if tuple(u.shape) != bd + (n, r_store + oversample):
        raise ValueError(f"sketch source returned shape {tuple(u.shape)}, "
                         f"expected {bd + (n, r_store + oversample)}")
    u = u.to(device=a.device, dtype=torch.float32)
    at = a.transpose(-1, -2)
    for _ in range(n_iter):
        q = cholesky_qr2((a @ u) * inv)
        u = (at @ q) * inv
    q = q[..., :r_store]
    u = u[..., :r_store] * scale.reshape(bd + (1, 1))
    col_energy = torch.sum(torch.square(u * inv), dim=-2)
    cum_energy = torch.cumsum(col_energy, dim=-1) * frob_sq.unsqueeze(-1)
    return SRSIResult(q=q, u=u, cum_energy=cum_energy, frob_sq=frob_sq)


def srsi_dense(a: torch.Tensor, r_store: int, oversample: int, n_iter: int,
               sketch: SketchSource,
               generator: Optional[torch.Generator] = None) -> SRSIResult:
    """Paper-faithful S-RSI on explicit targets ``a: (*batch, m, n)``."""
    a32 = a.float()
    return _srsi_core(a32, torch.sum(torch.square(a32), dim=(-2, -1)),
                      r_store, oversample, n_iter, sketch, generator)


def col_mask(r_store: int, k: torch.Tensor) -> torch.Tensor:
    """(*batch, r_store) float32 mask with the first ``k`` entries = 1."""
    ar = torch.arange(r_store, device=k.device)
    return (ar < k.unsqueeze(-1)).float()
