"""Streamlined Randomized Subspace Iteration (S-RSI), Algorithm 1 of
Adapprox: feature matrices ``Q (m, k)``, ``U (n, k)`` with ``A ~= Q U^T``
for an elementwise non-negative target ``A`` (the second moment ``V_t``).

Orthonormalisation is shifted CholeskyQR3 (matmuls plus a small Cholesky),
as in the JAX package.  Every function takes leading batch dims: a stacked
``(L, m, n)`` leaf is one batched call.

Batched equals unbatched.  A stacked leaf's matrices must come out of
S-RSI bitwise as each would alone (the JAX package's contract, which lets
bucketed leaves equal the per-leaf loop).  On the CPU the batched torch
ops give that.  On the card they do not: cuBLAS, cuSOLVER and the
reductions pick other kernels for a batch than for one matrix (the
transposed GEMM, the float64 Gram, its Cholesky, the Frobenius sum and
cumsum each differed from one matrix alone on an H100, at GPT-2 117M's
w_down stack (12, 3072, 768); ``chip_smoke.py``'s ``[srsi]`` holds the
route to it).  So on the card (:func:`batch_invariant`) each matrix
product, sum, scan and Cholesky of S-RSI runs on one matrix at a time
(:func:`_each`), and the elementwise arithmetic around them stays
batched.  The triangular inverse is substitution in column order
(:func:`_tri_inv_lower`), whose steps are elementwise, so it runs batched
on every device.

On a mesh each function takes this rank's blocks of a split matrix and
its ``split`` (``core/blocks.py``): A U sums over the column axis, A^T Q,
CholeskyQR's column norms and Gram over the row axis, ||A||_F^2 over
both, the column energies of U over the column axis.  The card's
one-matrix-at-a-time route and its float64 Gram stay as they are; the
sums come after the local products.  Off a mesh every sum is the
identity.

The Gaussian sketch comes from a pluggable source, a callable
``(shape, generator) -> tensor``.  The default draws from the caller's
seeded ``torch.Generator``; tests inject the JAX package's own threefry
draws (through numpy) to hold the two packages against each other.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.blocks import WHOLE, Split
from repro_torch.core.rank import xi_of_k

SketchSource = Callable[[tuple, Optional[torch.Generator]], torch.Tensor]


def torch_normal(device: torch.device) -> SketchSource:
    """The default sketch source: standard normals from ``generator``."""
    return lambda shape, generator: torch.randn(
        shape, generator=generator, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# One matrix at a time on the card
# ---------------------------------------------------------------------------

def batch_invariant(device: torch.device) -> bool:
    """Whether S-RSI runs its matrix products, sums, scans and Cholesky
    one matrix at a time (:func:`_each`): on the card, where the batched
    library calls round otherwise than the single ones; not on the CPU."""
    return device.type == "cuda"


def _alone(t: torch.Tensor) -> torch.Tensor:
    """A slice as a matrix of its own would be: a 256-byte aligned start
    (what the allocator gives), so no kernel picks another path for it."""
    return t if t.data_ptr() % 256 == 0 else t.clone()


def _each(fn: Callable, *xs: torch.Tensor, core: int = 2):
    """``fn`` of the last ``core`` dims of ``xs`` (which share their
    leading batch dims): one call per matrix, stacked (each tensor of a
    tuple that ``fn`` returns on its own), where :func:`batch_invariant`;
    one batched call elsewhere."""
    bd = xs[0].shape[:xs[0].dim() - core]
    if not batch_invariant(xs[0].device):
        return fn(*xs)
    if not bd:
        return fn(*(_alone(x) for x in xs))
    flat = [x.reshape((-1,) + tuple(x.shape[x.dim() - core:])) for x in xs]
    outs = [fn(*(_alone(f[i]) for f in flat))
            for i in range(flat[0].shape[0])]

    def stack(parts):
        out = torch.stack(parts)
        return out.reshape(tuple(bd) + tuple(out.shape[1:]))

    if isinstance(outs[0], tuple):
        return tuple(stack(list(parts)) for parts in zip(*outs))
    return stack(outs)


# ---------------------------------------------------------------------------
# Orthonormalisation: CholeskyQR3
# ---------------------------------------------------------------------------

def _tri_inv_lower(l: torch.Tensor) -> torch.Tensor:
    """Inverse of (*batch, r, r) lower-triangular matrices by forward
    substitution in column order: once row j of the inverse is known, its
    term leaves every later row's right-hand side,

        X[j] = B[j] / L[j, j],   B[i] -= L[i, j] X[j]  (i > j),  B = I,

    computed in place in B.  The JAX package uses substitution rather than
    trsm so that batched and unbatched runs agree bitwise; here each step
    is elementwise over (*batch, r, r), so every matrix of a batch rounds
    as it would alone, on any device.  JAX sums each row's terms in one
    matrix product (row order), this form subtracts them one at a time: the
    two agree to float32 rounding.  r is the sketch width (<= k_max + p)."""
    r = l.shape[-1]
    x = torch.eye(r, dtype=l.dtype, device=l.device).expand(
        l.shape).clone()
    for j in range(r):
        x[..., j, :] /= l[..., j, j:j + 1]
        x[..., j + 1:, :] -= l[..., j + 1:, j:j + 1] * x[..., j:j + 1, :]
    return x


def _cholesky(gram: torch.Tensor) -> torch.Tensor:
    """Cholesky factor that, like ``jnp.linalg.cholesky``, is all-NaN for a
    matrix that is not positive definite instead of raising; factored one
    matrix at a time where :func:`batch_invariant`."""
    chol, info = _each(torch.linalg.cholesky_ex, gram)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)


def gram_dtype(device: torch.device) -> torch.dtype:
    """The dtype CholeskyQR forms and factors its Gram matrix in: float64
    on the card, float32 (the JAX package's) on the CPU; see
    :func:`_cholesky_qr`."""
    return torch.float64 if device.type == "cuda" else torch.float32


def _cholesky_qr(y: torch.Tensor, shift_rel: float = 1e-5,
                 rows: Callable = lambda x: x) -> torch.Tensor:
    """One shifted CholeskyQR pass over (*batch, m, r): column scaling with
    a relative clamp at 1e-6 * max column norm, a trace-relative diagonal
    shift, and non-finite entries of Q zeroed (a collapsed sketch column is
    dropped).

    On the card the Gram matrix is formed and factored in float64 and the
    factor rounded to float32; the CPU forms it in float32, the JAX
    package's arithmetic, which the parity tests hold it to.  The sketch
    columns can be nearly parallel (always after a power iteration), and
    then the shift (1e-5 of a unit diagonal) is all that keeps the Gram
    positive definite.  Formed in float32 (dot products over m or n
    terms), the Gram's rounding can exceed the shift: its Cholesky then
    fails whether factored in float32 or float64, the factor is NaN, the
    finite mask below zeroes Q, and a zero Q stays zero through every
    later pass (its Gram is the shift alone), so S-RSI returns zero
    factors (xi 1).  At GPT-2 117M's full width the card's float32 GEMM
    did so on 8 and 11 of w_down's 12 matrices at refresh steps 1 and 6,
    and the CPU's on one of wo's at step 11 (``chip_smoke.py`` ``[srsi]``;
    ROADMAP Queue C).  Formed in float64 from the same float32 columns,
    the Gram is their inner products to float64 rounding, which the shift
    keeps positive definite.  ``rows`` sums a product over the rows of a
    row-split ``y`` (on a mesh)."""
    y32 = y.float()
    col = torch.sqrt(rows(
        _each(lambda m: torch.sum(m, dim=-2), torch.square(y32))) + 1e-30)
    col = torch.maximum(col, 1e-6 * torch.amax(col, dim=-1, keepdim=True)
                        + 1e-30)
    ys = y32 / col.unsqueeze(-2)
    wide = gram_dtype(y.device)
    yw = ys.to(wide)
    gram = rows(_each(lambda m: m.transpose(-1, -2) @ m, yw))
    r = gram.shape[-1]
    gram = gram + (shift_rel + 1e-30) * torch.eye(r, dtype=wide,
                                                  device=y.device)
    chol = _cholesky(gram).float()
    q = _each(lambda a, t: a @ t.transpose(-1, -2), ys,
              _tri_inv_lower(chol))
    return torch.where(torch.isfinite(q), q, torch.zeros_like(q))


def cholesky_qr2(y: torch.Tensor, rows: Callable = lambda x: x
                 ) -> torch.Tensor:
    """Shifted CholeskyQR3: three passes, shifts 1e-5, 1e-6, 1e-6."""
    return _cholesky_qr(_cholesky_qr(_cholesky_qr(y, 1e-5, rows), 1e-6,
                                     rows), 1e-6, rows)


# ---------------------------------------------------------------------------
# Second-moment operator
# ---------------------------------------------------------------------------

class ImplicitV(NamedTuple):
    """``V = b2 * (Q U^T) + (1 - b2) * G * G`` over (*batch, ...) factors,
    with ``b2`` a float32 scalar and ``col_mask`` (r,) selecting the active
    factor columns.  ``mv`` / ``rmv`` apply V without forming it, so the
    implicit S-RSI runs in O((m + n) r) memory beside G.  On a mesh the
    tensors are this rank's blocks and ``split`` the matrix's: each
    product is a partial over the split axis it crosses, summed."""

    q: torch.Tensor
    u: torch.Tensor
    g: torch.Tensor
    b2: torch.Tensor
    col_mask: torch.Tensor
    split: Split = WHOLE

    @property
    def shape(self):
        return tuple(self.g.shape)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """V @ x for x (*batch, n, s)."""
        g32 = self.g.float()
        qm = self.q * self.col_mask
        low = _each(lambda q, u, b: q @ (u.transpose(-1, -2) @ b),
                    qm, self.u, x)
        sq = _each(lambda g, b: (g * g) @ b, g32, x)
        return self.split.cols(self.b2 * low + (1.0 - self.b2) * sq)

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """V^T @ y for y (*batch, m, s); V is not symmetric."""
        g32 = self.g.float()
        um = self.u * self.col_mask
        low = _each(lambda u, q, b: u @ (q.transpose(-1, -2) @ b),
                    um, self.q, y)
        sq = _each(lambda g, b: (g * g).transpose(-1, -2) @ b, g32, y)
        return self.split.rows(self.b2 * low + (1.0 - self.b2) * sq)

    def materialize(self) -> torch.Tensor:
        """Clamp the low-rank term (not the sum) at zero before adding the
        fresh G^2, which keeps the floor V >= (1 - b2) G^2."""
        g32 = self.g.float()
        qm = self.q * self.col_mask
        low = torch.clamp_min(qm @ self.u.transpose(-1, -2), 0.0)
        return self.b2 * low + (1.0 - self.b2) * g32 * g32

    def frob_sq(self, row_tile: int = 512) -> torch.Tensor:
        """||V||_F^2 per matrix, (*batch,), streamed over ``row_tile``-row
        slabs of Q and G, so no more than (row_tile, n) of V exists at a
        time; the clamp is applied slab by slab.  One matrix at a time
        where :func:`batch_invariant`."""

        def one(q, u, g):
            g32 = g.float()
            qm = q * self.col_mask
            ut = u.transpose(-1, -2)
            total = None
            for r0 in range(0, g32.shape[-2], row_tile):
                gb = g32[..., r0:r0 + row_tile, :]
                v = (self.b2 * torch.clamp_min(
                    qm[..., r0:r0 + row_tile, :] @ ut, 0.0)
                     + (1.0 - self.b2) * gb * gb)
                part = torch.sum(torch.square(v), dim=(-2, -1))
                total = part if total is None else total + part
            return total

        return self.split.both(_each(one, self.q, self.u, self.g))


def make_implicit_v(q, u, g, b2, col_mask=None,
                    split: Split = WHOLE) -> ImplicitV:
    if col_mask is None:
        col_mask = torch.ones(q.shape[-1], dtype=torch.float32,
                              device=q.device)
    return ImplicitV(q.float(), u.float(), g,
                     torch.tensor(b2, dtype=torch.float32, device=q.device),
                     col_mask.float(), split)


# ---------------------------------------------------------------------------
# S-RSI proper
# ---------------------------------------------------------------------------

class SRSIResult(NamedTuple):
    q: torch.Tensor            # (*batch, m, r_store)
    u: torch.Tensor            # (*batch, n, r_store)
    cum_energy: torch.Tensor   # (*batch, r_store): ||U[:, :j+1]||_F^2
    frob_sq: torch.Tensor      # (*batch,) ||A||_F^2


def _srsi_core(matmul_a: Callable[[torch.Tensor], torch.Tensor],
               matmul_at: Callable[[torch.Tensor], torch.Tensor],
               frob_sq: torch.Tensor, n: int, r_store: int, oversample: int,
               n_iter: int, sketch: SketchSource,
               generator: Optional[torch.Generator],
               u0: Optional[torch.Tensor] = None,
               use_warm: Optional[torch.Tensor] = None,
               split: Split = WHOLE) -> SRSIResult:
    """l rounds of  Q <- orth(A U); U <- A^T Q  on A / ||A||_F, sampling
    ``r_store + oversample`` Gaussian columns and truncating to
    ``r_store``; ``matmul_a(x (*batch, n, s)) -> (*batch, m, s)`` and
    ``matmul_at(y (*batch, m, s)) -> (*batch, n, s)`` apply A.  Outputs
    are rescaled to A's units.

    Warm start: ``u0`` (*batch, n, r_store) seeds the first ``r_store``
    sketch columns in place of the Gaussian ones, except its all-zero
    columns, which keep their Gaussian column; the ``oversample`` columns
    are always fresh.  ``use_warm`` (*batch,) bool keeps the Gaussian
    sketch for the matrices where it is false (the caller's drift
    guard).  The Gaussian sketch is drawn either way, so the draws are
    the same whether or not the warm seed is taken.

    On a mesh ``n`` and the sketch are the block's (the caller hands
    every rank its block of one whole draw) and ``split`` sums U's
    column energies over the column axis and CholeskyQR's over the row
    axis; ``matmul_a`` / ``matmul_at`` sum their own."""
    bd = tuple(frob_sq.shape)
    want = bd + (n, r_store + oversample)
    u = sketch(want, generator)
    if tuple(u.shape) != want:
        raise ValueError(f"sketch source returned shape {tuple(u.shape)}, "
                         f"expected {want}")
    u = u.to(device=frob_sq.device, dtype=torch.float32)
    col_sq = lambda m: split.cols(_each(lambda c: torch.sum(c, dim=-2),
                                        torch.square(m)))
    if u0 is not None:
        r_warm = u0.shape[-1]
        u032 = u0.float()
        col_ok = (col_sq(u032) > 0.0).unsqueeze(-2)
        warm = torch.cat([torch.where(col_ok, u032, u[..., :r_warm]),
                          u[..., r_warm:]], dim=-1)
        if use_warm is not None:
            warm = torch.where(use_warm.reshape(bd + (1, 1)), warm, u)
        u = warm
    scale = torch.sqrt(frob_sq) + 1e-30
    inv = (1.0 / scale).reshape(bd + (1, 1))
    for _ in range(n_iter):
        q = cholesky_qr2(matmul_a(u) * inv, split.rows)
        u = matmul_at(q) * inv
    q = q[..., :r_store]
    u = u[..., :r_store] * scale.reshape(bd + (1, 1))
    col_energy = col_sq(u * inv)
    cum_energy = _each(lambda c: torch.cumsum(c, dim=-1), col_energy,
                       core=1) * frob_sq.unsqueeze(-1)
    return SRSIResult(q=q, u=u, cum_energy=cum_energy, frob_sq=frob_sq)


def srsi_dense(a: torch.Tensor, r_store: int, oversample: int, n_iter: int,
               sketch: SketchSource,
               generator: Optional[torch.Generator] = None,
               u0: Optional[torch.Tensor] = None,
               use_warm: Optional[torch.Tensor] = None,
               split: Split = WHOLE) -> SRSIResult:
    """Paper-faithful S-RSI on explicit targets ``a: (*batch, m, n)``;
    ``u0`` / ``use_warm``: the warm start of :func:`_srsi_core`; ``split``
    a's on a mesh, ``a`` this rank's block."""
    a32 = a.float()
    return _srsi_core(
        lambda x: split.cols(_each(lambda m, b: m @ b, a32, x)),
        lambda y: split.rows(_each(lambda m, b: m.transpose(-1, -2) @ b,
                                   a32, y)),
        split.both(_each(lambda m: torch.sum(torch.square(m),
                                             dim=(-2, -1)), a32)),
        a.shape[-1], r_store, oversample, n_iter, sketch, generator, u0=u0,
        use_warm=use_warm, split=split)


def srsi_implicit(v: ImplicitV, r_store: int, oversample: int, n_iter: int,
                  sketch: SketchSource,
                  generator: Optional[torch.Generator] = None,
                  frob_sq: Optional[torch.Tensor] = None,
                  u0: Optional[torch.Tensor] = None,
                  use_warm: Optional[torch.Tensor] = None) -> SRSIResult:
    """S-RSI on the implicit operator: V is never formed (the streaming
    ``frob_sq`` runs unless the caller has ||V||_F^2 already)."""
    if frob_sq is None:
        frob_sq = v.frob_sq()
    return _srsi_core(v.mv, v.rmv, frob_sq,
                      v.shape[-1], r_store, oversample, n_iter, sketch,
                      generator, u0=u0, use_warm=use_warm, split=v.split)


def reconstruct(q: torch.Tensor, u: torch.Tensor,
                col_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Q diag(mask) U^T`` clamped at zero."""
    q32 = q.float()
    if col_mask is not None:
        q32 = q32 * col_mask.unsqueeze(-2)
    return torch.clamp_min(q32 @ u.float().transpose(-1, -2), 0.0)


def approx_error_rate(res: SRSIResult, k: torch.Tensor) -> torch.Tensor:
    """xi(k) = ||A - Q_k U_k^T||_F / ||A||_F by the projection identity
    ||A - Q_k Q_k^T A||_F^2 = ||A||_F^2 - ||Q_k^T A||_F^2, per matrix;
    CholeskyQR3's ~1e-6 orthonormality error puts its floor near 1e-3."""
    return xi_of_k(res.cum_energy, res.frob_sq, k)


def col_mask(r_store: int, k: torch.Tensor) -> torch.Tensor:
    """(*batch, r_store) float32 mask with the first ``k`` entries = 1."""
    ar = torch.arange(r_store, device=k.device)
    return (ar < k.unsqueeze(-1)).float()
