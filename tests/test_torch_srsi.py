"""S-RSI, CholeskyQR3 and adaptive rank of the port against the JAX
package, with the Gaussian sketch injected from JAX's own threefry draws.

Inputs come from a numpy seed.  Tolerances: both sides run the same fp32
arithmetic but sum matmuls and Gram matrices in different orders; five
power iterations and three CholeskyQR passes amplify those roundings in
the directions with the smallest captured energy, so Q and U are compared
after the iteration (rtol 1e-4 against the largest entry), the
reconstruction Q U^T and cum_energy at rtol 1e-5, and the chosen rank k
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rank as JR
from repro.core import srsi as JS
from repro_torch.core import rank as R
from repro_torch.core import srsi as S


def _second_moment(rng, bd, m, n, rank=6, noise=1e-3):
    """Non-negative, few dominant directions: like an Adam second moment."""
    a = rng.standard_normal(bd + (m, rank))
    b = rng.standard_normal(bd + (rank, n))
    scales = 10.0 ** (-np.arange(rank) / 2.0)
    base = (a * scales) @ b
    return (np.square(base) + noise * np.square(
        rng.standard_normal(bd + (m, n)))).astype(np.float32)


def _jax_draws(key, bd, n, r_total):
    """The draws JAX's S-RSI makes: one key per matrix of the stack."""
    if not bd:
        return np.asarray(jax.random.normal(key, (n, r_total), jnp.float32))
    keys = jax.random.split(key, int(np.prod(bd)))
    return np.stack([np.asarray(jax.random.normal(k, (n, r_total),
                                                  jnp.float32))
                     for k in keys]).reshape(bd + (n, r_total))


def _close_rel(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rtol * float(np.max(np.abs(b))))


def test_tri_inv_lower_matches_jax():
    rng = np.random.default_rng(0)
    low = np.tril(rng.standard_normal((12, 12))).astype(np.float32)
    low[np.diag_indices(12)] = 1.0 + rng.random(12)
    got = S._tri_inv_lower(torch.from_numpy(low))
    want = JS._tri_inv_lower(jnp.asarray(low))
    # column order against JAX's row order: the same substitution, each
    # row's terms subtracted one at a time instead of in one product
    _close_rel(got, want, 1e-6)
    # X L = I up to the inverse's growth on a random triangle
    _close_rel(got @ torch.from_numpy(low), np.eye(12), 1e-5)


@pytest.mark.parametrize("shape", [(257, 33), (2, 96, 21)])
def test_cholesky_qr2_matches_jax(shape):
    y = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = S.cholesky_qr2(torch.from_numpy(y))
    eye = np.eye(shape[-1], dtype=np.float32)
    np.testing.assert_allclose((got.transpose(-1, -2) @ got).numpy(),
                               np.broadcast_to(eye, got.shape[:-2] + eye.shape),
                               atol=1e-5)
    for idx in np.ndindex(*shape[:-2]):
        _close_rel(got[idx], JS.cholesky_qr2(jnp.asarray(y[idx])), 1e-5)


def test_cholesky_qr2_graded_columns_match_jax():
    """Column norms from 1 down to 1e-5 and one at 1e-8: the relative
    clamp (1e-6 x the largest norm) normalises the first kind and keeps
    the last near zero, as in the JAX package."""
    y = np.random.default_rng(5).standard_normal((128, 10)).astype(
        np.float32)
    y *= np.array([10.0 ** -k for k in (0, 1, 2, 3, 4, 5, 0, 1, 2, 8)],
                  np.float32)
    got = S.cholesky_qr2(torch.from_numpy(y))
    _close_rel(got, JS.cholesky_qr2(jnp.asarray(y)), 1e-5)


def test_cholesky_qr2_rank_deficient_no_nan():
    """A singular Gram matrix gives a NaN Cholesky in JAX and zeros in Q;
    the port's non-raising Cholesky keeps that behaviour."""
    q = S.cholesky_qr2(torch.zeros((64, 8)))
    assert torch.isfinite(q).all()
    want = np.asarray(JS.cholesky_qr2(jnp.zeros((64, 8))))
    np.testing.assert_array_equal(q.numpy(), want)


def test_card_forms_the_gram_in_float64(monkeypatch):
    """The card's CholeskyQR forms and factors its Gram in float64: its
    float32 GEMM rounded a power-iterated sketch's Gram by more than the
    1e-5 shift, the Cholesky failed and S-RSI zeroed the factors of most
    of GPT-2 117M w_down's matrices (chip_smoke.py ``[srsi]`` holds the
    card there).  The CPU keeps float32, bitwise the JAX package's route;
    the card's float64 route, run here on nearly parallel sketch columns,
    gives the same orthonormal Q within float32 rounding."""
    assert S.gram_dtype(torch.device("cuda")) == torch.float64
    assert S.gram_dtype(torch.device("cpu")) == torch.float32
    rng = np.random.default_rng(7)
    base = rng.standard_normal((1024, 1))
    y = torch.from_numpy((base + 1e-3 * rng.standard_normal((1024, 40)))
                         .astype(np.float32)).unsqueeze(0)
    narrow = S.cholesky_qr2(y)
    monkeypatch.setattr(S, "gram_dtype", lambda device: torch.float64)
    wide = S.cholesky_qr2(y)
    eye = torch.eye(40)
    for q in (narrow, wide):
        assert torch.isfinite(q).all() and float(q.abs().sum()) > 0
        assert float((q[0].T @ q[0] - eye).abs().max()) < 1e-4
    _close_rel(wide, narrow, 1e-3)


@pytest.mark.parametrize("bd", [(), (3,)])
def test_srsi_dense_matches_jax_with_injected_sketch(bd):
    m, n, r_store, p, n_iter = 96, 80, 12, 5, 5
    a = _second_moment(np.random.default_rng(2), bd, m, n)
    key = jax.random.PRNGKey(4)
    draws = _jax_draws(key, bd, n, r_store + p)

    def sketch(shape, generator):
        assert tuple(shape) == draws.shape
        return torch.tensor(draws)

    got = S.srsi_dense(torch.from_numpy(a), r_store, p, n_iter, sketch)
    keys = (jax.random.split(key, int(np.prod(bd))) if bd else [key])
    for j, idx in enumerate(np.ndindex(*bd)):
        want = JS.srsi_dense(jnp.asarray(a[idx]), r_store, p, n_iter,
                             keys[j])
        _close_rel(got.q[idx], want.q, 1e-4)
        _close_rel(got.u[idx], want.u, 1e-4)
        _close_rel(got.q[idx] @ got.u[idx].T, want.q @ want.u.T, 1e-5)
        _close_rel(got.cum_energy[idx], want.cum_energy, 1e-5)
        np.testing.assert_allclose(float(got.frob_sq[idx]),
                                   float(want.frob_sq), rtol=1e-6)


@pytest.mark.parametrize("mode", ["paper", "exact"])
@pytest.mark.parametrize("seed", range(4))
def test_select_rank_matches_jax_exactly(mode, seed):
    """Energy profiles from fast to flat decay, so the selected k ranges
    from k_init to k_max; the rank must agree exactly, xi to fp32."""
    rng = np.random.default_rng(seed)
    r, k_max = 24, 20
    decay = [0.2, 0.5, 0.8, 0.97][seed]
    col = (decay ** np.arange(r) * (1 + 0.1 * rng.random((3, r)))
           ).astype(np.float32)
    frob = (col.sum(-1) * (1 + 0.02 * rng.random(3))).astype(np.float32)
    cum = np.cumsum(col, -1).astype(np.float32)
    cfg_t = R.RankConfig(k_init=1, k_max=k_max, mode=mode)
    cfg_j = JR.RankConfig(k_init=1, k_max=k_max, mode=mode)
    k_prev = np.full(3, 5, np.int32)
    for step in (1, 2, 11):
        got = R.select_rank(torch.from_numpy(cum), torch.from_numpy(frob),
                            cfg_t, k_max, step, torch.from_numpy(k_prev))
        want = jax.vmap(lambda c, f, k: JR.select_rank(
            c, f, cfg_j, k_max, step, k))(cum, frob, k_prev)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        xi_t = R.xi_of_k(torch.from_numpy(cum), torch.from_numpy(frob), got)
        xi_j = jax.vmap(JR.xi_of_k)(cum, frob, want)
        np.testing.assert_allclose(xi_t.numpy(), np.asarray(xi_j),
                                   rtol=1e-5, atol=1e-7)


def test_select_rank_amortized_cadence_matches_jax():
    """With refresh_every = T > 1 the re-selection is counted in refresh
    indices; the port keeps the JAX rule step for step."""
    cum = np.cumsum(np.full((1, 16), 1.0, np.float32), -1)
    frob = np.full(1, 16.5, np.float32)
    cfg_t, cfg_j = R.RankConfig(k_init=1), JR.RankConfig(k_init=1)
    for step in range(1, 40, 3):
        got = R.select_rank(torch.from_numpy(cum), torch.from_numpy(frob),
                            cfg_t, 16, step,
                            torch.tensor([3], dtype=torch.int32),
                            refresh_every=3)
        want = JR.select_rank(jnp.asarray(cum[0]), jnp.asarray(frob[0]),
                              cfg_j, 16, step,
                              jnp.asarray(3, jnp.int32), refresh_every=3)
        assert int(got[0]) == int(want), step


def test_col_mask():
    m = S.col_mask(6, torch.tensor([0, 2, 6], dtype=torch.int32))
    want = np.stack([np.asarray(JS.col_mask(6, k)) for k in (0, 2, 6)])
    np.testing.assert_array_equal(m.numpy(), want)


def test_tri_inv_lower_cols_is_batch_invariant():
    """The column-order substitution: each matrix of a batch bitwise as it
    comes alone, and the inverse JAX's row form gives, to fp32 rounding."""
    rng = np.random.default_rng(1)
    low = np.tril(rng.standard_normal((5, 24, 24))).astype(np.float32)
    low[:, np.arange(24), np.arange(24)] = 1.0 + rng.random((5, 24))
    batched = S._tri_inv_lower(torch.from_numpy(low))
    for i in range(5):
        alone = S._tri_inv_lower(torch.from_numpy(low[i]))
        assert torch.equal(batched[i], alone), i
        _close_rel(alone, JS._tri_inv_lower(jnp.asarray(low[i])), 1e-6)


@pytest.mark.parametrize("op", ["dense", "implicit"])
def test_card_route_is_batch_invariant(monkeypatch, op):
    """S-RSI as the card runs it (``batch_invariant``: each matrix product,
    sum, scan and Cholesky one matrix at a time), forced
    on the CPU: a stack's matrices come out bitwise as each alone, and
    within 1e-5 of the batched CPU route's reconstruction."""
    rng = np.random.default_rng(2)
    bd, m, n, r, p = (3,), 48, 40, 6, 4
    a = torch.from_numpy(_second_moment(rng, bd, m, n))
    draw = torch.from_numpy(rng.standard_normal(bd + (n, r + p)).astype(
        np.float32))
    q0 = torch.from_numpy(rng.random(bd + (m, r)).astype(np.float32))
    u0 = torch.from_numpy(rng.random(bd + (n, r)).astype(np.float32))

    def run(i=None):
        pick = (lambda t: t) if i is None else (lambda t: t[i])
        source = lambda shape, gen: pick(draw)
        if op == "dense":
            return S.srsi_dense(pick(a), r, p, 3, source)
        v = S.make_implicit_v(pick(q0), pick(u0), pick(a), 0.999)
        return S.srsi_implicit(v, r, p, 3, source)

    cpu = run()
    monkeypatch.setattr(S, "batch_invariant", lambda device: True)
    card = run()
    for i in range(bd[0]):
        alone = run(i)
        for f in alone._fields:
            assert torch.equal(getattr(card, f)[i], getattr(alone, f)), (
                i, f)
    _close_rel(card.q @ card.u.transpose(-1, -2),
               cpu.q @ cpu.u.transpose(-1, -2), 1e-5)
