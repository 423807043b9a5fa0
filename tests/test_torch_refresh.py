"""Adapprox's refresh knobs in the port against the JAX package: the warm
start of S-RSI, the implicit operator, bucketed leaves and the paper's
k_max (min(m, n) / 4) with the fold.

S-RSI draws JAX's own threefry sketches (``_JaxSketch`` and ``_jax_draws``
of the slice 1 tests), so the two packages differ only by rounding.
Inputs come from numpy seeds.  Tolerances are slice 1's, with their
reasons there (``test_torch_parity.py``, ``test_torch_srsi.py``): the
rank k exactly; the reconstruction Q U^T and the first moment within
1e-4 of each leaf's largest entry, xi within 1e-5 absolute, an update
within 1e-3; S-RSI's Q and U within 1e-4, Q U^T and cum_energy within
1e-5.  The implicit operator's products have no iteration behind them
and are held to 1e-6 of their largest entry.  Within the port, bucketed
execution equals the per-leaf loop bit for bit on the CPU, as the JAX
package's own test holds for it.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import srsi as JS
from repro.core.rank import RankConfig as JRankConfig
from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.core import srsi as S
from repro_torch.core.factored import FactoredLeaf, leaf_signature
from repro_torch.core.rank import RankConfig
from test_torch_parity import (_cfg_kw, _close_rel, _grads, _jax_params,
                               _JaxSketch)
from test_torch_srsi import _jax_draws, _second_moment
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

JA = importlib.import_module("repro.core.adapprox")
TA = importlib.import_module("repro_torch.core.adapprox")


def _fixed(draws: np.ndarray):
    def sketch(shape, generator):
        assert tuple(shape) == draws.shape
        return torch.tensor(draws)
    return sketch


def _warm_seed(rng, bd, n, r):
    """A right factor with its last two columns zero, as rank masking
    leaves them."""
    u0 = rng.standard_normal(bd + (n, r)).astype(np.float32)
    u0[..., -2:] = 0.0
    return u0


# ---------------------------------------------------------------------------
# S-RSI: warm start and the implicit operator
# ---------------------------------------------------------------------------

def test_warm_start_zero_u0_falls_back_to_gaussian():
    """All-zero warm columns take the Gaussian column: the warm run equals
    the cold one bit for bit (``tests/test_refresh.py``'s contract)."""
    a = torch.from_numpy(_second_moment(np.random.default_rng(2), (), 64,
                                        48))
    draws = _jax_draws(jax.random.PRNGKey(3), (), 48, 12)
    cold = S.srsi_dense(a, 8, 4, 2, _fixed(draws))
    warm = S.srsi_dense(a, 8, 4, 2, _fixed(draws), u0=torch.zeros((48, 8)),
                        use_warm=torch.tensor(True))
    assert torch.equal(cold.q, warm.q) and torch.equal(cold.u, warm.u)


def test_warm_start_drift_guard_rerandomizes():
    """``use_warm`` false (the drift guard) drops the seed for that matrix
    alone: per matrix of a stack, the guarded slices equal the cold run
    bit for bit, the others take the seed."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(_second_moment(rng, (3,), 64, 48))
    draws = _jax_draws(jax.random.PRNGKey(5), (3,), 48, 12)
    junk = torch.from_numpy(_warm_seed(rng, (3,), 48, 8))
    cold = S.srsi_dense(a, 8, 4, 2, _fixed(draws))
    guard = torch.tensor([False, True, False])
    mixed = S.srsi_dense(a, 8, 4, 2, _fixed(draws), u0=junk, use_warm=guard)
    for j in (0, 2):
        assert torch.equal(cold.q[j], mixed.q[j])
    assert not torch.equal(cold.q[1], mixed.q[1])


@pytest.mark.parametrize("bd", [(), (3,)])
def test_warm_srsi_matches_jax(bd):
    """One warm power iteration from a seed with zero columns, against
    JAX's per matrix with the same draws; in the stack the middle matrix
    has its guard tripped.  Held on what the optimizer consumes, Q U^T
    and cum_energy: after one iteration the weakest columns of Q are far
    from converged and CholeskyQR3 amplifies their rounding (one entry in
    1152 reads 1.4e-4 of the largest), which slice 1's 1e-4 on Q itself
    assumes five iterations to damp."""
    m, n, r, p = 96, 80, 12, 5
    rng = np.random.default_rng(6)
    a = _second_moment(rng, bd, m, n)
    u0 = _warm_seed(rng, bd, n, r)
    use = np.array([True, False, True][:bd[0]]) if bd else np.array(True)
    key = jax.random.PRNGKey(7)
    got = S.srsi_dense(torch.from_numpy(a), r, p, 1,
                       _fixed(_jax_draws(key, bd, n, r + p)),
                       u0=torch.from_numpy(u0), use_warm=torch.tensor(use))
    keys = jax.random.split(key, int(np.prod(bd))) if bd else [key]
    for j, idx in enumerate(np.ndindex(*bd)):
        want = JS.srsi_dense(jnp.asarray(a[idx]), r, p, 1, keys[j],
                             u0=jnp.asarray(u0[idx]),
                             use_warm=jnp.asarray(use[idx]))
        _close_rel(got.q[idx] @ got.u[idx].T, want.q @ want.u.T, 1e-5,
                   "Q U^T")
        _close_rel(got.cum_energy[idx], want.cum_energy, 1e-5, "cum")


def _implicit_inputs(bd, m, n, r, seed=8):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    mask = (np.arange(r) < r - 3).astype(np.float32)
    return (f(*bd, m, r, scale=3e-3), f(*bd, n, r, scale=3e-3),
            f(*bd, m, n, scale=1e-3), mask)


@pytest.mark.parametrize("m", [200, 1100])
def test_implicit_operator_matches_jax(m):
    """``ImplicitV.mv`` / ``rmv`` / ``frob_sq`` (streamed over 512-row
    slabs: 1100 rows is a ragged third slab) and ``materialize`` against
    JAX's, per matrix of a stack."""
    bd, n, r, s = (2,), 96, 10, 7
    q, u, g, mask = _implicit_inputs(bd, m, n, r)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(bd + (n, s)).astype(np.float32)
    y = rng.standard_normal(bd + (m, s)).astype(np.float32)
    tv = S.make_implicit_v(*map(torch.from_numpy, (q, u, g)), 0.999,
                           torch.from_numpy(mask))
    got = dict(mv=tv.mv(torch.from_numpy(x)), rmv=tv.rmv(torch.from_numpy(y)),
               frob=tv.frob_sq(), full=tv.materialize())
    for j in range(bd[0]):
        jv = JS.make_implicit_v(jnp.asarray(q[j]), jnp.asarray(u[j]),
                                jnp.asarray(g[j]), 0.999, jnp.asarray(mask))
        _close_rel(got["mv"][j], jv.mv(jnp.asarray(x[j])), 1e-6, "mv")
        _close_rel(got["rmv"][j], jv.rmv(jnp.asarray(y[j])), 1e-6, "rmv")
        _close_rel(got["full"][j], jv.materialize(), 1e-6, "materialize")
        np.testing.assert_allclose(float(got["frob"][j]),
                                   float(jv.frob_sq()), rtol=1e-5)
    assert torch.allclose(got["frob"], torch.sum(got["full"] ** 2, (-2, -1)),
                          rtol=1e-5, atol=0)


@pytest.mark.parametrize("frob", ["streamed", "given"])
def test_srsi_implicit_matches_jax(frob):
    """S-RSI on the implicit operator (5 cold iterations), with ||V||_F^2
    streamed or given, against JAX's with the same draws; then
    ``reconstruct`` and ``approx_error_rate`` at k = 1, 2 and 4 (above
    the ~1e-3 floor, where the two packages round alike)."""
    m, n, r, p = 96, 80, 12, 5
    q, u, g, _ = _implicit_inputs((), m, n, 6, seed=10)
    q, u = np.abs(q), np.abs(u)
    key = jax.random.PRNGKey(11)
    tv = S.make_implicit_v(*map(torch.from_numpy, (q, u, g)), 0.999)
    jv = JS.make_implicit_v(*map(jnp.asarray, (q, u, g)), 0.999)
    fs = tv.frob_sq() if frob == "given" else None
    got = S.srsi_implicit(tv, r, p, 5, _fixed(_jax_draws(key, (), n, r + p)),
                          frob_sq=fs)
    want = JS.srsi_implicit(jv, r, p, 5, key,
                            frob_sq=None if fs is None
                            else jnp.asarray(fs.numpy()))
    _close_rel(got.q @ got.u.T, want.q @ want.u.T, 1e-5, "Q U^T")
    _close_rel(got.cum_energy, want.cum_energy, 1e-5, "cum")
    mask = S.col_mask(r, torch.tensor(4))
    _close_rel(S.reconstruct(got.q, got.u, mask),
               JS.reconstruct(want.q, want.u, jnp.asarray(mask.numpy())),
               1e-5, "reconstruct")
    for k in (1, 2, 4):
        np.testing.assert_allclose(
            float(S.approx_error_rate(got, torch.tensor(k))),
            float(JS.approx_error_rate(want, jnp.asarray(k))), atol=1e-5)


# ---------------------------------------------------------------------------
# The optimizer: each knob against JAX over refresh and fold steps
# ---------------------------------------------------------------------------

KNOBS = {
    "warm_start": dict(warm_start=True, n_iter_warm=1),
    "warm_start-fused": dict(warm_start=True, n_iter_warm=2,
                             fused_update=True),
    "implicit": dict(implicit=True),
    "implicit-fused": dict(implicit=True, fused_update=True),
    "implicit-kernels": dict(implicit=True, use_kernels=True),
    "bucketed": dict(bucketed=True),
    "bucketed-warm-fused": dict(bucketed=True, warm_start=True,
                                fused_update=True),
    "kmax-fused": dict(fused_update=True),
}


@pytest.mark.parametrize("name", list(KNOBS))
def test_knob_matches_jax(name):
    """7 steps of the preconditioner on the GPT-2 smoke stack with fixed
    grads, refresh at t = 1, 4, 7 and folds between; "kmax" is the
    paper's k_max (k_max 10**9, so min(m, n) / 4 per leaf), the others
    the launcher's 128.  Ranks equal at every step; updates, first
    moments, Q U^T and xi within slice 1's tolerances."""
    steps = 7
    _, params_np = _jax_params()
    flat_np = tree.flatten(params_np)
    k_max = 10**9 if name.startswith("kmax") else 128
    kw = _cfg_kw(**KNOBS[name])
    jopt = JA.scale_by_adapprox(JA.AdapproxConfig(
        rank=JRankConfig(k_init=1, k_max=k_max, mode="paper"), **kw))
    sketch = _JaxSketch([v.shape for v in flat_np.values()], [1, 4, 7])
    topt = TA.scale_by_adapprox(TA.AdapproxConfig(
        rank=RankConfig(k_init=1, k_max=k_max, mode="paper"),
        sketch=sketch, **kw))
    jparams = jax.tree.map(jnp.asarray, params_np)
    tparams = tree.flatten(params_from_numpy(params_np))
    jst, tst = jopt.init(jparams), topt.init(tparams)
    jupdate = jax.jit(jopt.update)
    for t in range(1, steps + 1):
        g_np = _grads(flat_np, t)
        ju, jst = jupdate(tree.unflatten({k: jnp.asarray(v)
                                          for k, v in g_np.items()}),
                          jst, jparams)
        tu, tst = topt.update({k: torch.tensor(v) for k, v in g_np.items()},
                              tst, tparams)
        ju = tree.flatten(jax.device_get(ju))
        for k in flat_np:
            _close_rel(tu[k], ju[k], 1e-3, f"update {k} at step {t}")
        for k, jl, tl in zip(flat_np, jst.leaves, tst.leaves):
            if isinstance(tl, FactoredLeaf):
                np.testing.assert_array_equal(
                    tl.k.numpy(), np.asarray(jl.k), err_msg=f"k {k} t={t}")
    assert not sketch.calls
    n_fact = 0
    for k, jl, tl in zip(flat_np, jst.leaves, tst.leaves):
        jl = jax.device_get(jl)
        _close_rel(tl.m1, jl.m1, 1e-4, f"m1 {k}")
        if isinstance(tl, FactoredLeaf):
            n_fact += 1
            if name.startswith("kmax"):
                assert tl.q.shape[-1] == min(tl.q.shape[-2],
                                             tl.u.shape[-2]) // 4
            _close_rel(tl.q @ tl.u.transpose(-1, -2),
                       np.einsum("...mr,...nr->...mn", jl.q, jl.u), 1e-4,
                       f"Q U^T {k}")
            np.testing.assert_allclose(tl.xi.numpy(), jl.xi, atol=1e-5,
                                       err_msg=f"xi {k}")
    assert n_fact >= 5


def _port_run(cfg, flat, steps):
    opt = TA.scale_by_adapprox(cfg)
    st = opt.init(flat)
    outs = []
    for t in range(1, steps + 1):
        g = {k: torch.tensor(v) for k, v in _grads(
            {k: p.numpy() for k, p in flat.items()}, t).items()}
        u, st = opt.update(g, st, flat)
        outs.append(u)
    return outs, st


@pytest.mark.parametrize("extra", [dict(), dict(warm_start=True),
                                   dict(fused_update=True, warm_start=True),
                                   dict(factor_dtype="int8",
                                        fused_update=True)])
def test_bucketed_equals_per_leaf_bitwise(extra):
    """On the CPU a bucket (the smoke stack's wq and wo share (2, 64, 64))
    runs the per-leaf arithmetic batched: updates and every state field
    equal the per-leaf loop bit for bit over refresh and fold steps, and
    the seeded default sketch draws alike."""
    _, params_np = _jax_params()
    flat = tree.flatten(params_from_numpy(params_np))
    sigs = [leaf_signature(tuple(p.shape), p.dtype) for p in flat.values()
            if p.dim() >= 2 and min(p.shape[-2:]) >= 64]
    assert len(sigs) > len(set(sigs))
    rank = RankConfig(k_init=1, k_max=128, mode="paper")
    kw = _cfg_kw(**extra)
    a_out, a_st = _port_run(TA.AdapproxConfig(rank=rank, **kw), flat, 5)
    b_out, b_st = _port_run(TA.AdapproxConfig(rank=rank, bucketed=True,
                                              **kw), flat, 5)
    for ua, ub in zip(a_out, b_out):
        for k in ua:
            assert torch.equal(ua[k], ub[k]), k
    for la, lb in zip(a_st.leaves, b_st.leaves):
        for x, y in zip(dataclasses.astuple(la), dataclasses.astuple(lb)):
            xs = x if isinstance(x, tuple) else (x,)
            ys = y if isinstance(y, tuple) else (y,)
            for xx, yy in zip(xs, ys):
                assert (xx is None and yy is None) or torch.equal(xx, yy)
