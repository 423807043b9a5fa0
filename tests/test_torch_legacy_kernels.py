"""The port's ``use_kernels`` layer -- the single-pass update (B4), the
square-and-matmul (B3) and the fold built on it -- against the JAX
package's.

``repro_torch.kernels.ref`` (the plain versions the CUDA kernels are held
against on the card) is compared with ``repro.kernels.ref`` and with the
Pallas kernels run in interpret mode through the JAX dispatch
(``ops.set_mode("pallas")``, as ``tests/test_kernels.py`` runs them), on
ragged shapes; the port's dispatch on the CPU over a batch of matrices;
and the whole ``use_kernels`` Adapprox chain against JAX's.  The CUDA
kernels themselves run only on a GPU: ``chip_smoke.py`` compares them with
these plain versions there.  Inputs come from a numpy seed.

Tolerances, with their reasons:
  * both sides compute in float32 but sum Q U^T, (G^2)^T Q and ||V||_F^2
    in different orders: outputs within 1e-5 of their largest entry;
  * ``1 - b2``: ``ref.lowrank_update`` and ``one_sided_fold`` take the
    Python double rounded once to float32 in both packages (0.0010000000475
    for b2 = 0.999), but ``lowrank_update_pallas`` subtracts in float32
    (0.0009999871), 1.3e-5 relative apart.  Against the Pallas kernel V
    moves by up to that, so out (~V^-1/2) is held to 1e-5 and ||V||_F^2
    (~V^2) to 3e-5;
  * the chain: as ``test_torch_parity.py`` (one update within 1e-3 of its
    leaf's largest entry, Q U^T and the first moment within 1e-4, the rank
    k equal at every step).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rank import RankConfig as JRankConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.core.factored import FactoredLeaf
from repro_torch.core.rank import RankConfig
from repro_torch.kernels import lowrank_update as LU
from repro_torch.kernels import ops, ref
from repro_torch.kernels import srsi_matmul as SM
from test_torch_parity import _cfg_kw, _close_rel, _grads, _jax_params
from test_torch_parity import _JaxSketch

JA = importlib.import_module("repro.core.adapprox")
TA = importlib.import_module("repro_torch.core.adapprox")

B2, EPS = 0.999, 1e-8
# (m, n, r): none a multiple of 64 or 256, r not a multiple of 16
RAGGED = [(130, 258, 3), (300, 180, 6), (257, 129, 5)]


def _inputs(batch, m, n, r, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    # b2 Q U^T comparable to (1 - b2) G^2, with negative Q U^T entries for
    # the clamp
    return (f(*batch, m, r, scale=3e-3), f(*batch, n, r, scale=3e-3),
            f(*batch, m, n, scale=1e-3))


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rtol * float(np.max(np.abs(b))))


def _pallas(fn, *args, **kw):
    jops.set_mode("pallas")
    try:
        return fn(*(jnp.asarray(a) for a in args), **kw)
    finally:
        jops.set_mode("auto")


@pytest.mark.parametrize("m,n,r", RAGGED)
def test_lowrank_update_matches_jax(m, n, r):
    q, u, g = _inputs((), m, n, r)
    out, vfro = ref.lowrank_update(_t(q), _t(u), _t(g), B2, EPS)
    w_out, w_fro = jref.lowrank_update(q, u, g, B2, EPS)
    _close(out, w_out, 1e-5)
    _close(vfro, w_fro, 1e-5)
    p_out, p_fro = _pallas(jops.lowrank_update, q, u, g, B2, EPS,
                           with_frob=True)
    _close(out, p_out, 1e-5)
    _close(vfro, p_fro, 3e-5)


@pytest.mark.parametrize("m,n,s", RAGGED)
def test_sq_matmul_matches_jax(m, n, s):
    _, x, g = _inputs((), m, n, s, seed=1)
    y = _inputs((), m, n, s, seed=2)[0]
    got, got_t = ref.sq_matmul(_t(g), _t(x)), ref.sq_matmul_t(_t(g), _t(y))
    _close(got, jref.sq_matmul(g, x), 1e-5)
    _close(got_t, jref.sq_matmul_t(g, y), 1e-5)
    _close(got, _pallas(jops.sq_matmul, g, x), 1e-5)
    _close(got_t, _pallas(jops.sq_matmul_t, g, y), 1e-5)


@pytest.mark.parametrize("m,n,r", RAGGED)
def test_one_sided_fold_matches_jax(m, n, r):
    q, u, g = _inputs((), m, n, r, seed=3)
    mask = (np.arange(r) < r - 1).astype(np.float32)
    got = ref.one_sided_fold(_t(u), _t(q), _t(g), B2, _t(mask))
    _close(got, jref.one_sided_fold(u, q, g, B2, mask), 1e-5)
    _close(got, _pallas(jops.one_sided_fold, u, q, g, B2, col_mask=mask),
           1e-5)
    assert not got[:, -1].any()


def test_dispatch_batches_on_the_cpu():
    """ops over a (2, m, n) stack equals the plain version on each matrix,
    bitwise (the CPU dispatch is the plain version), and the fold's mask
    is per matrix."""
    q, u, g = (_t(x) for x in _inputs((2,), 130, 96, 5, seed=4))
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]],
                        dtype=torch.float32)
    out, vfro = ops.lowrank_update(q, u, g, B2, EPS, with_frob=True)
    assert torch.equal(ops.lowrank_update(q, u, g, B2, EPS), out)
    fold = ops.one_sided_fold(u, q, g, B2, mask)
    for i in range(2):
        o, f = ref.lowrank_update(q[i], u[i], g[i], B2, EPS)
        assert torch.equal(out[i], o) and torch.equal(vfro[i], f)
        assert torch.equal(ops.sq_matmul(g, u)[i], ref.sq_matmul(g[i], u[i]))
        assert torch.equal(ops.sq_matmul_t(g, q)[i],
                           ref.sq_matmul_t(g[i], q[i]))
        assert torch.equal(fold[i], ref.one_sided_fold(u[i], q[i], g[i], B2,
                                                       mask[i]))
    assert not fold[0, :, 3:].any()


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers check before they build or launch anything."""
    q, u, g = (_t(x) for x in _inputs((1,), 64, 64, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        LU.lowrank_update(q, u, g, B2, EPS)
    for transposed in (False, True):
        with pytest.raises(ValueError, match="CUDA tensor"):
            SM.sq_matmul(g, q, transposed)
    assert LU.LAUNCHES == {"lowrank_update": 0}
    assert SM.LAUNCHES == {"sq_matmul": 0, "sq_matmul_t": 0}


def test_use_kernels_chain_matches_jax():
    """7 steps of the use_kernels preconditioner (single-pass update every
    step, the fold through one_sided_fold) on the GPT-2 smoke stack with
    fixed grads, refresh at t = 1, 4, 7: updates and ranks at every step,
    factors and first moments at the end."""
    steps = 7
    _, params_np = _jax_params()
    flat_np = tree.flatten(params_np)
    kw = _cfg_kw(use_kernels=True)
    jopt = JA.scale_by_adapprox(JA.AdapproxConfig(
        rank=JRankConfig(k_init=1, k_max=128, mode="paper"), **kw))
    sketch = _JaxSketch([v.shape for v in flat_np.values()], [1, 4, 7])
    topt = TA.scale_by_adapprox(TA.AdapproxConfig(
        rank=RankConfig(k_init=1, k_max=128, mode="paper"), sketch=sketch,
        **kw))
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
    for k, jl, tl in zip(flat_np, jax.device_get(jst.leaves), tst.leaves):
        _close_rel(tl.m1, jl.m1, 1e-4, f"m1 {k}")
        if isinstance(tl, FactoredLeaf):
            _close_rel(tl.q @ tl.u.transpose(-1, -2),
                       np.einsum("...mr,...nr->...mn", jl.q, jl.u), 1e-4,
                       f"Q U^T {k}")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to tf32 (10 mantissa bits) to nearest, ties away
    from zero, by bit arithmetic on its pattern: ``cvt.rna.tf32.f32``."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _split3(a: torch.Tensor, b: torch.Tensor, rnd) -> torch.Tensor:
    """a @ b with each fp32 operand split into big = rnd(x) and small =
    rnd(x - big), as big.big + big.small + small.big: three products whose
    terms are exact in fp32, each summed in fp32, into one sum."""
    a_big, b_big = rnd(a), rnd(b)
    a_small, b_small = rnd(a - a_big), rnd(b - b_big)
    return a_big @ b_big + a_big @ b_small + a_small @ b_big


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m,n,s", [(768, 3072, 128), (257, 129, 5)])
def test_sq_matmul_kernel_arithmetic_holds_the_tolerance(m, n, s,
                                                         transposed):
    """The arithmetic decision of the square-and-matmul kernel
    (``csrc/srsi_matmul.cu``): G^2 (squared in fp32) and X split into
    tf32 big + small, three tf32 products into one fp32 sum (3xTF32), at a
    GPT-2 117M fold shape (an MLP leaf, s = r = 128) and a ragged one.  It
    holds ``chip_smoke.py``'s TOL_MATMUL (1e-5 of the largest entry)
    against the fp32 plain version; against an fp64 sum of the same fp32
    operands it reads at the plain fp32 product's own level (its fp32
    sums, ~3-7e-7 of the largest entry, outweigh the split's ~1e-7), and
    the same split done in bf16 (hi + lo, three bf16 products) reads
    ~5e-6, over 5x more."""
    from chip_smoke import TOL_MATMUL
    rng = np.random.default_rng(17)
    g = _t((rng.standard_normal((m, n)) * 1e-3).astype(np.float32))
    x = _t(rng.standard_normal((m if transposed else n, s)).astype(
        np.float32))
    g2 = g * g
    a = g2.transpose(0, 1) if transposed else g2
    want = (ref.sq_matmul_t(g, x) if transposed else ref.sq_matmul(g, x))
    exact = a.double() @ x.double()
    scale = float(exact.abs().max())
    err = lambda got: float((got.double() - exact).abs().max()) / scale
    tf32x3, bf16x3 = _split3(a, x, _tf32), _split3(a, x, _bf16)
    _close(tf32x3, want, TOL_MATMUL)
    assert err(tf32x3) < 2 * err(want), (err(tf32x3), err(want))
    assert err(bf16x3) > 5 * err(tf32x3), (err(bf16x3), err(tf32x3))
