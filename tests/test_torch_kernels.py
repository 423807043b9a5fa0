"""The port's fused-update layer against the JAX package's.

``repro_torch.kernels.ref`` (the plain versions that the CUDA kernels are
held against on the card) is compared with ``repro.kernels.ref`` and, for
one padded shape, with the Pallas kernels run in interpret mode.  The CUDA
kernels themselves only run on a GPU: ``chip_smoke.py`` compares them with
these plain versions there.  Inputs come from a numpy seed.

Tolerances: both sides compute in float32 but sum in different orders
(Q U^T, the fold product and the whole-matrix reductions), so elementwise
outputs are held to rtol 1e-5 and reductions to rtol 1e-5 relative to
their size; pass 2 has no reduction and must agree to 1 ulp-level
(rtol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantized as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import quantized_from_numpy
from repro_torch.core.quantized import quantize
from repro_torch.kernels import fused_update as K
from repro_torch.kernels import ops, ref

B2, EPS = 0.999, 1e-8


def _inputs(shape_b, m, n, r, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    # magnitudes where b2 * Q U^T and (1 - b2) G^2 are comparable, with
    # some negative Q U^T entries for the clamp
    q = f(*shape_b, m, r, scale=3e-3)
    u = f(*shape_b, n, r, scale=3e-3)
    g = f(*shape_b, m, n, scale=1e-3)
    m1 = f(*shape_b, m, n, scale=0.3)
    return q, u, g, m1


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("with_fold", [False, True])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_fused_precond_matches_jax_ref(guided, with_fold, batch):
    q, u, g, m1 = _inputs(batch, 96, 80, 16)
    got = ref.fused_precond(_t(q), _t(u), _t(g), B2, EPS,
                            m1=_t(m1) if guided else None,
                            with_vfro=True, with_fold=with_fold)
    for idx in np.ndindex(*batch):
        want = jref.fused_precond(q[idx], u[idx], g[idx], B2, EPS,
                                  m1=m1[idx] if guided else None,
                                  with_vfro=True, with_fold=with_fold)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                _close(a[idx], b, rtol=1e-5, atol=1e-5 * float(
                    np.max(np.abs(np.asarray(b)))))


def test_fused_precond_matches_pallas_interpret_padded():
    """One ragged shape (m, n, r not block- or lane-aligned) through the
    JAX dispatch in pallas mode, which pads and runs fused_precond_pallas
    with interpret=True: guided and fold riders together."""
    q, u, g, m1 = _inputs((), 100, 130, 12, seed=3)
    jops.set_mode("pallas")
    try:
        want = jops.fused_precond(jnp.asarray(q), jnp.asarray(u),
                                  jnp.asarray(g), B2, EPS,
                                  m1=jnp.asarray(m1), with_vfro=True,
                                  with_fold=True)
    finally:
        jops.set_mode("auto")
    got = ops.fused_precond(_t(q), _t(u), _t(g), B2, EPS, m1=_t(m1),
                            with_vfro=True, with_fold=True)
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-5,
               atol=1e-5 * float(np.max(np.abs(np.asarray(b)))))


@pytest.mark.parametrize("m,n,r", [(130, 258, 3), (300, 180, 6),
                                   (257, 129, 5)])
def test_fused_precond_int8_matches_jax(m, n, r):
    """Int8 factors (the codec's q8, scale, zero, carried over from JAX)
    through the port's dispatch, which dequantizes on the CPU, against the
    JAX dispatch in its ref mode (dequantize up front) and in pallas mode
    (the quantized fused_precond_pallas with its tile dequant _deq_tile,
    interpret=True): guided and fold riders together, ragged m, n and r.
    The dequantized factors are equal bit for bit (test_torch_quantized),
    so the tolerance is pass 1's.  Against the Pallas kernel the factors
    are non-negative: int8 factors of the signed inputs put Q U^T within
    1e-11 of 0 at some entries, where u_hat = G / sqrt(V) takes the
    rounding of the two sums apart -- the JAX package's own ref and
    Pallas paths differ by 2.6e-3 there."""
    q, u, g, m1 = _inputs((), m, n, r, seed=5)
    for factors, mode in (((q, u), "ref"),
                          ((np.abs(q), np.abs(u)), "pallas")):
        jq, ju = (JQ.quantize(jnp.asarray(f)) for f in factors)
        jops.set_mode(mode)
        try:
            want = jops.fused_precond(jq, ju, jnp.asarray(g), B2, EPS,
                                      m1=jnp.asarray(m1), with_vfro=True,
                                      with_fold=True)
        finally:
            jops.set_mode("auto")
        tq, tu = (quantized_from_numpy(jax.device_get(x)) for x in (jq, ju))
        got = ops.fused_precond(tq, tu, _t(g), B2, EPS, m1=_t(m1),
                                with_vfro=True, with_fold=True)
        for a, b in zip(got, want):
            _close(a, b, rtol=1e-5,
                   atol=1e-5 * float(np.max(np.abs(np.asarray(b)))))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("batch", [(), (2,)])
def test_fused_apply_matches_jax_ref(shared, batch):
    _, _, g, m1 = _inputs(batch, 48, 40, 4, seed=1)
    rng = np.random.default_rng(7)
    denom = (1.0 + rng.random(batch)).astype(np.float32)
    os_ = (0.5 + rng.random(batch)).astype(np.float32)
    ss = os_ if shared else np.ones(batch, np.float32)
    m_out, m1_new = ops.fused_apply(_t(g), _t(m1), _t(denom), 0.9, _t(os_),
                                    _t(ss), shared_out=shared)
    if shared:
        assert m_out is m1_new
    for idx in np.ndindex(*batch):
        w_out, w_m1 = jref.fused_apply(g[idx], m1[idx], denom[idx], 0.9,
                                       os_[idx], ss[idx])
        _close(m_out[idx], w_out, rtol=1e-6)
        _close(m1_new[idx], w_m1, rtol=1e-6)


def test_sq_matmul_t_matches_jax_ref():
    _, _, g, m1 = _inputs((), 64, 40, 4, seed=2)
    _close(ref.sq_matmul_t(_t(g), _t(m1)), jref.sq_matmul_t(g, m1),
           rtol=1e-5, atol=1e-11)


def test_dispatch_refuses_other_devices():
    """CPU tensors take the plain version; a tensor on any other device
    than CPU or CUDA raises instead of being moved."""
    q = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.fused_precond(q, q, torch.zeros((4, 4), device="meta"), B2, EPS)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers check before they build or launch anything."""
    q, u, g, m1 = (_t(x) for x in _inputs((1,), 64, 64, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fused_precond(q, u, g, B2, EPS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fused_precond(tuple(quantize(q)), tuple(quantize(u)), g, B2, EPS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fused_apply(g.reshape(1, -1), m1.reshape(1, -1),
                      torch.ones((1, 5)), shared_out=True)
    assert K.LAUNCHES == {"fused_precond": 0, "fused_precond_int8": 0,
                          "fused_apply": 0}


def test_row_groups_cover_every_tile():
    for m, n, b in [(50257, 768, 1), (768, 768, 12), (3072, 768, 12),
                    (100, 130, 1), (64, 64, 1)]:
        groups, per = K.row_groups(m, n, b, sm_count=132)
        tiles = -(-m // K.BM)
        assert groups * per >= tiles > (groups - 1) * per
