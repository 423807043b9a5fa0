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
from repro_torch.core.quantized import dequantize, quantize
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


def test_row_groups_fill_whole_waves():
    """Pass 1 runs one block an SM, so its blocks run in waves of the SM
    count: the chosen split of each leaf's row tiles costs no more tile
    times, whole waves counted, than one group or than the
    two-blocks-an-SM split of ``cuda.split`` (a fold partial counted as a
    tile); at GPT-2's w_up without the fold, 27 against 36."""
    from repro_torch.kernels import cuda
    sm = 132

    def cost(m, n, b, groups, per, fold):
        return -(-(-(-n // K.BN) * b * groups) // sm) * (per + int(fold))

    for m, n, b in [(768, 3072, 12), (3072, 768, 12), (768, 768, 12),
                    (50257, 768, 1), (1024, 4384, 48), (2048, 1024, 48)]:
        tiles = -(-m // K.BM)
        for fold in (False, True):
            groups, per = K.row_groups(m, n, b, sm, fold)
            assert groups * per >= tiles > (groups - 1) * per
            got = cost(m, n, b, groups, per, fold)
            assert got <= cost(m, n, b, 1, tiles, fold)
            assert got <= cost(m, n, b, *cuda.split(tiles, -(-n // K.BN) * b,
                                                    sm), fold)
    assert cost(768, 3072, 12, *K.row_groups(768, 3072, 12, sm), False) == 27
    assert cost(768, 3072, 12, 1, 12, False) == 36


def _emulated_pass1(q, u, g, rnd):
    """Pass 1 as ``csrc/pass1.cuh`` computes it, its products emulated: Q
    U^T and (G^2)^T Q each with both fp32 operands split into big =
    rnd(x) and small = rnd(x - big) (rnd: tf32 for the kernel, bf16 for
    the rejected alternative), three products; V, u_hat and the sums in
    fp32.  Returns ``(u_hat, vfro, usq, yfold, Q U^T)``."""
    from test_torch_legacy_kernels import _split3
    low = _split3(q, u.transpose(0, 1), rnd)
    g2 = g * g
    yfold = _split3(g2.transpose(0, 1), q, rnd)
    v = (ref.f32(B2) * torch.clamp_min(low, 0.0)
         + ref.f32_one_minus(B2) * g2)
    out = g / (torch.sqrt(v) + EPS)
    return out, torch.sum(v * v), torch.sum(out * out), yfold, low


@pytest.mark.parametrize("codec", ["fp32", "int8"])
@pytest.mark.parametrize("m,n,r", [(768, 3072, 128), (1024, 4384, 128),
                                   (257, 129, 5)])
def test_pass1_kernel_arithmetic_holds_the_tolerance(m, n, r, codec):
    """The arithmetic decision of pass 1's kernels (``csrc/pass1.cuh``:
    B1 fp32 and int8, B4): both products in 3xTF32, at a GPT-2 117M leaf
    (``w_up``, r = 128), Mamba2-370m's ``in_proj`` slice and a ragged
    shape, on fp32 factors and on the int8 codec of the same factors
    (dequantized as the kernel stages them, bit for bit).

    On the non-negative factors that ``chip_smoke.py`` draws (no
    cancellation in Q U^T) the emulation holds ``TOL_PRECOND`` for u_hat
    and ``TOL_SUMS`` for the sums and yfold against ``ref.fused_precond``
    (it reads ~3e-7 and ~1e-6).  On signed factors, where Q U^T cancels
    around 0 as a real S-RSI state's does, u_hat is ill-conditioned
    (plain fp32 itself reads ~1e-2 of the largest u_hat off an fp64 pass 1
    there), so the products are held in the condition-free measure, each
    entry's error over the sum of its terms' magnitudes (|Q| |U|^T,
    (G^2)^T |Q|), against fp64.  At r = 128 (and in every fold, which
    sums m terms) the split reads at plain fp32's own level (0.8-1.3x) and
    is held within 2x of it.  At r = 5 plain fp32 rounds a 5-term sum a
    few times and reads ~2 ulp, while the split keeps ~2^-22 of every
    term (the dropped small.small and the rounding of each small part), so
    it reads 2-4x plain fp32 there and is held to that analytic bound,
    4 x 2^-22.  The rejected alternative, the same split in bf16 (hi +
    lo), reads over 5x the 3xTF32 error in Q U^T (~10x plain fp32 at r =
    128, ~90x at r = 5)."""
    from chip_smoke import TOL_PRECOND, TOL_SUMS
    from test_torch_legacy_kernels import _bf16, _tf32
    rng = np.random.default_rng(18)
    g = _t((rng.standard_normal((m, n)) * 1e-3).astype(np.float32))

    def factors(signed):
        draw = ((lambda s: rng.standard_normal(s) * 3e-3) if signed
                else (lambda s: rng.random(s) * 1e-5))
        q, u = (_t(draw(s).astype(np.float32)) for s in ((m, r), (n, r)))
        if codec == "int8":
            q, u = (dequantize(quantize(f)) for f in (q, u))
        return q, u

    q, u = factors(signed=False)
    got = _emulated_pass1(q, u, g, _tf32)
    want = ref.fused_precond(q, u, g, B2, EPS, with_vfro=True,
                             with_fold=True)
    for a, b, tol in zip(got[:4], (want[0], want[1], want[2], want[5]),
                         (TOL_PRECOND, TOL_SUMS, TOL_SUMS, TOL_SUMS)):
        _close(a, b, rtol=0.0, atol=tol * float(b.abs().max()))

    q, u = factors(signed=True)
    q64, u64, g64 = q.double(), u.double(), g.double()
    exact = (q64 @ u64.T, (g64 * g64).T @ q64)
    scale = (q64.abs() @ u64.abs().T, (g64 * g64).T @ q64.abs())
    err = lambda k, a: float(((a.double() - exact[k]).abs()
                              / scale[k]).max())
    plain = (q @ u.T, ref.sq_matmul_t(g, q))
    tf32 = _emulated_pass1(q, u, g, _tf32)
    bf16 = _emulated_pass1(q, u, g, _bf16)
    for k, i in ((0, 4), (1, 3)):   # (Q U^T, its slot), (yfold, its slot)
        if k == 0 and r < 32:
            assert err(k, tf32[i]) < 4 * 2.0 ** -22, err(k, tf32[i])
        else:
            assert err(k, tf32[i]) < 2 * err(k, plain[k]), (
                k, err(k, tf32[i]), err(k, plain[k]))
    assert err(0, bf16[4]) > 5 * err(0, tf32[4]), (err(0, bf16[4]),
                                                   err(0, tf32[4]))


def test_every_factored_leaf_fits_pass1():
    """Every factored leaf of GPT-2 117M / 345M and Mamba2-370m takes the
    fold route its width implies (``ops.fold_in_pass1``).  Under the
    launcher's optimizer (with and without the mixed groups, k_max 128)
    every rank, padded to ``R_ALIGN``, is at most ``R_MAX``: pass 1 folds.
    Under the paper's k_max (min(m, n) / 4: ``k_max=10**9``, rank mode
    "paper") the ranks are 192 (GPT-2 117M) and 256 (345M, Mamba2-370m),
    past ``R_MAX``: the fold goes through ``sq_matmul_t``.  The models are
    built on the meta device: only shapes are read."""
    import dataclasses
    from unittest import mock

    from repro_torch import tree
    from repro_torch.configs.archs import get_config
    from repro_torch.core.adapprox import adapprox_state
    from repro_torch.core.build import build_optimizer
    from repro_torch.core.factored import FactoredLeaf
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model
    meta = lambda shape, **kw: torch.empty(shape, device="meta")
    paper_r = {"gpt2-117m": 192, "gpt2-345m": 256, "mamba2-370m": 256}
    for arch in ("gpt2-117m", "gpt2-345m", "mamba2-370m"):
        with mock.patch.object(torch, "randn", meta):
            flat = tree.flatten(build_model(get_config(arch)).init(
                torch.Generator()))
        for mixed in (False, True):
            launcher = optimizer_config(
                "adapprox", 12, 3e-3, refresh_every=5, fused_update=True,
                mixed_groups=mixed)
            paper = dataclasses.replace(launcher, k_max=10**9)
            for cfg in (launcher, paper):
                state = build_optimizer(cfg).init(flat)
                ranks = [leaf.q.shape[-1]
                         for leaf in adapprox_state(state).leaves
                         if isinstance(leaf, FactoredLeaf)]
                assert ranks, (arch, mixed)
                for r in ranks:
                    padded = -(-r // K.R_ALIGN) * K.R_ALIGN
                    if cfg is launcher:
                        assert padded <= K.R_MAX and ops.fold_in_pass1(r)
                    else:
                        assert r == paper_r[arch], (arch, mixed, r)
                        assert not ops.fold_in_pass1(r), (arch, r)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("r", [128, 192, 256])
def test_wide_fold_takes_sq_matmul_t(monkeypatch, r, int8):
    """The fold's route is chosen by width alone: with the dispatch made
    to take the card's route (the kernels stood in for by their plain
    versions, which record their calls), pass 1 is asked for the fold up
    to ``R_MAX`` and, past it, runs without the fold while
    ``sq_matmul_t`` takes G and Q (int8 factors dequantized); the
    outputs equal the plain pass 1 with the fold."""
    from repro_torch.kernels import srsi_matmul as SM
    rng = np.random.default_rng(r)
    m, n = 72, 40
    q = torch.tensor(rng.random((2, m, r), dtype=np.float32) * 1e-5)
    u = torch.tensor(rng.random((2, n, r), dtype=np.float32) * 1e-5)
    g = torch.tensor(rng.standard_normal((2, m, n)).astype(np.float32)
                     * 1e-3)
    if int8:
        q, u = quantize(q), quantize(u)
    calls = []

    def pass1(qp, up, g3, b2, eps, m1=None, with_fold=False):
        calls.append(("pass1", with_fold))
        deq = (lambda f: f if isinstance(f, torch.Tensor)
               else dequantize(type(q)(*f)))
        out, vfro, usq, _, _, yfold = ref.fused_precond(
            deq(qp), deq(up), g3, b2, eps, with_fold=with_fold)
        sums = torch.stack([vfro, usq, usq, usq], dim=-1)
        return out, sums, yfold

    def b3(g3, x3, transposed):
        calls.append(("sq_matmul_t", transposed))
        return ref.sq_matmul_t(g3, x3)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(K, "fused_precond", pass1)
    monkeypatch.setattr(SM, "sq_matmul", b3)
    got = ops.fused_precond(q, u, g, B2, EPS, with_fold=True)
    qd, ud = (dequantize(q), dequantize(u)) if int8 else (q, u)
    want = ref.fused_precond(qd, ud, g, B2, EPS, with_fold=True)
    if r <= K.R_MAX:
        assert calls == [("pass1", True)]
    else:
        assert calls == [("pass1", False), ("sq_matmul_t", True)]
    assert got[-1].shape == (2, n, r)
    for a, b in ((got[0], want[0]), (got[-1], want[-1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
