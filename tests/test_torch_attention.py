"""The port's chunked attention path (flash attention, B6) against the JAX
package, on the CPU, where ``kernels/ops.py`` runs the plain versions of
``kernels/ref.py``.  Inputs are made by numpy from a seed and fed to both.

Tolerances, with their reasons:
  * op, fp32: both compute fp32 scores and ``p v`` and differ only in
    summation order: within 1e-5 of the output's largest entry, against
    ``_sdpa_chunked`` and against the JAX package's CPU
    ``ops.flash_attention``;
  * op, bf16 inputs: within one bf16 ulp of each output entry (plus 1e-6
    of the largest, the fp32 summation-order difference, which exceeds
    the ulp of entries that cancel to near 0) against ``_sdpa_chunked``,
    which like the port keeps ``p`` in fp32 and rounds
    once at the end (JAX's CPU ``ops.flash_attention`` rounds ``p`` to
    bf16 before ``p v``, so it is not the bf16 yardstick);
  * gradients, fp32: the recompute backward against ``jax.vjp`` of
    ``_sdpa_chunked`` and against torch autograd through the port's naive
    ``_sdpa``, within 1e-5 of each gradient's largest entry (rows whose
    causal mask leaves one key make ``dP - D`` a difference of near-equal
    terms, so only a scale-relative bound is meaningful);
  * model, fp32, GPT-2 smoke at S = 2048 with ``attn_impl="chunked"``:
    loss within 1e-5 relative, every parameter gradient within 1e-4 of
    its leaf's largest entry; one Adapprox step on the mixed groups from
    those gradients within the slice-2 tolerance (1e-3 of each leaf's
    largest update), with equal ranks;
  * the bf16 CUDA kernels' arithmetic, emulated in torch (P and dS split
    into bf16 hi + lo terms), against the port's fp32 plain versions
    under ``chip_smoke.py``'s rule for the card (one bf16 ulp of each
    entry plus ``TOL_FLASH`` of the largest), which a bf16 P and dS
    miss.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import adapprox_state as jax_adapprox_state
from repro.core import build_optimizer as jax_build_optimizer
from repro.kernels import ops as jops
from repro.launch.train import optimizer_config as jax_opt_config
from repro.models import attention as JA
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.config import ModelConfig
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.adapprox import adapprox_state
from repro_torch.core.build import build_optimizer
from repro_torch.core.factored import FactoredLeaf
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import optimizer_config
from repro_torch.models import attention as TA
from repro_torch.models.model_zoo import build_model
from test_torch_groups import MIXED, _factored_shapes
from test_torch_parity import _close_rel, _JaxSketch
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

# the JAX package's own chunked-attention cases (test_attention_chunked.py)
HEADS = [(4, 4, 16), (8, 2, 32), (4, 1, 16), (2, 2, 80)]


@pytest.fixture(autouse=True)
def jax_auto_mode():
    """The JAX ops' default dispatch, which on the CPU is its reference
    path; restored afterwards."""
    old = jops._MODE
    jops.set_mode("auto")
    yield
    jops.set_mode(old)


def _cfgs(h, kv, hd, **over):
    kw = dict(arch="t", family="dense", n_layers=1, d_model=h * hd,
              n_heads=h, n_kv_heads=kv, d_ff=64, vocab=64, head_dim=hd)
    return JModelConfig(**kw, **over), ModelConfig(**kw, **over)


def _qkv(b, sq, sk, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, sq, h, hd), f(b, sk, kv, hd), f(b, sk, kv, hd)


def _chunks(sq, sk):
    """Small chunks for calling ``_sdpa_chunked`` directly, as the JAX
    package's own tests do: several of each, so the running max moves."""
    return dict(q_chunk=min(64, sq), k_chunk=min(32, sk))


def _jax_chunked(jcfg, q, k, v, causal):
    sq, sk = q.shape[1], k.shape[1]
    out = JA._sdpa_chunked(jcfg, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v), causal=causal, **_chunks(sq, sk))
    return np.asarray(out.astype(jnp.float32)).reshape(q.shape)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv,hd", HEADS)
def test_flash_attention_fp32_matches_jax(h, kv, hd, causal, s):
    jcfg, _ = _cfgs(h, kv, hd)
    q, k, v = _qkv(2, s, s, h, kv, hd)
    want_chunked = _jax_chunked(jcfg, q, k, v, causal)
    want_op = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got_op = ops.flash_attention(_t(q), _t(k), _t(v), causal)
    got_ref, lse = ref.flash_attention(_t(q), _t(k), _t(v), causal)
    assert got_op.dtype == torch.float32 and got_op.shape == q.shape
    assert lse.shape == (2, h, s) and lse.dtype == torch.float32
    for got in (got_op, got_ref):
        _close_rel(got, want_chunked, 1e-5, "vs _sdpa_chunked")
        _close_rel(got, want_op, 1e-5, "vs ops.flash_attention")


@pytest.mark.parametrize("h,kv,hd", [(4, 4, 16), (8, 2, 32)])
def test_flash_attention_cross_shapes_match_jax(h, kv, hd):
    """Sq != Sk, full attention, as the JAX package's
    test_chunked_cross_shapes."""
    jcfg, _ = _cfgs(h, kv, hd)
    q, k, v = _qkv(2, 128, 192, h, kv, hd, seed=3)
    out = JA._sdpa_chunked(jcfg, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v), causal=False, q_chunk=32,
                           k_chunk=64)
    want_op = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False)
    got = ops.flash_attention(_t(q), _t(k), _t(v), False)
    _close_rel(got, np.asarray(out).reshape(got.shape), 1e-5, "chunked")
    _close_rel(got, np.asarray(want_op), 1e-5, "ops.flash_attention")


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 at each |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv,hd", [(4, 4, 16), (8, 2, 32), (2, 2, 80)])
def test_flash_attention_bf16_within_one_ulp_of_chunked(h, kv, hd, causal):
    jcfg, _ = _cfgs(h, kv, hd)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(2, 128, 128, h, kv, hd))
    out = JA._sdpa_chunked(jcfg, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v), causal=causal, **_chunks(128, 128))
    assert out.dtype == jnp.bfloat16
    want = np.asarray(out.astype(jnp.float32)).reshape(q.shape)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                  for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # one bf16 ulp of each entry, plus the fp32 summation-order term for
    # entries near 0, where it is larger than their ulp
    bound = (_bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
             + 1e-6 * np.max(np.abs(want)))
    np.testing.assert_array_less(np.abs(got - want), bound)


def _torch_grads(fn, q, k, v, do):
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, _t(do).reshape(out.shape))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv,hd", HEADS)
def test_flash_attention_grads_match_jax_vjp(h, kv, hd, causal):
    jcfg, _ = _cfgs(h, kv, hd)
    s = 128
    q, k, v = _qkv(2, s, s, h, kv, hd, seed=1)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    f = lambda a, b, c: JA._sdpa_chunked(jcfg, a, b, c, causal=causal,
                                         **_chunks(s, s))
    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do).reshape(out.shape))
    got = _torch_grads(lambda a, b, c: ops.FlashAttention.apply(a, b, c,
                                                                causal),
                       q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        _close_rel(g, np.asarray(w), 1e-5, f"{name} vs jax.vjp")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv,hd", [(4, 4, 16), (8, 2, 32), (4, 1, 16)])
def test_flash_attention_backward_matches_naive_autograd(h, kv, hd, causal):
    """The hand-written backward formula against torch autograd through
    the port's naive ``_sdpa`` (a gradient check of the formula)."""
    _, tcfg = _cfgs(h, kv, hd)
    s = 128
    q, k, v = _qkv(1, s, s, h, kv, hd, seed=4)
    do = np.random.default_rng(5).standard_normal(
        (1, s, h * hd)).astype(np.float32)
    mask = (torch.arange(s)[None, None, :] <= torch.arange(s)[None, :, None]
            ) if causal else torch.ones((1, s, s), dtype=torch.bool)
    want = _torch_grads(lambda a, b, c: TA._sdpa(tcfg, a, b, c, mask),
                        q, k, v, do)
    got = _torch_grads(lambda a, b, c: TA._sdpa_chunked(tcfg, a, b, c,
                                                        causal=causal),
                       q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close_rel(g, w, 1e-5, f"{name} vs autograd of _sdpa")


@pytest.mark.parametrize("sq", [128, 1024, 2048, 4096, 8192, 1000])
@pytest.mark.parametrize("impl", ["auto", "chunked", "naive"])
def test_sdpa_auto_dispatch_matches_jax(monkeypatch, impl, sq):
    """Which branch each package's ``sdpa_auto`` takes, with both
    branches stubbed: no numerics, only the choice (and, for the naive
    branch, the mask)."""
    jcfg, tcfg = _cfgs(2, 1, 4, attn_impl=impl)
    taken = {}
    for pkg, mod in (("jax", JA), ("torch", TA)):
        monkeypatch.setattr(mod, "_sdpa_chunked",
                            lambda cfg, q, k, v, causal, pkg=pkg:
                            taken.setdefault(pkg, ("chunked", causal)))
        monkeypatch.setattr(mod, "_sdpa",
                            lambda cfg, q, k, v, mask, pkg=pkg:
                            taken.setdefault(pkg, ("naive",
                                                   np.asarray(mask).sum())))
    jq = jnp.zeros((1, sq, 2, 4))
    jk = jnp.zeros((1, sq, 1, 4))
    JA.sdpa_auto(jcfg, jq, jk, jk, causal=True)
    tq, tk = torch.zeros((1, sq, 2, 4)), torch.zeros((1, sq, 1, 4))
    TA.sdpa_auto(tcfg, tq, tk, tk, causal=True)
    assert taken["torch"][0] == taken["jax"][0]
    assert int(taken["torch"][1]) == int(taken["jax"][1])
    chunked = sq % 1024 == 0 and (impl == "chunked"
                                  or (impl == "auto" and sq > 4096))
    assert (taken["torch"][0] == "chunked") == chunked


def test_attn_impl_field_matches_jax_and_refuses_unknown():
    fields = {f.name: f.default
              for f in dataclasses.fields(JModelConfig)}
    assert fields["attn_impl"] == "auto"
    assert ModelConfig(arch="t", family="dense", n_layers=1, d_model=8,
                       n_heads=1, n_kv_heads=1, d_ff=8,
                       vocab=8).attn_impl == "auto"
    with pytest.raises(ValueError, match="attn_impl"):
        _cfgs(1, 1, 8, attn_impl="flash")


SEQ_LONG = 2048


@functools.cache
def _long_models():
    """GPT-2 smoke (2 layers, d 64, 4 heads over 2 KV heads) at S = 2048
    with attn_impl "chunked" in fp32: two 1024-row chunks each way and a
    live causal bound.  The JAX init, carried over by numpy."""
    over = dict(max_seq_len=SEQ_LONG, attn_impl="chunked")
    jcfg = dataclasses.replace(jax_smoke_config("gpt2-117m", **over),
                               dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("gpt2-117m", **over),
                               dtype="float32")
    jmodel = jax_build_model(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(7)))
    tokens = np.random.default_rng(8).integers(0, 512, (1, SEQ_LONG)).astype(
        np.int32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, {"tokens": jnp.asarray(tokens)})
    tmodel = build_model(tcfg)
    tparams = tree.flatten(params_from_numpy(params))
    for p in tparams.values():
        p.requires_grad_(True)
    naive = AssertionError("the chunked config took the naive path")
    with mock.patch.object(TA, "_sdpa", side_effect=naive):
        tloss, _ = tmodel.loss(tree.unflatten(tparams),
                               {"tokens": torch.from_numpy(tokens)})
    tgrads = dict(zip(tparams, torch.autograd.grad(tloss,
                                                   list(tparams.values()))))
    return (params, float(jloss), tree.flatten(jax.device_get(jgrads)),
            float(tloss.detach()), tgrads)


def test_gpt2_chunked_loss_and_grads_match_jax():
    _, jloss, jgrads, tloss, tgrads = _long_models()
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert list(tgrads) == list(jgrads)
    for k, g in tgrads.items():
        _close_rel(g, jgrads[k], 1e-4, k)


def test_gpt2_chunked_adapprox_step_matches_jax():
    """One step of the launcher's mixed groups (sketch, Adapprox, dense
    Adam) from the same init and sketches, each package on its own
    chunked-path gradients."""
    params_np, _, jgrads, _, tgrads = _long_models()
    flat_np = tree.flatten(params_np)
    kw = dict(refresh_every=3, fused_update=True, mixed_groups=True,
              **MIXED)
    jopt = jax_build_optimizer(jax_opt_config("adapprox", 4, 3e-3, **kw))
    jparams = jax.tree.map(jnp.asarray, params_np)
    jst = jopt.init(jparams)
    ju, jst = jax.jit(jopt.update)(
        tree.unflatten({k: jnp.asarray(v) for k, v in jgrads.items()}),
        jst, jparams)
    labels = dict(zip(flat_np, jst.labels))
    topt = build_optimizer(optimizer_config("adapprox", 4, 3e-3, **kw),
                           sketch=_JaxSketch(_factored_shapes(flat_np,
                                                              labels), [1]))
    tparams = tree.flatten(params_from_numpy(params_np))
    tu, tst = topt.update({k: g.detach() for k, g in tgrads.items()},
                          topt.init(tparams), tparams)
    ju = tree.flatten(jax.device_get(ju))
    for k in flat_np:
        _close_rel(tu[k], ju[k], 1e-3, f"update {k}")
    jk = [np.asarray(leaf.k).tolist()
          for leaf in jax_adapprox_state(jst).leaves if hasattr(leaf, "q")]
    tk = [leaf.k.tolist() for leaf in adapprox_state(tst).leaves
          if isinstance(leaf, FactoredLeaf)]
    assert tk == jk and tk


def _split(x: torch.Tensor, split: bool) -> torch.Tensor:
    """fp32 ``x`` as the bf16 kernels feed it to the tensor cores: hi =
    bf16(x) plus lo = bf16(x - hi) (``split``), or hi alone (P rounded to
    bf16, as SDPA rounds it)."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def _emulated_bf16_flash(q, k, v, do, causal, split):
    """The arithmetic of ``csrc/flash_attention.cu``'s bf16 (wgmma)
    kernels, in torch on the CPU: scores and dP as fp32 sums of exact
    bf16 products with the scale applied after, the forward's online
    softmax over 64-key tiles, and every product with an fp32 P or dS
    operand taken on its hi + lo bf16 split.  Returns ``(out, lse), (dq,
    dk, dv)``; the backward reads this forward's out and lse, as the
    kernels' does."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    scale = ref.attn_scale(dh)
    heads = lambda t: t.float().repeat_interleave(h // kv, dim=2)
    qf, kf, vf, dof = q.float(), heads(k), heads(v), do.float()
    mask = (torch.arange(sk)[None, :] > torch.arange(sq)[:, None]
            if causal else torch.zeros((sq, sk), dtype=torch.bool))
    s_all = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s_all = s_all.masked_fill(mask, ref.NEG_INF)
    m = torch.full((b, h, sq), ref.NEG_INF)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, dh))
    for k0 in range(0, sk, 64):
        s = s_all[..., k0:k0 + 64]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", _split(p, split), vf[:, k0:k0 + 64])
        m = m_new
    out = (acc / torch.clamp_min(l[..., None], 1e-30)).permute(0, 2, 1, 3)
    out, lse = out.bfloat16(), m + torch.log(l)
    d = (dof * out.float()).sum(dim=-1).permute(0, 2, 1)
    p = torch.exp(s_all - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = _split(p * (dp - d[..., None]), split)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", _split(p, split), dof)
    group = lambda t: t.reshape(b, sk, kv, h // kv, dh).sum(dim=3).bfloat16()
    return (out, lse), (dq.bfloat16(), group(dk), group(dv))


def _share_of_bound(got, want, tol) -> float:
    """``chip_smoke.hold``'s rule as the largest share of its bound: a bf16
    output entry within one bf16 ulp of itself plus ``tol`` of the largest
    entry, an fp32 output within ``tol`` of the largest entry."""
    from chip_smoke import bf16_ulp
    a, b = got.float(), want.float()
    scale = tol * float(b.abs().max())
    if got.dtype == torch.float32:
        return float((a - b).abs().max()) / scale
    return float(((a - b).abs()
                  / (bf16_ulp(torch.maximum(a.abs(), b.abs())) + scale)).max())


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", [
    (1, 1024, 1024, 2, 2, 64, True), (1, 1000, 872, 2, 1, 80, False)])
def test_bf16_kernel_arithmetic_holds_the_flash_tolerance(
        b, sq, sk, h, kv, hd, causal, split):
    """The tolerance decision of the bf16 flash kernels, at GPT-2's head
    shape (causal) and a ragged GQA one (full, dh 80): their arithmetic,
    emulated, holds ``chip_smoke.py``'s rule against the fp32 plain
    versions only with P and dS split into bf16 hi + lo; rounded to bf16
    once, as SDPA rounds P, some output misses it."""
    from chip_smoke import TOL_FLASH
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16() for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                                             (b, sk, kv, hd), (b, sq, h, hd)))
    (out, lse), grads = _emulated_bf16_flash(q, k, v, do, causal, split)
    want_out, want_lse = ref.flash_attention(q, k, v, causal)
    want_grads = ref.flash_attention_bwd(q, k, v, out, lse, do, causal)
    shares = [_share_of_bound(out, want_out, TOL_FLASH),
              _share_of_bound(lse, want_lse, TOL_FLASH)]
    shares += [_share_of_bound(g, w, TOL_FLASH)
               for g, w in zip(grads, want_grads)]
    if split:
        assert max(shares) <= 1.0, shares
    else:
        assert max(shares) > 1.0, shares
