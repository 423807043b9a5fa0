"""The port's encoder-decoder family (``models/whisper.py``) and
``attn_apply_full`` against the JAX package, at the whisper-large-v3 smoke
config (2 encoder and 2 decoder layers, enc_seq 32, d_model 64,
LayerNorm, learned positions, tied head), and the launcher on ``--arch
whisper-large-v3``, which fails for want of ``embeds`` as the JAX
launcher does (no data source of either package makes them).

Both packages start from the JAX init (carried over with
``repro_torch.convert``); tokens and the stub frontend's ``embeds`` come
from numpy seeds; each JAX reference runs once per module, and torch runs
on one intra-op thread.  Tolerances, with their reasons: in fp32 the
frameworks differ only in summation order (matmuls, LayerNorm, softmax),
so outputs, logits and every gradient agree within 1e-5 of each tensor's
largest entry and the loss to rtol 1e-6, as ``test_torch_dense.py``
holds the dense models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import make_batch as jax_make_batch
from repro.models import attention as JA
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.configs.archs import get_smoke_config
from repro_torch.configs.base import make_batch
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models.model_zoo import build_model
from test_torch_dense import _grads_of
from test_torch_model import _close_rel
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

ARCH = "whisper-large-v3"


def _f32(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cfgs(**over):
    return tuple(dataclasses.replace(f(ARCH, **over), dtype="float32")
                 for f in (jax_smoke_config, get_smoke_config))


@pytest.mark.parametrize("causal", [False, True])
def test_attn_apply_full_matches_jax(causal):
    """``attn_apply_full`` (projections, the naive fp32-score attention,
    the output projection) and its gradients at S 24, with and without
    the causal mask; then with ``kv_override`` (keys and values from 40
    other positions, full attention), as cross-attention takes them."""
    cfg, _ = _cfgs()
    p = jax.device_get(JA.attn_init(jax.random.PRNGKey(1), cfg, 64))
    names = sorted(p)
    x = _f32(2, 24, 64, seed=2)
    leaves = [p[k] for k in names]

    def jfn(x, *leaves):
        return JA.attn_apply_full(cfg, dict(zip(names, leaves)), x,
                                  causal=causal)

    want = np.asarray(jfn(x, *leaves))
    jgrads = jax.grad(lambda *a: jfn(*a).sum(),
                      argnums=tuple(range(1 + len(names))))(x, *leaves)
    got, grads = _grads_of(lambda x, *leaves: TA.attn_apply_full(
        cfg, dict(zip(names, leaves)), x, causal=causal), x, *leaves)
    _close_rel(got, want, 1e-5, "out")
    for name, g, jg in zip(["x"] + names, grads, jgrads):
        _close_rel(g, np.asarray(jg), 1e-5, name)
    if causal:
        return
    k = _f32(2, 40, 2, 16, seed=3)
    v = _f32(2, 40, 2, 16, seed=4)
    want = np.asarray(JA.attn_apply_full(cfg, p, x, causal=False,
                                         kv_override=(k, v)))
    got = TA.attn_apply_full(
        cfg, {n: torch.tensor(a) for n, a in p.items()}, torch.tensor(x),
        causal=False, kv_override=(torch.tensor(k), torch.tensor(v)))
    _close_rel(got.numpy(), want, 1e-5, "kv_override")


def _model_case(remat):
    """JAX (jitted) and the port from the JAX init, fp32: the encoder's
    output, the logits, loss and every gradient on one batch of (2, 24)
    tokens and (2, 32, 64) embeds."""
    cfg_j, cfg_t = (dataclasses.replace(c, remat=remat) for c in _cfgs())
    tokens = np.random.default_rng(5).integers(0, 512, (2, 24)).astype(
        np.int32)
    embeds = _f32(2, 32, 64, seed=6)
    jmodel = jax_build_model(cfg_j)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    jb = {"tokens": jnp.asarray(tokens), "embeds": jnp.asarray(embeds)}
    jenc = jax.jit(jmodel.encode)(params, jb["embeds"])
    jlogits, _ = jax.jit(jmodel.forward)(params, jb["tokens"], jb["embeds"])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, jb)
    model = build_model(cfg_t)
    flat = tree.flatten(params_from_numpy(params))
    port = tree.flatten(model.init(torch.Generator().manual_seed(0)))
    assert list(flat) == list(port)
    assert all(flat[k].shape == port[k].shape for k in flat)
    for p in flat.values():
        p.requires_grad_(True)
    nested = tree.unflatten(flat)
    tb = {"tokens": torch.tensor(tokens), "embeds": torch.tensor(embeds)}
    with torch.no_grad():
        enc = model.encode(nested, tb["embeds"])
        logits, aux = model.forward(nested, tb["tokens"], tb["embeds"])
    loss, _ = model.loss(nested, tb)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return dict(jenc=np.asarray(jenc), jlogits=np.asarray(jlogits),
                jloss=float(jloss), jgrads=tree.flatten(
                    jax.device_get(jgrads)),
                enc=enc.numpy(), logits=logits.numpy(), aux=float(aux),
                loss=float(loss.detach()),
                grads=dict(zip(flat, (g.numpy() for g in grads))))


@pytest.fixture(scope="module")
def runs():
    return {r: _model_case(r) for r in ("none", "full")}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_encdec_smoke_encode_logits_loss_grads_match_jax(runs, remat):
    """``encode``, the logits (B, S, V), the loss and every leaf's gradient
    (the encoder's, the cross-attention's, both position tables) from the
    JAX init, without remat and under remat "full"."""
    r = runs[remat]
    assert r["enc"].shape == (2, 32, 64)
    _close_rel(r["enc"], r["jenc"], 1e-5, "encode")
    assert r["logits"].shape == (2, 24, 512)
    _close_rel(r["logits"], r["jlogits"], 1e-5, "logits")
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-6)
    assert r["aux"] == 0.0
    assert list(r["grads"]) == list(r["jgrads"])
    for k, g in r["grads"].items():
        _close_rel(g, r["jgrads"][k], 1e-5, k)
    # dec_pos has max_seq_len rows; only the first 24 get a gradient
    assert r["grads"]["dec_pos"].shape == (256, 64)
    assert not r["grads"]["dec_pos"][24:].any()


def test_cross_attention_matches_jax():
    """``_cross_kv`` then ``_cross_attend`` (no positions, an all-true
    mask over the 32 encoder frames) and their gradients, one decoder
    block's parameters."""
    cfg_j, cfg_t = _cfgs()
    jmodel = jax_build_model(cfg_j)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    bp = jax.tree.map(lambda a: a[1], params["dec_blocks"])
    p = bp["cross_attn"]
    names = sorted(p)
    h = _f32(2, 24, 64, seed=7)
    enc = _f32(2, 32, 64, seed=8)

    def jfn(h, enc, *leaves):
        b = {"cross_attn": dict(zip(names, leaves))}
        return jmodel._cross_attend(b, h, *jmodel._cross_kv(b, enc))

    leaves = [p[k] for k in names]
    want = np.asarray(jfn(h, enc, *leaves))
    jgrads = jax.grad(lambda *a: jfn(*a).sum(),
                      argnums=tuple(range(2 + len(names))))(h, enc, *leaves)
    model = build_model(cfg_t)

    def tfn(h, enc, *leaves):
        b = {"cross_attn": dict(zip(names, leaves))}
        return model._cross_attend(b, h, *model._cross_kv(b, enc))

    got, grads = _grads_of(tfn, h, enc, *leaves)
    _close_rel(got, want, 1e-5, "cross")
    for name, g, jg in zip(["h", "enc"] + names, grads, jgrads):
        _close_rel(g, np.asarray(jg), 1e-5, name)


@pytest.mark.parametrize("arch", [ARCH, "llava-next-mistral-7b",
                                  "gpt2-117m"])
def test_make_batch_matches_jax_structure(arch):
    """``configs/base.py::make_batch``: the JAX function's keys, shapes and
    dtypes (int tokens, ``embeds`` in the compute dtype): (B, enc_seq, D)
    for encdec, (B, frontend_tokens, D) and S - F text tokens for vlm,
    tokens alone otherwise; drawn from the generator, so a seed repeats."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    want = jax_make_batch(jcfg, 2, 40)
    got = make_batch(tcfg, 2, 40, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert v.is_floating_point() == jnp.issubdtype(want[k].dtype,
                                                       jnp.floating), k
    assert got["tokens"].min() >= 0 and got["tokens"].max() < tcfg.vocab
    if "embeds" in got:
        assert got["embeds"].dtype == getattr(torch, tcfg.dtype)
    again = make_batch(tcfg, 2, 40, torch.Generator().manual_seed(0))
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_launcher_whisper_fails_as_jax_launcher():
    """``--arch whisper-large-v3 --smoke``: neither launcher's data stream
    makes ``embeds``, so both stop at the first step's loss with
    ``KeyError: 'embeds'`` (no source is invented for them)."""
    from repro.launch import train as jax_launcher
    from repro_torch.launch import train as launcher
    argv = ["--arch", ARCH, "--smoke", "--steps", "1", "--batch", "2",
            "--seq", "16", "--no-mixed-groups"]
    with pytest.raises(KeyError, match="embeds"):
        jax_launcher.main(argv)
    with pytest.raises(KeyError, match="embeds"):
        launcher.main(argv + ["--device", "cpu"])

