"""The dense family's features in the port (RMSNorm, RoPE, SwiGLU / ReLU^2,
qk-norm, QKV bias, GQA, the untied head and its chunked cross entropy)
against the JAX package, op by op and on the smoke models of qwen2-7b,
qwen3-14b, minitron-4b, deepseek-67b and embed-heavy-256k, plus the
launcher on ``--arch qwen2-7b``.

Both packages start from the JAX init (carried over with
``repro_torch.convert``); inputs come from numpy seeds; each JAX reference
runs once per module (module-scoped fixtures), and torch runs on one
intra-op thread (restored after).  Tolerances, with their reasons: in
fp32 the two frameworks differ only in summation order and in the last
ulp of pow / sin / cos, so outputs, logits and every gradient agree
within 1e-5 of each tensor's largest entry and the loss to rtol 1e-6
(``test_torch_model.py``'s standard); the launcher runs in bf16 compute,
where its losses agree within 1e-4 relative (bf16 matmuls round in other
places in XLA and PyTorch) and the ranks exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import adapprox_state as jax_adapprox_state
from repro.core import build_optimizer as jax_build_optimizer
from repro.launch.train import optimizer_config as jax_opt_config
from repro.models import attention as JA
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro_torch import tree
from repro_torch.configs import archs as torch_archs
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.adapprox import adapprox_state
from repro_torch.core.factored import FactoredLeaf
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.model_zoo import build_model
from test_torch_model import _close_rel
from test_torch_parity import SEQ, _JaxSketch
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

DENSE = ("qwen2-7b", "qwen3-14b", "minitron-4b", "deepseek-67b",
         "embed-heavy-256k")
MIXED = dict(sketch_width=256, sketch_depth=2, embedding_min_rows=256)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(*shape, seed=0, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _grad(out, ts):
    """d out / d ts as numpy, zeros for an input the output does not use
    (as JAX returns)."""
    grads = torch.autograd.grad(out, ts, allow_unused=True)
    return [np.zeros(t.shape, np.float32) if g is None else g.numpy()
            for t, g in zip(ts, grads)]


def _grads_of(fn, *args):
    """Port: ``fn(*tensors)`` and the gradient of its sum (or of itself, a
    scalar) with respect to each argument, as numpy."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    return out.detach().numpy(), _grad(out.sum(), ts)


def test_archs_are_the_jax_archs():
    """Every arch the port registers equals the JAX config field for
    field (JAX's values: rope_theta 10,000 everywhere), and so does its
    smoke config (the MoE branch: 8 experts, top-2, d_ff_expert 32)."""
    assert set(DENSE) | {"olmoe-1b-7b", "kimi-k2-1t-a32b"} <= set(
        torch_archs.ARCHS)
    for arch, cfg in torch_archs.ARCHS.items():
        for ours, ref in ((cfg, jax_archs.ARCHS[arch]),
                          (get_smoke_config(arch), jax_smoke_config(arch))):
            want = dataclasses.asdict(ref)
            got = dataclasses.asdict(ours)
            assert got == {k: want[k] for k in got}, arch
    assert get_smoke_config("olmoe-1b-7b").moe.n_experts == 8


def test_apply_rope_matches_jax():
    """Interleaved pairs rotated by fp32 angles, at positions 1000-1031
    (an offset range, (B, S) positions) and head_dim 16."""
    x = _f32(2, 32, 3, 16, seed=1)
    pos = np.broadcast_to(np.arange(1000, 1032), (2, 32)).astype(np.int32)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    10_000.0))
    got, _ = _grads_of(lambda t: TL.apply_rope(t, torch.tensor(pos),
                                               10_000.0), x)
    _close_rel(got, want, 1e-5, "rope")
    # not the half-split rotation: pairs (0, 1), (2, 3), ... rotate
    x0 = np.zeros((1, 1, 1, 4), np.float32)
    x0[..., 0] = 1.0
    one = TL.apply_rope(torch.tensor(x0), torch.tensor([[1]]), 10_000.0)
    np.testing.assert_allclose(one[0, 0, 0].numpy(),
                               [np.cos(1.0), np.sin(1.0), 0, 0], atol=1e-7)


@pytest.mark.parametrize("act", ["gelu", "relu2", "silu"])
def test_act_matches_jax(act):
    x = _f32(4, 33, seed=2, scale=3.0)
    want = np.asarray(JL._act(act, jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(lambda t: JL._act(act, t).sum())(
        jnp.asarray(x)))
    got, (grad,) = _grads_of(lambda t: TL._act(act, t), x)
    _close_rel(got, want, 1e-5, act)
    _close_rel(grad, jgrad, 1e-5, act + " grad")


@pytest.mark.parametrize("act,mlp_bias", [("swiglu", True), ("relu2", False),
                                          ("relu2", True)])
def test_mlp_and_rms_norm_match_jax(act, mlp_bias):
    """``rms_norm`` then ``mlp_apply`` with its gradients; SwiGLU under
    ``mlp_bias`` adds ``b_down`` only, as in JAX."""
    cfg = dataclasses.replace(jax_smoke_config("qwen2-7b"), act=act,
                              mlp_bias=mlp_bias)
    p = jax.device_get(JL.mlp_init(jax.random.PRNGKey(4), cfg, 64, 128))
    p = {k: (v + _f32(*v.shape, seed=5, scale=0.1) if k.startswith("b_")
             else v) for k, v in p.items()}
    names = sorted(p)
    x = _f32(2, 8, 64, seed=6)
    w = 1.0 + _f32(64, seed=7, scale=0.1)

    def jfn(x, w, *leaves):
        h = JL.rms_norm(x, w, 1e-5)
        return JL.mlp_apply(cfg, dict(zip(names, leaves)), h)

    leaves = [p[k] for k in names]
    want = np.asarray(jfn(x, w, *leaves))
    jgrads = jax.jit(jax.grad(lambda *a: jfn(*a).sum(),
                              argnums=tuple(range(2 + len(names)))))(
        x, w, *leaves)
    got, grads = _grads_of(lambda x, w, *leaves: TL.mlp_apply(
        cfg, dict(zip(names, leaves)), TL.rms_norm(x, w, 1e-5)), x, w,
        *leaves)
    _close_rel(got, want, 1e-5, "mlp")
    for name, g, jg in zip(["x", "w"] + names, grads, jgrads):
        _close_rel(g, np.asarray(jg), 1e-5, name)


def test_project_qkv_bias_qk_norm_rope_match_jax():
    """Biases, then per-head RMSNorm of q and k, then RoPE, GQA 4:2."""
    cfg = dataclasses.replace(jax_smoke_config("qwen2-7b"), qk_norm=True)
    p = jax.device_get(JA.attn_init(jax.random.PRNGKey(8), cfg, 64))
    p = {k: v + (_f32(*v.shape, seed=9, scale=0.2) if v.ndim == 1 else 0)
         for k, v in p.items()}
    names = sorted(p)
    x = _f32(2, 16, 64, seed=10)
    pos = np.arange(16)[None, :]
    jout = JA._project_qkv(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jnp.asarray(pos))
    jgrads = jax.jit(jax.grad(lambda x, *leaves: sum(
        t.sum() * (i + 1) for i, t in enumerate(JA._project_qkv(
            cfg, dict(zip(names, leaves)), x, jnp.asarray(pos)))),
        argnums=tuple(range(1 + len(names)))))(x, *[p[k] for k in names])
    ts = [torch.tensor(a, requires_grad=True)
          for a in [x] + [p[k] for k in names]]
    tout = TA._project_qkv(cfg, dict(zip(names, ts[1:])), ts[0],
                           torch.tensor(pos))
    for t, j in zip(tout, jout):
        _close_rel(t.detach().numpy(), np.asarray(j), 1e-5, "qkv")
    grads = _grad(sum(t.sum() * (i + 1) for i, t in enumerate(tout)), ts)
    for name, g, jg in zip(["x"] + names, grads, jgrads):
        _close_rel(g, np.asarray(jg), 1e-5, name)


def test_fused_xent_from_hidden_matches_jax():
    """Loss, d/dx and d/dhead at S 21 in chunks of 8 (20 positions: two
    whole chunks and one padded with target 0, mask 0)."""
    x = _f32(3, 21, 16, seed=11)
    head = _f32(16, 40, seed=12, scale=0.3)
    tgt = _rng(13).integers(0, 40, (3, 21)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda x, h: JL.fused_xent_from_hidden(x, h, jnp.asarray(tgt),
                                               chunk=8),
        argnums=(0, 1)))(x, head)
    loss, grads = _grads_of(lambda x, h: TL.fused_xent_from_hidden(
        x, h, torch.tensor(tgt), chunk=8), x, head)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    for name, g, jg in zip(("x", "head"), grads, jgrads):
        _close_rel(g, np.asarray(jg), 1e-5, name)
    # the chunked loss is the plain mean cross entropy
    plain = TL.softmax_xent(torch.tensor(x[:, :-1] @ head),
                            torch.tensor(tgt[:, 1:]))
    np.testing.assert_allclose(loss, float(plain), rtol=1e-6)


def _model_case(cfg_jax, cfg_torch, tokens, seed=0):
    """JAX: init, logits, loss and every gradient (fp32, jitted); the port
    from the same init: the same, as numpy."""
    jmodel = jax_build_model(cfg_jax)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed)))
    jtok = jnp.asarray(tokens)
    jlogits, jaux = jax.jit(jmodel.forward)(params, jtok)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, {"tokens": jtok})
    tmodel = build_model(cfg_torch)
    flat = tree.flatten(params_from_numpy(params))
    for p in flat.values():
        p.requires_grad_(True)
    nested = tree.unflatten(flat)
    tt = torch.tensor(tokens)
    with torch.no_grad():
        tlogits, taux = tmodel.forward(nested, tt)
    tloss, tmet = tmodel.loss(nested, {"tokens": tt})
    grads = torch.autograd.grad(tloss, list(flat.values()))
    return dict(
        jlogits=np.asarray(jlogits), jloss=float(jloss),
        jaux=float(jmet["aux_loss"]), jce=float(jmet["loss"]),
        jgrads=tree.flatten(jax.device_get(jgrads)),
        logits=tlogits.numpy(), loss=float(tloss.detach()),
        aux=float(tmet["aux_loss"].detach()), ce=float(tmet["loss"].detach()),
        grads=dict(zip(flat, (g.numpy() for g in grads))))


@pytest.fixture(scope="module")
def dense_runs():
    tokens = _rng(14).integers(0, 512, (2, 48)).astype(np.int32)
    f32 = lambda c: dataclasses.replace(c, dtype="float32")
    return {arch: _model_case(f32(jax_smoke_config(arch)),
                              f32(get_smoke_config(arch)), tokens)
            for arch in DENSE}


@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_logits_loss_grads_match_jax(dense_runs, arch):
    r = dense_runs[arch]
    _close_rel(r["logits"], r["jlogits"], 1e-5, "logits")
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-6)
    assert r["aux"] == r["jaux"] == 0.0 and r["ce"] == r["loss"]
    assert list(r["grads"]) == list(r["jgrads"])
    for k, g in r["grads"].items():
        _close_rel(g, r["jgrads"][k], 1e-5, k)


def test_big_vocab_takes_the_fused_cross_entropy(monkeypatch):
    """An untied head at vocab x S = 2^17 x 512 = 2^26 (smoke width, one
    layer, batch 1): both packages take the chunked cross entropy from the
    hiddens, and the loss and every gradient match."""
    calls = []
    fused = TL.fused_xent_from_hidden
    monkeypatch.setattr(TL, "fused_xent_from_hidden",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    jcalls = []
    jfused = JL.fused_xent_from_hidden
    monkeypatch.setattr(JL, "fused_xent_from_hidden",
                        lambda *a, **k: jcalls.append(1) or jfused(*a, **k))
    over = dict(vocab=2 ** 17, n_layers=1, max_seq_len=512, dtype="float32")
    tokens = _rng(15).integers(0, 2 ** 17, (1, 512)).astype(np.int32)
    r = _model_case(jax_smoke_config("qwen2-7b", **over),
                    get_smoke_config("qwen2-7b", **over), tokens)
    assert calls and jcalls
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-6)
    for k, g in r["grads"].items():
        _close_rel(g, r["jgrads"][k], 1e-5, k)


@pytest.mark.parametrize("arch", ["qwen2-7b", "olmoe-1b-7b"])
def test_full_width_groups_route_as_jax(arch):
    """The launcher's mixed groups at full width (shapes only, from
    ``jax.eval_shape``): every leaf labelled as the JAX package labels it;
    the (152064, 3584) embed and the untied (3584, 152064) lm_head of
    Qwen2-7B take the sketch (leading dim >= 1024), and no (L, ...) stack
    does (its leading dim is L)."""
    from repro.config import default_mixed_groups as jax_mixed_groups
    from repro.configs import get_config as jax_get_config
    from repro.core.build import group_labeler as jax_group_labeler
    from repro_torch.config import default_mixed_groups
    from repro_torch.core.build import group_labeler
    shapes = tree.flatten(jax.eval_shape(
        jax_build_model(jax_get_config(arch)).init, jax.random.PRNGKey(0)))
    want = tree.flatten(jax_group_labeler(jax_mixed_groups(), 64, 1024)(
        tree.unflatten(shapes)))
    got = group_labeler(default_mixed_groups(), 64, 1024)(shapes)
    assert got == want
    assert sorted(k for k, lab in got.items() if lab == "embeddings") == [
        "embed", "lm_head"]
    assert all(got[k] != "embeddings" for k in got if k.startswith("blocks"))


def test_launcher_dense_tracks_jax_launcher():
    """``repro_torch.launch.train --arch qwen2-7b --smoke --device cpu
    --fused-update --refresh-every 3 --embedding-min-rows 256
    --sketch-width 256 --sketch-depth 2`` for 6 steps on the default
    mixed groups against the JAX launcher's run from the same init and
    S-RSI draws, in bf16: embed (512 rows) on the sketch, the block
    matrices and the untied lm_head (64 rows) on Adapprox, the rest on
    dense Adam."""
    from repro_torch.launch import train as launcher
    arch = "qwen2-7b"
    jl, jlabels, jk, params_np, flat_np = _jax_launcher(arch)
    assert [k for k, v in jlabels.items() if v == "embeddings"] == [
        "embed"]
    sketch = _JaxSketch([v.shape for k, v in flat_np.items()
                         if jlabels[k] == "factored"], [1, 4])
    tstate, thist = launcher.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--fused-update",
         "--refresh-every", "3", "--embedding-min-rows", "256",
         "--sketch-width", "256", "--sketch-depth", "2", "--steps", "6",
         "--log-every", "1"],
        params=params_from_numpy(params_np), sketch=sketch)
    assert list(tstate.opt_state.labels) == list(jlabels.values())
    tl = [h["loss"] for h in thist]
    assert len(tl) == 6 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    tk = [leaf.k.tolist() for leaf in adapprox_state(tstate.opt_state).leaves
          if isinstance(leaf, FactoredLeaf)]
    assert tk == jk and tk


@functools.cache
def _jax_launcher(arch, dtype="bfloat16"):
    """The JAX launcher's 6-step run (the smoke config in ``dtype``
    compute, mixed groups, the smoke sketch flags): losses, group labels,
    final ranks, init."""
    from repro.data import DataConfig as JaxDataConfig
    from repro.train import LoopConfig as JaxLoopConfig
    from repro.train import train as jax_train
    cfg = dataclasses.replace(jax_smoke_config(arch, max_seq_len=SEQ),
                              dtype=dtype)
    jmodel = jax_build_model(cfg)
    params_np = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    jopt = jax_build_optimizer(jax_opt_config(
        "adapprox", 6, 3e-3, refresh_every=3, fused_update=True,
        mixed_groups=True, **MIXED))
    jstate, jhist = jax_train(
        jmodel, jopt, JaxDataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                    global_batch=8),
        JaxLoopConfig(total_steps=6, log_every=1))
    flat_np = tree.flatten(params_np)
    labels = dict(zip(flat_np, jstate.opt_state.labels))
    jk = [np.asarray(leaf.k).tolist()
          for leaf in jax_adapprox_state(jstate.opt_state).leaves
          if hasattr(leaf, "q")]
    return [h["loss"] for h in jhist], labels, jk, params_np, flat_np
