"""The port's vlm family (``TransformerLM`` behind the stub vision
frontend: ``embeds`` (B, F, D) before the text tokens) against the JAX
package, at the llava-next-mistral-7b smoke config (2 layers, d_model 64,
GQA 4:2, RoPE, SwiGLU, untied head, 8 frontend tokens), and the train
step with a batch that carries ``embeds``.

Both packages start from the JAX init (carried over with
``repro_torch.convert``); tokens and ``embeds`` come from numpy seeds;
each JAX reference runs once per module, and torch runs on one intra-op
thread.  Tolerances, with their reasons: in fp32 the frameworks differ
only in summation order, so logits and every gradient agree within 1e-5
of each tensor's largest entry and the loss to rtol 1e-6, as
``test_torch_dense.py`` holds the dense models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.types import GradientTransformation as JaxTransform
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.train.steps import TrainState as JaxTrainState
from repro.train.steps import build_train_step as jax_build_train_step
from repro_torch import tree
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.types import EmptyState, GradientTransformation
from repro_torch.models import layers as TL
from repro_torch.models.model_zoo import build_model
from repro_torch.train.steps import TrainState, build_train_step
from test_torch_model import _close_rel
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

ARCH = "llava-next-mistral-7b"
LR = 0.05


def _batch(b, s_txt, f=8, d=64, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s_txt)).astype(np.int32),
            "embeds": rng.standard_normal((b, f, d)).astype(np.float32)}


def _model_case(batch, **over):
    """JAX (jitted) and the port from the JAX init, fp32: logits, loss and
    every gradient on ``batch``."""
    cfg_j, cfg_t = (dataclasses.replace(f(ARCH, **over), dtype="float32")
                    for f in (jax_smoke_config, get_smoke_config))
    jmodel = jax_build_model(cfg_j)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = jax.jit(jmodel.forward)(params, jb["tokens"], jb["embeds"])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, jb)
    model = build_model(cfg_t)
    flat = tree.flatten(params_from_numpy(params))
    for p in flat.values():
        p.requires_grad_(True)
    nested = tree.unflatten(flat)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = model.forward(nested, tb["tokens"], tb["embeds"])
    loss, met = model.loss(nested, tb)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return dict(jlogits=np.asarray(jlogits), jloss=float(jloss),
                jgrads=tree.flatten(jax.device_get(jgrads)),
                logits=logits.numpy(), loss=float(loss.detach()),
                ce=float(met["loss"].detach()),
                grads=dict(zip(flat, (g.numpy() for g in grads))))


def test_vlm_smoke_logits_loss_grads_match_jax():
    """Logits over the frontend and the text, (B, F + S_txt, V); the loss
    over the text alone (logits from position F on); every gradient,
    against JAX's."""
    batch = _batch(2, 40)
    r = _model_case(batch)
    assert r["logits"].shape == (2, 8 + 40, 512)
    _close_rel(r["logits"], r["jlogits"], 1e-5, "logits")
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-6)
    text = TL.softmax_xent(torch.tensor(r["logits"][:, 8:-1]),
                           torch.tensor(batch["tokens"][:, 1:]))
    np.testing.assert_allclose(r["ce"], float(text), rtol=1e-6)
    assert list(r["grads"]) == list(r["jgrads"])
    for k, g in r["grads"].items():
        _close_rel(g, r["jgrads"][k], 1e-5, k)


def test_big_vocab_with_embeds_takes_the_full_logits(monkeypatch):
    """An untied head at vocab x S_txt = 2^17 x 512 = 2^26 (one layer,
    batch 1): with ``embeds`` both packages skip the chunked cross entropy
    and take the full logits, and the loss and every gradient match."""
    calls = []
    fused = TL.fused_xent_from_hidden
    monkeypatch.setattr(TL, "fused_xent_from_hidden",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    jfused = JL.fused_xent_from_hidden
    monkeypatch.setattr(JL, "fused_xent_from_hidden",
                        lambda *a, **k: calls.append(1) or jfused(*a, **k))
    r = _model_case(_batch(1, 512, vocab=2 ** 17, seed=1), vocab=2 ** 17,
                    n_layers=1, max_seq_len=520)
    assert not calls
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-6)
    for k, g in r["grads"].items():
        _close_rel(g, r["jgrads"][k], 1e-5, k)


def _sgd_jax():
    return JaxTransform(
        init=lambda params: (),
        update=lambda g, s, p: (jax.tree.map(lambda x: -LR * x, g), s))


def _sgd_port():
    return GradientTransformation(
        init=lambda params: EmptyState(),
        update=lambda g, s, p: ({k: -LR * x for k, x in g.items()}, s))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_with_embeds_matches_jax(microbatches):
    """``build_train_step`` on a batch of 4 that carries ``embeds``, with
    SGD (each update -0.05 g, so the parameters carry the gradients), two
    steps, against the JAX step: the loss of each step and every parameter
    after it.  The microbatches split ``embeds`` with the tokens.  The
    loss depends on ``embeds`` (the text-only loss differs), so a step
    that fed the model the tokens alone fails here."""
    cfg_j = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    cfg_t = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    batch = _batch(4, 24, seed=2)
    jmodel = jax_build_model(cfg_j)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    jstep = jax.jit(jax_build_train_step(jmodel, _sgd_jax(), microbatches))
    jstate = JaxTrainState.create(params, _sgd_jax())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = build_model(cfg_t)
    step = build_train_step(model, _sgd_port(), microbatches)
    state = TrainState.create(params_from_numpy(params), _sgd_port())
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        text, _ = model.loss(tree.unflatten(state.params),
                             {"tokens": tb["tokens"]})
    for _ in range(2):
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, tb)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-6)
        jflat = tree.flatten(jax.device_get(jstate.params))
        assert list(state.params) == list(jflat)
        for k, p in state.params.items():
            _close_rel(p.detach().numpy(), jflat[k], 1e-5, k)
        if _ == 0:
            assert abs(float(met["loss"]) - float(text)) > 1e-3
