"""The port's GPT-2 model and data stream against the JAX package.

The model starts from the JAX init, carried over with
``convert.params_from_numpy``; tokens come from a numpy seed.  Tolerances:
in fp32 the two frameworks differ only in summation order (matmuls,
LayerNorm, softmax), so logits, loss and gradients agree to rtol 1e-5 of
each tensor's largest entry; in the models' default bf16 compute the loss
agrees to 2e-3 absolute (measured 2.2e-4: bf16 keeps ~3 significant
digits and the two frameworks round activations in different places).  Data must be
byte-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import DataConfig, DataIterator, SyntheticLM
from repro_torch.models.model_zoo import build_model


def _models(dtype):
    jcfg = dataclasses.replace(jax_smoke_config("gpt2-117m", max_seq_len=64),
                               dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config("gpt2-117m", max_seq_len=64),
                               dtype=dtype)
    jmodel = jax_build_model(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    tokens = np.random.default_rng(0).integers(0, 512, (3, 64)).astype(
        np.int32)
    return jmodel, build_model(tcfg), params, tokens


def _close_rel(a, b, rtol, what=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, err_msg=what,
                               atol=rtol * float(np.max(np.abs(b))))


def test_gpt2_smoke_logits_loss_grads_match_jax():
    jmodel, tmodel, params, tokens = _models("float32")
    jlogits, _ = jax.jit(jmodel.forward)(params, jnp.asarray(tokens))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, {"tokens": jnp.asarray(tokens)})

    tparams = tree.flatten(params_from_numpy(params))
    for p in tparams.values():
        p.requires_grad_(True)
    nested = tree.unflatten(tparams)
    tt = torch.from_numpy(tokens)
    tlogits, taux = tmodel.forward(nested, tt)
    _close_rel(tlogits.detach(), jlogits, 1e-5, "logits")
    assert float(taux) == 0.0
    tloss, _ = tmodel.loss(nested, {"tokens": tt})
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    grads = torch.autograd.grad(tloss, list(tparams.values()))
    jflat = tree.flatten(jax.device_get(jgrads))
    assert list(jflat) == list(tparams)
    for (k, g) in zip(tparams, grads):
        _close_rel(g, jflat[k], 1e-5, k)


def test_gpt2_smoke_bf16_loss_matches_jax():
    jmodel, tmodel, params, tokens = _models("bfloat16")
    jloss, _ = jmodel.loss(params, {"tokens": jnp.asarray(tokens)})
    tloss, _ = tmodel.loss(params_from_numpy(params),
                           {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(tloss), float(jloss), atol=2e-3)


def test_flatten_order_is_jax_order():
    """GPT-2's tree, and a qwen2 (QKV bias, SwiGLU, untied head) and an
    olmoe (4-D expert stacks) smoke tree: the port's flatten order is JAX's
    and its init has the JAX init's paths, shapes and dtypes."""
    _, _, gpt2, _ = _models("float32")
    trees = [gpt2]
    for arch in ("qwen2-7b", "olmoe-1b-7b"):
        jparams = jax.device_get(jax_build_model(jax_smoke_config(arch))
                                 .init(jax.random.PRNGKey(0)))
        ours = tree.flatten(build_model(get_smoke_config(arch)).init(
            torch.Generator().manual_seed(0)))
        assert [(k, tuple(v.shape)) for k, v in ours.items()] == [
            (k, v.shape) for k, v in tree.flatten(jparams).items()]
        assert {v.dtype for v in ours.values()} == {torch.float32}
        trees.append(jparams)
    for params in trees:
        names = list(tree.flatten(params))
        paths = [jax.tree_util.keystr(p, simple=True, separator="/")
                 for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
        assert names == paths
        assert tree.unflatten(tree.flatten(params)).keys() == params.keys()


def test_unported_model_features_raise():
    """The families once refused here (hybrid, encdec, vlm) build, and the
    vlm stub frontend's precomputed ``embeds`` are taken: the logits span
    the frontend and text positions, the loss the text alone, and it moves
    with ``embeds``.  RoPE, SwiGLU and MoE build; bf16 master parameters
    (``param_dtype``) are cast at init.  Serving no longer raises
    (``test_torch_mamba2.py::test_unported_families_and_serving_raise``)."""
    for arch in ("zamba2-2.7b", "whisper-large-v3", "llava-next-mistral-7b",
                 "qwen2-7b", "olmoe-1b-7b"):
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        assert type(model).__name__ == {
            "hybrid": "HybridLM", "encdec": "EncDecLM"}.get(
            cfg.family, "TransformerLM")
    cfg = dataclasses.replace(get_smoke_config("llava-next-mistral-7b"),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    embeds = torch.randn((2, cfg.frontend_tokens, 64), generator=gen)
    with torch.no_grad():
        logits, _ = model.forward(params, tokens, embeds)
        assert logits.shape == (2, cfg.frontend_tokens + 12, cfg.vocab)
        with_e, _ = model.loss(params, {"tokens": tokens, "embeds": embeds})
        text, _ = model.loss(params, {"tokens": tokens})
        again, _ = model.loss(params, {"tokens": tokens,
                                       "embeds": embeds * 2})
    assert float(with_e) != float(text) and float(with_e) != float(again)
    params = build_model(dataclasses.replace(
        get_smoke_config("gpt2-117m"), param_dtype="bfloat16")).init(
        torch.Generator().manual_seed(0))
    assert {p.dtype for p in tree.flatten(params).values()} == {
        torch.bfloat16}


@pytest.mark.parametrize("vocab,seq,seed", [(512, 128, 0), (50_257, 1024, 3)])
def test_synthetic_batches_equal_jax(vocab, seq, seed):
    ours = SyntheticLM(DataConfig(vocab=vocab, seq_len=seq, global_batch=2,
                                  seed=seed))
    ref = JaxSyntheticLM(JaxDataConfig(vocab=vocab, seq_len=seq,
                                       global_batch=2, seed=seed))
    for step in (0, 1, 17):
        a, b = ours.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_data_iterator_yields_steps_in_order():
    cfg = DataConfig(vocab=64, seq_len=16, global_batch=2)
    it = DataIterator(cfg, start_step=5)
    try:
        for step in (5, 6, 7):
            batch = next(it)
            assert batch["step"] == step
            np.testing.assert_array_equal(
                batch["tokens"], SyntheticLM(cfg).batch_at(step)["tokens"])
    finally:
        it.close()
    assert not it._thread.is_alive()
