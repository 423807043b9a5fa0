"""The port's Mamba2 slice (``models/mamba2.py``, ``models/ssm_lm.py``, the
launcher on ``--arch mamba2-370m``) against the JAX package, at the smoke
config (2 layers, d_model 64, 8 heads of 16, d_state 16, chunk 16).

Both packages start from the JAX init (carried over with
``repro_torch.convert``); the launcher run takes JAX's own S-RSI draws
(``_JaxSketch`` of ``test_torch_parity.py``).  Tolerances, with their
reasons: the model in fp32, the loss within 1e-5 relative and every
leaf's gradient within 1e-4 of its largest entry (the frameworks sum the
matmuls and the causal conv in other orders; measured ~1e-6); the loss in
bf16 within 1e-3 (bf16 rounds at other places); the launcher's bf16
losses within 1e-3 absolute and the ranks equal at every step, as
``test_torch_groups.py`` holds GPT-2's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import adapprox_state as jax_adapprox_state
from repro.core import build_optimizer as jax_build_optimizer
from repro.launch.train import optimizer_config as jax_opt_config
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.adapprox import adapprox_state
from repro_torch.core.factored import FactoredLeaf
from repro_torch.models.model_zoo import build_model
from test_torch_parity import SEQ, _JaxSketch
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)


ARCH = "mamba2-370m"
MIXED = dict(sketch_width=256, sketch_depth=2, embedding_min_rows=256)


@functools.cache
def _jax_model(dtype="float32"):
    cfg = dataclasses.replace(jax_smoke_config(ARCH, max_seq_len=SEQ),
                              dtype=dtype)
    model = jax_build_model(cfg)
    return model, jax.device_get(model.init(jax.random.PRNGKey(0)))


def _tokens(batch=2, seq=64):
    return np.random.default_rng(0).integers(0, 512, (batch, seq)).astype(
        np.int32)


def test_params_from_numpy_carries_the_jax_tree():
    """The JAX SSMLM's parameter tree (names, stacked shapes, flatten
    order) is the port's, so convert.params_from_numpy carries it over."""
    _, params_np = _jax_model()
    got = tree.flatten(params_from_numpy(params_np))
    port = tree.flatten(build_model(get_smoke_config(ARCH)).init(
        torch.Generator().manual_seed(0)))
    assert list(got) == list(port) == list(tree.flatten(params_np))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in port.items()}
    assert got["layers/mamba/in_proj"].shape == (2, 64, 2 * 128 + 32 + 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_lm_loss_and_grads_match_jax(dtype):
    """SSMLM.loss and every leaf's gradient from JAX's init."""
    jmodel, params_np = _jax_model(dtype)
    tok = _tokens()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tok)})[0]))(
        jax.tree.map(jnp.asarray, params_np))
    model = build_model(dataclasses.replace(get_smoke_config(ARCH),
                                            dtype=dtype))
    flat = tree.flatten(params_from_numpy(params_np))
    for p in flat.values():
        p.requires_grad_(True)
    loss, _ = model.loss(tree.unflatten(flat), {"tokens": torch.tensor(tok)})
    if dtype == "bfloat16":
        assert abs(loss.item() - float(jloss)) <= 1e-3
        return
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = torch.autograd.grad(loss, list(flat.values()))
    jflat = tree.flatten(jax.device_get(jgrads))
    for (k, _), g in zip(flat.items(), grads):
        want = np.asarray(jflat[k], np.float64)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_launcher_mamba2_tracks_jax_launcher():
    """``repro_torch.launch.train --arch mamba2-370m --smoke --device cpu
    --fused-update --refresh-every 3 --embedding-min-rows 256
    --sketch-width 256 --sketch-depth 2`` for 6 steps on the default mixed
    groups against the JAX launcher's run from the same init and sketches,
    in bf16: the token embedding on the sketch, in_proj, out_proj and
    lm_head on Adapprox, the rest on dense Adam."""
    from repro.data import DataConfig as JaxDataConfig
    from repro.train import LoopConfig as JaxLoopConfig
    from repro.train import train as jax_train
    from repro_torch.launch import train as launcher

    steps = 6
    jmodel, params_np = _jax_model("bfloat16")
    jopt = jax_build_optimizer(jax_opt_config(
        "adapprox", steps, 3e-3, refresh_every=3, fused_update=True,
        mixed_groups=True, **MIXED))
    jstate, jhist = jax_train(
        jmodel, jopt, JaxDataConfig(vocab=512, seq_len=SEQ, global_batch=8),
        JaxLoopConfig(total_steps=steps, log_every=1))
    flat_np = tree.flatten(params_np)
    labels = dict(zip(flat_np, jstate.opt_state.labels))
    assert [k for k, v in labels.items() if v == "factored"] == [
        "layers/mamba/in_proj", "layers/mamba/out_proj", "lm_head"]
    assert [k for k, v in labels.items() if v == "embeddings"] == ["embed"]
    sketch = _JaxSketch([v.shape for k, v in flat_np.items()
                         if labels[k] == "factored"], [1, 4])
    tstate, thist = launcher.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--fused-update",
         "--refresh-every", "3", "--embedding-min-rows", "256",
         "--sketch-width", "256", "--sketch-depth", "2", "--steps",
         str(steps), "--log-every", "1"],
        params=params_from_numpy(params_np), sketch=sketch)
    assert tstate.opt_state.labels == tuple(jstate.opt_state.labels)
    jl = [h["loss"] for h in jhist]
    tl = [h["loss"] for h in thist]
    assert len(tl) == steps and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=1e-3)
    jk = [np.asarray(leaf.k).tolist()
          for leaf in jax_adapprox_state(jstate.opt_state).leaves
          if hasattr(leaf, "q")]
    tk = [leaf.k.tolist() for leaf in adapprox_state(tstate.opt_state).leaves
          if isinstance(leaf, FactoredLeaf)]
    assert tk == jk and len(tk) == 3


def test_unported_families_and_serving_raise():
    """Every family builds (dense, moe, vlm, ssm, hybrid, encdec) and an
    unknown one is refused, as in the JAX package.  Serving raised here
    until it was ported; now no family raises for it: each one's
    ``init_cache`` / ``prefill`` / ``decode_step`` run from its own init
    (whisper with its frame ``embeds``) and give finite logits, (B, 1, V)
    a call (``tests/test_torch_decode.py`` holds them to JAX)."""
    from repro_torch.config import ModelConfig
    with pytest.raises(ValueError, match="unknown model family 'rnn'"):
        build_model(ModelConfig(arch="x", family="rnn", n_layers=1,
                                d_model=8, n_heads=1, n_kv_heads=1, d_ff=8,
                                vocab=8))
    families = set()
    for arch in ("gpt2-117m", "olmoe-1b-7b", "llava-next-mistral-7b", ARCH,
                 "zamba2-2.7b", "whisper-large-v3"):
        cfg = get_smoke_config(arch)
        families.add(cfg.family)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        kw = ({"embeds": torch.randn((1, cfg.enc_seq, cfg.d_model))}
              if cfg.family == "encdec" else {})
        cache = model.init_cache(1, 32)
        logits, cache = model.prefill(params, torch.zeros((1, 16),
                                                          dtype=torch.long),
                                      cache, **kw)
        assert cache["pos"] == 16
        logits, cache = model.decode_step(params, cache,
                                          torch.zeros((1, 1),
                                                      dtype=torch.long))
        assert logits.shape == (1, 1, cfg.vocab) and cache["pos"] == 17
        assert bool(torch.isfinite(logits).all()), arch
    assert families == {"dense", "moe", "vlm", "ssm", "hybrid", "encdec"}
