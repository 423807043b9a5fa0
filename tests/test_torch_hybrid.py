"""The port's hybrid family (``models/zamba2.py``: a Mamba2 backbone with
shared attention + MLP blocks) against the JAX package, at the
zamba2-2.7b smoke config (4 layers, a shared block after every 2nd, 2
shared blocks, d_model 64, SSD d_state 16, chunk 16), and the launcher on
``--arch zamba2-2.7b``.

Both packages start from the JAX init (carried over with
``repro_torch.convert``); inputs come from numpy seeds; each JAX reference
runs once per module (module-scoped fixtures), and torch runs on one
intra-op thread (restored after).  Tolerances, with their reasons: in fp32
the frameworks differ only in summation order (the matmuls, the causal
conv, the SSD chunk sums), so logits and every gradient agree within
1e-5 of each tensor's largest entry and the loss to rtol 1e-6, as
``test_torch_dense.py`` holds the dense models; the launcher runs in bf16
compute, where its losses agree within 1e-4 relative (bf16 rounds at
other places in XLA and PyTorch) and the ranks exactly.  The JAX Mamba2
block's gradients are NaN at full width (ROADMAP Queue C), so the hybrid
is held to JAX at smoke size only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.adapprox import adapprox_state
from repro_torch.core.factored import FactoredLeaf
from repro_torch.models.model_zoo import build_model
from test_torch_dense import _jax_launcher
from test_torch_model import _close_rel
from test_torch_parity import _JaxSketch
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

ARCH = "zamba2-2.7b"


def _case(remat: str, **over):
    """JAX (jitted) and the port from the JAX init, fp32, on one (2, 48)
    batch: logits, loss and every gradient, as numpy."""
    cfg_j = dataclasses.replace(jax_smoke_config(ARCH, **over),
                                dtype="float32", remat=remat)
    cfg_t = dataclasses.replace(get_smoke_config(ARCH, **over),
                                dtype="float32", remat=remat)
    tokens = np.random.default_rng(21).integers(0, 512, (2, 48)).astype(
        np.int32)
    jmodel = jax_build_model(cfg_j)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    jtok = jnp.asarray(tokens)
    jlogits, _ = jax.jit(jmodel.forward)(params, jtok)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, {"tokens": jtok})
    model = build_model(cfg_t)
    flat = tree.flatten(params_from_numpy(params))
    port = tree.flatten(model.init(torch.Generator().manual_seed(0)))
    assert list(flat) == list(port)
    assert all(flat[k].shape == port[k].shape for k in flat)
    for p in flat.values():
        p.requires_grad_(True)
    nested = tree.unflatten(flat)
    tt = torch.tensor(tokens)
    with torch.no_grad():
        logits, aux = model.forward(nested, tt)
    loss, met = model.loss(nested, {"tokens": tt})
    grads = torch.autograd.grad(loss, list(flat.values()))
    return dict(jlogits=np.asarray(jlogits), jloss=float(jloss),
                jgrads=tree.flatten(jax.device_get(jgrads)),
                logits=logits.numpy(), aux=float(aux),
                loss=float(loss.detach()), met=float(met["loss"].detach()),
                grads=dict(zip(flat, (g.numpy() for g in grads))))


@pytest.fixture(scope="module")
def runs():
    return {"none": _case("none"), "full": _case("full"),
            # 8 layers, every 2nd, 2 shared blocks: each block at two
            # application points
            "two_points": _case("none", n_layers=8)}


@pytest.mark.parametrize("which", ["none", "full"])
def test_hybrid_smoke_logits_loss_grads_match_jax(runs, which):
    """Logits, loss and every leaf's gradient from the JAX init, without
    remat and under remat "full" (the whole layer, its shared block
    included, recomputed in the backward)."""
    r = runs[which]
    _close_rel(r["logits"], r["jlogits"], 1e-5, "logits")
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-6)
    assert r["aux"] == 0.0 and r["met"] == r["loss"]
    assert list(r["grads"]) == list(r["jgrads"])
    for k, g in r["grads"].items():
        assert np.isfinite(g).all(), k
        _close_rel(g, r["jgrads"][k], 1e-5, k)


def test_remat_full_equals_none_bitwise(runs):
    """Remat recomputes the same ops: loss and gradients bitwise equal."""
    a, b = runs["none"], runs["full"]
    assert a["loss"] == b["loss"]
    for k in a["grads"]:
        np.testing.assert_array_equal(a["grads"][k], b["grads"][k], k)


@pytest.mark.parametrize("which", ["none", "two_points"])
def test_shared_block_gradients_match_jax(runs, which):
    """The shared blocks' leaves on their own: (2, ...) stacks, each
    block's gradient the sum over its application points (one each at 4
    layers, two each at 8), against JAX's, and nonzero in both blocks."""
    r = runs[which]
    shared = [k for k in r["grads"] if k.startswith("shared/")]
    assert sorted(shared) == sorted(
        f"shared/{k}" for k in ("norm1/w", "norm2/w", "attn/wq", "attn/wk",
                                "attn/wv", "attn/wo", "mlp/w_up",
                                "mlp/w_down"))
    for k in shared:
        g = r["grads"][k]
        assert g.shape[0] == 2
        assert all(np.abs(g[i]).max() > 0 for i in range(2)), k
        for i in range(2):
            _close_rel(g[i], r["jgrads"][k][i], 1e-5, f"{k}[{i}]")


def test_hybrid_refuses_a_ragged_period():
    with pytest.raises(ValueError, match="hybrid_attn_every"):
        build_model(get_smoke_config(ARCH, n_layers=5))


def test_launcher_hybrid_tracks_jax_launcher():
    """``repro_torch.launch.train --arch zamba2-2.7b --smoke --device cpu
    --fused-update --refresh-every 3 --embedding-min-rows 256
    --sketch-width 256 --sketch-depth 2`` for 6 steps on the default mixed
    groups against the JAX launcher's run from the same init and S-RSI
    draws, in bf16: embed (512 rows) on the sketch; in_proj, out_proj,
    the shared blocks' wq, wo, w_up, w_down and lm_head on Adapprox; the
    rest (wk and wv are 32 wide at GQA 4:2) on dense Adam."""
    from repro_torch.launch import train as launcher
    jl, jlabels, jk, params_np, flat_np = _jax_launcher(ARCH)
    assert [k for k, v in jlabels.items() if v == "embeddings"] == ["embed"]
    assert [k for k, v in jlabels.items() if v == "factored"] == [
        "layers/mamba/in_proj", "layers/mamba/out_proj", "lm_head",
        "shared/attn/wo", "shared/attn/wq", "shared/mlp/w_down",
        "shared/mlp/w_up"]
    sketch = _JaxSketch([v.shape for k, v in flat_np.items()
                         if jlabels[k] == "factored"], [1, 4])
    tstate, thist = launcher.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--fused-update",
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
    assert tk == jk and len(tk) == 7
