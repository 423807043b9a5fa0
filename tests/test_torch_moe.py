"""The port's MoE block (``models/moe.py``: router, sort dispatch with
capacity and drops, the dense oracle) and the MoE family through the
model, the train step and the launcher, against the JAX package's
single-shard path, at the smoke configs of olmoe-1b-7b and kimi-k2
(8 experts, top-2, d_ff_expert 32).

Both packages start from the JAX init (``repro_torch.convert``); inputs
come from numpy seeds without ties among the router's probabilities
(``jax.lax.top_k`` and ``torch.topk`` may order ties differently); torch
runs on one intra-op thread.  Tolerances, with their reasons: fp32 as in
``test_torch_dense.py`` (1e-5 of each tensor's largest entry, the loss to
rtol 1e-6), the top-k indices exactly; the launcher within 1e-4
relative, the ranks exactly.

Routing is discontinuous, so MoE parity runs in fp32 compute.  In bf16
compute the two frameworks round the router's input in other places,
and near-tied experts swap: at the olmoe smoke model's 96 tokens the
top-1 assignments of JAX and the port differ (the aux losses part), and
kimi-k2's bf16-parameter loss parts by more than the bf16 tolerance,
while the same parameters in fp32 compute give equal losses.  A swapped
route is a different result, not a rounding error, so no tolerance is
widened to cover one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOptimizerConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import moe as JM
from repro.train.steps import build_train_step as jax_build_train_step
from repro_torch import tree
from repro_torch.config import OptimizerConfig
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.adapprox import adapprox_state
from repro_torch.core.build import build_optimizer
from repro_torch.core.factored import FactoredLeaf
from repro_torch.models import moe as TM
from repro_torch.models.model_zoo import build_model
from repro_torch.train.steps import TrainState, build_train_step
from test_torch_dense import (_jax_launcher, _model_case, _rng,
                              one_thread)  # noqa: F401 (autouse fixture)
from test_torch_model import _close_rel
from test_torch_parity import _JaxSketch

OLMOE = "olmoe-1b-7b"


def _moe_inputs(t=64, seed=20):
    """The smoke olmoe config in fp32, one layer's MoE parameters from the
    JAX init (one stack entry), and (T, D) tokens."""
    cfg = dataclasses.replace(jax_smoke_config(OLMOE), dtype="float32")
    p = jax.device_get(JM.moe_init(jax.random.PRNGKey(seed), cfg,
                                   cfg.d_model))
    x = (_rng(seed).standard_normal((t, cfg.d_model))).astype(np.float32)
    return cfg, p, x


def _with(cfg, **moe):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def _port(p):
    return {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}


def test_route_matches_jax():
    """Gates, top-k indices (exactly) and the Switch aux loss."""
    cfg, p, x = _moe_inputs()
    jg, ji, jaux = JM._route(cfg, jnp.asarray(p["router"]), jnp.asarray(x))
    probs = np.asarray(jax.nn.softmax(x @ p["router"], axis=-1))
    top = np.sort(probs, axis=-1)[:, ::-1]
    assert np.min(top[:, 1] - top[:, 2]) > 1e-6      # no near-ties at k
    g, i, aux = TM._route(cfg, torch.tensor(p["router"]), torch.tensor(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close_rel(g.numpy(), np.asarray(jg), 1e-6, "gates")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def _moe_out_and_grads(fn, cfg, p, x):
    """(y, aux) of ``fn`` and the gradients of sum(y * w) + aux w.r.t. x
    and each parameter, w fixed random weights."""
    w = _rng(21).standard_normal(x.shape).astype(np.float32)
    if isinstance(fn, str):              # the JAX package
        def f(x, p):
            y, aux = JM.moe_apply_local(_with(cfg, impl=fn), p, x[None])
            return jnp.sum(y[0] * w) + aux, (y[0], aux)
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(x, p)
        return (np.asarray(y), float(aux),
                [np.asarray(grads[0])] + [np.asarray(grads[1][k])
                                          for k in sorted(p)])
    tx, tp = torch.tensor(x, requires_grad=True), _port(p)
    y, aux = fn(cfg, tp, tx[None])
    grads = torch.autograd.grad((y[0] * torch.tensor(w)).sum() + aux,
                                [tx] + [tp[k] for k in sorted(p)])
    return (y[0].detach().numpy(), float(aux.detach()),
            [g.numpy() for g in grads])


def test_sort_equals_dense_at_ample_capacity():
    """With room for every pair (capacity factor E / k), the sort path
    equals the dense oracle: outputs, aux and every gradient."""
    cfg, p, x = _moe_inputs()
    ample = _with(cfg, capacity_factor=4.0)
    assert TM._capacity(x.shape[0], ample) == x.shape[0]
    sort = _moe_out_and_grads(TM.moe_apply_local, ample, p, x)
    dense = _moe_out_and_grads(TM.moe_apply_local,
                               _with(ample, impl="dense"), p, x)
    _close_rel(sort[0], dense[0], 1e-6, "y")
    assert sort[1] == dense[1]
    for a, b in zip(sort[2], dense[2]):
        _close_rel(a, b, 1e-6)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_sort_with_capacity_drops_matches_jax(capacity_factor):
    """The sort path at the smoke capacity (1.25) and at a capacity that
    drops pairs (0.5: 8 slots an expert for 16 pairs on average) against
    JAX's sort path: outputs, aux and every gradient."""
    cfg, p, x = _moe_inputs()
    cfg = _with(cfg, capacity_factor=capacity_factor)
    cap = TM._capacity(x.shape[0], cfg)
    _, idx, _ = TM._route(cfg, torch.tensor(p["router"]), torch.tensor(x))
    load = np.bincount(idx.numpy().ravel(), minlength=8)
    dropped = int(np.sum(np.maximum(load - cap, 0)))
    assert (dropped > 0) == (capacity_factor < 1)
    got = _moe_out_and_grads(TM.moe_apply_local, cfg, p, x)
    want = _moe_out_and_grads("sort", cfg, p, x)
    _close_rel(got[0], want[0], 1e-5, "y")
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    for name, a, b in zip(["x"] + sorted(p), got[2], want[2]):
        _close_rel(a, b, 1e-5, name)
    if dropped:
        # a dropped pair contributes nothing: rows of tokens whose pairs
        # all dropped are zero
        assert np.sum(np.all(got[0] == 0, axis=-1)) == np.sum(
            np.all(want[0] == 0, axis=-1))


def test_olmoe_smoke_loss_aux_and_grads_match_jax():
    """The olmoe smoke model (fp32): logits, total loss, ``loss`` (the
    cross entropy) and ``aux_loss`` metrics, every gradient (the 4-D
    expert stacks (L, E, m, n) included) against JAX's sort path."""
    tokens = _rng(22).integers(0, 512, (2, 48)).astype(np.int32)
    f32 = lambda c: dataclasses.replace(c, dtype="float32")
    r = _model_case(f32(jax_smoke_config(OLMOE)),
                    f32(get_smoke_config(OLMOE)), tokens)
    _close_rel(r["logits"], r["jlogits"], 1e-5, "logits")
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-6)
    np.testing.assert_allclose(r["ce"], r["jce"], rtol=1e-6)
    np.testing.assert_allclose(r["aux"], r["jaux"], rtol=1e-6)
    assert r["aux"] > 0 and r["loss"] == pytest.approx(
        r["ce"] + 0.01 * r["aux"], rel=1e-6)
    assert r["grads"]["blocks/moe/w_up"].shape == (2, 8, 64, 32)
    assert list(r["grads"]) == list(r["jgrads"])
    for k, g in r["grads"].items():
        _close_rel(g, r["jgrads"][k], 1e-5, k)


def test_kimi_smoke_bf16_params_loss_matches_jax():
    """kimi-k2's smoke model keeps the arch's bf16 master parameters: the
    port's init is bf16, and from JAX's bf16 init (fp32 compute, see the
    module docstring) the loss and aux loss match JAX's to rtol 1e-6."""
    arch = "kimi-k2-1t-a32b"
    f32 = lambda c: dataclasses.replace(c, dtype="float32")
    jcfg, tcfg = f32(jax_smoke_config(arch)), f32(get_smoke_config(arch))
    assert tcfg.param_dtype == "bfloat16" and tcfg.moe is not None
    port_init = build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert {v.dtype for v in tree.flatten(port_init).values()} == {
        torch.bfloat16}
    jmodel = jax_build_model(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    tokens = _rng(23).integers(0, 512, (2, 48)).astype(np.int32)
    jloss, jmet = jax.jit(jmodel.loss)(params, {"tokens": jnp.asarray(
        tokens)})
    f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    tparams = {k: v.to(torch.bfloat16) for k, v in
               tree.flatten(params_from_numpy(f32)).items()}
    tloss, tmet = build_model(tcfg).loss(tree.unflatten(tparams),
                                         {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=1e-6)


def test_train_step_metrics_match_jax():
    """One ``build_train_step`` step on the olmoe smoke model (fp32,
    AdamW) gives JAX's metric keys and values: ``loss`` the total (cross
    entropy + 0.01 aux), ``aux_loss``, ``step``."""
    cfg = dataclasses.replace(jax_smoke_config(OLMOE), dtype="float32")
    jmodel = jax_build_model(cfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    tokens = _rng(24).integers(0, 512, (2, 48)).astype(np.int32)
    jstep = jax_build_train_step(jmodel, JOptimizerConfig(name="adamw"))
    from repro.train.steps import TrainState as JTrainState
    _, jmet = jax.jit(jstep)(JTrainState.create(
        params, JOptimizerConfig(name="adamw")),
        {"tokens": jnp.asarray(tokens)})
    model = build_model(dataclasses.replace(get_smoke_config(OLMOE),
                                            dtype="float32"))
    opt = build_optimizer(OptimizerConfig(name="adamw"))
    state = TrainState.create(params_from_numpy(params), opt)
    _, met = build_train_step(model, opt)(state, {"tokens": torch.tensor(
        tokens)})
    assert sorted(met) == sorted(jmet) == ["aux_loss", "loss", "step"]
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(met["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=1e-6)
    assert int(met["step"]) == int(jmet["step"]) == 0
    assert float(met["aux_loss"]) > 0


def test_launcher_moe_tracks_jax_launcher(monkeypatch):
    """``repro_torch.launch.train --arch olmoe-1b-7b --smoke --device cpu
    --fused-update --refresh-every 3 --embedding-min-rows 256
    --sketch-width 256 --sketch-depth 2`` for 6 steps on the default
    mixed groups against the JAX launcher's run from the same init and
    S-RSI draws, both in fp32 compute (the smoke config's dtype set for
    the run; see the module docstring).  At smoke width the expert stacks
    (2, 8, 64, 32) and the router fall below ``min_dim_factor`` 64 and take
    dense Adam; at full width they are factored (``chip_smoke.py
    [train-olmoe]``)."""
    from repro_torch.launch import train as launcher
    smoke = launcher.get_smoke_config
    monkeypatch.setattr(launcher, "get_smoke_config", lambda *a, **k: (
        dataclasses.replace(smoke(*a, **k), dtype="float32")))
    jl, jlabels, jk, params_np, flat_np = _jax_launcher(OLMOE, "float32")
    assert jlabels["blocks/moe/w_up"] == "dense"
    sketch = _JaxSketch([v.shape for k, v in flat_np.items()
                         if jlabels[k] == "factored"], [1, 4])
    tstate, thist = launcher.main(
        ["--arch", OLMOE, "--smoke", "--device", "cpu", "--fused-update",
         "--refresh-every", "3", "--embedding-min-rows", "256",
         "--sketch-width", "256", "--sketch-depth", "2", "--steps", "6",
         "--log-every", "1"],
        params=params_from_numpy(params_np), sketch=sketch)
    assert list(tstate.opt_state.labels) == list(jlabels.values())
    tl = [h["loss"] for h in thist]
    assert len(tl) == 6 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert all(h["aux_loss"] > 0 for h in thist)
    tk = [leaf.k.tolist() for leaf in adapprox_state(tstate.opt_state).leaves
          if isinstance(leaf, FactoredLeaf)]
    assert tk == jk and tk
