"""Rematerialization (``ModelConfig.remat``) and bf16 master parameters
(``param_dtype``) in the port against the JAX package.

Remat changes what the backward keeps, not what it computes: in the port
the loss and every gradient under "full" and "dots" equal "none" bit for
bit on the CPU (the recomputed forward runs the same kernels on the same
inputs), and each is held to the JAX model under the same remat at the
model tests' tolerances (GPT-2: loss rtol 1e-6, gradients 1e-5 of each
leaf's largest entry; Mamba2: loss 1e-5, gradients 1e-4).

With bf16 parameters each training step is held one step from JAX's own
state: over several steps a bf16 parameter that rounds the other way by
one ulp moves the next gradient, and where the clamped low-rank term is
~0 and G is small, u_hat = G / sqrt(V) follows the sign of that gradient
(the int8 factors' chaos, ROADMAP), so trajectories part by more than an
ulp.  One step from a shared state, the parameters are within one bf16
ulp of JAX's, the rare entry more by what a bf16 gradient's rounding and
slice 1's update tolerance allow (see the test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import build_optimizer as jax_build_optimizer
from repro.data import DataConfig as JaxDataConfig
from repro.launch.train import optimizer_config as jax_opt_config
from repro.models import build_model as jax_build_model
from repro.train import LoopConfig as JaxLoopConfig
from repro.train import train as jax_train
from repro_torch import tree
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.build import build_optimizer
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import optimizer_config
from repro_torch.models.model_zoo import build_model
from test_torch_parity import SEQ, _close_rel, _JaxSketch
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

TOL = {"gpt2-117m": (1e-6, 1e-5), "mamba2-370m": (1e-5, 1e-4)}


def _loss_and_grads(arch, remat):
    """(JAX, port) loss and gradients of the fp32 smoke model under
    ``remat`` from the JAX init."""
    jcfg = dataclasses.replace(jax_smoke_config(arch, max_seq_len=SEQ),
                               dtype="float32", remat=remat)
    jmodel = jax_build_model(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    tok = np.random.default_rng(1).integers(0, 512, (2, SEQ)).astype(
        np.int32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                    {"tokens": jnp.asarray(tok)})
    model = build_model(dataclasses.replace(
        get_smoke_config(arch, max_seq_len=SEQ), dtype="float32",
        remat=remat))
    flat = tree.flatten(params_from_numpy(params))
    for p in flat.values():
        p.requires_grad_(True)
    loss, _ = model.loss(tree.unflatten(flat), {"tokens": torch.tensor(tok)})
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    return ((float(jloss), tree.flatten(jax.device_get(jgrads))),
            (loss.detach(), grads))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["gpt2-117m", "mamba2-370m"])
def test_remat_is_bitwise_and_matches_jax(arch, remat):
    (jl, jg), (tl, tg) = _loss_and_grads(arch, remat)
    _, (tl0, tg0) = _loss_and_grads(arch, "none")
    assert torch.equal(tl, tl0)
    for k in tg:
        assert torch.equal(tg[k], tg0[k]), k
    loss_tol, grad_tol = TOL[arch]
    np.testing.assert_allclose(float(tl), jl, rtol=loss_tol)
    for k, g in tg.items():
        _close_rel(g, jg[k], grad_tol, f"{remat} {k}")


def test_remat_defaults_follow_jax():
    """The full-size configs default to "full" and the smoke configs to
    "none", as the JAX package's; an unknown mode is refused."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs.archs import get_config
    for arch in ("gpt2-117m", "gpt2-345m", "mamba2-370m"):
        assert get_config(arch).remat == jax_get_config(arch).remat == "full"
        assert get_smoke_config(arch).remat == \
            jax_smoke_config(arch).remat == "none"
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(get_config("gpt2-117m"), remat="all")


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_bf16_params_three_steps_match_jax():
    """GPT-2 smoke with ``param_dtype="bfloat16"`` (fp32 compute) and the
    launcher's Adapprox (--fused-update --refresh-every 3, no mixed
    groups): JAX trains 0, 1, 2 and 3 steps from its init; the port takes
    step t from JAX's parameters and optimizer state after t - 1 steps
    (JAX's sketch at the step-1 refresh), as int8 runs are compared one
    step from a shared state (ROADMAP).  Each step's parameters are bf16
    and, entry by entry, within one bf16 ulp of JAX's, plus two bf16 ulp
    of the entry's own change (the gradient is bf16: its fp32 value,
    within ~1e-6 in the two packages, can round to either neighbour, and
    u_hat is proportional to G where the low-rank term dominates V), plus
    slice 1's update tolerance (1e-3 of the leaf's largest change); fewer
    than 1e-3 of the entries need more than the one ulp.  The step losses
    agree to 1e-4."""
    from repro_torch.convert import adapprox_state_from_numpy
    from repro_torch.core.transform import CountState
    from repro_torch.core.types import EmptyState
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.steps import TrainState, build_train_step
    jcfg = dataclasses.replace(jax_smoke_config("gpt2-117m",
                                                max_seq_len=SEQ),
                               dtype="float32", param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_config("gpt2-117m", max_seq_len=SEQ),
                               dtype="float32", param_dtype="bfloat16")
    jmodel = jax_build_model(jcfg)
    data = DataConfig(vocab=512, seq_len=SEQ, global_batch=4)
    f32 = lambda tree_: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     jax.device_get(tree_))
    jruns = [(f32(jmodel.init(jax.random.PRNGKey(0))), None, None)]
    for t in range(1, 4):
        jstate, jhist = jax_train(
            jmodel, jax_build_optimizer(jax_opt_config(
                "adapprox", 3, 3e-3, refresh_every=3, fused_update=True)),
            JaxDataConfig(vocab=512, seq_len=SEQ, global_batch=4),
            JaxLoopConfig(total_steps=t, log_every=1))
        jruns.append((f32(jstate.params), jax.device_get(jstate.opt_state),
                      jhist[-1]["loss"]))
    model = build_model(tcfg)
    worst, past_ulp, total = 0.0, 0, 0
    for t in range(1, 4):
        prev_np, prev_opt, _ = jruns[t - 1]
        want_np, _, want_loss = jruns[t]
        params = {k: v.to(torch.bfloat16) for k, v in
                  tree.flatten(params_from_numpy(prev_np)).items()}
        opt = build_optimizer(optimizer_config(
            "adapprox", 3, 3e-3, refresh_every=3, fused_update=True),
            sketch=_JaxSketch([v.shape for v in
                               tree.flatten(prev_np).values()], [t]))
        state = TrainState.create(tree.unflatten(params), opt)
        if prev_opt is not None:
            ad, count = prev_opt[0], prev_opt[2]
            state.opt_state = (adapprox_state_from_numpy(int(ad.step),
                                                         ad.leaves),
                               EmptyState(), CountState(int(count.count)),
                               EmptyState())
        tokens = torch.from_numpy(SyntheticLM(data).batch_at(t - 1)["tokens"])
        state, metrics = build_train_step(model, opt)(state,
                                                      {"tokens": tokens})
        assert abs(float(metrics["loss"]) - want_loss) <= 1e-4
        before = tree.flatten(prev_np)
        for k, want in tree.flatten(want_np).items():
            p = state.params[k]
            assert p.dtype == torch.bfloat16, k
            a = p.detach().float().numpy()
            ulp = _bf16_ulp(np.maximum(np.abs(a), np.abs(want)))
            change = np.abs(want - before[k])
            tol = 2 * _bf16_ulp(change) + 1e-3 * float(np.max(change))
            past_ulp += int(np.sum(np.abs(a - want) > ulp))
            total += a.size
            ratio = np.abs(a - want) / (ulp + tol)
            worst = max(worst, float(ratio.max()))
            assert np.all(ratio <= 1.0), (t, k, float(ratio.max()))
    assert worst > 0.0      # the two packages do round apart somewhere
    assert past_ulp <= 1e-3 * total, past_ulp
