"""The paper's baselines in the port, Adafactor and CAME, against the JAX
package: the optimizers as ``build_optimizer`` builds them (preconditioner,
weight decay, schedule or Adafactor's relative step, sign) over 6 steps
with fixed gradients, and the launchers' whole training slice.  Inputs
come from numpy seeds; both start from the JAX package's GPT-2 smoke
init.

Tolerances, with their reasons: the row and column means, the leaf RMS of
the clip and the relative step's parameter RMS sum in other orders in
XLA and PyTorch, a few fp32 ulp, which the updates carry into the next
step's statistics; updates and every state tensor are held to 1e-5 of
each one's largest entry.  The launcher slice runs in bf16 compute, so
its losses are held to 1e-3 absolute, slice 1's launcher tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOptimizerConfig
from repro.core import build_optimizer as jax_build_optimizer
from repro.core import make_optimizer as jax_make_optimizer
from repro_torch import tree
from repro_torch.config import OptimizerConfig
from repro_torch.convert import baseline_state_from_numpy, params_from_numpy
from repro_torch.core import make_optimizer
from repro_torch.core.adafactor import AdafactorState
from repro_torch.core.build import build_optimizer
from repro_torch.core.came import CAMEState
from repro_torch.core.types import find_states
from test_torch_parity import SEQ, _close_rel, _grads, _jax_params
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

CASES = {
    "adafactor": dict(name="adafactor"),
    "adafactor-constant-b2": dict(name="adafactor", b2_schedule=False),
    "adafactor-relative-step": dict(name="adafactor", relative_step=True),
    "adafactor-b1-0": dict(name="adafactor", b1=0.0),
    "came": dict(name="came"),
}


def _cfg(**kw):
    base = dict(lr=3e-3, schedule="cosine", warmup_steps=2, total_steps=6,
                min_lr=5e-4, weight_decay=0.1, min_dim_factor=64)
    base.update(kw)
    return base


def _jax_state_of(jst, cls_name):
    """The preconditioner's state inside a JAX chain state."""
    (sub,) = [s for s in jst if type(s).__name__ == cls_name]
    return jax.device_get(sub)


def _run_jax(jopt, params_np, steps, state=None):
    jparams = jax.tree.map(jnp.asarray, params_np)
    jst = jopt.init(jparams) if state is None else state
    jupdate = jax.jit(jopt.update)
    flat_np = tree.flatten(params_np)
    outs = []
    for t in range(1, steps + 1):
        jg = tree.unflatten({k: jnp.asarray(v)
                             for k, v in _grads(flat_np, t).items()})
        ju, jst = jupdate(jg, jst, jparams)
        outs.append(tree.flatten(jax.device_get(ju)))
    return outs, jst


def _run_port(topt, params_np, steps, state=None):
    tparams = tree.flatten(params_from_numpy(params_np))
    tst = topt.init(tparams) if state is None else state
    flat_np = tree.flatten(params_np)
    outs = []
    for t in range(1, steps + 1):
        tu, tst = topt.update({k: torch.tensor(v) for k, v in
                               _grads(flat_np, t).items()}, tst, tparams)
        outs.append(tu)
    return outs, tst


def _hold_states(tsub, jsub, what):
    assert tsub.step == int(jsub.step)
    for tl, jl in zip(tsub.leaves, jsub.leaves):
        for f in dataclasses.fields(tl):
            a, b = getattr(tl, f.name), getattr(jl, f.name)
            assert (a is None) == (b is None), (what, f.name)
            if a is not None:
                _close_rel(a, b, 1e-5, f"{what} {f.name}")


@pytest.mark.parametrize("case", list(CASES))
def test_baseline_matches_jax(case):
    """6 steps of the built chain on the GPT-2 smoke parameters, factored
    (min(m, n) >= 64) and dense leaves, against the JAX package's."""
    _, params_np = _jax_params()
    kw = _cfg(**CASES[case])
    jouts, jst = _run_jax(jax_build_optimizer(JOptimizerConfig(**kw)),
                          params_np, 6)
    touts, tst = _run_port(build_optimizer(OptimizerConfig(**kw)),
                           params_np, 6)
    for t, (tu, ju) in enumerate(zip(touts, jouts), 1):
        for k in tu:
            _close_rel(tu[k], ju[k], 1e-5, f"update {k} at step {t}")
    name = "AdafactorState" if kw["name"] == "adafactor" else "CAMEState"
    (tsub,) = find_states(tst, AdafactorState if kw["name"] == "adafactor"
                          else CAMEState)
    jsub = _jax_state_of(jst, name)
    assert sum(leaf.r is not None for leaf in tsub.leaves) >= 5
    _hold_states(tsub, jsub, case)


@pytest.mark.parametrize("stage", ["clip_update_rms", "clip_by_global_norm",
                                   "scale_by_relative_step"])
def test_stages_match_jax(stage):
    """The stages the baselines' chains add, on the smoke parameters and
    gradients scaled so that both clips engage, three steps (the relative
    step's count), against the JAX package's stages."""
    from repro.core import transform as JT
    from repro.core import types as JTy
    from repro_torch.core import transform as TT
    from repro_torch.core import types as TTy
    _, params_np = _jax_params()
    flat_np = tree.flatten(params_np)
    make = {"clip_update_rms": (JT.clip_update_rms(0.1),
                                TT.clip_update_rms(0.1)),
            "clip_by_global_norm": (JTy.clip_by_global_norm(0.3),
                                    TTy.clip_by_global_norm(0.3)),
            "scale_by_relative_step": (JT.scale_by_relative_step(),
                                       TT.scale_by_relative_step())}
    jt, tt = make[stage]
    jparams = jax.tree.map(jnp.asarray, params_np)
    tparams = tree.flatten(params_from_numpy(params_np))
    jst, tst = jt.init(jparams), tt.init(tparams)
    for t in range(1, 4):
        g_np = {k: 30.0 * v for k, v in _grads(flat_np, t).items()}
        ju, jst = jt.update(tree.unflatten({k: jnp.asarray(v)
                                            for k, v in g_np.items()}),
                            jst, jparams)
        tu, tst = tt.update({k: torch.tensor(v) for k, v in g_np.items()},
                            tst, tparams)
        ju = tree.flatten(jax.device_get(ju))
        for k in tu:
            _close_rel(tu[k], ju[k], 1e-6, f"{stage} {k} step {t}")
            assert not np.allclose(ju[k], g_np[k])     # the stage acted


def test_came_refuses_b1_0():
    with pytest.raises(ValueError, match="b1 > 0"):
        build_optimizer(OptimizerConfig(**_cfg(name="came", b1=0.0)))


@pytest.mark.parametrize("name", ["adafactor", "came"])
def test_make_optimizer_matches_build_optimizer(name):
    """The kwargs registry builds the same chain as build_optimizer's
    (constant lr, no decay mask), held bitwise in the port and to the
    JAX package's make_optimizer."""
    _, params_np = _jax_params()
    kw = dict(lr=1e-3, b1=0.9, weight_decay=0.1, min_dim_factor=64)
    touts, _ = _run_port(make_optimizer(name, **kw), params_np, 3)
    bouts, _ = _run_port(build_optimizer(OptimizerConfig(
        name=name, schedule="constant", b2_schedule=True, **kw)),
        params_np, 3)
    jouts, _ = _run_jax(jax_make_optimizer(name, **kw), params_np, 3)
    for tu, bu, ju in zip(touts, bouts, jouts):
        for k in tu:
            assert torch.equal(tu[k], bu[k]), k
            _close_rel(tu[k], ju[k], 1e-5, k)


@pytest.mark.parametrize("name", ["adafactor", "came"])
def test_state_from_numpy_continues_jax_run(name):
    """``convert.baseline_state_from_numpy``: the port picks up a JAX
    Adafactor / CAME state after 3 steps and its next 3 updates match
    JAX's."""
    _, params_np = _jax_params()
    kw = _cfg(name=name)
    jopt = jax_build_optimizer(JOptimizerConfig(**kw))
    _, jst = _run_jax(jopt, params_np, 3)
    jouts, _ = _run_jax(jopt, params_np, 3, state=jst)
    topt = build_optimizer(OptimizerConfig(**kw))
    tst = topt.init(tree.flatten(params_from_numpy(params_np)))
    sub = _jax_state_of(jst, "AdafactorState" if name == "adafactor"
                        else "CAMEState")
    # the chain's state: (preconditioner, decay, schedule, sign)
    counts = [s for s in jax.device_get(jst) if hasattr(s, "count")]
    tst = (baseline_state_from_numpy(int(sub.step), sub.leaves),
           tst[1], dataclasses.replace(tst[2], count=int(counts[0].count)),
           tst[3])
    touts, _ = _run_port(topt, params_np, 3, state=tst)
    for tu, ju in zip(touts, jouts):
        for k in tu:
            _close_rel(tu[k], ju[k], 1e-5, k)


@pytest.mark.parametrize("name", ["adafactor", "came"])
def test_launcher_matches_jax_launcher(name):
    """``repro_torch.launch.train --smoke --device cpu --optimizer <name>``
    (no mixed groups, as the JAX launcher) for 6 steps against the JAX
    launcher's configuration from the same init, in bf16 compute."""
    from repro.data import DataConfig as JaxDataConfig
    from repro.launch.train import optimizer_config as jax_opt_config
    from repro.train import LoopConfig as JaxLoopConfig
    from repro.train import train as jax_train
    from repro_torch.launch import train as launcher

    steps = 6
    jmodel, params_np = _jax_params(dtype="bfloat16")
    _, jhist = jax_train(
        jmodel, jax_build_optimizer(jax_opt_config(name, steps, 3e-3)),
        JaxDataConfig(vocab=512, seq_len=SEQ, global_batch=8),
        JaxLoopConfig(total_steps=steps, log_every=1))
    tstate, thist = launcher.main(
        ["--smoke", "--device", "cpu", "--optimizer", name, "--steps",
         str(steps), "--log-every", "1"],
        params=params_from_numpy(params_np))
    jl = [h["loss"] for h in jhist]
    tl = [h["loss"] for h in thist]
    assert len(tl) == steps and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=1e-3)
    cls = AdafactorState if name == "adafactor" else CAMEState
    assert isinstance(tstate.opt_state[0], cls)
