"""The port's resilience layer (``repro_torch.resilience``) against the JAX
package's, on the same numpy inputs.

Counterparts of ``tests/test_resilience.py`` (guards, the injector) and
``tests/test_chaos.py`` (the NaN burst through the train loop, guards on
without faults), each also held to the JAX package where the JAX test
holds a result, and a test of the trap of an eager port: pass 2 writes
the first moment in place on the card, and the skip-step guard must
still revert it.  Where the two packages run S-RSI, the port takes JAX's
own sketches (:class:`KeyedJaxSketch`).

Tolerances, with their reasons: counters and skip decisions exactly;
updates and states of the toy Adam and Adapprox runs within 1e-5 (Adam)
and 1e-4 (Adapprox: S-RSI's power iterations amplify the frameworks'
different summation orders) of each leaf's largest entry, as in
``tests/test_torch_parity.py``; the 14-step NaN-burst run in fp32 compute
at 1e-4 relative on the losses and 1e-3 of each leaf's largest entry on
the parameters (fourteen steps of a model in two frameworks).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOptimizerConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import build_optimizer as jax_build_optimizer
from repro.core import chain as jax_chain
from repro.core import make_optimizer as jax_make_optimizer
from repro.core.rank import RankConfig as JRankConfig
from repro.data import DataConfig as JDataConfig
from repro.models import build_model as jax_build_model
from repro.resilience import FaultPlan as JFaultPlan
from repro.resilience import GuardConfig as JGuardConfig
from repro.resilience import inject_faults as jax_inject_faults
from repro.resilience.guards import guard_updates as jax_guard_updates
from repro.train import LoopConfig as JLoopConfig
from repro.train import train as jax_train
from repro_torch import tree
from repro_torch.config import OptimizerConfig
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import make_optimizer
from repro_torch.core.build import build_optimizer
from repro_torch.core.factored import FactoredLeaf
from repro_torch.core.rank import RankConfig
from repro_torch.core.types import apply_updates, chain, find_states
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import ops
from repro_torch.models.model_zoo import build_model
from repro_torch.resilience import (FaultPlan, GuardConfig, GuardedState,
                                    guard_updates, inject_faults,
                                    tree_all_finite)
from repro_torch.train.train_loop import LoopConfig, train
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

JA = importlib.import_module("repro.core.adapprox")
TA = importlib.import_module("repro_torch.core.adapprox")
CPU = torch.device("cpu")


class KeyedJaxSketch:
    """Sketch source returning the draws JAX's S-RSI makes for the step
    and leaf the port's generator stands for: the port seeds leaf ``i``'s
    generator at step ``t`` from ``(seed, t, i)``, and this source looks
    the pair up by the generator's seed, so forced refreshes, skipped
    steps and demoted leaves need no call list.  JAX's key is
    ``fold_in(fold_in(PRNGKey(seed), t), i)``, split once per matrix of a
    stacked leaf."""

    def __init__(self, steps: int, n_leaves: int, seed: int = 0):
        self.seed = seed
        self.table = {
            TA._sketch_generator(seed, t, i, CPU).initial_seed(): (t, i)
            for t in range(1, steps + 1) for i in range(n_leaves)}
        self.calls = []

    def __call__(self, shape, generator):
        t, i = self.table[generator.initial_seed()]
        self.calls.append((t, i))
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(self.seed), t), i)
        *bd, n, r = shape
        keys = jax.random.split(key, int(np.prod(bd))) if bd else [key]
        draws = np.stack([np.asarray(jax.random.normal(k, (n, r),
                                                       jnp.float32))
                          for k in keys])
        return torch.tensor(draws.reshape(tuple(shape)))


def toy_params():
    rng = np.random.default_rng(0)
    return {"b": np.zeros((48,), np.float32),
            "w": (rng.standard_normal((64, 48)) * 0.02).astype(np.float32)}


def toy_grads(t):
    rng = np.random.default_rng(100 + t)
    return {"b": rng.standard_normal(48).astype(np.float32),
            "w": rng.standard_normal((64, 48)).astype(np.float32)}


def _torch(d):
    return {k: torch.tensor(v) for k, v in d.items()}


def _close(a, b, tol, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(
        a, b, rtol=0, atol=tol * max(float(np.max(np.abs(b))), 1e-30),
        err_msg=what)


def _state_tensors(state):
    """Every tensor of an optimizer state, in a fixed order."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(state)
    return out


def test_tree_all_finite():
    ok = {"a": torch.ones(3), "b": torch.zeros((2, 2))}
    assert bool(tree_all_finite(ok))
    assert not bool(tree_all_finite({"a": torch.tensor([1.0, np.nan])}))
    assert not bool(tree_all_finite({"a": torch.tensor([np.inf])}))
    # integer leaves cannot be non-finite and must not break the check
    assert bool(tree_all_finite({"i": torch.arange(3), "f": torch.ones(2)}))
    assert bool(tree_all_finite({}))


def test_skip_step_freezes_params_and_state():
    """A NaN gradient at step 3: zero updates, the whole inner state (Adam's
    moments, its step counter, the schedule's count) as before the step,
    only the guard's counters advance; a healthy step 4 proceeds.  The
    updates of every step equal the JAX package's within 1e-5."""
    p_np = toy_params()
    opt = guard_updates(make_optimizer("adamw", lr=1e-2, weight_decay=0.1))
    jopt = jax_guard_updates(jax_make_optimizer("adamw", lr=1e-2,
                                                weight_decay=0.1),
                             JGuardConfig())
    params = _torch(p_np)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    state, jst = opt.init(params), jopt.init(jp)
    for t in (1, 2, 3, 4):
        g = toy_grads(t)
        if t == 3:
            g = {k: v.copy() for k, v in g.items()}
            for v in g.values():
                v.reshape(-1)[0] = np.nan
            pre = [x.clone() for x in _state_tensors(state.inner)]
            pre_ints = (state.inner[0].step, state.inner[2].count)
        upd, state = opt.update(_torch(g), state, params)
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp)
        for k in upd:
            _close(upd[k], ju[k], 1e-5, f"update {k} at step {t}")
        if t == 3:
            assert all(bool((u == 0).all()) for u in upd.values())
            post = _state_tensors(state.inner)
            assert len(pre) == len(post)
            assert all(torch.equal(a, b) for a, b in zip(pre, post))
            assert (state.inner[0].step, state.inner[2].count) == pre_ints
            assert state.skipped == 1 and state.last_skip == 3
        apply_updates(params, upd)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
    assert any(float(u.abs().max()) > 0 for u in upd.values())
    assert (state.steps, state.skipped, state.last_skip) == (
        int(jst.steps), int(jst.skipped), int(jst.last_skip)) == (4, 1, 3)


def test_guard_is_bitwise_noop_on_healthy_steps():
    params_a, params_b = _torch(toy_params()), _torch(toy_params())
    bare = make_optimizer("adamw", lr=1e-2, weight_decay=0.1)
    wrapped = guard_updates(make_optimizer("adamw", lr=1e-2,
                                           weight_decay=0.1))
    sa, sb = bare.init(params_a), wrapped.init(params_b)
    for t in range(1, 5):
        ua, sa = bare.update(_torch(toy_grads(t)), sa, params_a)
        ub, sb = wrapped.update(_torch(toy_grads(t)), sb, params_b)
        for k in ua:
            assert torch.equal(ua[k], ub[k])
        apply_updates(params_a, ua)
        apply_updates(params_b, ub)
    assert sb.skipped == 0 and sb.steps == 4


def test_guard_init_leaves_do_not_alias():
    """Every tensor of a fresh guarded state is its own buffer (the JAX
    test's donation concern; here, a shared buffer would let one leaf's
    update show in another's)."""
    opt = guard_updates(make_optimizer("adamw", lr=1e-2))
    state = opt.init(_torch(toy_params()))
    assert isinstance(state, GuardedState)
    ptrs = [t.data_ptr() for t in _state_tensors(state)]
    assert len(set(ptrs)) == len(ptrs)


def _guarded_cfgs(refresh_every=1, **guard):
    base = dict(lr=1e-3, min_dim_factor=32, oversample=2, n_iter=2,
                refresh_every=refresh_every)
    gk = dict(xi_trip=1e-6, max_demotions=2)
    gk.update(guard)
    return (TA.AdapproxConfig(rank=RankConfig(k_init=2, k_max=8,
                                              mode="static"),
                              guards=GuardConfig(**gk), **base,
                              sketch=KeyedJaxSketch(8, 2)),
            JA.AdapproxConfig(rank=JRankConfig(k_init=2, k_max=8,
                                               mode="static"),
                              guards=JGuardConfig(**gk), **base))


def _run_both(steps, refresh_every=1, **guard):
    """The toy parameters through the guarded Adapprox chain in both
    packages; returns each step's (port state, JAX state), asserting the
    updates agree within 1e-4 of their largest entry and every update is
    finite."""
    tcfg, jcfg = _guarded_cfgs(refresh_every, **guard)
    # the port's guarded Adapprox runs inside the skip-step guard, which
    # advances its counters; a no-op on these healthy steps
    opt, jopt = guard_updates(TA.adapprox(tcfg)), JA.adapprox(jcfg)
    p_np = toy_params()
    params = _torch(p_np)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    st, jst = opt.init(params), jopt.init(jp)
    out = []
    for t in range(1, steps + 1):
        g = toy_grads(t)
        upd, st = opt.update(_torch(g), st, params)
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp)
        assert bool(tree_all_finite(upd)), f"step {t}"
        for k in upd:
            _close(upd[k], ju[k], 1e-4, f"update {k} at step {t}")
        apply_updates(params, upd)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        out.append((TA.adapprox_state(st), JA.adapprox_state(jst)))
    return out, tcfg.sketch


def _counters(g):
    return [np.asarray(x).tolist() for x in (g.trips, g.force_refresh,
                                             g.demoted, g.trip_total,
                                             g.demotions)]


def test_xi_trip_forces_refresh_then_demotes():
    """The JAX test's schedule (refresh every step, xi_trip 1e-6,
    max_demotions 2): a trip, then a demotion at the second, then the
    dense EMA; every counter equal to JAX's at every step, the shadow
    buffer within 1e-4 of its largest entry."""
    states, _ = _run_both(4)
    for t, (ts, js) in enumerate(states, 1):
        assert _counters(ts.guards) == _counters(js.guards), f"step {t}"
        for a, b in zip(ts.guards.dense_v, js.guards.dense_v):
            _close(a, b, 1e-4, f"dense_v at step {t}")
    g1, g2, g3, g4 = (ts.guards for ts, _ in states)
    assert int(g1.trips[0]) == 1 and int(g1.force_refresh[0]) == 1
    assert int(g1.demoted[0]) == 0
    assert int(g2.demoted[0]) == 1 and int(g2.demotions) == 1
    assert int(g2.trip_total) >= 2
    assert int(g3.demoted[0]) == 1 and int(g3.trips[0]) == 0
    dv3, dv4 = g3.dense_v[0].numpy(), g4.dense_v[0].numpy()
    assert dv3.shape == (64, 48)
    assert not np.array_equal(dv3, dv4)
    assert np.all(dv3 >= 0) and np.all(np.isfinite(dv4))
    assert float(states[-1][0].leaves[1].xi) == 0.0


def test_forced_refresh_lands_off_cadence():
    """refresh_every 3 (cadence 1, 4, 7), max_demotions 3: the trip at
    step 1 forces refreshes at steps 2 and 3, off the cadence (the port
    draws a sketch for them, and Q moves, where a fold keeps it), and the
    third trip demotes; a demoted leaf draws nothing at step 4.  Counters
    equal to JAX's at every step."""
    states, sketch = _run_both(5, refresh_every=3, max_demotions=3)
    for t, (ts, js) in enumerate(states, 1):
        assert _counters(ts.guards) == _counters(js.guards), f"step {t}"
    assert sketch.calls == [(1, 1), (2, 1), (3, 1)]
    q = [ts.leaves[1].q.clone() for ts, _ in states]
    assert not torch.equal(q[0], q[1]) and not torch.equal(q[1], q[2])
    assert torch.equal(q[2], q[3]) and torch.equal(q[3], q[4])
    assert [int(ts.guards.demoted[0]) for ts, _ in states] == [0, 0, 1, 1,
                                                              1]


def test_no_demotion_without_budget():
    states, _ = _run_both(3, max_demotions=0)
    ts, js = states[-1]
    assert _counters(ts.guards) == _counters(js.guards)
    g = ts.guards
    assert int(g.trip_total) >= 3 and int(g.demotions) == 0
    assert int(g.demoted[0]) == 0 and g.dense_v == ()


def test_inject_faults_schedule_is_exact():
    plan = FaultPlan(nan_steps=(2,), inf_steps=(3,))
    assert plan.fault_steps == (2, 3) == JFaultPlan(
        nan_steps=(2,), inf_steps=(3,)).fault_steps
    inj, jinj = inject_faults(plan), jax_inject_faults(
        JFaultPlan(nan_steps=(2,), inf_steps=(3,)))
    grads = {"a": torch.ones(4)}
    state, jstate = inj.init(grads), jinj.init({"a": jnp.ones(4)})
    for t in range(1, 5):
        out, state = inj.update(grads, state)
        jout, jstate = jinj.update({"a": jnp.ones(4)}, jstate)
        np.testing.assert_array_equal(out["a"].numpy(), np.asarray(jout["a"]))
        assert state == int(jstate) == t
    assert torch.equal(grads["a"], torch.ones(4))


def _chaos_opt_config(guards=True):
    """``tests/test_chaos.py``'s guarded Adapprox (static rank 4,
    refresh_every 2, so checkpoints and skips land mid-interval)."""
    return dict(name="adapprox", schedule="constant", lr=3e-3,
                weight_decay=0.1, k=4, rank_mode="static",
                min_dim_factor=32, implicit=False, refresh_every=2,
                guards=guards)


def test_nan_burst_skips_exactly_and_matches_jax():
    """``tests/test_chaos.py``'s NaN burst (NaN at 5 and 6, Inf at 11, 14
    steps) through both train loops from the same init, in fp32 compute:
    3 skips, the last at 11, every parameter finite, the loss falls; the
    losses within 1e-4 relative of JAX's, the parameters within 1e-3 of
    each leaf's largest entry, the guard counters and ranks equal."""
    steps = 14
    cfg = dataclasses.replace(jax_smoke_config("gpt2-117m", vocab=64,
                                               max_seq_len=32),
                              dtype="float32")
    jmodel = jax_build_model(cfg)
    init = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    jopt = jax_chain(jax_inject_faults(JFaultPlan(nan_steps=(5, 6),
                                                  inf_steps=(11,))),
                     jax_build_optimizer(JOptimizerConfig(
                         **_chaos_opt_config())))
    jstate, jhist = jax_train(jmodel, jopt, JDataConfig(vocab=64, seq_len=32,
                                                        global_batch=4),
                              JLoopConfig(total_steps=steps, log_every=1))
    n_leaves = len(tree.flatten(init))
    opt = chain(inject_faults(FaultPlan(nan_steps=(5, 6), inf_steps=(11,))),
                build_optimizer(OptimizerConfig(**_chaos_opt_config()),
                                sketch=KeyedJaxSketch(steps, n_leaves)))
    tcfg = dataclasses.replace(get_smoke_config("gpt2-117m", vocab=64,
                                                max_seq_len=32),
                               dtype="float32")
    state, hist = train(build_model(tcfg), opt,
                        DataConfig(vocab=64, seq_len=32, global_batch=4),
                        LoopConfig(total_steps=steps, log_every=1),
                        device=CPU, params=params_from_numpy(init))
    gs = state.opt_state[1]
    assert (gs.skipped, gs.last_skip) == (3, 11)
    jgs = jstate.opt_state[1]
    assert (int(jgs.skipped), int(jgs.last_skip)) == (3, 11)
    for p in state.params.values():
        assert bool(torch.isfinite(p).all())
    losses = [h["loss"] for h in hist]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, [h["loss"] for h in jhist],
                               rtol=1e-4)
    jflat = tree.flatten(jax.device_get(jstate.params))
    for k, p in state.params.items():
        _close(p.detach(), jflat[k], 1e-3, f"param {k}")
    ta, ja = TA.adapprox_state(state.opt_state), JA.adapprox_state(
        jstate.opt_state)
    assert ta.step == int(ja.step) == steps - 3
    assert _counters(ta.guards) == _counters(ja.guards)
    assert [leaf.k.tolist() for leaf in ta.leaves
            if isinstance(leaf, FactoredLeaf)] == [
        np.asarray(leaf.k).tolist() for leaf in ja.leaves
        if hasattr(leaf, "q")]


def test_guards_without_faults_match_unguarded_run():
    """Guards on and no fault: the same trajectory, bitwise, as guards
    off (the port's own contract; the JAX test holds the same)."""
    cfg = get_smoke_config("gpt2-117m", vocab=64, max_seq_len=32)
    data = DataConfig(vocab=64, seq_len=32, global_batch=4)
    runs = []
    for guards in (False, True):
        state, hist = train(build_model(cfg), build_optimizer(
            OptimizerConfig(**_chaos_opt_config(guards))), data,
            LoopConfig(total_steps=6, log_every=1), device=CPU)
        runs.append(state)
    off, on = runs
    assert on.opt_state.skipped == 0
    for k in off.params:
        assert torch.equal(off.params[k], on.params[k]), k


def test_guards_run_bucketed_leaves_alone():
    """Under the guards ``bucketed`` runs every factored leaf alone, as in
    the JAX package (a bucket would batch the per-leaf demotion): a
    bucketed guarded run, whose wq and wo share a shape, is bitwise the
    unbucketed one."""
    cfg = get_smoke_config("gpt2-117m", vocab=64, max_seq_len=32)
    data = DataConfig(vocab=64, seq_len=32, global_batch=4)
    states = []
    for bucketed in (False, True):
        ocfg = OptimizerConfig(**dict(_chaos_opt_config(), bucketed=bucketed,
                                      fused_update=True))
        state, _ = train(build_model(cfg), build_optimizer(ocfg), data,
                         LoopConfig(total_steps=3, log_every=1), device=CPU)
        states.append(state)
    for k, p in states[0].params.items():
        assert torch.equal(p, states[1].params[k]), k


def _card_like_pass2(monkeypatch, honour_in_place=True):
    """Stand-in for pass 2 on the card, on the CPU: the new first moment
    is written where the card's dispatch writes it, over ``m1`` unless
    the caller passes ``in_place=False`` (with ``honour_in_place=False``,
    over ``m1`` always)."""
    plain = ops.fused_apply

    def card_like(u_hat, m1, denom, b1, out_scale, store_scale,
                  shared_out=False, in_place=True):
        m_out, m1_new = plain(u_hat, m1, denom, b1, out_scale, store_scale,
                              shared_out=shared_out)
        if m1 is None:
            return m_out, m1_new
        in_place = in_place or not honour_in_place
        target = m1 if in_place else torch.empty_like(m1)
        target.copy_(m1_new)
        return (target if shared_out else m_out), target

    monkeypatch.setattr(ops, "fused_apply", card_like)


def _m1s(state):
    return [leaf.m1.clone() for leaf in TA.adapprox_state(state).leaves
            if leaf.m1 is not None]


@pytest.mark.parametrize("keep", [True, False])
def test_guard_reverts_m1_written_in_place(monkeypatch, keep):
    """The trap of an eager port.  With pass 2 writing ``m1`` in place as
    on the card, a NaN step still leaves every ``m1`` (and the whole
    state) bitwise as it was, because a guarded Adapprox has pass 2 write
    a fresh buffer (``in_place=False``); with the write forced in place
    (``keep=False``) the same step writes NaN into the old ``m1``, which
    is the failure this design prevents."""
    _card_like_pass2(monkeypatch, honour_in_place=keep)
    cfg = get_smoke_config("gpt2-117m", vocab=64, max_seq_len=32)
    ocfg = OptimizerConfig(**dict(_chaos_opt_config(), fused_update=True))
    opt = chain(inject_faults(FaultPlan(nan_steps=(3,))),
                build_optimizer(ocfg))
    data = DataConfig(vocab=64, seq_len=32, global_batch=4)
    state, _ = train(build_model(cfg), opt, data,
                     LoopConfig(total_steps=2, log_every=1), device=CPU)
    before = [x.clone() for x in _state_tensors(state.opt_state)]
    m1_before = _m1s(state.opt_state)
    params_before = {k: p.detach().clone() for k, p in state.params.items()}
    state, _ = train(build_model(cfg), opt, data,
                     LoopConfig(total_steps=3, log_every=1), device=CPU,
                     state=state)
    assert state.opt_state[1].skipped == 1
    for k, p in state.params.items():
        assert torch.equal(p, params_before[k]), k
    m1_after = _m1s(state.opt_state)
    if keep:
        assert all(torch.equal(a, b) for a, b in zip(m1_before, m1_after))
        after = _state_tensors(state.opt_state)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
    else:
        assert any(not bool(torch.isfinite(m).all()) for m in m1_after)
    assert find_states(state.opt_state, GuardedState)


def test_guard_refuses_unguarded_adapprox_and_unsettled_state():
    """The wrapper refuses an inner Adapprox without ``guards`` (its pass
    2 would write ``m1`` in place on the card); a guarded Adapprox stepped
    outside the wrapper refuses its own unsettled state; inside it, the
    wrapper settles the counters before it returns."""
    params = _torch(toy_params())
    tcfg, _ = _guarded_cfgs()
    bare = dataclasses.replace(tcfg, guards=None)
    with pytest.raises(ValueError, match="AdapproxConfig.guards"):
        guard_updates(TA.adapprox(bare)).init(params)
    stage = TA.adapprox(tcfg)
    state = stage.init(params)
    _, state = stage.update(_torch(toy_grads(1)), state, params)
    assert TA.adapprox_state(state).pending is not None
    with pytest.raises(ValueError, match="unsettled"):
        stage.update(_torch(toy_grads(2)), state, params)
    wrapped = guard_updates(stage)
    gstate = wrapped.init(params)
    _, gstate = wrapped.update(_torch(toy_grads(1)), gstate, params)
    inner = TA.adapprox_state(gstate.inner)
    assert inner.pending is None and int(inner.guards.trips[0]) == 1
