"""The port's optimizer and whole training slice against the JAX package.

Both packages start from the same GPT-2 smoke parameters (the JAX init,
carried over with ``repro_torch.convert``) and the port's S-RSI draws its
Gaussian sketches from JAX's own threefry keys (``_JaxSketch``), so the
two runs differ only by rounding.  Inputs come from numpy seeds.

Tolerances, with their reasons:
  * optimizer, fp32, 7 steps with refresh_every=3 (refresh at 1, 4, 7,
    folds between): the two frameworks sum matmuls in different orders,
    and S-RSI's power iterations amplify that in the weakest captured
    directions of Q.  The reconstruction Q U^T and the first moment stay
    within 1e-4 of each leaf's largest entry (measured: 6e-6 and 1.5e-5),
    xi within 1e-5 absolute (measured 1.4e-6), the rank k exactly.  A
    single update is held to 1e-3 (measured worst 1e-4, on a fold step):
    where the clamped low-rank term is ~0 and G is small, u_hat = G /
    sqrt(V) is ill-conditioned in V;
  * whole slice, the launcher's bf16 compute: losses at 1e-3 absolute
    (measured 1e-4) -- bf16 matmuls round in different places in XLA and
    PyTorch.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.factored import should_factor as jax_should_factor
from repro.core.rank import RankConfig as JRankConfig
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.convert import adapprox_state_from_numpy, params_from_numpy
from repro_torch.core.factored import FactoredLeaf
from repro_torch.core.rank import RankConfig
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)


# repro.core re-exports a function named ``adapprox`` over the module
JA = importlib.import_module("repro.core.adapprox")
TA = importlib.import_module("repro_torch.core.adapprox")

SEQ = 128
MIN_DIM = 64          # the launcher's min_dim_factor


def _jax_params(dtype="float32"):
    cfg = jax_smoke_config("gpt2-117m", max_seq_len=SEQ)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = jax_build_model(cfg)
    return model, jax.device_get(model.init(jax.random.PRNGKey(0)))


class _JaxSketch:
    """Sketch source for the port that returns the draws JAX's S-RSI makes:
    leaf ``i`` at step ``t`` uses ``fold_in(fold_in(PRNGKey(seed), t), i)``,
    split once per matrix of a stacked leaf.  The port calls it once per
    factored leaf on every refresh step, in flatten order; ``calls`` lists
    the (step, leaf index) pairs those calls stand for."""

    def __init__(self, flat_shapes, refresh_steps, seed=0):
        fact = [i for i, s in enumerate(flat_shapes)
                if jax_should_factor(s, MIN_DIM)]
        self.calls = [(t, i) for t in refresh_steps for i in fact]
        self.seed = seed

    def __call__(self, shape, generator):
        t, i = self.calls.pop(0)
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(self.seed), t), i)
        *bd, n, r = shape
        keys = jax.random.split(key, int(np.prod(bd))) if bd else [key]
        draws = np.stack([np.asarray(jax.random.normal(k, (n, r),
                                                       jnp.float32))
                          for k in keys])
        return torch.tensor(draws.reshape(tuple(shape)))


def _cfg_kw(**kw):
    base = dict(b1=0.9, b2=0.999, eps=1e-8, clip_d=1.0, oversample=5,
                n_iter=5, min_dim_factor=MIN_DIM, refresh_every=3, seed=0)
    base.update(kw)
    return base


def _grads(flat_np, step):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
            for k, v in flat_np.items()}


def _close_rel(a, b, rtol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, err_msg=what,
                               atol=rtol * max(float(np.max(np.abs(b))),
                                               1e-30))


@pytest.mark.parametrize("fused", [False, True])
def test_scale_by_adapprox_matches_jax(fused):
    """7 steps of the preconditioner on the GPT-2 smoke stack with fixed
    grads: refresh at t = 1, 4, 7, one-sided folds in between."""
    steps = 7
    _, params_np = _jax_params()
    flat_np = tree.flatten(params_np)
    jcfg = JA.AdapproxConfig(rank=JRankConfig(k_init=1, k_max=128,
                                              mode="paper"),
                             fused_update=fused, **_cfg_kw())
    sketch = _JaxSketch([v.shape for v in flat_np.values()], [1, 4, 7])
    tcfg = TA.AdapproxConfig(rank=RankConfig(k_init=1, k_max=128,
                                             mode="paper"),
                             fused_update=fused, sketch=sketch, **_cfg_kw())
    jopt, topt = JA.scale_by_adapprox(jcfg), TA.scale_by_adapprox(tcfg)
    jparams = jax.tree.map(jnp.asarray, params_np)
    tparams = tree.flatten(params_from_numpy(params_np))
    jst, tst = jopt.init(jparams), topt.init(tparams)
    jupdate = jax.jit(jopt.update)
    for t in range(1, steps + 1):
        g_np = _grads(flat_np, t)
        jg = tree.unflatten({k: jnp.asarray(v) for k, v in g_np.items()})
        ju, jst = jupdate(jg, jst, jparams)
        tu, tst = topt.update({k: torch.tensor(v) for k, v in g_np.items()},
                              tst, tparams)
        ju = tree.flatten(jax.device_get(ju))
        for k in flat_np:
            _close_rel(tu[k], ju[k], 1e-3, f"update {k} at step {t}")
        for k, (jl, tl) in zip(flat_np, zip(jst.leaves, tst.leaves)):
            if isinstance(tl, FactoredLeaf):
                np.testing.assert_array_equal(
                    tl.k.numpy(), np.asarray(jl.k), err_msg=f"k {k} t={t}")
    assert not sketch.calls
    for k, jl, tl in zip(flat_np, jst.leaves, tst.leaves):
        jl = jax.device_get(jl)
        _close_rel(tl.m1, jl.m1, 1e-4, f"m1 {k}")
        if isinstance(tl, FactoredLeaf):
            _close_rel(tl.q @ tl.u.transpose(-1, -2),
                       np.einsum("...mr,...nr->...mn", jl.q, jl.u), 1e-4,
                       f"Q U^T {k}")
            np.testing.assert_allclose(tl.xi.numpy(), jl.xi, atol=1e-5,
                                       err_msg=f"xi {k}")
        else:
            _close_rel(tl.v, jl.v, 1e-5, f"v {k}")


def _port_run(cfg, flat, steps, state=None):
    opt = TA.scale_by_adapprox(cfg)
    st = opt.init(flat) if state is None else state
    outs = []
    for t in range(1, steps + 1):
        g = {k: torch.tensor(v) for k, v in _grads(
            {k: p.numpy() for k, p in flat.items()}, t).items()}
        u, st = opt.update(g, st, flat)
        outs.append(u)
    return outs, st


def _leaf_tensors(leaf):
    return [x for x in dataclasses.astuple(leaf) if x is not None]


@pytest.mark.parametrize("b1", [0.9, 0.0])
def test_port_fused_equals_unfused_for_guidance_off(b1):
    """The JAX package's internal contract, held inside the port on the
    CPU: the two-pass fused tail is bitwise the unfused tail for guidance
    "off", over refresh and fold steps, factored and dense leaves."""
    _, params_np = _jax_params()
    flat = tree.flatten(params_from_numpy(params_np))
    kw = _cfg_kw(b1=b1)
    rank = RankConfig(k_init=1, k_max=128, mode="paper")
    a_out, a_st = _port_run(TA.AdapproxConfig(rank=rank, **kw), flat, 5)
    b_out, b_st = _port_run(TA.AdapproxConfig(rank=rank, fused_update=True,
                                              **kw), flat, 5)
    for ua, ub in zip(a_out, b_out):
        for k in ua:
            assert torch.equal(ua[k], ub[k]), k
    for la, lb in zip(a_st.leaves, b_st.leaves):
        for x, y in zip(_leaf_tensors(la), _leaf_tensors(lb)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("guidance", ["update", "stored"])
def test_port_fused_guidance_matches_unfused(guidance):
    """Guidance recovers its scalars algebraically from the pass-1
    partials (reassociated sums), so fused and unfused agree to fp32
    tolerance (rtol 1e-5) rather than bitwise.  As in the JAX package's
    test, the first moment is warmed up with guidance off first: at step 1
    m1 = 0 makes theta degenerate."""
    _, params_np = _jax_params()
    flat = tree.flatten(params_from_numpy(params_np))
    rank = RankConfig(k_init=1, k_max=128, mode="paper")
    _, warm = _port_run(TA.AdapproxConfig(rank=rank, **_cfg_kw()), flat, 2)
    outs = []
    for fused in (False, True):
        st = TA.AdapproxState(step=warm.step, leaves=tuple(
            dataclasses.replace(leaf, **{f: (None if x is None else x.clone())
                                         for f, x in vars(leaf).items()})
            for leaf in warm.leaves))
        cfg = TA.AdapproxConfig(rank=rank, guidance=guidance,
                                fused_update=fused, **_cfg_kw())
        outs.append(_port_run(cfg, flat, 3, state=st)[0])
    for ua, ub in zip(*outs):
        for k in ua:
            _close_rel(ub[k], ua[k], 1e-5, k)


def test_state_from_numpy_continues_jax_run():
    """convert.adapprox_state_from_numpy: the port picks up a JAX state
    after 4 steps and its 5th update (a fold step) matches JAX's."""
    _, params_np = _jax_params()
    flat_np = tree.flatten(params_np)
    kw = _cfg_kw(fused_update=True)
    jcfg = JA.AdapproxConfig(rank=JRankConfig(k_init=1, k_max=128,
                                              mode="paper"), **kw)
    jopt = JA.scale_by_adapprox(jcfg)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jst = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    for t in range(1, 6):
        jg = tree.unflatten({k: jnp.asarray(v)
                             for k, v in _grads(flat_np, t).items()})
        if t == 5:
            tst = adapprox_state_from_numpy(
                int(jst.step), jax.device_get(jst.leaves))
        ju, jst = jupdate(jg, jst, jparams)
    topt = TA.scale_by_adapprox(TA.AdapproxConfig(
        rank=RankConfig(k_init=1, k_max=128, mode="paper"), **kw))
    tu, _ = topt.update({k: torch.tensor(v)
                         for k, v in _grads(flat_np, 5).items()}, tst,
                        tree.flatten(params_from_numpy(params_np)))
    ju = tree.flatten(jax.device_get(ju))
    for k in flat_np:
        _close_rel(tu[k], ju[k], 1e-5, k)


def test_launcher_slice_tracks_jax_launcher():
    """``repro_torch.launch.train --smoke --device cpu --no-mixed-groups
    --fused-update --refresh-every 3`` for 6 steps against the JAX
    launcher's own configuration, from the same init and sketches, in the
    launcher's bf16 compute.  The rank is chosen only at step 1 in these 6
    steps (delta_s = 10 is re-counted in refreshes of T = 3), so equal
    final ranks mean equal ranks at every step."""
    from repro.core import build_optimizer as jax_build_optimizer
    from repro.data import DataConfig as JaxDataConfig
    from repro.launch.train import optimizer_config as jax_opt_config
    from repro.train import LoopConfig as JaxLoopConfig
    from repro.train import train as jax_train
    from repro_torch.core.adapprox import adapprox_state
    from repro_torch.launch import train as launcher

    steps = 6
    jmodel, params_np = _jax_params(dtype="bfloat16")
    jopt = jax_build_optimizer(jax_opt_config(
        "adapprox", steps, 3e-3, refresh_every=3, fused_update=True,
        mixed_groups=False))
    jstate, jhist = jax_train(
        jmodel, jopt, JaxDataConfig(vocab=512, seq_len=SEQ, global_batch=8),
        JaxLoopConfig(total_steps=steps, log_every=1))
    sketch = _JaxSketch([v.shape for v in tree.flatten(params_np).values()],
                        [1, 4])
    tstate, thist = launcher.main(
        ["--smoke", "--device", "cpu", "--no-mixed-groups", "--fused-update",
         "--refresh-every", "3", "--steps", str(steps), "--log-every", "1"],
        params=params_from_numpy(params_np), sketch=sketch)
    jl = [h["loss"] for h in jhist]
    tl = [h["loss"] for h in thist]
    assert len(tl) == steps and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=1e-3)
    jk = [np.asarray(leaf.k).tolist()
          for leaf in JA.adapprox_state(jstate.opt_state).leaves
          if hasattr(leaf, "q")]
    tk = [leaf.k.tolist() for leaf in adapprox_state(tstate.opt_state).leaves
          if isinstance(leaf, FactoredLeaf)]
    assert tk == jk
