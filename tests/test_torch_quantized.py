"""The port's int8 factor storage (``--quantize-factors``) against the JAX
package's.

Inputs come from numpy seeds; both packages start from the JAX GPT-2 smoke
init and the port's S-RSI takes JAX's own threefry draws (``_JaxSketch``
of ``test_torch_parity.py``).

Tolerances, with their reasons:
  * the codec (``quantize`` / ``dequantize``) is plain arithmetic on the
    same float32 inputs: q8, scale, zero and the dequantized values are
    held BITWISE equal to the JAX package's;
  * one optimizer step from the same int8 state (the JAX state carried
    over with ``repro_torch.convert``): the update within 1e-4 of its
    leaf's largest entry (measured 6e-6), the rank equal, and the
    requantized factors within one q8 step of JAX's at no more than 0.1%
    of their entries (measured: 9 of 32768 at most) -- the two frameworks'
    S-RSI factors differ by ~1e-6 relative, and ``round`` can land one
    step apart;
  * a free-running trajectory (7 steps) cannot be held that tight: the
    codec turns a 1e-6 difference into a q8 step, 1/254 of a block's
    range, and S-RSI amplifies it in the weakest captured directions, in
    the JAX package too.  So the test runs JAX a second time with every G
    moved by one ulp, and holds the port's distance from JAX (the
    relative Frobenius norm of each leaf's update) to 3x JAX's largest
    distance from itself at that step (which leaves a q8 flip reaches is
    chance) plus 1e-4 (the fp32 rounding of the two frameworks, as in
    ``test_torch_parity.py``); measured 2.3e-2 against 1.7e-2 at step 7
    with a refresh every step.  Ranks equal at EVERY step;
  * the launcher's bf16 losses within 1e-3 absolute, as in
    ``test_torch_groups.py``.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantized as JQ
from repro.core.rank import RankConfig as JRankConfig
from repro_torch import tree
from repro_torch.convert import (adapprox_state_from_numpy, params_from_numpy,
                                 quantized_from_numpy)
from repro_torch.core import quantized as TQ
from repro_torch.core.factored import FactoredLeaf
from repro_torch.core.rank import RankConfig
from repro_torch.core.types import tree_nbytes
from test_torch_parity import _cfg_kw, _close_rel, _grads, _JaxSketch
from test_torch_parity import _jax_params as _init_jax_params
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)


JA = importlib.import_module("repro.core.adapprox")
TA = importlib.import_module("repro_torch.core.adapprox")

_jax_params = functools.cache(_init_jax_params)
RANK = dict(k_init=1, k_max=128, mode="paper")


@pytest.mark.parametrize("shape,scale", [((300, 6), 3e-3),
                                         ((3, 257, 5), 1.0),
                                         ((256, 8), 1e-5),
                                         ((130, 3), 0.0)])
def test_codec_matches_jax_bitwise(shape, scale):
    """Ragged m (300, 257, 130), a batch of matrices, one whole block, and
    the all-zero init."""
    x = (np.random.default_rng(0).standard_normal(shape) * scale).astype(
        np.float32)
    want = JQ.quantize(jnp.asarray(x))
    got = TQ.quantize(torch.tensor(x))
    assert got.q8.dtype == torch.int8
    assert got.scale.shape == got.zero.shape == shape[:-2] + (
        -(-shape[-2] // TQ.BLOCK_ROWS), shape[-1])
    for name, a, b in zip(("q8", "scale", "zero"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    deq = TQ.dequantize(got).numpy()
    np.testing.assert_array_equal(deq, np.asarray(JQ.dequantize(want)))
    if scale == 0.0:
        assert not deq.any()
    # the converter carries a JAX QuantizedMatrix over unchanged
    conv = quantized_from_numpy(jax.device_get(want))
    for a, b in zip(conv, got):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_quantize_roundtrip_error_bounded():
    """As the JAX package's test: per entry at most 1/127 of its column's
    largest magnitude."""
    x = torch.tensor(np.random.default_rng(1).standard_normal((128, 16))
                     .astype(np.float32) * 3.0)
    err = torch.abs(TQ.dequantize(TQ.quantize(x)) - x)
    colmax = torch.amax(torch.abs(x), dim=0)
    assert float(torch.max(err / colmax)) <= 1.0 / 127 + 1e-6


def _cfg(dtype, b1=0.9):
    return TA.AdapproxConfig(lr=1e-2, b1=b1, b2=0.99, min_dim_factor=1,
                             oversample=2, n_iter=3, factor_dtype=dtype,
                             rank=RankConfig(k_init=8, mode="static"),
                             seed=0)


def test_int8_factors_shrink_state_4x():
    """As the JAX package's test: factor-only state (b1 = 0) under 0.30 of
    fp32's, int8 counted as one byte; and the leaves' bytes equal JAX's
    (whose state also holds a step and a PRNG key the port has not)."""
    params = {"w": torch.zeros((512, 512))}
    nb = {d: tree_nbytes(TA.scale_by_adapprox(_cfg(d)).init(params))
          for d in ("float32", "int8")}
    nbf = {d: tree_nbytes(TA.scale_by_adapprox(_cfg(d, b1=0.0)).init(params))
           for d in ("float32", "int8")}
    assert nbf["int8"] < 0.30 * nbf["float32"]
    assert nb["int8"] < nb["float32"]
    from repro.core import tree_nbytes as jax_tree_nbytes
    jcfg = JA.AdapproxConfig(b1=0.0, min_dim_factor=1, factor_dtype="int8",
                             rank=JRankConfig(k_init=8, mode="static"))
    tst = TA.scale_by_adapprox(_cfg("int8", b1=0.0)).init(params)
    jst = JA.scale_by_adapprox(jcfg).init({"w": jnp.zeros((512, 512))})
    assert tree_nbytes(tst.leaves) == jax_tree_nbytes(jst.leaves) > 0


def _refresh_steps(refresh_every, steps):
    return [t for t in range(1, steps + 1)
            if refresh_every <= 1 or t % refresh_every == 1]


def _rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("refresh_every", [1, 3])
def test_int8_adapprox_matches_jax(refresh_every):
    """7 steps of the int8 preconditioner on the GPT-2 smoke stack with
    fixed grads, port against JAX from the same init and sketches: the
    free-running trajectory (ranks equal at every step, updates in norm)
    and, at every step, one port step from JAX's own int8 state.  The
    unfused tail: the fused one gives the same bits in both packages (the
    next test; ``tests/test_fused.py`` for JAX)."""
    steps = 7
    _, params_np = _jax_params()
    flat_np = tree.flatten(params_np)
    shapes = [v.shape for v in flat_np.values()]
    kw = _cfg_kw(refresh_every=refresh_every, factor_dtype="int8")
    rsteps = _refresh_steps(refresh_every, steps)
    jopt = JA.scale_by_adapprox(JA.AdapproxConfig(rank=JRankConfig(**RANK),
                                                  **kw))
    port = lambda calls: TA.scale_by_adapprox(TA.AdapproxConfig(
        rank=RankConfig(**RANK), sketch=_JaxSketch(shapes, calls), **kw))
    topt = port(rsteps)
    jparams = jax.tree.map(jnp.asarray, params_np)
    tparams = tree.flatten(params_from_numpy(params_np))
    jst, tst = jopt.init(jparams), topt.init(tparams)
    jst_ulp = jst
    jupdate = jax.jit(jopt.update)
    for t in range(1, steps + 1):
        g_np = _grads(flat_np, t)
        tg = {k: torch.tensor(v) for k, v in g_np.items()}
        ju_ulp, jst_ulp = jupdate(tree.unflatten({
            k: jnp.asarray(np.nextafter(v, np.float32(np.inf)))
            for k, v in g_np.items()}), jst_ulp, jparams)
        ju_ulp = tree.flatten(jax.device_get(ju_ulp))
        one_u, one_st = port([t] if t in rsteps else []).update(
            tg, adapprox_state_from_numpy(int(jst.step),
                                          jax.device_get(jst.leaves)),
            tparams)
        ju, jst = jupdate(tree.unflatten({k: jnp.asarray(v)
                                          for k, v in g_np.items()}),
                          jst, jparams)
        tu, tst = topt.update(tg, tst, tparams)
        ju = tree.flatten(jax.device_get(ju))
        jax_drift = max(_rel_fro(ju_ulp[k], ju[k]) for k in flat_np)
        for k in flat_np:
            _close_rel(one_u[k], ju[k], 1e-4, f"one step: update {k} t={t}")
            assert _rel_fro(tu[k], ju[k]) <= 3 * jax_drift + 1e-4, (k, t)
        flips = total = 0
        for k, jl, ol, tl in zip(flat_np, jax.device_get(jst.leaves),
                                 one_st.leaves, tst.leaves):
            if not isinstance(tl, FactoredLeaf):
                continue
            for st in (ol, tl):
                np.testing.assert_array_equal(st.k.numpy(), np.asarray(jl.k),
                                              err_msg=f"k {k} t={t}")
            for jf, of in ((jl.q, ol.q), (jl.u, ol.u)):
                d = np.abs(of.q8.numpy().astype(np.int32)
                           - np.asarray(jf.q8).astype(np.int32))
                assert d.max() <= 1, (k, t)
                flips += int(np.count_nonzero(d))
                total += d.size
        assert flips <= 1e-3 * total, (flips, total, t)


@pytest.mark.parametrize("refresh_every", [1, 3])
def test_port_int8_fused_equals_unfused_bitwise(refresh_every):
    """The JAX package's contract (tests/test_fused.py), held inside the
    port on the CPU: int8 factors through the fused pass 1 (dequantized
    where they are read) give the same bits as the unfused tail
    (dequantized before the step), updates and requantized state, over
    refresh and fold steps."""
    _, params_np = _jax_params()
    flat_np = tree.flatten(params_np)
    runs = []
    for fused in (False, True):
        cfg = TA.AdapproxConfig(
            rank=RankConfig(**RANK),
            **_cfg_kw(refresh_every=refresh_every, fused_update=fused,
                      factor_dtype="int8"))
        opt = TA.scale_by_adapprox(cfg)
        params = tree.flatten(params_from_numpy(params_np))
        st = opt.init(params)
        outs = []
        for t in range(1, 6):
            u, st = opt.update({k: torch.tensor(v) for k, v in
                                _grads(flat_np, t).items()}, st, params)
            outs.append(u)
        runs.append((outs, st))
    (a_out, a_st), (b_out, b_st) = runs
    for ua, ub in zip(a_out, b_out):
        for k in ua:
            assert torch.equal(ua[k], ub[k]), k
    for la, lb in zip(a_st.leaves, b_st.leaves):
        for f in dataclasses.fields(la):
            x, y = getattr(la, f.name), getattr(lb, f.name)
            if isinstance(x, TQ.QuantizedMatrix):
                assert all(torch.equal(p, q) for p, q in zip(x, y)), f.name
            elif x is not None:
                assert torch.equal(x, y), f.name


def test_launcher_quantize_factors_tracks_jax_launcher():
    """``repro_torch.launch.train --smoke --device cpu --quantize-factors
    --fused-update --refresh-every 3`` on the default mixed groups for 6
    steps against the JAX launcher's same run, from the same init and
    sketches, in the launcher's bf16 compute: losses, ranks, and int8
    factors in the final state."""
    from repro.core import adapprox_state as jax_adapprox_state
    from repro.core import build_optimizer as jax_build_optimizer
    from repro.data import DataConfig as JaxDataConfig
    from repro.launch.train import optimizer_config as jax_opt_config
    from repro.train import LoopConfig as JaxLoopConfig
    from repro.train import train as jax_train
    from repro_torch.core.adapprox import adapprox_state
    from repro_torch.launch import train as launcher
    from test_torch_groups import MIXED, _factored_shapes

    steps = 6
    jmodel, params_np = _jax_params(dtype="bfloat16")
    jopt = jax_build_optimizer(jax_opt_config(
        "adapprox", steps, 3e-3, refresh_every=3, fused_update=True,
        quantize_factors=True, mixed_groups=True, **MIXED))
    jstate, jhist = jax_train(
        jmodel, jopt, JaxDataConfig(vocab=512, seq_len=128, global_batch=8),
        JaxLoopConfig(total_steps=steps, log_every=1))
    flat_np = tree.flatten(params_np)
    labels = dict(zip(flat_np, jstate.opt_state.labels))
    tstate, thist = launcher.main(
        ["--smoke", "--device", "cpu", "--quantize-factors",
         "--fused-update", "--refresh-every", "3", "--embedding-min-rows",
         "256", "--sketch-width", "256", "--sketch-depth", "2", "--steps",
         str(steps), "--log-every", "1"],
        params=params_from_numpy(params_np),
        sketch=_JaxSketch(_factored_shapes(flat_np, labels), [1, 4]))
    jl = [h["loss"] for h in jhist]
    tl = [h["loss"] for h in thist]
    assert len(tl) == steps and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=1e-3)
    jleaves = [leaf for leaf in jax_adapprox_state(jstate.opt_state).leaves
               if hasattr(leaf, "q")]
    tleaves = [leaf for leaf in adapprox_state(tstate.opt_state).leaves
               if isinstance(leaf, FactoredLeaf)]
    assert tleaves and all(isinstance(leaf.q, TQ.QuantizedMatrix)
                           for leaf in tleaves)
    assert ([leaf.k.tolist() for leaf in tleaves]
            == [np.asarray(leaf.k).tolist() for leaf in jleaves])


@pytest.mark.parametrize("arch", ["gpt2-117m", "gpt2-345m"])
def test_int8_state_bytes_equal_jax_count(arch):
    """Optimizer-state bytes of ``adapprox_kmax_int8`` (bench_memory.py's
    config at b1 = 0.9) at full size, counted on meta tensors: the port's
    equal the JAX package's own ``state_mb`` (which also counts its step,
    PRNG key and schedule counter, 16 bytes), and ``chip_smoke.py`` holds
    the card's count to these numbers.  BENCH_memory.json's 540.1 / 1547.0
    MB predate the per-256-row-block (scale, zero) codec: with the one
    absmax scale per column and matrix that the codec had then, the same
    state gives the JSON's numbers."""
    import json
    import sys
    from pathlib import Path

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro_torch.config import OptimizerConfig
    from repro_torch.core.build import build_optimizer

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "benchmarks"))
    sys.path.insert(0, str(root))
    try:
        from bench_memory import state_mb
        from chip_smoke import INT8_STATE_MB
    finally:
        sys.path[:2] = []
    shapes = jax.eval_shape(jax_build_model(jax_get_config(arch)).init,
                            jax.random.PRNGKey(0))
    flat = {k: torch.empty(v.shape, device="meta")
            for k, v in tree.flatten(shapes).items()}
    cfg = OptimizerConfig(name="adapprox", b1=0.9, k=1, k_max=10**9,
                          rank_mode="paper", factor_dtype="int8",
                          implicit=False, schedule="constant", lr=1e-3,
                          weight_decay=0.0)
    state = build_optimizer(cfg).init(flat)
    port_bytes = tree_nbytes(state)
    jax_mb = state_mb(arch, 0.9, "adapprox_kmax_int8")
    assert jax_mb == INT8_STATE_MB[arch]
    assert 0 <= round(jax_mb * 1e6) - port_bytes <= 16
    cells = old = 0
    for leaf in TA.adapprox_state(state).leaves:
        if isinstance(leaf, FactoredLeaf):
            for f in (leaf.q, leaf.u):
                cells += tree_nbytes((f.scale, f.zero))
                old += 4 * f.q8.numel() // f.q8.shape[-2]
    rows = json.loads((root / "BENCH_memory.json").read_text())
    (json_mb,) = [r["state_mb"] for r in rows["results"]["table2"]
                  if (r["arch"], r["b1"], r["method"])
                  == (arch, 0.9, "adapprox_kmax_int8")]
    assert abs((port_bytes - cells + old) / 1e6 - json_mb) < 0.05
