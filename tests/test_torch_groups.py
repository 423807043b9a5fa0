"""The port's parameter groups and the launcher's default mixed partition
(count-min sketch on embedding tables, Adapprox on matrices, dense Adam on
the rest) against the JAX package's.

Both packages start from the JAX GPT-2 smoke init (carried over with
``repro_torch.convert``), with ``embedding_min_rows`` 256 so the token
embedding (512 rows) is sketched; the port's S-RSI takes JAX's own
threefry draws (``_JaxSketch`` of ``test_torch_parity.py``), fed the
shapes of the Adapprox group's leaves only: inside a partition a leaf's
draws are keyed by its position among its group's leaves.

Tolerances are those of ``test_torch_parity.py``, for the same reasons:
one update within 1e-3 of its leaf's largest entry, factors (as Q U^T) and
moments within 1e-4, the rank k equal at every step; the launcher's bf16
losses within 1e-3 absolute.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GroupSpec as JGroupSpec
from repro.config import default_mixed_groups as jax_mixed_groups
from repro.core import adapprox_state as jax_adapprox_state
from repro.core import build_optimizer as jax_build_optimizer
from repro.core.build import group_labeler as jax_group_labeler
from repro.core.sketch import sketch_state as jax_sketch_state
from repro.launch.train import optimizer_config as jax_opt_config
from repro_torch import tree
from repro_torch.config import GroupSpec, OptimizerConfig, \
    default_mixed_groups
from repro_torch.convert import params_from_numpy
from repro_torch.core.adapprox import adapprox_state
from repro_torch.core.build import build_optimizer, group_labeler
from repro_torch.core.factored import FactoredLeaf
from repro_torch.core.sketch import SketchLeaf, sketch_state
from repro_torch.core.transform import PartitionState
from repro_torch.launch.train import optimizer_config
from test_torch_parity import MIN_DIM, SEQ, _close_rel, _grads, _JaxSketch
from test_torch_parity import _jax_params as _init_jax_params
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)


MIXED = dict(sketch_width=256, sketch_depth=2, embedding_min_rows=256)

# one JAX init per compute dtype for the whole file (numpy arrays, never
# written to)
_jax_params = functools.cache(_init_jax_params)


def _factored_shapes(flat_np, labels):
    return [v.shape for (k, v) in flat_np.items()
            if labels[k] == "factored"]


def test_group_labeler_matches_jax():
    _, params_np = _jax_params()
    flat_np = tree.flatten(params_np)
    want = tree.flatten(jax_group_labeler(jax_mixed_groups(), MIN_DIM, 256)(
        jax.tree.map(jnp.asarray, params_np)))
    got = group_labeler(default_mixed_groups(), MIN_DIM, 256)(
        tree.flatten(params_from_numpy(params_np)))
    assert got == want
    assert set(got.values()) == {"embeddings", "factored", "dense"}
    assert got["embed"] == "embeddings" and len(got) == len(flat_np)


@pytest.mark.parametrize("groups,match", [
    ((("a", GroupSpec(select="matrices")), ("a", GroupSpec())), "duplicate"),
    ((("a", GroupSpec(select="matrices")),), "catch-all")])
def test_bad_groups_raise(groups, match):
    with pytest.raises(ValueError, match=match):
        build_optimizer(OptimizerConfig(name="adamw", groups=groups))


def test_lr_scale_scales_only_its_group():
    """Two adamw groups, one at lr_scale 0.5: its updates are exactly half
    those of the same optimizer without groups; the other group's are
    unchanged."""
    params = {"b": torch.full((4,), 0.1), "w": torch.full((8, 8), 0.2)}
    grads = {"b": torch.linspace(-1, 1, 4),
             "w": torch.linspace(-1, 1, 64).reshape(8, 8)}
    base = dict(name="adamw", schedule="constant", lr=1e-2)
    ref = build_optimizer(OptimizerConfig(**base))
    grouped = build_optimizer(OptimizerConfig(**base, groups=(
        ("m", GroupSpec(select="matrices", lr_scale=0.5)),
        ("v", GroupSpec(select="rest")))))
    want, _ = ref.update(grads, ref.init(params), params)
    got, st = grouped.update(grads, grouped.init(params), params)
    assert isinstance(st, PartitionState) and st.labels == ("v", "m")
    assert torch.equal(got["b"], want["b"])
    assert torch.equal(got["w"], want["w"] * 0.5)


@pytest.mark.parametrize("fused", [False, True])
def test_mixed_chain_matches_jax(fused):
    """7 steps of the launcher's mixed partition on fixed grads: refresh at
    t = 1, 4, 7, one-sided folds between; updates of every leaf, the rank
    of every factored leaf at every step, and at the end the factors and
    moments of all three families."""
    steps = 7
    _, params_np = _jax_params()
    flat_np = tree.flatten(params_np)
    kw = dict(refresh_every=3, fused_update=fused, mixed_groups=True,
              **MIXED)
    jopt = jax_build_optimizer(jax_opt_config("adapprox", steps, 3e-3, **kw))
    jparams = jax.tree.map(jnp.asarray, params_np)
    jst = jopt.init(jparams)
    labels = dict(zip(flat_np, jst.labels))
    sketch = _JaxSketch(_factored_shapes(flat_np, labels), [1, 4, 7])
    topt = build_optimizer(optimizer_config("adapprox", steps, 3e-3, **kw),
                           sketch=sketch)
    tparams = tree.flatten(params_from_numpy(params_np))
    tst = topt.init(tparams)
    assert tst.labels == tuple(jst.labels)
    jupdate = jax.jit(jopt.update)
    for t in range(1, steps + 1):
        g_np = _grads(flat_np, t)
        ju, jst = jupdate(tree.unflatten({k: jnp.asarray(v)
                                          for k, v in g_np.items()}),
                          jst, jparams)
        tu, tst = topt.update({k: torch.tensor(v) for k, v in g_np.items()},
                              tst, tparams)
        ju = tree.flatten(jax.device_get(ju))
        for k in flat_np:
            _close_rel(tu[k], ju[k], 1e-3, f"update {k} at step {t}")
        for jl, tl in zip(jax_adapprox_state(jst).leaves,
                          adapprox_state(tst).leaves):
            if isinstance(tl, FactoredLeaf):
                np.testing.assert_array_equal(tl.k.numpy(), np.asarray(jl.k),
                                              err_msg=f"k at step {t}")
    assert not sketch.calls
    names = {lab: [k for k in flat_np if labels[k] == lab]
             for lab in ("embeddings", "factored", "dense")}
    for k, jl, tl in zip(names["factored"],
                         jax.device_get(jax_adapprox_state(jst).leaves),
                         adapprox_state(tst).leaves):
        _close_rel(tl.m1, jl.m1, 1e-4, f"m1 {k}")
        if isinstance(tl, FactoredLeaf):
            _close_rel(tl.q @ tl.u.transpose(-1, -2),
                       np.einsum("...mr,...nr->...mn", jl.q, jl.u), 1e-4,
                       f"Q U^T {k}")
    sk = [(k, jl, tl) for k, jl, tl in zip(
        names["embeddings"], jax.device_get(jax_sketch_state(jst).leaves),
        sketch_state(tst).leaves)]
    assert sk and all(isinstance(tl, SketchLeaf) for _, _, tl in sk)
    for k, jl, tl in sk:
        _close_rel(tl.table, jl.table, 1e-4, f"table {k}")
        _close_rel(tl.m, jl.m, 1e-4, f"m {k}")
    jad = jax.device_get(jst.inner["dense"][0])
    tad = tst.inner["dense"][0]
    for k in names["dense"]:
        jm, jv = tree.flatten(jad.m)[k], tree.flatten(jad.v)[k]
        _close_rel(tad.m[k], jm, 1e-4, f"adam m {k}")
        _close_rel(tad.v[k], jv, 1e-4, f"adam v {k}")


def test_adam_state_from_numpy_reads_a_partition_group():
    """convert.adam_state_from_numpy on the JAX dense group's state, whose
    moment trees hold None for the other groups' leaves."""
    from repro_torch.convert import adam_state_from_numpy
    _, params_np = _jax_params()
    jopt = jax_build_optimizer(jax_opt_config("adapprox", 4, 3e-3,
                                              mixed_groups=True, **MIXED))
    jst = jax.device_get(jopt.init(jax.tree.map(jnp.asarray, params_np)))
    jad = jst.inner["dense"][0]
    st = adam_state_from_numpy(int(jad.step), jad.m, jad.v)
    dense = [k for k, lab in zip(tree.flatten(params_np), jst.labels)
             if lab == "dense"]
    assert list(st.m) == list(st.v) == dense
    assert all(st.m[k].shape == tree.flatten(params_np)[k].shape
               for k in dense)


def test_launcher_mixed_groups_tracks_jax_launcher():
    """``repro_torch.launch.train --smoke --device cpu --fused-update
    --refresh-every 3 --embedding-min-rows 256 --sketch-width 256
    --sketch-depth 2`` for 6 steps, on its default mixed groups, against
    the JAX launcher's same run from the same init and sketches, in the
    launcher's bf16 compute.  As in test_torch_parity, the rank is chosen
    only at step 1 in 6 steps of T = 3, so equal final ranks mean equal
    ranks at every step."""
    from repro.data import DataConfig as JaxDataConfig
    from repro.train import LoopConfig as JaxLoopConfig
    from repro.train import train as jax_train
    from repro_torch.launch import train as launcher

    steps = 6
    jmodel, params_np = _jax_params(dtype="bfloat16")
    jopt = jax_build_optimizer(jax_opt_config(
        "adapprox", steps, 3e-3, refresh_every=3, fused_update=True,
        mixed_groups=True, **MIXED))
    jstate, jhist = jax_train(
        jmodel, jopt, JaxDataConfig(vocab=512, seq_len=SEQ, global_batch=8),
        JaxLoopConfig(total_steps=steps, log_every=1))
    flat_np = tree.flatten(params_np)
    labels = dict(zip(flat_np, jstate.opt_state.labels))
    sketch = _JaxSketch(_factored_shapes(flat_np, labels), [1, 4])
    tstate, thist = launcher.main(
        ["--smoke", "--device", "cpu", "--fused-update", "--refresh-every",
         "3", "--embedding-min-rows", "256", "--sketch-width", "256",
         "--sketch-depth", "2", "--steps", str(steps), "--log-every", "1"],
        params=params_from_numpy(params_np), sketch=sketch)
    assert isinstance(tstate.opt_state, PartitionState)
    assert set(tstate.opt_state.labels) == {"embeddings", "factored",
                                            "dense"}
    jl = [h["loss"] for h in jhist]
    tl = [h["loss"] for h in thist]
    assert len(tl) == steps and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=1e-3)
    jk = [np.asarray(leaf.k).tolist()
          for leaf in jax_adapprox_state(jstate.opt_state).leaves
          if hasattr(leaf, "q")]
    tk = [leaf.k.tolist() for leaf in adapprox_state(tstate.opt_state).leaves
          if isinstance(leaf, FactoredLeaf)]
    assert tk == jk and tk


def test_jax_groups_are_the_ports():
    """The port's GroupSpec and default partition mirror the JAX
    config's field for field."""
    assert [(l, dataclasses.asdict(g)) for l, g in default_mixed_groups()] \
        == [(l, dataclasses.asdict(g)) for l, g in jax_mixed_groups()]
    assert dataclasses.asdict(GroupSpec()) == dataclasses.asdict(JGroupSpec())
