"""The port's distributed training path on several ranks: one 8-rank gloo
spawn on the CPU (``_torch_mesh_ranks.py``) runs every scenario, and the
tests read what its rank 0 wrote.

The contracts are the JAX package's (``tests/test_sharded_train.py``), on
the smoke GPT-2 with the mixed three-family partition (count-min sketch
on the token embedding, Adapprox on the matrices, dense Adam on the
rest), started from the JAX init (``repro_torch.convert``) with JAX's
S-RSI draws:

  * a checkpoint saved at step 3 of 5 on (4, 2) restores bitwise on
    (2, 4), (8,) and without a mesh, the partition's labels and the
    sketch tables included;
  * same-mesh restart is bitwise;
  * a restore equals the live state re-placed (single-device
    continuation from either is bitwise the same);
  * losses across meshes, against the single-device port and against
    the JAX package's training loop from the same init and draws agree
    within rtol 1e-3, JAX's cross-mesh contract (the batch split changes
    the order of the gradient sums); so do the launcher's ``--mesh 4,2``
    run (its default mixed groups, bf16 compute), the launcher without a
    mesh and the JAX launcher's run;
  * the manifest carries JAX's spec string for every leaf;
  * the step runs on each rank's blocks (``train/steps.py``): on the
    gather route (every product whole) one step's gradient blocks on
    (4, 2), (2, 4) and (8,), under remat none and full, are bitwise the
    slices of the gather design's (the whole gradient on the rank's batch
    block, ``comm.all_sum`` in rank order, kept in
    ``_torch_mesh_ranks.gather_step``), and every optimizer the launcher
    offers keeps its state and parameter blocks within 1e-4 of each
    leaf's largest entry of that design's for 3 steps on (4, 2), Adapprox
    also at microbatches 2 and under remat full (CAME step by step: see
    :func:`test_blocked_optimizer_state_matches_gather_design`);
  * with the products split over ``model`` (the default ``tp`` route:
    heads, MLP hidden units, vocabulary) on (4, 2) (every leaf its
    rank's block), (2, 4) (the kv leaves gathered and sliced) and (1, 8)
    (the q heads misaligned, half the ranks without one), in fp32
    compute: one step's gradient blocks, and Adapprox's state and
    parameter blocks for 3 steps, within 1e-3 of each leaf's largest
    entry of the gather design's; on (4, 2) no leaf is gathered over
    ``model`` and each rank's attention sees H / M q heads.

Besides: the MoE mesh paths against JAX's ``moe_apply_local`` (rtol 2e-4,
atol 2e-5, ``tests/test_moe_multidevice.py``'s tolerance) and their
gradients against the port's single-shard path; the 4-stage pipeline
against sequential application, in the port and in JAX's
``stage_fn_from_layers`` on one device; the elastic restore past a
bit-flipped newest checkpoint onto the six survivors' (3, 2) mesh.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
from repro.config import ModelConfig as JModelConfig
from repro.config import MoESpec as JMoESpec
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import default_mixed_groups as jax_mixed_groups
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import build_optimizer as jax_build_optimizer
from repro.core import types as JT
from repro.data import DataConfig as JDataConfig
from repro.distributed import sharding as JSH
from repro.distributed.pipeline import split_stages as jax_split_stages
from repro.launch.train import optimizer_config as jax_launcher_config
from repro.distributed.pipeline import \
    stage_fn_from_layers as jax_stage_fn_from_layers
from repro.models import build_model as jax_build_model
from repro.models import moe as JMOE
from repro.train import LoopConfig as JLoopConfig
from repro.train import train as jax_train
from repro.train.steps import TrainState as JTrainState
from repro_torch.core.adapprox import _sketch_generator
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

RTOL = 1e-3                       # JAX's cross-mesh contract
MOE_TOL = dict(rtol=2e-4, atol=2e-5)


class RecordingJaxSketch:
    """S-RSI sketch source of the port returning JAX's draws for the step
    and leaf a generator stands for (``fold_in(fold_in(PRNGKey(seed), t),
    i)``, split once a matrix of a stacked leaf), and keeping them by the
    generator's seed for the ranks."""

    def __init__(self, steps=5, n_leaves=64, seed=0):
        self.seed = seed
        self.keys = {_sketch_generator(seed, t, i, torch.device("cpu"))
                     .initial_seed(): (t, i)
                     for t in range(1, steps + 1) for i in range(n_leaves)}
        self.table = {}

    def __call__(self, shape, generator):
        t, i = self.keys[generator.initial_seed()]
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(self.seed), t), i)
        *bd, n, r = shape
        keys = jax.random.split(key, int(np.prod(bd))) if bd else [key]
        arr = np.stack([np.asarray(jax.random.normal(k, (n, r),
                                                     jnp.float32))
                        for k in keys]).reshape(tuple(shape))
        self.table[generator.initial_seed()] = arr
        return torch.tensor(arr)


def _jax_opt():
    return jax_build_optimizer(JOptimizerConfig(
        name="adapprox", schedule="constant", lr=1e-3, weight_decay=0.1,
        decay_mask="no_1d", min_dim_factor=32, k=4, rank_mode="static",
        implicit=False, refresh_every=2, groups=jax_mixed_groups(),
        embedding_min_rows=64, sketch_width=256, sketch_depth=2))


def _jax_model():
    return jax_build_model(jax_smoke_config("gpt2-117m", vocab=R.VOCAB,
                                            max_seq_len=R.SEQ))


MOE_CFG = JModelConfig(arch="t", family="moe", n_layers=1, d_model=32,
                       n_heads=4, n_kv_heads=4, d_ff=64, vocab=64,
                       moe=JMoESpec(n_experts=8, top_k=2, d_ff_expert=16,
                                    capacity_factor=64.0, impl="sort"))


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The single-device references (the port's, recording JAX's draws,
    and the JAX loop's), then the 8-rank spawn."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import LoopConfig, train
    torch.set_num_threads(1)
    jmodel = _jax_model()
    params_np = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    sketch = RecordingJaxSketch()
    _, hist = train(build_model(R.smoke_config()), R.make_opt(sketch),
                    DataConfig(vocab=R.VOCAB, seq_len=R.SEQ,
                               global_batch=R.BATCH),
                    LoopConfig(total_steps=5, log_every=1),
                    device=torch.device("cpu"),
                    params=params_from_numpy(params_np))
    single = [h["loss"] for h in hist]
    _, jhist = jax_train(jmodel, _jax_opt(),
                         JDataConfig(vocab=R.VOCAB, seq_len=R.SEQ,
                                     global_batch=R.BATCH),
                         JLoopConfig(total_steps=5, log_every=1))
    jax_losses = [float(h["loss"]) for h in jhist]

    # the launcher's run (smoke GPT-2, default mixed groups, bf16 compute)
    from repro_torch.launch import train as launcher
    lmodel = jax_build_model(jax_smoke_config("gpt2-117m", max_seq_len=128))
    lparams = jax.device_get(lmodel.init(jax.random.PRNGKey(0)))
    lsketch = RecordingJaxSketch(steps=6)
    _, lhist = launcher.main(R.LAUNCH_ARGV, params=params_from_numpy(lparams),
                             sketch=lsketch)
    _, ljhist = jax_train(
        lmodel, jax_build_optimizer(jax_launcher_config(
            "adapprox", 6, 3e-3, refresh_every=3, fused_update=True,
            mixed_groups=True, sketch_width=256, sketch_depth=2,
            embedding_min_rows=256)),
        JDataConfig(vocab=512, seq_len=128, global_batch=8),
        JLoopConfig(total_steps=6, log_every=1))

    moe_p = jax.device_get(JMOE.moe_init(jax.random.PRNGKey(0), MOE_CFG,
                                         32))
    moe_x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32)))
    moe_y = np.asarray(JMOE.moe_apply_local(MOE_CFG, moe_p, moe_x)[0])

    rng = np.random.default_rng(0)
    pipe_w = (rng.standard_normal((8, 16, 16)) / 4.0).astype(np.float32)
    pipe_x = rng.standard_normal((6, 4, 16)).astype(np.float32)
    stage_fn = jax_stage_fn_from_layers(lambda wl, h: jnp.tanh(h @ wl))

    def jax_seq(w):
        h = jnp.asarray(pipe_x)
        for sp in jax_split_stages(w, 4):
            h = stage_fn(sp, h)
        return h

    jout = np.asarray(jax_seq(jnp.asarray(pipe_w)))
    jgrad = np.asarray(jax.grad(lambda w: jnp.sum(jax_seq(w) ** 2))(
        jnp.asarray(pipe_w)))

    out = tmp_path_factory.mktemp("mesh")
    R.spawn(dict(params=params_np, draws=sketch.table,
                 launch_params=lparams, launch_draws=lsketch.table,
                 moe_p={k: np.asarray(v) for k, v in moe_p.items()},
                 moe_x=moe_x, pipe_w=pipe_w, pipe_x=pipe_x,
                 batches=rng.integers(0, R.VOCAB, (3, R.BATCH, R.SEQ))),
            str(out))
    res = json.loads((out / "results.json").read_text())
    arrs = dict(np.load(out / "arrays.npz"))
    return dict(res=res, arrs=arrs, single=single, jax=jax_losses,
                launcher=[h["loss"] for h in lhist],
                launcher_jax=[float(h["loss"]) for h in ljhist],
                moe_y=moe_y, jout=jout, jgrad=jgrad, params_np=params_np)


def _close(got, want, what):
    print(f"{what}: {got}\n  vs {want}")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=what)


@pytest.mark.parametrize("tag", ["42", "24", "8", "18"])
def test_mesh_losses_match_single_device_and_jax(ran, tag):
    res = ran["res"]
    got = res[f"losses_{tag}"]
    assert len(got) == 5
    _close(got, ran["single"], f"{tag} vs the port on one device")
    _close(got, ran["jax"], f"{tag} vs the JAX loop")
    _close(ran["single"], ran["jax"], "the port vs JAX, one device")


@pytest.mark.parametrize("mesh,remat", [
    (m, r) for m in ("4x2", "2x4", "8") for r in ("none", "full")]
    + [("4x2_fsdp", "none")])
def test_blocked_gradients_are_gather_design_slices(ran, mesh, remat):
    """On the gather route (the model computing every product whole),
    every rank's gradient blocks of one step, summed over the dp axes in
    the backward (reduce-scatters), equal bit for bit its slices of the
    gather design's whole gradient summed by ``comm.all_sum``: the same
    terms in the same order; also under the fsdp rule, whose (L, d)
    leaves split on their stack axis."""
    assert ran["res"][f"grads_bad_{mesh}_{remat}"] == 0


TP_TOL = 1e-3            # the split step's tolerance, JAX's cross-mesh rtol
# each mesh's route of the attention, MLP and vocabulary leaves (smoke
# GPT-2: 4 q / 2 kv heads of 16, d_ff 128, vocab 128, tied)
TP_ROUTES = {
    "4x2": dict.fromkeys(("wq", "wk", "wv", "wo"), "block"),
    "2x4": {"wq": "block", "wk": "slice", "wv": "slice", "wo": "block"},
    "1x8": dict.fromkeys(("wq", "wk", "wv", "wo"), "slice"),
}


@pytest.mark.parametrize("mesh", list(TP_ROUTES))
@pytest.mark.parametrize("remat", ["none", "full"])
def test_split_products_gradients_match_gather_design(ran, mesh, remat):
    """With the products split over ``model``, every rank's gradient
    blocks of one step are within 1e-3 of each leaf's largest entry of
    the gather design's slices: the split-product leaves (their blocks
    computed from the rank's heads, hidden units and vocabulary rows) and
    every other leaf (computed from a residual stream whose split
    products' parts are summed over ``model``, not one product: the same
    sum rounded in another order, so not bitwise).  Each attention leaf
    takes the route the mesh gives it; the MLP and the vocabulary divide
    on every mesh, so they are blocks."""
    rec = ran["res"][f"tp_grads_{mesh}_{remat}"]
    print(mesh, remat, rec["split"], rec["other"])
    assert rec["split"] <= TP_TOL and rec["other"] <= TP_TOL
    routes = rec["routes"]
    want = {f"blocks/attn/{k}": r for k, r in TP_ROUTES[mesh].items()}
    want.update({f"blocks/mlp/{k}": "block"
                 for k in ("w_up", "b_up", "w_down")})
    # b_down is added after the sum: split over data, if data has ranks
    want.update({"embed": "block", "blocks/mlp/b_down": (
        "whole" if mesh == "1x8" else "gather")})
    assert {k: routes[k] for k in want} == want


def test_split_products_chunked_attention_matches_gather_design(ran):
    """The split on (1, 8) with ``attn_impl="chunked"`` at 1024 tokens
    (the flash-attention op on each rank's heads; the ranks without a
    head run the attention on empty tensors), remat full: every gradient
    block within 1e-3 of each leaf's largest entry of the gather
    design's."""
    err = ran["res"]["tp_grads_1x8_chunked"]
    print(err)
    assert err <= TP_TOL


def test_split_products_gather_nothing_over_model_on_aligned_blocks(ran):
    """On (4, 2) every attention, MLP and vocabulary block is its rank's
    range: no leaf is all-gathered over ``model`` in the forward or the
    backward's regathers, and each rank's attention computes H / M = 2 q
    heads over KV / M = 1 kv head."""
    spy = ran["res"]["tp_spy_42"]
    assert spy["model_gathers"] == 0
    assert spy["heads"] == [[2, 1]]


BLOCKED_TOL = 1e-4


@pytest.mark.parametrize("run", list(R.OPTIMIZERS) + ["microbatches_2",
                                                     "remat_full"])
def test_blocked_optimizer_state_matches_gather_design(ran, run):
    """On the gather route, the blocked update (``core/blocks.py``: sums over the split axes
    where a reduction crosses them) keeps every state and parameter
    block within 1e-4 of each leaf's largest entry of the gather design's
    whole update after each of 3 steps (refresh, fold, refresh), and its
    losses within 1e-5.  CAME (``R.ANCHORED``) takes each step from the
    reference's state: its trajectories part wherever the summation
    order differs (it divides by row means of (u - m1)^2 that come near
    0; two gather-design runs that differ only in their dp-sum order, on
    (8,) and (4, 2), part by 8% of a leaf's largest entry in 3 steps), so
    its update is held step by step instead."""
    rec = ran["res"]["blocked_vs_gather"][run]
    print(run, rec)
    assert max(rec["opt_state"]) <= BLOCKED_TOL, rec["opt_state"]
    assert max(rec["params"]) <= BLOCKED_TOL, rec["params"]
    got, want = np.array(rec["losses"]).T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mesh", list(TP_ROUTES))
def test_split_products_state_matches_gather_design(ran, mesh):
    """With the products split over ``model``, in fp32 compute, Adapprox's
    parameter blocks after each of 3 steps (refresh, fold, refresh) and
    its state blocks after the 3 steps are within 1e-3 of each leaf's
    largest entry of the gather design's whole update, and the losses
    within 1e-5.  The state of the first steps is printed, not held: the
    split's gradients differ from the design's at ~1e-6 of a leaf's
    largest entry, which is a large part of an entry near zero, and the
    update's g / sqrt(v) carries that into ``m1`` (up to ~4e-3 of its
    largest entry after step 1 here, shrinking as the moment averages)."""
    rec = ran["res"]["blocked_vs_gather"]["tp_" + mesh]
    print(mesh, rec)
    assert rec["opt_state"][-1] <= TP_TOL, rec["opt_state"]
    assert max(rec["params"]) <= TP_TOL, rec["params"]
    got, want = np.array(rec["losses"]).T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_launcher_mesh_matches_single_device_and_jax_launcher(ran):
    """``python -m repro_torch.launch.train --smoke --mesh 4,2`` on the 8
    ranks against the launcher without a mesh and the JAX launcher's
    run, all from the JAX init with JAX's draws."""
    got = ran["res"]["launcher_42"]
    assert len(got) == 6 and got[-1] < got[0]
    _close(got, ran["launcher"], "launcher --mesh 4,2 vs one device")
    _close(got, ran["launcher_jax"], "launcher --mesh 4,2 vs the JAX "
           "launcher's run")


def test_restore_is_bitwise_on_every_mesh(ran):
    res = ran["res"]
    assert res["prefix_ok"]
    for tag in ("24", "8", "1"):
        assert res[f"restore_{tag}"], tag
    assert res["restore_24_split"] and res["restore_24_labels"]


def test_same_mesh_restart_is_bitwise(ran):
    assert ran["res"]["same_mesh_bitwise"], ran["res"]["same_mesh_losses"]


def test_checkpoint_restore_equals_live_placement(ran):
    assert ran["res"]["ckpt_eq_live"]


@pytest.mark.parametrize("tag", ["24", "8"])
def test_continuation_across_meshes(ran, tag):
    res = ran["res"]
    _close(res[f"losses_cont{tag}"], res["losses_42"][3:],
           f"continuation on {tag} vs (4, 2)")
    _close(res[f"losses_cont{tag}"], res["losses_cont1"],
           f"continuation on {tag} vs one device")


def test_sketch_tables_and_labels_kept(ran):
    res = ran["res"]
    assert res["labels"] == ["dense", "embeddings", "factored"]
    assert res["sketch_tables"] and all(t[:2] == [2, 256]
                                        for t in res["sketch_tables"])
    assert res["sketch_m_split"] and res["q_split"]


def test_state_is_split_per_rank(ran):
    """Each rank of (4, 2) stores a fraction of the state: every FSDP
    param and its moments are split over data."""
    res = ran["res"]
    from repro_torch.convert import params_from_numpy
    from repro_torch import tree
    full = sum(v.numel() * 4 for v in
               tree.flatten(params_from_numpy(ran["params_np"])).values())
    print(f"params per rank {res['param_bytes_42']} of {full} bytes; "
          f"optimizer state per rank {res['bytes_42']} bytes")
    assert res["param_bytes_42"] < full / 2


def test_manifest_specs_are_jax_strings(ran):
    """The step-3 manifest of the (4, 2) run lists, leaf for leaf, the
    spec JAX derives for the same state and mesh."""
    man = ran["res"]["manifest"]
    jmodel = _jax_model()
    opt = _jax_opt()
    mesh = {"data": 4, "model": 2}
    pspecs = JSH.param_pspecs(jmodel, mesh, "train")
    pstruct = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    sstruct = jax.eval_shape(lambda p: JTrainState.create(p, opt), pstruct)
    ospecs = JT.state_sharding_spec(opt, sstruct.opt_state, pspecs)
    from jax.sharding import PartitionSpec as JP
    spec_state = dataclasses.replace(sstruct, params=pspecs,
                                     opt_state=ospecs, step=JP())
    want = [(jax.tree_util.keystr(kp), str(s)) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                spec_state, is_leaf=lambda x: isinstance(x, JP))[0]]
    assert list(zip(man["paths"], man["specs"])) == want
    assert man["mesh_axes"] == mesh


@pytest.mark.parametrize("path", ["sharded", "ep_tp"])
def test_moe_mesh_paths(ran, path):
    """Outputs against JAX's ``moe_apply_local``; every gradient (of each
    data block's sum(y^2) + aux) against the port's single-shard path."""
    np.testing.assert_allclose(ran["arrs"][f"moe_{path}_y"], ran["moe_y"],
                               **MOE_TOL)
    errs = ran["res"][f"moe_{path}_grad_err"]
    scale = ran["res"][f"moe_{path}_grad_scale"]
    print(path, {k: (errs[k], scale[k]) for k in errs})
    for k in errs:
        assert errs[k] <= 1e-5 * max(scale[k], 1.0), (k, errs[k], scale[k])


def test_pipeline_matches_sequential(ran):
    a = ran["arrs"]
    np.testing.assert_array_equal(a["pipe_out"], a["pipe_seq_out"])
    np.testing.assert_allclose(a["pipe_grad"], a["pipe_seq_grad"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a["pipe_out"], ran["jout"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(a["pipe_grad"], ran["jgrad"], rtol=1e-4,
                               atol=1e-4)


def test_elastic_restore_onto_survivors(ran):
    assert ran["res"]["elastic_plan"] == [1, 3, 2, 6]
    assert ran["res"]["elastic_ok"]


# ---------------------------------------------------------------------------
# elastic plans (no ranks needed)
# ---------------------------------------------------------------------------

def test_plan_remesh_keeps_tp_when_possible():
    from repro.distributed.elastic import plan_remesh as jax_plan
    from repro_torch.distributed.elastic import plan_remesh
    for n, tm in [(512, 16), (256, 16), (240, 16), (8, 16), (6, 2)]:
        got, want = plan_remesh(n, target_model=tm), jax_plan(
            n, target_model=tm)
        assert (got.pods, got.data, got.model) == (
            want.pods, want.data, want.model)
        assert got.axes() == want.axes() and got.shape() == want.shape()
    p = plan_remesh(240, target_model=16)
    assert (p.pods, p.data, p.model) == (1, 15, 16)
    p = plan_remesh(8, target_model=16)
    assert p.model == 8 and p.devices <= 8


def test_remesh_after_loss():
    from repro_torch.resilience.chaos import remesh_after_loss
    plan = remesh_after_loss(lost=2, target_model=2, available_devices=8)
    assert (plan.pods, plan.data, plan.model) == (1, 3, 2)
    with pytest.raises(ValueError, match="nothing left"):
        remesh_after_loss(lost=8, available_devices=8)


# ---------------------------------------------------------------------------
# gradient compression against JAX's, with JAX's draws
# ---------------------------------------------------------------------------

class KeyedCompressionSketch:
    """JAX's compression draws, ``fold_in(fold_in(PRNGKey(seed), step),
    i)`` split once a matrix, looked up by the port's generator seed."""

    def __init__(self, steps, n_leaves, seed=0):
        from repro_torch.distributed.compression import sketch_generator
        self.seed = seed
        self.keys = {sketch_generator(seed, t, i, "cpu").initial_seed():
                     (t, i) for t in range(1, steps + 1)
                     for i in range(n_leaves)}

    def __call__(self, shape, generator):
        from repro.core.factored import batched_keys
        t, i = self.keys[generator.initial_seed()]
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(self.seed), t), i)
        *bd, n, r = shape
        keys = np.asarray(batched_keys(key, tuple(bd))).reshape(-1, 2) \
            if bd else [key]
        return torch.tensor(np.stack([
            np.asarray(jax.random.normal(jnp.asarray(k, jnp.uint32), (n, r),
                                         jnp.float32))
            for k in keys]).reshape(tuple(shape)))


def _compressors(rank, min_dim, steps, n_leaves):
    from repro.distributed.compression import CompressionConfig as JCC
    from repro.distributed.compression import compress_gradients as jcg
    from repro_torch.distributed.compression import (CompressionConfig,
                                                     compress_gradients)
    return (jcg(JCC(rank=rank, min_dim=min_dim)),
            compress_gradients(CompressionConfig(rank=rank, min_dim=min_dim),
                               sketch=KeyedCompressionSketch(steps,
                                                             n_leaves)))


def test_compression_converges_as_jax():
    """test_substrate.py's case: compressed-gradient GD on a rank-4
    optimum reaches it; and every 20th step, JAX's compressor run from
    the port's state (the same gradient, error feedback and draws) gives
    the port's compressed gradient to 1e-5 of its largest entry (the
    trajectories themselves part at fp32 rounding over 200 steps)."""
    from repro.distributed.compression import CompressionState as JCS
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    target = np.asarray(jax.random.normal(k1, (64, 4))
                        @ jax.random.normal(k2, (4, 48)))
    jcomp, comp = _compressors(8, 8, 200, 1)
    tp = {"w": torch.zeros((64, 48))}
    ts = comp.init(tp)
    tt = torch.tensor(target)
    worst = 0.0
    for t in range(200):
        g = {"w": tp["w"] - tt}
        if t % 20 == 0:
            js = JCS(step=jnp.asarray(ts.step, jnp.int32),
                     error={"w": jnp.asarray(ts.error["w"].numpy())})
            want = np.asarray(jcomp.update({"w": jnp.asarray(g["w"].numpy())},
                                           js, None)[0]["w"])
        g_hat, ts = comp.update(g, ts, tp)
        if t % 20 == 0:
            err = np.abs(g_hat["w"].numpy() - want).max() / np.abs(want).max()
            worst = max(worst, float(err))
        tp = {"w": tp["w"] - 0.5 * g_hat["w"]}
    final = float(torch.mean((tp["w"] - tt) ** 2))
    print(f"final mse {final:.3e}; worst step vs JAX {worst:.3e}")
    assert final < 1e-3, final
    assert worst <= 1e-5


def test_compression_passthrough_small_leaves():
    _, comp = _compressors(2, 8, 1, 1)
    params = {"small": torch.zeros((4, 4))}
    state = comp.init(params)
    g = {"small": torch.ones((4, 4))}
    out, state = comp.update(g, state, params)
    assert torch.equal(out["small"], g["small"])
    assert state.error["small"] is None


def test_compression_stacked_leaf_and_error_feedback():
    """A stacked (L, m, n) leaf beside a plain one and a small one: two
    updates, the compressed gradients and the error-feedback state
    within 1e-5 of their largest entry of JAX's."""
    rng = np.random.default_rng(3)
    params = {"a": np.zeros((3, 40, 24), np.float32),
              "b": np.zeros((32, 32), np.float32),
              "c": np.zeros((5,), np.float32)}
    jcomp, comp = _compressors(4, 16, 2, 3)
    js = jcomp.init(jax.tree.map(jnp.asarray, params))
    ts = comp.init({k: torch.tensor(v) for k, v in params.items()})
    for _ in range(2):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        jout, js = jcomp.update(jax.tree.map(jnp.asarray, g), js, None)
        tout, ts = comp.update({k: torch.tensor(v) for k, v in g.items()},
                               ts, None)
        for k in params:
            want = np.asarray(jout[k])
            np.testing.assert_allclose(tout[k].numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            if k != "c":
                we = np.asarray(js.error[k])
                np.testing.assert_allclose(ts.error[k].numpy(), we, rtol=0,
                                           atol=1e-5 * np.abs(we).max())
    assert ts.step == 2 and ts.error["c"] is None


# ---------------------------------------------------------------------------
# the launcher on a mesh of one rank, in this process
# ---------------------------------------------------------------------------

def test_launcher_mesh_one_rank_is_bitwise(tmp_path):
    """``--mesh 1,1 --fsdp`` starts a one-rank gloo group: every split leaf
    a DTensor, every collective an identity, so the launcher's smoke run
    (mixed groups) is bitwise the run without a mesh, losses and every
    state tensor; its checkpoint has a spec string on every leaf and
    ``mesh_axes`` {data: 1, model: 1}, and restores without a mesh
    bitwise."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.checkpoint.serialization import leaves_with_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train as launcher
    argv = ["--smoke", "--device", "cpu", "--fused-update", "--refresh-every",
            "3", "--embedding-min-rows", "256", "--sketch-width", "256",
            "--sketch-depth", "2", "--steps", "4", "--log-every", "1"]
    try:
        s0, h0 = launcher.main(argv)
        s1, h1 = launcher.main(argv + ["--mesh", "1,1", "--fsdp",
                                       "--ckpt-dir", str(tmp_path)])
        assert [h["loss"] for h in h1] == [h["loss"] for h in h0]
        assert any(isinstance(v, DTensor) for v in s1.params.values())
        full = SH.gather_tree(s1)
        pairs = list(zip(leaves_with_paths(full), leaves_with_paths(s0)))
        assert pairs and all(
            pa == pb and (torch.equal(a, b) if isinstance(a, torch.Tensor)
                          else np.array_equal(a, b))
            for (pa, a), (pb, b) in pairs)
        man = json.loads((tmp_path / "step_000000004" / "manifest.json")
                         .read_text())
        assert man["mesh_axes"] == {"data": 1, "model": 1}
        assert all(e["spec"].startswith("PartitionSpec(")
                   for e in man["leaves"])
        restored, step = CheckpointManager(CheckpointConfig(
            directory=str(tmp_path))).restore(full)
        assert step == 4 and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(restored), leaves_with_paths(full))
            if isinstance(a, torch.Tensor))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
