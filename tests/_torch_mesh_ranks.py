"""The ranks of ``test_torch_mesh.py``: one 8-rank gloo spawn on the CPU
runs every multi-rank scenario and rank 0 writes what the tests read.

The scenarios are the JAX package's sharded-training contracts
(``tests/test_sharded_train.py``), on the smoke GPT-2 with the mixed
three-family partition, plus the MoE mesh paths, the 4-stage GPipe
pipeline and the elastic restore onto the six survivors of eight ranks;
and the blocked step held to the gather design (:func:`gather_step`, the
mesh step as it was before it ran on blocks, kept here as the
reference): on the gather route its gradient blocks bitwise, every
optimizer's state blocks after 3 steps; with the products split over
``model`` (the ``tp`` route) its gradient blocks, state and parameters
within 1e-3, no attention, MLP or vocabulary leaf gathered over ``model``
where every block is its rank's range, and the heads a rank computes.
Inputs (the JAX init, JAX's S-RSI draws keyed by the port's generator
seeds, the MoE and pipeline arrays) come from the test in a pickle.
"""
import json
import os
import pickle
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

VOCAB, SEQ, BATCH = 128, 32, 8
WORLD = 8


class TableSketch:
    """S-RSI sketch source reading the draws the test looked up by the
    port's generator seed (JAX's threefry draws for that step and leaf)."""

    def __init__(self, table: dict):
        self.table = table

    def __call__(self, shape, generator):
        arr = self.table[generator.initial_seed()]
        assert tuple(arr.shape) == tuple(shape), (arr.shape, shape)
        return torch.tensor(arr)


def make_opt(sketch):
    """The JAX test's optimizer: refresh_every 2 puts a step-3 checkpoint
    mid-interval; embedding_min_rows 64 sketches the 128-row token
    embedding, so all three state families ride the round trip."""
    from repro_torch.config import OptimizerConfig, default_mixed_groups
    from repro_torch.core.build import build_optimizer
    return build_optimizer(OptimizerConfig(
        name="adapprox", schedule="constant", lr=1e-3, weight_decay=0.1,
        decay_mask="no_1d", min_dim_factor=32, k=4, rank_mode="static",
        implicit=False, refresh_every=2, groups=default_mixed_groups(),
        embedding_min_rows=64, sketch_width=256, sketch_depth=2),
        sketch=sketch)


def smoke_config():
    from repro_torch.configs.archs import get_smoke_config
    return get_smoke_config("gpt2-117m", vocab=VOCAB, max_seq_len=SEQ)


_MESHES = {}


def mesh_of(shape):
    from torch.distributed.device_mesh import init_device_mesh
    if shape is None:
        return None
    if shape not in _MESHES:
        axes = {1: ("data",), 2: ("data", "model"),
                3: ("pod", "data", "model")}[len(shape)]
        _MESHES[shape] = init_device_mesh("cpu", shape,
                                          mesh_dim_names=axes)
    return _MESHES[shape]


def run(inp, shape, total, ckpt_dir=None, state=None):
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import LoopConfig, train
    mesh = mesh_of(shape)
    model = build_model(smoke_config(), mesh)
    opt = make_opt(TableSketch(inp["draws"]))
    params = params_from_numpy(inp["params"])
    ssh = bsh = None
    if mesh is not None:
        ssh, bsh = SH.train_shardings(model, opt, mesh,
                                      {"tokens": (BATCH, SEQ)},
                                      params=params)
    ck = (CheckpointConfig(directory=ckpt_dir, save_every=10 ** 9,
                           async_save=False) if ckpt_dir else None)
    st, hist = train(model, opt, DataConfig(vocab=VOCAB, seq_len=SEQ,
                                            global_batch=BATCH),
                     LoopConfig(total_steps=total, log_every=1, ckpt=ck),
                     device=torch.device("cpu"), params=params, state=state,
                     state_shardings=ssh, batch_shardings=bsh)
    return st, [h["loss"] for h in hist], ssh


def leaves(state):
    from repro_torch.checkpoint.serialization import leaves_with_paths
    from repro_torch.distributed import sharding as SH
    return leaves_with_paths(SH.gather_tree(state))


def equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x, y)):
                return False
        elif not (type(x) is type(y) and np.array_equal(x, y)):
            return False
    return True


def copy_dir(src, dst):
    if dist.get_rank() == 0:
        shutil.copytree(src, dst)
    dist.barrier()


def training(inp, out, res, arrs):
    """The resharding round trip, restarts and cross-mesh continuation."""
    from repro_torch.core.sketch import SketchLeaf, sketch_state
    from repro_torch.core.transform import PartitionState
    from repro_torch.core.types import tree_nbytes
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.distributed import sharding as SH
    from torch.distributed.tensor import DTensor
    base = os.path.join(out, "ckpt")

    # uninterrupted reference: 5 steps on (4, 2); and on (2, 4) and (8,)
    state5, l5, ssh42 = run(inp, (4, 2), 5)
    res["losses_42"] = l5
    for tag, shape in [("24", (2, 4)), ("8", (8,)), ("18", (1, 8))]:
        res[f"losses_{tag}"] = run(inp, shape, 5)[1]
    res["bytes_42"] = tree_nbytes(state5.opt_state)
    res["param_bytes_42"] = tree_nbytes(state5.params)
    pstate = state5.opt_state
    res["labels"] = (sorted(set(pstate.labels))
                     if isinstance(pstate, PartitionState) else None)
    sk = sketch_state(pstate.inner["embeddings"])
    sls = [leaf for leaf in sk.leaves if isinstance(leaf, SketchLeaf)]
    res["sketch_tables"] = [list(leaf.table.shape) for leaf in sls]
    res["sketch_m_split"] = any(isinstance(leaf.m, DTensor) for leaf in sls)
    from repro_torch.core.adapprox import adapprox_state
    from repro_torch.core.factored import FactoredLeaf
    fls = [leaf for leaf in adapprox_state(pstate.inner["factored"]).leaves
           if isinstance(leaf, FactoredLeaf)]
    res["q_split"] = any(isinstance(leaf.q, DTensor) and any(
        getattr(p, "dim", None) is not None for p in leaf.q.placements)
        for leaf in fls)

    # 3 steps on (4, 2), blocking save mid refresh interval
    d0 = os.path.join(base, "save42")
    state3, l3, _ = run(inp, (4, 2), 3, ckpt_dir=d0)
    res["prefix_ok"] = l3 == l5[:3]
    if dist.get_rank() == 0:
        m = json.load(open(os.path.join(d0, "step_000000003",
                                        "manifest.json")))
        res["manifest"] = {"paths": m["paths"],
                           "specs": [e["spec"] for e in m["leaves"]],
                           "mesh_axes": m["mesh_axes"]}

    # restore bitwise on every target mesh, and unsharded
    restored = {}
    for tag, shape in [("24", (2, 4)), ("8", (8,)), ("1", None)]:
        mgr = CheckpointManager(CheckpointConfig(directory=d0))
        shard = None
        if shape is not None:
            from repro_torch.models.model_zoo import build_model
            model = build_model(smoke_config(), mesh_of(shape))
            from repro_torch.convert import params_from_numpy
            shard, _ = SH.train_shardings(
                model, make_opt(TableSketch(inp["draws"])), mesh_of(shape),
                params=params_from_numpy(inp["params"]))
        st, step = mgr.restore(state3, shardings=shard)
        res[f"restore_{tag}"] = bool(step == 3 and equal(st, state3))
        restored[tag] = st
    res["restore_24_split"] = any(
        isinstance(v, DTensor) and any(getattr(p, "dim", None) is not None
                                       for p in v.placements)
        for v in restored["24"].params.values())
    res["restore_24_labels"] = (restored["24"].opt_state.labels
                                == state3.opt_state.labels)

    # same-mesh restart is bitwise
    d1 = os.path.join(base, "cont42")
    copy_dir(d0, d1)
    state5b, l45, _ = run(inp, (4, 2), 5, ckpt_dir=d1)
    res["same_mesh_losses"] = l45
    res["same_mesh_bitwise"] = bool(l45 == l5[3:] and equal(state5b, state5))

    # checkpoint restore == live re-placement (single-device continuation)
    live = SH.gather_tree(state3)
    _, l_live, _ = run(inp, None, 5, state=live)
    d2 = os.path.join(base, "cont1")
    copy_dir(d0, d2)
    _, l_ckpt, _ = run(inp, None, 5, ckpt_dir=d2)
    res["ckpt_eq_live"] = l_ckpt == l_live
    res["losses_cont1"] = l_ckpt

    # continuation across meshes
    for tag, shape in [("24", (2, 4)), ("8", (8,))]:
        d = os.path.join(base, "cont" + tag)
        copy_dir(d0, d)
        _, lc, _ = run(inp, shape, 5, ckpt_dir=d)
        res[f"losses_cont{tag}"] = lc


LAUNCH_ARGV = ["--smoke", "--device", "cpu", "--fused-update",
               "--refresh-every", "3", "--embedding-min-rows", "256",
               "--sketch-width", "256", "--sketch-depth", "2", "--steps", "6",
               "--log-every", "1"]


# ---------------------------------------------------------------------------
# the blocked step against the gather design
# ---------------------------------------------------------------------------

def gather_step(model, opt, ssh, bsh, microbatches=1):
    """The gather design's train step (the reference): every parameter and
    the optimizer state gathered whole, the whole gradient on this rank's
    batch block summed over the dp axes in rank order (``comm.all_sum``,
    the minor axis first) over their size, the whole update on every
    rank, each rank's blocks kept.  Returns ``(step, grads)``:
    ``step(state, batch) -> (state, loss)`` and ``grads(state, batch)``
    the whole summed gradients."""
    from repro_torch.core.types import apply_updates
    from repro_torch.distributed import sharding as SH
    from repro_torch.train.steps import TrainState, _MeshStep, \
        microbatch_grads
    mesh = _MeshStep(model, ssh, bsh)

    def grads(state, batch):
        with torch.no_grad():
            full = {k: SH.gather(v) for k, v in state.params.items()}
        whole = {k: v.detach().requires_grad_(True) for k, v in full.items()}
        g, loss, _ = microbatch_grads(model, whole, mesh.split(batch),
                                      microbatches)
        return full, {k: mesh.dp_mean(v) for k, v in g.items()}, \
            mesh.dp_mean(loss)

    def step(state, batch):
        full, g, loss = grads(state, batch)
        with torch.no_grad():
            opt_state = SH.gather_tree(state.opt_state)
            upd, opt_state = opt.update(g, opt_state, full)
            apply_updates(full, upd)
        return SH.place_state(TrainState(full, opt_state, state.step + 1),
                              ssh), float(loss)

    return step, grads


OPTIMIZERS = {
    "adapprox_fused": dict(fused_update=True, implicit=False),
    "adapprox_unfused": dict(implicit=False),
    "implicit": dict(implicit=True),
    "warm_start": dict(implicit=False, warm_start=True),
    "sketch": dict(fused_update=True, implicit=False,
                   embedding_min_rows=64, sketch_width=256, sketch_depth=2),
    "adamw": dict(name="adamw"),
    "adafactor": dict(name="adafactor"),
    "came": dict(name="came"),
}


# CAME's trajectories part wherever the summation order differs (two
# gather-design runs on (8,) and (4, 2) differ by 8% of a leaf's largest
# entry after 3 steps: it divides by row means of (u - m1)^2 that come
# near 0), so its blocked step is held to the reference one step at a
# time, each step taken from the reference's state
ANCHORED = ("came",)


def opt_of(kind: str):
    from repro_torch.config import OptimizerConfig, default_mixed_groups
    from repro_torch.core.build import build_optimizer
    over = dict(OPTIMIZERS[kind])
    if kind == "sketch":
        over["groups"] = default_mixed_groups()
    return build_optimizer(OptimizerConfig(**{
        **dict(name="adapprox", schedule="constant", lr=1e-3,
               weight_decay=0.1, decay_mask="no_1d", min_dim_factor=32, k=4,
               rank_mode="static", refresh_every=2), **over}))


TP_MESHES = [(4, 2), (2, 4), (1, 8)]


def spy_split_step(model, step, mparams, batch) -> dict:
    """One step's gradients on the tp route with a spy on the leaf gathers
    (``sharding._gather``) and on the attention (``attention.sdpa_auto``):
    how many gathers ran over the model axis' group (the forward's and
    the backward's regathers), and the q and kv head counts each
    attention call saw, the same on every rank."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import attention as A
    group = step.mesh.get_group("model")
    seen = {"model_gathers": 0, "heads": set()}
    gather, sdpa = SH._gather, A.sdpa_auto

    def spy_gather(x, gathers):
        seen["model_gathers"] += sum(1 for _, g in gathers if g is group)
        return gather(x, gathers)

    def spy_sdpa(cfg, q, k, v, **kw):
        seen["heads"].add((q.shape[2], k.shape[2]))
        return sdpa(cfg, q, k, v, **kw)

    SH._gather, A.sdpa_auto = spy_gather, spy_sdpa
    try:
        step.grads(model, mparams, step.split(batch), 1)
    finally:
        SH._gather, A.sdpa_auto = gather, sdpa
    return {"model_gathers": seen["model_gathers"],
            "heads": sorted(seen["heads"])}


def blocked(inp, res):
    """The blocked step (``train/steps.py``) against :func:`gather_step`
    from the same init on the same batches.  On the gather route (every
    product whole): one step's gradient blocks on every mesh under remat
    none and full, to be the reference's slices bit for bit (and on (4,
    2) under the fsdp rule, which splits the (L, d) leaves' stack axis);
    every optimizer's state and parameter blocks after each of 3 steps on
    (4, 2) (and Adapprox's at microbatches 2 and under remat full;
    ``ANCHORED`` ones step by step).  On the tp route (the products split
    over ``model``), in fp32 compute, on ``TP_MESHES``: one step's
    gradient blocks under remat none and full, each leaf's route, and
    Adapprox's state and parameter blocks after each of 3 steps; on (4, 2)
    the spy of :func:`spy_split_step`.  Differences are each leaf's
    largest over its largest entry, for the tests to hold."""
    import dataclasses
    from repro_torch.convert import params_from_numpy
    from repro_torch.checkpoint.serialization import leaves_with_paths
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.steps import (TrainState, _MeshStep,
                                         build_train_step)
    batches = [{"tokens": torch.from_numpy(b)} for b in inp["batches"]]

    def setup(shape, kind="adapprox_fused", remat="none", strategy="tp",
              split=False, dtype="bfloat16"):
        """The model, optimizer, shardings and placed state; ``split``
        False keeps every leaf on the gather route (the model declares no
        split products)."""
        mesh = mesh_of(shape)
        model = build_model(dataclasses.replace(
            smoke_config(), remat=remat, parallel_strategy=strategy,
            dtype=dtype), mesh)
        if not split:
            model.split_products = None
        opt = opt_of(kind)
        params = params_from_numpy(inp["params"])
        ssh, bsh = SH.train_shardings(model, opt, mesh,
                                      {"tokens": (BATCH, SEQ)},
                                      params=params)
        state = SH.place_state(TrainState.create(params, opt), ssh)
        return model, opt, ssh, bsh, state

    def everywhere(x: float) -> float:
        return max(comm.all_concat(torch.tensor([float(x)]), 0,
                                   dist.group.WORLD).tolist())

    grid = [(shape, remat, "tp") for shape in [(4, 2), (2, 4), (8,)]
            for remat in ("none", "full")] + [((4, 2), "none", "fsdp")]
    for shape, remat, strategy in grid:
        model, opt, ssh, bsh, state = setup(shape, remat=remat,
                                            strategy=strategy)
        step = _MeshStep(model, ssh, bsh)
        _, mparams, _ = step.blocks(state)
        got, _, _ = step.grads(model, mparams, step.split(batches[0]), 1)
        _, want, _ = gather_step(model, opt, ssh, bsh)[1](state,
                                                           batches[0])
        bad = [k for k in want if not torch.equal(
            got[k], SH.local_block(want[k], ssh.params[k]))]
        tag = "x".join(map(str, shape))
        tag += "_fsdp" if strategy == "fsdp" else ""
        res[f"grads_bad_{tag}_{remat}"] = everywhere(len(bad))

    def leaf_err(x, y) -> float:
        x, y = x.double(), y.double()
        scale = float(y.abs().max()) if y.numel() else 0.0
        err = float((x - y).abs().max()) if y.numel() else 0.0
        return err / scale if scale else err

    # the products split over model, in fp32 compute (in bf16 the two
    # routes' roundings, not the split, would set the difference)
    for shape in TP_MESHES:
        tag = "x".join(map(str, shape))
        for remat in ("none", "full"):
            model, opt, ssh, bsh, state = setup(
                shape, remat=remat, split=True, dtype="float32")
            step = _MeshStep(model, ssh, bsh)
            _, mparams, _ = step.blocks(state)
            got, _, _ = step.grads(model, mparams, step.split(batches[0]), 1)
            _, want, _ = gather_step(model, opt, ssh, bsh)[1](state,
                                                               batches[0])
            routes = step.use.routes()
            errs = {k: leaf_err(got[k], SH.local_block(want[k],
                                                        ssh.params[k]))
                    for k in want}
            split = [k for k in errs if routes[k] in ("block", "slice")]
            res[f"tp_grads_{tag}_{remat}"] = {
                "split": everywhere(max(errs[k] for k in split)),
                "other": everywhere(max(errs[k] for k in errs
                                        if k not in split)),
                "routes": routes}
        if shape == (4, 2):
            res["tp_spy_42"] = spy_split_step(model, step, mparams,
                                              batches[0])

    def rel_err(a, b) -> float:
        worst = 0.0
        for (pa, x), (pb, y) in zip(leaves_with_paths(SH.local_tree(a)),
                                    leaves_with_paths(SH.local_tree(b))):
            assert pa == pb, (pa, pb)
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                x, y = x.double(), y.double()
                scale = float(y.abs().max()) if y.numel() else 0.0
                err = float((x - y).abs().max()) if y.numel() else 0.0
                worst = max(worst, err / scale if scale else err)
        return worst

    runs = [(kind, kind, 1, "none", (4, 2), False) for kind in OPTIMIZERS]
    runs += [("microbatches_2", "adapprox_fused", 2, "none", (4, 2), False),
             ("remat_full", "adapprox_fused", 1, "full", (4, 2), False)]
    runs += [("tp_" + "x".join(map(str, shape)), "adapprox_fused", 1,
              "none", shape, True) for shape in TP_MESHES]
    errs = {}
    for tag, kind, mb, remat, shape, split in runs:
        dtype = "float32" if split else "bfloat16"
        model, opt, ssh, bsh, state = setup(shape, kind, remat, split=split,
                                            dtype=dtype)
        ref = setup(shape, kind, remat, split=split, dtype=dtype)[-1]
        step = build_train_step(model, opt, microbatches=mb,
                                state_shardings=ssh, batch_shardings=bsh)
        ref_step = gather_step(model, opt, ssh, bsh, mb)[0]
        rec = dict(opt_state=[], params=[], losses=[])
        for batch in batches:
            if tag in ANCHORED:        # each step from the reference's state
                state = SH.place_state(SH.gather_tree(ref), ssh)
            state, metrics = step(state, batch)
            ref, ref_loss = ref_step(ref, batch)
            rec["losses"].append((float(metrics["loss"]), ref_loss))
            rec["opt_state"].append(everywhere(rel_err(state.opt_state,
                                                       ref.opt_state)))
            rec["params"].append(everywhere(rel_err(state.params,
                                                    ref.params)))
        errs[tag] = rec
    res["blocked_vs_gather"] = errs


def split_chunked(res):
    """The products split over ``model`` on (1, 8) with the chunked
    attention (``attn_impl="chunked"``, the flash-attention op on each
    rank's heads: its plain version on the CPU; half the ranks hold no
    head) at 1024 tokens under remat full, in fp32 compute, from the
    port's seed-0 init: one step's gradient blocks against
    :func:`gather_step`'s, each leaf's largest difference over its
    largest entry."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.steps import TrainState, _MeshStep
    seq = 1024
    cfg = dataclasses.replace(smoke_config(), max_seq_len=seq,
                              attn_impl="chunked", remat="full",
                              dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = tree.flatten(build_model(cfg).init(gen))
    batch = {"tokens": torch.randint(0, VOCAB, (BATCH, seq), generator=gen)}
    mesh = mesh_of((1, 8))
    model = build_model(cfg, mesh)
    opt = opt_of("adapprox_fused")
    ssh, bsh = SH.train_shardings(model, opt, mesh, {"tokens": (BATCH, seq)},
                                  params=params)
    state = SH.place_state(TrainState.create(params, opt), ssh)
    step = _MeshStep(model, ssh, bsh)
    _, mparams, _ = step.blocks(state)
    got, _, _ = step.grads(model, mparams, step.split(batch), 1)
    _, want, _ = gather_step(model, opt, ssh, bsh)[1](state, batch)
    worst = 0.0
    for k in want:
        x, y = got[k].double(), SH.local_block(want[k], ssh.params[k]).double()
        worst = max(worst, float((x - y).abs().max() / y.abs().max()))
    res["tp_grads_1x8_chunked"] = max(comm.all_concat(
        torch.tensor([worst]), 0, dist.group.WORLD).tolist())


def launcher_mesh(inp, res):
    """The launcher itself at ``--mesh 4,2`` (its default mixed groups,
    bf16 compute) from the JAX init with JAX's draws."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import train as launcher
    _, hist = launcher.main(LAUNCH_ARGV + ["--mesh", "4,2"],
                            params=params_from_numpy(inp["launch_params"]),
                            sketch=TableSketch(inp["launch_draws"]))
    res["launcher_42"] = [h["loss"] for h in hist]


def moe(inp, res, arrs):
    """moe_apply_sharded on (2, 4) and moe_apply_ep_tp, outputs and the
    gradients of each data block's loss, against the port's local path."""
    from repro_torch.config import ModelConfig, MoESpec
    from repro_torch.distributed import comm
    from repro_torch.models import moe as MOE
    cfg = ModelConfig(arch="t", family="moe", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=4, d_ff=64, vocab=64,
                      moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=16,
                                  capacity_factor=64.0, impl="sort"))
    mesh = mesh_of((2, 4))
    di, mi = mesh.get_local_rank(0), mesh.get_local_rank(1)
    p = {k: torch.tensor(v) for k, v in inp["moe_p"].items()}
    x = torch.tensor(inp["moe_x"])
    names = ("router", "w_gate", "w_up", "w_down")

    def local_grads(xs):
        """Sum over the blocks ``xs`` of the gradients of sum(y^2) + aux
        through the port's single-shard path."""
        tot = {k: torch.zeros_like(p[k]) for k in names}
        for xb in xs:
            q = {k: p[k].clone().requires_grad_(True) for k in names}
            y, aux = MOE.moe_apply_local(cfg, q, xb)
            g = torch.autograd.grad((y ** 2).sum() + aux, [q[k] for k in names])
            for k, gk in zip(names, g):
                tot[k] += gk
        return tot

    def err(a, b):
        return float((a - b).abs().max())

    # EP over model + the FSDP gather over data (the training layout)
    ex = slice(mi * 2, mi * 2 + 2)
    dsl = slice(di * 16, di * 16 + 16)
    blk = {"router": p["router"].clone(),
           "w_gate": p["w_gate"][ex, dsl].clone(),
           "w_up": p["w_up"][ex, dsl].clone(),
           "w_down": p["w_down"][ex, :, dsl].clone()}
    blk = {k: v.requires_grad_(True) for k, v in blk.items()}
    xb = x.chunk(2)[di]
    y, aux = MOE.moe_apply_sharded(cfg, blk, xb, mesh, dp_axes=("data",),
                                   gather_axes=("data",))
    g = dict(zip(names, torch.autograd.grad((y ** 2).sum() + aux,
                                            [blk[k] for k in names])))
    g["router"] = comm.all_sum(g["router"], mesh.get_group("data"))
    want = local_grads(x.chunk(2))
    errs = {"router": err(g["router"], want["router"]),
            "w_gate": err(g["w_gate"], want["w_gate"][ex, dsl]),
            "w_up": err(g["w_up"], want["w_up"][ex, dsl]),
            "w_down": err(g["w_down"], want["w_down"][ex, :, dsl])}
    errs = {k: max(comm.all_concat(torch.tensor([v]), 0,
                                   dist.group.WORLD).tolist())
            for k, v in errs.items()}
    res["moe_sharded_grad_err"] = errs
    res["moe_sharded_grad_scale"] = {k: float(want[k].abs().max())
                                     for k in names}
    ys = comm.all_concat(y.detach(), 0, mesh.get_group("data"))
    arrs["moe_sharded_y"] = ys.numpy()

    # weights-stationary EP-TP: experts over model, FFN over data
    fsl = slice(di * 8, di * 8 + 8)
    blk = {"router": p["router"].clone(),
           "w_gate": p["w_gate"][ex, :, fsl].clone(),
           "w_up": p["w_up"][ex, :, fsl].clone(),
           "w_down": p["w_down"][ex, fsl].clone()}
    blk = {k: v.requires_grad_(True) for k, v in blk.items()}
    y, aux = MOE.moe_apply_ep_tp(cfg, blk, x, mesh)
    g = dict(zip(names, torch.autograd.grad((y ** 2).sum() + aux,
                                            [blk[k] for k in names])))
    want = local_grads([x])
    errs = {"router": err(g["router"], want["router"]),
            "w_gate": err(g["w_gate"], want["w_gate"][ex, :, fsl]),
            "w_up": err(g["w_up"], want["w_up"][ex, :, fsl]),
            "w_down": err(g["w_down"], want["w_down"][ex, fsl])}
    errs = {k: max(comm.all_concat(torch.tensor([v]), 0,
                                   dist.group.WORLD).tolist())
            for k, v in errs.items()}
    res["moe_ep_tp_grad_err"] = errs
    res["moe_ep_tp_grad_scale"] = {k: float(want[k].abs().max())
                                   for k in names}
    arrs["moe_ep_tp_y"] = y.detach().numpy()


def pipeline(inp, res, arrs):
    """4 stages over the ``stage`` axis of a (2, 4) mesh (each data
    replica runs the pipeline), forward and gradient."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import comm
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  split_stages,
                                                  stage_fn_from_layers)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "stage"))
    w = torch.tensor(inp["pipe_w"]).requires_grad_(True)
    x = torch.tensor(inp["pipe_x"])
    stage_fn = stage_fn_from_layers(lambda wl, h: torch.tanh(h @ wl))
    out = pipeline_apply(stage_fn, split_stages(w, 4), x, mesh)
    (g,) = torch.autograd.grad((out ** 2).sum(), [w])
    g = comm.all_sum(g, mesh.get_group("stage"))
    ws = torch.tensor(inp["pipe_w"]).requires_grad_(True)
    h = x
    for layer in range(ws.shape[0]):
        h = torch.tanh(h @ ws[layer])
    (gs,) = torch.autograd.grad((h ** 2).sum(), [ws])
    arrs["pipe_out"], arrs["pipe_grad"] = out.detach().numpy(), g.numpy()
    arrs["pipe_seq_out"], arrs["pipe_seq_grad"] = (h.detach().numpy(),
                                                   gs.numpy())


def elastic(out, res):
    """A bit-flipped newest checkpoint, two ranks lost, the survivors'
    (3, 2) mesh restores the older one."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core.types import P
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.resilience.chaos import (corrupt_latest_checkpoint,
                                              remesh_after_loss)
    d = os.path.join(out, "elastic")
    tree = {"w": torch.arange(96, dtype=torch.float32).reshape(12, 8),
            "step": torch.tensor(0, dtype=torch.int32)}
    mgr = CheckpointManager(CheckpointConfig(directory=d, async_save=False))
    mgr.save(tree, 1, blocking=True)
    mgr.save({**tree, "step": torch.tensor(2, dtype=torch.int32)}, 2,
             blocking=True)
    if dist.get_rank() == 0:
        corrupt_latest_checkpoint(d, kind="bitflip")
    dist.barrier()
    plan = remesh_after_loss(lost=2, target_model=2, available_devices=8)
    res["elastic_plan"] = [plan.pods, plan.data, plan.model, plan.devices]

    def make_shardings(mesh):
        return {"w": SH.NamedSharding(mesh, P("data", "model")),
                "step": SH.NamedSharding(mesh, P())}

    state, step, mesh = elastic_restore(
        CheckpointManager(CheckpointConfig(directory=d)), like=tree,
        make_shardings=make_shardings, available_devices=plan.devices,
        target_model=2)
    ok = step == 1 and SH.mesh_axis_sizes(mesh) == {"data": 3, "model": 2}
    if dist.get_rank() < 6:
        w = state["w"]
        ok = ok and w.device_mesh.size() == 6 and tuple(
            w.to_local().shape) == (4, 4)
        ok = ok and torch.equal(w.full_tensor(), tree["w"])
    else:
        ok = ok and state is None
    from repro_torch.distributed import comm
    res["elastic_ok"] = bool(min(comm.all_concat(
        torch.tensor([float(ok)]), 0, dist.group.WORLD).tolist()))


def worker(rank: int, port: int, inp_path: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    res, arrs = {}, {}
    try:
        training(inp, out, res, arrs)
        blocked(inp, res)
        split_chunked(res)
        launcher_mesh(inp, res)
        moe(inp, res, arrs)
        pipeline(inp, res, arrs)
        elastic(out, res)
        if rank == 0:
            with open(os.path.join(out, "results.json"), "w") as f:
                json.dump(res, f)
            np.savez(os.path.join(out, "arrays.npz"), **arrs)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def spawn(inp: dict, out: str, timeout_s: float = 600.0,
          target=None) -> None:
    """Run the scenarios (``target(rank, port, inputs path, out)``, by
    default :func:`worker`) on 8 gloo ranks; results under ``out``.
    Raises if a rank fails, or (the ranks killed) if they take over
    ``timeout_s``."""
    import socket
    import time
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    inp_path = os.path.join(out, "inputs.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    ctx = mp.start_processes(target or worker, args=(port, inp_path, out),
                             nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"the {WORLD} ranks took over {timeout_s} s")


if __name__ == "__main__":
    spawn(pickle.load(open(sys.argv[1], "rb")), sys.argv[2])
