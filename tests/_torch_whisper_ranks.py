"""The ranks of ``test_torch_mesh_whisper.py``: one 8-rank gloo spawn on the
CPU trains and serves each Whisper case and serves each Zamba2
long-context case, and rank 0 writes what the tests read.

Whisper, training (fp32 compute, the JAX init, ``_torch_mesh_ranks.
opt_of``'s Adapprox, batches of tokens and the stub frontend's
``embeds``): one step's gradient blocks with the products split over
``model`` (``train/steps.py::_MeshStep``) against the gather design
(``_torch_mesh_ranks.gather_step``: every leaf whole) under remat none
and, on (1, 8), full; each leaf's route; which leaves a spy saw gathered
over the model axis; then ``TRAIN_STEPS`` steps of both, their losses
and the parameter blocks after them; and the run without a mesh, once a
case.

Serving, both models: the parameters and an empty cache placed by the
serving specs (Zamba2's by the ``long_500k`` specs: B = 1, the KV
sequence over (data, model)), the model handed the rank's blocks under
``sharding.serving_view``, ``prefill`` and ``decode_step``s fed the
case's seeded tokens: the logits (whole on every rank; their spread
over the model group), each rank's block of every cache leaf against its
block of the single-device port's cache, the leaves a spy saw gathered
over the model axis, and the collectives that read a cache's storage.
"""
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

import _torch_mesh_ranks as MR
from _torch_serve_ranks import Spy
from _torch_ssm_ranks import MovedSpy, _everywhere, _leaf_err, _params_err

SEQ, BATCH, TRAIN_STEPS = 32, 8, 2


def make_config(case: dict, **over):
    """The smoke config of the case's arch in fp32 compute with the case's
    overrides (``get_smoke_config`` of either package, so the test builds
    JAX's the same way)."""
    from repro_torch.configs.archs import get_smoke_config
    return get_smoke_config(case["arch"], dtype="float32",
                            **{**case["over"], **over})


def batches_of(case: dict) -> list:
    return [{"tokens": torch.from_numpy(t), "embeds": torch.from_numpy(e)}
            for t, e in zip(case["batches"], case["embeds"])]


def no_mesh(case: dict) -> list:
    """The losses of ``TRAIN_STEPS`` steps without a mesh."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.steps import TrainState, build_train_step
    model, opt = build_model(make_config(case)), MR.opt_of("adapprox_fused")
    state = TrainState.create(params_from_numpy(case["params"]), opt)
    step = build_train_step(model, opt)
    losses = []
    for b in batches_of(case):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses


def train_run(case: dict, shape: tuple) -> dict:
    """The split route against the gather design on ``shape`` (see the
    module docstring)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.steps import (TrainState, _MeshStep,
                                         build_train_step)
    mesh = MR.mesh_of(shape)
    batches = batches_of(case)
    struct = {k: tuple(v.shape) for k, v in batches[0].items()}

    def setup(split: bool, remat: str = "none"):
        model = build_model(make_config(case, remat=remat), mesh)
        if not split:
            model.split_products = None
        opt = MR.opt_of("adapprox_fused")
        params = params_from_numpy(case["params"])
        ssh, bsh = SH.train_shardings(model, opt, mesh, struct,
                                      params=params)
        state = SH.place_state(TrainState.create(params, opt), ssh)
        return model, opt, ssh, bsh, state

    rec = {}
    for remat in ("none", "full") if shape == (1, 8) else ("none",):
        model, opt, ssh, bsh, state = setup(True, remat)
        step = _MeshStep(model, ssh, bsh)
        _, mparams, _ = step.blocks(state)
        with MovedSpy(mesh.get_group("model")) as spy:
            got, _, _ = step.grads(model, mparams, step.split(batches[0]), 1)
        _, want, _ = MR.gather_step(model, opt, ssh, bsh)[1](state,
                                                              batches[0])
        rec[f"grads_{remat}"] = {k: _everywhere(_leaf_err(
            got[k], SH.local_block(want[k], ssh.params[k]))) for k in want}
        rec["routes"] = step.use.routes()
        rec["moved"] = sorted(spy.moved)
    model, opt, ssh, bsh, state = setup(True)
    ref = setup(False)[-1]
    step = build_train_step(model, opt, state_shardings=ssh,
                            batch_shardings=bsh)
    ref_step = MR.gather_step(model, opt, ssh, bsh)[0]
    rec["losses"], rec["gather_losses"] = [], []
    for batch in batches:
        state, metrics = step(state, batch)
        ref, ref_loss = ref_step(ref, batch)
        rec["losses"].append(float(metrics["loss"]))
        rec["gather_losses"].append(ref_loss)
    rec["params_err"] = _everywhere(_params_err(state.params, ref.params))
    return rec


def serve_run(case: dict, shape: tuple) -> tuple:
    """Prefill and the decode steps on the mesh ``shape``: ``(record,
    {what: whole logits})``."""
    from repro_torch import tree
    from repro_torch.checkpoint.serialization import (leaves_with_paths,
                                                      spec_leaves)
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    cfg = make_config(case)
    mesh = MR.mesh_of(shape)
    model = build_model(cfg, mesh)
    whole = tree.flatten(params_from_numpy(case["params"]))
    shapes = {k: tuple(v.shape) for k, v in whole.items()}
    tokens = torch.from_numpy(case["tokens"]).long()
    cache = model.init_cache(tokens.shape[0], case["cache_len"])
    cshard = SH.cache_shardings(cfg, mesh, cache, case["long_context"])
    cache = SH.local_tree(SH.place_tree(cache, cshard))
    model_group, dp_group = mesh.get_group("model"), mesh.get_group("data")

    def block(x):
        spec = (SH.dp_axes(mesh),) + (None,) * (x.dim() - 1)
        return SH.local_block(x, SH.NamedSharding(
            mesh, SH.sanitize_spec(spec, tuple(x.shape), mesh)))

    spread, logits, moved, routes, errs = 0.0, {}, {}, {}, {}

    def keep(what, lg):
        nonlocal spread
        peers = comm.all_concat(lg[None], 0, model_group)
        spread = max(spread, float((peers - peers[0]).abs().max()))
        logits[what] = (lg if case["long_context"] else comm.all_concat(
            lg, 0, dp_group)).numpy()

    def cache_err(what):
        for (path, t), (_, sh) in zip(leaves_with_paths(cache),
                                      spec_leaves(cshard)):
            if isinstance(t, torch.Tensor):
                want = torch.from_numpy(case[f"cache_{what}"][path])
                errs[f"{what} {path}"] = _everywhere(_leaf_err(
                    t, SH.local_block(want, sh)))

    spy = Spy()
    spy.cache_ptrs = {t.untyped_storage().data_ptr()
                      for t in list(cache["kv"]) + [cache.get("cross")]
                      if t is not None}
    collectives = {}
    with spy, torch.inference_mode():
        for kind in ("prefill", "decode"):
            pshard = SH.param_shardings(model, mesh, kind, params=whole)
            params = tree.unflatten({k: SH.to_local(SH.place(v, pshard[k]))
                                     for k, v in whole.items()})
            use = SH.serving_view(model, mesh, pshard, shapes, cshard)
            if use is None:
                raise RuntimeError("the serving view does not split")
            routes[kind] = use.routes()
            before = spy.seen["cache_collectives"]
            with MovedSpy(model_group) as moved_spy, L.gathering(use):
                if kind == "prefill":
                    kw = ({"embeds": block(torch.from_numpy(
                        case["serve_embeds"]))}
                        if case["serve_embeds"] is not None else {})
                    lg, cache = model.prefill(params, block(tokens), cache,
                                              **kw)
                    keep("prefill", lg)
                    cache_err("prefill")
                else:
                    for i, tok in enumerate(case["decode_tokens"]):
                        lg, cache = model.decode_step(
                            params, cache, block(torch.from_numpy(tok)
                                                 .long()))
                        keep(f"decode {i}", lg)
            moved[kind] = sorted(moved_spy.moved)
            collectives[kind] = _everywhere(
                spy.seen["cache_collectives"] - before)
    cache_err("final")
    seq = use.seq
    return {"spread": _everywhere(spread), "cache_err": errs,
            "cache_pos": cache["pos"], "moved": moved, "routes": routes,
            "cache_collectives": collectives,
            "whole_route": _everywhere(spy.seen["whole_route"]),
            "seq_size": None if seq is None else seq.size,
            "seq_rows": comm_all(None if seq is None else [
                seq.rank * cache["kv"].k.shape[2],
                cache["kv"].k.shape[2]])}, logits


def comm_all(obj) -> list:
    """Every rank's ``obj`` (a JSON-able value), in rank order."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def worker(rank: int, port: int, inp_path: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=MR.WORLD)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    res, arrs = {}, {}
    try:
        for name, case in inp.items():
            if case["batches"] is not None:
                res[f"{name} no mesh"] = no_mesh(case)
            for shape in case["meshes"]:
                tag = f"{name} {'x'.join(map(str, shape))}"
                if case["batches"] is not None:
                    res[f"{tag} train"] = train_run(case, shape)
                rec, logits = serve_run(case, shape)
                res[f"{tag} serve"] = rec
                for what, lg in logits.items():
                    arrs[f"{tag} {what}"] = lg
        if rank == 0:
            with open(os.path.join(out, "results.json"), "w") as f:
                json.dump(res, f)
            np.savez(os.path.join(out, "arrays.npz"), **arrs)
    finally:
        dist.barrier()
        dist.destroy_process_group()
