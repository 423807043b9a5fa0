"""The ranks of ``test_torch_mesh_serve.py``: one 8-rank gloo spawn on the
CPU serves each case (a smoke model, a cache length, the meshes) and rank
0 writes what the tests read.

Each run places the whole parameters and an empty cache by the serving
specs (``sharding.param_shardings`` of the cell's kind,
``cache_shardings``), hands the model the rank's blocks under
``sharding.serving_view`` and runs ``prefill`` and ``STEPS``
``decode_step``s on the rank's block of the batch, fed the JAX stream's
greedy tokens.  It records the logits (whole on every rank: their spread
over the model group, and the dp blocks concatenated), each rank's cache
block against its rows of the single-device port's cache, the routes of
the parameters, and a spy: every "block" leaf the hook hands the model
against the stored block (the same storage, so nothing gathered), the
collectives' inputs against the cache blocks' storage, the whole route's
gathers (``sharding.gather``, ``model_params``, ``gather_tree_except``)
never called, and the q / kv heads each prefill attention saw.
"""
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from _torch_mesh_ranks import mesh_of

CACHE_LEN = 24       # 12 / 6 / 3 rows a rank over model 2 / 4 / 8
STEPS = 16           # positions 10 .. 25: past a block edge and the cache


class SpyUse:
    """A serving hook that records every "block" leaf it hands the model
    on other storage or in another shape than the stored block (a gather
    over ``model``)."""

    def __init__(self, use):
        self.use, self.split, self.seq = use, use.split, use.seq
        self.seq_split = use.seq_split
        self.moved = set()

    def __call__(self, tree, path, stack=False):
        out = self.use(tree, path, stack)
        self._check(tree, out, path)
        return out

    def _check(self, given, got, path):
        if isinstance(given, dict):
            for k in given:
                self._check(given[k], got[k], f"{path}/{k}")
        elif self.use.route(path) == "block" and (
                got.shape != given.shape
                or got.data_ptr() != given.data_ptr()):
            self.moved.add(path)


class Spy:
    """Counts the whole route's gathers, the collectives that read a
    cache block's storage, and the heads each attention saw."""

    def __init__(self):
        from repro_torch.distributed import sharding as SH
        from repro_torch.models import attention as A
        self.cache_ptrs = set()
        self.seen = {"whole_route": 0, "cache_collectives": 0,
                     "heads": set()}
        self.saved = [(SH, n, getattr(SH, n)) for n in (
            "gather", "model_params", "gather_tree_except")]
        self.saved += [(dist, n, getattr(dist, n))
                       for n in ("all_gather", "all_to_all_single")]
        self.saved += [(A, "sdpa_auto", A.sdpa_auto)]

    def __enter__(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def _wrap(self, name, fn):
        def spied(*args, **kw):
            if name in ("gather", "model_params", "gather_tree_except"):
                self.seen["whole_route"] += 1
            elif name == "sdpa_auto":
                self.seen["heads"].add((args[1].shape[2], args[2].shape[2]))
            else:
                ts = [a for a in list(args) + list(kw.values())
                      if isinstance(a, torch.Tensor)]
                ts += [t for a in args if isinstance(a, list) for t in a]
                if any(t.untyped_storage().data_ptr() in self.cache_ptrs
                       for t in ts):
                    self.seen["cache_collectives"] += 1
            return fn(*args, **kw)
        return spied


def _everywhere_max(x: float) -> float:
    from repro_torch.distributed import comm
    return max(comm.all_concat(torch.tensor([float(x)]), 0,
                               dist.group.WORLD).tolist())


def _rel(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    if not got.numel():
        return 0.0
    return float((got.double() - want.double()).abs().max()) / scale


def serve_run(case: dict, shape: tuple) -> dict:
    """One model's prefill and decode steps on the mesh ``shape``."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs.archs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    cfg = get_smoke_config(case["arch"], dtype="float32")
    if case["capacity_factor"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity_factor"]))
    mesh = mesh_of(shape)
    model = build_model(cfg, mesh)
    whole = tree.flatten(params_from_numpy(case["params"]))
    shapes = {k: tuple(v.shape) for k, v in whole.items()}
    tokens = torch.from_numpy(case["tokens"]).long()
    b = tokens.shape[0]
    cache = model.init_cache(b, case["cache_len"])
    cshard = SH.cache_shardings(cfg, mesh, cache, False)
    cache = SH.local_tree(SH.place_tree(cache, cshard))

    def view(kind):
        pshard = SH.param_shardings(model, mesh, kind, params=whole)
        params = {k: SH.to_local(SH.place(v, pshard[k]))
                  for k, v in whole.items()}
        return SH.serving_view(model, mesh, pshard, shapes, cshard), params

    def block(x):
        spec = (SH.dp_axes(mesh),) + (None,) * (x.dim() - 1)
        return SH.local_block(x, SH.NamedSharding(
            mesh, SH.sanitize_spec(spec, tuple(x.shape), mesh)))

    model_group = mesh.get_group("model")
    dp_group = mesh.get_group("data")
    spread, rows = 0.0, []

    def whole_logits(lg):
        nonlocal spread
        peers = comm.all_concat(lg[None], 0, model_group)
        spread = max(spread, float((peers - peers[0]).abs().max()))
        return comm.all_concat(lg, 0, dp_group).numpy()

    spy = Spy()
    spy.cache_ptrs = {t.untyped_storage().data_ptr() for t in cache["kv"]}
    out, moved, routes = {}, set(), {}
    with spy, torch.inference_mode():
        for kind in ("prefill", "decode"):
            use, params = view(kind)
            hook = SpyUse(use)
            routes[kind] = use.routes()
            model.moe_mode = "decode" if kind == "decode" else "train"
            with L.gathering(hook):
                if kind == "prefill":
                    kw = ({"embeds": block(torch.from_numpy(case["embeds"]))}
                          if case["embeds"] is not None else {})
                    lg, cache = model.prefill(tree.unflatten(params),
                                              block(tokens), cache, **kw)
                    out["prefill"] = whole_logits(lg)
                    rows.append(("prefill", {
                        k: t.clone() for k, t in zip("kv", cache["kv"])}))
                    continue
                for i, tok in enumerate(case["decode_tokens"]):
                    lg, cache = model.decode_step(
                        tree.unflatten(params), cache,
                        block(torch.from_numpy(tok).long()))
                    out[f"decode {i}"] = whole_logits(lg)
            moved |= hook.moved
    rows.append(("final", dict(zip("kv", cache["kv"]))))
    errs = {}
    for what, got in rows:
        for name in "kv":
            want = torch.from_numpy(case[f"cache_{what}"][name])
            sh = cshard["kv"][0 if name == "k" else 1]
            errs[f"{what} {name}"] = _everywhere_max(_rel(
                got[name], SH.local_block(want, sh),
                float(want.abs().max())))
    seq_split = cshard["kv"].k.spec[2] is not None
    return {"logits": out, "spread": _everywhere_max(spread),
            "cache_err": errs, "cache_pos": cache["pos"],
            "moved_blocks": sorted(moved), "routes": routes,
            "seq_split": seq_split,
            "whole_route": _everywhere_max(spy.seen["whole_route"]),
            "cache_collectives": _everywhere_max(
                spy.seen["cache_collectives"]),
            "heads": sorted(spy.seen["heads"])}


def worker(rank: int, port: int, inp_path: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=8)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    res, arrs = {}, {}
    try:
        for name, case in inp.items():
            for shape in case["meshes"]:
                tag = f"{name} {'x'.join(map(str, shape))}"
                rec = serve_run(case, shape)
                for what, lg in rec.pop("logits").items():
                    arrs[f"{tag} {what}"] = lg
                moved = [sorted(set(m)) for m in comm_all(rec["moved_blocks"])]
                rec["moved_blocks"] = sorted({p for m in moved for p in m})
                heads = comm_all(rec["heads"])
                rec["heads"] = sorted({tuple(h) for hs in heads for h in hs})
                res[tag] = rec
        if rank == 0:
            with open(os.path.join(out, "results.json"), "w") as f:
                json.dump(res, f)
            np.savez(os.path.join(out, "arrays.npz"), **arrs)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def comm_all(obj) -> list:
    """Every rank's ``obj`` (a JSON-able value), in rank order."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got
