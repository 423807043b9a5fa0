"""Two ranks on one GPU under gloo: whether gloo's CUDA collectives carry
the port's mesh training step (NCCL refuses two ranks on one device).

The smoke GPT-2 (4 q / 2 kv heads of 16, d_ff 128, vocab 512), the
launcher's mixed groups with --fused-update --refresh-every 5, batch 8 x
128, 6 steps: first without a mesh in this process, then ``--mesh 1,2``
(the products split over ``model``: two heads, half the MLP and half the
vocabulary a rank) and ``--mesh 2`` (the batch split, every product
whole) on two gloo ranks, both on cuda:0.  Each mesh run's losses are
held to the run without a mesh at rtol 1e-3 (the CPU tests' cross-mesh
tolerance).

    python3 scripts/mesh_ranks.py        # on a machine with a GPU
    python3 scripts/mesh_ranks.py --ranks-only --mesh 1,2 --json OUT.json

Prints each run's losses and the reading, or the error the mesh run
raised (a crash's Python stack through ``faulthandler``); the last line
is ``RESULT ok`` or ``RESULT error``.  ``--ranks-only`` runs no reference
and writes the ranks' ``{mesh: losses}`` (or ``{"error": ...}``) to
``--json`` for a caller that holds them itself (``chip_smoke.py``'s
``[mesh]``); ``--mesh`` picks one mesh.

``--serve`` serves instead, at ``--mesh 1,2`` on the two ranks
(``sharding.serving_view``: the heads, MLP and vocabulary split over
``model``, the KV cache's sequence kept split), 2 prompts of 8192 tokens
(so the flash-attention kernel, B6, runs on each rank's heads) and 8
decode steps fed seeded tokens, each step's logits and greedy tokens
held to the run without a mesh in this process, and B6's forward
launches counted (one a layer on each rank).  The smoke Qwen2-7B at
head_dim 64 (4 q / 2 kv heads, d_model 64, 2 layers) in fp32 compute is
held at ``chip_smoke.TOL_SERVE_MESH``; ``--full`` adds Qwen2-7B at full
width and depth (28 layers, 30.5 GB of fp32 parameters whole, ~15 GB a
rank) in its bf16 compute, the reference's memory freed before the
ranks start, held at ``chip_smoke.TOL_SERVE_DENSE``.  Greedy tokens must
be equal but where the rows part at a tie (``chip_smoke.parting``).  The
weights are seeded leaf by leaf on the card, so every process draws the
same and none holds more than one whole leaf beyond its blocks.

    python3 scripts/mesh_ranks.py --serve [--full]
    python3 scripts/mesh_ranks.py --serve --full --ranks-only --json OUT.json
"""
import argparse
import json
import os
import socket
import sys
import tempfile
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as CS                      # noqa: E402

ARGV = CS.MESH_RANKS_ARGV
MESHES = ("1,2", "2")
SERVE_MESH = (1, 2)
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 2, 8192, 8
# each serve case's tolerance on the logits against the run without a mesh
SERVE_TOL = {"smoke": CS.TOL_SERVE_MESH, "full": CS.TOL_SERVE_DENSE}


def serve_config(case: str):
    """Qwen2-7B whole (``"full"``, bf16 compute), or its smoke config at
    head_dim 64 in fp32 compute (``"smoke"``), ``max_seq_len`` the prompt
    and the decode steps."""
    from repro_torch.configs.archs import get_config, get_smoke_config
    if case == "full":
        return get_config("qwen2-7b")
    return get_smoke_config("qwen2-7b", head_dim=64, dtype="float32",
                            max_seq_len=SERVE_PROMPT + SERVE_STEPS)


def serve_leaf(path: str, shape: tuple, index: int, device) -> torch.Tensor:
    """A seeded parameter leaf (its own generator, so a process draws any
    leaf alone): norm scales ones, tables and biases normal x 0.02,
    matrices normal over the root of their fan-in."""
    gen = torch.Generator(device=device).manual_seed(1000 + index)
    if path.endswith(("norm1/w", "norm2/w", "final_norm/w", "_norm")):
        return torch.ones(shape, device=device)
    x = torch.randn(shape, generator=gen, device=device)
    if path in ("embed", "lm_head") or len(shape) < 3:
        return x.mul_(0.02)
    return x.mul_(shape[-2] ** -0.5)


def serve_case(case: str, device, mesh=None) -> dict:
    """Prefill and ``SERVE_STEPS`` decode steps of :func:`serve_config`'s
    model, without a mesh or on ``mesh`` through the serving view (each
    rank its parameter blocks and its block of the cache; it fails where
    the view does not apply: no fallback to the whole route).  Returns
    the logits of the prefill and of every step (numpy, fp32), each
    step's greedy tokens, the kernels' launches in the case, the seconds
    from the prefill to the last step and the peak memory of this
    process."""
    import time
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch import tree
    cfg = serve_config(case)
    model = build_model(cfg, mesh)
    shapes = {k: tuple(v.shape)
              for k, v in SH.param_structs(model).items()}
    pshard = (SH.param_shardings(model, mesh, "prefill", params=shapes)
              if mesh is not None else None)
    params = {}
    for i, (k, shape) in enumerate(shapes.items()):
        leaf = serve_leaf(k, shape, i, device)
        params[k] = leaf if mesh is None else SH.to_local(
            SH.place(leaf, pshard[k]))
        del leaf
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_STEPS,
                             device=device)
    use = L.no_gather
    if mesh is not None:
        cshard = SH.cache_shardings(cfg, mesh, cache, False)
        cache = SH.local_tree(SH.place_tree(cache, cshard))
        use = SH.serving_view(model, mesh, pshard, shapes, cshard)
        if use is None or not use.seq_split:
            raise RuntimeError("the serving view does not split this model")
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, device=device)
    feed = torch.randint(0, cfg.vocab, (SERVE_STEPS, SERVE_BATCH, 1),
                         generator=gen, device=device)
    params = tree.unflatten(params)
    out = {"logits": [], "greedy": []}

    def keep(lg):
        lg = lg[:, -1].float()
        out["logits"].append(lg.cpu().numpy())
        out["greedy"].append(lg.argmax(-1).cpu().numpy())

    CS.reset_launches()
    cuda = device.type == "cuda"          # (a CPU rehearsal has no peak)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with torch.inference_mode(), L.gathering(use):
        lg, cache = model.prefill(params, tokens, cache)
        keep(lg)
        for tok in feed:
            lg, cache = model.decode_step(params, cache, tok)
            keep(lg)
    if cuda:
        torch.cuda.synchronize(device)
    out["seconds"] = time.perf_counter() - t0
    out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                       if cuda else 0.0)
    out["launches"] = CS.launch_counts()
    return out


def free_memory() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def serve_worker(rank: int, port: int, out: str, cases: tuple):
    """One rank of the ``--serve`` cases, in turn; rank 0 writes each
    case's logits and greedy tokens (``out.<case>.npz``) and every rank's
    ``{case: launches, seconds and peak, or the error}`` (``out``)."""
    import faulthandler
    import numpy as np
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    faulthandler.enable()
    os.environ["LOCAL_RANK"] = "0"
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    mesh = make_mesh(SERVE_MESH, ("data", "model"), "cuda")
    res = {}
    for case in cases:
        try:
            got = serve_case(case, torch.device("cuda", 0), mesh)
            arrays = {"logits": np.stack(got.pop("logits")),
                      "greedy": np.stack(got.pop("greedy"))}
            if rank == 0:
                np.savez(f"{out}.{case}.npz", **arrays)
            res[case] = got
        except Exception:  # noqa: BLE001 -- the reading is the error
            res[case] = {"error": traceback.format_exc()}
        free_memory()
    ranks = [None, None]
    dist.all_gather_object(ranks, res)
    if rank == 0:
        Path(out).write_text(json.dumps({"ranks": ranks}))
    dist.destroy_process_group()


def run(argv):
    from repro_torch.launch import train as launcher
    state, hist = launcher.main(argv)
    return state, [h["loss"] for h in hist]


def worker(rank: int, port: int, out: str, meshes=MESHES):
    import faulthandler
    import torch.distributed as dist
    faulthandler.enable()                   # a crash prints its stack
    os.environ["LOCAL_RANK"] = "0"          # both ranks on the one card
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    res = {}
    for spec in meshes:
        try:
            _, losses = run(ARGV + ["--mesh", spec])
            res[spec] = losses
        except Exception:  # noqa: BLE001 -- the reading is the error
            res["error"] = res.get("error", "") + f"--mesh {spec}:\n" \
                + traceback.format_exc()
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass


def spawn_ranks(out: str, meshes=MESHES, serve=None) -> dict:
    """Each mesh of ``meshes`` trained on two gloo ranks on cuda:0; the
    ranks' ``{mesh: losses}``, with ``"error"`` where a run failed, also
    written to ``out``.  ``serve`` (a tuple of serve cases) runs
    :func:`serve_worker` instead: ``{"ranks": [each rank's {case:
    launches, seconds, peak or error}]}``, the arrays in
    ``out.<case>.npz``."""
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        if serve is None:
            mp.spawn(worker, args=(port, out, tuple(meshes)), nprocs=2)
        else:
            mp.spawn(serve_worker, args=(port, out, tuple(serve)), nprocs=2)
    except Exception:  # noqa: BLE001
        print(traceback.format_exc())
    if not os.path.exists(out):
        Path(out).write_text(json.dumps({"error": "no result written"}))
    return json.loads(Path(out).read_text())


def serve_errors(res: dict, case: str) -> str:
    """The ranks' errors in ``case`` of a ``--serve`` run, or ""."""
    if "error" in res:
        return res["error"]
    return "".join(r.get(case, {"error": f"no {case} result\n"})
                   .get("error", "") for r in res["ranks"])


def hold_serve(case: str, ref: dict, out: str) -> tuple:
    """``(largest logit difference over the largest logit, count of rows
    whose greedy tokens part at a tie, or -1 where one parts beyond a
    tie)`` of the ranks' arrays (``out.<case>.npz``) against the run
    without a mesh ``ref``, the case's tolerance (``SERVE_TOL``) applying
    to both."""
    import numpy as np
    got = np.load(f"{out}.{case}.npz")
    want = np.stack(ref["logits"])
    err = float(np.abs(got["logits"] - want).max() / np.abs(want).max())
    ties = 0
    for rows_a, rows_b, mine, theirs in zip(got["logits"], want,
                                            got["greedy"], ref["greedy"]):
        for a, b, ta, tb in zip(rows_a, rows_b, mine, theirs):
            if ta != tb:
                *_, tie = CS.parting(torch.from_numpy(a), torch.from_numpy(b),
                                     int(ta), int(tb), SERVE_TOL[case])
                if not tie:
                    return err, -1
                ties += 1
    return err, ties


def serve_cases(full: bool) -> tuple:
    return ("smoke", "full") if full else ("smoke",)


def main(argv=None) -> int:
    import numpy as np
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", action="append", default=None)
    ap.add_argument("--ranks-only", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    meshes = tuple(args.mesh or MESHES)
    if not torch.cuda.is_available():
        print("no GPU")
        return 1
    out = args.json or os.path.join(tempfile.mkdtemp(), "mesh_ranks.json")
    if args.serve:
        return serve_main(serve_cases(args.full), args.ranks_only, out)
    if args.ranks_only:
        res = spawn_ranks(out, meshes)
        print("RESULT " + ("error" if "error" in res else "ok"))
        return 0
    _, ref = run(ARGV)
    print(f"without a mesh: {ref}")
    res = spawn_ranks(out, meshes)
    ok = "error" not in res
    for spec in meshes:
        if spec in res:
            err = float(np.max(np.abs(np.subtract(res[spec], ref))
                               / np.abs(ref)))
            print(f"--mesh {spec} on two gloo ranks on cuda:0: {res[spec]}; "
                  f"largest relative difference {err:.3e}")
            ok = ok and err <= CS.TOL_MESH_RANKS
    if "error" in res:
        print(res["error"])
    print("RESULT " + ("ok" if ok else "error"))
    return 0


def serve_main(cases: tuple, ranks_only: bool, out: str) -> int:
    refs = {}
    for case in ([] if ranks_only else cases):
        refs[case] = serve_case(case, torch.device("cuda", 0))
        print(f"{case} without a mesh: {refs[case]['seconds']:.2f} s, peak "
              f"{refs[case]['peak_gib']:.2f} GiB, B6 forward launches "
              f"{refs[case]['launches']['flash_fwd']}")
        free_memory()
    res = spawn_ranks(out, serve=cases)
    ok = True
    for case in cases:
        bad = serve_errors(res, case)
        if bad:
            print(bad)
            ok = False
            continue
        for i, r in enumerate(res["ranks"]):
            r = r[case]
            print(f"{case} rank {i}: {r['seconds']:.2f} s, peak "
                  f"{r['peak_gib']:.2f} GiB, B6 forward launches "
                  f"{r['launches']['flash_fwd']}")
        if case in refs:
            err, ties = hold_serve(case, refs[case], out)
            tol = SERVE_TOL[case]
            ok = ok and err <= tol and ties >= 0
            model = "Qwen2-7B, bf16" if case == "full" else "smoke Qwen2, fp32"
            tokens = ("differ beyond a tie" if ties < 0
                      else f"equal but {ties} ties")
            print(f"--mesh 1,2 serving on two gloo ranks on cuda:0 ({model})"
                  f": largest logit difference {err:.3e} of the largest "
                  f"logit (tolerance {tol}); greedy tokens {tokens} "
                  f"({CS.card_line()})")
    print("RESULT " + ("ok" if ok else "error"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
