"""Two (or four) ranks on one GPU under gloo: whether gloo's CUDA
collectives carry the port's mesh training step and its serving (NCCL
refuses two ranks on one device).

The training cases (``TRAIN_CASES``), each through the launcher with
--fused-update --refresh-every 5 on its mixed groups: ``gpt2``, the smoke
GPT-2 (4 q / 2 kv heads of 16, d_ff 128, vocab 512), batch 8 x 128, 6
steps; ``mamba2`` and ``zamba2``, the smoke Mamba2-370m and Zamba2-2.7B
the same way; ``mamba2-370m``, Mamba2-370m at full width, its depth cut
to 12 of 48 layers (``TRAIN_DEPTH``), batch 2 x 1024, 3 steps;
``whisper``, the smoke Whisper-large-v3 as the smoke GPT-2 but through
``build_train_step`` on ``make_batch``'s tokens and frames
(:func:`train_direct`: the launcher stops for want of ``embeds``, as the
JAX launcher does) (each case's batch and length in ``TRAIN_SHAPE``).
Each runs first without a mesh in this process, then ``--mesh 1,2``
(the products split over
``model``: half the heads (SSM heads too), the MLP and the vocabulary a
rank) and ``--mesh 2`` (the batch split, every product whole) on two
gloo ranks, both on cuda:0.  Each mesh run's losses are held to the
run without a mesh at rtol 1e-3 (the CPU tests' cross-mesh tolerance).

    python3 scripts/mesh_ranks.py        # on a machine with a GPU
    python3 scripts/mesh_ranks.py --case all --mesh 1,2
    python3 scripts/mesh_ranks.py --ranks-only --case all --mesh 1,2 \
        --json OUT.json

Prints each run's losses and the reading, or the error the mesh run
raised (a crash's Python stack through ``faulthandler``); the last line
is ``RESULT ok`` or ``RESULT error``.  ``--case`` picks the training
cases (``gpt2`` by default, ``all`` for every one), ``--mesh`` the
meshes.  ``--ranks-only`` runs no reference and writes the ranks'
``{"train": {case: {mesh: losses}}, "serve": ...}`` (and ``"error"``
where a run failed) to ``--json`` for a caller that holds them itself
(``chip_smoke.py``'s ``[mesh]``).

``--serve`` serves, alone or, with ``--case``, after the training cases
in the same spawn of the two ranks, at ``--mesh 1,2``
(``sharding.serving_view``: the heads (SSM heads too), MLP and
vocabulary split over ``model``, the KV cache's sequence kept split, the
Mamba states' heads too; Whisper's cross cache's encoder rows),
2 prompts and 8 decode steps fed seeded tokens (Whisper's prompt after
seeded frames), each step's logits and greedy tokens held to the run
without a mesh in this process, and the kernels' launches a rank counted
in the prefill and in decode (``expected_launches``).  The smoke cases
in fp32 compute, held at ``chip_smoke.TOL_SERVE_MESH``: ``smoke`` and
``smoke-whisper``, Qwen2-7B and Whisper-large-v3 at head_dim 64 (4 q /
2 kv heads, d_model 64, 2 layers), prompts of 8192 tokens (so the
flash-attention kernel, B6, runs on each rank's heads);
``smoke-mamba2`` and ``smoke-zamba2``, prompts of 1024 (B7, the SSD
block, on each rank's SSM heads).  ``--full`` adds Qwen2-7B at full
width and depth (``full``: 28 layers) in its bf16 compute, held at
``chip_smoke.TOL_SERVE_DENSE``, Zamba2-2.7B (``full-zamba2``: 12 of its
54 Mamba2 layers, so 2 shared-block applications, one of each block)
held at ``chip_smoke.TOL_SERVE_SSM`` and Whisper-large-v3
(``full-whisper``: 1500 frames, its depth ``SERVE_DEPTH``) held at
``chip_smoke.TOL_SERVE_ENCDEC``, in bf16, prompts of 8192; each
reference's memory is freed before the ranks start.  ``--serve`` then
runs a second spawn, of four ranks at ``--mesh 2,2`` (``LONG_MESH``), serving
at the ``long_500k`` cells' layout: B = 1, the KV cache's sequence over
(data, model), a prompt of 8192 into ``LONG_CACHE`` = 16,384 rows (4096
a rank: the prompt fills the first data group's blocks) and 8 decode
steps into the third rank's block: ``long-smoke-zamba2`` in fp32 at
``TOL_SERVE_MESH`` and, with ``--full``, ``long-full-zamba2`` (12
layers) in bf16 at ``TOL_SERVE_SSM``.  Gloo moves every collective
through the host, so the full-width cases' seconds a rank grow with the
depth: Zamba2-2.7B's and Whisper-large-v3's (``SERVE_DEPTH``) and
Mamba2-370m's (``TRAIN_DEPTH``) are cut to keep ``chip_smoke.py``
inside its time limit.  Greedy tokens must be equal but where the rows
part at a tie (``chip_smoke.parting``).  The weights are seeded leaf by
leaf on the card, so every process draws the same and none holds more
than one whole leaf beyond its blocks.

    python3 scripts/mesh_ranks.py --serve [--full]
    python3 scripts/mesh_ranks.py --ranks-only --case all --mesh 1,2 \
        --serve --full --json OUT.json     # chip_smoke.py's two spawns
"""
import argparse
import contextlib
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
# name -> (batch, seq) of the training case
TRAIN_SHAPE = {"gpt2": (8, 128), "mamba2": (8, 128), "zamba2": (8, 128),
               "mamba2-370m": (2, 1024), "whisper": (8, 128)}
# name -> the launcher's argv (the mesh appended), its TRAIN_SHAPE
# appended; the smoke SSM cases as the smoke GPT-2 (ARGV's first two
# entries are its --arch)
TRAIN_CASES = {name: argv + ["--batch", str(TRAIN_SHAPE[name][0]),
                             "--seq", str(TRAIN_SHAPE[name][1])]
               for name, argv in {
    "gpt2": ARGV,
    "mamba2": ["--arch", "mamba2-370m"] + ARGV[2:],
    "zamba2": ["--arch", "zamba2-2.7b"] + ARGV[2:],
    "mamba2-370m": ["--arch", "mamba2-370m", "--steps", "3",
                    "--fused-update", "--refresh-every", "5", "--log-every",
                    "1", "--device", "cuda"],
    "whisper": ["--arch", "whisper-large-v3"] + ARGV[2:]}.items()}
# the training cases the launcher cannot run (no data source makes
# Whisper's ``embeds``): trained through ``build_train_step`` on
# ``make_batch``'s batches, with the launcher's optimizer
DIRECT_TRAIN = ("whisper",)
# the full-width cases' depth cuts (layers; Whisper's encoder and decoder
# each), the time limit's choice; Qwen2-7B ("full") serves at its full
# depth
TRAIN_DEPTH = {"mamba2-370m": 12}
SERVE_DEPTH = {"full-zamba2": 12, "long-full-zamba2": 12,
               "full-whisper": 32}


def train_config(case: str):
    """The model config the launcher (or :func:`train_direct`) builds for
    the training case."""
    from repro_torch.configs.archs import get_smoke_config
    argv = TRAIN_CASES[case]
    arch = argv[argv.index("--arch") + 1]
    if "--smoke" in argv:
        return get_smoke_config(arch)
    return CS.arch_config(arch, TRAIN_DEPTH.get(case))


def run_case(case: str, extra=()) -> list:
    """The training case's losses through the launcher (``extra``
    appended to its argv), at its ``TRAIN_DEPTH``; a ``DIRECT_TRAIN`` case
    through :func:`train_direct`."""
    if case in DIRECT_TRAIN:
        return train_direct(case, extra)
    depth = TRAIN_DEPTH.get(case)
    with (CS.depth_cut(depth) if depth else contextlib.nullcontext()):
        return run(TRAIN_CASES[case] + list(extra))[1]


def train_direct(case: str, extra=()) -> list:
    """The losses of a ``DIRECT_TRAIN`` case: its smoke model (the
    launcher's init, seed 0), the launcher's optimizer for its argv, and
    ``--steps`` batches of ``configs.make_batch`` (tokens and the stub
    frontend's ``embeds``, seed 1) through ``build_train_step``, on the
    ``--mesh`` in ``extra`` (the batch and the products placed as the
    launcher places them) or without one."""
    from repro_torch.configs.archs import get_smoke_config
    from repro_torch.configs.base import make_batch
    from repro_torch.core.build import build_optimizer
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train as launcher
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.steps import TrainState, build_train_step
    args = launcher.parse_args(TRAIN_CASES[case] + list(extra))
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = launcher.parse_mesh(args.mesh, "cuda") if args.mesh else None
    cfg = get_smoke_config(args.arch, max_seq_len=args.seq)
    model = build_model(cfg, mesh)
    opt = build_optimizer(launcher.optimizer_config(
        args.optimizer, args.steps, args.lr,
        refresh_every=args.refresh_every, fused_update=args.fused_update,
        mixed_groups=True, embedding_min_rows=args.embedding_min_rows,
        sketch_width=args.sketch_width, sketch_depth=args.sketch_depth))
    params = model.init(torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    batches = [make_batch(cfg, args.batch, args.seq, gen)
               for _ in range(args.steps)]
    ssh = bsh = None
    if mesh is not None:
        ssh, bsh = SH.train_shardings(
            model, opt, mesh, {k: tuple(v.shape)
                               for k, v in batches[0].items()},
            params=params)
        state = SH.place_state(TrainState.create(params, opt), ssh)
    else:
        state = TrainState.create(params, opt)
    step = build_train_step(model, opt, state_shardings=ssh,
                            batch_shardings=bsh)
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def train_launches(case: str) -> dict:
    """B7's launches a rank in the training case's run: its forward once
    a Mamba2 layer a step (twice under remat), each backward kernel
    once."""
    cfg = train_config(case)
    argv = TRAIN_CASES[case]
    n = int(argv[argv.index("--steps") + 1]) * (
        cfg.n_layers if cfg.ssm is not None else 0)
    return {"ssd_fwd": n * (1 if cfg.remat == "none" else 2),
            "ssd_bwd_rows": n, "ssd_bwd_cols": n}


SERVE_MESH = (1, 2)
SERVE_BATCH, SERVE_STEPS = 2, 8
# name -> (prompt tokens, tolerance on the logits against the run without
# a mesh)
SERVE_CASES = {"smoke": (8192, CS.TOL_SERVE_MESH),
               "smoke-mamba2": (1024, CS.TOL_SERVE_MESH),
               "smoke-zamba2": (1024, CS.TOL_SERVE_MESH),
               "smoke-whisper": (8192, CS.TOL_SERVE_MESH),
               "full": (8192, CS.TOL_SERVE_DENSE),
               "full-zamba2": (8192, CS.TOL_SERVE_SSM),
               "full-whisper": (8192, CS.TOL_SERVE_ENCDEC),
               "long-smoke-zamba2": (8192, CS.TOL_SERVE_MESH),
               "long-full-zamba2": (8192, CS.TOL_SERVE_SSM)}
SERVE_TOL = {case: tol for case, (_, tol) in SERVE_CASES.items()}
# the long-context cases: the long_500k cells' layout, B = 1 and the KV
# cache's sequence over (data, model), on four ranks; a cache of LONG_CACHE
# rows, 4096 a rank, so the prompt fills the first two ranks' blocks (the
# first data group's) and decode writes into the third's
LONG_MESH, LONG_CACHE = (2, 2), 16_384
LONG_CASES = ("long-smoke-zamba2", "long-full-zamba2")


def serve_shape(case: str) -> tuple:
    """``(batch, cache rows, mesh)`` of a serving case."""
    if case in LONG_CASES:
        return 1, LONG_CACHE, LONG_MESH
    return SERVE_BATCH, SERVE_CASES[case][0] + SERVE_STEPS, SERVE_MESH


def serve_config(case: str):
    """The case's config (``SERVE_CASES``): Qwen2-7B (``"full"``) at full
    width and depth, Zamba2-2.7B (``"full-zamba2"``, ``"long-full-
    zamba2"``) or Whisper-large-v3 (``"full-whisper"``, its encoder and
    decoder alike) at full width, the depth cut to ``SERVE_DEPTH``, bf16
    compute; the smoke Qwen2-7B or Whisper-large-v3 at head_dim 64
    (``"smoke"``, ``"smoke-whisper"``), Mamba2-370m or Zamba2-2.7B in fp32
    compute, ``max_seq_len`` the cache's rows."""
    from repro_torch.configs.archs import get_smoke_config
    arch = {"full": "qwen2-7b", "smoke": "qwen2-7b",
            "smoke-mamba2": "mamba2-370m"}.get(
        case, "whisper-large-v3" if case.endswith("whisper")
        else "zamba2-2.7b")
    if "full" in case:
        depth = SERVE_DEPTH.get(case)
        over = ({"enc_layers": depth}
                if depth and arch == "whisper-large-v3" else {})
        return CS.arch_config(arch, depth, **over)
    seq = serve_shape(case)[1]
    if case in ("smoke", "smoke-whisper"):
        return get_smoke_config(arch, head_dim=64, dtype="float32",
                                max_seq_len=seq)
    return get_smoke_config(arch, dtype="float32", max_seq_len=seq)


def expected_launches(case: str) -> dict:
    """``{"prefill" | "decode": {kernel: launches a rank}}`` of the serving
    kernels: B7's forward once a Mamba2 layer and B6's once a (decoder)
    self-attention layer where the prompt takes the chunked path (past
    4096 tokens; Whisper's encoder, 1500 frames, and cross attention stay
    on the naive path), in the prefill; neither in decode."""
    from repro_torch.models.attention import CHUNK_THRESHOLD
    cfg = serve_config(case)
    ssd = cfg.n_layers if cfg.ssm is not None else 0
    attn = {"dense": cfg.n_layers, "encdec": cfg.n_layers,
            "hybrid": cfg.n_layers // max(cfg.hybrid_attn_every, 1)}.get(
        cfg.family, 0)
    if SERVE_CASES[case][0] <= CHUNK_THRESHOLD:
        attn = 0
    return {"prefill": {"ssd_fwd": ssd, "flash_fwd": attn},
            "decode": {"ssd_fwd": 0, "flash_fwd": 0}}


def serve_leaf(path: str, shape: tuple, index: int, device) -> torch.Tensor:
    """A seeded parameter leaf (its own generator, so a process draws any
    leaf alone): norm scales ones, tables and biases normal x 0.02,
    matrices normal over the root of their fan-in."""
    gen = torch.Generator(device=device).manual_seed(1000 + index)
    if path.endswith(("norm1/w", "norm2/w", "final_norm/w", "_norm",
                      "/norm/w", "norm_w", "norm_x/w", "enc_norm/w",
                      "dec_norm/w")):
        return torch.ones(shape, device=device)
    x = torch.randn(shape, generator=gen, device=device)
    if path in ("embed", "lm_head") or len(shape) < 3:
        return x.mul_(0.02)
    return x.mul_(shape[-2] ** -0.5)


def serve_case(case: str, device, mesh=None) -> dict:
    """Prefill and ``SERVE_STEPS`` decode steps of :func:`serve_config`'s
    model at :func:`serve_shape` (Whisper's prompt after seeded frames of
    the stub frontend), without a mesh or on ``mesh`` through the serving
    view (each rank its parameter blocks and its blocks of the caches, a
    long-context case's by the ``long_500k`` specs; it fails where the
    view does not apply: no fallback to the whole route).
    Returns the logits of the prefill and of every step (numpy, fp32),
    each step's greedy tokens, the kernels' launches in the prefill and
    in decode, the seconds from the prefill to the last step and the
    peak memory of this process."""
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
    prompt = SERVE_CASES[case][0]
    batch, rows, _ = serve_shape(case)
    cache = model.init_cache(batch, rows, device=device)
    use = L.no_gather
    if mesh is not None:
        cshard = SH.cache_shardings(cfg, mesh, cache, case in LONG_CASES)
        cache = SH.local_tree(SH.place_tree(cache, cshard))
        use = SH.serving_view(model, mesh, pshard, shapes, cshard)
        if use is None or ("kv" in cache and not use.seq_split):
            raise RuntimeError("the serving view does not split this model")
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt),
                           generator=gen, device=device)
    feed = torch.randint(0, cfg.vocab, (SERVE_STEPS, batch, 1),
                         generator=gen, device=device)
    kw = {}
    if cfg.family == "encdec":          # the stub frontend's frames
        kw["embeds"] = torch.randn(
            (batch, cfg.enc_seq, cfg.d_model), generator=gen,
            device=device).to(getattr(torch, cfg.dtype))
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
        lg, cache = model.prefill(params, tokens, cache, **kw)
        keep(lg)
        launches = {"prefill": CS.launch_counts()}
        CS.reset_launches()
        for tok in feed:
            lg, cache = model.decode_step(params, cache, tok)
            keep(lg)
    if cuda:
        torch.cuda.synchronize(device)
    out["seconds"] = time.perf_counter() - t0
    out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                       if cuda else 0.0)
    out["launches"] = dict(launches, decode=CS.launch_counts())
    return out


def launches_held(case: str, launches: dict) -> bool:
    """Whether a rank's (or the run without a mesh's) launches in the
    prefill and in decode are :func:`expected_launches`'."""
    want = expected_launches(case)
    return all(launches[phase].get(k, 0) == n for phase in want
               for k, n in want[phase].items())


def free_memory() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def serve_ranks(rank: int, out: str, cases: tuple, shape=SERVE_MESH) -> dict:
    """This rank's ``--serve`` cases, in turn, on the mesh ``shape``:
    ``{case: launches, seconds and peak, or the error}``; rank 0 writes
    each case's logits and greedy tokens (``out.<case>.npz``)."""
    import numpy as np
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"), "cuda")
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
    return res


def run(argv):
    from repro_torch.launch import train as launcher
    state, hist = launcher.main(argv)
    return state, [h["loss"] for h in hist]


def train_ranks(meshes: tuple, cases: tuple) -> dict:
    """This rank's training cases on each mesh: ``{case: {mesh: losses,
    "<mesh> seconds" / "<mesh> peak_gib" / "<mesh> launches": ...}}``,
    with ``"error"`` where a run failed."""
    import time
    res = {}
    for case in cases:
        res[case] = {}
        for spec in meshes:
            try:
                CS.reset_launches()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res[case][spec] = run_case(case, ["--mesh", spec])
                res[case][spec + " seconds"] = time.perf_counter() - t0
                res[case][spec + " peak_gib"] = \
                    torch.cuda.max_memory_allocated() / 2**30
                res[case][spec + " launches"] = CS.launch_counts()
            except Exception:  # noqa: BLE001 -- the reading is the error
                res["error"] = res.get("error", "") + \
                    f"{case} --mesh {spec}:\n" + traceback.format_exc()
            free_memory()
    return res


def worker(rank: int, port: int, out: str, meshes=MESHES, cases=("gpt2",),
           serve=(), shape=SERVE_MESH):
    """One rank of ``prod(shape)``: the training ``cases`` on each of
    ``meshes``, then the ``serve`` cases on the mesh ``shape``, in one
    process group; rank 0 writes ``{"train": rank 0's training record
    with each rank's launches and peak, "serve": {"ranks": [each rank's
    serving record]}, "startup_seconds": from the rank's start to its
    first case}`` to ``out``."""
    import faulthandler
    import math
    import time
    import torch.distributed as dist
    t0 = time.perf_counter()
    faulthandler.enable()                   # a crash prints its stack
    os.environ["LOCAL_RANK"] = "0"          # every rank on the one card
    world = math.prod(shape)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    torch.cuda.init()
    startup = time.perf_counter() - t0
    res = train_ranks(meshes, cases)
    served = serve_ranks(rank, out, serve, shape)
    ranks = [None] * world
    dist.all_gather_object(ranks, (res, served))
    for case in cases:
        for spec in meshes:
            for key in (spec + " launches", spec + " peak_gib"):
                if key in res[case]:
                    res[case][key] = [r[0][case].get(key) for r in ranks]
    if rank == 0:
        Path(out).write_text(json.dumps({
            "train": res, "serve": {"ranks": [r[1] for r in ranks]},
            "startup_seconds": startup}))
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass


def spawn_ranks(out: str, meshes=MESHES, cases=("gpt2",), serve=(),
                shape=SERVE_MESH) -> dict:
    """The training ``cases`` on each mesh of ``meshes``, then the
    ``serve`` cases on the mesh ``shape``, on its gloo ranks (two by
    default) on cuda:0, in one spawn (:func:`worker`).  Returns, as
    written to ``out``, ``{"train": {case: {mesh: losses, "<mesh>
    seconds": s, "<mesh> launches" /
    "<mesh> peak_gib": [each rank's launches / peak memory]}}, with
    "error" where a run failed, "serve": {"ranks": [each rank's {case:
    launches, seconds, peak or error}]}}``, the serving arrays in
    ``out.<case>.npz``; both ``{"error": ...}`` where no result came."""
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        mp.spawn(worker, args=(port, out, tuple(meshes), tuple(cases),
                               tuple(serve), tuple(shape)),
                 nprocs=shape[0] * shape[1])
    except Exception:  # noqa: BLE001
        print(traceback.format_exc())
    if not os.path.exists(out):
        none = {"error": "no result written"}
        Path(out).write_text(json.dumps({"train": none, "serve": none}))
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
    """The serving cases on two ranks at ``SERVE_MESH``."""
    smoke = ("smoke", "smoke-mamba2", "smoke-zamba2", "smoke-whisper")
    return smoke + ("full", "full-zamba2", "full-whisper") if full else smoke


def long_cases(full: bool) -> tuple:
    """The long-context serving cases on four ranks at ``LONG_MESH``."""
    return LONG_CASES if full else LONG_CASES[:1]


def spawn_all(out: str, meshes: tuple, cases: tuple, serve: tuple,
              longs: tuple) -> dict:
    """:func:`spawn_ranks` on two ranks (the training cases, then the
    ``serve`` cases), then, with ``longs``, a second spawn of four ranks
    at ``LONG_MESH`` writing to ``out.long`` (its arrays
    ``out.long.<case>.npz``); returns the first's result with the
    second's serving record under ``"long"``, as written to ``out``."""
    res = spawn_ranks(out, meshes, cases, serve)
    if longs:
        res["long"] = spawn_ranks(out + ".long", (), (), longs,
                                  LONG_MESH)["serve"]
        Path(out).write_text(json.dumps(res))
    return res


def losses_err(got: list, ref: list) -> float:
    """The largest relative difference of two runs' losses (inf where
    their lengths differ)."""
    import numpy as np
    if len(got) != len(ref):
        return float("inf")
    return float(np.max(np.abs(np.subtract(got, ref)) / np.abs(ref)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", action="append", default=None)
    ap.add_argument("--case", action="append", default=None,
                    help=f"training case, of {sorted(TRAIN_CASES)} or all")
    ap.add_argument("--ranks-only", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    meshes = tuple(args.mesh or MESHES)
    cases = tuple(args.case or (() if args.serve else ("gpt2",)))
    if "all" in cases:
        cases = tuple(TRAIN_CASES)
    serve = serve_cases(args.full) if args.serve else ()
    longs = long_cases(args.full) if args.serve else ()
    if not torch.cuda.is_available():
        print("no GPU")
        return 1
    out = args.json or os.path.join(tempfile.mkdtemp(), "mesh_ranks.json")
    if args.ranks_only:
        res = spawn_all(out, meshes, cases, serve, longs)
        bad = "error" in res["train"] or any(
            serve_errors(res["serve"], case) for case in serve) or any(
            serve_errors(res["long"], case) for case in longs)
        print("RESULT " + ("error" if bad else "ok"))
        return 0
    refs = {}
    for case in cases:
        refs[case] = run_case(case)
        print(f"{case} without a mesh: {refs[case]}")
        free_memory()
    serve_refs = {}
    for case in serve + longs:
        serve_refs[case] = serve_case(case, torch.device("cuda", 0))
        print(f"{case} without a mesh: {serve_refs[case]['seconds']:.2f} s, "
              f"peak {serve_refs[case]['peak_gib']:.2f} GiB, launches "
              f"{serve_refs[case]['launches']}")
        free_memory()
    res = spawn_all(out, meshes, cases, serve, longs)
    ok = hold_train(res["train"], refs, meshes)
    ok = hold_serving(res["serve"], {c: serve_refs[c] for c in serve},
                      out) and ok
    if longs:
        ok = hold_serving(res["long"], {c: serve_refs[c] for c in longs},
                          out + ".long") and ok
    print("RESULT " + ("ok" if ok else "error"))
    return 0


def hold_train(res: dict, refs: dict, meshes: tuple) -> bool:
    """Prints each training case's mesh runs against its run without a
    mesh; whether every one holds ``chip_smoke.TOL_MESH_RANKS``."""
    ok = "error" not in res
    for case in refs:
        for spec in meshes:
            got = res.get(case, {}).get(spec)
            if got is None:
                ok = False
                continue
            err = losses_err(got, refs[case])
            print(f"{case} --mesh {spec} on two gloo ranks on cuda:0: {got}"
                  f"; largest relative difference {err:.3e}")
            ok = ok and err <= CS.TOL_MESH_RANKS
    if "error" in res:
        print(res["error"])
    return ok


def hold_serving(res: dict, refs: dict, out: str) -> bool:
    """Prints each serving case's ranks against its run without a mesh;
    whether every one holds its tolerance and its launches."""
    ok = True
    for case, ref in refs.items():
        bad = serve_errors(res, case)
        if bad:
            print(bad)
            ok = False
            continue
        for i, r in enumerate(res["ranks"]):
            r = r[case]
            held = launches_held(case, r["launches"])
            ok = ok and held
            print(f"{case} rank {i}: {r['seconds']:.2f} s, peak "
                  f"{r['peak_gib']:.2f} GiB, launches {r['launches']} "
                  f"({'as' if held else 'not as'} expected: "
                  f"{expected_launches(case)})")
        err, ties = hold_serve(case, ref, out)
        tol = SERVE_TOL[case]
        ok = ok and err <= tol and ties >= 0
        tokens = ("differ beyond a tie" if ties < 0
                  else f"equal but {ties} ties")
        mesh = ",".join(map(str, serve_shape(case)[2]))
        print(f"--mesh {mesh} serving on gloo ranks on cuda:0 ({case}, "
              f"{serve_config(case).dtype}): largest logit difference "
              f"{err:.3e} of the largest logit (tolerance {tol}); greedy "
              f"tokens {tokens} ({CS.card_line()})")
    return ok


if __name__ == "__main__":
    sys.exit(main())
