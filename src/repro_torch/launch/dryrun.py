"""Multi-pod dry run of the port: the JAX package's ``launch/dryrun.py``.

For every (architecture x shape cell x mesh) combination it

  * builds the full-size config, the production mesh ((data=16, model=16)
    = 256 ranks, or (pod=2, data=16, model=16) = 512) and the port's
    sharded step, in one process: the mesh is a ``DeviceMesh`` over a
    fake process group (``launch/mesh.py::make_fake_mesh``), every tensor
    a fake one (``FakeTensorMode``: shapes and dtypes, no storage), so no
    array is allocated at any size;
  * places the state by the port's specs, as a real run does: train cells
    a ``TrainState`` by ``train_shardings`` (parameters, optimizer state),
    serving cells the parameters by ``param_shardings`` and the cache by
    ``cache_shardings``, each split leaf a DTensor holding this rank's
    block;
  * runs one step of it as rank 0 runs it, under ``launch/step_cost.py``'s
    counter: train cells one ``build_train_step`` step of the mesh step
    (``train/steps.py::_MeshStep``), prefill and decode cells ``prefill`` /
    ``decode_step`` on the parameters gathered the same way (the expert
    stacks of the MoE mesh paths as this rank's blocks, every other leaf
    whole) and the cache gathered over every axis but the dp axes (the
    rank keeps its batch block);
  * records per-rank bytes (parameters, optimizer state, batch block,
    cache: each a DTensor's local block), the step's peak of live bytes,
    FLOPs, bytes accessed and the collectives it calls, and writes one
    JSON per cell.

What the numbers are.  The stored bytes follow JAX's specs leaf for leaf.
The step is the port's gather design: it gathers every split parameter
and the whole optimizer state and runs every product whole, so its peak
and its FLOPs are the unsharded model's on the rank's batch block (the
MoE expert stacks excepted).  Fake tensors live on the CPU, so every
kernel wrapper takes its plain version (``kernels/ops.py``): the peak is
the plain route's (``"route": "plain"``), whose temporaries (a
materialised V, u_hat) exceed the CUDA kernels'.  The counts are per rank
and come from fake tensors: no time is measured.  Each cell's peak is
printed against one card's memory (``DEVICE_BYTES``, the same on every
host).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --preset test

``--preset test`` runs the smoke configs at sequence 64 over a (pod=2,
data=2, model=2) mesh of 8 fake ranks; its records' file names end in
``__test``.  A record in ``--out`` is reused (and printed as cached)
only if it was made for the same mesh and preset; ``--force`` makes
every cell anew.  ``--telemetry-dir DIR`` streams
one ``kind="dryrun_cell"`` event per cell (after a ``run_meta`` header)
in the telemetry schema; ``--trace-dir DIR`` records a ``compile_cell``
span per cell around its ``place`` and ``step`` spans, and with
``--metrics-every`` metric registry snapshots.

Importing this module starts no process group and reads or sets no
environment variable.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.config import (CELLS, ModelConfig, OptimizerConfig,
                                ShapeCell, applicable_cells)
from repro_torch.configs import (ASSIGNED, get_config, get_smoke_config,
                                 input_specs)
from repro_torch.core.build import build_optimizer
from repro_torch.core.types import P, tree_nbytes
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
from repro_torch.launch.step_cost import StepCost
from repro_torch.models.model_zoo import build_model
from repro_torch.telemetry.trace import NULL_TRACER
from repro_torch.train.steps import TrainState, build_train_step

DEFAULT_OUT = Path("experiments/dryrun_torch")
# the memory a rank's peak is held to: an NVIDIA H100 80GB HBM3's stated
# 80 GB, on every host, so that a record does not depend on where it was
# made
DEVICE_BYTES = 80 * 10**9
TEST_MESH = ((2, 2, 2), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Optimizer and microbatching of train cells (the JAX package's)
# ---------------------------------------------------------------------------

def dryrun_opt_config(arch: str) -> OptimizerConfig:
    """The paper's technique at production settings.  b1 = 0 for the 1T
    model: its full first moment alone would be 2-4 TB (paper Table 2's
    beta1 = 0 row is this regime)."""
    b1 = 0.0 if arch.startswith("kimi") else 0.9
    return OptimizerConfig(
        name="adapprox", lr=3e-4, schedule="cosine", warmup_steps=1000,
        total_steps=100_000, min_lr=0.0, b1=b1, b2=0.999, weight_decay=0.1,
        k=64, rank_mode="static", oversample=5, n_iter=5,
        min_dim_factor=128, implicit=True)


def dryrun_optimizer(arch: str):
    return build_optimizer(dryrun_opt_config(arch))


# Train cells of these archs take pure FSDP (ZeRO-3 over every mesh axis):
# the JAX package's hill-climbed choice; deepseek-67b and qwen3-14b keep
# the TP x FSDP rules.
FSDP_TRAIN_ARCHS = {"qwen2-7b", "minitron-4b", "llava-next-mistral-7b",
                    "mamba2-370m", "zamba2-2.7b", "whisper-large-v3"}


def microbatches_for(arch: str, cell: str, mesh=None,
                     global_batch: int = 256) -> int:
    """Gradient-accumulation microbatches of a train cell; ``mesh`` (a
    ``DeviceMesh`` or ``{axis: size}``) caps them so that each still
    covers every data shard."""
    if cell != "train_4k":
        return 1
    if arch in FSDP_TRAIN_ARCHS:
        return 1          # batch == rank count: one sequence a rank
    mb = {"deepseek-67b": 16, "kimi-k2-1t-a32b": 16,
          "qwen3-14b": 8}.get(arch, 4)
    if mesh is not None:
        sizes = SH.mesh_axis_sizes(mesh)
        dp = sizes.get("pod", 1) * sizes.get("data", 1)
        mb = min(mb, max(global_batch // dp, 1))
    return mb


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One (arch, shape cell) on a mesh, ready to place and run, once: its
    optimizer keeps tensors made under the fake mode that measures it
    (the sketch's bucket indices), which no other fake mode may use."""
    arch: str
    name: str
    cfg: ModelConfig
    cell: ShapeCell
    mesh: Any
    model: Any
    opt: Any = None          # train cells
    microbatches: int = 1

    @property
    def kind(self) -> str:
        return self.cell.kind

    @property
    def long_context(self) -> bool:
        return self.name == "long_500k"


def build_cell(arch: str, cell_name: str, mesh, smoke: bool = False) -> Cell:
    """The config, model and optimizer of a cell on ``mesh`` (no tensor
    yet): the full-size config (the smoke one at sequence 64 and batch
    max(4, ranks / 2) with ``smoke``), pure FSDP for the train cells of
    ``FSDP_TRAIN_ARCHS``, the MoE decode path for MoE decode cells."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cell = CELLS[cell_name]
    if not smoke and cell.kind == "train" and arch in FSDP_TRAIN_ARCHS:
        cfg = dataclasses.replace(cfg, parallel_strategy="fsdp")
    if smoke:
        cell = dataclasses.replace(cell, seq_len=64, global_batch=max(
            4, mesh.size() // 2))
    model = build_model(cfg, mesh)
    if cell.kind == "decode" and cfg.moe is not None:
        model.moe_mode = "decode"
    model.constrain = SH.make_act_constrainer(
        mesh, cell.kind, long_context=(cell_name == "long_500k"),
        all_axes_batch=(cfg.parallel_strategy == "fsdp"))
    if cell.kind != "train":
        return Cell(arch, cell_name, cfg, cell, mesh, model)
    mb = 1 if smoke else microbatches_for(arch, cell_name, mesh,
                                          cell.global_batch)
    return Cell(arch, cell_name, cfg, cell, mesh, model,
                opt=dryrun_optimizer(arch), microbatches=mb)


def batch_shardings(c: Cell, batch: dict) -> dict:
    """How the cell's batch splits: ``sharding.batch_shardings``, but a
    decode step's tokens over the dp axes only, and not at all at long
    context (the cache's batch is not split there), as in JAX."""
    if c.kind != "decode":
        return SH.batch_shardings(c.cfg, c.kind, c.mesh, batch)
    dp = SH.dp_axes(c.mesh)
    spec = P(dp if dp and not c.long_context else None, None)
    return {k: SH.NamedSharding(c.mesh, SH.sanitize_spec(
        spec, tuple(x.shape), c.mesh)) for k, x in batch.items()}


def _batch_block_bytes(c: Cell, batch: dict) -> int:
    shard = batch_shardings(c, batch)
    return sum(tree_nbytes(SH.local_block(x, shard[k]))
               for k, x in batch.items())


def place_inputs(c: Cell) -> dict:
    """The cell's inputs as a run holds them, on fake tensors (call under
    a ``FakeTensorMode``): ``state`` (train) or ``params`` and ``cache``
    placed by the port's specs, the global ``batch`` every rank is handed,
    their shardings, and the per-rank bytes of each."""
    gen = torch.Generator().manual_seed(0)
    params = tree.flatten(c.model.init(gen))
    batch = input_specs(c.cfg, c.cell, device="cpu")
    out = {"batch": batch, "batch_bytes": _batch_block_bytes(c, batch)}
    with torch.no_grad():
        if c.kind == "train":
            sshard, bshard = SH.train_shardings(
                c.model, c.opt, c.mesh, batch, params=params)
            state = SH.place_state(TrainState.create(params, c.opt),
                                   sshard)
            out.update(state=state, state_shardings=sshard,
                       batch_shardings=bshard,
                       param_bytes=tree_nbytes(state.params),
                       opt_state_bytes=tree_nbytes(state.opt_state),
                       cache_bytes=0)
            return out
        pshard = SH.param_shardings(c.model, c.mesh, c.kind, params=params)
        placed = {k: SH.place(v, pshard[k]) for k, v in params.items()}
        cache = c.model.init_cache(c.cell.global_batch, c.cell.seq_len,
                                   device="cpu")
        cshard = SH.cache_shardings(c.cfg, c.mesh, cache, c.long_context)
        cache = SH.place_tree(cache, cshard)
    out.update(params=placed, cache=cache, cache_shardings=cshard,
               param_bytes=tree_nbytes(placed), opt_state_bytes=0,
               cache_bytes=tree_nbytes(cache))
    return out


def run_step(c: Cell, inputs: dict):
    """One step of the cell on its placed inputs, as rank 0 runs it (see
    the module docstring); returns the step's outputs."""
    if c.kind == "train":
        step = build_train_step(c.model, c.opt, microbatches=c.microbatches,
                                state_shardings=inputs["state_shardings"],
                                batch_shardings=inputs["batch_shardings"])
        return step(inputs["state"], inputs["batch"])
    local = set(getattr(c.model, "mesh_local_leaves", tuple)())
    dp = SH.dp_axes(c.mesh)
    params = SH.model_params(inputs["params"], local)
    with torch.no_grad():
        cache = SH.gather_tree_except(inputs["cache"],
                                      inputs["cache_shardings"], dp)
        shard = batch_shardings(c, inputs["batch"])
        batch = {k: SH.local_block(x, shard[k])
                 for k, x in inputs["batch"].items()}
    params = tree.unflatten(params)
    if c.kind == "decode":
        return c.model.decode_step(params, cache, batch["tokens"])
    if "embeds" in batch:
        return c.model.prefill(params, batch["tokens"], cache,
                               embeds=batch["embeds"])
    return c.model.prefill(params, batch["tokens"], cache)


def at_step(state, n: int):
    """``state`` (a ``TrainState``, an optimizer state) with every step
    counter (each dataclass's int ``step`` / ``count``) set to ``n``, its
    tensors as they are: a state at the start of step ``n + 1``.  On fake
    tensors only the counters have values, and they pick the step's path
    (refresh or fold)."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        over = {}
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            if f.name in ("step", "count") and isinstance(v, int):
                over[f.name] = n
            elif isinstance(v, (tuple, list, dict)) or (
                    dataclasses.is_dataclass(v) and not isinstance(v, type)):
                over[f.name] = at_step(v, n)
        return dataclasses.replace(state, **over)
    if isinstance(state, dict):
        return {k: at_step(v, n) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return state
    if isinstance(state, (tuple, list)):
        return type(state)(at_step(v, n) for v in state)
    return state


def measure(c: Cell, tracer=None, start_step: int = 0) -> dict:
    """Place the cell's inputs and run its step on fake tensors under the
    cost counter: the per-rank bytes of what was placed, the step's counts
    and the seconds each part took.  A train cell's state starts at
    ``start_step`` (:func:`at_step`): 1 makes a cadence's fold step of
    step 2.  A refresh step of the paper's adaptive rank (``rank_mode``
    "paper") reads xi to the host, which fake tensors cannot: the dry
    run's optimizer is static-rank, as JAX's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tr = tracer if tracer is not None else NULL_TRACER
    with FakeTensorMode():
        t0 = time.perf_counter()
        with tr.span("place"):
            inputs = place_inputs(c)
            if start_step:
                inputs["state"] = at_step(inputs["state"], start_step)
        t1 = time.perf_counter()
        rec = {k: inputs[k] for k in ("param_bytes", "opt_state_bytes",
                                      "batch_bytes", "cache_bytes")}
        cost = StepCost()
        cost.track(inputs.get("state"), inputs.get("params"),
                   inputs.get("cache"), inputs["batch"])
        with tr.span("step"), cost:
            run_step(c, inputs)
        t2 = time.perf_counter()
    return {**rec, **cost.summary(), "place_s": t1 - t0, "step_s": t2 - t1}


def record_path(out_dir: Path, arch: str, cell_name: str, mesh_tag: str,
                smoke: bool = False) -> Path:
    """A cell's record file in ``out_dir``; the test preset's end in
    ``__test``."""
    tail = "__test" if smoke else ""
    return out_dir / f"{arch}__{cell_name}__{mesh_tag}{tail}.json"


def cached_record(path: Path, mesh, smoke: bool = False) -> Optional[dict]:
    """The record at ``path``, marked ``"cached"``, if there is one made
    for ``mesh`` (its rank count and axis sizes) and for this preset;
    else None, and the cell is made anew."""
    if not path.exists():
        return None
    rec = json.loads(path.read_text())
    want = (mesh.size(), SH.mesh_axis_sizes(mesh), "test" if smoke else None)
    if (rec.get("devices"), rec.get("mesh_shape"), rec.get("preset")) != want:
        return None
    return dict(rec, cached=True)


def run_cell(arch: str, cell_name: str, multi_pod: bool, out_dir: Path,
             smoke: bool = False, force: bool = False, mesh_override=None,
             tracer=None) -> dict:
    """One cell's record (written to ``out_dir``, or, unless ``force``,
    read from it where :func:`cached_record` finds one)."""
    mesh_tag = "multipod" if multi_pod else "pod"
    out_path = record_path(out_dir, arch, cell_name, mesh_tag, smoke)
    mesh = mesh_override or make_production_mesh(multi_pod=multi_pod,
                                                 fake=True)
    cached = None if force else cached_record(out_path, mesh, smoke)
    if cached is not None:
        return cached
    tr = tracer if tracer is not None else NULL_TRACER
    with tr.span("compile_cell", arch=arch, cell=cell_name, mesh=mesh_tag):
        c = build_cell(arch, cell_name, mesh, smoke=smoke)
        m = measure(c, tracer=tr)
    stored = (m["param_bytes"] + m["opt_state_bytes"] + m["batch_bytes"]
              + m["cache_bytes"])
    rec = {
        "arch": arch, "cell": cell_name, "mesh": mesh_tag,
        "preset": "test" if smoke else None,
        "devices": mesh.size(), "mesh_shape": SH.mesh_axis_sizes(mesh),
        "seq_len": c.cell.seq_len, "global_batch": c.cell.global_batch,
        "kind": c.kind, "microbatches": c.microbatches,
        "parallel_strategy": c.cfg.parallel_strategy,
        "params": c.cfg.param_count(),
        "active_params": c.cfg.active_param_count(),
        "route": "plain",
        "flops": float(m["flops"]), "bytes_accessed": float(
            m["bytes_accessed"]),
        "collectives": m["collectives"],
        "collective_bytes": m["collective_bytes"],
        "param_bytes": m["param_bytes"],
        "opt_state_bytes": m["opt_state_bytes"],
        "batch_bytes": m["batch_bytes"], "cache_bytes": m["cache_bytes"],
        "memory": {"stored_bytes": stored, "peak_bytes": m["peak_bytes"],
                   "peak_op": m["peak_op"], "device_bytes": DEVICE_BYTES,
                   "fits": m["peak_bytes"] <= DEVICE_BYTES},
        "place_s": round(m["place_s"], 2), "step_s": round(m["step_s"], 2),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


SKIPS = {}  # (arch, cell) -> reason, filled by plan()


def plan(archs, cells):
    """The (arch, cell) pairs to run, in order; a cell an arch does not
    take goes to ``SKIPS`` with its reason."""
    for arch in archs:
        ok = applicable_cells(get_config(arch))
        for cell in cells:
            if cell not in ok:
                SKIPS[(arch, cell)] = ("full-attention arch: long_500k "
                                       "needs sub-quadratic attention")
                continue
            yield arch, cell


def quiet_redistribute() -> None:
    """Silence DTensor's warning, at every gather over two mesh axes, that
    it runs two all-gathers: the dry run counts them, the warning adds
    nothing (for the command-line entry points)."""
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def _gib(n: float) -> str:
    return f"{n / 2**30:.2f}GiB"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry run of the port over fake tensors and a fake "
                    "256 / 512-rank process group")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--all", action="store_true",
                    help="every arch of ASSIGNED and every cell (what "
                         "--arch all --cell all give)")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multi", "both"])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--preset", default=None, choices=[None, "test"])
    ap.add_argument("--telemetry-dir", default=None,
                    help="emit one dryrun_cell JSONL event per cell "
                         "(repro_torch.telemetry schema)")
    ap.add_argument("--trace-dir", default=None,
                    help="record per-cell compile_cell / place / step spans "
                         "as kind=\"span\" JSONL; may equal "
                         "--telemetry-dir to share one stream")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="with --trace-dir: a kind=\"metric\" registry "
                         "snapshot every N cells (0 = only the final one)")
    args = ap.parse_args(argv)
    if args.all:
        args.arch = args.cell = "all"
    quiet_redistribute()

    out_dir = Path(args.out)
    smoke = args.preset == "test"
    sink = None
    if args.telemetry_dir:
        from repro_torch.telemetry import SinkConfig, TelemetrySink
        sink = TelemetrySink(SinkConfig(directory=args.telemetry_dir))
        sink.emit({"kind": "run_meta", "source": "launch.dryrun",
                   "argv": list(argv) if argv is not None else sys.argv[1:]})
    tracer = trace_sink = reg = None   # trace_sink: one this run owns
    run_t0 = time.time()
    if args.trace_dir:
        from repro_torch.telemetry import (MetricsRegistry, SinkConfig,
                                           TelemetrySink, Tracer)
        reg = MetricsRegistry()
        if sink is not None and args.trace_dir == args.telemetry_dir:
            span_sink = sink
        else:
            trace_sink = span_sink = TelemetrySink(
                SinkConfig(directory=args.trace_dir))
        tracer = Tracer(sink=span_sink, registry=reg)

    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    cells = list(CELLS) if args.cell == "all" else args.cell.split(",")
    meshes = {"pod": [False], "multi": [True], "both": [False, True]}[
        args.mesh]
    failures = []
    done = 0
    try:
        mesh_override = make_fake_mesh(*TEST_MESH) if smoke else None
        for arch, cell in plan(archs, cells):
            for mp in meshes:
                tag = f"{arch} x {cell} x {'multipod' if mp else 'pod'}"
                try:
                    rec = run_cell(arch, cell, mp, out_dir, smoke=smoke,
                                   force=args.force,
                                   mesh_override=mesh_override,
                                   tracer=tracer)
                except Exception as e:  # noqa: BLE001 (report, go on)
                    failures.append((tag, e))
                    traceback.print_exc()
                    print(f"FAIL {tag}: {e}", flush=True)
                    continue
                done += 1
                secs = rec["place_s"] + rec["step_s"]
                if reg is not None:
                    reg.counter("dryrun_cells_total",
                                help="dry-run cells run").inc(
                                    1, cell=rec["cell"], mesh=rec["mesh"])
                    reg.histogram("dryrun_cell_seconds",
                                  help="per-cell seconds on fake "
                                       "tensors").observe(float(secs))
                    if args.metrics_every > 0 and \
                            done % args.metrics_every == 0:
                        (trace_sink or sink).emit(reg.snapshot(
                            t_s=time.time() - run_t0))
                mem = rec["memory"]
                if sink is not None:
                    sink.emit({
                        "kind": "dryrun_cell", "arch": rec["arch"],
                        "cell": rec["cell"], "mesh": rec["mesh"],
                        "devices": rec["devices"],
                        "flops": float(rec["flops"]),
                        "bytes_accessed": float(rec["bytes_accessed"]),
                        "peak_bytes": float(mem["peak_bytes"]),
                        "collective_bytes": float(rec["collective_bytes"]),
                        "params": float(rec["params"])})
                fits = ("fits" if mem["peak_bytes"] <= DEVICE_BYTES
                        else "DOES NOT FIT")
                note = ", cached" if rec.get("cached") else ""
                print(f"OK   {tag}: flops/rank={rec['flops']:.3g} "
                      f"coll={rec['collective_bytes']:.3g}B "
                      f"stored={_gib(mem['stored_bytes'])} "
                      f"peak={_gib(mem['peak_bytes'])} of "
                      f"{DEVICE_BYTES / 1e9:.0f} GB: {fits} "
                      f"({secs:.1f} s{note})", flush=True)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    if tracer is not None:
        final_sink = trace_sink if trace_sink is not None else sink
        if final_sink is not None:
            final_sink.emit(reg.snapshot(t_s=time.time() - run_t0))
        tracer.flush()
        (Path(args.trace_dir) / "metrics.prom").write_text(reg.render())
    if sink is not None:
        sink.close()
        print(f"telemetry: {len(sink.paths())} event file(s) under "
              f"{args.telemetry_dir}")
    if trace_sink is not None:
        trace_sink.close()
        print(f"trace: {len(trace_sink.paths())} event file(s) under "
              f"{args.trace_dir}")
    for (a, c), why in SKIPS.items():
        if a in archs and c in cells:
            print(f"SKIP {a} x {c}: {why}")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        sys.exit(1)
    print(f"\nall dry-run cells compiled ({time.time() - run_t0:.1f} s)")


if __name__ == "__main__":
    main()
