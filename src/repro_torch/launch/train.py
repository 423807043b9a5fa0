"""Training CLI of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-117m \
        --seq 1024 --steps 200 --fused-update --refresh-every 5

Flags and defaults are those of ``python -m repro.launch.train``, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain versions of
the kernels, for parity tests).  ``--arch`` takes every arch the port
registers (``configs/archs.py``), the JAX package's 13: GPT-2 117M /
345M, the dense decoders (qwen2-7b, qwen3-14b, minitron-4b, deepseek-67b,
embed-heavy-256k), the MoE decoders (olmoe-1b-7b, kimi-k2-1t-a32b),
mamba2-370m, the hybrid zamba2-2.7b, llava-next-mistral-7b (text only:
the data stream makes no frontend ``embeds``) and whisper-large-v3, which
stops at its first loss for want of ``embeds`` (KeyError), as the JAX
launcher does; ``build_train_step`` takes batches that carry them
(``configs/base.py::make_batch``).  Without a GPU and without ``--device
cpu`` it raises.  As in the JAX launcher, ``--optimizer adapprox`` runs the mixed
groups by default (count-min sketch on embedding tables, Adapprox on
matrices, dense Adam on the rest); ``--no-mixed-groups`` puts Adapprox on
every matrix; ``--quantize-factors`` stores the Adapprox factors as int8
(``core/quantized.py``); ``--warm-start`` seeds each refresh's S-RSI from
the stored factors and ``--bucketed`` runs same-shape factored leaves as
one stacked call.  ``--optimizer adafactor`` / ``came`` / ``adamw`` run the
baselines, without the mixed groups unless ``--mixed-groups`` is given.
``--guards`` wraps the optimizer in the non-finite skip-step guard and arms
the xi watchdog (``--guard-skip-threshold``, ``--max-demotions``);
``--ckpt-dir`` saves a checkpoint every ``--ckpt-every`` steps, resumes
from the latest good one, and writes a preemption checkpoint on SIGTERM.

Telemetry, as in the JAX launcher: ``--telemetry-dir DIR`` streams the
optimizer's per-group snapshots (xi, rank, clip activation, refresh
counters; every ``--telemetry-every`` steps), guard faults and straggler
flags as schema-checked JSONL (``repro_torch.telemetry``);
``--auto-refresh`` adds the closed-loop controller, which retunes each
group's S-RSI cadence from the observed xi (it turns the optimizer's
telemetry and dynamic cadence on).  ``--trace-dir DIR`` records the
train-step and checkpoint spans for ``tools/traceview.py`` (the same
directory as ``--telemetry-dir`` shares one stream); ``--metrics-every N``
adds a registry snapshot every N steps, and ``<trace-dir>/metrics.prom``
is written at exit.

Sharded runs, as in the JAX launcher: ``--mesh 4,2`` builds a (data=4,
model=2) device mesh (three numbers add a leading ``pod`` axis, one
number is pure data parallelism) and derives the param / optimizer-state
/ batch placement through ``distributed.sharding.train_shardings``; the
optimizer state is split alongside the FSDP params (``--fsdp``, the
default), which is where Adapprox's factored state saves memory per
device.  One process per rank: ``torchrun --nproc-per-node 8 -m
repro_torch.launch.train --smoke --device cpu --mesh 4,2`` on the CPU
(gloo), one GPU a rank on the card (NCCL); ``--mesh 1,1`` starts its
own one-rank group (``launch/mesh.py``) and leaves it up for the
caller, which may gather the returned state's DTensor leaves.
"""
from __future__ import annotations

import argparse
import logging
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointConfig
from repro_torch.config import (OptimizerConfig, TelemetryConfig,
                                default_mixed_groups)
from repro_torch.configs.archs import get_config, get_smoke_config
from repro_torch.core.build import build_optimizer
from repro_torch.core.srsi import SketchSource
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.train.train_loop import LoopConfig, train

log = logging.getLogger(__name__)


def optimizer_config(name: str, steps: int, lr: float,
                     refresh_every: int = 1, warm_start: bool = False,
                     bucketed: bool = False, fused_update: bool = False,
                     quantize_factors: bool = False,
                     mixed_groups: bool = False, telemetry: bool = False,
                     dynamic_refresh: bool = False, sketch_width: int = 2048,
                     sketch_depth: int = 4,
                     embedding_min_rows: int = 1024, guards: bool = False,
                     guard_xi_trip: float = 0.75,
                     max_demotions: int = 0) -> OptimizerConfig:
    """The launcher's OptimizerConfig: cosine schedule derived from the run
    length and the paper's adaptive-rank settings, as in the JAX
    launcher.  With ``mixed_groups`` it is the partition of
    ``default_mixed_groups()``."""
    common = dict(name=name, lr=lr, schedule="cosine",
                  warmup_steps=max(steps // 20, 5), total_steps=steps,
                  min_lr=lr / 6, weight_decay=0.1,
                  groups=default_mixed_groups() if mixed_groups else (),
                  sketch_width=sketch_width, sketch_depth=sketch_depth,
                  embedding_min_rows=embedding_min_rows)
    if name == "adapprox":
        return OptimizerConfig(**common, rank_mode="paper", k=1, k_max=128,
                               xi_thresh=0.01, delta_s=10,
                               min_dim_factor=64, implicit=False,
                               refresh_every=refresh_every,
                               warm_start=warm_start, bucketed=bucketed,
                               fused_update=fused_update,
                               quantize_factors=quantize_factors,
                               telemetry=telemetry,
                               dynamic_refresh=dynamic_refresh,
                               guards=guards, guard_xi_trip=guard_xi_trip,
                               max_demotions=max_demotions)
    return OptimizerConfig(**common)


def parse_mesh(spec: str, device_type: str = "cuda"):
    """``"4,2"`` -> a (data=4, model=2) ``DeviceMesh``; one number -> pure
    DP ``(data,)``; three -> ``(pod, data, model)``.  Raises
    ``ValueError`` unless the process group has as many ranks."""
    from repro_torch.launch.mesh import make_mesh
    shape = tuple(int(s) for s in spec.split(",") if s)
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}.get(len(shape))
    if axes is None:
        raise ValueError(f"--mesh takes 1-3 comma-separated sizes, "
                         f"got {spec!r}")
    try:
        return make_mesh(shape, axes, device_type)
    except ValueError as e:
        raise ValueError(f"--mesh {spec} needs {math.prod(shape)} "
                         f"devices: {e}") from None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-117m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adapprox")
    ap.add_argument("--refresh-every", type=int, default=1,
                    help="adapprox: full S-RSI every T steps (fold between)")
    ap.add_argument("--warm-start", action="store_true")
    ap.add_argument("--bucketed", action="store_true")
    ap.add_argument("--fused-update", action="store_true",
                    help="adapprox: two-pass fused elementwise tail (CUDA "
                         "kernels in kernels/csrc/fused_update.cu)")
    ap.add_argument("--quantize-factors", action="store_true",
                    help="adapprox: int8 factors (core/quantized.py)")
    ap.add_argument("--mesh", default=None,
                    help="device mesh sizes, e.g. '4,2' = (data=4, "
                         "model=2), one rank a device; omit for the "
                         "single-device path")
    fsdp = ap.add_mutually_exclusive_group()
    fsdp.add_argument("--fsdp", dest="fsdp", action="store_true",
                      default=True,
                      help="split params and optimizer state over the data "
                           "axis (default)")
    fsdp.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    mg = ap.add_mutually_exclusive_group()
    mg.add_argument("--mixed-groups", dest="mixed_groups",
                    action="store_true", default=None,
                    help="partition chain: count-min sketch on "
                         "embedding tables, adapprox on matrices, dense "
                         "adam on the rest (default for adapprox)")
    mg.add_argument("--no-mixed-groups", dest="mixed_groups",
                    action="store_false")
    ap.add_argument("--sketch-width", type=int, default=2048,
                    help="count-min sketch buckets per hash (embeddings "
                         "group)")
    ap.add_argument("--sketch-depth", type=int, default=4,
                    help="count-min sketch hash functions (min over depth)")
    ap.add_argument("--embedding-min-rows", type=int, default=1024,
                    help=">= 2-D leaves with at least this many rows take "
                         "the sketch second moment")
    ap.add_argument("--telemetry-dir", default=None,
                    help="stream optimizer / guard / straggler telemetry "
                         "as JSONL events here")
    ap.add_argument("--telemetry-every", type=int, default=1,
                    help="emit optimizer events every N steps")
    ap.add_argument("--auto-refresh", action="store_true",
                    help="adapprox: the closed-loop controller retunes "
                         "refresh_every per group from the observed xi "
                         "(turns on telemetry and the dynamic cadence)")
    ap.add_argument("--guards", action="store_true",
                    help="adapprox: wrap the chain in the non-finite "
                         "skip-step guard and arm the per-leaf xi watchdog")
    ap.add_argument("--guard-skip-threshold", type=float, default=0.75,
                    help="xi level that counts as a factorization blow-up "
                         "(forces a full S-RSI refresh for that leaf)")
    ap.add_argument("--max-demotions", type=int, default=0,
                    help="consecutive xi trips before a leaf is demoted to "
                         "the exact dense second moment (0 = never)")
    ap.add_argument("--trace-dir", default=None,
                    help="record train-step and checkpoint spans here as "
                         "JSONL (tools/traceview.py); may equal "
                         "--telemetry-dir to share one stream")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="a metric registry snapshot every N steps (0 = "
                         "off); <trace-dir>/metrics.prom at exit")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=20)
    return ap.parse_args(argv)


def main(argv=None, *, params: Optional[dict] = None,
         sketch: Optional[SketchSource] = None):
    """Run the CLI.  ``params`` (a nested dict of fp32 tensors) replaces the
    random init and ``sketch`` the S-RSI sketch source, so a caller can
    start the port from the JAX package's init and draws.  Returns
    ``(final_state, history)``."""
    args = parse_args(argv)
    mixed = (args.optimizer == "adapprox" if args.mixed_groups is None
             else args.mixed_groups)
    device = resolve_device(args.device)
    mesh = parse_mesh(args.mesh, device.type) if args.mesh else None
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = (get_smoke_config(args.arch, max_seq_len=args.seq)
           if args.smoke else get_config(args.arch))
    model = build_model(cfg, mesh)
    telemetry_on = args.telemetry_dir is not None or args.auto_refresh
    opt = build_optimizer(optimizer_config(
        args.optimizer, args.steps, args.lr,
        refresh_every=args.refresh_every, warm_start=args.warm_start,
        bucketed=args.bucketed, fused_update=args.fused_update,
        quantize_factors=args.quantize_factors, mixed_groups=mixed,
        telemetry=telemetry_on, dynamic_refresh=args.auto_refresh,
        sketch_width=args.sketch_width, sketch_depth=args.sketch_depth,
        embedding_min_rows=args.embedding_min_rows, guards=args.guards,
        guard_xi_trip=args.guard_skip_threshold,
        max_demotions=args.max_demotions), sketch=sketch)
    runtime = None
    if telemetry_on:
        from repro_torch.telemetry import TelemetryRuntime
        runtime = TelemetryRuntime(TelemetryConfig(
            enabled=True, dir=args.telemetry_dir,
            emit_every=args.telemetry_every,
            auto_refresh=args.auto_refresh))
        log.info("telemetry on (dir=%s, auto_refresh=%s)",
                 args.telemetry_dir, args.auto_refresh)
    tracer = trace_sink = reg = None   # trace_sink: one this launcher owns
    if args.trace_dir is not None:
        from repro_torch.telemetry import (MetricsRegistry, SinkConfig,
                                           TelemetrySink, Tracer)
        reg = MetricsRegistry()
        if runtime is not None and args.trace_dir == args.telemetry_dir:
            span_sink = runtime.sink   # one directory, one stream
        else:
            trace_sink = span_sink = TelemetrySink(
                SinkConfig(directory=args.trace_dir))
        tracer = Tracer(sink=span_sink, registry=reg)
        log.info("tracing on (dir=%s, metrics_every=%d)",
                 args.trace_dir, args.metrics_every)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    state_shardings = batch_shardings = None
    if mesh is not None:
        from repro_torch.distributed import sharding as SH
        if params is None:     # the loop's own init, drawn here once
            params = model.init(torch.Generator(device=device).manual_seed(0))
        model.constrain = SH.make_act_constrainer(mesh, "train")
        state_shardings, batch_shardings = SH.train_shardings(
            model, opt, mesh, {"tokens": (args.batch, args.seq)},
            fsdp=args.fsdp, params=params)
        log.info("mesh %s, fsdp=%s, mixed_groups=%s",
                 SH.mesh_axis_sizes(mesh), args.fsdp, mixed)
    ckpt = (CheckpointConfig(directory=args.ckpt_dir,
                             save_every=args.ckpt_every)
            if args.ckpt_dir else None)
    try:
        state, history = train(
            model, opt, data_cfg,
            LoopConfig(total_steps=args.steps, log_every=args.log_every,
                       ckpt=ckpt),
            device=device, params=params, telemetry=runtime, tracer=tracer,
            metrics_every=args.metrics_every,
            install_signal_handler=ckpt is not None,
            state_shardings=state_shardings,
            batch_shardings=batch_shardings)
    finally:
        if runtime is not None:
            runtime.close()
        if tracer is not None:
            tracer.flush()
            if trace_sink is not None:
                trace_sink.close()
            prom = Path(args.trace_dir) / "metrics.prom"
            prom.write_text(reg.render())
            log.info("trace events and %s written under %s", prom.name,
                     args.trace_dir)
    if history:
        print(f"final loss: {history[-1]['loss']:.4f} "
              f"({history[-1]['step_time_s'] * 1e3:.0f} ms/step)")
    return state, history


if __name__ == "__main__":
    main()
