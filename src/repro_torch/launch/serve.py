"""Serving CLI of the PyTorch port: batched greedy generation, wave or
continuous.

    # wave (lock-step) baseline
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --smoke --requests 6 --max-new 16 --device cpu

    # continuous batching over the paged KV cache, with telemetry
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-117m \
        --smoke --continuous --block-size 16 --slots 4 \
        --telemetry-dir /tmp/serve --device cpu

Flags and defaults are those of ``python -m repro.launch.serve``, plus
``--device`` (default ``cuda``; without a GPU it raises unless ``--device
cpu`` is given).  The model is the arch's seed-0 init on the device, or the
caller's ``params``.  The summary line is the JAX launcher's.
"""
from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.archs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import (ContinuousConfig, ContinuousEngine, Engine,
                               Request, ServeConfig)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching + paged KV cache (instead "
                         "of the lock-step wave scheduler)")
    ap.add_argument("--paged", action="store_true",
                    help="alias for --continuous (the paged cache only "
                         "exists under the continuous scheduler)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV block size (tokens) for the paged cache")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size in blocks (default: full span "
                         "for every slot)")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="max prompt tokens prefilled per engine step")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the admission queue (0 = unbounded); "
                         "arrivals past it are load-shed")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop decoding a sequence at this token id")
    ap.add_argument("--seed", type=int, default=0,
                    help="prompt RNG seed")
    ap.add_argument("--telemetry-dir", default=None,
                    help="stream kind=\"serve\" JSONL events here")
    ap.add_argument("--trace-dir", default=None,
                    help="record per-request span waterfalls "
                         "(queued/admitted/prefill/decode) as "
                         "kind=\"span\" JSONL for tools/traceview.py; "
                         "may equal --telemetry-dir to share one stream")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="with --trace-dir: emit a kind=\"metric\" "
                         "registry snapshot every N engine steps (waves "
                         "for the wave scheduler; 0 = only the "
                         "metrics.prom dump at exit)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None, *, params: Optional[dict] = None):
    """Run the CLI.  ``params`` (a nested dict of fp32 tensors on the
    device) replaces the seed-0 init, so a caller can serve the JAX
    package's init (``repro_torch.convert``).  Returns ``(engine,
    requests)``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0))

    sink = None
    if args.telemetry_dir is not None:
        from repro_torch.telemetry import SinkConfig, TelemetrySink
        sink = TelemetrySink(SinkConfig(directory=args.telemetry_dir))

    tracer = None
    trace_sink = None        # a sink this launcher owns (closed at exit)
    reg = None
    if args.trace_dir is not None:
        from repro_torch.telemetry import (MetricsRegistry, SinkConfig,
                                           TelemetrySink, Tracer)
        reg = MetricsRegistry()
        if sink is not None and args.trace_dir == args.telemetry_dir:
            span_sink = sink     # one directory, one stream
        else:
            trace_sink = span_sink = TelemetrySink(
                SinkConfig(directory=args.trace_dir))
        tracer = Tracer(sink=span_sink, registry=reg)
        if sink is None:
            sink = span_sink     # serve events join the span stream

    continuous = args.continuous or args.paged
    if continuous:
        engine = ContinuousEngine(model, params, ContinuousConfig(
            slots=args.slots, cache_len=args.cache_len,
            block_size=args.block_size, num_blocks=args.num_blocks,
            prefill_chunk=args.prefill_chunk, eos_id=args.eos_id,
            max_queue=args.max_queue), sink=sink, tracer=tracer)
    else:
        engine = Engine(model, params, ServeConfig(
            slots=args.slots, cache_len=args.cache_len,
            eos_id=args.eos_id), sink=sink, tracer=tracer)
    engine.metrics_every = args.metrics_every

    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=args.prompt_len)
                    .astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    if tracer is not None:
        tracer.flush()
    if sink is not None:
        sink.flush()
        sink.close()
    if trace_sink is not None and trace_sink is not sink:
        trace_sink.close()
    if reg is not None:
        (Path(args.trace_dir) / "metrics.prom").write_text(reg.render())
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    ttfts = [r.first_token_s - r.arrival_s for r in reqs
             if r.first_token_s is not None]
    sched = (f"{engine.steps} steps" if continuous
             else f"{engine.waves} waves")
    print(f"{len(reqs)} requests ({'continuous' if continuous else 'wave'},"
          f" {sched}), {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s), "
          f"mean ttft {statistics.mean(ttfts) * 1e3:.1f}ms"
          if ttfts else f"{len(reqs)} requests, no tokens emitted")
    for r in reqs[:3]:
        print(f"  req {r.uid}: {r.out_tokens[:10]}")
    return engine, reqs


if __name__ == "__main__":
    main()
