"""Quickstart: train a tiny LM with Adapprox on the PyTorch port, traced
end to end (the port's counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --steps 60 \
        --trace-dir /tmp/quickstart-trace
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

It runs on the GPU; ``--device cpu`` is the only way onto the CPU, and
without a GPU and without it the script raises.  Every step runs under
host-side spans (``repro_torch.telemetry.trace``); at exit the script
reconstructs where step time went (data wait vs dispatch vs device sync)
straight from the recorded JSONL, the same events ``python -m
repro_torch.tools.traceview`` analyses.
"""
import argparse
import tempfile

import torch

from repro_torch import tree
from repro_torch.config import OptimizerConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import apply_updates, build_optimizer, rank_metrics
from repro_torch.data import DataConfig, make_source
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.telemetry import (SinkConfig, TelemetrySink, Tracer,
                                   format_breakdown, load_events,
                                   step_breakdown)


def main(argv=None) -> dict:
    """Train and print; returns ``{"losses", "rank_metrics", "k_max",
    "trace_dir"}`` (the losses and the final rank metrics as floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--trace-dir", default=None,
                    help="record span events here (default: a temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    STEPS, BATCH, SEQ, VOCAB, K_MAX = args.steps, 8, 64, 256, 16

    cfg = get_smoke_config("gpt2-117m", vocab=VOCAB, max_seq_len=SEQ)
    model = build_model(cfg)
    params = tree.flatten(
        model.init(torch.Generator(device=device).manual_seed(0)))
    for p in params.values():
        p.requires_grad_(True)

    # Adapprox: factored second moment with adaptive rank (paper Algorithm
    # 3).  build_optimizer lowers the declarative config to the documented
    # chain scale_by_adapprox -> add_decayed_weights -> scale_by_schedule
    # -> scale(-1).
    opt = build_optimizer(OptimizerConfig(
        name="adapprox", lr=3e-3, schedule="cosine", warmup_steps=10,
        total_steps=STEPS, min_lr=0.0, b1=0.9, weight_decay=0.1,
        k=1, k_max=K_MAX, rank_mode="paper", xi_thresh=0.01, delta_s=10,
        min_dim_factor=32, implicit=False))
    opt_state = opt.init(params)
    source = make_source(DataConfig(vocab=VOCAB, seq_len=SEQ,
                                    global_batch=BATCH))

    trace_dir = args.trace_dir or tempfile.mkdtemp(
        prefix="quickstart-trace-")
    sink = TelemetrySink(SinkConfig(directory=trace_dir))
    tracer = Tracer(sink=sink)

    def step(params, opt_state, batch):
        loss, _ = model.loss(tree.unflatten(params), batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            updates, opt_state = opt.update(dict(zip(params, grads)),
                                            opt_state, params)
            apply_updates(params, updates)
        return params, opt_state, loss.detach()

    losses = []
    for t in range(STEPS):
        with tracer.span("train_step", step=t + 1):
            with tracer.span("data_wait"):
                batch = {"tokens": torch.from_numpy(
                    source.batch_at(t)["tokens"]).to(device)}
            with tracer.span("step_dispatch"):
                params, opt_state, loss = step(params, opt_state, batch)
            with tracer.span("device_sync"):
                if device.type == "cuda":
                    torch.cuda.synchronize()
        losses.append(loss)
        if (t + 1) % 25 == 0 or t == 0:
            m = rank_metrics(opt_state)
            print(f"step {t + 1:4d}  loss {float(loss):.4f}  "
                  f"mean_rank {float(m['adapprox/mean_rank']):.1f}  "
                  f"mean_xi {float(m['adapprox/mean_xi']):.4f}")

    tracer.flush()
    sink.close()
    print("done — Adapprox trained a model with a low-rank second moment.")
    print()
    print(format_breakdown(step_breakdown(load_events(trace_dir))))
    print(f"\nspan events in {trace_dir} — inspect with "
          f"PYTHONPATH=src python -m repro_torch.tools.traceview {trace_dir}")
    return {"losses": torch.stack(losses).tolist(),
            "rank_metrics": {k: float(v)
                             for k, v in rank_metrics(opt_state).items()},
            "k_max": K_MAX, "trace_dir": trace_dir}


if __name__ == "__main__":
    main()
