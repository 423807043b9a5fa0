"""Chaos smoke driver: a tiny guarded training run under a deterministic
NaN / Inf gradient burst, asserting the resilience layer's contract from
the outside (the port's counterpart of the JAX package's
``tools/chaos.py``: the same flags, plan, model, optimizer and checks).

    PYTHONPATH=src python -m repro_torch.tools.chaos --out /tmp/chaos-events \
        --steps 30 --nan-steps 7,8,19 [--device cpu]

It runs on the GPU unless ``--device cpu`` is given.  What it checks
(exit 0 only if ALL hold; 1 if one fails; 2 for an empty plan or a fault
at or past the last step):

  * the guard skipped EXACTLY the injected steps -- ``skipped`` equals the
    schedule length and ``last_skip`` equals its max;
  * every parameter is finite at the end of the run;
  * the loss recovered -- the final logged loss is finite and below the
    first;
  * the sink emitted at least one ``kind="fault"`` event, and the whole
    stream passes the telemetry schema (``telemetry.validate_dir``).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

from repro_torch.config import OptimizerConfig, TelemetryConfig
from repro_torch.configs.archs import get_smoke_config
from repro_torch.core.build import build_optimizer
from repro_torch.core.types import chain
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.resilience import FaultPlan, inject_faults
from repro_torch.telemetry import (TelemetryRuntime, chain_guard_state,
                                   validate_dir)
from repro_torch.train.train_loop import LoopConfig, train


def parse_steps(spec: str) -> tuple:
    return tuple(int(s) for s in spec.split(",") if s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="telemetry JSONL directory")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--nan-steps", default="7,8,19",
                    help="comma-separated 1-based steps to poison with NaN")
    ap.add_argument("--inf-steps", default="",
                    help="comma-separated 1-based steps to poison with Inf")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)

    plan = FaultPlan(nan_steps=parse_steps(args.nan_steps),
                     inf_steps=parse_steps(args.inf_steps))
    if not plan.fault_steps:
        print("chaos: empty fault plan — nothing to test", file=sys.stderr)
        return 2
    if max(plan.fault_steps) >= args.steps:
        print(f"chaos: fault step {max(plan.fault_steps)} must land before "
              f"the last step ({args.steps}) so the loss can recover",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    cfg = get_smoke_config("gpt2-117m", vocab=64, max_seq_len=32)
    model = build_model(cfg)
    # guards=True wraps the whole chain in the skip-step guard; the
    # injector sits in front of it, poisoning grads the way a real
    # overflow would arrive
    opt = chain(inject_faults(plan), build_optimizer(OptimizerConfig(
        name="adapprox", schedule="constant", lr=args.lr, weight_decay=0.1,
        k=4, rank_mode="static", min_dim_factor=32, implicit=False,
        telemetry=True, guards=True)))
    runtime = TelemetryRuntime(TelemetryConfig(
        enabled=True, dir=args.out, emit_every=5))
    data_cfg = DataConfig(vocab=64, seq_len=32, global_batch=4, seed=0)

    try:
        state, hist = train(model, opt, data_cfg,
                            LoopConfig(total_steps=args.steps, log_every=5),
                            device=device, telemetry=runtime)
    finally:
        runtime.close()

    failures = []
    n_injected = len(plan.fault_steps)
    gs = chain_guard_state(state.opt_state)
    if gs is None:
        failures.append("no chain guard state in the optimizer state")
        skipped = last_skip = -1
    else:
        skipped, last_skip = int(gs.skipped), int(gs.last_skip)
        if skipped != n_injected:
            failures.append(f"guard skipped {skipped} steps, injected "
                            f"{n_injected} ({plan.fault_steps})")
        if last_skip != max(plan.fault_steps):
            failures.append(f"last skip at step {last_skip}, last injection "
                            f"at {max(plan.fault_steps)}")

    bad = [k for k, p in state.params.items()
           if not bool(torch.isfinite(p).all())]
    if bad:
        failures.append(f"non-finite params after the run: {bad}")

    first, last = hist[0]["loss"], hist[-1]["loss"]
    if not (math.isfinite(last) and last < first):
        failures.append(f"loss did not recover: first {first}, last {last}")

    try:
        ok_events = validate_dir(args.out)
    except ValueError as e:
        ok_events = 0
        failures.append(f"schema-invalid event stream: {e}")
    n_fault = sum(
        1 for f in sorted(Path(args.out).glob("events-*.jsonl"))
        for line in f.read_text().splitlines()
        if json.loads(line).get("kind") == "fault")
    if n_fault == 0:
        failures.append("no kind=fault events in the stream")

    print(f"chaos: {args.steps} steps on {device.type}, injected "
          f"{n_injected} ({plan.fault_steps}), guard skipped {skipped} "
          f"(last at {last_skip}); loss {first:.3f} -> {last:.3f}; "
          f"{n_fault} fault events / {ok_events} valid lines in {args.out}")
    if failures:
        for f in failures:
            print(f"chaos: FAIL: {f}", file=sys.stderr)
        return 1
    print("chaos: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
