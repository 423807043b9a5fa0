"""Batched serving example on the PyTorch port: wave vs continuous on a
mixed workload (the port's counterpart of ``examples/serve_batched.py``).

Runs the SAME mixed-length request set (short and long prompts, short
and long generation budgets: the shape where lock-step waves suffer
head-of-line blocking) through both schedulers at equal slot count and
prints the per-request p99 latency gap.  The continuous engine recycles
a slot the step its request finishes and interleaves chunked prefill
with decode over the paged KV cache, so short requests stop paying for
long ones.

    PYTHONPATH=src python examples/torch/serve_batched.py
    PYTHONPATH=src python examples/torch/serve_batched.py --device cpu

It runs on the GPU; ``--device cpu`` is the only way onto the CPU, and
without a GPU and without it the script raises.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import (ContinuousConfig, ContinuousEngine, Engine,
                               Request, ServeConfig)

SLOTS = 4
CACHE_LEN = 128


def make_requests(n=12, seed=0):
    """Mixed prompt lengths (5..40) and budgets (short tail + a few
    long): uid order is arrival order."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(5, 41))
        mnew = int(rng.integers(48, 72)) if rng.random() < 0.25 \
            else int(rng.integers(4, 12))
        reqs.append(Request(
            uid=i, prompt=rng.integers(0, 512, size=plen).astype(np.int32),
            max_new_tokens=mnew))
    return reqs


def clone(reqs):
    return [Request(uid=r.uid, prompt=r.prompt.copy(),
                    max_new_tokens=r.max_new_tokens) for r in reqs]


def p99_latency(reqs):
    lat = [r.done_s - r.arrival_s for r in reqs]
    return float(np.percentile(np.asarray(lat), 99))


def main(argv=None) -> dict:
    """Serve and print; returns ``{"wave", "continuous"}`` (each the
    engine and its timed requests) and ``"wave_s"`` / ``"continuous_s"``
    (wall seconds of the timed runs)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config("gpt2-117m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    wave = Engine(model, params,
                  ServeConfig(slots=SLOTS, cache_len=CACHE_LEN))
    cont = ContinuousEngine(model, params, ContinuousConfig(
        slots=SLOTS, cache_len=CACHE_LEN, block_size=16, prefill_chunk=32))

    # warm both engines so the timing below measures scheduling, not the
    # first calls' allocations and library set-up
    wave.run(clone(make_requests()))
    cont.run(clone(make_requests()))

    reqs = make_requests(seed=7)
    # modest open-loop arrival stream so latency includes queueing
    arrivals = np.cumsum(np.full(len(reqs), 0.02)).tolist()

    wave_reqs = clone(reqs)
    t0 = time.perf_counter()
    wave.run(wave_reqs, arrivals=list(arrivals))
    wave_s = time.perf_counter() - t0

    cont_reqs = clone(reqs)
    t0 = time.perf_counter()
    cont.run(cont_reqs, arrivals=list(arrivals))
    cont_s = time.perf_counter() - t0

    wp99, cp99 = p99_latency(wave_reqs), p99_latency(cont_reqs)
    print(f"{len(reqs)} mixed requests "
          f"(prompts 5..40 tokens, budgets 4..72), {SLOTS} slots")
    print(f"  wave:       {wave_s:.2f}s wall, p99 latency {wp99 * 1e3:.0f}ms")
    print(f"  continuous: {cont_s:.2f}s wall, p99 latency {cp99 * 1e3:.0f}ms")
    print(f"  p99 gap: {wp99 / cp99:.2f}x in favor of continuous")
    for r in cont_reqs[:3]:
        print(f"  req {r.uid}: prompt {len(r.prompt)} -> "
              f"{len(r.out_tokens)} tokens {r.out_tokens[:8]}")
    return {"wave": (wave, wave_reqs), "continuous": (cont, cont_reqs),
            "wave_s": wave_s, "continuous_s": cont_s}


if __name__ == "__main__":
    main()
