#!/usr/bin/env python3
"""S-RSI's refresh on one card, two checkouts of the port side by side,
each checkout in its own process, in the order base, change, change, base.

    python3 scripts/ab_refresh.py BASE_DIR [CHANGE_DIR]

BASE_DIR and CHANGE_DIR (default: this checkout) are checkouts of this
repository, each with its own ``chip_smoke.py``; each builds its kernels
into its own ``build/``.  Each run prints its card, then:

  * srsi: the wall time of one S-RSI call on the implicit operator, cold
    (5 power iterations) and warm (1, seeded with U), and on the formed V
    (the launcher's route), cold, at every factored leaf of the launcher's
    mixed groups of GPT-2 117M and Mamba2-370m, on random factors and
    gradients; the median of
    5 calls after 2 unmeasured ones, the device synchronized before and
    after each.  Then, at GPT-2's w_down and Mamba2's first stacked leaf,
    whether each matrix run alone equals its slice of the batched run,
    bitwise (the contract of ``core/srsi.py``);
  * ``chip_smoke.py``'s [train-mixed] (cold refreshes), [train-warm],
    [train-implicit], [train-kmax] and [train-mamba2]: 12 steps, refresh
    at 1, 6 and 11, the refresh-step times of steps 6 and 11, the
    fold-step median and the peak memory;

then one JSON line per run.  Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r'''
import dataclasses, json, statistics, sys, time
sys.path.insert(0, "."); sys.path.insert(0, "src")
import torch
import chip_smoke as C
from repro_torch.core import srsi as S
from repro_torch.kernels import cuda, fused_update, sketch_update
from repro_torch.kernels import srsi_matmul, ssd_chunk
from repro_torch.launch.train import optimizer_config
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
print(C.card_line(), flush=True)
t0 = time.monotonic()
cuda.build(fused_update.SOURCE, sketch_update.SOURCE, srsi_matmul.SOURCE,
           ssd_chunk.SOURCE)
res = {"build_s": time.monotonic() - t0, "srsi_s": {}, "alone_equal": {}}

C.phase("[srsi] one S-RSI call: implicit cold and warm, dense cold")
gen = torch.Generator(device=dev).manual_seed(0)
for arch in ("gpt2-117m", C.MAMBA):
    fact, _ = C.main_path_leaves(dev, mixed=True, arch=arch)
    checked = False
    for name, shape, r in fact:
        m, n = shape[-2:]
        p = max(0, min(5, min(m, n) - r))
        q = torch.rand(shape[:-1] + (r,), generator=gen, device=dev) * 1e-3
        u = torch.rand(shape[:-2] + (n, r), generator=gen, device=dev) * 1e-3
        g = torch.randn(shape, generator=gen, device=dev) * 1e-3
        v = S.make_implicit_v(q, u, g, 0.999)
        draw = torch.randn(shape[:-2] + (n, r + p), generator=gen,
                           device=dev)
        source = lambda want, _gen: draw
        vm = v.materialize()
        calls = {
            "implicit-cold": lambda: S.srsi_implicit(v, r, p, 5, source),
            "implicit-warm": lambda: S.srsi_implicit(v, r, p, 1, source,
                                                     u0=u),
            "dense-cold": lambda: S.srsi_dense(vm, r, p, 5, source)}
        for label, call in calls.items():
            times = []
            for i in range(7):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
            key = f"{arch}/{name}/{label}"
            res["srsi_s"][key] = statistics.median(times[2:])
            print(f"  {key} {tuple(shape)} r {r} p {p}: "
                  f"{res['srsi_s'][key]:.4f} s (calls "
                  f"{', '.join(f'{t:.4f}' for t in times[2:])})",
                  flush=True)
        if len(shape) > 2 and not checked and (
                arch == C.MAMBA or name == "blocks/mlp/w_down"):
            checked = True
            batched = S.srsi_implicit(v, r, p, 5, source)
            bad = []
            for i in range(shape[0]):
                alone = S.srsi_implicit(
                    S.make_implicit_v(q[i], u[i], g[i], 0.999), r, p, 5,
                    lambda want, _gen, i=i: draw[i])
                diff = [f for f in alone._fields
                        if not torch.equal(getattr(batched, f)[i],
                                           getattr(alone, f))]
                if diff:
                    bad.append((i, diff))
            res["alone_equal"][f"{arch}/{name}"] = not bad
            print(f"  {arch}/{name}: each matrix alone vs its slice of the "
                  f"batched run: {bad or 'bitwise equal'}", flush=True)
        del q, u, g, v, vm, draw, calls
    torch.cuda.empty_cache()

warm_cfg = optimizer_config("adapprox", 12, 3e-3, refresh_every=5,
                            fused_update=True, mixed_groups=True,
                            warm_start=True, bucketed=True)
warm_expect = dict(fused_precond=36, fused_apply=36, sketch_scatter=24,
                   sketch_query=24)
runs = {
    "mixed": (C.launcher_run(C.TRAIN_MIXED_ARGV), dict(
        fused_precond=72, fused_apply=72, sketch_scatter=24,
        sketch_query=24), {}),
    "warm": (C.launcher_run(C.TRAIN_WARM_ARGV), warm_expect,
             dict(bucketed=True)),
    "implicit": (C.loop_run(dev, dataclasses.replace(warm_cfg,
                                                     implicit=True)),
                 warm_expect, dict(bucketed=True)),
    "kmax": (C.loop_run(dev, dataclasses.replace(warm_cfg, k_max=10**9)),
             dict(warm_expect, sq_matmul_t=27), dict(bucketed=True)),
    "mamba2": (C.launcher_run(C.TRAIN_MAMBA_ARGV), dict(
        fused_precond=24, fused_apply=24, sketch_scatter=24,
        sketch_query=24, ssd_fwd=2 * 12 * C.SSD_LAYERS,
        ssd_bwd_rows=12 * C.SSD_LAYERS, ssd_bwd_cols=12 * C.SSD_LAYERS),
        dict(ssd_layers=C.SSD_LAYERS)),
}
for cell, (run, expect, kw) in runs.items():
    C.phase(f"[train-{cell}]")
    _, info = C.train_main_path(run, "fused", expect, **kw)
    res[cell] = info
print("RESULT " + json.dumps(res), flush=True)
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base")
    ap.add_argument("change", nargs="?",
                    default=str(Path(__file__).parents[1]))
    args = ap.parse_args()
    trees = {"base": Path(args.base).resolve(),
             "change": Path(args.change).resolve()}
    results = []
    for name in ("base", "change", "change", "base"):
        print(f"==== {name} ({trees[name]})", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=trees[name],
                              capture_output=True, text=True)
        print(proc.stdout, proc.stderr if proc.returncode else "",
              flush=True)
        if proc.returncode:
            raise SystemExit(f"ab_refresh: the {name} run failed")
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")][-1]
        results.append(dict(tree=name, **json.loads(line[len("RESULT "):])))
    for res in results:
        print(json.dumps(res))


if __name__ == "__main__":
    main()
