#!/usr/bin/env python3
"""Two checkouts of the port on one card, cell by cell: a cell's
hand-written kernels at their main-path shape and its training run, each
checkout in its own process, in the order base, change, change, base.

    python3 tools/ab_chunked.py [--cell chunked|mamba2|kernels|mixed]
                                BASE_DIR [CHANGE_DIR]

BASE_DIR and CHANGE_DIR (default: this checkout) are checkouts of this
repository, each with its own ``chip_smoke.py``; each builds its kernels
into its own ``build/``.  Each run prints its card, then, by cell:

  * chunked (the default): the device time a call of flash attention's
    forward, dQ and dK/dV kernels (B6, bf16, (8, 1024, 12, 64), causal),
    then ``chip_smoke.py``'s [train-chunked] and [breakdown-chunked];
  * mamba2: the device time a call of the SSD block's forward, rows and
    columns kernels (B7, bf16, Mamba2-370m's block (8, 1024, 32 heads, P
    64, N 128, chunk 256), dY bf16-valued as the model feeds it), and a
    step's of pass 1 (B1, the fold variant, over in_proj and out_proj)
    and of the sketch (B5, scatter + query, over embed and lm_head), then
    [train-mamba2] and [breakdown-mamba2];
  * kernels: the device time of the transposed square-and-matmul (B3, the
    fold) summed over the mixed groups' factored leaves of GPT-2 117M,
    then [train-kernels] and [breakdown-kernels];
  * mixed: a step's device time of pass 1 (B1, the fold variant) over
    the mixed groups' six factored leaves of GPT-2 117M and of the sketch
    (B5) over embed and pos_embed, then [train-mixed] and
    [breakdown-mixed];

each training run 12 steps (fold-step median, peak memory, launch
counts), then one JSON line per run with the cell's keys.  Needs one
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HEAD = r'''
import json, sys, time
sys.path.insert(0, "."); sys.path.insert(0, "src")
import torch
import chip_smoke as C
from repro_torch.kernels import cuda, ops
from repro_torch.launch.train import optimizer_config
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
print(C.card_line(), flush=True)
res = {}


def b1_b5_ms(arch, sketched):
    """A step's device time of pass 1 (fold variant, no guidance) over the
    mixed groups' factored leaves of arch, and of the sketch over its
    sketched leaves, on chip_smoke.py's inputs."""
    from repro_torch.core.sketch import bucket_indices
    fact, _ = C.main_path_leaves(dev, mixed=True, arch=arch)
    g = torch.Generator(device=dev).manual_seed(1)
    b1 = 0.0
    for name, shape, r in fact:
        bd = tuple(shape[:-2])
        q = torch.rand(bd + (shape[-2], r), generator=g, device=dev) * 1e-5
        u = torch.rand(bd + (shape[-1], r), generator=g, device=dev) * 1e-5
        gm = torch.randn(shape, generator=g, device=dev) * 1e-3
        b1 += C.device_ms(lambda: ops.fused_precond(
            q, u, gm, C.B2, C.EPS, with_vfro=False, with_fold=True),
            "precond_kernel")
        del q, u, gm
    b5 = 0.0
    for name, rows, d, width, depth, seeds in C.sketch_cases(
            dev, arch, sketched, ragged=False):
        idx = torch.from_numpy(bucket_indices(rows, width, seeds)).to(dev)
        order, offsets = ops.bucket_order(idx, width)
        table = torch.rand((depth, width, d), generator=g, device=dev) * 0.025
        gm = torch.randn((rows, d), generator=g, device=dev)
        b5 += C.device_ms(lambda: ops.sketch_update(
            table, gm, idx, C.B2, order=order, offsets=offsets), "sketch_")
        del idx, order, offsets, table, gm
    torch.cuda.empty_cache()
    print(f"  B1 ms a step over {len(fact)} leaves: {b1:.4f}; B5 ms a step "
          f"over {', '.join(sketched)}: {b5:.4f}", flush=True)
    return dict(b1_ms=b1, b5_ms=b5)
'''

CELLS = {
    "chunked": r'''
from repro_torch.kernels import flash_attention as FA
t0 = time.monotonic()
cuda.build(FA.SOURCE)
res.update(build_s=time.monotonic() - t0)
g = torch.Generator(device=dev).manual_seed(7)
q, k, v, do = (torch.randn((8, 1024, 12, 64), generator=g, device=dev)
               .bfloat16() for _ in range(4))
fwd = lambda: ops.flash_attention_fwd(q, k, v, True)
o, lse = fwd()
bwd = lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, True)
res.update(fwd_ms=C.device_ms(fwd, "flash_fwd_kernel"),
           dq_ms=C.device_ms(bwd, "flash_bwd_dq_kernel"),
           dkdv_ms=C.device_ms(bwd, "flash_bwd_dkdv_kernel"),
           fwd_stream_ms=C.events_ms(fwd), bwd_stream_ms=C.events_ms(bwd))
print(f"  B6 bf16 ms a call: fwd {res['fwd_ms']:.4f} dQ {res['dq_ms']:.4f} "
      f"dK/dV {res['dkdv_ms']:.4f}", flush=True)
del q, k, v, do, o, lse
torch.cuda.empty_cache()
cfg = optimizer_config("adapprox", 12, 3e-3, refresh_every=5,
                       fused_update=True, mixed_groups=True)
C.phase("[train-chunked]")
_, info = C.train_main_path(
    C.loop_run(dev, cfg, C.chunked_model_config()), "fused", dict(
        fused_precond=72, fused_apply=72, sketch_scatter=24,
        sketch_query=24, flash_fwd=2 * 144, flash_bwd_dq=144,
        flash_bwd_dkdv=144), attn_layers=12)
res.update(info)
C.phase("[breakdown-chunked]")
C.step_breakdown(dev, cfg, C.chunked_model_config())
''',
    "mamba2": r'''
from repro_torch.configs.archs import get_config
from repro_torch.kernels import fused_update, sketch_update
from repro_torch.kernels import ssd_chunk as SSD
t0 = time.monotonic()
cuda.build(SSD.SOURCE, fused_update.SOURCE, sketch_update.SOURCE)
res.update(build_s=time.monotonic() - t0)
g = torch.Generator(device=dev).manual_seed(8)
shape = (8, 1024, 32, 1, 64, 128, 256)
ins = C.ssd_inputs(g, shape, torch.bfloat16, dev)
dy = torch.randn(ins[0].shape, generator=g, device=dev).bfloat16().float()
fwd = lambda: ops.ssd_chunk_fwd(*ins)
bwd = lambda: ops.ssd_chunk_bwd(*ins, dy)
res.update(ssd_fwd_ms=C.device_ms(fwd, "ssd_fwd_kernel"),
           ssd_rows_ms=C.device_ms(bwd, "ssd_bwd_rows_kernel"),
           ssd_cols_ms=C.device_ms(bwd, "ssd_bwd_cols_kernel"),
           ssd_fwd_stream_ms=C.events_ms(fwd),
           ssd_bwd_stream_ms=C.events_ms(bwd))
print(f"  B7 bf16 ms a call: fwd {res['ssd_fwd_ms']:.4f} rows "
      f"{res['ssd_rows_ms']:.4f} columns {res['ssd_cols_ms']:.4f}",
      flush=True)
del ins, dy
torch.cuda.empty_cache()
res.update(b1_b5_ms(C.MAMBA, ("embed", "lm_head")))
C.phase("[train-mamba2]")
_, info = C.train_main_path(
    C.launcher_run(C.TRAIN_MAMBA_ARGV), "fused", dict(
        fused_precond=24, fused_apply=24, sketch_scatter=24,
        sketch_query=24, ssd_fwd=2 * 12 * C.SSD_LAYERS,
        ssd_bwd_rows=12 * C.SSD_LAYERS, ssd_bwd_cols=12 * C.SSD_LAYERS),
    ssd_layers=C.SSD_LAYERS)
res.update(info)
C.phase("[breakdown-mamba2]")
C.step_breakdown(dev, optimizer_config(
    "adapprox", 12, 3e-3, refresh_every=5, fused_update=True,
    mixed_groups=True), get_config(C.MAMBA))
''',
    "kernels": r'''
from repro_torch.kernels import srsi_matmul as SM
t0 = time.monotonic()
cuda.build(SM.SOURCE)
res.update(build_s=time.monotonic() - t0)
fact, _ = C.main_path_leaves(dev, mixed=True)
g = torch.Generator(device=dev).manual_seed(6)
res["sq_matmul_t_ms"] = 0.0
for name, shape, s in fact:
    gm = torch.randn(shape, generator=g, device=dev) * 1e-3
    y = torch.randn(shape[:-1] + (s,), generator=g, device=dev)
    res["sq_matmul_t_ms"] += C.device_ms(lambda: ops.sq_matmul_t(gm, y),
                                         "sq_matmul_kernel")
    del gm, y
print(f"  B3 transposed ms over {len(fact)} leaves: "
      f"{res['sq_matmul_t_ms']:.4f}", flush=True)
torch.cuda.empty_cache()
C.phase("[train-kernels]")
_, info = C.train_main_path(C.loop_run(dev, C.kernels_config()), "kernels",
                            dict(lowrank_update=72, sq_matmul_t=54,
                                 sketch_scatter=24, sketch_query=24))
res.update(info)
C.phase("[breakdown-kernels]")
C.step_breakdown(dev, C.kernels_config())
''',
}

CELLS["mixed"] = r'''
from repro_torch.kernels import fused_update, sketch_update
t0 = time.monotonic()
cuda.build(fused_update.SOURCE, sketch_update.SOURCE)
res.update(build_s=time.monotonic() - t0)
res.update(b1_b5_ms("gpt2-117m", ("embed", "pos_embed")))
cfg = optimizer_config("adapprox", 12, 3e-3, refresh_every=5,
                       fused_update=True, mixed_groups=True)
C.phase("[train-mixed]")
_, info = C.train_main_path(C.launcher_run(C.TRAIN_MIXED_ARGV), "fused",
                            dict(fused_precond=72, fused_apply=72,
                                 sketch_scatter=24, sketch_query=24))
res.update(info)
C.phase("[breakdown-mixed]")
C.step_breakdown(dev, cfg)
'''

TAIL = r'''
print("RESULT " + json.dumps(res), flush=True)
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", choices=sorted(CELLS), default="chunked")
    ap.add_argument("base")
    ap.add_argument("change", nargs="?",
                    default=str(Path(__file__).parents[1]))
    args = ap.parse_args()
    trees = {"base": Path(args.base).resolve(),
             "change": Path(args.change).resolve()}
    run = HEAD + CELLS[args.cell] + TAIL
    results = []
    for name in ("base", "change", "change", "base"):
        print(f"==== {name} ({trees[name]}), cell {args.cell}", flush=True)
        proc = subprocess.run([sys.executable, "-c", run], cwd=trees[name],
                              capture_output=True, text=True)
        print(proc.stdout, proc.stderr if proc.returncode else "",
              flush=True)
        if proc.returncode:
            raise SystemExit(f"ab_chunked: the {name} run failed")
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")][-1]
        results.append(dict(tree=name, cell=args.cell,
                            **json.loads(line[len("RESULT "):])))
    for res in results:
        print(json.dumps(res))


if __name__ == "__main__":
    main()
