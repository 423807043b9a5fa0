#!/usr/bin/env python3
"""Two checkouts of the port on one card: flash attention's bf16 kernels
(B6) at GPT-2 117M's attention shape, and the chunked-attention training
cell, each checkout in its own process, in the order base, change,
change, base.

    python3 tools/ab_chunked.py BASE_DIR [CHANGE_DIR]

BASE_DIR and CHANGE_DIR (default: this checkout) are checkouts of this
repository, each with its own ``chip_smoke.py``; each builds its kernels
into its own ``build/``.  Each run prints the device time a call of the
forward, dQ and dK/dV kernels (bf16, (8, 1024, 12, 64), causal), then
``chip_smoke.py``'s [train-chunked] (12 steps: fold-step median, peak
memory, launch counts) and [breakdown-chunked], then one JSON line.
Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = r'''
import json, sys, time
sys.path.insert(0, "."); sys.path.insert(0, "src")
import torch
import chip_smoke as C
from repro_torch.kernels import cuda, flash_attention as FA, ops
from repro_torch.launch.train import optimizer_config
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
print(C.card_line(), flush=True)
t0 = time.monotonic()
cuda.build(FA.SOURCE)
res = dict(build_s=time.monotonic() - t0)
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
        sketch_query=24, flash_fwd=144, flash_bwd_dq=144,
        flash_bwd_dkdv=144), attn_layers=12)
res.update(info)
C.phase("[breakdown-chunked]")
C.step_breakdown(dev, cfg, C.chunked_model_config())
print("RESULT " + json.dumps(res), flush=True)
'''


def main() -> None:
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    trees = {"base": Path(sys.argv[1]).resolve(),
             "change": Path(sys.argv[2] if len(sys.argv) == 3
                            else Path(__file__).parents[1]).resolve()}
    results = []
    for name in ("base", "change", "change", "base"):
        print(f"==== {name} ({trees[name]})", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=trees[name],
                              capture_output=True, text=True)
        print(proc.stdout, proc.stderr if proc.returncode else "",
              flush=True)
        if proc.returncode:
            raise SystemExit(f"ab_chunked: the {name} run failed")
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")][-1]
        results.append(dict(tree=name, **json.loads(line[len("RESULT "):])))
    for res in results:
        print(json.dumps(res))


if __name__ == "__main__":
    main()
