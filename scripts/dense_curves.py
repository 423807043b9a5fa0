#!/usr/bin/env python3
"""Loss curves of Qwen2-7B and OLMoE-1B-7B at full width on one card, the
depth cut to ``chip_smoke.DENSE_LAYERS`` layers as in ``chip_smoke.py``'s
[train-qwen2] / [train-olmoe], under several learning rates, optimizers
and attention paths: the record behind the learning rates those phases
run at.

    python3 scripts/dense_curves.py

Each curve is 6 steps of ``repro_torch.launch.train`` (batch 2 x 2048,
``--fused-update --refresh-every 5``, the launcher's 5-step warmup); it
prints one ``CURVE`` line each: the losses, the MoE aux losses, the step
times and the peak memory.  Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

BASE = ["--steps", "6", "--batch", "2", "--seq", "2048", "--fused-update",
        "--refresh-every", "5", "--log-every", "1", "--device", "cuda"]
QWEN2 = ["--arch", "qwen2-7b"] + BASE
OLMOE = ["--arch", "olmoe-1b-7b"] + BASE
# (label, launcher argv, ModelConfig fields set)
CURVES = [
    ("qwen2 chunked mixed lr 3e-4", QWEN2 + ["--lr", "3e-4"],
     dict(attn_impl="chunked")),
    ("qwen2 naive mixed lr 3e-4", QWEN2 + ["--lr", "3e-4"],
     dict(attn_impl="naive")),
    ("qwen2 chunked adamw lr 3e-4",
     QWEN2 + ["--lr", "3e-4", "--optimizer", "adamw"],
     dict(attn_impl="chunked")),
    ("qwen2 chunked no-mixed lr 3e-4",
     QWEN2 + ["--lr", "3e-4", "--no-mixed-groups"],
     dict(attn_impl="chunked")),
    ("qwen2 chunked mixed lr 1e-4", QWEN2 + ["--lr", "1e-4"],
     dict(attn_impl="chunked")),
    ("qwen2 chunked mixed lr 3e-5", QWEN2 + ["--lr", "3e-5"],
     dict(attn_impl="chunked")),
    ("olmoe mixed lr 4e-4", OLMOE + ["--lr", "4e-4"], {}),
    ("olmoe mixed lr 1e-4", OLMOE + ["--lr", "1e-4"], {}),
    ("olmoe adamw lr 4e-4", OLMOE + ["--lr", "4e-4", "--optimizer", "adamw"],
     {}),
]


def main() -> None:
    import torch
    import chip_smoke as C
    from repro_torch.kernels import cuda
    from repro_torch.launch import train as launcher
    if not torch.cuda.is_available():
        raise SystemExit("dense_curves: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(C.card_line())
    cuda.build(*[m.SOURCE for m in C.kernel_modules()])
    for label, argv, over in CURVES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        with C.depth_cut(C.DENSE_LAYERS, **over):
            state, hist = launcher.main(argv)
        del state
        print(f"CURVE {label}: losses {[round(h['loss'], 4) for h in hist]}"
              f" aux {[round(h.get('aux_loss', 0.0), 4) for h in hist]} "
              f"times {[round(h['step_time_s'], 3) for h in hist]} peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({time.monotonic() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
