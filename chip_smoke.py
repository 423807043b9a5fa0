#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (H100,
sm_90a) and the CUDA toolkit.  In order, it

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel source in ``src/repro_torch/kernels/csrc`` with
     nvcc, one process per source, all started together, and prints the
     build time, the ptxas report and the wgmma (HGMMA) instructions in
     each bf16 flash attention kernel, each square-and-matmul kernel
     (3xTF32), each bf16 SSD kernel and each pass-1 and single-pass update
     kernel (3xTF32), failing if one has none;
  3. holds every kernel variant against its plain PyTorch version on the
     card at every leaf shape of the GPT-2 117M main paths (pass 1 plain,
     guided, fold, both, and its int8 variant on quantized factors; pass 2
     shared, two-output, dense; the single-pass update; the square-and-
     matmul in both orientations; the sketch scatter + query at the
     embedding shapes of the mixed groups; flash attention's forward and
     two backward kernels at GPT-2 117M's attention shape in bf16 and
     fp32; the SSD block's forward and two backward kernels at
     Mamba2-370m's block in bf16 and fp32, on inputs whose decay
     overflows above the diagonal; pass 1, pass 2 and the sketch also at
     Mamba2-370m's leaves; pass 1 with the fold at the paper's k_max, r
     192 and 256, past what pass 1 folds itself, where the fold goes
     through the square-and-matmul, fp32 and int8) and at ragged shapes,
     each new kernel bitwise repeatable, and times each beside its bound
     and the plain version's time (flash attention also beside
     scaled_dot_product_attention, a yardstick the port never calls);
  4. checks the kernel path end to end against the plain path on a small
     input: the GPT-2 smoke model in fp32 trains a few steps on the card
     and on the CPU from the same init and sketches, and the losses, ranks
     and parameters must agree -- without and with the mixed groups, with
     int8 factors, on the use_kernels path, with attn_impl "chunked" at
     2048 tokens, and on the Mamba2 smoke model (its first step's
     gradients too); with warm start, implicit S-RSI, bucketing, the
     paper's k_max, bf16 parameters, for Adafactor and CAME, and under
     the guards with every factored leaf demoted at step 2, the guard
     counters equal;
  5. trains GPT-2 117M at full width (12 steps, batch 8 x 1024,
     --fused-update --refresh-every 5) with the launch counters set to 0
     just before each run, and checks a finite, falling loss and the
     launches that the optimizer state implies: through
     ``repro_torch.launch.train`` with --no-mixed-groups (pass 1 per
     factored leaf, pass 2 per leaf, every step), on the launcher's
     default mixed groups (count-min sketch on embed and pos_embed,
     Adapprox on the six block matrices, dense Adam on the rest; two
     sketch launches per sketched leaf per step), and on the mixed groups
     with --quantize-factors (every pass 1 int8); then, through
     ``build_optimizer`` and the train loop, the launcher's optimizer
     with use_kernels and no fused update (the single-pass update per
     factored leaf every step, the transposed square-and-matmul per
     factored leaf on fold steps), and the launcher's mixed groups with
     attn_impl "chunked" (flash attention's three kernels once per layer
     every step, and none on the other paths); then Mamba2-370m through
     ``repro_torch.launch.train --arch mamba2-370m`` on the mixed groups
     (the SSD block's three kernels once per layer every step, none on
     the GPT-2 paths); then GPT-2 117M on the mixed groups with
     --warm-start --bucketed, the same with implicit=True, the same at
     the paper's k_max (the fold through the transposed
     square-and-matmul on fold steps), and --optimizer adafactor and
     came (no kernel launched); every model runs under remat "full"
     (each layer's forward again in the backward: flash attention's and
     the SSD block's forward twice a layer), and GPT-2 117M (none,
     full, dots) and Mamba2-370m (none, full) run 4 steps for their peak
     memory and fold step; then the fault-tolerant path on the mixed
     groups with --guards: [ckpt] trains 12 steps twice (without and
     with --ckpt-dir --ckpt-every 4), SIGTERMs a launcher subprocess once
     step 6 is logged and relaunches it, and holds the relaunched run's
     step 12, and the unguarded [train-mixed] run, to the straight runs
     (bitwise if the two are bitwise equal, else within their
     difference), checks restore(save(state)) bitwise on the card, skips
     a bit-flipped and a truncated latest checkpoint, and prints the
     save's and the restore's seconds and bytes; [chaos] injects NaN
     gradients at steps 5 and 6 and Inf at 9 and holds every state
     tensor (m1 included) bitwise across them; [guards] drives the xi
     watchdog to a forced refresh off the cadence and the demotion of
     every factored leaf, after which B1 and B2 launch no more, its
     counters those of [parity-guards]' CPU run; [guards-bucketed] runs
     the guarded launcher with --bucketed --max-demotions 2 --ckpt-dir
     per leaf (6 calls of B1 / B2 a step, not 3); [telemetry] runs the
     mixed groups with the telemetry subsystem: bitwise [train-mixed]
     with snapshots on, with a constant dynamic cadence and with
     everything on, the snapshots against the leaves, the closed loop
     (interval 2) against a replay of its interval means and across a
     save at step 7 and a restore, the launcher with --telemetry-dir
     --trace-dir --metrics-every --auto-refresh --guards, paired fold-step
     times with everything on and off, and the device-to-host copies a
     fold step (telemetry adds at most one, none under the guards);
     [chaos] also checks its runtime's fault events and runs
     ``python -m repro_torch.tools.chaos`` on the card (exit 0); [srsi]
     also holds each of w_down's matrices alone against its slice of the
     batched S-RSI, bitwise, and at other widths (GPT-2 345M's w_down,
     Mamba2-370m's in_proj, Qwen2-7B's w_down at their step-1 refresh)
     one matrix against the CPU and alone against its batch; then the
     dense family and the MoE block at full width, depth cut to 4 layers
     (``depth_cut``: Qwen2-7B's fp32 state would not fit 28): [kernels-
     dense] holds flash attention at Qwen2-7B's (2, 2048, 28 over 4, 128),
     the sketch at its embed and 152,064-wide lm_head, pass 1 and pass 2
     at one w_up and an OLMoE expert stack; [parity-dense] and
     [parity-moe] (the router's top-k indices first: a flip fails as
     one) run a qwen3-14b and an olmoe smoke model on the card and the
     CPU; [train-qwen2] trains Qwen2-7B (attn_impl "chunked", batch 2 x
     2048, the chunked cross entropy of the untied head) and
     [train-olmoe] OLMoE-1B-7B 6 steps through the launcher, with the
     launches the path implies, and runs OLMoE's step 2 twice from one
     state, bitwise; then the hybrid, encoder-decoder and vlm families at
     full width: [kernels-families] holds the SSD block at Zamba2-2.7B's
     (4, 2048, 80 heads, P 64, N 64), flash attention at Zamba2-2.7B's
     (4, 2048, 32, dh 80) and LLaVA-NeXT-Mistral-7B's (2, 2048, 32 over
     8, 128), each in bf16 and fp32, pass 1 and pass 2 at Zamba2-2.7B's
     in_proj stack and the sketch at Whisper-large-v3's sketched leaves;
     [parity-hybrid], [parity-encdec] and [parity-vlm] run the zamba2,
     whisper and llava smoke models on the card and the CPU (the last
     two on make_batch batches, which carry the stub frontend's embeds,
     through build_train_step); [train-zamba2] trains Zamba2-2.7B whole
     (54 layers, attn_impl "chunked", batch 4 x 2048) through the
     launcher, [train-whisper] Whisper-large-v3 whole (batch 8, 1500
     frames, 448 tokens) and [train-llava] LLaVA-NeXT-Mistral-7B (4 of 32
     layers, 576 image + 1472 text tokens) through build_train_step,
     each 6 steps (the last two on fresh make_batch embeds and synthetic
     text a step) with the launches the path implies, and LLaVA text
     only through the launcher for 6;
  6. [mesh]: trains GPT-2 117M (mixed groups, 12 steps, writing a
     checkpoint) and OLMoE-1B-7B (4 layers, 6 steps, the MoE block
     through moe_apply_sharded) through the launcher with --mesh 1,1
     --fsdp, on a one-rank NCCL group (the split leaves DTensors, the
     step on each rank's blocks: batch split and gradient sums real
     collectives), and holds each to its run without a mesh, bitwise:
     every loss,
     every final state tensor, the launches; the checkpoint's manifest
     carries a spec string on every leaf and the rules' param specs, and
     restores without a mesh bitwise; then breaks a step of each run
     down into model and optimizer time; [dryrun] runs the dry run
     (``repro_torch.launch.dryrun``) of [mesh]'s GPT-2 117M configuration
     on a one-rank fake mesh (1, 1), fake CPU tensors, its step 2 (a fold
     step), holds its per-rank parameter and optimizer-state bytes
     exactly to a 2-step ``--mesh 1,1`` run on the card and to [mesh]'s
     final state, and holds the card's fold-step max_memory_allocated
     within 0.97-1.03 of its predicted peak; [mesh] last runs two gloo
     ranks sharing cuda:0 at --mesh 1,2 in one subprocess and one spawn
     (``scripts/mesh_ranks.py --ranks-only --case all --mesh 1,2 --serve
     --full``): they train the smoke GPT-2, the smoke Mamba2-370m
     and Zamba2-2.7B and Mamba2-370m at full width (12 of 48 layers, 3
     steps) through the launcher, and the smoke Whisper-large-v3 through
     build_train_step on make_batch's embeds (the launcher stops for want
     of them), the products split over model (half the heads, SSM heads
     included, the MLP and the vocabulary a rank; Whisper's encoder,
     self and cross attention), their losses held to the runs without a
     mesh at rtol 1e-3 and B7's launches a rank to the depth's; then
     they serve (the heads, MLP and vocabulary split over model, the KV
     cache's sequence kept split, Whisper's cross cache's encoder rows
     and the Mamba states' heads too) the smoke Qwen2-7B and
     Whisper-large-v3 at head_dim 64, Mamba2-370m and Zamba2-2.7B in
     fp32 compute, then Qwen2-7B at full width and depth (28 layers),
     Zamba2-2.7B (12 of 54 layers) and Whisper-large-v3 (1500 frames;
     ``mesh_ranks.SERVE_DEPTH``) at full width in bf16, prefilling 2 x
     8192 tokens (1024 for the smoke SSM models), so B6 and B7 run on
     each rank's heads (one launch a layer a rank), then 8 decode steps
     (no B6 or B7 launch); then a second spawn of four gloo ranks at
     --mesh 2,2 serves the smoke Zamba2-2.7B in fp32 and Zamba2-2.7B (12
     layers) in bf16 at the long_500k cells' layout (B = 1, the KV
     sequence over (data, model)), a prompt of 8192 into 16,384 rows and
     8 decode steps that write into the second data group's block; every
     step's logits held to the run without a mesh in this process at
     ``TOL_SERVE_MESH`` / ``TOL_SERVE_DENSE`` / ``TOL_SERVE_SSM`` /
     ``TOL_SERVE_ENCDEC`` and the greedy tokens equal but at a tie; before
     the spawns, B6's forward and B7's forward and backward are held to
     their plain versions at the shapes a rank gives them;
  7. sums the optimizer-state bytes of GPT-2 117M under the mixed groups
     and AdamW, and of Adafactor and CAME at 117M and 345M, and holds
     them against ``BENCH_memory.json``, and those of
     the int8 factors (117M and 345M) and of Mamba2-370m (mixed groups,
     AdamW) against the JAX package's count;
  8. serves, under torch.inference_mode (after the profiled phases, as
     late in a long run torch.profiler drops kernel records):
     [kernels-serve] holds B6's forward at Qwen2-7B's wave prefill (2,
     8192, 28 over 4, 128) beside SDPA and B7's at Mamba2-370m's and
     Zamba2-2.7B's prefills; [serve-qwen2] serves Qwen2-7B whole (28
     layers) through ``repro_torch.launch.serve``: a 2-slot wave at prompt
     8192 (B6's forward once a layer in the prefill, nothing else), the
     continuous engine (8 requests of 512 tokens on 4 slots, the paged
     cache, chunks of 64) and its requests through the wave engine, each
     request's logits teacher-forced against the full forward of its
     sequence, the continuous streams held to the wave's (a parting only
     at a tie within a few bf16 ulps) and the allocator drained;
     [serve-families] serves Mamba2-370m and Zamba2-2.7B (whole) on the
     wave engine, Whisper-large-v3 (whole) and LLaVA-NeXT-Mistral-7B (4
     layers) through prefill and decode_step, and OLMoE-1B-7B (4 layers,
     dropless) on the continuous engine, each with its launches and the
     same gate (a tolerance per family, failing too where the gate could
     not tell a path off by one position); [parity-serve] runs every
     family's smoke model and the paged path in fp32 on the card and the
     CPU, and paged decode against dense decode on the card, bitwise;
  9. runs the four examples of ``examples/torch`` through their ``main``
     ([examples]): ``train_gpt2_pile.py --full --steps 8`` (GPT-2 117M,
     batch 16 x 256, the launcher's mixed groups) into a checkpoint
     directory and again (a falling loss, the second run restoring at
     step 8 and taking none, B5 launched twice a step for each of the two
     sketched tables and nothing else), ``quickstart.py --steps 20`` (a
     falling loss, finite rank metrics, the mean rank in [1, k_max], its
     trace through ``repro_torch.tools.traceview --check``),
     ``elastic_restart.py`` (a bitwise restore) and ``serve_batched.py``
     (each request's continuous stream against the request alone on a
     one-slot wave engine, parting only at a tie), and prints the
     phase's seconds;
 10. prints one JSON line with each training run's loss, times and peak
     memory, one with each kernel's launches, error and times, then
     ``{"ok": true, "device": {...}}`` as the last line.

Any failed check raises, so the script exits non-zero without the last
line.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 and TF32 on the tensor cores (fp32 accumulation) and
# HBM3 bandwidth, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

TRAIN_ARGV = ["--arch", "gpt2-117m", "--steps", "12", "--batch", "8",
              "--seq", "1024", "--no-mixed-groups", "--fused-update",
              "--refresh-every", "5", "--log-every", "1", "--device", "cuda"]
# the launcher's default: mixed groups for adapprox
TRAIN_MIXED_ARGV = [a for a in TRAIN_ARGV if a != "--no-mixed-groups"]
TRAIN_INT8_ARGV = TRAIN_MIXED_ARGV + ["--quantize-factors"]
# slice 5: Mamba2-370m on the launcher's defaults (mixed groups)
TRAIN_MAMBA_ARGV = ["--arch", "mamba2-370m"] + TRAIN_MIXED_ARGV[2:]
# slice 9: warm start and bucketing; the baselines (no mixed groups, as in
# the JAX launcher; --fused-update and --refresh-every are Adapprox's)
TRAIN_WARM_ARGV = TRAIN_MIXED_ARGV + ["--warm-start", "--bucketed"]
TRAIN_BASELINE_ARGV = [a for a in TRAIN_MIXED_ARGV
                       if a not in ("--fused-update", "--refresh-every", "5")]
B2, EPS, B1 = 0.999, 1e-8, 0.9
# slice 10: the launcher's mixed groups under the skip-step guard and the
# xi watchdog, as a pretraining run is launched
TRAIN_GUARDED_ARGV = TRAIN_MIXED_ARGV + ["--guards"]
# the same with the watchdog's threshold above any xi (an error rate in
# [0, 1]): the skip-step guard alone, a no-op on healthy steps
TRAIN_GUARDED_CALM_ARGV = TRAIN_GUARDED_ARGV + ["--guard-skip-threshold", "1"]
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"
# [examples]: the four examples of examples/torch, run as a user runs them
# ([examples]); their checkpoints and traces under build/, removed after.
# train_gpt2_pile.py --full is GPT-2 117M at full width, batch 16 x 256,
# on the launcher's defaults (mixed groups, refresh every step)
EXAMPLES = ROOT / "examples" / "torch"
EXAMPLES_ROOT = ROOT / "build" / "chip_smoke_examples"
EXAMPLE_GPT2_STEPS = 8
EXAMPLE_QUICKSTART_STEPS = 20
# slice 12: the dense family's features and the MoE block at full width,
# depth cut to 4 layers (``depth_cut``): Qwen2-7B's 7.6B fp32 master
# parameters, their gradients and the first moment exceed 80 GB.  Batch
# 2 x 2048: vocab x S >= 2^26 in both, so the loss is the chunked cross
# entropy from the hiddens (the untied head).  The learning rates are the
# models' scale, not the launcher's 3e-3 (GPT-2's), under which Qwen2-7B's
# loss climbs.  The launcher warms up over max(steps / 20, 5) steps, so a
# 6-step run reaches its peak rate at step 5: at 3e-4 Qwen2-7B climbs
# 13.0 -> 23.1 by step 6 under Adapprox and AdamW alike
# (scripts/dense_curves.py, PERF.md run 22b), so it runs at 1e-4;
# OLMoE-1B-7B runs at its own peak rate, 4e-4 (arXiv 2409.02060), and
# falls 11.5 -> 8.0.
DENSE_LAYERS = 4
TRAIN_QWEN2_ARGV = ["--arch", "qwen2-7b", "--steps", "6", "--batch", "2",
                    "--seq", "2048", "--lr", "1e-4", "--fused-update",
                    "--refresh-every", "5", "--log-every", "1",
                    "--device", "cuda"]
TRAIN_OLMOE_ARGV = (["--arch", "olmoe-1b-7b"] + TRAIN_QWEN2_ARGV[2:8]
                    + ["--lr", "4e-4"] + TRAIN_QWEN2_ARGV[10:])
# wq, wk, wv, wo, the router and the three expert stacks (L, 64, m, n)
# factored (8 calls), embed and lm_head sketched; naive attention
OLMOE_EXPECT = dict(fused_precond=48, fused_apply=48, sketch_scatter=12,
                    sketch_query=12)
# the distributed training path on a one-rank NCCL group (--mesh 1,1:
# the check runs on one card, and NCCL refuses two ranks on one device),
# every collective an identity: held bitwise to [train-mixed] and
# [train-olmoe]
MESH_ARGV = ["--mesh", "1,1", "--fsdp"]

# The hybrid, encoder-decoder and vlm families at full width,
# each on the launcher's mixed groups with --fused-update --refresh-every 5
# for 6 steps.  Zamba2-2.7B whole (54 layers, 2.48B parameters: fp32
# parameters, gradients and first moment ~30 GB), attn_impl "chunked" (the
# shared blocks' attention on B6 at dh 2560 / 32 = 80), batch 4 x 2048,
# through the launcher, at lr 1.6e-4: GPT-3 2.7B's peak rate (arXiv
# 2005.14165, Table 2.1), as the launcher's 3e-3 is GPT-2 117M's.
# Whisper-large-v3 whole (32 + 32 layers, 1.58B), batch 8, 1500 frames
# and 448 decoder tokens (its text context), at lr 1.75e-4, the Whisper
# paper's rate for large (arXiv 2212.04356), and LLaVA-NeXT-Mistral-7B cut
# to 4 of 32 layers (7.24B does not fit, for Qwen2-7B's reason), batch 2 x
# (576 image + 1472 text tokens), attn_impl "chunked", at lr 1e-4, Qwen2-
# 7B's (scripts/dense_curves.py: 3e-4 climbs in a 6-step run at that
# width): both through build_train_step on a fresh batch a step
# (``configs/base.py::make_batch``'s stub-frontend embeds, the launcher's
# synthetic text; ``family_run``), since no launcher path feeds embeds,
# in JAX or here.  LLaVA also runs text-only through the launcher for 6
# steps, as [train-qwen2] does: at these rates the first fold steps of
# the dense decoders climb before they fall (Qwen2-7B 12.04 -> 13.00 at
# step 3, LLaVA text only 10.15 -> 14.17; PERF.md run 23c).
ZAMBA = "zamba2-2.7b"
ZAMBA_LAYERS = 54
ZAMBA_APPS = 9          # shared-block applications: 54 layers / every 6
TRAIN_ZAMBA_ARGV = ["--arch", ZAMBA, "--steps", "6", "--batch", "4",
                    "--seq", "2048", "--lr", "1.6e-4", "--fused-update",
                    "--refresh-every", "5", "--log-every", "1",
                    "--device", "cuda"]
WHISPER = "whisper-large-v3"
WHISPER_RUN = dict(batch=8, seq=448, lr=1.75e-4)
LLAVA = "llava-next-mistral-7b"
LLAVA_LAYERS = 4
LLAVA_RUN = dict(batch=2, seq=2048, lr=1e-4)
TRAIN_LLAVA_ARGV = ["--arch", LLAVA, "--steps", "6", "--batch", "2",
                    "--seq", "2048", "--lr", "1e-4", "--fused-update",
                    "--refresh-every", "5", "--log-every", "1",
                    "--device", "cuda"]

# Serving, through ``repro_torch.launch.serve`` and the models'
# prefill / decode.  Serving holds no gradient or optimizer state, so
# Qwen2-7B runs whole: 28 layers, ~30.5 GB of fp32 parameters, the port's
# seed-0 init.  A 2-slot wave at prompt 8192 (cache 8448 rows: 0.97 GB of
# bf16 KV) prefills through B6 (attn_impl "auto" takes the chunked path
# for S > 4096 that divides into 1024), 28 forward launches; decode and the
# paged paths run the naive _sdpa, as in JAX.  The continuous engine serves
# 8 requests of 512 tokens on 4 slots over a pool of 1024 tokens a slot,
# and the same requests go through the wave engine for the stream check.
QWEN2 = "qwen2-7b"
QWEN2_LAYERS = 28
SERVE_WAVE_ARGV = ["--arch", QWEN2, "--slots", "2", "--requests", "2",
                   "--prompt-len", "8192", "--cache-len", "8448",
                   "--max-new", "32", "--device", "cuda"]
SERVE_CONT_ARGV = ["--arch", QWEN2, "--continuous", "--block-size", "16",
                   "--slots", "4", "--requests", "8", "--prompt-len", "512",
                   "--cache-len", "1024", "--max-new", "32",
                   "--prefill-chunk", "64", "--device", "cuda"]
SERVE_CONT_WAVE_ARGV = [a for a in SERVE_CONT_ARGV if a != "--continuous"]
# the other families at full width: Mamba2-370m (B7 once a layer in the
# prefill), Zamba2-2.7B whole (B7 in 54 layers, B6 at its 9 shared-block
# applications: prompt 8192, one slot), OLMoE-1B-7B at 4 of 16 layers on
# the continuous engine; Whisper-large-v3 whole and LLaVA-NeXT-Mistral-7B
# at 4 of 32 layers through prefill / decode_step directly (no engine
# passes embeds, in JAX or here)
SERVE_MAMBA_ARGV = ["--arch", "mamba2-370m", "--slots", "2", "--requests", "2",
                    "--prompt-len", "1024", "--cache-len", "1056",
                    "--max-new", "32", "--device", "cuda"]
SERVE_ZAMBA_ARGV = ["--arch", ZAMBA, "--slots", "1", "--requests", "1",
                    "--prompt-len", "8192", "--cache-len", "8224",
                    "--max-new", "32", "--device", "cuda"]
OLMOE = "olmoe-1b-7b"
SERVE_OLMOE_ARGV = ["--arch", OLMOE] + SERVE_CONT_ARGV[2:]
SERVE_WHISPER = dict(batch=2, prompt=64, steps=32)
SERVE_LLAVA = dict(batch=2, text=1472, steps=32)
# [parity-serve]: (arch, prompt length, frontend rows) at smoke size
PARITY_SERVE = [("gpt2-117m", 32, None), ("qwen3-14b", 32, None),
                (OLMOE, 32, None), (LLAVA, 24, 8), ("mamba2-370m", 32, None),
                (ZAMBA, 32, None), (WHISPER, 12, "enc_seq")]

# the smoke model's mixed groups: embed (512 rows) is sketched
SMALL_MIXED = dict(embedding_min_rows=256, sketch_width=256, sketch_depth=2)

# Tolerances, relative to the largest magnitude of the plain output.
# Pass 1 sums Q U^T over r (and the fold over m) in another order than the
# plain matmul, and its whole-matrix reductions in per-block partials; the
# inputs keep Q U^T away from 0, where u_hat is ill-conditioned.  Pass 2
# has no reduction: the only difference is fma contraction, a few ulp.
TOL_PRECOND = 1e-5
TOL_SUMS = 1e-4
TOL_APPLY = 1e-6
# The sketch scatter sums ~25 squares per bucket (embed: 50257 rows over
# 2048 buckets) in ascending row order; the plain version's index_add_ on
# the card sums them with atomics in another order.
TOL_SKETCH = 1e-5
# The square-and-matmul sums m (or n) products per entry in another order
# than cuBLAS.
TOL_MATMUL = 1e-5
# End to end with int8 factors, card against CPU: the codec turns a 1e-7
# difference of the factors into a q8 step (1/254 of a block's range) and
# S-RSI amplifies it; on the CPU, the same 4 steps from an init moved by
# one ulp move the parameters by 1.1e-3 of the largest.
TOL_PARAMS_INT8 = 1e-2
# S-RSI on the card against the CPU at a full-width leaf (five power
# iterations of fp32 GEMMs summed in another order): Q U^T relative to
# its largest entry.
TOL_SRSI = 1e-4
# End to end on the Mamba2 smoke model, card against CPU: a sketched
# embedding entry whose gradient cancels to ~eps (1.8e-8 against 2e-2 in
# its row) and fills its (bucket, column) alone takes the update
# g / (|g| + eps), so a 1e-7 difference of the gradient moves it by ~10%
# of a step; on the CPU, the same 4 steps with B7's plain version run in
# fp64 instead of fp32 move the parameters by 4.1e-4 of the largest.  The
# step-1 gradients, where nothing amplifies, are held to 1e-4.
TOL_PARAMS_MAMBA = 1e-3
# The same on the MoE smoke model (olmoe, the token embedding sketched):
# with equal routes the card's losses agree with the CPU's to 2e-7, but
# after 4 steps the sketched embedding's entries whose gradient is ~eps
# differ by 4.8e-4 to 5.0e-4 of its largest entry; on the CPU an init
# whose wq is scaled by 1 + 1e-7 moves that leaf by 2.7e-4 to 6.1e-4
# (the phase prints this witness; PERF.md runs 22a, 22b).  The step-1
# gradients are held to 1e-4.
TOL_PARAMS_MOE = 1e-3

# Serving, teacher-forced, on the card in the model's bf16 compute: the
# logits each generated token came from (the prefill's last row, then one
# decode step a token against the cache) against the full forward's
# logits at the same positions of the same sequence, relative to the
# largest entry of the forward's rows, held to a tolerance per family.
# The two paths round differently: bf16 keeps 8 significant bits (2^-9
# relative a rounding) at every projection, norm and residual of every
# layer, each side rounds M = 1 and M = S products in other orders, the
# prefill's B6 keeps P in fp32 where the forward's naive path rounds the
# probabilities to bf16, the SSM decode runs the conv and the state update
# in fp32 from a bf16 buffer where the forward runs B7 on bf16 operands,
# and a near-tied MoE route can flip; at random init nothing cancels this.
# Each tolerance sits about twice above its family's readings (runs
# 24b-24f, identical each run) and at or above the bf16 forward's own
# error against an fp32 forward of the same sequence (the witness each run
# prints).  Dense and vlm: 1.1e-2 to 2.2e-2 (Qwen2-7B, LLaVA), witness
# 1.7e-2 to 2.3e-2.
TOL_SERVE_DENSE = 5e-2
# SSM and hybrid: 4.2e-2 to 4.9e-2 (Mamba2-370m, Zamba2-2.7B), witness
# 6.2e-2 (Zamba2-2.7B) and 7.3e-2 (Mamba2-370m).
TOL_SERVE_SSM = 1e-1
# Encoder-decoder: 1.26e-2 (Whisper-large-v3), witness 1.77e-2; at random
# init its decoder output barely moves with the position, so a path off by
# one position reads only 5.05e-2 to 5.30e-2 and the bound stays below
# SERVE_SHIFT_MARGIN times under that.
TOL_SERVE_ENCDEC = 2.5e-2
# MoE: up to 8.9e-2 (OLMoE-1B-7B, dropless), witness 1.59e-1 (run 24c): a
# router score near-tied between an expert and the next routes a token
# apart under either rounding.  Held to the bf16 forward's own scale.
TOL_SERVE_MOE = 2e-1
TOL_SERVE = {"dense": TOL_SERVE_DENSE, "vlm": TOL_SERVE_DENSE,
             "ssm": TOL_SERVE_SSM, "hybrid": TOL_SERVE_SSM,
             "encdec": TOL_SERVE_ENCDEC, "moe": TOL_SERVE_MOE}
# The gate must tell a cache path off by one position: the rows against
# the forward's next position must read at least this many times the
# family's tolerance, or the phase fails (smallest readings: 0.62 dense,
# 1.29 SSM, 0.47 MoE, 5.05e-2 Whisper).
SERVE_SHIFT_MARGIN = 1.5
# Where a continuous stream parts from the wave's, both logits rows at
# that step lie within the family's tolerance of each other and the two
# chosen tokens are tied in each row to within this many bf16 ulps of the
# row's largest entry: each engine's token leads the other's by at most
# that much in its own row.  The rows differ by 1.6e-2 to 2.2e-2 of the
# largest entry (3-5 ulps), so a rounding breaks a tie only that close;
# the partings lead by 0 to 3 ulps (run 24g).
SERVE_TIE_ULPS = 4
# [parity-serve]: card against CPU at smoke size in fp32 compute, logits
# and caches relative to each tensor's largest entry (summation order only)
TOL_SERVE_PARITY = 1e-4

# Flash attention against its plain version on the same inputs.  fp32:
# the same fp32 products, summed in 64-wide tiles against 1024-wide chunks
# and cuBLAS, so out and lse within 1e-5 of the largest entry; the
# gradients within 1e-4, as D and the recomputed P each sum in another
# order and dS = P (dP - D) cancels.  bf16 outputs (out, dq, dk, dv of
# bf16 inputs): each side rounds an fp32 result to bf16 once, so each
# entry within one bf16 ulp of itself, plus TOL_FLASH of the largest
# entry for the fp32 summation order, which exceeds the ulp of entries
# near 0 (fp32 gradients read 2.9e-7 of the largest on the card).
TOL_FLASH = 1e-5
TOL_FLASH_GRAD = 1e-4
# (name, (B, Sq, Sk, H, KV, dh), causal, dtypes): GPT-2 117M's attention
# at batch 8 x 1024 (timed), then dh 80 (no multiple of 64), S 1000 (no
# multiple of the 64-row tiles), 8 query heads over 2 KV heads, and dh 60
# (no multiple of 8: the bf16 kernels' loads without 16-byte copies)
FLASH_CASES = [
    ("gpt2-117m", (8, 1024, 1024, 12, 12, 64), True,
     ("bfloat16", "float32")),
    ("ragged gqa causal", (2, 1000, 1000, 8, 2, 80), True,
     ("float32", "bfloat16")),
    ("ragged gqa full", (2, 1000, 872, 8, 2, 80), False,
     ("float32", "bfloat16")),
    ("ragged dh 60", (2, 300, 300, 4, 2, 60), True, ("bfloat16",))]
# Qwen2-7B's attention at batch 2 x 2048 (timed): dh 128 and 28 query
# heads over 4 KV heads, a group of 7
DENSE_FLASH_CASES = [
    ("qwen2-7b", (2, 2048, 2048, 28, 4, 128), True, ("bfloat16", "float32"))]

# Zamba2-2.7B's shared attention at batch 4 x 2048 (dh 80: the 128-wide
# tiles 37.5% padding) and LLaVA-NeXT-Mistral-7B's (dh 128, 32 query heads
# over 8 KV heads) at batch 2 x 2048, each timed
ZAMBA_FLASH_CASES = [
    (ZAMBA, (4, 2048, 2048, 32, 32, 80), True, ("bfloat16", "float32"))]
LLAVA_FLASH_CASES = [
    (LLAVA, (2, 2048, 2048, 32, 8, 128), True, ("bfloat16", "float32"))]

# The SSD intra-chunk block (B7) against its plain version on the same
# inputs: y sums the same fp32 products as the plain einsums in other
# orders (64-wide tiles against whole chunks), so within 1e-5 of its
# largest entry; every gradient within 1e-4, as dcums is a row sum minus a
# column sum of T = dS * CB that cancel on the diagonal, and dB, dC sum
# over a group's heads.  bf16 outputs (dx, db, dc of bf16 inputs) each
# within one bf16 ulp of itself plus the same share of the largest entry.
TOL_SSD = 1e-5
TOL_SSD_GRAD = 1e-4
# (name, (B, S, H, G, P, N, chunk), dtypes, dY bf16-valued): Mamba2-370m's
# block at batch 8 x 1024 (timed, bf16 as the model feeds it), then G > 1,
# S < chunk and no multiple of the 64-row tiles, P and N no multiple of 16;
# dY bf16-valued as the model feeds it, then at the ragged shape an fp32
# dY: the bf16 kernels split dY into hi + lo and skip the lo products only
# where a tile's lo half is all zero, so this case holds the split branch
RAGGED_SSD = (2, 200, 8, 2, 48, 80, 256)
SSD_CASES = [
    ("mamba2-370m", (8, 1024, 32, 1, 64, 128, 256),
     ("bfloat16", "float32"), True),
    ("ragged", RAGGED_SSD, ("float32", "bfloat16"), True),
    ("ragged, dY not bf16-valued", RAGGED_SSD, ("bfloat16",), False)]
SSD_LAYERS = 48
MAMBA = "mamba2-370m"
# Zamba2-2.7B's Mamba2 block at batch 4 x 2048: 80 heads of P 64, N 64 (the
# 64-wide instances), G 1 (timed)
ZAMBA_SSD_CASES = [
    (ZAMBA, (4, 2048, 80, 1, 64, 64, 256), ("bfloat16", "float32"), True)]

# Optimizer-state MB of adapprox_kmax_int8 at b1 = 0.9 as the JAX package's
# own benchmarks/bench_memory.py::state_mb counts it (tier-1's
# tests/test_torch_quantized.py recomputes it).  BENCH_memory.json's 540.1 and
# 1547.0 predate its per-256-row-block (scale, zero) codec: with one
# absmax scale per column they come out at 540.055 and 1546.991.
INT8_STATE_MB = {"gpt2-117m": 541.254944, "gpt2-345m": 1550.658976}
# Mamba2-370m's optimizer-state MB at b1 = 0.9, the same count
# (jax.eval_shape of the state): mixed groups cost more than AdamW, as the
# untied lm_head (1024, 50280) passes the "embeddings" rule and its
# count-min table (4 x 2048 x 50280 fp32) is 8x the leaf.
MAMBA_STATE_MB = {"mixed_groups": 3780.064032, "adamw": 3358.601224}


T0 = time.monotonic()


def phase(title: str) -> None:
    """Print a phase's heading with the seconds since the script began."""
    print(f"{title} (t = {time.monotonic() - T0:.1f} s)", flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def events_ms(fn, reps: int = 10) -> float:
    """Mean time per call between CUDA events around ``reps`` calls: the
    stream's time, which includes launch gaps where the host is slower
    than the card."""
    import torch
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, kernel: str | None = None, reps: int = 20,
              profiles: int = 3) -> float:
    """Device time per call from torch.profiler: the kernels whose name
    contains ``kernel``, or every kernel the call launches, as the median
    over ``profiles`` profiles of ``reps`` calls each, every kernel and
    plain version alike.  A profile that records no device time at all
    (CUPTI can drop microsecond kernels) is left out of the median; with
    none left it returns 0.0 and the caller falls back to events.  Fails
    when a profile records device time but no kernel named ``kernel``: a
    name that matches nothing is a stale lookup, not 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = averages(prof)
        us = sum(e.self_device_time_total for e in evs
                 if kernel is None or kernel in e.key)
        if us > 0:
            readings.append(us / reps / 1e3)
        elif kernel is not None and sum(e.self_device_time_total
                                        for e in evs) > 0:
            fail(f"the profiler recorded device time but no kernel named "
                 f"{kernel!r}: {sorted({e.key[:60] for e in evs})}")
    return statistics.median(readings) if readings else 0.0


def time_pair(kern, plain, kernel_name: str | None, rec: dict,
              bound: float, label: str) -> None:
    """Time a kernel (its own device time; with ``kernel_name`` None,
    every kernel the call launches) and its plain version (all its device
    time), print both with the stream times, add to ``rec``."""
    t_k, t_p = device_ms(kern, kernel_name), device_ms(plain)
    e_k, e_p = events_ms(kern), events_ms(plain)
    note = ""
    if t_k == 0.0 or t_p == 0.0:
        note = "; profiler saw no kernel, stream time used"
        t_k, t_p = t_k or e_k, t_p or e_p
    print(f"    timing {label}: kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
          f"bound_ms {bound:.4f} (stream: kernel {e_k:.4f} plain "
          f"{e_p:.4f}{note})")
    rec["ms"] += t_k
    rec["plain_ms"] += t_p
    rec["bound_ms"] += bound


def new_rec() -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}


def bound_ms(flops: float, nbytes: float) -> float:
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def kernel_modules():
    from repro_torch.kernels import (flash_attention, fused_update,
                                     lowrank_update, sketch_update,
                                     srsi_matmul, ssd_chunk)
    return (fused_update, sketch_update, lowrank_update, srsi_matmul,
            flash_attention, ssd_chunk)


def reset_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def launch_counts() -> dict:
    return {k: v for mod in kernel_modules() for k, v in mod.LAUNCHES.items()}


def expected_launches(kind: str, steps: int, folds: int, n_fact: int,
                      n_leaves: int, n_sk: int, attn_layers: int = 0,
                      ssd_layers: int = 0, fwd_per_layer: int = 1,
                      n_wide: int = 0,
                      factored_steps: int | None = None) -> dict:
    """Launches of ``steps`` train steps (``folds`` of them fold steps)
    on a path: ``fused`` and ``int8`` launch pass 1 per factored call (a
    leaf, or a bucket of same-shape leaves) and pass 2 per Adapprox call
    every step (``int8``: every pass 1 is the int8 variant), and on fold
    steps the transposed square-and-matmul per call of the ``n_wide``
    whose factors are wider than pass 1's fold takes; ``kernels``
    (use_kernels) the single-pass update per factored leaf every step and
    the transposed square-and-matmul per factored leaf on fold steps;
    ``none`` (Adafactor, CAME, AdamW) no optimizer kernel; the sketch two
    launches per sketched leaf every step; flash attention, on
    ``attn_layers`` layers (all of them under attn_impl "chunked", none on
    the naive path), and the SSD block, on the ``ssd_layers`` Mamba2
    layers, each backward kernel once per layer every step and the
    forward ``fwd_per_layer`` times (2 under remat, whose backward runs
    the layer's forward again).  ``factored_steps`` (default ``steps``):
    the steps before the xi watchdog demoted every factored leaf, after
    which they run the plain dense second moment and launch neither
    pass."""
    want = dict.fromkeys(launch_counts(), 0)
    want.update(sketch_scatter=steps * n_sk, sketch_query=steps * n_sk)
    want.update(flash_fwd=steps * attn_layers * fwd_per_layer,
                flash_bwd_dq=steps * attn_layers,
                flash_bwd_dkdv=steps * attn_layers)
    want.update(ssd_fwd=steps * ssd_layers * fwd_per_layer,
                ssd_bwd_rows=steps * ssd_layers,
                ssd_bwd_cols=steps * ssd_layers)
    if kind == "kernels":
        want.update(lowrank_update=steps * n_fact, sq_matmul_t=folds * n_fact)
    elif kind != "none":
        fs = steps if factored_steps is None else factored_steps
        want.update(fused_precond=fs * n_fact,
                    fused_apply=fs * n_fact + steps * (n_leaves - n_fact),
                    sq_matmul_t=folds * n_wide)
        if kind == "int8":
            want["fused_precond_int8"] = fs * n_fact
    return want


def factor_width(leaf) -> int:
    """r of a factored Adapprox leaf, fp32 or int8."""
    return getattr(leaf.q, "q8", leaf.q).shape[-1]


def adapprox_calls(state, bucketed: bool) -> tuple[int, int, int]:
    """(factored calls, pass-2 calls, factored calls past pass 1's fold
    width) a step of an optimizer state makes: a factored call is one
    leaf or, ``bucketed``, one bucket of leaves of one shape; a pass-2
    call a factored call or a dense Adapprox leaf.  (0, 0, 0) without an
    Adapprox stage."""
    from repro_torch.core.adapprox import AdapproxState
    from repro_torch.core.types import find_states
    from repro_torch.kernels.ops import fold_in_pass1
    subs = list(find_states(state, AdapproxState))
    if not subs:
        return 0, 0, 0
    leaves = subs[0].leaves
    fact = [leaf for leaf in leaves if hasattr(leaf, "q")]

    def shape(leaf):      # the parameter's: (*batch, m) of Q, n of U
        q, u = getattr(leaf.q, "q8", leaf.q), getattr(leaf.u, "q8", leaf.u)
        return tuple(q.shape[:-1]) + (u.shape[-2],)

    calls = (list({shape(leaf): leaf for leaf in fact}.values())
             if bucketed else fact)
    wide = sum(not fold_in_pass1(factor_width(leaf)) for leaf in calls)
    return len(calls), len(calls) + len(leaves) - len(fact), wide


def bf16_ulp(x):
    """The spacing of bf16 at each |x| (8 significant bits)."""
    import torch
    mag = torch.clamp_min(x.abs(), torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def hold(what: str, labels, tols, got, want, rec: dict, again=None) -> str:
    """Fail unless each output of a kernel is finite and within its
    tolerance (relative to the largest entry of the plain output) of the
    plain version's and, given ``again`` (a second launch), bitwise equal
    to it.  A bf16 output is held entry by entry instead: within one bf16
    ulp of the entry plus its tolerance of the largest entry.  The first
    output's error goes into ``rec``.  Returns the errors as text."""
    import torch
    again = again if again is not None else [None] * len(labels)
    errs = []
    for label, tol, a, a2, b in zip(labels, tols, got, again, want):
        if (a is None) != (b is None):
            fail(f"{what}: {label} missing")
        if a is None:
            continue
        if a2 is not None and not torch.equal(a, a2):
            fail(f"{what}: two launches differ in {label}")
        if not bool(torch.isfinite(a).all()):
            fail(f"{what}: {label} not finite")
        ab, rel = rel_err(a, b)
        errs.append(f"{label} {ab:.3e} ({rel:.2e})")
        if a.dtype == torch.bfloat16:
            a32, b32 = a.float(), b.float()
            bound = (bf16_ulp(torch.maximum(a32.abs(), b32.abs()))
                     + tol * float(b32.abs().max()))
            worst = float(((a32 - b32).abs() / bound).max())
            errs[-1] += f" {worst:.3f} of its per-entry bf16 bound"
            if worst > 1.0:
                fail(f"{what}: {label} exceeds one bf16 ulp + {tol} of the "
                     f"largest entry by {worst:.3f}x")
        elif rel > tol:
            fail(f"{what}: {label} rel err {rel:.3e} > {tol}")
        if label == labels[0]:
            rec["max_abs_err"] = max(rec["max_abs_err"], ab)
    return ", ".join(errs) + ("; bitwise repeatable" if again[0] is not None
                              else "")


def arch_config(arch: str, layers: int | None = None, **over):
    """``arch``'s full-width config, its depth cut to ``layers`` and the
    fields ``over`` set (the launcher has no depth flag, as the JAX
    launcher has none)."""
    from repro_torch.configs.archs import get_config
    if layers is not None:
        over["n_layers"] = layers
    return dataclasses.replace(get_config(arch), **over)


@contextlib.contextmanager
def depth_cut(layers: int, **over):
    """Within it, the launcher builds its ``--arch`` at full width with the
    depth cut to ``layers`` and the fields ``over`` set
    (:func:`arch_config`)."""
    from repro_torch.launch import train as launcher
    full = launcher.get_config
    launcher.get_config = lambda arch: arch_config(arch, layers, **over)
    try:
        yield
    finally:
        launcher.get_config = full


def main_path_leaves(device, mixed: bool = False, arch: str = "gpt2-117m",
                     k_max: int = 128, layers: int | None = None):
    """(factored [(name, shape, r)], dense [(name, size)]) of the Adapprox
    leaves of ``arch`` (GPT-2 117M, Mamba2-370m, or ``layers`` deep) under
    the launcher's optimizer, read from the optimizer state itself: with
    --no-mixed-groups (Adapprox on every leaf) or, ``mixed``, on its
    default mixed groups (GPT-2: the six block matrices; Mamba2: in_proj
    and out_proj); ``k_max=10**9`` gives the paper's k_max, min(m, n) /
    4."""
    import torch
    from repro_torch import tree
    from repro_torch.core.adapprox import adapprox_state
    from repro_torch.core.build import build_optimizer
    from repro_torch.core.factored import FactoredLeaf
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model

    cfg = arch_config(arch, layers)
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(0))
    flat = tree.flatten(params)
    state = build_optimizer(dataclasses.replace(optimizer_config(
        "adapprox", 12, 3e-3, refresh_every=5, fused_update=True,
        mixed_groups=mixed), k_max=k_max)).init(flat)
    names = ([k for k, lab in zip(flat, state.labels) if lab == "factored"]
             if mixed else list(flat))
    fact, dense = [], []
    for name, leaf in zip(names, adapprox_state(state).leaves):
        if isinstance(leaf, FactoredLeaf):
            fact.append((name, tuple(flat[name].shape), leaf.q.shape[-1]))
        else:
            dense.append((name, flat[name].numel()))
    del params, flat, state
    torch.cuda.empty_cache()
    return fact, dense


def rel_err(got, want) -> tuple[float, float]:
    import torch
    got, want = got.detach().float(), want.detach().float()
    diff = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    return diff, diff / max(scale, 1e-30)


PRECOND_OUT = ("u_hat", "vfro", "usq", "m1dot", "m1sq", "yfold")
PRECOND_TOL = (TOL_PRECOND, TOL_SUMS, TOL_SUMS, TOL_SUMS, TOL_SUMS,
               TOL_SUMS)
# (m, n, r) of the ragged checks: m and n no multiple of 64 or 256, r no
# multiple of 16 (the JAX package's own ragged test shapes)
RAGGED = [(130, 258, 3), (300, 180, 6), (257, 129, 5)]


def pass1_bound(shape, r, products: int, elementwise: int,
                int8: bool = False, fold: bool = False,
                split: bool = True) -> tuple[float, float, float]:
    """Bound in ms of one pass-1 call (B1, or B4 with ``products=1``), with
    its operations' and its bytes' times.  Operations: ``products``
    products of 2 m n r each (Q U^T, and the fold's (G^2)^T Q), priced at
    the arithmetic that holds
    ``TOL_PRECOND``: the factors and G^2 are fp32, one tf32 product misses
    it, so the kernels split each operand into two tf32 terms and run three
    products (big.big + big.small + small.big) at the dense TF32 peak;
    plus ``elementwise`` fp32 operations a G entry (V, its root, the
    division, the sums) and, ``int8``, 3 a factor entry to dequantize, at
    the fp32 peak.  ``split=False`` gives the earlier pricing, every
    product at the fp32 peak.  Bytes: G read and u_hat written once, the
    factors read once (int8: one byte an entry and the codec's scales and
    zeros) and, ``fold``, the (n, r) fold written."""
    *bd, m, n = shape
    L = math.prod(bd)
    mmr = products * 2 * L * m * n * r
    fp32 = L * m * n * elementwise + (3 * L * (m + n) * r if int8 else 0)
    ops_s = (3 * mmr / PEAK_TF32_FLOPS + fp32 / PEAK_FP32_FLOPS if split
             else (mmr + fp32) / PEAK_FP32_FLOPS)
    fbytes = 4 * (m + n) * r
    if int8:
        fbytes = (m + n) * r + 8 * r * (-(-m // 256) + -(-n // 256))
    bytes_s = L * (8 * m * n + fbytes + (4 * n * r if fold else 0)) \
        / PEAK_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), 1e3 * ops_s, 1e3 * bytes_s


def precond_bound(shape, r, int8: bool = False,
                  split: bool = True) -> tuple[float, float, float]:
    """Pass 1's main-path variant: the fold rider, no guidance, no vfro --
    two products, ~10 fp32 operations a G entry."""
    return pass1_bound(shape, r, 2, 10, int8=int8, fold=True, split=split)


def lowrank_bound(shape, r,
                  split: bool = True) -> tuple[float, float, float]:
    """The single-pass update: Q U^T, ~8 fp32 operations a G entry."""
    return pass1_bound(shape, r, 1, 8, split=split)


def add_bound(rec: dict, new: tuple, old: tuple, name: str) -> float:
    """Print a pass-1 bound beside its earlier pricing and add both to
    ``rec`` (the earlier as ``bound_fp32_ms``), with the operations' and
    the bytes' shares of the new one and which of the two sums bounds the
    kernel; return the new bound."""
    for key, v in (("bound_fp32_ms", old[0]), ("bound_ops_ms", new[1]),
                   ("bound_bytes_ms", new[2])):
        rec[key] = rec.get(key, 0.0) + v
    rec["bound_by"] = ("operations" if rec["bound_ops_ms"]
                       >= rec["bound_bytes_ms"] else "bytes")
    by = "operations" if new[1] >= new[2] else "bytes"
    print(f"    bound {name} {new[0]:.4f} ms ({by}: 3xTF32 at the TF32 peak; "
          f"every product at the fp32 peak: {old[0]:.4f})")
    return new[0]


def check_precond(fact, device, ragged: bool = True):
    """Pass 1 against its plain version at every factored leaf shape and,
    with ``ragged``, at the ragged shapes, each variant's two launches
    bitwise equal; the main path's variant is timed per leaf."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(1)
    rec = new_rec()
    cases = fact + ([("ragged", (m, n), r) for m, n, r in RAGGED]
                    if ragged else [])
    for name, shape, r in cases:
        *bd, m, n = shape
        bd = tuple(bd)
        # Q, U uniform in [0, 1e-5): b2 Q U^T ~ (1 - b2) G^2, no cancellation
        q = torch.rand(bd + (m, r), generator=gen, device=device) * 1e-5
        u = torch.rand(bd + (n, r), generator=gen, device=device) * 1e-5
        g = torch.randn(bd + (m, n), generator=gen, device=device) * 1e-3
        m1 = torch.randn(bd + (m, n), generator=gen, device=device) * 0.3
        for variant, kw in (("plain", {}), ("guided", {"m1": m1}),
                            ("fold", {"with_fold": True}),
                            ("guided-fold", {"m1": m1, "with_fold": True})):
            call = lambda: ops.fused_precond(q, u, g, B2, EPS,
                                             with_vfro=True, **kw)
            got, again = call(), call()
            want = ref.fused_precond(q, u, g, B2, EPS, with_vfro=True, **kw)
            torch.cuda.synchronize()
            errs = hold(f"fused_precond[{variant}] {name} {shape}",
                        PRECOND_OUT, PRECOND_TOL, got, want, rec, again)
            print(f"  fused_precond[{variant}] {name} {shape} r={r}: {errs}")
            del got, again, want      # a full-width stack's are GBs each
        if name == "ragged":
            continue
        # the main path's variant: fold rider, no guidance, no vfro
        kern = lambda: ops.fused_precond(q, u, g, B2, EPS, with_vfro=False,
                                         with_fold=True)
        plain = lambda: ref.fused_precond(q, u, g, B2, EPS, with_vfro=False,
                                          with_fold=True)
        bound = add_bound(rec, precond_bound(shape, r),
                          precond_bound(shape, r, split=False), name)
        time_pair(kern, plain, "precond_kernel", rec, bound, name)
        del q, u, g, m1
    return rec


def check_precond_int8(fact, device):
    """The int8 pass 1 on quantized factors (the codec of a random Q and U)
    against the plain pass 1 on the same factors dequantized, at every
    factored leaf of the mixed path (plain and fold; guided, and guided
    with the fold, at the first) and at the ragged shapes (all four
    variants); two launches bitwise equal.  The main path's variant (fold) is timed per leaf."""
    import torch
    from repro_torch.core.quantized import dequantize, quantize
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(4)
    rec = new_rec()
    cases = fact + [("ragged", (m, n), r) for m, n, r in RAGGED]
    for i, (name, shape, r) in enumerate(cases):
        *bd, m, n = shape
        bd = tuple(bd)
        q = quantize(torch.rand(bd + (m, r), generator=gen, device=device)
                     * 1e-5)
        u = quantize(torch.rand(bd + (n, r), generator=gen, device=device)
                     * 1e-5)
        g = torch.randn(bd + (m, n), generator=gen, device=device) * 1e-3
        m1 = torch.randn(bd + (m, n), generator=gen, device=device) * 0.3
        variants = [("plain", {}), ("fold", {"with_fold": True})]
        if i == 0 or name == "ragged":
            variants += [("guided", {"m1": m1}),
                         ("guided-fold", {"m1": m1, "with_fold": True})]
        for variant, kw in variants:
            call = lambda: ops.fused_precond(q, u, g, B2, EPS,
                                             with_vfro=True, **kw)
            got, again = call(), call()
            want = ref.fused_precond(dequantize(q), dequantize(u), g, B2, EPS,
                                     with_vfro=True, **kw)
            torch.cuda.synchronize()
            errs = hold(f"fused_precond_int8[{variant}] {name} {shape}",
                        PRECOND_OUT, PRECOND_TOL, got, want, rec, again)
            print(f"  fused_precond_int8[{variant}] {name} {shape} r={r}: "
                  f"{errs}")
        if name != "ragged":
            kern = lambda: ops.fused_precond(q, u, g, B2, EPS,
                                             with_vfro=False, with_fold=True)
            plain = lambda: ref.fused_precond(dequantize(q), dequantize(u), g,
                                              B2, EPS, with_vfro=False,
                                              with_fold=True)
            bound = add_bound(rec, precond_bound(shape, r, int8=True),
                              precond_bound(shape, r, int8=True, split=False),
                              name)
            time_pair(kern, plain, "precond_kernel", rec, bound, name)
        del q, u, g, m1
    return rec


def check_precond_kmax(fact, device, int8: bool = False):
    """Pass 1 with the fold at the paper's k_max (r = 192 at GPT-2 117M's
    block matrices, 256 at Mamba2-370m's), past ``R_MAX``: the dispatch
    runs pass 1 without the fold and the fold through sq_matmul_t (on the
    dequantized Q for ``int8`` factors).  u_hat held to TOL_PRECOND, the
    sums to TOL_SUMS and the fold to TOL_MATMUL against the plain pass 1
    (int8: on the dequantized factors), two calls bitwise equal; the
    guided variant at the first leaf.  Each leaf's route is timed as the
    device sees both of its kernels, beside the function's bound (the
    fold as pass 1's rider, ``precond_bound``) and the route's own (pass 1
    without the fold plus ``sq_matmul_bound``)."""
    import torch
    from repro_torch.core.quantized import dequantize, quantize
    from repro_torch.kernels import fused_update as K
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(7)
    rec = new_rec()
    rec["fold_ms"] = 0.0
    tols = PRECOND_TOL[:-1] + (TOL_MATMUL,)
    tag = "fused_precond_int8" if int8 else "fused_precond"
    for i, (name, shape, r) in enumerate(fact):
        if r <= K.R_MAX or ops.fold_in_pass1(r):
            fail(f"[kernels-kmax] {name}: r = {r} is within pass 1's fold")
        *bd, m, n = shape
        bd = tuple(bd)
        q = torch.rand(bd + (m, r), generator=gen, device=device) * 1e-5
        u = torch.rand(bd + (n, r), generator=gen, device=device) * 1e-5
        g = torch.randn(bd + (m, n), generator=gen, device=device) * 1e-3
        m1 = torch.randn(bd + (m, n), generator=gen, device=device) * 0.3
        if int8:
            q, u = quantize(q), quantize(u)
        qd, ud = (dequantize(q), dequantize(u)) if int8 else (q, u)
        variants = [("fold", {})] + ([("guided-fold", {"m1": m1})]
                                     if i == 0 else [])
        for variant, kw in variants:
            call = lambda: ops.fused_precond(q, u, g, B2, EPS, with_vfro=True,
                                             with_fold=True, **kw)
            got, again = call(), call()
            want = ref.fused_precond(qd, ud, g, B2, EPS, with_vfro=True,
                                     with_fold=True, **kw)
            torch.cuda.synchronize()
            errs = hold(f"{tag}[{variant}] kmax {name} {shape}", PRECOND_OUT,
                        tols, got, want, rec, again)
            print(f"  {tag}[{variant}] {name} {shape} r={r}: {errs}")
        kern = lambda: ops.fused_precond(q, u, g, B2, EPS, with_vfro=False,
                                         with_fold=True)
        plain = lambda: ref.fused_precond(qd, ud, g, B2, EPS,
                                          with_vfro=False, with_fold=True)
        L = math.prod(bd)
        route = (pass1_bound(shape, r, 1, 10, int8=int8)[0]
                 + sq_matmul_bound(L, m, n, r))
        bound = add_bound(rec, precond_bound(shape, r, int8=int8),
                          precond_bound(shape, r, int8=int8, split=False),
                          name)
        rec["route_bound_ms"] = rec.get("route_bound_ms", 0.0) + route
        fold = device_ms(kern, "sq_matmul_kernel")
        rec["fold_ms"] += fold
        print(f"    route: pass 1 without the fold + sq_matmul_t, bound "
              f"{route:.4f} ms; sq_matmul_t alone {fold:.4f} ms")
        time_pair(kern, plain, None, rec, bound, f"{name} (both kernels)")
        del q, u, g, m1, qd, ud
    return rec


def check_lowrank(fact, device):
    """The single-pass update against its plain version at every factored
    leaf of the mixed path and at the ragged shapes; two launches bitwise
    equal.  Timed per leaf of the main path."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(5)
    rec = new_rec()
    for name, shape, r in fact + [("ragged", (m, n), r)
                                  for m, n, r in RAGGED]:
        *bd, m, n = shape
        bd = tuple(bd)
        # as for pass 1: no cancellation in Q U^T
        q = torch.rand(bd + (m, r), generator=gen, device=device) * 1e-5
        u = torch.rand(bd + (n, r), generator=gen, device=device) * 1e-5
        g = torch.randn(bd + (m, n), generator=gen, device=device) * 1e-3
        kern = lambda: ops.lowrank_update(q, u, g, B2, EPS, with_frob=True)
        plain = lambda: ref.lowrank_update(q, u, g, B2, EPS)
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        errs = hold(f"lowrank_update {name} {shape}", ("out", "vfro"),
                    (TOL_PRECOND, TOL_SUMS), got, want, rec, again)
        print(f"  lowrank_update {name} {shape} r={r}: {errs}")
        if name != "ragged":
            bound = add_bound(rec, lowrank_bound(shape, r),
                              lowrank_bound(shape, r, split=False), name)
            time_pair(kern, plain, "lowrank_update_kernel", rec, bound, name)
        del q, u, g
    return rec


def sq_matmul_bound(L: int, m: int, n: int, s: int,
                    split: bool = True) -> float:
    """Bound in ms of one square-and-matmul call, priced at the arithmetic
    that holds ``TOL_MATMUL``: G^2 and X are fp32, and one tf32 product
    misses the tolerance, so the kernel splits each operand into two tf32
    terms and runs three products (big.big + big.small + small.big), 3 x
    2 m n s operations at the dense TF32 peak.  Bytes: G, X read and Y
    written once, 4 L (m n + (m + n) s).  ``split=False`` gives the earlier
    pricing, one fp32 product (and the square) at the fp32 peak."""
    nbytes = 4 * L * (m * n + (m + n) * s)
    if not split:
        return bound_ms(L * m * n * (2 * s + 1), nbytes)
    return 1e3 * max(3 * 2 * L * m * n * s / PEAK_TF32_FLOPS,
                     nbytes / PEAK_BYTES_PER_S)


def check_sq_matmul(fact, device):
    """(G * G) X and (G * G)^T Y against their plain versions at every
    factored leaf of the mixed path (s = r) and at the ragged shapes; two
    launches bitwise equal.  The main path's orientation (transposed, the
    fold) is timed per leaf beside its plain version, its bound (and the
    earlier fp32 pricing) and, as the library yardstick, torch.matmul on a
    pre-squared G -- two calls where the kernel is one, with only the
    matmul timed."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(6)
    rec = new_rec()
    rec["library_ms"] = 0.0
    for name, shape, s in fact + [("ragged", (m, n), r)
                                  for m, n, r in RAGGED]:
        *bd, m, n = shape
        bd = tuple(bd)
        g = torch.randn(bd + (m, n), generator=gen, device=device) * 1e-3
        x = torch.randn(bd + (n, s), generator=gen, device=device)
        y = torch.randn(bd + (m, s), generator=gen, device=device)
        for variant, kern, plain in (
                ("plain", lambda: ops.sq_matmul(g, x),
                 lambda: ref.sq_matmul(g, x)),
                ("transposed", lambda: ops.sq_matmul_t(g, y),
                 lambda: ref.sq_matmul_t(g, y))):
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            errs = hold(f"sq_matmul[{variant}] {name} {shape}", ("out",),
                        (TOL_MATMUL,), (got,), (want,), rec, (again,))
            print(f"  sq_matmul[{variant}] {name} {shape} s={s}: {errs}")
        if name == "ragged":
            continue
        L = math.prod(bd)
        bound = sq_matmul_bound(L, m, n, s)
        old = sq_matmul_bound(L, m, n, s, split=False)
        rec["bound_fp32_ms"] = rec.get("bound_fp32_ms", 0.0) + old
        print(f"    bound {bound:.4f} ms (3xTF32 at the TF32 peak; one fp32 "
              f"product at the fp32 peak: {old:.4f})")
        sub = new_rec()
        time_pair(lambda: ops.sq_matmul(g, x), lambda: ref.sq_matmul(g, x),
                  "sq_matmul_kernel", sub, bound, f"{name} (not transposed)")
        time_pair(lambda: ops.sq_matmul_t(g, y),
                  lambda: ref.sq_matmul_t(g, y), "sq_matmul_kernel", rec,
                  bound, f"{name} (transposed)")
        g2 = g * g
        lib = device_ms(lambda: torch.matmul(g2.transpose(-1, -2), y)) \
            or events_ms(lambda: torch.matmul(g2.transpose(-1, -2), y))
        print(f"    library: torch.matmul on a pre-squared G {lib:.4f} ms")
        rec["library_ms"] += lib
        del g, x, y, g2
    return rec


def check_apply(fact, dense, device):
    """Pass 2 against its plain version at every leaf shape: factored
    leaves (shared and two-output) and dense leaves viewed as (1, size)."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(2)
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    cases = [(name, shape, sh) for name, shape, _ in fact
             for sh in (True, False)]
    cases += [(name, (1, size), True) for name, size in dense]
    for name, shape, shared in cases:
        *bd, m, n = shape
        bd = tuple(bd)
        u_hat = torch.randn(shape, generator=gen, device=device)
        m1 = torch.randn(shape, generator=gen, device=device) * 0.3
        denom = 1.0 + torch.rand(bd, generator=gen, device=device)
        os_ = 0.5 + torch.rand(bd, generator=gen, device=device)
        ss = os_ if shared else torch.ones_like(os_)
        m1_k = m1.clone()
        got = ops.fused_apply(u_hat, m1_k, denom, B1, os_, ss,
                              shared_out=shared)
        want = ref.fused_apply(u_hat, m1, denom, B1, os_, ss)
        torch.cuda.synchronize()
        if shared and not (got[0] is got[1]
                           and got[1].data_ptr() == m1_k.data_ptr()):
            fail(f"fused_apply[shared] {name}: m_out is not m1 updated "
                 f"in place")
        variant = "shared" if shared else "two-output"
        if name in dict(dense):
            variant = "dense"
        errs = []
        for label, a, b in (("m_out", got[0], want[0]),
                            ("m1_new", got[1], want[1])):
            ab, rel = rel_err(a, b)
            errs.append(f"{label} {ab:.3e} ({rel:.2e})")
            if rel > TOL_APPLY:
                fail(f"fused_apply[{variant}] {name} {shape}: {label} rel err "
                     f"{rel:.3e} > {TOL_APPLY}")
            rec["max_abs_err"] = max(rec["max_abs_err"], ab)
        print(f"  fused_apply[{variant}] {name} {shape}: " + ", ".join(errs))
        if shared and name not in dict(dense):
            # the variant a guarded Adapprox runs (in_place=False): the
            # new m1 into a fresh buffer, the one given left as it was
            m1_in = m1.clone()
            fresh = ops.fused_apply(u_hat, m1_in, denom, B1, os_, ss,
                                    shared_out=True, in_place=False)
            torch.cuda.synchronize()
            if not torch.equal(m1_in, m1):
                fail(f"fused_apply[fresh] {name}: wrote into the m1 it was "
                     f"given")
            if (fresh[1].data_ptr() == m1_in.data_ptr()
                    or not torch.equal(fresh[1], got[1])):
                fail(f"fused_apply[fresh] {name}: not bitwise the in-place "
                     f"result in a new buffer")
            print(f"  fused_apply[fresh] {name} {shape}: m1 untouched, "
                  f"bitwise the in-place result")
        if shared:      # the main path's variant, timed once per leaf
            kern = lambda: ops.fused_apply(u_hat, m1_k, denom, B1, os_, ss,
                                           shared_out=True)
            plain = lambda: ref.fused_apply(u_hat, m1, denom, B1, os_, ss)
            time_pair(kern, plain, "apply_kernel", rec,
                      1e3 * 12 * math.prod(shape) / PEAK_BYTES_PER_S, name)
            if name not in dict(dense):
                def kern_fresh():
                    ops.fused_apply(u_hat, m1_k, denom, B1, os_, ss,
                                    shared_out=True, in_place=False)
                t_in = device_ms(kern, "apply_kernel")
                t_fr = device_ms(kern_fresh, "apply_kernel")
                rec["fresh_ms"] = rec.get("fresh_ms", 0.0) + t_fr
                rec["inplace_ms"] = rec.get("inplace_ms", 0.0) + t_in
                print(f"    timing {name} under the guard (fresh m1): "
                      f"kernel_ms {t_fr:.4f} vs in place {t_in:.4f}; stream "
                      f"{events_ms(kern_fresh):.4f} vs "
                      f"{events_ms(kern):.4f}")
    return rec


def sketch_cases(device, arch: str = "gpt2-117m",
                 expect: tuple = ("embed", "pos_embed"), ragged: bool = True,
                 layers: int | None = None):
    """(name, rows, d, width, depth, seeds) for the sketch kernel checks:
    the sketched leaves of ``arch`` (``layers`` deep) under the launcher's
    mixed groups, read from the optimizer state itself (``expect``: GPT-2
    117M's embed and pos_embed, Mamba2-370m's embed and lm_head, whose
    1024 rows leave most of the 2048 buckets empty, Qwen2-7B's embed and
    lm_head, 3584 rows of 152,064; hash seeds of leaves 0 and 1 of the
    sketch group, seed 0, depth 4, width 2048) and, with ``ragged``, two
    ragged shapes (d = 101 takes the kernels' unvectorized loads)."""
    import torch
    from repro_torch import tree
    from repro_torch.core.build import build_optimizer
    from repro_torch.core.sketch import _leaf_seeds, sketch_state
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model

    flat = tree.flatten(build_model(arch_config(arch, layers)).init(
        torch.Generator(device=device).manual_seed(0)))
    state = build_optimizer(optimizer_config(
        "adapprox", 12, 3e-3, refresh_every=5, fused_update=True,
        mixed_groups=True)).init(flat)
    names = [k for k, lab in zip(flat, state.labels) if lab == "embeddings"]
    cases = [(name, leaf.shape[0], leaf.table.shape[2], leaf.table.shape[1],
              leaf.table.shape[0], leaf.seeds)
             for name, leaf in zip(names, sketch_state(state).leaves)]
    if tuple(c[0] for c in cases) != expect or any(
            c[5] != _leaf_seeds(0, i, 4) for i, c in enumerate(cases)):
        fail(f"mixed groups sketch {[c[:5] for c in cases]}, expected "
             f"{expect} at leaves 0, 1 of the sketch group")
    del flat, state
    torch.cuda.empty_cache()
    if not ragged:
        return cases
    return cases + [("ragged", 1000, 100, 256, 3, _leaf_seeds(0, 0, 3)),
                    ("ragged", 1000, 101, 256, 3, _leaf_seeds(0, 0, 3))]


def check_sketch(cases, device):
    """Scatter + query against the plain version, two launches bitwise
    equal, at every case; the main path's leaves are timed."""
    import torch
    from repro_torch.core.sketch import bucket_indices
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(3)
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, rows, d, width, depth, seeds in cases:
        idx = torch.from_numpy(bucket_indices(rows, width, seeds)).to(device)
        order, offsets = ops.bucket_order(idx, width)
        # (1 - b2) * (~25 squares of unit normals) ~ b2 * table
        table = torch.rand((depth, width, d), generator=gen,
                           device=device) * 0.025
        g = torch.randn((rows, d), generator=gen, device=device)
        kern = lambda: ops.sketch_update(table, g, idx, B2, order=order,
                                         offsets=offsets)
        plain = lambda: ref.sketch_update(table, g, idx, B2)
        first, second, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        errs = []
        for label, a, a2, b in zip(("table", "vhat"), first, second, want):
            if not torch.equal(a, a2):
                fail(f"sketch_update {name}: two launches differ in {label}")
            if not bool(torch.isfinite(a).all()):
                fail(f"sketch_update {name}: {label} not finite")
            ab, rel = rel_err(a, b)
            errs.append(f"{label} {ab:.3e} ({rel:.2e})")
            if rel > TOL_SKETCH:
                fail(f"sketch_update {name} rows={rows} d={d} width={width} "
                     f"depth={depth}: {label} rel err {rel:.3e} > "
                     f"{TOL_SKETCH}")
            rec["max_abs_err"] = max(rec["max_abs_err"], ab)
        print(f"  sketch_update {name} rows={rows} d={d} width={width} "
              f"depth={depth}: " + ", ".join(errs) + "; bitwise repeatable")
        if name != "ragged":
            nbytes = 4 * (2 * rows * d + 2 * depth * width * d + depth * rows)
            time_pair(kern, plain, "sketch_", rec,
                      1e3 * nbytes / PEAK_BYTES_PER_S, name)
        del table, g, idx, order, offsets, first, second, want
    return rec


def attn_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: k_pos <= q_pos, both
    counted from 0, when causal."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def flash_bounds(b, sq, sk, h, kv, dh, causal, dtype, split=True):
    """(forward, backward) bounds in ms of one call.  Operations: the
    forward's two products over the live pairs (q k^T, p v), the
    backward's five (the recomputed q k^T, dO v^T, P^T dO, dS k,
    dS^T q), 2 a multiply-add, priced at the arithmetic that holds
    ``TOL_FLASH``.  With bf16 inputs q k^T and dO v^T are one bf16 product
    each (the scale multiplies the fp32 product, so for every dh), and P
    and dS are fp32: a bf16 P or dS misses the tolerance, so the kernels
    split each into two bf16 terms (hi + lo) and every product with one is
    two bf16 products, all at the bf16 tensor-core peak: three products'
    worth forward, eight backward.  fp32 inputs: every product at the
    fp32 peak.  ``split=False`` gives the earlier pricing of bf16 inputs,
    for comparison: the products with an fp32 operand at the fp32 peak,
    q k^T at the bf16 peak only where the scale is a power of two.  The
    recompute of S and dP in both backward kernels is the design's cost,
    not the function's, and is not priced.  Bytes: the forward reads q,
    k, v and writes o and the fp32 lse, the backward reads q, k, v, o, dO
    and lse and writes dq, dk, dv; at GPT-2 117M's shape they bound
    neither."""
    import torch
    from repro_torch.kernels.ref import attn_scale
    flops = 2 * b * h * dh * attn_pairs(sq, sk, causal)
    bf16 = dtype == torch.bfloat16
    if bf16 and split:
        fwd_s, bwd_s = 3 * flops / PEAK_BF16_FLOPS, 8 * flops / PEAK_BF16_FLOPS
    else:
        qk = PEAK_BF16_FLOPS if bf16 and math.frexp(
            attn_scale(dh))[0] == 0.5 else PEAK_FP32_FLOPS
        dov = PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS
        fwd_s = flops / qk + flops / PEAK_FP32_FLOPS
        bwd_s = flops / qk + flops / dov + 3 * flops / PEAK_FP32_FLOPS
    itemsize = 2 if bf16 else 4
    nq, nk = b * sq * h * dh * itemsize, b * sk * kv * dh * itemsize
    lse = 4 * b * h * sq
    return (1e3 * max(fwd_s, (2 * nq + 2 * nk + lse) / PEAK_BYTES_PER_S),
            1e3 * max(bwd_s, (4 * nq + 4 * nk + lse) / PEAK_BYTES_PER_S))


FLASH_LAYERS = 12   # GPT-2 117M: one launch of each B6 kernel a layer


def hgmma_counts(lib, kernels) -> dict:
    """HGMMA instructions (wgmma in the SASS, ``cuobjdump -sass``) in each
    instantiation of the kernels named in ``kernels`` in library ``lib``,
    by kernel name and template arguments (``<64>``, ``<64,128>``,
    ``<true,2>``; none for a kernel that is no template)."""
    import re
    from repro_torch.kernels import cuda
    tool = Path(cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = None
            for kern in kernels:
                mangled = f"{len(kern)}{kern}I"
                if mangled in line:
                    args = line.split(mangled, 1)[1].split("EEv")[0]
                    vals = re.findall(r"Li(\d+)E|Lb(\d)E", args)
                    name = f"{kern}<" + ",".join(
                        a or ("true" if b == "1" else "false")
                        for a, b in vals) + ">"
                    counts[name] = 0
                elif f"{len(kern)}{kern}E" in line:
                    name = kern
                    counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


FLASH_WGMMA = ("flash_fwd_kernel_wgmma", "flash_bwd_dq_kernel_wgmma",
               "flash_bwd_dkdv_kernel_wgmma")
SSD_WGMMA = ("ssd_fwd_kernel_wgmma", "ssd_bwd_rows_kernel_wgmma",
             "ssd_bwd_cols_kernel_wgmma")


def check_hgmma() -> None:
    """Fail unless every bf16 flash attention kernel (dh 64 and 128), every
    square-and-matmul kernel (both orientations, 64 and 128 columns a
    pass), every bf16 SSD kernel (P and N of 64 and 128), every pass-1
    kernel (guided or not, fold or not, fp32 or int8 factors) and the
    single-pass update kernel holds HGMMA instructions: their products run
    on the tensor cores."""
    from repro_torch.kernels import cuda, flash_attention, fused_update
    from repro_torch.kernels import lowrank_update, srsi_matmul, ssd_chunk
    for what, src, kernels, want in (
            ("bf16 flash attention", flash_attention.SOURCE, FLASH_WGMMA, 6),
            ("square-and-matmul (3xTF32)", srsi_matmul.SOURCE,
             ("sq_matmul_kernel",), 4),
            ("bf16 SSD", ssd_chunk.SOURCE, SSD_WGMMA, 12),
            ("pass-1 (3xTF32)", fused_update.SOURCE, ("precond_kernel",), 8),
            ("single-pass update (3xTF32)", lowrank_update.SOURCE,
             ("lowrank_update_kernel",), 1)):
        counts = hgmma_counts(cuda.library(src), kernels)
        print(f"  HGMMA instructions in the {what} kernels: {counts}")
        if len(counts) != want or not all(counts.values()):
            fail(f"a {what} kernel runs no wgmma (expected {want} kernels, "
                 f"each with HGMMA): {counts}")


def check_flash(device, cases=FLASH_CASES, timed: str = "gpt2-117m",
                layers: int = FLASH_LAYERS):
    """Flash attention's forward and backward kernels against their plain
    versions on the same inputs, each kernel launched twice and compared
    bitwise, at each of ``cases``: by default GPT-2 117M's shape (8, 1024,
    12, 64), causal, in bf16 (as the model feeds them) and in fp32, ragged
    GQA shapes (S 1000, dh 80, 8 query heads over 2 KV heads; causal, and
    full attention with Sq != Sk), both dtypes, and dh 60 in bf16;
    ``DENSE_FLASH_CASES``: Qwen2-7B's (2, 2048, 28 over 4, 128).  Then, at
    the shape named ``timed``, each kernel's device time beside its bound
    and its plain version's, and the library yardstick that the port never
    calls: scaled_dot_product_attention forward and forward+backward, fp32
    and bf16; for bf16, the times per call and per step of ``layers``
    layers beside the bound, the bound before the hi/lo pricing and SDPA.
    Returns (forward, backward) records, times per call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    fwd_rec, bwd_rec = new_rec(), new_rec()
    for name, (b, sq, sk, h, kv, dh), causal, dtypes in cases:
        for dt in (getattr(torch, d) for d in dtypes):
            rnd = lambda *shape: torch.randn(shape, generator=gen,
                                             device=device).to(dt)
            q, k, v = rnd(b, sq, h, dh), rnd(b, sk, kv, dh), rnd(b, sk, kv, dh)
            do = rnd(b, sq, h, dh)
            gtol = TOL_FLASH_GRAD if dt == f32 else TOL_FLASH
            what = f"flash_attention {name} {tuple(q.shape)} {dt}"
            fwd = lambda: ops.flash_attention_fwd(q, k, v, causal)
            got, again = fwd(), fwd()
            want = ref.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            errs = hold(f"{what} fwd", ("out", "lse"), (TOL_FLASH,) * 2,
                        got, want, fwd_rec, again)
            print(f"  {what} causal={causal} fwd: {errs}")
            o, lse = got
            bwd = lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
            got, again = bwd(), bwd()
            want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            errs = hold(f"{what} bwd", ("dq", "dk", "dv"), (gtol,) * 3, got,
                        want, bwd_rec, again)
            print(f"  {what} causal={causal} bwd: {errs}")
            del got, again, want
            if name != timed:
                continue
            b_fwd, b_bwd = flash_bounds(b, sq, sk, h, kv, dh, causal,
                                        q.dtype)
            plain_fwd = lambda: ref.flash_attention(q, k, v, causal)
            plain_bwd = lambda: ref.flash_attention_bwd(q, k, v, o, lse, do,
                                                        causal)
            if dt == bf16:      # the main path's dtype goes in the records
                time_pair(fwd, plain_fwd, "flash_fwd_kernel", fwd_rec, b_fwd,
                          f"{name} bf16 fwd")
                time_pair(bwd, plain_bwd, "flash_bwd", bwd_rec, b_bwd,
                          f"{name} bf16 bwd (both kernels)")
                for kern in ("dq", "dkdv"):
                    bwd_rec[kern + "_ms"] = device_ms(
                        bwd, f"flash_bwd_{kern}_kernel")
                print(f"    timing bwd by kernel: dq {bwd_rec['dq_ms']:.4f}"
                      f" ms, dkdv {bwd_rec['dkdv_ms']:.4f} ms")
            else:               # fp32: the function SDPA computes in fp32
                fwd_rec["fp32_ms"] = device_ms(fwd, "flash_fwd_kernel")
                bwd_rec["fp32_ms"] = device_ms(bwd, "flash_bwd")
                print(f"    timing fp32 inputs: fwd {fwd_rec['fp32_ms']:.4f} "
                      f"ms, bwd {bwd_rec['fp32_ms']:.4f} ms")
            # the yardstick, (B, H, S, dh) as SDPA takes it
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=kv != h)

            def sdpa_fwd():
                with torch.no_grad():
                    return sdpa()

            def sdpa_fwd_bwd():
                return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

            t_f = device_ms(sdpa_fwd) or events_ms(sdpa_fwd)
            t_fb = device_ms(sdpa_fwd_bwd) or events_ms(sdpa_fwd_bwd)
            tag = "fp32" if dt == f32 else "bf16"
            print(f"    library: scaled_dot_product_attention {tag} fwd "
                  f"{t_f:.4f} ms, fwd+bwd {t_fb:.4f} ms")
            key = "library_ms" if dt == f32 else "library_bf16_ms"
            fwd_rec[key] = t_f
            bwd_rec[key] = t_fb - t_f
            if dt == bf16:
                old_f, old_b = flash_bounds(b, sq, sk, h, kv, dh, causal,
                                            q.dtype, split=False)
                both = lambda x: f"{x:.4f} ({x * layers:.4f})"
                print(f"    bf16 ms per call (per step of {layers} "
                      f"layers): fwd {both(fwd_rec['ms'])}, dQ "
                      f"{both(bwd_rec['dq_ms'])}, dK/dV "
                      f"{both(bwd_rec['dkdv_ms'])}; bound fwd "
                      f"{both(b_fwd)}, bwd {both(b_bwd)}; bound before the "
                      f"hi/lo pricing fwd {both(old_f)}, bwd {both(old_b)};"
                      f" SDPA bf16 fwd {both(t_f)}, bwd {both(t_fb - t_f)}")
            del qt, kt, vt, dot
            torch.cuda.empty_cache()
    return fwd_rec, bwd_rec


def ssd_inputs(gen, shape, dtype, device):
    """Inputs of the SSD block drawn as the model makes them: dt =
    softplus(N(0, 1) - 2) (the init's dt_bias puts dt near 0.1), a =
    -(1..H) (the init's a_log), cums the within-chunk cumsum of dt a, so
    that exp(cums_i - cums_j) overflows fp32 above the diagonal on every
    head past the first; h_in and d_skip random."""
    import torch
    import torch.nn.functional as F
    bt, s, h, g, p, n, chunk = shape
    q = min(chunk, s)
    nc = s // q
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=device)
    x = rnd(bt, s, h, p).to(dtype)
    b = (rnd(bt, s, g, n) * 0.5).to(dtype)
    c = (rnd(bt, s, g, n) * 0.5).to(dtype)
    dt = F.softplus(rnd(bt, s, h) - 2.0)
    a = -torch.arange(1, h + 1, device=device, dtype=torch.float32)
    cums = torch.cumsum((dt * a).reshape(bt, nc, q, h), 2).reshape(bt, s, h)
    h_in = rnd(bt, nc, h, n, p) * 0.1
    d_skip = 1.0 + rnd(h) * 0.1
    return x, b, c, dt, cums, h_in, d_skip


def ssd_pairs(q: int) -> int:
    """Live (i, j) pairs, j <= i, of one chunk of q rows."""
    return q * (q + 1) // 2


def ssd_bounds(shape, dtype, split: bool = True, by: bool = False):
    """(forward, backward) bounds in ms of one call.  Operations: the
    forward's CB (2 N a live pair), (CB * L) X (2 P a pair) and C h_in (2
    q N P a chunk), the backward's CB, dM = dY X^T, dX, dC (intra), d(dt
    B) (2 N or 2 P a pair each) and dC (inter), dh_in (2 q N P each), per
    chunk and head, counted once, priced at the arithmetic that holds
    ``TOL_SSD`` / ``TOL_SSD_GRAD``.  With bf16 x, b, c, CB = dt_j (C_i .
    B_j) is one bf16 product with fp32 sums (dt only scales its column),
    and so is dM, since dY is the gradient of y.to(bf16) and so
    bf16-valued (check_ssd draws it so for the timed case); every product
    with an fp32 operand (M = CB * L, h_in, dS * dt, dS, exp(cums) dY) is
    two bf16 products, the operand split into bf16 hi + lo (a bf16 M or
    dS misses the tolerance, as a bf16 P does in flash attention): all at
    the bf16 tensor-core peak, 1 + 2 + 2 products' worth forward, 1 + 1 +
    2 + 2 + 2 + 2 + 2 backward.  fp32 inputs: every product at the fp32
    peak.  ``split=False`` gives the earlier pricing of bf16 inputs, CB
    and dM at the bf16 peak and the rest at the fp32 peak.  Bytes: the
    forward reads x, b, c, dt, cums, h_in, d_skip and writes y (fp32); the
    backward reads them and dY and writes dx, db, dc, ddt, dcums, dh_in
    and dd_skip.  At Mamba2-370m's block with bf16 inputs the bytes bound
    the forward and the operations the backward.  With ``by``, also
    return which ("bytes" or "operations") bounds each."""
    import torch
    bt, s, h, g, p, n, chunk = shape
    q = min(chunk, s)
    nc = s // q
    prog = bt * nc * h
    pairs = ssd_pairs(q)
    cb, mx, ch = 2 * n * pairs, 2 * p * pairs, 2 * q * n * p
    if dtype != torch.bfloat16:
        fwd_s = prog * (cb + mx + ch) / PEAK_FP32_FLOPS
        bwd_s = prog * (3 * cb + 2 * mx + 2 * ch) / PEAK_FP32_FLOPS
    elif split:
        fwd_s = prog * (cb + 2 * mx + 2 * ch) / PEAK_BF16_FLOPS
        bwd_s = prog * (5 * cb + 3 * mx + 4 * ch) / PEAK_BF16_FLOPS
    else:
        fwd_s = prog * (cb / PEAK_BF16_FLOPS + (mx + ch) / PEAK_FP32_FLOPS)
        bwd_s = prog * ((cb + mx) / PEAK_BF16_FLOPS
                        + (2 * cb + mx + 2 * ch) / PEAK_FP32_FLOPS)
    it = torch.finfo(dtype).bits // 8
    xbc = it * (bt * s * h * p + 2 * bt * s * g * n)
    small = 4 * (2 * bt * s * h + bt * nc * h * n * p + h)
    y = 4 * bt * s * h * p
    fwd_b = (xbc + small + y) / PEAK_BYTES_PER_S
    bwd_b = (2 * (xbc + small) + y) / PEAK_BYTES_PER_S
    bounds = (1e3 * max(fwd_s, fwd_b), 1e3 * max(bwd_s, bwd_b))
    if not by:
        return bounds
    kind = lambda ops, nbytes: "operations" if ops >= nbytes else "bytes"
    return bounds, (kind(fwd_s, fwd_b), kind(bwd_s, bwd_b))


SSD_GRADS = ("dx", "db", "dc", "ddt", "dcums", "dh_in", "dd_skip")


def check_ssd(device, cases=SSD_CASES, timed: str = "mamba2-370m"):
    """The SSD block's forward and two backward kernels against their plain
    versions on the same inputs, each launched twice and compared bitwise,
    every output finite (the inputs make exp(cums_i - cums_j) overflow
    above the diagonal, where the JAX formula's backward meets inf), at
    each of ``cases``: by default Mamba2-370m's block (8, 1024, 32 heads,
    P 64, N 128, G 1) in bf16 (as the model feeds it) and fp32, and a
    ragged shape (S 200 < chunk, G 2, P 48, N 80), dY bf16-valued as the
    model feeds it, then bf16 at the ragged shape with an fp32 dY;
    ``ZAMBA_SSD_CASES``: Zamba2-2.7B's (4, 2048, 80 heads, P 64, N 64).
    Then, at the shape named ``timed`` in bf16, each kernel's device time
    beside its bound (and the earlier pricing) and its plain version's.
    Returns (forward, backward) records, times per call."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(8)
    fwd_rec, bwd_rec = new_rec(), new_rec()
    runs = [(name, shape, dt, dy_bf16)
            for name, shape, dtypes, dy_bf16 in cases for dt in dtypes]
    for name, shape, dt, dy_bf16 in runs:
        dt = getattr(torch, dt)
        ins = ssd_inputs(gen, shape, dt, device)
        dy = torch.randn(ins[0].shape, generator=gen, device=device)
        if dy_bf16:
            dy = dy.to(dt).float()
        what = f"ssd_chunk {name} {shape} {dt}"
        fwd = lambda: ops.ssd_chunk_fwd(*ins)
        got, again = fwd(), fwd()
        want = ref.ssd_chunk(*ins)
        torch.cuda.synchronize()
        errs = hold(f"{what} fwd", ("y",), (TOL_SSD,), (got,), (want,),
                    fwd_rec, (again,))
        print(f"  {what} fwd: {errs}")
        bwd = lambda: ops.ssd_chunk_bwd(*ins, dy)
        got, again = bwd(), bwd()
        want = ref.ssd_chunk_bwd(*ins, dy)
        torch.cuda.synchronize()
        errs = hold(f"{what} bwd", SSD_GRADS,
                    (TOL_SSD_GRAD,) * len(SSD_GRADS), got, want,
                    bwd_rec, again)
        print(f"  {what} bwd: {errs}")
        del got, again, want
        if name != timed or dt != torch.bfloat16:
            continue
        (b_fwd, b_bwd), by = ssd_bounds(shape, dt, by=True)
        fwd_rec["bound_by"], bwd_rec["bound_by"] = by
        old_f, old_b = ssd_bounds(shape, dt, split=False)
        fwd_rec["bound_before_split_ms"] = old_f
        bwd_rec["bound_before_split_ms"] = old_b
        print(f"    bound fwd {b_fwd:.4f} ms ({by[0]}), bwd {b_bwd:.4f} "
              f"ms ({by[1]}); priced before the hi/lo split: fwd "
              f"{old_f:.4f}, bwd {old_b:.4f}")
        time_pair(fwd, lambda: ref.ssd_chunk(*ins), "ssd_fwd_kernel",
                  fwd_rec, b_fwd, f"{name} bf16 fwd")
        time_pair(bwd, lambda: ref.ssd_chunk_bwd(*ins, dy), "ssd_bwd",
                  bwd_rec, b_bwd, f"{name} bf16 bwd (both kernels)")
        for kern in ("rows", "cols"):
            bwd_rec[kern + "_ms"] = device_ms(
                bwd, f"ssd_bwd_{kern}_kernel")
        print(f"    timing bwd by kernel: rows {bwd_rec['rows_ms']:.4f}"
              f" ms, cols {bwd_rec['cols_ms']:.4f} ms")
        del ins, dy
        torch.cuda.empty_cache()
    return fwd_rec, bwd_rec


@contextlib.contextmanager
def cholesky_traced(gram_dtype=None):
    """Within it, CholeskyQR records the ``cholesky_ex`` info of every
    matrix of each factorization it makes (a list, one entry per call:
    three per power iteration) and, with ``gram_dtype``, forms and factors
    its Gram in that dtype on every device instead of the route's own
    (``core/srsi.py::gram_dtype``)."""
    import torch
    from repro_torch.core import srsi as S
    chol, wide = S._cholesky, S.gram_dtype
    log = []

    def traced(gram):
        log.append(torch.linalg.cholesky_ex(gram)[1].reshape(-1).tolist())
        return chol(gram)

    S._cholesky = traced
    if gram_dtype is not None:
        S.gram_dtype = lambda device: gram_dtype
    try:
        yield log
    finally:
        S._cholesky, S.gram_dtype = chol, wide


def failed_factorizations(log: list) -> list:
    """``[(power iteration, pass, {matrix: info})]`` of a
    :func:`cholesky_traced` log, for the factorizations that failed."""
    return [(k // 3, k % 3, {j: i for j, i in enumerate(infos) if i})
            for k, infos in enumerate(log) if any(infos)]


SRSI_ROUTES = {"card": (True, None), "card-fp32-gram": (True, "float32"),
               "cpu": (False, None), "cpu-fp64-gram": (False, "float64")}


def srsi_routes(v, draw, r: int, p: int, n_it: int, routes,
                seconds: dict | None = None):
    """S-RSI of the stacked ``v`` with the sketch ``draw`` on each of
    ``routes`` (names in ``SRSI_ROUTES``): ``card`` and ``cpu`` as the
    port runs them (the Gram in float64 on the card, in float32, the JAX
    package's arithmetic, on the CPU), ``cpu-fp64-gram``, the card's route
    on the CPU, and ``card-fp32-gram``, the CPU's route on the card.
    Returns ``{route: (Q U^T, xi(r), Q's mass per matrix, failed
    factorizations)}``; each route's seconds are added into
    ``seconds``."""
    import torch
    from repro_torch.core import rank as R
    from repro_torch.core import srsi as S
    out = {}
    cpu = torch.device("cpu")
    seconds = {} if seconds is None else seconds
    for route in routes:
        on_card, wide = SRSI_ROUTES[route]
        dev = v.device if on_card else cpu
        wide = None if wide is None else getattr(torch, wide)
        t0 = time.monotonic()
        vv = v.to(dev)
        with cholesky_traced(wide) as log:
            res = S.srsi_dense(vv, r, p, n_it,
                               lambda shape, gen, d=dev: draw.to(d))
        k = torch.full(vv.shape[:-2], r, dtype=torch.int32, device=dev)
        out[route] = (res.q @ res.u.transpose(-1, -2),
                      R.xi_of_k(res.cum_energy, res.frob_sq, k).cpu(),
                      res.q.abs().sum(dim=(-2, -1)).cpu(),
                      failed_factorizations(log))
        seconds[route] = seconds.get(route, 0.0) + time.monotonic() - t0
    return out


def check_srsi(device, fact_mixed: list):
    """S-RSI as the main path batches it on the card, on the inputs the
    launcher's mixed groups give it: 11 steps of GPT-2 117M (``--fused-
    update --refresh-every 5``), each factored leaf's V and sketch
    captured at the refresh steps 6 and 11, and w_down's at step 1, each
    run on the routes of :func:`srsi_routes`.  The card's route must
    factor every Gram (``cholesky_ex`` info 0), leave no matrix's factors
    zero, keep xi(r) below 1 and Q U^T within ``TOL_SRSI`` of the largest
    entry of the same route's on the CPU, which must factor every Gram
    too.  The float32 Gram on the card is printed beside it, and where it
    fails, the CPU's own route (float32, the JAX package's arithmetic):
    where their Cholesky fails, the factor is NaN, the finite mask zeroes
    Q, and a zero Q stays zero through the later passes
    (``core/srsi.py``)."""
    import torch
    from repro_torch.configs.archs import get_config
    from repro_torch.core import srsi as S
    from repro_torch.core.build import build_optimizer
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import LoopConfig, train
    names = [name for name, _, _ in fact_mixed]
    wanted = lambda t, name: t in (6, 11) or (
        t == 1 and name == "blocks/mlp/w_down")
    seen = {"step": 1, "calls": 0}
    captured = []
    plain = S.srsi_dense

    def capture(a, r_store, oversample, n_iter, sketch, generator=None,
                **kw):
        draws = []

        def source(shape, gen):
            draws.append(sketch(shape, gen))
            return draws[-1]

        res = plain(a, r_store, oversample, n_iter, source, generator, **kw)
        name = names[seen["calls"] % len(names)]
        seen["calls"] += 1
        if wanted(seen["step"], name):
            captured.append((seen["step"], name, a.detach().cpu(),
                             draws[0].detach().cpu(), r_store, oversample,
                             n_iter))
        return res

    def hook(step, metrics):
        seen["step"] = step + 1

    cfg = get_config("gpt2-117m")
    t0 = time.monotonic()
    S.srsi_dense = capture
    try:
        train(build_model(cfg), build_optimizer(optimizer_config(
            "adapprox", 12, 3e-3, refresh_every=5, fused_update=True,
            mixed_groups=True)),
            DataConfig(vocab=cfg.vocab, seq_len=1024, global_batch=8),
            LoopConfig(total_steps=11, log_every=1), device=device,
            metric_hook=hook)
    finally:
        S.srsi_dense = plain
    got = [(t, name) for t, name, *_ in captured]
    want = [(t, name) for t in (1, 6, 11) for name in names
            if wanted(t, name)]
    if got != want:
        fail(f"[srsi] captured S-RSI at {got}, expected {want}")
    print(f"  11 steps with the S-RSI inputs captured: "
          f"{time.monotonic() - t0:.1f} s; CPU threads "
          f"{torch.get_num_threads()}")
    where = lambda fl: "; ".join(
        f"iteration {it} pass {ps}: {sorted(bad)}" for it, ps, bad in fl
    ) or "none"
    seconds = {}
    for t, name, v, draw, r, p, n_it in captured:
        vd = v.to(device)
        out = srsi_routes(vd, draw, r, p, n_it,
                          ("card", "card-fp32-gram", "cpu-fp64-gram"),
                          seconds)
        if out["card-fp32-gram"][3]:
            out.update(srsi_routes(vd, draw, r, p, n_it, ("cpu",), seconds))
        rec, xi, mass, failed = out["card"]
        rec_cpu, xi_cpu, _, failed_cpu = out["cpu-fp64-gram"]
        worst = max(rel_err(rec[i].cpu(), rec_cpu[i])[1]
                    for i in range(v.shape[0]))
        print(f"  step {t} {name} {tuple(v.shape)} r {r}: xi(r) card "
              f"{float(xi.min()):.4f}-{float(xi.max()):.4f}, CPU "
              f"{float(xi_cpu.min()):.4f}-{float(xi_cpu.max()):.4f}; Q U^T "
              f"rel err {worst:.2e} (tolerance {TOL_SRSI}); failed "
              f"Choleskys: card {where(failed)}, CPU {where(failed_cpu)}")
        for route in [w for w in ("card-fp32-gram", "cpu") if w in out]:
            _, xi_32, mass_32, failed_32 = out[route]
            infos = sorted({i for _, _, bad in failed_32
                            for i in bad.values()})
            print(f"    Gram in fp32, {route.split('-')[0]}: failed "
                  f"Choleskys {where(failed_32)}, info {infos}; Q zeroed "
                  f"on matrices {(mass_32 == 0).nonzero().flatten().tolist()}"
                  f", xi(r) max {float(xi_32.max()):.4f}")
        if failed or failed_cpu or not bool((mass > 0).all()) \
                or not bool((xi < 1.0).all()):
            fail(f"S-RSI, step {t} {name}: failed Choleskys card "
                 f"{where(failed)}, CPU {where(failed_cpu)}; matrices "
                 f"zeroed on the card "
                 f"{(mass == 0).nonzero().flatten().tolist()}")
        if worst > TOL_SRSI:
            fail(f"S-RSI on the card vs the CPU, step {t} {name}: Q U^T "
                 f"rel err {worst:.2e}")
    print("  seconds by route: " + ", ".join(
        f"{route} {sec:.1f}" for route, sec in seconds.items()))
    # batched equals unbatched, the JAX package's contract (core/srsi.py):
    # each matrix of w_down's stack alone, against its slice of the batch
    for t, name, v, draw, r, p, n_it in captured:
        if name != "blocks/mlp/w_down":
            continue
        vd, dd = v.to(device), draw.to(device)
        batched = S.srsi_dense(vd, r, p, n_it, lambda shape, gen: dd)
        t1 = time.monotonic()
        bad = []
        for i in range(v.shape[0]):
            alone = S.srsi_dense(vd[i], r, p, n_it,
                                 lambda shape, gen, i=i: dd[i])
            diff = [f for f in alone._fields
                    if not torch.equal(getattr(batched, f)[i],
                                       getattr(alone, f))]
            if diff:
                bad.append((i, diff))
        print(f"  step {t} {name}: each of its {v.shape[0]} matrices alone "
              f"on the card vs its slice of the batched run: "
              f"{bad or 'bitwise equal (Q, U, cum_energy, frob_sq)'} "
              f"({time.monotonic() - t1:.1f} s)")
        if bad:
            fail(f"S-RSI at step {t}, {name}: batched differs from alone "
                 f"on matrices {bad}")


@contextlib.contextmanager
def srsi_captured(shape: tuple):
    """Within it, the first S-RSI call on a stacked leaf of ``shape`` (the
    main path's refresh at step 1) records, on the host, its input V, its
    sketch and its ``(r, oversample, n_iter)``: a list, empty until then."""
    from repro_torch.core import srsi as S
    plain = S.srsi_dense
    got = []

    def capture(a, r_store, oversample, n_iter, sketch, generator=None,
                **kw):
        if got or tuple(a.shape) != tuple(shape):
            return plain(a, r_store, oversample, n_iter, sketch, generator,
                         **kw)
        draws = []

        def source(shp, gen):
            draws.append(sketch(shp, gen))
            return draws[-1]

        res = plain(a, r_store, oversample, n_iter, source, generator, **kw)
        got.append((a.detach().cpu(), draws[0].detach().cpu(), r_store,
                    oversample, n_iter))
        return res

    S.srsi_dense = capture
    try:
        yield got
    finally:
        S.srsi_dense = plain


def check_srsi_widths(device, captured: list) -> None:
    """[srsi] at other widths: for each ``(name, (V, sketch, r, p,
    n_iter))`` captured at a main path's step-1 refresh, one matrix (the
    stack's first) on the card against the card's route on the CPU (the
    float64 Gram): every Gram factored, Q nonzero, xi(r) below 1, Q U^T
    within ``TOL_SRSI``; then the batched stack on the card against that
    matrix alone, bitwise (Q, U, cum_energy, frob_sq)."""
    import torch
    from repro_torch.core import srsi as S
    for name, (v, draw, r, p, n_it) in captured:
        t0 = time.monotonic()
        vd, dd = v.to(device), draw.to(device)
        out = srsi_routes(vd[:1], draw[:1], r, p, n_it,
                          ("card", "cpu-fp64-gram"))
        (rec, xi, mass, failed), (rec_cpu, _, _, failed_cpu) = (
            out["card"], out["cpu-fp64-gram"])
        worst = rel_err(rec[0].cpu(), rec_cpu[0])[1]
        batched = S.srsi_dense(vd, r, p, n_it, lambda shape, gen: dd)
        alone = S.srsi_dense(vd[0], r, p, n_it, lambda shape, gen: dd[0])
        diff = [f for f in alone._fields
                if not torch.equal(getattr(batched, f)[0],
                                   getattr(alone, f))]
        print(f"  {name} {tuple(v.shape)} r {r}, matrix 0: xi(r) "
              f"{float(xi.max()):.4f}; Q U^T card vs CPU rel err "
              f"{worst:.2e} (tolerance {TOL_SRSI}); failed Choleskys card "
              f"{failed or 'none'}, CPU {failed_cpu or 'none'}; alone vs "
              f"its slice of the batched run: "
              f"{diff or 'bitwise equal (Q, U, cum_energy, frob_sq)'} "
              f"({time.monotonic() - t0:.1f} s)")
        if failed or failed_cpu or not bool((mass > 0).all()) \
                or not bool((xi < 1.0).all()) or worst > TOL_SRSI:
            fail(f"S-RSI at {name}: Q U^T rel err {worst:.2e}, failed "
                 f"Choleskys card {failed}, CPU {failed_cpu}, xi {xi}")
        if diff:
            fail(f"S-RSI at {name}: batched differs from alone in {diff}")
        del vd, dd, batched, alone, out
        torch.cuda.empty_cache()


def moe_repeat_step(device) -> None:
    """[train-olmoe]'s model and optimizer, step 1 from the seed-0 init,
    then step 2 twice from that one state: every tensor of the two results
    bitwise equal (the MoE dispatch and combine use no float atomics)."""
    import copy
    import torch
    from repro_torch.core.build import build_optimizer
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import LoopConfig, train
    cfg = arch_config("olmoe-1b-7b", DENSE_LAYERS)
    model = build_model(cfg)
    opt = build_optimizer(optimizer_config(
        "adapprox", 6, 4e-4, refresh_every=5, fused_update=True,
        mixed_groups=True))
    data = DataConfig(vocab=cfg.vocab, seq_len=2048, global_batch=2)
    to = lambda n, st: train(model, opt, data, LoopConfig(
        total_steps=n, log_every=1), device=device, state=st)[0]
    t0 = time.monotonic()
    first = to(1, None)
    twin = copy.deepcopy(first)
    snap = snapshot(to(2, first))
    del first
    unchanged("step 2 run twice from the step-1 state", snap, to(2, twin))
    del snap, twin
    torch.cuda.empty_cache()
    print(f"  ({time.monotonic() - t0:.1f} s)")


def chaos_tool(directory: Path) -> None:
    """``python -m repro_torch.tools.chaos --out DIR`` on the card, its
    default plan: exit 0."""
    from repro_torch.tools import chaos
    shutil.rmtree(directory, ignore_errors=True)
    t0 = time.monotonic()
    code = chaos.main(["--out", str(directory)])
    print(f"  repro_torch.tools.chaos exit {code} "
          f"({time.monotonic() - t0:.1f} s)")
    if code != 0:
        fail(f"repro_torch.tools.chaos exited {code}")


def check_dense_kernels(device):
    """[kernels-dense]: B6 at Qwen2-7B's attention (dh 128, a group of 7),
    B5 at Qwen2-7B's embed and untied lm_head (152,064 columns: a (4,
    2048, 152064) table, 1.25e9 entries), B1 and B2 at one layer's w_up
    (3584 x 18944) and at one OLMoE-1B-7B expert stack (64, 2048, 1024),
    each against its plain version, bitwise repeatable, timed beside its
    bound.  Returns the records ``{"flash_fwd", "flash_bwd", "sketch",
    "precond", "apply"}``."""
    fwd, bwd = check_flash(device, DENSE_FLASH_CASES, "qwen2-7b",
                           DENSE_LAYERS)
    sk = check_sketch(sketch_cases(device, "qwen2-7b", ("embed", "lm_head"),
                                   ragged=False, layers=DENSE_LAYERS),
                      device)
    one = lambda arch, leaf: [
        (f"{arch} {name}", shape[1:], r) for name, shape, r in
        main_path_leaves(device, mixed=True, arch=arch,
                         layers=DENSE_LAYERS)[0] if name == leaf]
    fact = (one("qwen2-7b", "blocks/mlp/w_up")
            + one("olmoe-1b-7b", "blocks/moe/w_up"))
    if [shape for _, shape, _ in fact] != [(3584, 18944), (64, 2048, 1024)]:
        fail(f"[kernels-dense] leaves {fact}")
    return dict(flash_fwd=fwd, flash_bwd=bwd, sketch=sk,
                precond=check_precond(fact, device, ragged=False),
                apply=check_apply(fact, [], device))


def check_family_kernels(device):
    """[kernels-families]: B7 at Zamba2-2.7B's Mamba2 block (4, 2048, 80
    heads, P 64, N 64); B6 at Zamba2-2.7B's shared attention (4, 2048, 32,
    dh 80) and LLaVA-NeXT-Mistral-7B's (2, 2048, 32 over 8, 128), beside
    SDPA; each in bf16 and fp32, forward and both backward kernels; B1 and
    B2 at Zamba2-2.7B's in_proj stack (54, 2560, 10448) as the optimizer
    calls them; B5 at Whisper-large-v3's sketched leaves (dec_pos, embed,
    enc_pos: 32768, 51866 and 1500 rows of 1280).  Each against its plain
    version, bitwise repeatable, timed beside its bound.  Returns the
    records ``{"ssd_fwd", "ssd_bwd", "zamba_fwd", "zamba_bwd", "llava_fwd",
    "llava_bwd", "precond", "apply", "sketch"}``."""
    s_fwd, s_bwd = check_ssd(device, ZAMBA_SSD_CASES, ZAMBA)
    z_fwd, z_bwd = check_flash(device, ZAMBA_FLASH_CASES, ZAMBA, ZAMBA_APPS)
    l_fwd, l_bwd = check_flash(device, LLAVA_FLASH_CASES, LLAVA,
                               LLAVA_LAYERS)
    fact = [(f"{ZAMBA} {name}", shape, r) for name, shape, r in
            main_path_leaves(device, mixed=True, arch=ZAMBA)[0]
            if name == "layers/mamba/in_proj"]
    if [shape for _, shape, _ in fact] != [(ZAMBA_LAYERS, 2560, 10448)]:
        fail(f"[kernels-families] leaves {fact}")
    pre = check_precond(fact, device, ragged=False)
    app = check_apply(fact, [], device)
    sk = check_sketch(sketch_cases(device, WHISPER,
                                   ("dec_pos", "embed", "enc_pos"),
                                   ragged=False), device)
    return dict(ssd_fwd=s_fwd, ssd_bwd=s_bwd, zamba_fwd=z_fwd,
                zamba_bwd=z_bwd, llava_fwd=l_fwd, llava_bwd=l_bwd,
                precond=pre, apply=app, sketch=sk)


class _CallOrderSketch:
    """Sketch source drawing from one CPU generator in call order, so two
    runs that call it alike get the same Gaussian sketches on any device."""

    def __init__(self, seed: int):
        import torch
        self.gen = torch.Generator().manual_seed(seed)

    def __call__(self, shape, generator):
        import torch
        return torch.randn(shape, generator=self.gen)


@contextlib.contextmanager
def plain_ssd_in_fp64():
    """Within it, B7's plain version computes in fp64 and rounds its
    results to fp32: run on the CPU against the fp32 plain path, a witness
    of how far rounding alone moves the Mamba2 smoke run."""
    from repro_torch.kernels import ref
    fwd, bwd = ref.ssd_chunk, ref.ssd_chunk_bwd
    up = lambda ts: [t.double() for t in ts]
    ref.ssd_chunk = lambda *a: fwd(*up(a)).float()
    ref.ssd_chunk_bwd = lambda *a: tuple(g.float() for g in bwd(*up(a)))
    try:
        yield
    finally:
        ref.ssd_chunk, ref.ssd_chunk_bwd = fwd, bwd


@contextlib.contextmanager
def routes_recorded():
    """Within it, every call of the MoE router records, on the host, its
    top-k indices and its smallest top-k margin: over the tokens, the
    k-th largest probability minus the (k+1)-th."""
    import torch
    from repro_torch.models import moe as MOE
    route = MOE._route
    log = []

    def traced(cfg, router_w, xf):
        gates, idx, aux = route(cfg, router_w, xf)
        with torch.no_grad():
            probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)
            top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
            log.append((idx.detach().cpu(),
                        float((top[:, -2] - top[:, -1]).min())))
        return gates, idx, aux

    MOE._route = traced
    try:
        yield log
    finally:
        MOE._route = route


def hold_routes(cpu: list, card: list) -> None:
    """The top-k indices of every router call equal on the card and the
    CPU (:func:`routes_recorded`), checked before any loss or parameter:
    a route that flips is a different result, so it fails as a routing
    flip, with the calls and tokens that flipped and the smallest margin,
    and is never folded into a tolerance."""
    import torch
    flips = [(i, int((a != b).any(dim=-1).sum()))
             for i, ((a, _), (b, _)) in enumerate(zip(cpu, card))
             if not torch.equal(a, b)]
    margin = min(m for _, m in cpu + card)
    print(f"  top-k indices of {len(cpu)} router calls: card vs CPU "
          f"{'equal' if not flips else f'flipped (call, tokens) {flips}'}; "
          f"smallest top-k margin {margin:.3e}")
    if len(cpu) != len(card) or not cpu or flips:
        fail(f"routing flip between the card and the CPU: {len(card)} vs "
             f"{len(cpu)} router calls, (call, tokens) {flips}; smallest "
             f"top-k margin {margin:.3e}")


def small_parity(device, kind: str = "fused", mixed: bool = False,
                 chunked: bool = False, seed: int = 0,
                 sketch_rows: int = SMALL_MIXED["embedding_min_rows"],
                 name: str = "adapprox", over: dict | None = None,
                 param_dtype: str = "float32",
                 factored_steps: int | None = None,
                 arch: str = "gpt2-117m"):
    """Kernel path (card) against plain path (CPU), end to end: the smoke
    model of ``arch`` (GPT-2 117M, a dense or MoE decoder, Mamba2-370m) in
    fp32, 4 steps with refresh_every=3 (refresh, fold, fold,
    refresh), same init and sketches, the launcher's optimizer with
    ``kind`` "fused" (--fused-update), "int8" (and --quantize-factors) or
    "kernels" (use_kernels, no fused update).  With ``mixed`` on the
    launcher's mixed groups, with the token embedding sketched.  With
    ``chunked``, attn_impl "chunked" at batch 2 x 2048 (two 1024-token
    chunks, so the dispatch takes the flash-attention path on every
    layer); else batch 4 x 128 on the naive path.  On Mamba2 (2 layers,
    chunk 16) every layer's SSD block runs B7, and beside it runs the fp64
    witness (:func:`plain_ssd_in_fp64`), unchecked; on MoE the top-k
    indices of every router call are compared first
    (:func:`hold_routes`), and beside it runs a witness from a nudged
    init, unchecked; both hold the first step's gradients to 1e-4
    (:func:`step1_grads`).  The hybrid (zamba2) runs B7 in every layer,
    beside the same fp64 witness, but its parameters are held to 1e-4:
    only the ssm family takes ``TOL_PARAMS_MAMBA``.  The vlm and encdec
    families train on ``make_batch`` batches, which carry the stub
    frontend's ``embeds``, through ``build_train_step``
    (:func:`batch_run`), their step-1 gradients held to 1e-4 too.
    ``seed`` draws the init; ``sketch_rows`` is the mixed groups'
    embedding_min_rows (64 puts the Mamba2 smoke lm_head, (64, 512), on
    the sketch too).  ``name`` is the
    launcher's optimizer (``kind`` "none" for the families without a
    kernel), ``over`` replaces fields of its OptimizerConfig (warm start,
    bucketing, implicit, k_max), ``param_dtype`` the master parameters'
    dtype: bf16 parameters are held entry by entry, within one bf16 ulp of
    the entry plus the tolerance of the leaf's largest.  The card's
    launches must be those the optimizer state and the model's path
    imply; ``factored_steps`` is the step after which the xi watchdog has
    demoted every factored leaf (``over`` with guards).  With guards the
    guard counters must be equal on the card and the CPU; returns the CPU
    run's (:func:`guard_counters`), else None."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.archs import get_smoke_config
    from repro_torch.core.adapprox import adapprox_state
    from repro_torch.core.build import build_optimizer
    from repro_torch.core.factored import FactoredLeaf
    from repro_torch.core.sketch import SketchLeaf, SketchState
    from repro_torch.core.types import find_states
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import LoopConfig, train

    seq, batch = (2048, 2) if chunked else (128, 4)
    cfg = dataclasses.replace(
        get_smoke_config(arch, max_seq_len=seq), dtype="float32",
        attn_impl="chunked" if chunked else "auto", param_dtype=param_dtype)
    mamba, moe = cfg.ssm is not None, cfg.moe is not None
    embeds = cfg.family in ("vlm", "encdec")
    model = build_model(cfg)
    init = model.init(torch.Generator().manual_seed(seed))
    kw = (dict(mixed_groups=True, **dict(SMALL_MIXED,
                                         embedding_min_rows=sketch_rows))
          if mixed else {})
    batches = smoke_batches(cfg, seq, batch, 4)
    if mamba or moe or embeds:
        step1_grads(model, init, batches[0], device)

    def run(dev, start=init):
        ocfg = optimizer_config(name, 4, 3e-3, refresh_every=3,
                                fused_update=kind != "kernels",
                                quantize_factors=kind == "int8", **kw)
        if kind == "kernels":
            ocfg = dataclasses.replace(ocfg, use_kernels=True)
        ocfg = dataclasses.replace(ocfg, **(over or {}))
        opt = build_optimizer(ocfg, sketch=_CallOrderSketch(5))
        params = {k: v.detach().clone().to(dev)
                  for k, v in tree.flatten(start).items()}
        reset_launches()
        with (routes_recorded() if moe
              else contextlib.nullcontext([])) as routes:
            if embeds:
                state, hist = batch_run(model, opt, tree.unflatten(params),
                                        batches, dev)
            else:
                state, hist = train(model, opt,
                                    DataConfig(vocab=cfg.vocab, seq_len=seq,
                                               global_batch=batch),
                                    LoopConfig(total_steps=4, log_every=1),
                                    device=dev,
                                    params=tree.unflatten(params))
        routes_of[dev.type] = routes
        return state, [h["loss"] for h in hist]

    cpu = torch.device("cpu")
    routes_of = {}
    if mamba:
        with plain_ssd_in_fp64():
            s_64, _ = run(cpu)
    if moe:
        nudged = tree.flatten(init)
        nudged = tree.unflatten(dict(nudged, **{
            "blocks/attn/wq": nudged["blocks/attn/wq"] * (1 + 1e-7)}))
        s_nudge, _ = run(cpu, nudged)
    (s_cpu, l_cpu), (s_gpu, l_gpu) = run(cpu), run(device)
    launches = launch_counts()
    if moe:
        hold_routes(routes_of["cpu"], routes_of[device.type])
    if mamba:
        wit = max(rel_err(s_64.params[k], p)[1]
                  for k, p in s_cpu.params.items())
        print(f"  witness: the plain path with B7's plain version in fp64 "
              f"moves the params by {wit:.2e} (unchecked)")
    if moe:
        wit = max((rel_err(s_nudge.params[k], p)[1], k)
                  for k, p in s_cpu.params.items())
        print(f"  witness: the plain path from an init whose wq is scaled by "
              f"1 + 1e-7 moves the params by {wit[0]:.2e} ({wit[1]}; "
              f"unchecked)")
    print(f"  losses cpu {l_cpu}")
    print(f"  losses gpu {l_gpu}")
    for a, b in zip(l_cpu, l_gpu):
        if not abs(a - b) <= 1e-4 * abs(a):
            fail(f"small-input parity: loss {b} on the card vs {a} on CPU")
    leaves = {k: (adapprox_state(st.opt_state).leaves if name == "adapprox"
                  else ())
              for k, st in (("cpu", s_cpu), ("gpu", s_gpu))}
    k_cpu, k_gpu = ([leaf.k.tolist() for leaf in leaves[k]
                     if isinstance(leaf, FactoredLeaf)]
                    for k in ("cpu", "gpu"))
    if k_cpu != k_gpu:
        fail(f"small-input parity: ranks {k_gpu} on the card vs {k_cpu}")
    tol = (TOL_PARAMS_INT8 if kind == "int8"
           else TOL_PARAMS_MAMBA if cfg.family == "ssm"
           else TOL_PARAMS_MOE if moe
           else 1e-4)
    if param_dtype == "bfloat16":
        hold("small-input parity, bf16 params", list(s_cpu.params),
             [tol] * len(s_cpu.params),
             [p.detach().cpu() for p in s_gpu.params.values()],
             [p.detach() for p in s_cpu.params.values()], new_rec())
    worst, at = max((rel_err(s_gpu.params[k].cpu(), p)[1], k)
                    for k, p in s_cpu.params.items())
    print(f"  ranks {k_cpu}; max param rel err {worst:.2e} at {at} "
          f"(tolerance {tol}"
          f"{', and the bf16 rule' if param_dtype != 'float32' else ''})")
    if param_dtype == "float32" and worst > tol:
        fail(f"small-input parity: params differ by {worst:.2e}")
    n_fact, n_apply, n_wide = adapprox_calls(
        s_gpu.opt_state, bool((over or {}).get("bucketed")))
    n_sk = sum(isinstance(leaf, SketchLeaf)
               for sub in find_states(s_gpu.opt_state, SketchState)
               for leaf in sub.leaves)
    want = expected_launches(kind, 4, 2, n_fact, n_apply, n_sk,
                             cfg.n_layers if chunked else 0,
                             cfg.n_layers if mamba else 0, n_wide=n_wide,
                             factored_steps=factored_steps)
    print(f"  factored calls {n_fact}, sketched leaves {n_sk}; launches on "
          f"the card {launches}")
    if ((n_fact < 1) != (kind == "none") or (mixed and n_sk < 1)
            or launches != want):
        fail(f"small-input parity: launches {launches}, expected {want}")
    if not (over or {}).get("guards"):
        return None
    c_cpu, c_gpu = (guard_counters(st.opt_state) for st in (s_cpu, s_gpu))
    print(f"  guard counters cpu {c_cpu}")
    print(f"  guard counters gpu {c_gpu}")
    if c_cpu != c_gpu:
        fail(f"small-input parity: guard counters {c_gpu} on the card vs "
             f"{c_cpu} on the CPU")
    return c_cpu


def smoke_batches(cfg, seq: int, batch: int, steps: int) -> list:
    """The batches of ``steps`` smoke steps, CPU tensors: the train loop's
    (``SyntheticLM``'s tokens, ``{"tokens"}``) or, for the vlm and encdec
    families, ``configs/base.py::make_batch``'s from one seeded generator
    (tokens and the stub frontend's ``embeds``)."""
    import torch
    from repro_torch.configs.base import make_batch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    if cfg.family in ("vlm", "encdec"):
        gen = torch.Generator().manual_seed(0)
        return [make_batch(cfg, batch, seq, gen) for _ in range(steps)]
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch))
    return [{"tokens": torch.from_numpy(data.batch_at(i)["tokens"])}
            for i in range(steps)]


def batch_run(model, opt, params: dict, batches: list, device):
    """``build_train_step`` over ``batches`` (dicts of tensors, one a step)
    from ``params`` on ``device``: ``(state, history)`` as the train loop
    returns them, each step's ``step_time_s`` its wall time up to a
    synchronize.  The path of a batch that carries ``embeds``, which no
    data source of the launcher makes."""
    import torch
    from repro_torch.train.steps import TrainState, build_train_step
    state = TrainState.create(params, opt)
    step = build_train_step(model, opt)
    hist = []
    for i, b in enumerate(batches, 1):
        b = {k: v.to(device) for k, v in b.items()}
        t0 = time.perf_counter()
        state, met = step(state, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        hist.append({"loss": float(met["loss"]), "step": i,
                     "step_time_s": dt})
    return state, hist


def step1_grads(model, init, batch: dict, device):
    """The first step's loss and every leaf's gradient, from the same init
    and batch (CPU tensors), on the card (the kernels) and on the CPU
    (their plain versions): the loss within 1e-4 relative, each gradient
    within 1e-4 of its leaf's largest entry."""
    import torch
    from repro_torch import tree
    out = []
    for dev in (torch.device("cpu"), device):
        params = {k: v.detach().clone().to(dev).requires_grad_(True)
                  for k, v in tree.flatten(init).items()}
        loss, _ = model.loss(tree.unflatten(params),
                             {k: v.to(dev) for k, v in batch.items()})
        out.append((loss.item(), dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out
    worst = max((rel_err(g_gpu[k].cpu(), g)[1], k) for k, g in g_cpu.items())
    print(f"  step-1 loss cpu {l_cpu} gpu {l_gpu}; worst gradient rel err "
          f"{worst[0]:.2e} ({worst[1]})")
    if not abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu) or worst[0] > 1e-4:
        fail(f"small-input parity: step-1 loss {l_gpu} vs {l_cpu}, "
             f"gradient {worst[1]} rel err {worst[0]:.2e} > 1e-4")


def train_main_path(run, kind: str, expect: dict, attn_layers: int = 0,
                    ssd_layers: int = 0, bucketed: bool = False,
                    steps: int = 12, check: bool = True, keep=None,
                    tokens: int = 8 * 1024):
    """One main-path run: ``run()`` trains ``steps`` steps (refresh every
    5) and returns ``(state, history)``.  Its launches must be those the
    optimizer state (its factored calls: ``bucketed`` stacks leaves of one
    shape) and the attention path (``attn_layers`` chunked layers) or the
    SSD path (``ssd_layers`` Mamba2 layers), their forward twice a layer
    under the model's default remat, imply for ``kind`` (see
    :func:`expected_launches`) and ``expect`` (every other kernel 0); the
    loss finite and falling.  ``check=False`` (the [remat] runs) checks
    neither.  Returns the launch counts and ``{"loss", "peak_gib",
    "fold_s", "refresh_s", "wall_s", "state_mb"}`` (median fold-step
    time, refresh-step times after the first, the whole run's wall time,
    the optimizer state's MB); ``keep(state)`` is given the final state;
    ``tokens`` a step's, for tokens/s."""
    import torch
    from repro_torch.core.sketch import SketchLeaf, SketchState
    from repro_torch.core.types import find_states
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, hist = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    from repro_torch.core.types import tree_nbytes
    state_mb = tree_nbytes(state.opt_state) / 1e6
    if keep is not None:
        keep(state)
    losses = [h["loss"] for h in hist]
    times = [h["step_time_s"] for h in hist]
    for h in hist:
        print(f"  step {h['step']:2d} loss {h['loss']:.4f} "
              f"step_time_s {h['step_time_s']:.4f}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"main path: losses {losses}")
    if check and not losses[-1] < losses[0]:
        fail(f"main path: loss did not fall ({losses[0]} -> {losses[-1]})")
    n_fact, n_apply, n_wide = adapprox_calls(state.opt_state, bucketed)
    n_sk = sum(isinstance(leaf, SketchLeaf)
               for sub in find_states(state.opt_state, SketchState)
               for leaf in sub.leaves)
    # refresh at steps 1, 6, 11 of 12: 9 fold steps
    refresh_steps = [i for i in range(1, steps + 1) if i % 5 == 1]
    want = expected_launches(kind, steps, steps - len(refresh_steps),
                             n_fact, n_apply, n_sk, attn_layers, ssd_layers,
                             fwd_per_layer=2, n_wide=n_wide)
    expect = {**dict.fromkeys(launches, 0), **expect}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches {launches} (expected {want}); peak memory "
          f"{peak:.2f} GiB")
    if check and (launches != want or launches != expect):
        fail(f"main path launches {launches}, expected {want} and {expect}")
    refresh = [t for i, t in enumerate(times, 1)
               if i in refresh_steps and i > 1]
    fold = [t for i, t in enumerate(times, 1) if i not in refresh_steps]
    fold_s = sorted(fold)[len(fold) // 2]
    print(f"  fold-step time median {fold_s:.4f} s "
          f"({tokens / fold_s:.0f} tokens/s); refresh-step times {refresh};"
          f" optimizer state {state_mb:.1f} MB; the run {wall:.1f} s")
    return launches, {"loss": losses[-1], "peak_gib": peak, "fold_s": fold_s,
                      "refresh_s": refresh, "wall_s": wall,
                      "state_mb": state_mb, "losses": losses}


def family_run(device, arch: str, layers: int | None, batch: int, seq: int,
               lr: float, steps: int = 6, **over):
    """``arch`` at full width (``layers`` deep, the fields ``over`` set) on
    the launcher's optimizer (mixed groups, --fused-update --refresh-every
    5, ``lr``), seed-0 init on the card, ``steps`` steps through
    ``build_train_step`` (:func:`batch_run`), each on a fresh batch
    (``batch`` x ``seq``): ``configs/base.py::make_batch``'s from one
    seeded generator (the stub frontend's ``embeds``), its uniform text
    tokens replaced by the launcher's ``SyntheticLM`` stream, which a
    model can learn from in a few steps where uniform tokens stay flat."""
    import torch
    from repro_torch.configs.base import _token_len, make_batch
    from repro_torch.core.build import build_optimizer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model
    cfg = arch_config(arch, layers, **over)

    def run():
        model = build_model(cfg)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        opt = build_optimizer(optimizer_config(
            "adapprox", steps, lr, refresh_every=5, fused_update=True,
            mixed_groups=True))
        gen = torch.Generator(device=device).manual_seed(0)
        text = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=batch,
                                      seq_len=_token_len(cfg, seq)))
        batches = [dict(make_batch(cfg, batch, seq, gen), tokens=torch.
                        from_numpy(text.batch_at(i)["tokens"]).to(device))
                   for i in range(steps)]
        shapes = {k: tuple(v.shape) for k, v in batches[0].items()}
        print(f"  batches {shapes}, {cfg.dtype} embeds")
        return batch_run(model, opt, params, batches, device)
    return run


def launcher_run(argv):
    from repro_torch.launch import train as launcher
    return lambda: launcher.main(argv)


def kernels_config():
    """The launcher's optimizer (mixed groups, --refresh-every 5, no fused
    update) with use_kernels: the JAX launcher has no flag for it, and a
    user reaches it through OptimizerConfig, as the JAX package's
    benchmarks/bench_step_time.py does."""
    from repro_torch.launch.train import optimizer_config
    return dataclasses.replace(
        optimizer_config("adapprox", 12, 3e-3, refresh_every=5,
                         mixed_groups=True), use_kernels=True)


def chunked_model_config():
    """GPT-2 117M with attn_impl "chunked": at 1024 tokens every layer's
    attention takes the flash-attention kernels.  The JAX launcher has no
    flag for it either; a user sets the ModelConfig field."""
    from repro_torch.configs.archs import get_config
    return dataclasses.replace(get_config("gpt2-117m"), attn_impl="chunked")


def loop_run(device, ocfg, model_cfg=None, steps: int = 12):
    """GPT-2 117M (``model_cfg``, by default the launcher's), ``steps``
    steps at batch 8 x 1024, on optimizer config ``ocfg`` through
    build_optimizer and the train loop (the launcher's defaults: seed 0,
    lr 3e-3)."""
    from repro_torch.configs.archs import get_config
    from repro_torch.core.build import build_optimizer
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import LoopConfig, train
    cfg = model_cfg or get_config("gpt2-117m")
    return lambda: train(build_model(cfg), build_optimizer(ocfg),
                         DataConfig(vocab=cfg.vocab, seq_len=1024,
                                    global_batch=8),
                         LoopConfig(total_steps=steps, log_every=1),
                         device=device)


def step_breakdown(device, ocfg, model_cfg=None):
    """Where a main-path step goes: model forward+backward and optimizer
    timed apart (host clock around synchronised work) over steps 1-7 of a
    main path's optimizer config ``ocfg`` (and GPT-2 117M config
    ``model_cfg``, by default the launcher's), and a profile of step 6
    (refresh) and step 7 (fold) for the device's busy share and its
    largest kernels.  With int8 factors, also the cost of their codec
    (dequantize and requantize both factors of every leaf, once a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tree
    from repro_torch.configs.archs import get_config
    from repro_torch.core.build import build_optimizer
    from repro_torch.core.types import apply_updates
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.steps import TrainState

    cfg = model_cfg or get_config("gpt2-117m")
    model = build_model(cfg)
    opt = build_optimizer(ocfg)
    state = TrainState.create(
        model.init(torch.Generator(device=device).manual_seed(0)), opt)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=1024,
                                  global_batch=8))
    params, opt_state = state.params, state.opt_state

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for t in range(1, 8):
        tokens = torch.from_numpy(data.batch_at(t - 1)["tokens"]).to(device)

        def model_part():
            loss, _ = model.loss(tree.unflatten(params), {"tokens": tokens})
            return dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))

        def opt_part():
            with torch.no_grad():
                upd, st = opt.update(grads, opt_state, params)
                apply_updates(params, upd)
            return st

        if t < 6:
            grads, t_model = timed(model_part)
            opt_state, t_opt = timed(opt_part)
            print(f"  step {t}: model fwd+bwd {t_model:.4f} s, optimizer "
                  f"{t_opt:.4f} s")
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            grads, t_model = timed(model_part)
            opt_state, t_opt = timed(opt_part)
        kind = "refresh" if t == 6 else "fold"
        kernel_records(prof, f"step {t} ({kind})")
        busy = sum(e.self_device_time_total for e in averages(prof))
        wall = t_model + t_opt
        print(f"  step {t} ({kind}, profiled): model fwd+bwd {t_model:.4f} "
              f"s, optimizer {t_opt:.4f} s; device busy {busy / 1e6:.4f} s "
              f"of {wall:.4f} s (idle share {1 - busy / 1e6 / wall:.3f})")
        top = sorted(averages(prof),
                     key=lambda e: -e.self_device_time_total)[:8]
        for e in top:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<5d} {e.key[:90]}")
    if ocfg.quantize_factors:
        codec_cost(opt_state)


def codec_cost(opt_state):
    """What the int8 codec adds to a step: dequantize both factors of every
    factored leaf (the refresh or fold takes them so) and requantize the
    new ones, timed as the stream sees it and as the device does, with its
    kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import quantized as QZ
    from repro_torch.core.adapprox import adapprox_state
    leaves = [leaf for leaf in adapprox_state(opt_state).leaves
              if isinstance(getattr(leaf, "q", None), QZ.QuantizedMatrix)]

    def codec():
        for leaf in leaves:
            QZ.quantize_tree_factors(QZ.dequantize(leaf.q),
                                     QZ.dequantize(leaf.u))

    stream = events_ms(codec)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        codec()
        torch.cuda.synchronize()
    kernel_records(prof, "int8 codec")
    evs = averages(prof)
    print(f"  int8 codec per step ({len(leaves)} leaves, dequantize + "
          f"requantize Q and U): stream {stream:.4f} ms, device "
          f"{sum(e.self_device_time_total for e in evs) / 1e3:.4f} ms, "
          f"{sum(e.count for e in evs)} kernel launches")


def remat_runs(device) -> dict:
    """GPT-2 117M on the launcher's mixed groups (--fused-update
    --refresh-every 5) under remat "none", "full" and "dots", and
    Mamba2-370m under "none" and "full", 4 steps each (a refresh, then
    three folds) through build_optimizer and the train loop: the peak
    memory and the median fold step of each, unchecked beside a finite
    loss.  Returns ``{label: info}``."""
    from repro_torch.configs.archs import get_config
    from repro_torch.launch.train import optimizer_config
    ocfg = optimizer_config("adapprox", 12, 3e-3, refresh_every=5,
                            fused_update=True, mixed_groups=True)
    out = {}
    for arch, modes in (("gpt2-117m", ("none", "full", "dots")),
                        (MAMBA, ("none", "full"))):
        for mode in modes:
            label = f"{arch} remat={mode}"
            print(f"  {label}")
            mcfg = dataclasses.replace(get_config(arch), remat=mode)
            _, info = train_main_path(loop_run(device, ocfg, mcfg, steps=4),
                                      "fused", {}, steps=4, check=False)
            out[label] = info
    for label, info in out.items():
        print(f"  {label}: peak {info['peak_gib']:.2f} GiB, fold step "
              f"{info['fold_s']:.4f} s")
    return out


def check_memory(device):
    """Optimizer-state bytes under bench_memory.py's configs at b1 = 0.9
    (implicit=False; the bytes do not depend on it): GPT-2 117M
    ``mixed_groups`` and ``adamw``, and ``adafactor`` and ``came`` of
    117M and 345M, against BENCH_memory.json (0.1 MB rounding), ``adapprox_kmax_int8`` of 117M and 345M against
    the JAX package's count (``INT8_STATE_MB``), Mamba2-370m's
    ``mixed_groups`` and ``adamw`` against it too (``MAMBA_STATE_MB``);
    and, unchecked, the
    launcher's mixed groups with and without --quantize-factors.  Counts
    the tensors that mirror the JAX state's array leaves; the sketch's
    bucket buffers are not state."""
    import torch
    from repro_torch import tree
    from repro_torch.config import OptimizerConfig, default_mixed_groups
    from repro_torch.configs.archs import get_config
    from repro_torch.core.build import build_optimizer
    from repro_torch.core.types import tree_nbytes
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model

    rows = json.loads((ROOT / "BENCH_memory.json").read_text())
    table = {(r["arch"], r["method"]): r["state_mb"]
             for r in rows["results"]["table2"] if r["b1"] == 0.9}
    base = dict(b1=0.9, schedule="constant", lr=1e-3, weight_decay=0.0)
    kmax = dict(name="adapprox", k=1, k_max=10**9, rank_mode="paper",
                implicit=False, **base)
    mixed = OptimizerConfig(groups=default_mixed_groups(), **kmax)
    adamw = OptimizerConfig(name="adamw", **base)
    cases = [("gpt2-117m", "mixed_groups", mixed,
              table["gpt2-117m", "mixed_groups"]),
             ("gpt2-117m", "adamw", adamw, table["gpt2-117m", "adamw"])]
    cases += [("gpt2-117m", f"launcher mixed groups{flag}", optimizer_config(
                   "adapprox", 12, 3e-3, refresh_every=5, fused_update=True,
                   mixed_groups=True, quantize_factors=bool(flag)), None)
              for flag in ("", " --quantize-factors")]
    cases += [(arch, "adapprox_kmax_int8", OptimizerConfig(
                   factor_dtype="int8", **kmax), INT8_STATE_MB[arch])
              for arch in ("gpt2-117m", "gpt2-345m")]
    cases += [("mamba2-370m", "mixed_groups", mixed,
               MAMBA_STATE_MB["mixed_groups"]),
              ("mamba2-370m", "adamw", adamw, MAMBA_STATE_MB["adamw"])]
    # the paper's baselines (Table 2), as bench_memory.py builds them
    cases += [(arch, name, OptimizerConfig(name=name, **base),
               table[arch, name])
              for arch in ("gpt2-117m", "gpt2-345m")
              for name in ("adafactor", "came")]
    flat = {}
    for arch, name, cfg, want in cases:
        if arch not in flat:
            flat = {arch: tree.flatten(build_model(get_config(arch)).init(
                torch.Generator(device=device).manual_seed(0)))}
        state = build_optimizer(cfg).init(flat[arch])
        mb = tree_nbytes(state) / 1e6
        del state
        json_mb = table.get((arch, name))
        note = ("unchecked" if want is None else f"expected {want} MB"
                + (f", BENCH_memory.json {json_mb} MB" if json_mb else ""))
        print(f"  {arch} {name}: {mb:.6f} MB ({note})")
        if want is not None and abs(mb - want) > 0.05:
            fail(f"optimizer state of {arch} {name}: {mb:.3f} MB, expected "
                 f"{want}")
    del flat
    torch.cuda.empty_cache()


def guard_counters(opt_state) -> dict:
    """The xi watchdog's counters of the Adapprox stage and the skip-step
    guard's, as plain lists and ints."""
    from repro_torch.core.adapprox import adapprox_state
    from repro_torch.core.types import find_states
    from repro_torch.resilience import GuardedState
    g = adapprox_state(opt_state).guards
    out = {f: getattr(g, f).tolist() for f in
           ("trips", "force_refresh", "demoted", "trip_total", "demotions")}
    for sub in find_states(opt_state, GuardedState):
        out.update(steps=sub.steps, skipped=sub.skipped,
                   last_skip=sub.last_skip)
        break
    return out


def per_leaf(counters: dict) -> dict:
    """Counters of a schedule every factored leaf follows alike, per leaf:
    each vector's one value, each total over the number of leaves (fails
    unless the leaves agree)."""
    n = len(counters["trips"])
    out = {}
    for f in ("trips", "force_refresh", "demoted"):
        if len(set(counters[f])) != 1:
            fail(f"guard counters: {f} {counters[f]} differ between leaves")
        out[f] = counters[f][0]
    for f in ("trip_total", "demotions"):
        out[f + "_per_leaf"] = counters[f] / n
    return out


def tensor_leaves(state) -> list:
    """``[(checkpoint path, tensor)]`` of every tensor of a train state:
    parameters, optimizer state, guard counters."""
    import torch
    from repro_torch.checkpoint.serialization import leaves_with_paths
    return [(p, leaf) for p, leaf in leaves_with_paths(state)
            if isinstance(leaf, torch.Tensor)]


def snapshot(state) -> list:
    """Copies of every tensor of ``state`` (on its device)."""
    return [(p, t.detach().clone()) for p, t in tensor_leaves(state)]


def unchanged(what: str, snap: list, state) -> None:
    """Fail unless every tensor of ``state`` equals the snapshot bitwise."""
    import torch
    now = tensor_leaves(state)
    if [p for p, _ in now] != [p for p, _ in snap]:
        fail(f"{what}: the state's structure changed")
    bad = [p for (p, a), (_, b) in zip(snap, now) if not torch.equal(a, b)]
    if bad:
        fail(f"{what}: {len(bad)} tensors changed, e.g. {bad[:3]}")
    print(f"  {what}: params and all {len(snap)} state tensors (m1 "
          f"included) bitwise unchanged")


def compare_states(a, b) -> tuple[bool, float]:
    """(every tensor bitwise equal, worst parameter error relative to the
    leaf's largest entry) of two train states of one structure."""
    import torch
    ta, tb = tensor_leaves(a), tensor_leaves(b)
    same = len(ta) == len(tb) and all(
        torch.equal(x.to(y.device), y) for (_, x), (_, y) in zip(ta, tb))
    worst = max(rel_err(b.params[k].float(), p.float())[1]
                for k, p in a.params.items())
    return same, worst


def hold_to_straight(what: str, state, ref, straight: tuple) -> str:
    """``state`` against the straight run ``ref`` by the straight runs' own
    standard ``straight = (bitwise, worst)``: bitwise if two straight runs
    are bitwise equal, else within their difference."""
    same, worst = compare_states(ref, state)
    if straight[0]:
        if not same:
            fail(f"{what}: not bitwise the straight run, whose two runs "
                 f"are (worst param rel err {worst:.2e})")
        return "bitwise equal, as the two straight runs are"
    if worst > straight[1]:
        fail(f"{what}: param rel err {worst:.2e} exceeds the straight runs' "
             f"own difference {straight[1]:.2e}")
    return (f"within the straight runs' difference ({worst:.2e} <= "
            f"{straight[1]:.2e}; they are not bitwise equal)")


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def ckpt_phase(device, mixed_params: dict, mixed_launches: dict) -> dict:
    """[ckpt]: the launcher's guarded mixed-groups run at full width, 12
    steps twice (without and with --ckpt-dir D --ckpt-every 4: the fold
    step's cost of saving, and whether two straight runs are bitwise
    equal), with the xi watchdog's trips and each leaf's xi; the run
    without guards ([train-mixed]) held to the guarded one whose
    watchdog cannot trip (--guard-skip-threshold 1); a
    launcher subprocess with --ckpt-dir SIGTERMed once step 6 is logged
    (its preemption checkpoint, meta.preempted) and the same command
    relaunched, ending at step 12 held to the straight run; then
    restore(save(state)) bitwise on the device (and a bf16 / int8 / int
    tree), the save's and the restore's seconds and bytes, and a
    bit-flipped, then truncated latest checkpoint skipped for the one
    before.  Each straight run launches exactly what [train-mixed]
    (``mixed_launches``) did.  Returns ``{label: (launches, info)}`` of
    the two in-process straight runs."""
    import signal
    import torch
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core.adapprox import adapprox_state
    from repro_torch.launch import train as launcher
    from repro_torch.resilience import corrupt_latest_checkpoint
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    expect = mixed_launches
    ref = {}
    out = {"guarded": train_main_path(
        launcher_run(TRAIN_GUARDED_ARGV), "fused", expect,
        keep=lambda st: ref.update(a=st))}
    saving_argv = TRAIN_GUARDED_ARGV + [
        "--ckpt-dir", str(CKPT_ROOT / "straight"), "--ckpt-every", "4"]
    phase("[ckpt] the same with " + " ".join(saving_argv[-4:]))
    out["guarded_ckpt"] = train_main_path(
        launcher_run(saving_argv), "fused", expect,
        keep=lambda st: ref.update(b=st))
    straight = compare_states(ref["a"], ref["b"])
    print(f"  two straight runs (without and with checkpoints): "
          f"{'bitwise equal' if straight[0] else 'NOT bitwise equal'}, "
          f"worst param rel err {straight[1]:.2e}; peak memory includes "
          f"the first run's state, held for the comparison")
    fold = [out[k][1]["fold_s"] for k in ("guarded", "guarded_ckpt")]
    wall = [out[k][1]["wall_s"] for k in ("guarded", "guarded_ckpt")]
    watch = guard_counters(ref["a"].opt_state)
    xi = [round(float(leaf.xi.max()), 4) for leaf in
          adapprox_state(ref["a"].opt_state).leaves if hasattr(leaf, "q")]
    print(f"  xi watchdog (threshold 0.75) over the 12 steps: "
          f"{watch['trip_total']} trips, trips in a row {watch['trips']}, "
          f"forced refresh next {watch['force_refresh']}; worst xi per "
          f"factored leaf at step 12 {xi}")
    del ref["b"]
    torch.cuda.empty_cache()
    phase("[ckpt] guards on, the watchdog above any xi: "
          + " ".join(TRAIN_GUARDED_CALM_ARGV[-4:]))
    calm = {}
    out["guarded_calm"] = train_main_path(
        launcher_run(TRAIN_GUARDED_CALM_ARGV), "fused", expect,
        keep=lambda st: calm.update(params={
            k: p.detach().cpu() for k, p in st.params.items()},
            counters=guard_counters(st.opt_state)))
    worst_off = max(rel_err(calm["params"][k], p)[1]
                    for k, p in mixed_params.items())
    same_off = all(torch.equal(calm["params"][k], p)
                   for k, p in mixed_params.items())
    trips, skips = (calm["counters"][k] for k in ("trip_total", "skipped"))
    print(f"  guards off ([train-mixed]) vs on ({trips} trips, {skips} "
          f"skips): "
          f"{'bitwise equal' if same_off else 'not bitwise'}, worst param "
          f"rel err {worst_off:.2e}")
    if trips or skips:
        fail(f"guards with threshold 1 tripped: {calm['counters']}")
    if straight[0] and not same_off:
        fail("guards on without faults is not bitwise the guards-off run")
    if not straight[0] and worst_off > straight[1]:
        fail(f"guards on vs off: {worst_off:.2e} beyond the straight runs' "
             f"difference {straight[1]:.2e}")

    ckdir = CKPT_ROOT / "preempt"
    argv = TRAIN_GUARDED_ARGV + ["--ckpt-dir", str(ckdir),
                                 "--ckpt-every", "4"]
    phase("[ckpt] launcher subprocess, SIGTERM once step 6 is logged: "
          + " ".join(argv))
    code = (f"import sys\nsys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "from repro_torch.launch import train as launcher\n"
            f"launcher.main({argv!r})\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    sent = False
    for line in proc.stdout:
        if " step " in line or "signal" in line or "Error" in line:
            print("  | " + line.rstrip()[-110:])
        if not sent and "step 6 loss" in line:
            proc.send_signal(signal.SIGTERM)
            sent = True
    rc = proc.wait(timeout=600)
    if rc != -signal.SIGTERM:
        fail(f"the SIGTERMed launcher exited {rc}, not by the signal")
    mgr = CheckpointManager(CheckpointConfig(directory=str(ckdir)))
    pre = mgr.latest_step()
    meta = mgr.read_meta(pre)
    print(f"  exit by SIGTERM; latest checkpoint step {pre}, meta {meta}")
    if pre is None or pre < 6 or meta.get("preempted") is not True:
        fail(f"preemption checkpoint: step {pre}, meta {meta}")
    phase("[ckpt] the same command relaunched")
    t0 = time.perf_counter()
    resumed, hist = launcher.main(argv)
    torch.cuda.synchronize()
    relaunch_s = time.perf_counter() - t0
    steps = [h["step"] for h in hist]
    if steps[0] != pre + 1 or steps[-1] != 12 or resumed.step != 12:
        fail(f"relaunch: steps {steps} after the checkpoint at {pre}")
    verdict = hold_to_straight("resumed run at step 12", resumed, ref["a"],
                               straight)
    print(f"  resumed from step {pre}, steps {steps[0]}-{steps[-1]} "
          f"({relaunch_s:.1f} s with the restore): {verdict}")
    del resumed
    torch.cuda.empty_cache()

    phase("[ckpt] restore(save(state)) on the device; corrupt latest "
          "checkpoints")
    rt = CheckpointManager(CheckpointConfig(
        directory=str(CKPT_ROOT / "roundtrip"), async_save=False))
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rt.save(ref["a"], 12, blocking=True)
    save_dev = torch.cuda.max_memory_allocated() - mem0
    nbytes = dir_bytes(CKPT_ROOT / "roundtrip" / "step_000000012")
    back, step = rt.restore(ref["a"])
    same, _ = compare_states(ref["a"], back)
    ints_same = (back.step == ref["a"].step == step
                 and guard_counters(back.opt_state)
                 == guard_counters(ref["a"].opt_state))
    if not (same and ints_same):
        fail("restore(save(state)) is not the state bitwise")
    del back
    gen = torch.Generator(device=device).manual_seed(3)
    small = {"bf16": torch.randn((257, 65), generator=gen, device=device
                                 ).to(torch.bfloat16),
             "int8": torch.randint(-128, 128, (300,), generator=gen,
                                   device=device).to(torch.int8),
             "int32": torch.randint(0, 9, (5,), generator=gen,
                                    device=device).int(),
             "fp32": torch.randn((3, 7), generator=gen, device=device),
             "count": 9}
    small_rt = CheckpointManager(CheckpointConfig(
        directory=str(CKPT_ROOT / "small"), async_save=False))
    small_rt.save(small, 1)
    small_back, _ = small_rt.restore(small)
    for k, t in small.items():
        ok = (small_back[k] == t if k == "count" else
              small_back[k].dtype == t.dtype
              and small_back[k].device == t.device
              and torch.equal(small_back[k], t))
        if not ok:
            fail(f"restore(save(tree)) on the device: {k} differs")
    print(f"  restore(save(state)): every tensor of the step-12 state "
          f"({len(tensor_leaves(ref['a']))}: fp32 params and state, int32 "
          f"ranks, the host's int32 guard counters) and every int bitwise; "
          f"bf16, int8, int32, fp32 and int leaves of a small tree on the "
          f"device bitwise")
    before = mgr.latest_step()
    second = ckpt_steps(ckdir)[-2]
    corrupt_latest_checkpoint(str(ckdir), kind="bitflip")
    _, got = mgr.restore(ref["a"])
    print(f"  bit-flipped latest (step {before}): restore skips it for "
          f"step {got}")
    if got != second:
        fail(f"restore after a bit flip landed on step {got}, not {second}")
    corrupt_latest_checkpoint(str(ckdir), kind="truncate")
    if mgr.latest_step() != second:
        fail(f"truncated latest still visible: latest_step "
             f"{mgr.latest_step()}")
    _, got = mgr.restore(ref["a"])
    print(f"  truncated latest: latest_step {mgr.latest_step()}, restore "
          f"step {got}")
    if got != second:
        fail(f"restore after a truncation landed on step {got}")
    card = card_line()
    costs = dict(gather_s=rt.last_gather_s, write_s=rt.last_write_s,
                 restore_s=rt.last_restore_s, bytes=nbytes,
                 fold_s_without=fold[0], fold_s_with=fold[1],
                 wall_s_without=wall[0], wall_s_with=wall[1],
                 relaunch_s=relaunch_s, straight_bitwise=straight[0],
                 straight_worst=straight[1], preempt_step=pre,
                 save_device_bytes=save_dev, watchdog_trips=watch[
                     "trip_total"], calm_fold_s=out["guarded_calm"][1][
                     "fold_s"])
    print(f"  [ckpt] costs on {card}: device-to-host copy "
          f"{rt.last_gather_s:.3f} s, write {rt.last_write_s:.3f} s, "
          f"restore {rt.last_restore_s:.3f} s, {nbytes} bytes on disk "
          f"({nbytes / 2**30:.3f} GiB), device memory the save allocated "
          f"{save_dev} bytes; fold step {fold[1]:.4f} s with "
          f"--ckpt-every 4 vs {fold[0]:.4f} s without; 12-step run "
          f"{wall[1]:.2f} s vs {wall[0]:.2f} s; the skip-step guard alone "
          f"(threshold 1) {out['guarded_calm'][1]['fold_s']:.4f} s a fold "
          f"step")
    del ref["a"]
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()
    out["costs"] = costs
    return out


def ckpt_steps(directory: Path) -> list:
    from repro_torch.checkpoint import serialization as SER
    return [SER.checkpoint_step(p) for p in SER.list_checkpoints(directory)]


def chaos_phase(device, mixed_launches: dict):
    """[chaos]: chain(inject_faults(NaN at steps 5 and 6, Inf at 9), the
    launcher's guarded mixed groups) at full width over 12 steps through
    the train loop, resumed from its own state between segments: every
    tensor of the state (params, m1 included) bitwise unchanged across
    each skipped step, 3 skips, the last at 9, every parameter finite, the
    loss falling, and B1 / B2 / B5 launched on every step, skipped ones
    too: as often as in [train-mixed] (``mixed_launches``).  A
    ``TelemetryRuntime`` with a sink rides the loop and must write exactly
    three ``kind="fault"`` ``skip`` events, at steps 5, 6 and 9.  Returns
    ``(launches, info)``."""
    import torch
    from repro_torch.configs.archs import get_config
    from repro_torch.core.build import build_optimizer
    from repro_torch.core.types import chain
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.config import TelemetryConfig
    from repro_torch.resilience import FaultPlan, inject_faults
    from repro_torch.telemetry import TelemetryRuntime, load_events
    from repro_torch.train.train_loop import LoopConfig, train
    cfg = get_config("gpt2-117m")
    model = build_model(cfg)
    events = CKPT_ROOT / "chaos_events"
    shutil.rmtree(events, ignore_errors=True)
    runtime = TelemetryRuntime(TelemetryConfig(enabled=True,
                                               dir=str(events)))
    opt = chain(inject_faults(FaultPlan(nan_steps=(5, 6), inf_steps=(9,))),
                build_optimizer(optimizer_config(
                    "adapprox", 12, 3e-3, refresh_every=5, fused_update=True,
                    mixed_groups=True, guards=True)))
    data = DataConfig(vocab=cfg.vocab, seq_len=1024, global_batch=8)
    hist = []

    def run_to(total, state):
        st, h = train(model, opt, data, LoopConfig(total_steps=total,
                                                   log_every=1),
                      device=device, state=state, telemetry=runtime)
        hist.extend(h)
        return st

    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    state = run_to(4, None)
    snap = snapshot(state)
    state = run_to(6, state)
    unchanged("steps 5 and 6 (NaN gradients)", snap, state)
    state = run_to(8, state)
    snap = snapshot(state)
    state = run_to(9, state)
    unchanged("step 9 (Inf gradients)", snap, state)
    del snap
    state = run_to(12, state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for h in hist:
        print(f"  step {h['step']:2d} loss {h['loss']:.4f} "
              f"step_time_s {h['step_time_s']:.4f}")
    g = state.opt_state[1]
    losses = [h["loss"] for h in hist]
    finite = all(bool(torch.isfinite(p).all())
                 for p in state.params.values())
    print(f"  skipped {g.skipped}, last_skip {g.last_skip}, steps "
          f"{g.steps}; params finite {finite}; launches {launches}")
    if (g.skipped, g.last_skip, g.steps) != (3, 9, 12):
        fail(f"chaos: skipped {g.skipped}, last_skip {g.last_skip}")
    if not finite or not all(math.isfinite(x) for x in losses):
        fail("chaos: a parameter or loss is not finite")
    if not losses[-1] < losses[0]:
        fail(f"chaos: loss did not fall ({losses[0]} -> {losses[-1]})")
    if launches != mixed_launches:
        fail(f"chaos: launches {launches}, expected {mixed_launches}")
    runtime.close()
    faults = [(e["step"], e["event"], e["skipped"])
              for e in load_events(events) if e["kind"] == "fault"]
    print(f"  fault events in the runtime's stream: {faults}")
    if faults != [(5, "skip", 1), (6, "skip", 2), (9, "skip", 3)]:
        fail(f"chaos: fault events {faults}, expected skips at 5, 6, 9")
    del state
    torch.cuda.empty_cache()
    return launches, {"loss": losses[-1], "wall_s": wall}


def same_as_mixed(what: str, state, mixed_state: list) -> None:
    """Fail unless every tensor of [train-mixed]'s final state
    (``mixed_state``: its paths and CPU copies) is in ``state``, bitwise
    equal; ``state`` may hold more (the telemetry snapshots)."""
    import torch
    now = dict(tensor_leaves(state))
    missing = [p for p, _ in mixed_state if p not in now]
    bad = [p for p, t in mixed_state
           if p in now and not torch.equal(now[p].detach().cpu(), t)]
    if missing or bad:
        fail(f"{what}: {len(missing)} of [train-mixed]'s tensors missing "
             f"({missing[:2]}), {len(bad)} differ ({bad[:3]})")
    print(f"  {what}: all {len(mixed_state)} parameter and state tensors of "
          f"[train-mixed] bitwise equal")


def averages(prof):
    """``prof.key_averages()``, computed once a profile: each call walks
    every event again (seconds for a refresh step's profile)."""
    if not hasattr(prof, "_chip_smoke_averages"):
        prof._chip_smoke_averages = prof.key_averages()
    return prof._chip_smoke_averages


def kernel_records(prof, what: str) -> None:
    """Fail unless the profile ``prof`` of ``what``, work known to launch
    kernels, holds a kernel record: a profile that lost them all would
    read no copies and no busy time."""
    from torch.autograd import DeviceType
    n = sum(e.count for e in averages(prof)
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset")))
    if n == 0:
        fail(f"{what}: the profile holds no kernel record")


def dtoh_copies(fn) -> int:
    """Device-to-host copies (torch.profiler's ``Memcpy DtoH`` activity)
    that ``fn()``, work that launches kernels, makes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernel_records(prof, "device-to-host copies")
    return sum(e.count for e in averages(prof)
               if "Memcpy DtoH" in e.key)


def mesh_phase(mixed_state: list, mixed_info: dict, mixed_expect: dict,
               olmoe_state: list, olmoe_info: dict) -> dict:
    """[mesh]: the launcher's distributed path (``--mesh 1,1 --fsdp``) on
    a one-rank NCCL group: every split leaf a DTensor on a (data=1,
    model=1) mesh, the step running on each rank's blocks (the model
    gathering at use, the optimizer updating the blocks, the new state
    wrapped from them), splitting the batch and summing the gradients
    over the dp axes through real collectives, OLMoE's MoE block through
    ``moe_apply_sharded`` (a model axis of 1).  Each is held
    bitwise to its run without a mesh ([train-mixed], [train-olmoe]):
    losses, launches and every final state tensor; per-rank state bytes
    and the fold / refresh step times printed beside the unsharded run's.
    GPT-2's run writes its checkpoint: JAX's spec string on every leaf,
    the param specs the rules give, ``mesh_axes`` {data: 1, model: 1},
    and a restore without a mesh bitwise the gathered final state."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core.types import tree_nbytes
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model_zoo import build_model
    t0 = time.monotonic()
    card = card_line()
    runs = {}

    def held(what, info, ref_info, ref_state, state):
        if info["losses"] != ref_info["losses"]:
            fail(f"[mesh] {what}: losses {info['losses']} vs "
                 f"{ref_info['losses']} without a mesh")
        full = tensor_leaves(SH.gather_tree(state))
        ref = dict(ref_state)
        if [p for p, _ in full] != [p for p, _ in ref_state]:
            fail(f"[mesh] {what}: the state's leaves differ")
        bad = [p for p, t in full
               if not torch.equal(t.detach().cpu(), ref[p])]
        if bad:
            fail(f"[mesh] {what}: {len(bad)} state tensors differ from the "
                 f"run without a mesh, e.g. {bad[:3]}")
        rank_mb = tree_nbytes(state.opt_state) / 1e6
        info["rank_param_bytes"] = tree_nbytes(state.params)
        info["rank_opt_state_bytes"] = tree_nbytes(state.opt_state)
        print(f"  {what}: losses and all {len(full)} state tensors bitwise "
              f"the run without a mesh; optimizer state per rank "
              f"{rank_mb:.1f} MB vs {ref_info['state_mb']:.1f} MB without "
              f"a mesh; fold step {info['fold_s']:.4f} vs "
              f"{ref_info['fold_s']:.4f} s "
              f"({info['fold_s'] / ref_info['fold_s'] - 1:+.1%}); "
              f"refresh steps "
              f"{info['refresh_s']} vs {ref_info['refresh_s']}; peak "
              f"{info['peak_gib']:.2f} vs {ref_info['peak_gib']:.2f} GiB "
              f"({card})")
        return full

    ckpt = CKPT_ROOT / "mesh"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = TRAIN_MIXED_ARGV + MESH_ARGV + ["--ckpt-dir", str(ckpt),
                                           "--ckpt-every", "12"]
    phase("[mesh] GPT-2 117M, " + " ".join(argv))
    kept = {}
    runs["mesh"] = train_main_path(launcher_run(argv), "fused", mixed_expect,
                                   keep=lambda st: kept.update(st=st))
    full = held("GPT-2 117M (mixed)", runs["mesh"][1], mixed_info,
                mixed_state, kept["st"])
    step_dir = ckpt / "step_000000012"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    specs = dict(zip(manifest["paths"],
                     [e["spec"] for e in manifest["leaves"]]))
    if manifest["mesh_axes"] != {"data": 1, "model": 1}:
        fail(f"[mesh] manifest mesh_axes {manifest['mesh_axes']}")
    if not all(str(s).startswith("PartitionSpec(") for s in specs.values()):
        fail("[mesh] a manifest leaf has no spec string")
    from repro_torch.launch import train as launcher
    params = {k: v for k, v in kept["st"].params.items()}
    want = SH.param_pspecs(build_model(launcher.get_config("gpt2-117m")),
                           {"data": 1, "model": 1}, params=params)
    for name, spec in want.items():
        path = ".params" + "".join(f"[{k!r}]" for k in name.split("/"))
        if specs[path] != str(spec):
            fail(f"[mesh] {path}: {specs[path]} in the manifest, the rules "
                 f"give {spec}")
    like = SH.gather_tree(kept["st"])
    restored, step = CheckpointManager(CheckpointConfig(
        directory=str(ckpt))).restore(like)
    bad = [p for (p, a), (_, b) in zip(tensor_leaves(restored), full)
           if not torch.equal(a, b)]
    if step != 12 or bad:
        fail(f"[mesh] restore without a mesh: step {step}, {len(bad)} "
             f"tensors differ, e.g. {bad[:3]}")
    split = sum(1 for s in specs.values() if "'data'" in s)
    print(f"  manifest: {len(specs)} leaves with spec strings, {split} "
          f"split over data, mesh_axes {manifest['mesh_axes']}; restore "
          f"without a mesh bitwise")
    del kept, full, like, restored
    shutil.rmtree(ckpt, ignore_errors=True)

    phase(f"[mesh] OLMoE-1B-7B at full width, n_layers 16 -> {DENSE_LAYERS}, "
          f"moe_apply_sharded, " + " ".join(TRAIN_OLMOE_ARGV + MESH_ARGV))
    kept = {}
    with depth_cut(DENSE_LAYERS):
        runs["mesh_olmoe"] = train_main_path(
            launcher_run(TRAIN_OLMOE_ARGV + MESH_ARGV), "fused",
            OLMOE_EXPECT, steps=6, tokens=2 * 2048,
            keep=lambda st: kept.update(st=st))
    held("OLMoE-1B-7B (4 layers)", runs["mesh_olmoe"][1], olmoe_info,
         olmoe_state, kept["st"])
    del kept
    dist.destroy_process_group()
    runs["mesh-ranks"], runs["serve-mesh"] = mesh_gloo_run(card)
    print(f"  [mesh] {time.monotonic() - t0:.1f} s")
    return runs


# [mesh]'s two-rank run: the smoke GPT-2 as scripts/mesh_ranks.py trains it
# (its smoke SSM cases the same way)
MESH_RANKS_ARGV = ["--arch", "gpt2-117m", "--smoke", "--steps", "6",
                   "--fused-update", "--refresh-every", "5", "--log-every",
                   "1", "--device", "cuda"]
TOL_MESH_RANKS = 1e-3        # the CPU tests' cross-mesh tolerance
# [mesh]'s smoke serving case in fp32 compute against the run without a
# mesh: B6's fp32 kernel computes each head alike on either route, so only
# the split products' sums over model and the decode's log-sum-exp combine
# differ, in summation order (1.1e-6 on the CPU), as the CPU tests'
# serving parity (test_torch_mesh_serve.py, 1e-4).  The full-width case
# runs in bf16 and takes TOL_SERVE_DENSE, [serve-qwen2]'s tolerance.
TOL_SERVE_MESH = 1e-4


def mesh_ranks_module():
    """``scripts/mesh_ranks.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "mesh_ranks", ROOT / "scripts" / "mesh_ranks.py")
    MR = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(MR)
    return MR


def ssd_rank_held(device, name: str, cfg, batch: int, seq: int,
                  ranks: int, backward: bool = True,
                  mesh: str | None = None) -> None:
    """B7's forward (and, ``backward``, its backward: :func:`check_ssd`)
    held to its plain version at the shape a rank of a model axis of
    ``ranks`` gives it in ``cfg``'s Mamba2 block, in its compute dtype;
    ``mesh`` names the mesh in the label (``1,<ranks>`` by default)."""
    import torch
    from repro_torch.kernels import ops, ref
    s = cfg.ssm
    nh = s.expand * cfg.d_model // s.head_dim
    shape = (batch, seq, nh // ranks, s.n_groups, s.head_dim, s.d_state,
             s.chunk)
    name = f"{name}, a rank of --mesh {mesh or f'1,{ranks}'}"
    if backward:
        check_ssd(device, [(name, shape, (cfg.dtype,), True)], timed=None)
        return
    gen = torch.Generator(device=device).manual_seed(12)
    with torch.inference_mode():
        ins = ssd_inputs(gen, shape, getattr(torch, cfg.dtype), device)
        got, again = ops.ssd_chunk_fwd(*ins), ops.ssd_chunk_fwd(*ins)
        want = ref.ssd_chunk(*ins)
        torch.cuda.synchronize()
        errs = hold(f"ssd_chunk {name}", ("y",), (TOL_SSD,), (got,), (want,),
                    new_rec(), (again,))
    print(f"  ssd_chunk {name} {shape} {cfg.dtype} fwd: {errs}")


def mesh_gloo_run(card: str) -> tuple:
    """[mesh]'s cases on gloo ranks sharing cuda:0 (NCCL refuses two ranks
    on one device), all in one subprocess (``scripts/mesh_ranks.py
    --ranks-only --case all --mesh 1,2 --serve --full``) and two
    spawns.  Two ranks at --mesh 1,2: first the training cases of
    ``mesh_ranks.TRAIN_CASES`` (the smoke GPT-2, the smoke Mamba2-370m,
    Zamba2-2.7B and Whisper-large-v3, Mamba2-370m at full width, 12 of 48
    layers), the products split over ``model``, then the serving cases,
    each a prefill of 2 prompts and 8 decode steps on each rank's blocks,
    the KV cache's sequence split: the smoke Qwen2-7B and
    Whisper-large-v3 at head_dim 64 (4 q / 2 kv heads, 2 layers) in fp32
    compute at 8192 tokens (B6 on each rank's heads), the smoke
    Mamba2-370m and Zamba2-2.7B in fp32 at 1024 (B7 on each rank's SSM
    heads), then Qwen2-7B at full width and depth (28 layers),
    Zamba2-2.7B (12 of 54 layers, ``mesh_ranks.SERVE_DEPTH``: 2
    shared-block applications) and Whisper-large-v3 (1500 frames; its
    ``SERVE_DEPTH``) at full width in bf16 at 8192, Whisper's cross cache
    split over ``model`` by its encoder rows.  Four ranks at --mesh 2,2:
    the long-context cases (``mesh_ranks.LONG_CASES``: the smoke
    Zamba2-2.7B in fp32 and Zamba2-2.7B, 12 layers, in bf16), B = 1, a
    prompt of 8192 into a cache of 16,384 rows whose sequence splits
    over (data, model), and 8 decode steps into the second data group's
    block.  Before the spawns B7's forward and backward (training) and
    B6's and B7's forwards (serving) are held to their plain versions at
    the shapes a rank gives them (:func:`ssd_rank_held`,
    :func:`flash_fwd_held`), and each case runs without a mesh in this
    process (its memory freed before the ranks start).  Each training
    case's losses are held to its run at rtol ``TOL_MESH_RANKS`` and
    each rank's B7 launches are those the depth implies
    (``mesh_ranks.train_launches``); every serving step's logits are
    held to its run (``TOL_SERVE_MESH``, ``TOL_SERVE_DENSE``,
    ``TOL_SERVE_SSM``), the greedy tokens equal but at a tie
    (:func:`parting`), and every run's launches in the prefill and in
    decode are those the depth implies (``mesh_ranks.expected_launches``:
    B7 once a Mamba2 layer and B6 once an attention layer past 4096
    tokens in the prefill, neither in decode).  Returns ``((the ranks'
    training launches summed over the cases, info), (the same of
    serving))``."""
    import torch
    MR = mesh_ranks_module()
    device = torch.device("cuda", 0)
    t0 = time.monotonic()
    phase("[mesh] two gloo ranks on cuda:0, --mesh 1,2 (heads, SSM heads, "
          "MLP and vocabulary split over model), training: "
          + "; ".join(" ".join(a) for a in MR.TRAIN_CASES.values()))
    train_refs, held = {}, set()
    for case in MR.TRAIN_CASES:
        cfg = MR.train_config(case)
        batch, seq = MR.TRAIN_SHAPE[case]
        if cfg.ssm is not None and (cfg.ssm, batch, seq) not in held:
            ssd_rank_held(device, f"{case} {cfg.arch} training", cfg,
                          batch, seq, 2)
            held.add((cfg.ssm, batch, seq))
        train_refs[case] = MR.run_case(case)
        MR.free_memory()
    phase("[mesh] serving on the same two ranks, --mesh 1,2: smoke Qwen2-7B "
          "and Whisper-large-v3 at head_dim 64, smoke Mamba2-370m and "
          "Zamba2-2.7B in fp32, then Qwen2-7B, Zamba2-2.7B and "
          "Whisper-large-v3 at full width in bf16, each a prefill (B6 / B7 "
          "on each rank's heads) and 8 decode steps, the KV cache's "
          "sequence, Whisper's cross cache's encoder rows and the Mamba "
          "states' heads split over model; then on four ranks, --mesh 2,2, "
          "the smoke Zamba2-2.7B in fp32 and Zamba2-2.7B at full width in "
          "bf16 at long_500k's layout (B = 1, the KV sequence over (data, "
          "model))")
    serve_cases = MR.serve_cases(full=True)
    long_cases = MR.long_cases(full=True)
    gen = torch.Generator(device=device).manual_seed(11)
    serve_refs = {}
    for case in serve_cases + long_cases:
        cfg = MR.serve_config(case)
        prompt = MR.SERVE_CASES[case][0]
        batch, _, mesh = MR.serve_shape(case)
        m = mesh[1]
        if MR.expected_launches(case)["prefill"]["flash_fwd"]:
            shape = (batch, prompt, prompt, cfg.n_heads // m,
                     max(cfg.n_kv_heads // m, 1), cfg.resolved_head_dim)
            with torch.inference_mode():
                got = flash_fwd_held(device, gen, f"{case} {cfg.arch}, a "
                                     f"rank of --mesh {mesh[0]},{m}", shape,
                                     getattr(torch, cfg.dtype), new_rec())
            del got
        if cfg.ssm is not None:
            ssd_rank_held(device, f"{case} {cfg.arch}", cfg, batch,
                          prompt, m, backward=False,
                          mesh=f"{mesh[0]},{m}")
        MR.free_memory()
        serve_refs[case] = MR.serve_case(case, device)
        if not MR.launches_held(case, serve_refs[case]["launches"]):
            fail(f"[mesh] {case} serving without a mesh: launches "
                 f"{serve_refs[case]['launches']}, "
                 f"{MR.expected_launches(case)} expected")
        MR.free_memory()
    refs_s = time.monotonic() - t0
    out = ROOT / "build" / "mesh_ranks.json"
    out.unlink(missing_ok=True)
    t_spawn = time.monotonic()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "mesh_ranks.py"),
         "--ranks-only", "--case", "all", "--mesh", "1,2", "--serve",
         "--full", "--json", str(out)], capture_output=True, text=True,
        timeout=900)
    spawn_s = time.monotonic() - t_spawn
    none = {"error": "no result"}
    res = json.loads(out.read_text()) if out.exists() else {
        "train": none, "serve": none, "long": none}
    said = f"\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}"
    train = mesh_train_held(MR, res["train"], train_refs, said)
    serve = mesh_serve_held(MR, res["serve"], {
        c: serve_refs[c] for c in serve_cases}, str(out), said)
    longs = mesh_serve_held(MR, res.get("long", none), {
        c: serve_refs[c] for c in long_cases}, f"{out}.long", said)
    for k, n in longs[0].items():
        serve[0][k] = serve[0].get(k, 0) + n
    serve[1].update(longs[1])
    cases_s = sum(i["rank_seconds"] for c, i in train[1].items()) + sum(
        max(i["rank_seconds"]) for i in serve[1].values())
    seconds = time.monotonic() - t0
    train[1]["seconds"] = serve[1]["seconds"] = seconds
    train[1]["spawn_seconds"] = spawn_s
    print(f"  two gloo ranks: {seconds:.1f} s, of which the holds and the "
          f"runs without a mesh {refs_s:.1f} s, the subprocess "
          f"{spawn_s:.1f} s (the ranks' start "
          f"{res.get('startup_seconds', 0):.1f} s, their cases "
          f"{cases_s:.1f} s) ({card})")
    return train, serve


def mesh_train_held(MR, res: dict, refs: dict, said: str) -> tuple:
    """The training cases of a :func:`mesh_gloo_run` held (see there):
    ``(the ranks' launches summed over the cases, info)``."""
    info, counts = {}, {}
    for case, ref in refs.items():
        got = res.get(case, {}).get("1,2")
        if got is None or "error" in res:
            fail(f"[mesh] two ranks, {case}: "
                 f"{res.get('error', 'no result')}{said}")
        err = MR.losses_err(got, ref)
        want = MR.train_launches(case)
        per_rank = [{k: r[k] for k in want}
                    for r in res[case]["1,2 launches"]]
        if err > TOL_MESH_RANKS or per_rank != [want] * 2:
            fail(f"[mesh] two ranks, {case}: losses {got} vs {ref} without "
                 f"a mesh, largest relative difference {err:.3e}; B7 "
                 f"launches a rank {per_rank} ({want} expected)")
        for launched in res[case]["1,2 launches"]:
            for k, n in launched.items():
                counts[k] = counts.get(k, 0) + n
        info[case] = {"max_rel_err": err, "losses": got, "ref": ref,
                      "rank_seconds": res[case]["1,2 seconds"],
                      "rank_peak_gib": res[case]["1,2 peak_gib"],
                      "ssd_launches_per_rank": per_rank}
        print(f"  {case} --mesh 1,2 on two gloo ranks on cuda:0: losses "
              f"{got} vs {ref} without a mesh, largest relative difference "
              f"{err:.3e} (rtol {TOL_MESH_RANKS}); B7 launches a rank "
              f"{per_rank}; {res[case]['1,2 seconds']:.1f} s (rank 0), "
              f"peak a rank {res[case]['1,2 peak_gib']} GiB")
    return counts, info


def mesh_serve_held(MR, res: dict, refs: dict, out: str, said: str) -> tuple:
    """The serving cases of a :func:`mesh_gloo_run` held (see there):
    ``(the ranks' launches summed over the cases, info)``."""
    info, counts = {}, {}
    for case, ref in refs.items():
        bad = MR.serve_errors(res, case)
        if bad:
            fail(f"[mesh] {case} serving on gloo ranks: {bad}{said}")
        ranks = [r[case] for r in res["ranks"]]
        err, ties = MR.hold_serve(case, ref, out)
        tol = MR.SERVE_TOL[case]
        per_rank = [{phase_: {k: r["launches"][phase_][k]
                              for k in ("ssd_fwd", "flash_fwd")}
                     for phase_ in ("prefill", "decode")} for r in ranks]
        held = all(MR.launches_held(case, r["launches"]) for r in ranks)
        if err > tol or ties < 0 or not held:
            fail(f"[mesh] {case} serving on gloo ranks: largest logit "
                 f"difference {err:.3e} (tolerance {tol}), greedy tokens "
                 f"{'differ beyond a tie' if ties < 0 else 'equal'}, "
                 f"launches a rank {per_rank} "
                 f"({MR.expected_launches(case)} expected)")
        for r in ranks:
            for launched in r["launches"].values():
                for k, n in launched.items():
                    counts[k] = counts.get(k, 0) + n
        info[case] = {"max_rel_err": err, "tolerance": tol,
                      "greedy_ties": ties, "launches_per_rank": per_rank,
                      "rank_seconds": [r["seconds"] for r in ranks],
                      "rank_peak_gib": [r["peak_gib"] for r in ranks],
                      "ref_seconds": ref["seconds"],
                      "ref_peak_gib": ref["peak_gib"]}
        mesh = ",".join(map(str, MR.serve_shape(case)[2]))
        print(f"  --mesh {mesh} serving, {case}: largest logit difference "
              f"{err:.3e} of the largest logit (tolerance {tol}), greedy "
              f"tokens equal but {ties} ties; launches a rank {per_rank}, "
              f"as the depth implies; prefill + {MR.SERVE_STEPS} steps "
              f"{info[case]['rank_seconds']} s a rank, "
              f"{ref['seconds']:.2f} s without a mesh; peak a rank "
              f"{info[case]['rank_peak_gib']} GiB, {ref['peak_gib']:.2f} "
              f"without a mesh")
    return counts, info


# [dryrun]: the card's fold-step peak over the dry run's prediction (the
# plain route's, on fake tensors), which must lie within these
DRYRUN_PEAK_RATIO = (0.97, 1.03)


def dryrun_cell(mesh, train: bool = True):
    """[mesh]'s GPT-2 117M configuration as the dry run's cell on ``mesh``:
    the full config, the launcher's mixed groups (--fused-update
    --refresh-every 5, 12 steps), [train-mixed]'s batch 8 x 1024."""
    from repro_torch.config import ShapeCell
    from repro_torch.configs.archs import get_config
    from repro_torch.core.build import build_optimizer
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model
    cfg = get_config("gpt2-117m")
    model = build_model(cfg, mesh)
    model.constrain = SH.make_act_constrainer(mesh, "train")
    opt = build_optimizer(optimizer_config(
        "adapprox", 12, 3e-3, refresh_every=5, fused_update=True,
        mixed_groups=True))
    return D.Cell("gpt2-117m", "train-mixed", cfg,
                  ShapeCell("train-mixed", 1024, 8, "train"), mesh, model,
                  opt=opt)


def dryrun_predict() -> dict:
    """The dry run's record of :func:`dryrun_cell`'s step 2 (a fold step)
    on a one-rank fake mesh (1, 1), on fake CPU tensors: no card."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_fake_mesh
    try:
        c = dryrun_cell(make_fake_mesh((1, 1), ("data", "model")))
        return D.measure(c, start_step=1)
    finally:
        dist.destroy_process_group()


def dryrun_measure(device) -> dict:
    """:func:`dryrun_cell` on a one-rank NCCL group on the card, as the
    launcher's ``--mesh 1,1 --fsdp`` places and steps it: step 1 (a
    refresh), then step 2 (a fold) from a reset peak; the fold step's
    ``max_memory_allocated`` and the state's per-rank bytes after it."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.types import tree_nbytes
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.steps import TrainState, build_train_step
    torch.cuda.empty_cache()
    try:
        c = dryrun_cell(make_mesh((1, 1), ("data", "model"), "cuda"))
        params = c.model.init(torch.Generator(device=device).manual_seed(0))
        sshard, bshard = SH.train_shardings(
            c.model, c.opt, c.mesh, {"tokens": (8, 1024)}, fsdp=True,
            params=params)
        state = SH.place_state(TrainState.create(params, c.opt), sshard)
        del params
        step = build_train_step(c.model, c.opt, state_shardings=sshard,
                                batch_shardings=bshard)
        data = SyntheticLM(DataConfig(vocab=c.cfg.vocab, seq_len=1024,
                                      global_batch=8))
        batches = [{"tokens": torch.from_numpy(data.batch_at(i)["tokens"])
                    .to(device)} for i in range(2)]
        state, _ = step(state, batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        state, met = step(state, batches[1])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if not math.isfinite(float(met["loss"])):
            fail(f"[dryrun] the card's step 2 loss {met['loss']}")
        return {"peak_bytes": peak, "held_bytes": held,
                "param_bytes": tree_nbytes(state.params),
                "opt_state_bytes": tree_nbytes(state.opt_state)}
    finally:
        dist.destroy_process_group()


def dryrun_phase(device, mesh_info: dict) -> dict:
    """[dryrun]: the dry run's prediction of [mesh]'s GPT-2 117M run
    against the card.  Its per-rank parameter and optimizer-state bytes
    must equal the card's exactly, both the 2-step run's and [mesh]'s
    12-step final state's; the card's fold-step ``max_memory_allocated``
    must lie within ``DRYRUN_PEAK_RATIO`` of its predicted peak (the
    plain route's, on fake tensors), printed with their ratio."""
    t0 = time.monotonic()
    pred = dryrun_predict()
    t_pred = time.monotonic() - t0
    got = dryrun_measure(device)
    for key, mesh_key in (("param_bytes", "rank_param_bytes"),
                          ("opt_state_bytes", "rank_opt_state_bytes")):
        if not pred[key] == got[key] == mesh_info[mesh_key]:
            fail(f"[dryrun] {key}: predicted {pred[key]}, the card's "
                 f"2-step run {got[key]}, [mesh]'s final state "
                 f"{mesh_info[mesh_key]}")
    ratio = got["peak_bytes"] / pred["peak_bytes"]
    if not DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1]:
        fail(f"[dryrun] the card's fold-step peak {got['peak_bytes']} B is "
             f"{ratio:.4f} of the predicted {pred['peak_bytes']} B, outside "
             f"{DRYRUN_PEAK_RATIO}")
    print(f"  per-rank bytes: parameters {pred['param_bytes']}, optimizer "
          f"state {pred['opt_state_bytes']}: predicted = the card's 2-step "
          f"run = [mesh]'s final state, exactly")
    print(f"  fold step (step 2) peak: predicted {pred['peak_bytes']} B "
          f"({pred['peak_bytes'] / 2**30:.3f} GiB, plain route, at "
          f"{pred['peak_op']}), the card's max_memory_allocated "
          f"{got['peak_bytes']} B ({got['peak_bytes'] / 2**30:.3f} GiB, "
          f"{got['held_bytes'] / 2**30:.3f} GiB held before it): "
          f"measured / predicted {ratio:.4f} ({card_line()})")
    secs = time.monotonic() - t0
    print(f"  [dryrun] {secs:.1f} s (the dry run {t_pred:.1f} s of it); "
          f"predicted flops {pred['flops']:.4g}, collectives "
          f"{pred['collectives']}")
    return {"predicted_peak_bytes": pred["peak_bytes"],
            "measured_peak_bytes": got["peak_bytes"],
            "measured_over_predicted": ratio,
            "param_bytes": pred["param_bytes"],
            "opt_state_bytes": pred["opt_state_bytes"],
            "flops": pred["flops"], "seconds": secs}


def telemetry_phase(device, mixed_state: list, mixed_expect: dict) -> dict:
    """[telemetry]: GPT-2 117M at full width on the launcher's mixed
    groups, --fused-update --refresh-every 5, 12 steps, seed 0, as
    [train-mixed], with the telemetry subsystem on:

      1. a ``TelemetryRuntime`` without the controller: the final state
         bitwise [train-mixed]'s (``mixed_state``), every step's snapshot
         xi and k those of the leaves, refresh + fold == step, refreshes
         at 1, 6 and 11 only, B1 / B2 / B5 launched as in [train-mixed];
      2. the closed loop (``auto_refresh``, interval 2, relax_patience 1,
         a dynamic cadence from 5): every refresh where ``_refresh_pred``
         puts it under the cadence then, by the snapshot's counters and by
         B1's calls with and without the fold; a fresh controller fed the
         recorded interval means gives the same cadence log; the run
         saved at step 7 (mid-interval) and restored into a new loop
         gives the same log and bitwise the same parameters;
      3. the whole launcher with --telemetry-dir D --trace-dir D
         --metrics-every 4 --auto-refresh --guards: launches as
         [train-mixed], its stream valid, a train_step span with a phase
         each step, metrics.prom parses;
      4. cost: everything on (telemetry, a dynamic cadence and the
         controller, a sink, the tracer, metrics every 4) against
         everything off, resumed from their own states in alternating
         segments: the fold steps' times, paired, and both final states
         bitwise [train-mixed]'s (on: a constant dynamic cadence of 5 is
         the static run); device-to-host copies of one fold step,
         telemetry on and off, with and without --guards: telemetry adds
         at most one, and none under the guards.

    Returns ``{path: train_main_path's result}`` for runs 1 and 3."""
    import numpy as np
    import torch
    from repro_torch import telemetry as T
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.config import TelemetryConfig
    from repro_torch.configs.archs import get_config
    from repro_torch.core.adapprox import _refresh_pred, adapprox_state
    from repro_torch.core.build import build_optimizer
    from repro_torch.core.factored import FactoredLeaf
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.telemetry.snapshot import fetch_host
    from repro_torch.train.train_loop import LoopConfig, train
    cfg = get_config("gpt2-117m")
    model = build_model(cfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=1024, global_batch=8)
    ocfg = lambda **kw: optimizer_config(
        "adapprox", 12, 3e-3, refresh_every=5, fused_update=True,
        mixed_groups=True, **{"telemetry": True, **kw})
    folds = []                      # B1's calls since the last step
    plain_precond = ops.fused_precond

    def precond(*args, **kw):
        folds.append(bool(kw.get("with_fold")))
        return plain_precond(*args, **kw)

    class Checked(T.TelemetryRuntime):
        """The runtime, and after each of its steps the checks of the
        phase: the snapshot against the leaves and the counters, B1's
        calls against the refresh decision."""

        def __init__(self, tcfg):
            super().__init__(tcfg)
            self.rows = []

        def on_step(self, step, state):
            out = super().on_step(step, state)
            snap = T.named_snapshots(state.opt_state)["factored"]
            fetch_host([snap])
            fact = [leaf for leaf in adapprox_state(state.opt_state).leaves
                    if isinstance(leaf, FactoredLeaf)]
            own = torch.stack(
                [torch.mean(leaf.xi.float()) for leaf in fact]
                + [torch.mean(torch.clamp_max(leaf.k, factor_width(leaf))
                              .float()) for leaf in fact]).cpu().numpy()
            if not np.array_equal(own, np.concatenate(
                    [snap.host("xi"), snap.host("k")])):
                fail(f"[telemetry] step {step}: snapshot xi / k "
                     f"{snap.host('xi')} / {snap.host('k')} are not the "
                     f"leaves' {own}")
            t = snap.refresh_every
            want = t <= 1 or _refresh_pred(step, t)
            if (snap.step != step or snap.refresh_steps + snap.fold_steps
                    != step or bool(snap.did_refresh) != want
                    or folds != [not want] * len(fact)):
                fail(f"[telemetry] step {step}: snapshot step {snap.step}, "
                     f"refresh {snap.refresh_steps} + fold "
                     f"{snap.fold_steps}, did_refresh {snap.did_refresh} "
                     f"at cadence {t}; B1 calls with the fold {folds}")
            self.rows.append((step, bool(snap.did_refresh), t,
                              float(np.mean(snap.host("xi")))))
            folds.clear()
            return out

    def checked_run(rt, steps=12, ckpt=None, **kw):
        def run():
            folds.clear()
            ops.fused_precond = precond
            try:
                return train(model, build_optimizer(ocfg(**kw)), data,
                             LoopConfig(total_steps=steps, log_every=1,
                                        ckpt=ckpt), device=device,
                             telemetry=rt)
            finally:
                ops.fused_precond = plain_precond
        return run

    out = {}
    t_phase = time.monotonic()
    print("  1. telemetry, no controller:")
    rt = Checked(TelemetryConfig(enabled=True))
    out["telemetry"] = train_main_path(
        checked_run(rt), "fused", mixed_expect,
        keep=lambda st: same_as_mixed("telemetry on", st, mixed_state))
    refreshed = [step for step, did, _, _ in rt.rows if did]
    print(f"  refreshes at steps {refreshed}; snapshot xi and k equal the "
          f"leaves' at all {len(rt.rows)} steps")
    if refreshed != [1, 6, 11]:
        fail(f"[telemetry] refreshes at {refreshed}, expected 1, 6, 11")

    print("  2. the closed loop, interval 2, relax_patience 1:")
    loop_cfg = TelemetryConfig(enabled=True, auto_refresh=True, interval=2,
                               relax_patience=1)
    rt_a = Checked(loop_cfg)
    state_a, _ = checked_run(rt_a, dynamic_refresh=True)()
    print(f"  cadence log {rt_a.cadence_log}")
    print("  steps (step, refreshed, cadence, mean xi): " + ", ".join(
        f"({s}, {int(d)}, {t}, {x:.4f})" for s, d, t, x in rt_a.rows))
    ctl, t, replay = T.RefreshController(T.ControllerConfig(
        interval=2, relax_patience=1)), 5, []
    for step, _, _, xi in rt_a.rows:
        c = ctl.observe(step, "factored", xi, t)
        if c is not None:
            replay.append((c.step, "factored", c.old, c.new))
            t = c.new
    if replay != rt_a.cadence_log or not replay:
        fail(f"[telemetry] a fresh controller gives {replay}, the run "
             f"{rt_a.cadence_log}")
    d = CKPT_ROOT / "telemetry"
    shutil.rmtree(d, ignore_errors=True)
    ck = CheckpointConfig(directory=str(d), save_every=7, async_save=False)
    checked_run(Checked(loop_cfg), steps=7, ckpt=ck,
                dynamic_refresh=True)()
    rt_c = Checked(loop_cfg)
    state_c, _ = checked_run(rt_c, ckpt=ck, dynamic_refresh=True)()
    same, worst = compare_states(state_a, state_c)
    print(f"  saved at 7, restored into a new loop: cadence log "
          f"{rt_c.cadence_log}; state {'bitwise equal' if same else worst}"
          f" to the straight run's")
    if rt_c.cadence_log != rt_a.cadence_log or not same:
        fail("[telemetry] the resumed closed loop differs from the "
             "straight run")
    del state_a, state_c
    shutil.rmtree(d, ignore_errors=True)

    print("  3. the launcher with every telemetry flag:")
    d = CKPT_ROOT / "telemetry_launcher"
    shutil.rmtree(d, ignore_errors=True)
    argv = TRAIN_MIXED_ARGV + [
        "--telemetry-dir", str(d), "--trace-dir", str(d), "--metrics-every",
        "4", "--auto-refresh", "--guards"]
    out["telemetry_launcher"] = train_main_path(launcher_run(argv), "fused",
                                                mixed_expect)
    n_events = T.validate_dir(d)
    events = T.load_events(d)
    phases = {e["step"]: e.get("attrs", {}).get("phase") for e in events
              if e["kind"] == "span" and e["name"] == "train_step"}
    prom = T.parse_prometheus((d / "metrics.prom").read_text())["samples"]
    kinds = sorted({e["kind"] for e in events})
    print(f"  {n_events} events valid ({kinds}); train_step phases "
          f"{[phases.get(i) for i in range(1, 13)]}; check_events "
          f"{T.check_events(events)}; metrics.prom train_steps_total "
          f"{prom.get('train_steps_total')}")
    if [phases.get(i) for i in range(1, 13)] != [
            "refresh" if i % 5 == 1 else "fold" for i in range(1, 13)]:
        fail(f"[telemetry] train_step phases {phases}")
    if T.check_events(events) or prom.get("train_steps_total") != 12.0:
        fail("[telemetry] the launcher's spans or metrics.prom are wrong")
    shutil.rmtree(d, ignore_errors=True)

    print("  4. cost, everything on vs everything off, fold steps paired:")
    d = CKPT_ROOT / "telemetry_cost"
    shutil.rmtree(d, ignore_errors=True)
    sink = T.TelemetrySink(T.SinkConfig(directory=str(d)))
    on = dict(ocfg=ocfg(dynamic_refresh=True), rt=T.TelemetryRuntime(
        TelemetryConfig(enabled=True, auto_refresh=True), sink=sink),
        tracer=T.Tracer(sink=sink, registry=T.MetricsRegistry()))
    off = dict(ocfg=ocfg(telemetry=False), rt=None, tracer=None)
    for ctx in (on, off):
        ctx.update(opt=build_optimizer(ctx["ocfg"]), state=None, t={})

    def advance(ctx, total):
        stamps = {}
        ctx["state"], _ = train(
            model, ctx["opt"], data, LoopConfig(total_steps=total,
                                                log_every=1),
            device=device, state=ctx["state"], telemetry=ctx["rt"],
            tracer=ctx["tracer"], metrics_every=4 if ctx["rt"] else 0,
            metric_hook=lambda step, m: stamps.update(
                {step: time.perf_counter()}))
        ctx["t"].update({s: stamps[s] - stamps[s - 1] for s in stamps
                         if s - 1 in stamps and s % 5 != 1})

    for total in (1, 5, 10, 12):
        for ctx in ((on, off) if total % 2 else (off, on)):
            advance(ctx, total)
    fold_on, fold_off = (sorted(c["t"].values()) for c in (on, off))
    pairs = [on["t"][s] - off["t"][s] for s in sorted(on["t"])]
    med = lambda xs: xs[len(xs) // 2]
    print(f"  fold-step period (step to step, the whole loop body), "
          f"{len(pairs)} pairs: on median {med(fold_on):.4f} s, off "
          f"{med(fold_off):.4f} s; on - off per pair (ms) "
          f"{[round(x * 1e3, 2) for x in pairs]}, median "
          f"{med(sorted(pairs)) * 1e3:.2f} ms ({card_line()})")
    same_as_mixed("everything on, a constant dynamic cadence of 5",
                  on["state"], mixed_state)
    same_as_mixed("everything off", off["state"], mixed_state)
    copies = {}
    for ctx, label in ((on, "on"), (off, "off")):
        copies[label] = dtoh_copies(lambda: advance(ctx, 13))
    for ctx in (on, off):
        ctx["state"] = None
    for label, tel in (("guards on", True), ("guards off", False)):
        ctx = dict(opt=build_optimizer(ocfg(guards=True, telemetry=tel)),
                   rt=(T.TelemetryRuntime(TelemetryConfig(enabled=True),
                                          sink=sink) if tel else None),
                   tracer=None, state=None, t={})
        advance(ctx, 1)
        copies[("on" if tel else "off") + ", guards"] = dtoh_copies(
            lambda: advance(ctx, 2))
        del ctx
    sink.close()
    shutil.rmtree(d, ignore_errors=True)
    print(f"  device-to-host copies in one fold step (the loop's log line "
          f"included): {copies}; the runtime's own: "
          f"{on['rt'].transfers} in 13 steps ({card_line()})")
    if (copies["on"] - copies["off"] > 1
            or copies["on, guards"] != copies["off, guards"]):
        fail(f"[telemetry] telemetry adds {copies['on'] - copies['off']} "
             f"copies, {copies['on, guards'] - copies['off, guards']} "
             f"under the guards")
    torch.cuda.empty_cache()
    print(f"  [telemetry] took {time.monotonic() - t_phase:.1f} s")
    return out


def guards_phase(device, cpu_counters: dict):
    """[guards]: the xi watchdog at full width, the launcher's mixed groups
    with --guards --guard-skip-threshold 0 --max-demotions 2, 6 steps
    through the train loop one step at a time: every factored leaf trips at
    step 1, refreshes at step 2 off the cadence (Q moves; refresh_every 5),
    trips again and is demoted; from step 3 B1 and B2 launch no more; the
    loss finite throughout; the final counters, per leaf, those of
    [parity-guards]' CPU run of the same schedule.  Returns ``(launches,
    info)``."""
    import torch
    from repro_torch.configs.archs import get_config
    from repro_torch.core.adapprox import adapprox_state
    from repro_torch.core.build import build_optimizer
    from repro_torch.core.factored import FactoredLeaf
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_loop import LoopConfig, train
    cfg = get_config("gpt2-117m")
    model = build_model(cfg)
    opt = build_optimizer(optimizer_config(
        "adapprox", 12, 3e-3, refresh_every=5, fused_update=True,
        mixed_groups=True, guards=True, guard_xi_trip=0.0, max_demotions=2))
    data = DataConfig(vocab=cfg.vocab, seq_len=1024, global_batch=8)
    torch.cuda.empty_cache()
    reset_launches()
    state, qs, per_step, counters = None, [], [], []
    prev = launch_counts()
    for t in range(1, 7):
        state, hist = train(model, opt, data,
                            LoopConfig(total_steps=t, log_every=1),
                            device=device, state=state)
        now = launch_counts()
        per_step.append({k: now[k] - prev[k] for k in now if now[k] - prev[k]})
        prev = now
        qs.append([leaf.q.clone() for leaf in
                   adapprox_state(state.opt_state).leaves
                   if isinstance(leaf, FactoredLeaf)])
        counters.append(guard_counters(state.opt_state))
        print(f"  step {t} loss {hist[-1]['loss']:.4f} step_time_s "
              f"{hist[-1]['step_time_s']:.4f}; launches {per_step[-1]}; "
              f"trips {counters[-1]['trips']} force "
              f"{counters[-1]['force_refresh']} demoted "
              f"{counters[-1]['demoted']}")
        if not math.isfinite(hist[-1]["loss"]):
            fail(f"guards: loss not finite at step {t}")
    n = len(qs[0])
    if counters[0]["trips"] != [1] * n or counters[0]["force_refresh"] != [
            1] * n:
        fail(f"guards: step 1 counters {counters[0]}")
    moved = [not torch.equal(a, b) for a, b in zip(qs[0], qs[1])]
    if not all(moved):
        fail(f"guards: the forced refresh at step 2 left Q of leaves "
             f"{[i for i, m in enumerate(moved) if not m]} as it was")
    if counters[1]["demoted"] != [1] * n:
        fail(f"guards: not every leaf demoted at step 2: {counters[1]}")
    fact_launch = [s.get("fused_precond", 0) for s in per_step]
    apply_launch = [s.get("fused_apply", 0) for s in per_step]
    if fact_launch != [n, n, 0, 0, 0, 0] or apply_launch != fact_launch:
        fail(f"guards: pass 1 / pass 2 launches a step {fact_launch} / "
             f"{apply_launch}, expected {n}, {n}, then none")
    mine, theirs = per_leaf(counters[-1]), per_leaf(cpu_counters)
    print(f"  forced refresh at step 2 (off the cadence 1, 6, 11): Q moved "
          f"on all {n} factored leaves; all demoted at step 2; per leaf "
          f"{mine} vs [parity-guards] CPU {theirs}")
    if mine != theirs:
        fail(f"guards: per-leaf counters {mine} vs the CPU run's {theirs}")
    launches = launch_counts()
    del state, qs
    torch.cuda.empty_cache()
    return launches, {"loss": hist[-1]["loss"]}


# -- serving -----------------------------------------------------------------

class ServeRecorder:
    """The model as a serving engine sees it, recording on the card the
    logits row that each request's every token came from, keyed ``(uid,
    index of the token in its stream)``, and the seconds of each prefill
    and decode call up to a synchronize (the engines keep only the argmax).
    The wave engine hands it its wave (``wave``), the continuous engine
    itself (``engine``), so that each row finds its request."""

    def __init__(self, model):
        self.model = model
        self.engine = None
        self.wave = []
        self.rows = {}
        self.seconds = {"prefill": [], "decode": []}

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _timed(self, kind: str, fn, *args):
        import torch
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        self.seconds[kind].append(time.perf_counter() - t0)
        return out

    def prefill(self, params, tokens, cache):
        logits, cache = self._timed("prefill", self.model.prefill, params,
                                    tokens, cache)
        for i, r in enumerate(self.wave):
            self.rows[(r.uid, 0)] = logits[i, -1]
        return logits, cache

    def decode_step(self, params, cache, tokens):
        logits, cache = self._timed("decode", self.model.decode_step,
                                    params, cache, tokens)
        for i, r in enumerate(self.wave):
            if not r.done:
                self.rows[(r.uid, len(r.out_tokens))] = logits[i, -1]
        return logits, cache

    def prefill_paged(self, params, pool, tokens, table, p0, last_idx):
        import numpy as np
        logits, pool = self._timed("prefill", self.model.prefill_paged,
                                   params, pool, tokens, table, p0, last_idx)
        eng, row = self.engine, table.cpu().numpy()
        for s in eng.slots:
            if (s.phase == "prefill" and s.prompt_done == p0
                    and np.array_equal(s.table.padded(eng.nbt), row)
                    and p0 + last_idx + 1 == len(s.req.prompt)):
                self.rows[(s.req.uid, 0)] = logits[0, -1]
        return logits, pool

    def decode_paged(self, params, pool, tokens, tables, positions):
        logits, pool = self._timed("decode", self.model.decode_paged,
                                   params, pool, tokens, tables, positions)
        for i, s in enumerate(self.engine.slots):
            if s.phase == "decode":
                self.rows[(s.req.uid, len(s.req.out_tokens))] = logits[i, -1]
        return logits, pool


@contextlib.contextmanager
def serve_recorded(layers: int | None = None, **over):
    """Within it, ``repro_torch.launch.serve`` builds its model wrapped in
    a :class:`ServeRecorder` (yielded as ``rec["model"]``) and its engines
    hand it what it needs; with ``layers`` or ``over``, the arch's full
    config cut and changed as :func:`arch_config` does."""
    from repro_torch.launch import serve as launcher
    saved = (launcher.build_model, launcher.Engine,
             launcher.ContinuousEngine, launcher.get_config)
    rec = {}

    def build(cfg):
        rec["model"] = ServeRecorder(saved[0](cfg))
        return rec["model"]

    class Wave(saved[1]):
        def run_wave(self, reqs, t0=None):
            self.model.wave = reqs
            super().run_wave(reqs, t0)

    class Continuous(saved[2]):
        def __init__(self, model, *args, **kw):
            super().__init__(model, *args, **kw)
            model.engine = self

    launcher.build_model, launcher.Engine = build, Wave
    launcher.ContinuousEngine = Continuous
    if layers is not None or over:
        launcher.get_config = lambda arch: arch_config(arch, layers, **over)
    try:
        yield rec
    finally:
        (launcher.build_model, launcher.Engine, launcher.ContinuousEngine,
         launcher.get_config) = saved


def forward_rows(model, params, prompt, out_tokens: list, embeds=None,
                 pad_to: int = 1):
    """The full forward of ``prompt + out_tokens`` (zero tokens after them
    up to a multiple of ``pad_to``: the SSD chunk; the model is causal, so
    they change no earlier position): its logits rows, fp32, from the last
    prompt position on (one a generated token, and one after the last)."""
    import torch
    dev = params["embed"].device
    seq = [int(t) for t in prompt] + [int(t) for t in out_tokens]
    seq += [0] * ((-len(seq)) % pad_to)
    toks = torch.tensor(seq, device=dev)[None]
    with torch.inference_mode():
        if embeds is None:
            logits, _ = model.forward(params, toks)
        else:
            logits, _ = model.forward(params, toks, embeds)
    front = (embeds.shape[1] if embeds is not None
             and model.cfg.family == "vlm" else 0)
    lo = front + len(prompt) - 1
    rows = logits[0, lo:lo + len(out_tokens) + 1].float()
    del logits
    torch.cuda.empty_cache()
    return rows


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def hold_teacher_forced(what: str, model, params, items, pad_to: int = 1
                        ) -> dict:
    """For each of ``items`` (prompt, out_tokens, rows: the logits each
    token came from, embeds): the rows against the full forward's at the
    same positions (:func:`forward_rows`), relative to the forward's
    largest entry, failing past the family's ``TOL_SERVE``; and the rows
    against the forward's one position later (a cache path off by one
    position reads so: O(1) for the decoders, 5e-2 for Whisper at random
    init, whose decoder output barely moves with the position), failing
    below ``SERVE_SHIFT_MARGIN`` times the tolerance, where the gate could
    not tell such a path; beside them, how many tokens the forward's
    argmax gives too.  For the first request, the witness, unchecked: the
    bf16 forward against an fp32 forward (the same parameters, compute
    dtype float32) of the same sequence.  Returns the worst error, the
    smallest shifted error and the witness."""
    import torch
    from repro_torch.models.model_zoo import build_model
    worst, shifted_min, witness = 0.0, math.inf, None
    tol = TOL_SERVE[model.cfg.family]
    for i, (prompt, out, rows, embeds) in enumerate(items):
        want = forward_rows(model, params, prompt, out, embeds, pad_to)
        got = torch.stack([r.float() for r in rows])
        n = len(rows)
        err, shifted = _rel(got, want[:n]), _rel(got, want[1:n + 1])
        same = int((want[:n].argmax(-1).cpu() == torch.tensor(
            [int(t) for t in out][:n])).sum())
        print(f"  {what} request {i}: teacher-forced logits rel err "
              f"{err:.3e} over {n} tokens (tolerance {tol}; against the "
              f"next position's: {shifted:.3e}, at least "
              f"{SERVE_SHIFT_MARGIN * tol:.3e}); the forward's argmax "
              f"agrees on {same} of {n}")
        if i == 0:
            fp32 = build_model(dataclasses.replace(model.cfg,
                                                   dtype="float32"))
            witness = _rel(want[:n], forward_rows(fp32, params, prompt, out,
                                                  embeds, pad_to)[:n])
            print(f"  {what} witness: the bf16 forward against an fp32 "
                  f"forward of request 0's sequence, rel err {witness:.3e} "
                  f"(unchecked)")
        del want, got
        if not err <= tol:
            fail(f"{what}: request {i} teacher-forced logits rel err "
                 f"{err:.3e} > {tol}")
        if not shifted >= SERVE_SHIFT_MARGIN * tol:
            fail(f"{what}: request {i}: the rows against the next "
                 f"position's read {shifted:.3e}, under "
                 f"{SERVE_SHIFT_MARGIN} x {tol}: the gate could not tell a "
                 f"path off by one position")
        worst, shifted_min = max(worst, err), min(shifted_min, shifted)
    return {"teacher_forced_err": worst, "next_position_err": shifted_min,
            "bf16_vs_fp32_forward": witness}


def serve_summary(what: str, tokens: int, ttft: float, wall: float, rec,
                  launches: dict, peak: float, steps: str) -> dict:
    """Print and return a serve run's numbers: tokens/s over the run's
    wall time, mean TTFT, seconds, peak memory, seconds a prefill call and
    a decode step (medians, each up to a synchronize), launches."""
    med = lambda xs: statistics.median(xs) if xs else None
    info = {"tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
            "ttft_mean_s": ttft, "peak_gib": peak, "steps": steps,
            "prefill_s": med(rec.seconds["prefill"]),
            "prefill_calls": len(rec.seconds["prefill"]),
            "decode_s": med(rec.seconds["decode"]),
            "decode_calls": len(rec.seconds["decode"])}
    live = {k: v for k, v in launches.items() if v}
    print(f"  {what}: {tokens} tokens in {wall:.2f} s ({tokens / wall:.1f} "
          f"tokens/s, {steps}), mean TTFT {ttft * 1e3:.1f} ms, peak "
          f"{peak:.2f} GiB; prefill {info['prefill_calls']} calls, median "
          f"{info['prefill_s']:.4f} s; decode {info['decode_calls']} steps, "
          f"median {info['decode_s']:.4f} s; launches {live}")
    return info


def serve_run(device, argv, expect: dict, what: str, layers=None,
              params=None, pad_to: int = 1, gate: bool = True, **over):
    """One run of ``repro_torch.launch.serve``'s ``main`` on the card with
    the launch counters set to 0 just before it: every request served to
    its budget, the allocator drained (continuous), the launches those of
    ``expect`` (every other kernel 0), and the teacher-forced gate on each
    request.  Returns ``(launches, info, (engine, reqs, recorder))``."""
    import torch
    from repro_torch.launch import serve as launcher
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with serve_recorded(layers, **over) as rec:
        reset_launches()
        t0 = time.perf_counter()
        eng, reqs = launcher.main(argv, params=params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = rec["model"]
    budget = int(argv[argv.index("--max-new") + 1])
    if any(len(r.out_tokens) != budget for r in reqs):
        fail(f"{what}: streams {[len(r.out_tokens) for r in reqs]} long, "
             f"budget {budget}")
    continuous = hasattr(eng, "alloc")
    if continuous and not (eng.alloc.free_blocks() == eng.alloc.usable
                           == eng.alloc.available()):
        fail(f"{what}: allocator not drained: {eng.alloc.free_blocks()} "
             f"free, {eng.alloc.available()} available of "
             f"{eng.alloc.usable}")
    want = {**dict.fromkeys(launches, 0), **expect}
    steps = (f"{eng.steps} engine steps" if continuous
             else f"{eng.waves} waves")
    info = serve_summary(
        what, sum(len(r.out_tokens) for r in reqs),
        statistics.mean(r.first_token_s - r.arrival_s for r in reqs), wall,
        rec, launches, peak, steps)
    if continuous:
        print(f"  allocator drained: {eng.alloc.usable} of "
              f"{eng.alloc.usable} blocks free, nothing reserved")
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")
    if gate:
        info.update(hold_teacher_forced(
            what, rec.model, eng.params,
            [(r.prompt, r.out_tokens,
              [rec.rows[(r.uid, t)] for t in range(len(r.out_tokens))],
              None) for r in reqs], pad_to))
    rec.engine = None        # the engine and its model refer to each other
    return launches, info, (eng, reqs, rec)


def parting(a, b, ta: int, tb: int, tol: float) -> tuple:
    """Where two runs' greedy tokens part, ``ta`` chosen from the logits
    row ``a`` and ``tb`` from ``b``: ``(the rows' largest difference over
    b's largest entry, each row's lead of its own token over the other's
    in bf16 ulps of the row's largest entry, whether that is a tie: the
    rows within ``tol`` and each lead within SERVE_TIE_ULPS)``."""
    diff = float((a - b).abs().max()) / float(b.abs().max())
    gaps = [float((r[mine] - r[other]) / bf16_ulp(r.abs().max()))
            for r, mine, other in ((a, ta, tb), (b, tb, ta))]
    return diff, gaps, diff <= tol and max(gaps) <= SERVE_TIE_ULPS


def hold_streams(what: str, cont, wave) -> int:
    """The continuous run's streams against the wave run's of the same
    requests: equal, or where one parts, both logits rows at that step
    within the family's ``TOL_SERVE`` of each other and the two chosen
    tokens tied in each row to within ``SERVE_TIE_ULPS`` bf16 ulps of the
    row's largest entry.  Prints both rows' numbers; returns the count of
    streams that part."""
    import torch
    (_, c_reqs, c_rec), (_, w_reqs, w_rec) = cont, wave
    tol = TOL_SERVE[c_rec.model.cfg.family]
    parted = 0
    for c, w in zip(c_reqs, w_reqs):
        t = next((i for i, (a, b) in enumerate(zip(c.out_tokens,
                                                   w.out_tokens)) if a != b),
                 None)
        if t is None:
            continue
        parted += 1
        a, b = c_rec.rows[(c.uid, t)].float(), w_rec.rows[(w.uid, t)].float()
        tc, tw = c.out_tokens[t], w.out_tokens[t]
        diff, gaps, tie = parting(a, b, tc, tw, tol)
        print(f"  {what} request {c.uid} parts at token {t}: continuous "
              f"{tc} vs wave {tw}; rows rel diff {diff:.3e}; each row's "
              f"token leads the other's by {gaps[0]:g} (continuous) and "
              f"{gaps[1]:g} (wave) bf16 ulps of the row's largest entry")
        if not tie:
            fail(f"{what}: request {c.uid} parts at token {t} without a "
                 f"tie (rows {diff:.3e} > {tol}, or leads {gaps} ulps > "
                 f"{SERVE_TIE_ULPS})")
        del a, b
    torch.cuda.empty_cache()
    print(f"  {what}: {len(c_reqs) - parted} of {len(c_reqs)} streams equal "
          f"the wave engine's token for token; the {parted} that part each "
          f"do so at a tie within {SERVE_TIE_ULPS} bf16 ulps")
    return parted


def serve_qwen2(device) -> dict:
    """[serve-qwen2]: Qwen2-7B whole through the launcher, the wave run
    (B6's forward 28 times, nothing else), the continuous run, the
    continuous requests through the wave engine; each gated teacher-forced
    and the continuous streams held to the wave's."""
    import torch
    out = {}
    phase("[serve-qwen2] wave, " + " ".join(SERVE_WAVE_ARGV))
    t_p = time.monotonic()
    launches, info, (eng, reqs, rec) = serve_run(
        device, SERVE_WAVE_ARGV, dict(flash_fwd=QWEN2_LAYERS), "serve-qwen2 "
        "wave")
    params = eng.params
    out["serve-qwen2-wave"] = (launches, info)
    del eng, reqs, rec
    print(f"  [serve-qwen2] wave: {time.monotonic() - t_p:.1f} s")
    phase("[serve-qwen2] continuous, " + " ".join(SERVE_CONT_ARGV))
    t_p = time.monotonic()
    launches, info, cont = serve_run(device, SERVE_CONT_ARGV, {},
                                     "serve-qwen2 continuous", params=params)
    out["serve-qwen2-continuous"] = (launches, info)
    phase("[serve-qwen2] the same requests through the wave engine, "
          + " ".join(SERVE_CONT_WAVE_ARGV))
    launches, info, wave = serve_run(device, SERVE_CONT_WAVE_ARGV, {},
                                     "serve-qwen2 wave (4 slots)",
                                     params=params)
    out["serve-qwen2-wave4"] = (launches, info)
    out["serve-qwen2-continuous"][1]["parted"] = hold_streams(
        "serve-qwen2", cont, wave)
    del cont, wave, params
    torch.cuda.empty_cache()
    print(f"  [serve-qwen2] continuous and its wave: "
          f"{time.monotonic() - t_p:.1f} s")
    return out


def serve_direct(device, arch: str, layers, batch: int, prompt: int,
                 steps: int, front: int, expect: dict, **over):
    """``arch`` at full width (``layers`` deep), seed-0 init, driven through
    ``init_cache`` / ``prefill`` (with ``front`` rows of stub frontend
    ``embeds``) / ``steps`` greedy ``decode_step``s on the card, the
    launch counters set to 0 just before; the launches those of
    ``expect``, and the teacher-forced gate per row.  Returns ``(launches,
    info)``."""
    import torch
    from repro_torch.models.model_zoo import build_model
    cfg = arch_config(arch, layers, **over)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    dt = getattr(torch, cfg.dtype)
    embeds = torch.randn((batch, front, cfg.d_model), generator=gen,
                         device=device).to(dt)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                           device=device)
    n_front = front if cfg.family == "vlm" else 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = ServeRecorder(model)
    rows = [[] for _ in range(batch)]
    outs = [[] for _ in range(batch)]
    reset_launches()
    t0 = time.perf_counter()
    cache = model.init_cache(batch, n_front + prompt + steps, device=device)
    logits, cache = rec._timed("prefill", model.prefill, params, tokens,
                               cache, embeds)
    ttft = time.perf_counter() - t0
    for _ in range(steps + 1):
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        for b in range(batch):
            rows[b].append(logits[b, -1])
            outs[b].append(int(tok[b]))
        if len(outs[0]) > steps:
            break
        logits, cache = rec._timed("decode", model.decode_step, params,
                                   cache, tok[:, None])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del cache
    what = f"serve-{arch}"
    print(f"  {what}: batch {batch}, {n_front} frontend + {prompt} prompt "
          f"tokens")
    info = serve_summary(what, batch * (steps + 1), ttft, wall, rec,
                         launches, peak, f"{steps} steps")
    want = {**dict.fromkeys(launches, 0), **expect}
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")
    info.update(hold_teacher_forced(
        what, model, params,
        [(tokens[b].tolist(), outs[b], rows[b], embeds[b:b + 1])
         for b in range(batch)]))
    del params, model, rows, logits
    torch.cuda.empty_cache()
    return launches, info


def serve_families(device) -> dict:
    """[serve-families]: Mamba2-370m and Zamba2-2.7B (whole) on the wave
    engine, Whisper-large-v3 (whole) and LLaVA-NeXT-Mistral-7B (4 layers)
    driven directly, OLMoE-1B-7B (4 layers) on the continuous engine; each
    at full width with its launches and the teacher-forced gate."""
    from repro_torch.configs.archs import get_config
    out = {}
    phase("[serve-families] Mamba2-370m, " + " ".join(SERVE_MAMBA_ARGV))
    t_p = time.monotonic()
    launches, info, _ = serve_run(device, SERVE_MAMBA_ARGV,
                                  dict(ssd_fwd=SSD_LAYERS),
                                  "serve-mamba2", pad_to=256)
    out["serve-mamba2"] = (launches, info)
    phase("[serve-families] Zamba2-2.7B whole, " + " ".join(SERVE_ZAMBA_ARGV))
    launches, info, _ = serve_run(device, SERVE_ZAMBA_ARGV,
                                  dict(ssd_fwd=ZAMBA_LAYERS,
                                       flash_fwd=ZAMBA_APPS),
                                  "serve-zamba2", pad_to=256)
    out["serve-zamba2"] = (launches, info)
    w = SERVE_WHISPER
    phase(f"[serve-families] Whisper-large-v3 whole, prefill of batch "
          f"{w['batch']} with 1500 stub frames and {w['prompt']} tokens, "
          f"then {w['steps']} decode_steps")
    out["serve-whisper"] = serve_direct(
        device, WHISPER, None, w["batch"], w["prompt"], w["steps"],
        arch_config(WHISPER).enc_seq, {})
    v = SERVE_LLAVA
    phase(f"[serve-families] LLaVA-NeXT-Mistral-7B, n_layers 32 -> "
          f"{LLAVA_LAYERS}, attn_impl \"chunked\", prefill of batch "
          f"{v['batch']} x (576 image + {v['text']} text tokens), then "
          f"{v['steps']} decode_steps")
    out["serve-llava"] = serve_direct(
        device, LLAVA, LLAVA_LAYERS, v["batch"], v["text"], v["steps"],
        arch_config(LLAVA).frontend_tokens, dict(flash_fwd=LLAVA_LAYERS),
        attn_impl="chunked")
    # dropless, as the published OLMoE: capacity = the token count at any
    # batch (capacity_factor n_experts / top_k).  At the config's 1.25 a
    # 4-row decode step keeps one token an expert where the forward of a
    # whole sequence keeps ceil(0.156 T), so the two drop different tokens
    # and the teacher-forced gate would compare two functions.
    moe = get_config(OLMOE).moe
    dropless = dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k)
    phase(f"[serve-families] OLMoE-1B-7B, n_layers 16 -> {DENSE_LAYERS}, "
          f"dropless (capacity_factor {dropless.capacity_factor}), "
          + " ".join(SERVE_OLMOE_ARGV))
    launches, info, _ = serve_run(device, SERVE_OLMOE_ARGV, {},
                                  "serve-olmoe", layers=DENSE_LAYERS,
                                  moe=dropless)
    out["serve-olmoe"] = (launches, info)
    print(f"  [serve-families]: {time.monotonic() - t_p:.1f} s")
    return out


def _to_device(tree: dict, dev) -> dict:
    return {k: _to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _cache_tensors(cache) -> dict:
    """A serving cache's tensors by name (KV, Mamba, cross), as CPU
    copies (``clone``: on the CPU ``.cpu()`` returns the cache itself,
    which the next decode step writes)."""
    out = {}
    for key, val in cache.items():
        if key == "pos":
            continue
        if hasattr(val, "_fields"):
            for f in val._fields:
                out[f"{key}.{f}"] = getattr(val, f).float().cpu().clone()
        else:
            out[key] = val.float().cpu().clone()
    return out


def _hold_parity(what: str, got, want, worst: list) -> None:
    ab, rel = rel_err(got.float().cpu(), want.float().cpu())
    worst.append((rel, what))
    if not rel <= TOL_SERVE_PARITY:
        fail(f"[parity-serve] {what}: rel err {rel:.3e} > "
             f"{TOL_SERVE_PARITY}")


def parity_serve(device) -> None:
    """[parity-serve]: every family's smoke model in fp32 compute, the same
    init and inputs on the CPU and the card: the prefill and six decode
    steps (the CPU's greedy tokens fed to both), logits and caches within
    ``TOL_SERVE_PARITY``; the paged trio (gpt2: prefill_paged in two
    chunks and one, six decode_paged steps with a parked row), logits and
    the pool but its null block; and paged decode against dense decode on
    the card from one ``pool_from_dense``, bitwise."""
    import numpy as np
    import torch
    from repro_torch.configs.archs import get_smoke_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import BlockAllocator, SlotTable, pool_from_dense
    cpu = torch.device("cpu")
    for arch, plen, front in PARITY_SERVE:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        model = build_model(cfg)
        init = model.init(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (2, plen), generator=gen)
        rows = cfg.enc_seq if front == "enc_seq" else front
        embeds = (None if rows is None else
                  torch.randn((2, rows, cfg.d_model), generator=gen))
        fed, runs = [], []
        for dev in (cpu, device):
            p = _to_device(init, dev)
            kw = {} if embeds is None else {"embeds": embeds.to(dev)}
            cache = model.init_cache(2, 48, device=dev)
            logits, cache = model.prefill(p, tokens.to(dev), cache, **kw)
            run = {"logits": [logits.cpu()], "prefill": _cache_tensors(cache)}
            for i in range(6):
                if dev == cpu:
                    fed.append(torch.argmax(logits[:, -1], -1)[:, None])
                logits, cache = model.decode_step(p, cache, fed[i].to(dev))
                run["logits"].append(logits.cpu())
            run["final"] = _cache_tensors(cache)
            runs.append(run)
        worst = []
        for i, (a, b) in enumerate(zip(runs[1]["logits"],
                                       runs[0]["logits"])):
            _hold_parity(f"{arch} logits {i}", a, b, worst)
        for when in ("prefill", "final"):
            for k in runs[0][when]:
                _hold_parity(f"{arch} {when} cache {k}", runs[1][when][k],
                             runs[0][when][k], worst)
        rel, at = max(worst)
        print(f"  {arch}: prefill + 6 decode steps, logits and caches card "
              f"vs CPU within {rel:.3e} of the largest entry (worst: {at})")
    # the paged trio, card against CPU
    cfg = dataclasses.replace(get_smoke_config("gpt2-117m"), dtype="float32")
    model = build_model(cfg)
    init = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 512, (21,), generator=gen),
               torch.randint(0, 512, (9,), generator=gen)]
    # slot 0 reaches position 26: its 4th block (3) holds 24 on, as the
    # engine grows a table before a step; a null column there would take
    # the parked row's duplicate writes into block 0 and be read unmasked
    tables = torch.tensor([[5, 2, 9, 3, 0, 0], [7, 1, 12, 0, 0, 0],
                           [0] * 6])
    runs, fed = [], []      # fed: the CPU's greedy tokens, fed to both
    for dev in (cpu, device):
        p = _to_device(init, dev)
        pool = model.init_paged_cache(13, 8, device=dev)
        out = []
        for slot, chunks in ((0, ((0, 16, 16), (16, 5, 8))),
                             (1, ((0, 9, 16),))):
            for p0, real, padded in chunks:
                chunk = torch.zeros((1, padded), dtype=torch.long)
                chunk[0, :real] = prompts[slot][p0:p0 + real]
                logits, pool = model.prefill_paged(
                    p, pool, chunk.to(dev), tables[slot].to(dev), p0,
                    real - 1)
                out.append(logits.cpu())
            if dev == cpu:
                fed.append(int(torch.argmax(logits[0, -1])))
        positions = torch.tensor([21, 9, 0])
        toks = torch.tensor([[fed[0]], [fed[1]], [0]])
        for i in range(6):
            logits, pool = model.decode_paged(p, pool, toks.to(dev),
                                              tables.to(dev),
                                              positions.to(dev))
            out.append(logits[:2].cpu())
            if dev == cpu:
                fed.append(torch.argmax(logits[:2, -1], -1).cpu())
            toks[:2, 0] = fed[2 + i]
            positions[:2] += 1
        runs.append((out, {k: v[:, 1:].cpu() for k, v in pool.items()}))
    worst = []
    for i, (a, b) in enumerate(zip(runs[1][0], runs[0][0])):
        _hold_parity(f"paged logits {i}", a, b, worst)
    for k in ("k", "v"):
        _hold_parity(f"pool {k}", runs[1][1][k], runs[0][1][k], worst)
    rel, at = max(worst)
    print(f"  paged trio (gpt2 smoke): prefill_paged 16 + 8 (padded) and 16 "
          f"(padded), 6 decode_paged steps with a parked row: card vs CPU "
          f"within {rel:.3e} (worst: {at}); the null block not compared")
    # paged decode against dense decode on the card, from one dense prefill
    p = _to_device(init, device)
    cache_len, bs = 128, 16
    nbt = cache_len // bs
    prompts = torch.randint(0, 512, (2, 16), generator=gen).to(device)
    cache = model.init_cache(2, cache_len, device=device)
    logits, cache = model.prefill(p, prompts, cache)
    alloc = BlockAllocator(2 * nbt + 1, bs)
    slot_tables = [SlotTable(alloc.alloc(nbt)) for _ in range(2)]
    pool = pool_from_dense(model, cache, slot_tables, [16, 16],
                           2 * nbt + 1, bs)
    tabs = torch.from_numpy(np.stack([t.padded(nbt) for t in slot_tables])
                            ).long().to(device)
    toks = torch.argmax(logits[:, -1], -1)[:, None]
    pos = torch.full((2,), 16, device=device)
    diffs = []
    for _ in range(6):
        ld, cache = model.decode_step(p, cache, toks)
        lp, pool = model.decode_paged(p, pool, toks, tabs, pos)
        diffs.append(float((ld - lp).abs().max()))
        toks = torch.argmax(ld[:, -1], -1)[:, None]
        pos += 1
    print(f"  paged decode vs dense decode on the card from one "
          f"pool_from_dense, 6 steps: max abs diff per step {diffs}")
    if any(diffs):
        fail("[parity-serve] paged decode is not bitwise the dense decode "
             "on the card")


SERVE_FLASH = ("qwen2-7b serve prefill", (2, 8192, 8192, 28, 4, 128))
SERVE_SSD = [("mamba2-370m serve prefill", (2, 1024, 32, 1, 64, 128, 256)),
             ("zamba2-2.7b serve prefill", (1, 8192, 80, 1, 64, 64, 256))]


# -- the examples --------------------------------------------------------------

def example(name: str):
    """``examples/torch/<name>.py`` loaded as a module (the examples are
    scripts, not a package); its ``main(argv)`` runs it."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def engines_recorded(mod):
    """Within it, each ``Engine`` and ``ContinuousEngine`` that ``mod``
    builds wraps its model in a :class:`ServeRecorder` of its own, yielded
    as ``rec["wave"]`` / ``rec["continuous"]`` (the last one built of
    each)."""
    saved = (mod.Engine, mod.ContinuousEngine)
    rec = {}

    class Wave(saved[0]):
        def __init__(self, model, *args, **kw):
            rec["wave"] = ServeRecorder(model)
            super().__init__(rec["wave"], *args, **kw)

        def run_wave(self, reqs, t0=None):
            self.model.wave = reqs
            super().run_wave(reqs, t0)

    class Continuous(saved[1]):
        def __init__(self, model, *args, **kw):
            rec["continuous"] = ServeRecorder(model)
            super().__init__(rec["continuous"], *args, **kw)
            rec["continuous"].engine = self

    mod.Engine, mod.ContinuousEngine = Wave, Continuous
    try:
        yield rec
    finally:
        mod.Engine, mod.ContinuousEngine = saved


def examples_phase() -> dict:
    """[examples]: the four examples of ``examples/torch`` on the card, each
    through its ``main`` as its command line runs it.  train_gpt2_pile.py
    --full (GPT-2 117M at full width, batch 16 x 256, the launcher's mixed
    groups) trains ``EXAMPLE_GPT2_STEPS`` steps into a checkpoint directory
    and runs again: the loss falls, the second run restores at the last
    step and takes none, and B5 (the sketch's scatter and query) launches
    twice a step for each sketched leaf (embed and pos_embed) and nothing
    else launches.  quickstart.py: the loss falls, ``rank_metrics`` gives a
    finite mean rank in [1, k_max] and a finite mean xi, its trace passes
    ``repro_torch.tools.traceview --check``, and no kernel launches (no
    fused update, no sketch).  elastic_restart.py: the restore is
    bitwise.  serve_batched.py: every request's continuous stream equals
    the same request served alone on the wave engine (a wave of one slot:
    the wave engine right-aligns a wave's prompts and attends the pad, as
    JAX's does, so a shorter prompt in a mixed wave is another input),
    parting only at a tie within ``SERVE_TIE_ULPS``.  Returns ``{path:
    (launch counts, info)}`` and the phase's seconds."""
    import torch
    from repro_torch.core.sketch import SketchLeaf, SketchState
    from repro_torch.core.types import find_states
    from repro_torch.tools import traceview
    t_phase = time.monotonic()
    shutil.rmtree(EXAMPLES_ROOT, ignore_errors=True)
    runs = {}

    argv = ["--full", "--steps", str(EXAMPLE_GPT2_STEPS), "--ckpt-dir",
            str(EXAMPLES_ROOT / "gpt2"), "--log-every", "1"]
    phase("[examples] examples/torch/train_gpt2_pile.py " + " ".join(argv))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    (state, hist), (again, hist2) = example("train_gpt2_pile").main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    losses = [h["loss"] for h in hist]
    times = [h["step_time_s"] for h in hist]
    for h in hist:
        print(f"  step {h['step']:2d} loss {h['loss']:.4f} "
              f"step_time_s {h['step_time_s']:.4f}")
    if (len(losses) != EXAMPLE_GPT2_STEPS
            or not all(math.isfinite(x) for x in losses)
            or not losses[-1] < losses[0]):
        fail(f"[examples] train_gpt2_pile: losses {losses}")
    if hist2 or again.step != EXAMPLE_GPT2_STEPS:
        fail(f"[examples] train_gpt2_pile's second run: step {again.step}, "
             f"{len(hist2)} steps taken; expected a restore at "
             f"{EXAMPLE_GPT2_STEPS} and none")
    n_sk = sum(isinstance(leaf, SketchLeaf)
               for sub in find_states(state.opt_state, SketchState)
               for leaf in sub.leaves)
    want = expected_launches("none", EXAMPLE_GPT2_STEPS, 0, 0, 0, n_sk)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = statistics.median(times[1:])
    print(f"  launches {launches} (expected {want}: {n_sk} sketched "
          f"leaves); the second run restored step {again.step} and took "
          f"none; median step {step_s:.4f} s after the first "
          f"({16 * 256 / step_s:.0f} tokens/s); peak memory {peak:.2f} "
          f"GiB; both runs {wall:.1f} s")
    if n_sk != 2 or launches != want:
        fail(f"[examples] train_gpt2_pile launches {launches}, expected "
             f"{want} (sketched leaves {n_sk}, expected 2)")
    runs["examples-gpt2"] = (launches, {
        "loss": losses[-1], "losses": losses, "step_s": step_s,
        "first_step_s": times[0], "peak_gib": peak, "wall_s": wall})
    del state, again

    argv = ["--steps", str(EXAMPLE_QUICKSTART_STEPS), "--trace-dir",
            str(EXAMPLES_ROOT / "quickstart")]
    phase("[examples] examples/torch/quickstart.py " + " ".join(argv))
    reset_launches()
    t0 = time.perf_counter()
    out = example("quickstart").main(argv)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    losses, rm = out["losses"], out["rank_metrics"]
    rank, xi = rm.get("adapprox/mean_rank"), rm.get("adapprox/mean_xi")
    print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}; mean rank {rank}, "
          f"mean xi {xi}; launches {launches}; {wall:.1f} s")
    if (not all(math.isfinite(x) for x in losses)
            or not losses[-1] < losses[0]):
        fail(f"[examples] quickstart: losses {losses}")
    if not (rank is not None and math.isfinite(rank)
            and 1 <= rank <= out["k_max"] and xi is not None
            and math.isfinite(xi)):
        fail(f"[examples] quickstart: rank metrics {rm}")
    if any(launches.values()):
        fail(f"[examples] quickstart launched {launches}; its path (no "
             f"fused update, no sketch) launches no kernel")
    print("  python -m repro_torch.tools.traceview --check on its trace:")
    if traceview.main([out["trace_dir"], "--check"]) != 0:
        fail("[examples] quickstart's trace fails traceview --check")
    runs["examples-quickstart"] = (launches, {
        "loss": losses[-1], "losses": losses, "mean_rank": rank,
        "mean_xi": xi, "wall_s": wall})

    phase("[examples] examples/torch/elastic_restart.py")
    out = example("elastic_restart").main([])
    if not (out["bit_identical"] is True and out["step"] == 123):
        fail(f"[examples] elastic_restart: restored step {out['step']}, "
             f"bit-identical {out['bit_identical']}")

    phase("[examples] examples/torch/serve_batched.py, then each request "
          "alone on a one-slot wave engine")
    mod = example("serve_batched")
    reset_launches()
    with engines_recorded(mod) as rec:
        out = mod.main([])
        cont, c_reqs = out["continuous"]
        solo_reqs = mod.clone(c_reqs)
        solo = mod.Engine(rec["continuous"].model, cont.params,
                          mod.ServeConfig(slots=1, cache_len=mod.CACHE_LEN))
        solo.run(solo_reqs)
    w_reqs = out["wave"][1]
    same_wave = sum(a.out_tokens == b.out_tokens
                    for a, b in zip(c_reqs, w_reqs))
    print(f"  the mixed waves' streams equal the continuous ones for "
          f"{same_wave} of {len(c_reqs)} requests (a mixed wave attends "
          f"its pad)")
    parted = hold_streams("[examples] serve_batched",
                          (cont, c_reqs, rec["continuous"]),
                          (solo, solo_reqs, rec["wave"]))
    runs["examples-serve"] = (launch_counts(), {
        "wave_s": out["wave_s"], "continuous_s": out["continuous_s"],
        "parted": parted, "same_as_mixed_wave": same_wave})
    shutil.rmtree(EXAMPLES_ROOT, ignore_errors=True)
    seconds = time.monotonic() - t_phase
    print(f"  [examples] phase: {seconds:.1f} s")
    return runs, seconds


def time_stream(kern, plain, kernel_name: str, rec: dict, bound: float,
                label: str) -> None:
    """:func:`time_pair` for calls of a millisecond or so, by CUDA events
    (the stream's time over 10 calls of the kernel, 3 of its plain
    version), the profiler's reading printed beside it: late in a long
    run the profiler drops kernel records (runs 24b, 24c read B6 and B7
    below their bounds while the stream read them as before)."""
    t_k, t_p = events_ms(kern), events_ms(plain, reps=3)
    d_k = device_ms(kern, kernel_name, reps=10, profiles=1)
    print(f"    timing {label}: kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
          f"bound_ms {bound:.4f} (CUDA events; the profiler read the "
          f"kernel at {d_k:.4f})")
    rec["ms"] += t_k
    rec["plain_ms"] += t_p
    rec["bound_ms"] += bound


def flash_fwd_held(device, gen, name: str, shape: tuple, dtype,
                   rec: dict) -> tuple:
    """B6's forward on seeded ``(B, Sq, Sk, H, KV, dh)`` inputs of
    ``dtype``, causal, launched twice and held to its plain version on the
    same inputs (:func:`hold`, ``TOL_FLASH``; the error into ``rec``).
    Returns ``(q, k, v, the launch)`` for a caller that times it."""
    import torch
    from repro_torch.kernels import ops, ref
    b, sq, sk, h, kv, dh = shape
    rnd = lambda *dims: torch.randn(dims, generator=gen,
                                    device=device).to(dtype)
    q, k, v = rnd(b, sq, h, dh), rnd(b, sk, kv, dh), rnd(b, sk, kv, dh)
    fwd = lambda: ops.flash_attention_fwd(q, k, v, True)
    got, again = fwd(), fwd()
    want = ref.flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    errs = hold(f"flash_attention {name}", ("out", "lse"), (TOL_FLASH,) * 2,
                got, want, rec, again)
    print(f"  flash_attention {name} {tuple(q.shape)} {dtype} fwd: {errs}")
    return q, k, v, fwd


def check_serve_kernels(device) -> dict:
    """[kernels-serve]: the forward kernels at the serving path's prefill
    shapes, bf16 as the models feed them, under ``torch.inference_mode``:
    B6 at Qwen2-7B's wave prefill (2, 8192, 28 over 4, 128), causal, beside
    SDPA (``enable_gqa``) forward; B7 at Mamba2-370m's prefill (2, 1024,
    32 heads, P 64, N 128) and Zamba2-2.7B's (1, 8192, 80 heads, P 64, N
    64).  Each against its plain version on the same inputs, bitwise
    repeatable, timed beside its bound (``flash_bounds`` / ``ssd_bounds``)
    and its plain version's time, per call, by CUDA events
    (:func:`time_stream`).  Returns ``{"flash_fwd",
    "ssd_fwd": {name: record}}``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(9)
    name, (b, sq, sk, h, kv, dh) = SERVE_FLASH
    rec = new_rec()
    with torch.inference_mode():
        q, k, v, fwd = flash_fwd_held(device, gen, name, SERVE_FLASH[1],
                                      bf16, rec)
        bound = flash_bounds(b, sq, sk, h, kv, dh, True, bf16)[0]
        time_stream(fwd, lambda: ref.flash_attention(q, k, v, True),
                    "flash_fwd_kernel", rec, bound, f"{name} bf16 fwd")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        rec["library_ms"] = events_ms(sdpa)
        rec.update(bound_by="operations", shape=f"{name} {(b, sq, h, kv, dh)}")
        print(f"    library: scaled_dot_product_attention bf16 fwd "
              f"{rec['library_ms']:.4f} ms")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    ssd = {}
    for name, shape in SERVE_SSD:
        r = new_rec()
        with torch.inference_mode():
            ins = ssd_inputs(gen, shape, bf16, device)
            fwd = lambda: ops.ssd_chunk_fwd(*ins)
            got, again = fwd(), fwd()
            want = ref.ssd_chunk(*ins)
            torch.cuda.synchronize()
            errs = hold(f"ssd_chunk {name}", ("y",), (TOL_SSD,), (got,),
                        (want,), r, (again,))
            print(f"  ssd_chunk {name} {shape} bf16 fwd: {errs}")
            del got, again, want
            (bound, _), (by, _) = ssd_bounds(shape, bf16, by=True)
            time_stream(fwd, lambda: ref.ssd_chunk(*ins), "ssd_fwd_kernel",
                        r, bound, f"{name} bf16 fwd")
            r.update(bound_by=by, library_ms=None, shape=f"{name} {shape}")
            del ins
        torch.cuda.empty_cache()
        ssd[name.split()[0]] = r
    return {"flash_fwd": rec, "ssd_fwd": ssd}


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a GPU")
    from repro_torch.configs.archs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import optimizer_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    sources = [mod.SOURCE for mod in kernel_modules()]
    cuda.build(*sources)
    phase("[build] one nvcc per source, in parallel, done")
    for src in sources:
        log = cuda.BUILD_LOG[src.stem]
        print(f"  {src.name}: {log['seconds']:.1f} s")
        for line in log["output"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    check_hgmma()

    fact, dense = main_path_leaves(device)
    fact_mixed, _ = main_path_leaves(device, mixed=True)
    phase("[kernels] fused_precond vs plain, every factored leaf")
    pre = check_precond(fact, device)
    phase("[kernels] fused_precond int8 vs dequantize + plain, every factored "
          "leaf of the mixed groups and ragged shapes")
    pre8 = check_precond_int8(fact_mixed, device)
    phase("[kernels] fused_apply vs plain, every leaf")
    app = check_apply(fact, dense, device)
    phase("[kernels] lowrank_update vs plain, every factored leaf of the "
          "mixed groups and ragged shapes")
    low = check_lowrank(fact_mixed, device)
    phase("[kernels] sq_matmul and sq_matmul_t vs plain, every factored leaf "
          "of the mixed groups and ragged shapes")
    sqm = check_sq_matmul(fact_mixed, device)
    phase("[kernels] sketch_update (scatter + query) vs plain, every "
          "sketched leaf of the mixed groups and a ragged shape")
    sk = check_sketch(sketch_cases(device), device)
    phase("[kernels] flash_attention fwd / bwd vs plain, GPT-2 117M's shape "
          "and ragged GQA shapes")
    fa_fwd, fa_bwd = check_flash(device)
    phase("[kernels] ssd_chunk fwd / bwd vs plain, Mamba2-370m's block and "
          "a ragged shape")
    ssd_fwd, ssd_bwd = check_ssd(device)
    fact_mamba, _ = main_path_leaves(device, mixed=True, arch=MAMBA)
    phase("[kernels-mamba2] fused_precond and fused_apply vs plain at "
          "Mamba2-370m's factored leaves (in_proj, out_proj)")
    pre_m = check_precond(fact_mamba, device, ragged=False)
    app_m = check_apply(fact_mamba, [], device)
    phase("[kernels-mamba2] sketch_update vs plain at Mamba2-370m's "
          "sketched leaves (embed, lm_head)")
    sk_m = check_sketch(sketch_cases(device, MAMBA, ("embed", "lm_head"),
                                     ragged=False), device)
    fact_kmax = (main_path_leaves(device, mixed=True, k_max=10**9)[0]
                 + main_path_leaves(device, mixed=True, arch=MAMBA,
                                    k_max=10**9)[0])
    phase("[kernels-kmax] fused_precond with the fold at the paper's k_max "
          "(r 192: GPT-2 117M's block matrices; r 256: Mamba2-370m's "
          "in_proj, out_proj), past R_MAX: pass 1 + sq_matmul_t")
    pre_k = check_precond_kmax(fact_kmax, device)
    phase("[kernels-kmax] the same with int8 factors")
    pre8_k = check_precond_kmax(fact_kmax, device, int8=True)
    phase("[kernels-dense] flash attention at Qwen2-7B's (2, 2048, 28 over "
          "4, 128), sketch_update at its embed and lm_head (152,064 "
          "columns), fused_precond and fused_apply at one layer's w_up and "
          "an OLMoE-1B-7B expert stack, vs plain")
    dense_k = check_dense_kernels(device)
    phase("[kernels-families] ssd_chunk at Zamba2-2.7B's block (4, 2048, "
          "80 heads, P 64, N 64), flash attention at Zamba2-2.7B's (4, 2048, "
          "32, dh 80) and LLaVA-NeXT-Mistral-7B's (2, 2048, 32 over 8, 128), "
          "fused_precond and fused_apply at Zamba2-2.7B's in_proj stack, "
          "sketch_update at Whisper-large-v3's sketched leaves, vs plain")
    t_k = time.monotonic()
    fam_k = check_family_kernels(device)
    print(f"  [kernels-families]: {time.monotonic() - t_k:.1f} s")
    phase("[srsi] S-RSI batched on the card at every factored leaf of the "
          "mixed groups at refresh steps 6 and 11 (w_down at 1), against "
          "the CPU")
    check_srsi(device, fact_mixed)
    phase("[parity] kernel path on the card vs plain path on the CPU")
    small_parity(device)
    phase("[parity] mixed groups, kernel path on the card vs plain path on "
          "the CPU")
    small_parity(device, mixed=True)
    phase("[parity-int8] mixed groups, --quantize-factors, kernel path on "
          "the card vs plain path on the CPU")
    small_parity(device, "int8", mixed=True)
    phase("[parity-kernels] mixed groups, use_kernels, kernel path on the "
          "card vs plain path on the CPU")
    small_parity(device, "kernels", mixed=True)
    phase("[parity-chunked] mixed groups, attn_impl \"chunked\" at S 2048, "
          "kernel path on the card vs plain path on the CPU")
    small_parity(device, mixed=True, chunked=True)
    phase("[parity-mamba2] Mamba2 smoke, mixed groups, kernel path on the "
          "card vs plain path on the CPU")
    small_parity(device, mixed=True, arch=MAMBA)
    phase("[parity-mamba2] seed 1, lm_head on the sketch too "
          "(embedding_min_rows 64)")
    small_parity(device, mixed=True, arch=MAMBA, seed=1, sketch_rows=64)
    for label, kw in (
            ("[parity-warm] mixed groups, --warm-start (n_iter_warm 1)",
             dict(over=dict(warm_start=True))),
            ("[parity-implicit] mixed groups, implicit=True (S-RSI on the "
             "implicit operator, ||V||_F^2 from pass 1)",
             dict(over=dict(implicit=True))),
            ("[parity-bucketed] mixed groups, --bucketed --warm-start "
             "(wq and wo stacked)", dict(over=dict(bucketed=True,
                                                   warm_start=True))),
            ("[parity-kmax] mixed groups, the paper's k_max (min(m, n) / 4)",
             dict(over=dict(k_max=10**9))),
            ("[parity-adafactor] --optimizer adafactor (no kernel)",
             dict(kind="none", name="adafactor")),
            ("[parity-came] --optimizer came (no kernel)",
             dict(kind="none", name="came")),
            ("[parity-bf16-params] mixed groups, param_dtype bfloat16",
             dict(param_dtype="bfloat16"))):
        phase(label + ", kernel path on the card vs plain path on the CPU")
        small_parity(device, mixed=kw.get("name") is None, **kw)
    phase("[parity-dense] qwen3-14b smoke (qk-norm, RoPE, GQA, SwiGLU, "
          "untied head), mixed groups, kernel path on the card vs plain "
          "path on the CPU")
    small_parity(device, mixed=True, arch="qwen3-14b")
    phase("[parity-moe] olmoe-1b-7b smoke (8 experts, top-2, sort "
          "dispatch), mixed groups, the router's top-k indices, then the "
          "kernel path on the card vs plain path on the CPU")
    small_parity(device, mixed=True, arch="olmoe-1b-7b")
    for label, arch in (
            ("[parity-hybrid] zamba2-2.7b smoke (4 Mamba2 layers, a shared "
             "block after every 2nd)", ZAMBA),
            ("[parity-encdec] whisper-large-v3 smoke (2 + 2 layers, "
             "enc_seq 32, make_batch's embeds)", WHISPER),
            ("[parity-vlm] llava-next-mistral-7b smoke (8 frontend tokens, "
             "make_batch's embeds)", LLAVA)):
        phase(label + ", mixed groups, kernel path on the card vs plain "
              "path on the CPU")
        t_p = time.monotonic()
        small_parity(device, mixed=True, arch=arch)
        print(f"  ({time.monotonic() - t_p:.1f} s)")
    # every factored leaf trips at step 1, is refreshed off the cadence at
    # step 2, trips again and is demoted: B1 / B2 on steps 1-2 only
    phase("[parity-guards] mixed groups, --guards --guard-skip-threshold 0 "
          "--max-demotions 2, kernel path on the card vs plain path on the "
          "CPU")
    guard_cpu = small_parity(device, mixed=True, over=dict(
        guards=True, guard_xi_trip=0.0, max_demotions=2), factored_steps=2)
    # 12 steps: 8 factored + 8 dense leaves; 6 factored, 2 sketched
    phase("[train] GPT-2 117M, " + " ".join(TRAIN_ARGV))
    runs = {"no_mixed": train_main_path(launcher_run(TRAIN_ARGV), "fused", dict(
        fused_precond=96, fused_apply=192))}
    phase("[train-mixed] GPT-2 117M on the launcher's default mixed groups, "
          + " ".join(TRAIN_MIXED_ARGV))
    mixed_params, mixed_state = {}, []
    mixed_expect = dict(fused_precond=72, fused_apply=72, sketch_scatter=24,
                        sketch_query=24)

    def keep_mixed(st):
        mixed_params.update({k: p.detach().cpu()
                             for k, p in st.params.items()})
        mixed_state.extend((p, t.detach().cpu())
                           for p, t in tensor_leaves(st))

    runs["mixed"] = train_main_path(launcher_run(TRAIN_MIXED_ARGV), "fused",
                                    mixed_expect, keep=keep_mixed)
    phase("[train-int8] GPT-2 117M, " + " ".join(TRAIN_INT8_ARGV))
    runs["int8"] = train_main_path(launcher_run(TRAIN_INT8_ARGV), "int8", dict(
        fused_precond=72, fused_precond_int8=72, fused_apply=72,
        sketch_scatter=24, sketch_query=24))
    phase("[train-kernels] GPT-2 117M, the launcher's optimizer (mixed "
          "groups, --refresh-every 5) with use_kernels, no fused update, "
          "through build_optimizer and the train loop")
    runs["kernels"] = train_main_path(loop_run(device, kernels_config()),
                                      "kernels", dict(
        lowrank_update=72, sq_matmul_t=54, sketch_scatter=24,
        sketch_query=24))
    launcher_cfg = lambda **kw: optimizer_config(
        "adapprox", 12, 3e-3, refresh_every=5, **kw)
    mixed_cfg = launcher_cfg(fused_update=True, mixed_groups=True)
    phase("[train-chunked] GPT-2 117M with attn_impl \"chunked\", the "
          "launcher's default mixed groups, --fused-update --refresh-every "
          "5, batch 8 x 1024, through build_optimizer and the train loop")
    # remat "full" (the config's default): each layer's forward runs
    # again in the backward, so flash_fwd is launched twice a layer
    runs["chunked"] = train_main_path(
        loop_run(device, mixed_cfg, chunked_model_config()), "fused", dict(
            fused_precond=72, fused_apply=72, sketch_scatter=24,
            sketch_query=24, flash_fwd=288, flash_bwd_dq=144,
            flash_bwd_dkdv=144), attn_layers=12)
    # 12 steps: in_proj and out_proj factored, embed and lm_head sketched,
    # 48 SSD blocks a step
    phase("[train-mamba2] Mamba2-370m, " + " ".join(TRAIN_MAMBA_ARGV))
    # its step-1 in_proj refresh is kept for [srsi] at other widths
    in_proj = dict((n, sh) for n, sh, _ in fact_mamba)["layers/mamba/in_proj"]
    with srsi_captured(in_proj) as cap_mamba:
        runs["mamba2"] = train_main_path(
            launcher_run(TRAIN_MAMBA_ARGV), "fused", dict(
                fused_precond=24, fused_apply=24, sketch_scatter=24,
                sketch_query=24, ssd_fwd=2 * 12 * SSD_LAYERS,
                ssd_bwd_rows=12 * SSD_LAYERS, ssd_bwd_cols=12 * SSD_LAYERS),
            ssd_layers=SSD_LAYERS)
    # wq, wk, wv and wo share (12, 768, 768): one bucket, so 3 factored
    # calls a step (w_up, w_down alone)
    warm_cfg = launcher_cfg(fused_update=True, mixed_groups=True,
                            warm_start=True, bucketed=True)
    warm_expect = dict(fused_precond=36, fused_apply=36, sketch_scatter=24,
                       sketch_query=24)
    phase("[train-warm] GPT-2 117M, " + " ".join(TRAIN_WARM_ARGV))
    runs["warm"] = train_main_path(launcher_run(TRAIN_WARM_ARGV), "fused",
                                   warm_expect, bucketed=True)
    phase("[train-implicit] the same with implicit=True, through "
          "build_optimizer and the train loop")
    runs["implicit"] = train_main_path(
        loop_run(device, dataclasses.replace(warm_cfg, implicit=True)),
        "fused", warm_expect, bucketed=True)
    phase("[train-kmax] the same with the paper's k_max (k_max 10**9, rank "
          "mode paper: r 192), the fold through sq_matmul_t on fold steps")
    runs["kmax"] = train_main_path(
        loop_run(device, dataclasses.replace(warm_cfg, k_max=10**9)),
        "fused", dict(warm_expect, sq_matmul_t=27), bucketed=True)
    # CAME at lr 1e-4: at the launcher's 3e-3 its confidence scaling
    # (rs, cs start at (1 - b3) S, no bias correction) multiplies the first
    # steps' updates ~100x and the loss climbs, in the JAX package alike
    for name, lr in (("adafactor", "3e-3"), ("came", "1e-4")):
        argv = TRAIN_BASELINE_ARGV + ["--optimizer", name, "--lr", lr]
        phase(f"[train-{name}] GPT-2 117M, " + " ".join(argv))
        runs[name] = train_main_path(launcher_run(argv), "none", {})
    # 6 steps, refresh at 1 and 6: wq, wk, wv, wo, w_gate, w_up, w_down
    # factored (7 calls), embed and lm_head sketched; B6's forward twice a
    # layer under remat "full"
    phase(f"[train-qwen2] Qwen2-7B at full width, n_layers 28 -> "
          f"{DENSE_LAYERS}, attn_impl \"chunked\", "
          + " ".join(TRAIN_QWEN2_ARGV))
    w_down = (DENSE_LAYERS, 18944, 3584)
    with depth_cut(DENSE_LAYERS, attn_impl="chunked"), \
            srsi_captured(w_down) as cap_qwen2:
        runs["qwen2"] = train_main_path(
            launcher_run(TRAIN_QWEN2_ARGV), "fused", dict(
                fused_precond=42, fused_apply=42, sketch_scatter=12,
                sketch_query=12, flash_fwd=2 * 6 * DENSE_LAYERS,
                flash_bwd_dq=6 * DENSE_LAYERS,
                flash_bwd_dkdv=6 * DENSE_LAYERS),
            attn_layers=DENSE_LAYERS, steps=6, tokens=2 * 2048)
    # wq, wk, wv, wo, the router and the three expert stacks (L, 64, m, n)
    # factored (8 calls), embed and lm_head sketched; naive attention
    phase(f"[train-olmoe] OLMoE-1B-7B at full width, n_layers 16 -> "
          f"{DENSE_LAYERS}, " + " ".join(TRAIN_OLMOE_ARGV))
    olmoe_state = []      # host copies, for [mesh]
    with depth_cut(DENSE_LAYERS):
        runs["olmoe"] = train_main_path(
            launcher_run(TRAIN_OLMOE_ARGV), "fused", OLMOE_EXPECT, steps=6,
            tokens=2 * 2048, keep=lambda st: olmoe_state.extend(
                (p, t.detach().cpu()) for p, t in tensor_leaves(st)))
    phase("[train-olmoe] step 2 twice from one state, bitwise (MoE "
          "determinism)")
    moe_repeat_step(device)
    # 6 steps, refresh at 1 and 6: in_proj, out_proj and the shared
    # blocks' wq, wk, wv, wo, w_up, w_down factored (8 calls), embed and
    # lm_head sketched; B7 in every layer and B6 at each of the 9 shared-
    # block applications, each forward twice under remat "full"
    phase(f"[train-zamba2] Zamba2-2.7B at full width and depth "
          f"({ZAMBA_LAYERS} layers), attn_impl \"chunked\", "
          + " ".join(TRAIN_ZAMBA_ARGV))
    with depth_cut(ZAMBA_LAYERS, attn_impl="chunked"):
        runs["zamba2"] = train_main_path(
            launcher_run(TRAIN_ZAMBA_ARGV), "fused", dict(
                fused_precond=48, fused_apply=48, sketch_scatter=12,
                sketch_query=12, ssd_fwd=2 * 6 * ZAMBA_LAYERS,
                ssd_bwd_rows=6 * ZAMBA_LAYERS,
                ssd_bwd_cols=6 * ZAMBA_LAYERS,
                flash_fwd=2 * 6 * ZAMBA_APPS, flash_bwd_dq=6 * ZAMBA_APPS,
                flash_bwd_dkdv=6 * ZAMBA_APPS),
            attn_layers=ZAMBA_APPS, ssd_layers=ZAMBA_LAYERS, steps=6,
            tokens=4 * 2048)
    # the encoder's and decoder's attention, self and cross, wk, wv, wq,
    # wo, w_up, w_down factored (16 calls), dec_pos, embed, enc_pos
    # sketched; naive attention (1500 frames and 448 tokens do not divide
    # into 1024-row chunks, as in JAX)
    phase(f"[train-whisper] Whisper-large-v3 at full width and depth (32 + "
          f"32 layers), batch {WHISPER_RUN['batch']}, 1500 frames, "
          f"{WHISPER_RUN['seq']} tokens, lr {WHISPER_RUN['lr']}, 6 steps "
          f"through build_train_step")
    runs["whisper"] = train_main_path(
        family_run(device, WHISPER, None, **WHISPER_RUN), "fused", dict(
            fused_precond=96, fused_apply=96, sketch_scatter=18,
            sketch_query=18), steps=6,
        tokens=WHISPER_RUN["batch"] * WHISPER_RUN["seq"])
    # wq, wk, wv, wo, w_gate, w_up, w_down factored (7 calls), embed and
    # lm_head sketched; B6 on every layer at 576 + 1472 = 2048 positions
    phase(f"[train-llava] LLaVA-NeXT-Mistral-7B at full width, n_layers 32 "
          f"-> {LLAVA_LAYERS}, attn_impl \"chunked\", batch "
          f"{LLAVA_RUN['batch']} x (576 image + 1472 text tokens), lr "
          f"{LLAVA_RUN['lr']}, 6 steps through build_train_step")
    runs["llava"] = train_main_path(
        family_run(device, LLAVA, LLAVA_LAYERS, attn_impl="chunked",
                   **LLAVA_RUN), "fused", dict(
            fused_precond=42, fused_apply=42, sketch_scatter=12,
            sketch_query=12, flash_fwd=2 * 6 * LLAVA_LAYERS,
            flash_bwd_dq=6 * LLAVA_LAYERS, flash_bwd_dkdv=6 * LLAVA_LAYERS),
        attn_layers=LLAVA_LAYERS, steps=6,
        tokens=LLAVA_RUN["batch"] * LLAVA_RUN["seq"])
    phase(f"[train-llava] text only through the launcher, n_layers 32 -> "
          f"{LLAVA_LAYERS}, attn_impl \"chunked\", "
          + " ".join(TRAIN_LLAVA_ARGV))
    with depth_cut(LLAVA_LAYERS, attn_impl="chunked"):
        runs["llava_text"] = train_main_path(
            launcher_run(TRAIN_LLAVA_ARGV), "fused", dict(
                fused_precond=42, fused_apply=42, sketch_scatter=12,
                sketch_query=12, flash_fwd=2 * 6 * LLAVA_LAYERS,
                flash_bwd_dq=6 * LLAVA_LAYERS,
                flash_bwd_dkdv=6 * LLAVA_LAYERS),
            attn_layers=LLAVA_LAYERS, steps=6, tokens=2 * 2048)
    argv_345 = ["--arch", "gpt2-345m", "--steps", "1"] + TRAIN_MIXED_ARGV[4:]
    phase("[srsi] at other widths: one matrix of GPT-2 345M's w_down (its "
          "step-1 refresh, " + " ".join(argv_345) + "), Mamba2-370m's "
          "in_proj ([train-mamba2]) and Qwen2-7B's w_down ([train-qwen2])")
    t_w = time.monotonic()
    with srsi_captured((24, 4096, 1024)) as cap_345:
        launcher_run(argv_345)()
    caps = [("gpt2-345m blocks/mlp/w_down", cap_345),
            ("mamba2-370m layers/mamba/in_proj", cap_mamba),
            ("qwen2-7b blocks/mlp/w_down", cap_qwen2)]
    if not all(len(c) == 1 for _, c in caps):
        fail(f"[srsi] captured {[(n, len(c)) for n, c in caps]}")
    check_srsi_widths(device, [(n, c[0]) for n, c in caps])
    del caps, cap_345, cap_mamba, cap_qwen2
    print(f"  [srsi] at other widths: {time.monotonic() - t_w:.1f} s")
    phase("[ckpt] GPT-2 117M, " + " ".join(TRAIN_GUARDED_ARGV)
          + ", 12 straight steps")
    ckpt = ckpt_phase(device, mixed_params, runs["mixed"][0])
    ckpt_costs = ckpt.pop("costs")
    runs.update(ckpt)
    phase("[chaos] GPT-2 117M, chain(inject_faults(NaN at 5, 6; Inf at 9), "
          "the launcher's optimizer with --guards), 12 steps")
    runs["chaos"] = chaos_phase(device, runs["mixed"][0])
    phase("[chaos] python -m repro_torch.tools.chaos on the card (NaN at 7, "
          "8, 19 of 30 steps)")
    chaos_tool(CKPT_ROOT / "chaos_tool")
    phase("[guards] GPT-2 117M, the launcher's optimizer with --guards "
          "--guard-skip-threshold 0 --max-demotions 2, 6 steps")
    runs["guards"] = guards_phase(device, guard_cpu)
    # under the guards --bucketed runs per leaf, as in the JAX package:
    # 6 calls of B1 / B2 a step, not 3
    bucketed_argv = [a if a != "12" else "3" for a in TRAIN_GUARDED_ARGV] + [
        "--bucketed", "--max-demotions", "2", "--ckpt-dir",
        str(CKPT_ROOT / "bucketed"), "--ckpt-every", "2"]
    phase("[guards-bucketed] GPT-2 117M, " + " ".join(bucketed_argv))
    runs["guarded_bucketed"] = train_main_path(
        launcher_run(bucketed_argv), "fused", dict(
            fused_precond=18, fused_apply=18, sketch_scatter=6,
            sketch_query=6), steps=3)
    phase("[telemetry] GPT-2 117M, the launcher's mixed groups "
          "--fused-update --refresh-every 5, 12 steps, with the telemetry "
          "subsystem: snapshots, the closed loop, the launcher's flags, cost")
    runs.update(telemetry_phase(device, mixed_state, mixed_expect))
    runs.update(mesh_phase(mixed_state, runs["mixed"][1], mixed_expect,
                           olmoe_state, runs["olmoe"][1]))
    del mixed_state, olmoe_state
    phase("[dryrun] GPT-2 117M, [mesh]'s mixed groups at batch 8 x 1024: "
          "the dry run on a one-rank fake mesh (1, 1) vs --mesh 1,1 on "
          "the card, step 2 (a fold step)")
    dryrun = dryrun_phase(device, runs["mesh"][1])
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)

    info = {p: r[1] for p, r in runs.items()}
    runs = {p: r[0] for p, r in runs.items()}
    phase("[train-*] against [train-mixed], this run")
    for p in ("chunked", "warm", "implicit", "kmax", "adafactor", "came"):
        print(f"  [train-{p}] vs [train-mixed]: final loss "
              f"{info[p]['loss']:.4f} vs {info['mixed']['loss']:.4f}; peak "
              f"memory {info[p]['peak_gib']:.2f} vs "
              f"{info['mixed']['peak_gib']:.2f} GiB; fold step "
              f"{info[p]['fold_s']:.4f} vs {info['mixed']['fold_s']:.4f} s; "
              f"refresh steps {info[p]['refresh_s']} vs "
              f"{info['mixed']['refresh_s']}")
    phase("[remat] GPT-2 117M (mixed) under none / full / dots and "
          "Mamba2-370m under none / full, 4 steps each")
    remat = remat_runs(device)
    for label, ocfg, mcfg in (
            ("[breakdown]", launcher_cfg(fused_update=True), None),
            ("[breakdown-mixed]", mixed_cfg, None),
            ("[breakdown-warm]", warm_cfg, None),
            ("[breakdown-int8]", launcher_cfg(fused_update=True,
                                              mixed_groups=True,
                                              quantize_factors=True), None),
            ("[breakdown-kernels]", kernels_config(), None),
            ("[breakdown-chunked]", mixed_cfg, chunked_model_config()),
            ("[breakdown-mamba2]", mixed_cfg, get_config(MAMBA))):
        phase(f"{label} model vs optimizer, refresh vs fold step")
        step_breakdown(device, ocfg, mcfg)
    phase("[memory] optimizer state vs BENCH_memory.json and the JAX "
          "package's count")
    check_memory(device)
    # serving last: it reads no profile, and the phases above read
    # torch.profiler, which drops kernel records late in a long run
    phase("[kernels-serve] B6 and B7 forward at the serving path's prefill "
          "shapes, bf16, under inference_mode")
    serve_k = check_serve_kernels(device)
    t_s = time.monotonic()
    serve = serve_qwen2(device)
    serve.update(serve_families(device))
    phase("[parity-serve] every family's smoke model and the paged trio in "
          "fp32, card vs CPU; paged vs dense decode on the card")
    parity_serve(device)
    print(f"  serving phases: {time.monotonic() - t_s:.1f} s")
    serve_info = {p: r[1] for p, r in serve.items()}
    runs.update({p: r[0] for p, r in serve.items()})
    examples, examples_s = examples_phase()
    examples_info = {p: r[1] for p, r in examples.items()}
    examples_info["seconds"] = examples_s
    runs.update({p: r[0] for p, r in examples.items()})

    def launches(*names):
        return dict(
            launches=sum(r[n] for r in runs.values() for n in names),
            launches_by_path={p: sum(r[n] for n in names)
                              for p, r in runs.items()})

    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(name="fused_precond", route="cuda", source=src + "fused_update.cu",
             replaces="src/repro/kernels/fused_update.py:130",
             **launches("fused_precond"), library_ms=None, **pre,
             mamba2=pre_m, dense=dict(dense_k["precond"], shapes=(
                 "qwen2-7b w_up (3584, 18944); olmoe-1b-7b expert stack "
                 "(64, 2048, 1024)")),
             families=dict(fam_k["precond"], shapes=(
                 "zamba2-2.7b in_proj stack (54, 2560, 10448)")),
             int8={"launches": launches("fused_precond_int8")["launches"],
                   **pre8},
             kmax=dict(pre_k, route="pass 1 without the fold + sq_matmul_t",
                       launches=runs["kmax"]["sq_matmul_t"], int8=pre8_k)),
        dict(name="fused_apply", route="cuda", source=src + "fused_update.cu",
             replaces="src/repro/kernels/fused_update.py:233",
             **launches("fused_apply"), bound_by="bytes",
             library_ms=None, **app, mamba2=app_m, dense=dense_k["apply"],
             families=dict(fam_k["apply"], shapes=(
                 "zamba2-2.7b in_proj stack (54, 2560, 10448)"))),
        dict(name="sketch_update", route="cuda",
             source=src + "sketch_update.cu",
             replaces="src/repro/kernels/sketch_update.py:80",
             **launches("sketch_scatter", "sketch_query"), bound_by="bytes",
             library_ms=None, **sk, mamba2=sk_m, dense=dict(
                 dense_k["sketch"], shapes="qwen2-7b embed, lm_head"),
             families=dict(fam_k["sketch"], shapes=(
                 "whisper-large-v3 dec_pos, embed, enc_pos"))),
        dict(name="lowrank_update", route="cuda",
             source=src + "lowrank_update.cu",
             replaces="src/repro/kernels/lowrank_update.py:45",
             **launches("lowrank_update"), library_ms=None, **low),
        dict(name="sq_matmul", route="cuda", source=src + "srsi_matmul.cu",
             replaces="src/repro/kernels/srsi_matmul.py:43",
             **launches("sq_matmul", "sq_matmul_t"), bound_by="operations",
             library_note="torch.matmul on a pre-squared G: two calls (the "
                          "square untimed)", **sqm),
    ]
    # flash attention: times and bounds per train step (12 layers, one
    # launch of each kernel a layer), measured per call at the main path's
    # shape and bf16 inputs; library_ms is scaled_dot_product_attention on
    # fp32 inputs (the same fp32 function), library_bf16_ms on bf16 inputs
    # (bf16 tensor-core products), the backward's as fwd+bwd minus fwd.
    per_step = lambda rec, n=FLASH_LAYERS: {
        k: (v * n if k.endswith("ms") else v) for k, v in rec.items()}
    # [kernels-dense]: per step of [train-qwen2]'s 4 layers
    qwen2 = lambda rec: dict(per_step(rec, DENSE_LAYERS),
                             shape="qwen2-7b (2, 2048, 28 over 4, 128)")
    # [kernels-families]: per step of [train-zamba2]'s 9 shared-block
    # applications and of [train-llava]'s 4 layers
    fam = lambda key: dict(
        zamba2=dict(per_step(fam_k[f"zamba_{key}"], ZAMBA_APPS),
                    shape="zamba2-2.7b (4, 2048, 32, 80)"),
        llava=dict(per_step(fam_k[f"llava_{key}"], LLAVA_LAYERS),
                   shape="llava-next-mistral-7b (2, 2048, 32 over 8, 128)"))
    kernels += [
        dict(name="flash_attention_fwd", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:78",
             **launches("flash_fwd"), bound_by="operations",
             **per_step(fa_fwd), dense=qwen2(dense_k["flash_fwd"]),
             families=fam("fwd"),
             serve=dict(serve_k["flash_fwd"], launches=sum(
                 r["flash_fwd"] for p, r in runs.items()
                 if p.startswith("serve-")), per="call")),
        dict(name="flash_attention_bwd", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/models/attention.py:137",
             replaces_note="B6 has no backward kernel: the JAX model "
                           "differentiates the remat'd chunked recurrence",
             **launches("flash_bwd_dq", "flash_bwd_dkdv"),
             bound_by="operations", **per_step(fa_bwd),
             dense=qwen2(dense_k["flash_bwd"]), families=fam("bwd")),
    ]
    # the SSD block: per train step of Mamba2-370m (48 layers, one launch
    # of each kernel a layer), measured per call at the main path's shape
    # and bf16 inputs; no single PyTorch call computes it
    per_step = lambda rec, n=SSD_LAYERS: {
        k: (v * n if k.endswith("ms") else v) for k, v in rec.items()}
    # [kernels-families]: per step of [train-zamba2]'s 54 layers
    zamba2 = lambda rec: dict(per_step(rec, ZAMBA_LAYERS),
                              shape="zamba2-2.7b (4, 2048, 80, 1, 64, 64)")
    kernels += [
        dict(name="ssd_chunk_fwd", route="cuda",
             source=src + "ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_chunk.py:61",
             **launches("ssd_fwd"), library_ms=None, **per_step(ssd_fwd),
             families=zamba2(fam_k["ssd_fwd"]),
             serve=dict(serve_k["ssd_fwd"], launches=sum(
                 r["ssd_fwd"] for p, r in runs.items()
                 if p.startswith("serve-")), per="call")),
        dict(name="ssd_chunk_bwd", route="cuda",
             source=src + "ssd_chunk.cu",
             replaces="src/repro/models/mamba2.py:108",
             replaces_note="B7 has no backward kernel: the JAX model "
                           "differentiates the jnp ssd_chunked",
             **launches("ssd_bwd_rows", "ssd_bwd_cols"),
             library_ms=None, **per_step(ssd_bwd),
             families=zamba2(fam_k["ssd_bwd"])),
    ]
    phase("[report] every check passed")
    print(json.dumps({"train": info, "remat": remat, "ckpt": ckpt_costs,
                      "serve": serve_info, "dryrun": dryrun,
                      "examples": examples_info}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
