"""Bisect a train cell's per-rank peak: forward | grad | opt | train, the
port of the JAX package's ``tools/probe_memory.py``, over the dry run.

    PYTHONPATH=src python -m repro_torch.tools.probe_memory qwen2-7b all
    PYTHONPATH=src python -m repro_torch.tools.probe_memory kimi-k2-1t-a32b grad --mesh multi

The ``train_4k`` cell is placed on fake tensors over the fake production
mesh, as ``launch/dryrun.py`` places it, and each stage runs on this
rank's blocks as the port's mesh step (``train/steps.py::_MeshStep``)
does: ``fwd`` the loss over the microbatches of this rank's batch block,
each leaf gathered at use, ``grad`` their gradient blocks accumulated in
fp32 by the step's own ``grads``, ``opt`` the optimizer update on
gradient blocks, ``train`` the whole step.  Each line gives the
stage's peak of live bytes and what the rank held before it (the placed
state and the batch), counted by ``launch/step_cost.py``; no time, and the
plain route's temporaries (see the dry run's docstring).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import tree
from repro_torch.core.types import apply_updates
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.step_cost import StepCost
from repro_torch.distributed.sharding import gathering
from repro_torch.train.steps import _MeshStep

STAGES = ("fwd", "grad", "opt", "train")


def _microbatches(batch: dict, n: int) -> list:
    parts = {k: x.chunk(n) for k, x in batch.items()}
    return [{k: xs[i] for k, xs in parts.items()} for i in range(n)]


def _stage(c: D.Cell, inputs: dict, what: str) -> None:
    """Run one stage on the placed inputs (under a fake mode)."""
    if what == "train":
        D.run_step(c, inputs)
        return
    ms = _MeshStep(c.model, inputs["state_shardings"],
                   inputs["batch_shardings"])
    params, model_params, opt_state = ms.blocks(inputs["state"])
    batch = ms.split(inputs["batch"])
    if what == "fwd":
        with torch.no_grad(), gathering(ms.use):
            for b in _microbatches(batch, c.microbatches):
                c.model.loss(tree.unflatten(model_params), b)
        return
    if what == "grad":
        ms.grads(c.model, model_params, batch, c.microbatches)
        return
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    with torch.no_grad(), ms.on_blocks():
        updates, _ = c.opt.update(grads, opt_state, params)
        apply_updates(params, updates)


def stage_peak(c: D.Cell, stage: str) -> tuple:
    """``(peak bytes, bytes held before it)`` of one stage of a fresh
    train cell, placed and run on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        inputs = D.place_inputs(c)
        cost = StepCost()
        cost.track(inputs["state"], inputs["batch"])
        held = cost.live_bytes
        with cost:
            _stage(c, inputs, stage)
    return cost.peak_bytes, held


def probe(arch: str, what: str, multi_pod: bool = False) -> dict:
    """``{stage: (peak bytes, bytes held before it)}`` of the train_4k
    cell of ``arch`` on the fake production mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
    # a cell a fake mode: its optimizer keeps tensors of the mode
    return {stage: stage_peak(D.build_cell(arch, "train_4k", mesh), stage)
            for stage in (STAGES if what == "all" else (what,))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch", nargs="?", default="qwen2-7b")
    ap.add_argument("what", nargs="?", default="all",
                    choices=("all",) + STAGES)
    ap.add_argument("--mesh", default="pod", choices=("pod", "multi"))
    args = ap.parse_args(argv)
    D.quiet_redistribute()
    import torch.distributed as dist
    try:
        res = probe(args.arch, args.what, args.mesh == "multi")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for stage, (peak, held) in res.items():
        print(f"{stage:12s} peak={peak / 2**30:7.2f} GiB  "
              f"held={held / 2**30:6.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
