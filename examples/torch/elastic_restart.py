"""Elastic-scaling example on the PyTorch port: checkpoint under one mesh
plan, resume under a smaller one (simulating node loss), with the
optimizer state restored alongside (the port's counterpart of
``examples/elastic_restart.py``).  It needs one device: a real cluster
re-places the same tensors across whatever survives.

    PYTHONPATH=src python examples/torch/elastic_restart.py
    PYTHONPATH=src python examples/torch/elastic_restart.py --device cpu

It runs on the GPU; ``--device cpu`` is the only way onto the CPU, and
without a GPU and without it the script raises.
"""
import argparse
import tempfile

import torch

from repro_torch import tree
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.config import OptimizerConfig
from repro_torch.core import build_optimizer
from repro_torch.device import resolve_device
from repro_torch.distributed import plan_remesh
from repro_torch.models import build_model
from repro_torch.train import TrainState


def main(argv=None) -> dict:
    """Save, plan, restore and print; returns ``{"plan", "step",
    "bit_identical"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config("qwen2-7b")
    model = build_model(cfg)
    opt = build_optimizer(OptimizerConfig(
        name="adapprox", schedule="constant", lr=1e-3, weight_decay=0.0,
        k=4, rank_mode="static", min_dim_factor=16, implicit=False))
    params = model.init(torch.Generator(device=device).manual_seed(0))
    state = TrainState.create(params, opt)

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(CheckpointConfig(directory=d,
                                                 async_save=False))
        mgr.save(state, step=123)

        # simulate losing 16 of 512 devices -> plan keeps TP, shrinks data
        plan = plan_remesh(available_devices=496, target_model=16)
        print(f"re-mesh plan after node loss: pods={plan.pods} "
              f"data={plan.data} model={plan.model} ({plan.devices} "
              f"devices)")

        restored, step = mgr.restore(state)
        same = all(torch.equal(a, b) for a, b in zip(
            tree.flatten(state.params).values(),
            tree.flatten(restored.params).values()))
        print(f"restored step {step}; params bit-identical:", same)
    return {"plan": plan, "step": step, "bit_identical": same}


if __name__ == "__main__":
    main()
