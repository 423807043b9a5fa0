"""The plain training loop: deterministic data, train step, metric
history.  Checkpointing, tracing and telemetry are not ported yet (see
ROADMAP.md)."""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import torch

from repro_torch.core.types import GradientTransformation
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.train.steps import TrainState, build_train_step

log = logging.getLogger(__name__)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    log_every: int = 50
    microbatches: int = 1
    grad_clip_norm: Optional[float] = None


def train(model, opt: GradientTransformation, data_cfg: DataConfig,
          loop_cfg: LoopConfig, *, device: torch.device,
          params: Optional[dict] = None, seed: int = 0
          ) -> tuple[TrainState, list]:
    """Train for ``loop_cfg.total_steps`` steps.  ``params`` (a nested dict
    of fp32 tensors on ``device``) defaults to ``model.init`` from a
    generator seeded with ``seed``.  Returns ``(final_state, history)``;
    history holds the metrics of the first step and of every
    ``log_every``-th, with the step's wall time (``step_time_s``, taken
    after the device has finished the step)."""
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(seed))
    state = TrainState.create(params, opt)
    step_fn = build_train_step(model, opt, microbatches=loop_cfg.microbatches,
                               grad_clip_norm=loop_cfg.grad_clip_norm)
    data = DataIterator(data_cfg)
    history = []
    try:
        for step in range(loop_cfg.total_steps):
            tokens = torch.from_numpy(next(data)["tokens"]).to(device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, {"tokens": tokens})
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if (step + 1) % loop_cfg.log_every == 0 or step == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step + 1, step_time_s=dt)
                history.append(m)
                log.info("step %d loss %.4f (%.3fs)", step + 1, m["loss"], dt)
    finally:
        data.close()
    return state, history
