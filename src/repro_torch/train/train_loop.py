"""Fault-tolerant training loop: deterministic data, the train step,
asynchronous atomic checkpoints with a preemption flush, straggler timing
and metric history; the port of the JAX package's ``train/train_loop.py``
without its telemetry, tracer and metrics arguments (ROADMAP.md Queue A).

Restart-safe as there: on start it restores the latest committed
checkpoint (falling back past corrupt ones) and fast-forwards the data
stream to the restored step, so a killed run resumes where it left off.
With ``install_signal_handler`` a SIGTERM / SIGINT writes a preemption
checkpoint of the state at the next step boundary (``meta.preempted``)
and is then handed on (``checkpoint/manager.py`` says why at the
boundary: parameters and the first moment are updated in place).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.core.types import GradientTransformation
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.train.steps import TrainState, build_train_step

log = logging.getLogger(__name__)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    log_every: int = 50
    ckpt: Optional[CheckpointConfig] = None
    microbatches: int = 1
    grad_clip_norm: Optional[float] = None
    # Cap on the in-memory metric history (a deque of the most recent
    # entries); None keeps every logged entry.
    history_cap: Optional[int] = None


def train(model, opt: GradientTransformation, data_cfg: DataConfig,
          loop_cfg: LoopConfig, *, device: torch.device,
          params: Optional[dict] = None, seed: int = 0,
          state: Optional[TrainState] = None,
          metric_hook: Optional[Callable[[int, dict], None]] = None,
          install_signal_handler: bool = False
          ) -> tuple[TrainState, list]:
    """Train until step ``loop_cfg.total_steps``.  The start state is, in
    order: the latest good checkpoint under ``loop_cfg.ckpt`` (if any),
    else ``state`` (a mid-run state resumes at its own step), else fresh,
    with ``params`` (a nested dict of fp32 tensors on ``device``) or
    ``model.init`` from a generator seeded with ``seed``.

    Returns ``(final_state, history)``; history holds the metrics of the
    first step run and of every ``log_every``-th, each with its wall time
    (``step_time_s``, taken after the device has finished the step); each
    entry also goes to ``metric_hook(step, metrics)``.  With checkpoints:
    one every ``ckpt.save_every`` steps, asynchronous, and a final
    blocking one at ``total_steps``."""
    ckpt = CheckpointManager(loop_cfg.ckpt) if loop_cfg.ckpt else None
    if state is None:
        if params is None:
            params = model.init(
                torch.Generator(device=device).manual_seed(seed))
        state = TrainState.create(params, opt)
    start_step = state.step
    if ckpt is not None and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state)
        log.info("restored checkpoint at step %d", start_step)

    step_fn = build_train_step(model, opt, microbatches=loop_cfg.microbatches,
                               grad_clip_norm=loop_cfg.grad_clip_norm)
    data = DataIterator(data_cfg, start_step=start_step)
    monitor = StragglerMonitor()
    history = (collections.deque(maxlen=loop_cfg.history_cap)
               if loop_cfg.history_cap is not None else [])
    boundary = {"state": state, "step": start_step}
    if ckpt is not None and install_signal_handler:
        ckpt.install_preemption_handler(
            lambda: (boundary["state"], boundary["step"]))
    try:
        for step in range(start_step, loop_cfg.total_steps):
            tokens = torch.from_numpy(next(data)["tokens"]).to(device)
            monitor.start()
            state, metrics = step_fn(state, {"tokens": tokens})
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = monitor.stop()
            boundary["state"], boundary["step"] = state, step + 1
            if (step + 1) % loop_cfg.log_every == 0 or step == start_step:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step + 1, step_time_s=dt)
                history.append(m)
                if metric_hook:
                    metric_hook(step + 1, m)
                log.info("step %d loss %.4f (%.3fs)", step + 1, m["loss"], dt)
            if ckpt is not None and ckpt.should_save(step + 1):
                ckpt.save(state, step + 1)
            if ckpt is not None and install_signal_handler:
                ckpt.at_step_boundary()
    finally:
        data.close()
        if ckpt is not None:
            if install_signal_handler:
                # before wait(): a failed async save re-raises there
                ckpt.uninstall_preemption_handler()
            ckpt.wait()
    if ckpt is not None:
        ckpt.save(state, loop_cfg.total_steps, blocking=True)
    return state, list(history)
