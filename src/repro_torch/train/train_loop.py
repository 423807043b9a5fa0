"""Fault-tolerant training loop: deterministic data, the train step,
asynchronous atomic checkpoints with a preemption flush, straggler timing,
metric history and the telemetry subsystem (``repro_torch.telemetry``);
the port of the JAX package's ``train/train_loop.py``.

Restart-safe as there: on start it restores the latest committed
checkpoint (falling back past corrupt ones) and fast-forwards the data
stream to the restored step, so a killed run resumes where it left off.
With ``install_signal_handler`` a SIGTERM / SIGINT writes a preemption
checkpoint of the state at the next step boundary (``meta.preempted``)
and is then handed on (``checkpoint/manager.py`` says why at the
boundary: parameters and the first moment are updated in place).

Telemetry, as in JAX: a ``TelemetryRuntime`` reads the optimizer's
snapshots after each step's ``torch.cuda.synchronize``, streams events to
its sink, lets its controller retune the refresh cadence, saves its
controller state into every checkpoint manifest and restores it from the
manifest of the step the restore landed on; the straggler monitor writes
to its sink.  A ``Tracer`` records a ``train_step`` span a step, with
``data_wait`` / ``step_dispatch`` / ``device_sync`` children (the last is
the synchronize) and the refresh-or-fold ``phase`` from the snapshot's
host counters, plus the checkpoint spans; the preemption path drains its
open spans and the telemetry sink, best-effort, before the checkpoint.
``metrics_every`` adds a ``kind="metric"`` registry snapshot every N
steps.  Spans touch no tensor, so a traced run is bitwise the untraced
one.

Sharded runs, as in JAX: ``state_shardings`` / ``batch_shardings``
(``distributed.sharding.train_shardings``) place the state on their
device mesh and run the mesh step (``train/steps.py``); every rank runs
this loop on the same global batches, checkpoints record each leaf's
spec, and a restore is placed under the run's shardings whatever mesh
wrote it.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.core.types import GradientTransformation
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.telemetry.trace import NULL_TRACER
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


def _host_metrics(metrics: dict) -> dict:
    """The step metrics as Python floats, the device scalars among them
    (the loss, device-side telemetry means) read in one transfer."""
    dev = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    vals = {}
    if dev:
        d0 = metrics[dev[0]].device
        vals = dict(zip(dev, torch.stack(
            [metrics[k].detach().float().reshape(()).to(d0)
             for k in dev]).cpu().tolist()))
    return {k: vals[k] if k in vals else float(v)
            for k, v in metrics.items()}


def _refresh_phase(metrics: dict) -> Optional[str]:
    """Refresh-or-fold attribution of the step span from the snapshots'
    ``telemetry/<group>/did_refresh`` (host numbers; absent when the
    optimizer collects no telemetry)."""
    flags = [v for k, v in metrics.items() if k.endswith("/did_refresh")]
    if not flags:
        return None
    return "refresh" if any(bool(f) for f in flags) else "fold"


def train(model, opt: GradientTransformation, data_cfg: DataConfig,
          loop_cfg: LoopConfig, *, device: torch.device,
          params: Optional[dict] = None, seed: int = 0,
          state: Optional[TrainState] = None,
          metric_hook: Optional[Callable[[int, dict], None]] = None,
          telemetry=None, tracer=None, metrics_every: int = 0,
          registry=None, install_signal_handler: bool = False,
          state_shardings: Optional[TrainState] = None,
          batch_shardings: Optional[dict] = None
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
    blocking one at ``total_steps``.

    ``telemetry``: a ``repro_torch.telemetry.TelemetryRuntime`` (the
    caller owns it and closes it).  ``tracer``: a ``Tracer`` (the caller
    owns its sink).  ``metrics_every`` > 0 emits a registry snapshot
    (``train_steps_total``, ``train_step_seconds``, ``train_loss``) every
    N steps to the tracer's sink, else the runtime's; ``registry``
    defaults to the tracer's, else the process-wide one.

    ``state_shardings`` (a ``TrainState`` of ``NamedSharding``) and
    ``batch_shardings`` run the steps on their device mesh; a ``state``
    given whole is placed under them."""
    ckpt = CheckpointManager(loop_cfg.ckpt) if loop_cfg.ckpt else None
    if ckpt is not None:
        ckpt.shardings = state_shardings
    tr = tracer if tracer is not None else NULL_TRACER
    if ckpt is not None and tracer is not None:
        ckpt.tracer = tracer
    reg = metric_sink = None
    if metrics_every > 0:
        from repro_torch.telemetry import metrics as metrics_mod
        reg = registry if registry is not None else (
            tracer.registry if tracer is not None
            and tracer.registry is not None
            else metrics_mod.default_registry())
        metric_sink = (tracer.sink if tracer is not None
                       and tracer.sink is not None
                       else telemetry.sink if telemetry is not None
                       else None)
    if state is None:
        if params is None:
            params = model.init(
                torch.Generator(device=device).manual_seed(seed))
        state = TrainState.create(params, opt)
    if state_shardings is None:
        for p in state.params.values():   # a given state's, gathered ones
            p.requires_grad_(True)
    else:
        state = TrainState(
            params={k: SH.place(v, state_shardings.params[k])
                    for k, v in state.params.items()},
            opt_state=SH.place_tree(state.opt_state,
                                    state_shardings.opt_state),
            step=state.step)
    start_step = state.step
    if ckpt is not None and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state)
        log.info("restored checkpoint at step %d", start_step)
        if telemetry is not None:
            # the controller resumes from the manifest of the step the
            # restore landed on (a fallback past a corrupt latest included)
            telemetry.restore_meta(ckpt.read_meta(start_step))

    step_fn = build_train_step(model, opt, microbatches=loop_cfg.microbatches,
                               grad_clip_norm=loop_cfg.grad_clip_norm,
                               state_shardings=state_shardings,
                               batch_shardings=batch_shardings)
    data = DataIterator(data_cfg, start_step=start_step)
    monitor = StragglerMonitor(
        sink=telemetry.sink if telemetry is not None else None)
    history = (collections.deque(maxlen=loop_cfg.history_cap)
               if loop_cfg.history_cap is not None else [])

    def meta():
        return telemetry.manifest_meta() if telemetry is not None else None

    # (state, step, controller meta) as one tuple in one assignment, so a
    # preemption never pairs a step's state with another step's meta; kept
    # (and replaced every step) only while the handler is installed
    preempt = ckpt is not None and install_signal_handler
    latest = {"snap": (state, start_step, meta()) if preempt else None}
    if preempt:

        def flush_state():
            # drain open spans and the telemetry sink first, best-effort:
            # a sick sink must never cost the preemption checkpoint
            if tracer is not None:
                try:
                    tracer.drain_open()
                    tracer.flush()
                except Exception:  # noqa: BLE001 -- checkpoint comes first
                    log.exception("span drain failed during preemption; "
                                  "saving checkpoint anyway")
            if telemetry is not None:
                try:
                    telemetry.flush()
                except Exception:  # noqa: BLE001 -- checkpoint comes first
                    log.exception("telemetry flush failed during "
                                  "preemption; saving checkpoint anyway")
            return latest["snap"]

        ckpt.install_preemption_handler(flush_state)

    run_trace = tr.new_trace("train") if tracer is not None else None
    loop_t0 = time.monotonic()
    try:
        for step in range(start_step, loop_cfg.total_steps):
            with tr.span("train_step", trace=run_trace,
                         step=step + 1) as step_span:
                with tr.span("data_wait"):
                    tokens = torch.from_numpy(next(data)["tokens"]).to(device)
                monitor.start()
                with tr.span("step_dispatch"):
                    state, metrics = step_fn(state, {"tokens": tokens})
                with tr.span("device_sync"):
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                dt = monitor.stop()
                if tracer is not None:
                    phase = _refresh_phase(metrics)
                    if phase is not None:
                        step_span.set(phase=phase)
            if telemetry is not None:
                state = telemetry.on_step(step + 1, state)
            if preempt:
                latest["snap"] = (state, step + 1, meta())
            if reg is not None:
                reg.counter("train_steps_total",
                            help="train steps completed").inc()
                reg.histogram("train_step_seconds",
                              help="wall time per train step").observe(dt)
                if (step + 1) % metrics_every == 0:
                    reg.gauge("train_loss",
                              help="loss at the last snapshot").set(
                                  float(metrics["loss"]))
                    if metric_sink is not None:
                        metric_sink.emit(reg.snapshot(
                            t_s=time.monotonic() - loop_t0, step=step + 1))
            if (step + 1) % loop_cfg.log_every == 0 or step == start_step:
                m = _host_metrics(metrics)
                m.update(step=step + 1, step_time_s=dt)
                history.append(m)
                if metric_hook:
                    metric_hook(step + 1, m)
                log.info("step %d loss %.4f (%.3fs)", step + 1, m["loss"], dt)
            if ckpt is not None and ckpt.should_save(step + 1):
                with tr.span("checkpoint_save", trace=run_trace,
                             step=step + 1):
                    ckpt.save(state, step + 1, extra_meta=meta())
            if preempt:
                ckpt.at_step_boundary()
    finally:
        data.close()
        if ckpt is not None:
            if install_signal_handler:
                # before wait(): a failed async save re-raises there
                ckpt.uninstall_preemption_handler()
            ckpt.wait()
        if telemetry is not None:
            try:
                telemetry.flush()
            except Exception:  # noqa: BLE001 -- never mask the exception
                log.exception("telemetry flush failed at loop exit")
        if tracer is not None:
            try:
                tracer.flush()
            except Exception:  # noqa: BLE001 -- same rule
                log.exception("tracer flush failed at loop exit")
    if ckpt is not None:
        with tr.span("checkpoint_save", trace=run_trace,
                     step=loop_cfg.total_steps):
            ckpt.save(state, loop_cfg.total_steps, blocking=True,
                      extra_meta=meta())
        if tracer is not None:
            try:
                tracer.flush()
            except Exception:  # noqa: BLE001
                log.exception("tracer flush failed after final save")
    return state, list(history)
