"""Train step: loss -> autograd -> optimizer, with microbatch gradient
accumulation in fp32 and an optional global-norm clip.  Master parameters
are fp32; the model casts them to its compute dtype.  The step metrics
are the JAX package's: the model's (``aux_loss``; the microbatch path
keeps only the loss), ``loss`` the total the gradients are of, ``step``
the state's step before the update, and the optimizer's telemetry
aggregates (``telemetry.collect.telemetry_metrics``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core.types import (GradientTransformation, apply_updates,
                                    global_norm)
from repro_torch.telemetry.collect import telemetry_metrics


@dataclasses.dataclass
class TrainState:
    params: dict          # flat {path: fp32 tensor}, JAX flatten order
    opt_state: Any
    step: int

    @staticmethod
    def create(params: dict, opt: GradientTransformation) -> "TrainState":
        flat = tree.flatten(params)
        for p in flat.values():
            p.requires_grad_(True)
        return TrainState(params=flat, opt_state=opt.init(flat), step=0)


def build_train_step(model, opt: GradientTransformation,
                     microbatches: int = 1,
                     grad_clip_norm: Optional[float] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    is a dict of tensors on the parameters' device, ``{"tokens": (B, S)}``
    and, for the vlm and encdec families, ``"embeds"`` (the stub
    frontend's output): the model's loss takes the whole dict, and
    microbatches split every tensor of it on the leading axis, as in the
    JAX package."""

    def grads_of(params: dict, batch: dict):
        loss, metrics = model.loss(tree.unflatten(params), batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (dict(zip(params, grads)), loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    def compute_grads(params: dict, batch: dict):
        if microbatches == 1:
            return grads_of(params, batch)
        for k, x in batch.items():
            if x.shape[0] % microbatches:
                raise ValueError(f"batch {k!r} of {x.shape[0]} does not "
                                 f"split into {microbatches} microbatches")
        parts = {k: x.chunk(microbatches) for k, x in batch.items()}
        acc = {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()}
        loss_sum = None
        for i in range(microbatches):
            grads, loss, _ = grads_of(
                params, {k: xs[i] for k, xs in parts.items()})
            acc = {k: a + grads[k].float() for k, a in acc.items()}
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / microbatches
        loss = loss_sum * inv
        return {k: g * inv for k, g in acc.items()}, loss, {"loss": loss}

    def train_step(state: TrainState, batch: dict):
        grads, loss, metrics = compute_grads(state.params, batch)
        if grad_clip_norm is not None:
            norm = global_norm(grads)
            scale = torch.clamp_max(grad_clip_norm / (norm + 1e-12), 1.0)
            grads = {k: g * scale for k, g in grads.items()}
            metrics = dict(metrics, grad_norm=norm)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            apply_updates(state.params, updates)
        # the model's metrics (the MoE aux loss), the total as "loss" and
        # the step, as in the JAX package; then per-group aggregates of the
        # optimizer's snapshots and the guard counters (empty without
        # either): host numbers where the port holds them on the host, else
        # 0-d device tensors
        metrics = dict(metrics, loss=loss, step=state.step)
        metrics.update(telemetry_metrics(opt_state))
        return (TrainState(params=state.params, opt_state=opt_state,
                           step=state.step + 1), metrics)

    return train_step
