"""Train step: loss -> autograd -> optimizer, with microbatch gradient
accumulation in fp32 and an optional global-norm clip.  Master parameters
are fp32; the model casts them to its compute dtype.  The step metrics
are the JAX package's: the model's (``aux_loss``; the microbatch path
keeps only the loss), ``loss`` the total the gradients are of, ``step``
the state's step before the update, and the optimizer's telemetry
aggregates (``telemetry.collect.telemetry_metrics``).

On a device mesh (``state_shardings`` from
``distributed.sharding.train_shardings``) the state's split leaves are
DTensors, and a step: gathers every leaf whole (the model's mesh-local
leaves, the MoE expert stacks, it takes as this rank's blocks instead);
takes this rank's block of the batch (``batch_shardings``, over the dp
axes); sums the gradients and the metrics over the dp axes in a fixed
order (``distributed/comm.py``) and divides by their size, so every rank
holds the gradient of the global batch's mean loss; runs the same
optimizer update on every rank; and keeps each rank's blocks of the new
state.  On a mesh of one rank every collective is an identity, and the
step is the unsharded one, bit for bit."""
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


class _MeshStep:
    """The mesh side of a train step (see the module docstring)."""

    def __init__(self, model, state_shardings: TrainState,
                 batch_shardings: Optional[dict]):
        from repro_torch.distributed import comm
        from repro_torch.distributed import sharding as SH
        self.SH, self.comm = SH, comm
        self.shardings = state_shardings
        self.batch = batch_shardings or {}
        self.mesh = state_shardings.step.mesh
        self.local = set(getattr(model, "mesh_local_leaves", tuple)())
        tok = self.batch.get("tokens")
        spec0 = tok.spec[0] if tok is not None and tok.spec else None
        self.dp = (spec0 if isinstance(spec0, tuple)
                   else (spec0,) if spec0 else ())
        self.n_dp = comm.axis_size(self.mesh, self.dp)

    def gather(self, state: TrainState):
        """(whole params, the model's params, whole optimizer state)."""
        with torch.no_grad():
            full = {k: self.SH.gather(v) for k, v in state.params.items()}
            opt_state = self.SH.gather_tree(state.opt_state)
        model_params = {
            k: (v.detach() if k in self.local else v).requires_grad_(True)
            for k, v in self.SH.model_params(state.params, self.local,
                                             full).items()}
        return full, model_params, opt_state

    def split(self, batch: dict) -> dict:
        return {k: self.SH.local_block(x, self.batch[k]) if k in self.batch
                else x for k, x in batch.items()}

    def dp_mean(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """The sum of ``x`` over the dp axes (the minor one first), over
        their size."""
        for g in reversed(self.comm.axis_groups(
                self.mesh, self.dp if axes is None else axes)):
            x = self.comm.all_sum(x, g)
        return x / self.n_dp

    def reduce(self, grads: dict, metrics: dict):
        """Whole gradients of the global batch's mean loss, and the
        metrics averaged over the dp axes."""
        out = {}
        for k, g in grads.items():
            if k in self.local:
                # moe_apply_sharded's gather summed these over "data" in
                # its backward; the other dp axes remain
                g = self.dp_mean(g, tuple(a for a in self.dp if a != "data"))
                from torch.distributed.tensor import DTensor
                sh = self.shardings.params[k]
                g = DTensor.from_local(g, sh.mesh, sh.placements,
                                       run_check=False).full_tensor()
            else:
                g = self.dp_mean(g)
            out[k] = g
        metrics = {k: self.dp_mean(v.float()) if isinstance(v, torch.Tensor)
                   and v.dim() == 0 and v.is_floating_point() else v
                   for k, v in metrics.items()}
        return out, metrics

    def place(self, params: dict, opt_state, step: int) -> TrainState:
        return self.SH.place_state(TrainState(params, opt_state, step),
                                   self.shardings)


def _grads_of(model, params: dict, batch: dict):
    loss, metrics = model.loss(tree.unflatten(params), batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return (dict(zip(params, grads)), loss.detach(),
            {k: v.detach() for k, v in metrics.items()})


def microbatch_grads(model, params: dict, batch: dict,
                     microbatches: int = 1):
    """``(grads, loss, metrics)`` of the model's loss on ``batch`` at
    ``params`` (flat): with ``microbatches`` > 1 every tensor of the batch
    splits on its leading axis, and the gradients are accumulated in fp32
    and averaged, as is the loss."""
    if microbatches == 1:
        return _grads_of(model, params, batch)
    for k, x in batch.items():
        if x.shape[0] % microbatches:
            raise ValueError(f"batch {k!r} of {x.shape[0]} does not "
                             f"split into {microbatches} microbatches")
    parts = {k: x.chunk(microbatches) for k, x in batch.items()}
    acc = {k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in params.items()}
    loss_sum = None
    for i in range(microbatches):
        grads, loss, _ = _grads_of(
            model, params, {k: xs[i] for k, xs in parts.items()})
        acc = {k: a + grads[k].float() for k, a in acc.items()}
        loss_sum = loss if loss_sum is None else loss_sum + loss
    inv = 1.0 / microbatches
    loss = loss_sum * inv
    return {k: g * inv for k, g in acc.items()}, loss, {"loss": loss}


def build_train_step(model, opt: GradientTransformation,
                     microbatches: int = 1,
                     grad_clip_norm: Optional[float] = None,
                     state_shardings: Optional[TrainState] = None,
                     batch_shardings: Optional[dict] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    is a dict of tensors on the parameters' device, ``{"tokens": (B, S)}``
    and, for the vlm and encdec families, ``"embeds"`` (the stub
    frontend's output): the model's loss takes the whole dict, and
    microbatches split every tensor of it on the leading axis, as in the
    JAX package.  ``state_shardings`` / ``batch_shardings`` run the step
    on their device mesh (see the module docstring)."""
    mesh = (_MeshStep(model, state_shardings, batch_shardings)
            if state_shardings is not None else None)

    def train_step(state: TrainState, batch: dict):
        if mesh is None:
            params, model_params, opt_state = (state.params, state.params,
                                               state.opt_state)
        else:
            params, model_params, opt_state = mesh.gather(state)
            batch = mesh.split(batch)
        grads, loss, metrics = microbatch_grads(model, model_params, batch,
                                                microbatches)
        if mesh is not None:
            metrics = dict(metrics, loss=loss)
            grads, metrics = mesh.reduce(grads, metrics)
            loss = metrics["loss"]
        if grad_clip_norm is not None:
            norm = global_norm(grads)
            scale = torch.clamp_max(grad_clip_norm / (norm + 1e-12), 1.0)
            grads = {k: g * scale for k, g in grads.items()}
            metrics = dict(metrics, grad_norm=norm)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            apply_updates(params, updates)
        # the model's metrics (the MoE aux loss), the total as "loss" and
        # the step, as in the JAX package; then per-group aggregates of the
        # optimizer's snapshots and the guard counters (empty without
        # either): host numbers where the port holds them on the host, else
        # 0-d device tensors
        metrics = dict(metrics, loss=loss, step=state.step)
        metrics.update(telemetry_metrics(opt_state))
        if mesh is not None:
            return mesh.place(params, opt_state, state.step + 1), metrics
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1), metrics)

    return train_step
