"""Pipeline parallelism (GPipe schedule) over a mesh axis: the JAX
package's ``distributed/pipeline.py``.

Layers are split into S stages, one a rank of the ``axis`` dimension;
each tick every stage runs one microbatch and hands its activation to the
next stage.  The bubble is the usual (S-1)/(M+S-1) fraction, and bubble
ticks feed zeros, as in JAX.  JAX's ``ppermute`` is differentiable (its
transpose is the reverse permute); torch's ``send`` / ``recv`` are not,
so the hand-off is an autograd function whose backward is the reverse
shift, and the final broadcast from the last stage is a sum over the
axis whose backward is the identity (``distributed/comm.py``'s
``reduce_from``).  ``torch.autograd`` through :func:`pipeline_apply` then
runs the reverse-schedule backward pass.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import comm


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank i of ``group`` sends ``x`` to rank i + step and returns what
    rank i - step sent (zeros where there is no such rank)."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    out = torch.zeros_like(x)
    ops = []
    if 0 <= me + step < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, me + step), group))
    if 0 <= me - step < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, me - step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PermuteNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   mesh, axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(params_stage, x) -> x`` as an S-stage GPipe pipeline
    over the mesh dimension ``axis``.

    stage_params: a tensor or a dict of tensors with a leading (S, ...)
    stage dim, whole on every rank: each rank takes its stage's slice, so
    its gradient holds that slice, zeros elsewhere (sum it over ``axis``
    for the whole gradient).
    x_micro: (M, mb, ...) microbatches, the same on every rank.  Returns
    the (M, mb, ...) outputs on every rank."""
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    s_idx = dist.get_rank(group)
    params = ({k: v[s_idx] for k, v in stage_params.items()}
              if isinstance(stage_params, dict) else stage_params[s_idx])
    m = x_micro.shape[0]
    outputs = [torch.zeros_like(x_micro[0]) for _ in range(m)]
    prev = torch.zeros_like(x_micro[0])
    first = torch.tensor(s_idx == 0, device=x_micro.device)
    last = torch.tensor(s_idx == n_stages - 1, device=x_micro.device)
    for t in range(m + n_stages - 1):
        # stage 0 injects microbatch t (bubble ticks feed zeros), the
        # others take the hand-off.  Selects, as in JAX, rather than
        # branches: every rank's graph then holds every hand-off, so each
        # rank runs the same backward shifts in the same order
        inject = x_micro[min(t, m - 1)] * float(t < m)
        x_in = torch.where(first, inject, prev)
        y = stage_fn(params, x_in)
        out_idx = t - (n_stages - 1)
        if out_idx >= 0:
            # the last stage commits microbatch t - (S - 1)
            outputs[out_idx] = torch.where(last, y, outputs[out_idx])
        prev = _PermuteNext.apply(y, group)
    # only the last stage's buffer is nonzero: the sum broadcasts it
    return comm.reduce_from(torch.stack(outputs), group)


def split_stages(layer_params, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-major; a tensor
    or a dict of them."""
    def rs(p):
        l = p.shape[0]
        if l % n_stages:
            raise ValueError(f"{l} layers do not split into {n_stages} "
                             f"stages")
        return p.reshape((n_stages, l // n_stages) + tuple(p.shape[1:]))
    if isinstance(layer_params, dict):
        return {k: rs(v) for k, v in layer_params.items()}
    return rs(layer_params)


def stage_fn_from_layers(layer_fn: Callable) -> Callable:
    """``layer_fn(params_layer, x) -> x`` lifted to a stage: the stage's
    layers in order."""
    def stage(params_stage, x):
        n = (next(iter(params_stage.values())) if isinstance(
            params_stage, dict) else params_stage).shape[0]
        for i in range(n):
            lp = ({k: v[i] for k, v in params_stage.items()}
                  if isinstance(params_stage, dict) else params_stage[i])
            x = layer_fn(lp, x)
        return x
    return stage
