"""Deterministic collectives for the mesh paths, and the autograd pairs
that make them differentiable.

Every reduction here is an all-gather followed by a sum in group-rank
order, so each rank gets the same bits, run after run, whatever the
backend's own reduction order: the same-mesh restart is bitwise, and the
ranks that run the same optimizer update stay identical.  On a group of
one rank every function is an exact identity (a sum of one term is that
term), which is what lets a ``--mesh 1,1`` run be held bitwise to the
run without a mesh.

The autograd pairs are Megatron's: ``copy_to`` is the identity forward
and sums the gradient over the group backward (an input every rank of the
group holds whole, into a computation each rank does a part of);
``reduce_from`` sums forward and is the identity backward (the parts'
combine, after which every rank computes the same loss).  ``gather_dim``
concatenates the ranks' blocks along a dimension forward and hands each
rank its block of the summed gradient backward (a reduce-scatter).
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``, added in group-rank
    order; the same on every rank."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return functools.reduce(torch.add, parts[1:], parts[0])


def all_concat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return all_concat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return (all_sum(g, ctx.group).narrow(ctx.dim, me * ctx.n, ctx.n)
                .contiguous(), None, None)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherDim.apply(x, dim, group)


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` forward, its gradient times ``scale`` backward."""
    return _ScaleGrad.apply(x, scale)


def axis_groups(mesh, axes) -> list:
    """The process groups of ``mesh``'s dimensions named in ``axes`` that
    are in the mesh, in the order given."""
    names = mesh.mesh_dim_names or ()
    return [mesh.get_group(a) for a in axes if a in names]


def axis_size(mesh, axes) -> int:
    """The product of the sizes of ``mesh``'s dimensions named in
    ``axes`` (an absent name counts 1)."""
    names = mesh.mesh_dim_names or ()
    n = 1
    for a in axes:
        if a in names:
            n *= mesh.size(names.index(a))
    return n
