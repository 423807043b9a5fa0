"""Deterministic collectives for the mesh paths, and the autograd pairs
that make them differentiable.

Every reduction here sums in group-rank order, so each rank gets the same
bits, run after run, whatever the backend's own reduction order: the
same-mesh restart is bitwise, and the ranks that hold the same block stay
identical.  :func:`reduce_scatter` hands each rank every rank's part of
its own block (one ``all_to_all_single``) and adds those; :func:`all_sum`
all-gathers a small tensor's n copies and adds them, and reduce-scatters
a large one and all-gathers the sums: the same terms in the same order
either way, so every form equals every other bit for bit.  On a group of
one rank every function is an exact identity (a sum of one term is that
term), which is what lets a ``--mesh 1,1`` run be held bitwise to the
run without a mesh.

The autograd pairs are Megatron's: ``copy_to`` is the identity forward
and sums the gradient over the group backward (an input every rank of the
group holds whole, into a computation each rank does a part of);
``reduce_from`` sums forward and is the identity backward (the parts'
combine, after which every rank computes the same loss).  ``gather_dim``
concatenates the ranks' blocks along a dimension forward and hands each
rank its block of the summed gradient backward (a reduce-scatter); it
keeps only the block, so a saved-tensor hook can gather the whole again
in the backward instead of keeping it (``distributed/sharding.py``).
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist


# all_sum moves a tensor of at least this many entries as a reduce-scatter
# and an all-gather of the summed chunks (the same sums, bit for bit)
# instead of gathering every rank's whole copy
SCATTER_MIN = 1 << 16


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``, added in group-rank
    order; the same on every rank.  A small ``x`` is all-gathered and
    added; a large one reduce-scattered in chunks (:func:`reduce_scatter`)
    and the sums all-gathered, so no rank holds n copies."""
    n = dist.get_world_size(group)
    if x.numel() < SCATTER_MIN or n == 1:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return functools.reduce(torch.add, parts[1:], parts[0])
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mine = reduce_scatter(flat, 0, group)
    return all_concat(mine, 0, group)[:x.numel()].reshape(x.shape)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over ``group`` of every rank's ``x`` (no
    gradient); the same on every rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts).amax(dim=0)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block (``x.chunk(n, dim)[rank]``) of the sum over
    ``group`` of every rank's ``x``, added in group-rank order:
    ``all_sum(x, group)`` sliced, bit for bit.  ``x.shape[dim]`` must
    divide by the group's size; a group of one returns ``x``."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    send = torch.stack(x.chunk(n, dim))
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    parts = got.unbind(0)
    return functools.reduce(torch.add, parts[1:], parts[0])


def all_concat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int,
               group) -> torch.Tensor:
    """Chunk i of ``x`` along ``split_dim`` to rank i of ``group``, and the
    chunks this rank receives concatenated along ``cat_dim`` in group-rank
    order (one ``all_to_all_single``; no gradient).  ``x.shape[split_dim]``
    must divide by the group's size; a group of one returns ``x``."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    send = torch.stack(x.chunk(n, split_dim))
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    return torch.cat(got.unbind(0), dim=cat_dim)


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
        ctx.dim, ctx.group = dim, group
        ctx.block = x.detach()
        return all_concat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None

    @staticmethod
    def regather(ctx) -> torch.Tensor:
        """The forward's output, gathered again from the block."""
        return all_concat(ctx.block, ctx.dim, ctx.group)


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
