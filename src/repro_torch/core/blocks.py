"""Leaves as blocks on a device mesh: what a transformation needs to update
this rank's block of a split leaf.

On a mesh the train step hands the optimizer each rank's blocks of the
gradients, the parameters and the state (``train/steps.py``), each block
placed by its leaf's spec as in the JAX package.  Elementwise arithmetic
is then local; a reduction that crosses a split axis (a per-matrix RMS, a
row or column mean, a product over the split dimension) takes its local
part and sums it over the ranks that hold the other blocks.  A
:class:`Split` says, for one parameter, which process groups those are,
and the whole shape the block comes from.

The step sets the splits for the duration of the update
(:func:`on_blocks`); a transformation asks :func:`split_of` by the
parameter's path.  Outside it, and for a leaf no mesh axis splits, every
sum is the identity and every mean the plain ``torch.mean``, so an update
off a mesh, or on a mesh of one rank, is the unsharded one bit for bit.
Sums run in group-rank order (``distributed/comm.py``): every rank holding
a block of one matrix gets the same per-matrix scalars.
"""
from __future__ import annotations

import contextlib
import math

import torch

_ACTIVE: list = [None]          # (splits {path: Split}, mesh) or None


class Split:
    """How one parameter of whole shape ``shape`` splits over ``mesh`` by
    ``spec`` (a ``PartitionSpec``); without a mesh, not at all."""

    def __init__(self, shape: tuple, spec=None, mesh=None):
        self.shape = tuple(shape)
        self.mesh = mesh
        self.spec = tuple(spec or ())
        nd = len(self.shape)
        entries = self.spec + (None,) * (nd - len(self.spec))
        self._axes = [() if ax is None else
                      (ax if isinstance(ax, tuple) else (ax,))
                      for ax in entries[:nd]]
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names)
            self._axes = [tuple(a for a in axes
                                if mesh.size(names.index(a)) > 1)
                          for axes in self._axes]

    @property
    def is_split(self) -> bool:
        return any(self._axes)

    def _dims(self, pdims) -> list:
        nd = len(self.shape)
        if pdims is None:
            return list(range(nd))
        if isinstance(pdims, int):
            pdims = (pdims,)
        return sorted({d % nd for d in pdims})

    def axes(self, pdims=None) -> tuple:
        """The mesh axes that split the parameter dims ``pdims`` (all of
        them by default), in dimension order."""
        return tuple(a for d in self._dims(pdims) for a in self._axes[d])

    def count(self, pdims=None) -> int:
        """The whole number of entries over ``pdims``."""
        return math.prod(self.shape[d] for d in self._dims(pdims))

    def psum(self, x: torch.Tensor, pdims=None) -> torch.Tensor:
        """``x``, a local reduction over the block's ``pdims``, summed over
        the ranks holding the other blocks of those dims."""
        from repro_torch.distributed import comm
        for g in comm.axis_groups(self.mesh, self.axes(pdims)) \
                if self.mesh is not None else ():
            x = comm.all_sum(x, g)
        return x

    def pmax(self, x: torch.Tensor, pdims=None) -> torch.Tensor:
        """As :meth:`psum`, with a maximum."""
        from repro_torch.distributed import comm
        for g in comm.axis_groups(self.mesh, self.axes(pdims)) \
                if self.mesh is not None else ():
            x = torch.amax(comm.all_concat(x.unsqueeze(0), 0, g), dim=0)
        return x

    def sum(self, x: torch.Tensor, dim, pdims=None) -> torch.Tensor:
        """``torch.sum(x, dim)`` over the whole leaf: ``dim`` are ``x``'s
        dims, ``pdims`` the parameter dims they stand for (``dim``'s by
        default)."""
        total = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
        return self.psum(total, dim if pdims is None else pdims)

    def mean(self, x: torch.Tensor, dim=None, pdims=None) -> torch.Tensor:
        """``torch.mean(x, dim)`` over the whole leaf (``dim`` None: every
        entry); ``torch.mean`` itself where no split axis is crossed."""
        pd = dim if pdims is None else pdims
        if not self.axes(pd):
            return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
        total = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
        return self.psum(total, pd) / self.count(pd)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """Summed over the ranks holding the other row blocks (dim -2)."""
        return self.psum(x, (-2,))

    def cols(self, x: torch.Tensor) -> torch.Tensor:
        """Summed over the ranks holding the other column blocks (dim -1)."""
        return self.psum(x, (-1,))

    def both(self, x: torch.Tensor) -> torch.Tensor:
        """Summed over the ranks holding the other blocks of a matrix."""
        return self.psum(x, (-2, -1))

    def block(self, whole: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of ``whole`` (every rank has the same) placed
        by ``spec`` on the split's mesh; ``whole`` itself off a mesh."""
        if self.mesh is None:
            return whole
        from repro_torch.distributed.sharding import (NamedSharding,
                                                      local_block)
        from repro_torch.core.types import P
        return local_block(whole, NamedSharding(self.mesh, P(*spec)))

    def dim_spec(self, pdim: int):
        """The spec entry of parameter dim ``pdim``."""
        d = pdim % len(self.shape)
        return self.spec[d] if d < len(self.spec) else None

    def start(self, pdim: int) -> tuple:
        """``(first whole index, length)`` of this rank's block along
        parameter dim ``pdim``."""
        d = pdim % len(self.shape)
        n, i = self.shape[d], 0
        names = tuple(self.mesh.mesh_dim_names) if self.mesh else ()
        for a in self._axes[d]:
            size = self.mesh.size(names.index(a))
            i, n = i * size + self.mesh.get_local_rank(a), n // size
        return i * n, n

    def side(self, whole: torch.Tensor, pdim: int) -> torch.Tensor:
        """This rank's block of a whole ``(*batch, shape[pdim], r)`` tensor
        (a factor, a sketch): the batch dims as the parameter's, the rows
        as its dim ``pdim``."""
        nb = len(self.shape) - 2
        return self.block(whole, tuple(self.dim_spec(d) for d in range(nb))
                          + (self.dim_spec(pdim), None))

    def stacked(self, n: int) -> "Split":
        """The split of ``n`` such leaves stacked on a new leading axis."""
        return Split((n,) + self.shape, (None,) + self.spec
                     + (None,) * (len(self.shape) - len(self.spec)),
                     self.mesh)

    def key(self) -> tuple:
        """What leaves must share to be stacked with this one."""
        return (self.spec if self.is_split else ())


WHOLE = Split(())


@contextlib.contextmanager
def on_blocks(splits: dict, mesh):
    """Run the enclosed updates on blocks: ``splits`` maps each parameter
    path to its :class:`Split` on ``mesh``."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = (splits, mesh)
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def split_of(name: str, like: torch.Tensor) -> Split:
    """The split of parameter ``name`` under :func:`on_blocks`, else the
    whole leaf of ``like``'s shape."""
    active = _ACTIVE[0]
    if active is not None and name in active[0]:
        return active[0][name]
    return Split(tuple(like.shape))


def all_ranks(flag: torch.Tensor) -> torch.Tensor:
    """A bool scalar true on every rank of the mesh iff it is true on
    each (under :func:`on_blocks`; ``flag`` itself otherwise)."""
    active = _ACTIVE[0]
    if active is None:
        return flag
    from repro_torch.distributed import comm
    bad = torch.logical_not(flag).float().reshape(())
    mesh = active[1]
    for g in comm.axis_groups(mesh, tuple(mesh.mesh_dim_names)):
        bad = comm.all_sum(bad, g)
    return bad == 0
