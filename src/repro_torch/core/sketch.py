"""Count-min sketch second moment, the embedding backend of the mixed groups.

Port of the JAX package's ``core/sketch.py``.  Each sketched leaf holds
its Adam second moment in a depth x width count-min sketch over its rows:

    update:  S[j, h_j(i), :] <- b2 * S[j, h_j(i), :] + (1 - b2) * G[i, :]^2
    query:   vhat[i, :] = min_j S[j, h_j(i), :] / (1 - b2^t)

with the first moment kept exact.  The query never underestimates the
exact per-row EMA.  A leaf is sketched when it is >= 2-D with at least
``min_rows`` rows; other leaves owned by this transform run exact dense
Adam, bit for bit :func:`repro_torch.core.adamw.scale_by_adam`.

Hashing is universal, ``((a * i + b) mod p) mod width`` with p = 2^31 - 1,
in plain Python and numpy integers, with seeds derived from ``cfg.seed``
and the leaf's position among the transform's leaves, so the bucket
indices equal the JAX package's exactly.  The indices, and for the CUDA
scatter the bucket-sorted row order and offsets, are built once per leaf
and device by the transform and kept beside the state, not in it: the
JAX package holds them as trace-time constants.

The scatter + query goes through ``kernels.ops.sketch_update``: CUDA
kernels on the card, the plain version on the CPU.

:func:`sketch` is the chain

    chain(scale_by_sketch(cfg),
          add_decayed_weights(wd),
          scale_by_schedule(lr),
          scale(-1.0))

With ``telemetry`` the state carries a
``telemetry.snapshot.SketchSnapshot``: per sketched leaf the fraction of
buckets holding mass and the queried mass over the table mass, plain
torch reductions over the table and the query the scatter has just
written (the kernel is unchanged), as the JAX package computes them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.adamw import adam_leaf, bias_corrections
from repro_torch.core.transform import (add_decayed_weights, scale,
                                        scale_by_schedule)
from repro_torch.core.types import (GradientTransformation, P, chain,
                                    find_states)
from repro_torch.kernels import ops
from repro_torch.telemetry.snapshot import (SketchSnapshot,
                                            init_sketch_snapshot,
                                            snapshot_spec)

_PRIME = (1 << 31) - 1          # Mersenne prime for universal hashing
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    lr: "float | Callable" = 1e-3          # used by the sketch() chain only
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0              # used by the sketch() chain only
    depth: int = 4                         # hash functions (min-over-depth)
    width: int = 2048                      # buckets per hash
    min_rows: int = 1024                   # leading-dim threshold to sketch
    seed: int = 0                          # hash-seed derivation root
    telemetry: bool = False                # carry a SketchSnapshot


@dataclasses.dataclass
class SketchLeaf:
    """Sketched second moment of one >= 2-D leaf of shape (rows, *inner).

    table: (depth, width, prod(inner)) f32, the count-min EMA.
    m:     exact first moment, param shape f32; None when b1 = 0.
    seeds: ((a, b), ...) per depth, the universal hash coefficients.
    shape: the param's shape (the table flattens the inner dims away).
    """
    table: torch.Tensor
    m: Optional[torch.Tensor]
    seeds: tuple = dataclasses.field(default=(), metadata=dict(static=True))
    shape: tuple = dataclasses.field(default=(), metadata=dict(static=True))


@dataclasses.dataclass
class SketchDense:
    """Exact dense-Adam fallback for leaves below the sketch threshold; the
    first moment is allocated even at b1 = 0, as in ``scale_by_adam``."""
    m: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class SketchState:
    step: int                         # counts from 0
    leaves: tuple                     # SketchLeaf | SketchDense per param,
                                      # in flatten order
    telemetry: Optional[SketchSnapshot] = None   # cfg.telemetry


def should_sketch(shape, min_rows: int) -> bool:
    """The ``"embeddings"`` predicate: >= 2-D with leading dim >= min_rows."""
    return len(shape) >= 2 and shape[0] >= min_rows


def _leaf_seeds(seed: int, leaf_idx: int, depth: int) -> tuple:
    """Deterministic (a, b) universal-hash pairs per depth, from plain
    Python ints (splitmix-style), as in the JAX package."""
    x = (seed * 0x9E3779B97F4A7C15
         + (leaf_idx + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    out = []
    for _ in range(depth):
        x = (x * 6364136223846793005 + 1442695040888963407) & _MASK64
        a = int((x >> 16) % (_PRIME - 1)) + 1          # a in [1, p)
        x = (x * 6364136223846793005 + 1442695040888963407) & _MASK64
        b = int((x >> 16) % _PRIME)                    # b in [0, p)
        out.append((a, b))
    return tuple(out)


def bucket_indices(n_rows: int, width: int, seeds: tuple) -> np.ndarray:
    """(depth, n_rows) int32 bucket per row per hash, computed with numpy."""
    i = np.arange(n_rows, dtype=np.int64)
    rows = [((a * i + b) % _PRIME) % width for (a, b) in seeds]
    return np.stack(rows).astype(np.int32)


def scale_by_sketch(cfg: SketchConfig) -> GradientTransformation:
    """Bias-corrected Adam direction with a count-min second moment on
    every >= 2-D leaf whose leading dim reaches ``cfg.min_rows``; exact
    dense Adam on the rest.  Learning rate, weight decay and the descent
    sign are later stages (see :func:`sketch`)."""
    # (seeds, rows, width, device) -> (idx, order, offsets), built once
    index: dict = {}

    def buckets(leaf: SketchLeaf, device: torch.device):
        rows, width = leaf.shape[0], leaf.table.shape[1]
        key = (leaf.seeds, rows, width, str(device))
        if key not in index:
            idx = torch.from_numpy(bucket_indices(rows, width,
                                                  leaf.seeds)).to(device)
            index[key] = (idx, *ops.bucket_order(idx, width))
        return index[key]

    def init(params):
        leaves = []
        for i, p in enumerate(params.values()):
            if should_sketch(tuple(p.shape), cfg.min_rows):
                inner = int(np.prod(p.shape[1:]))
                leaf = SketchLeaf(
                    table=torch.zeros((cfg.depth, cfg.width, inner),
                                      dtype=torch.float32, device=p.device),
                    m=(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) if cfg.b1 > 0 else None),
                    seeds=_leaf_seeds(cfg.seed, i, cfg.depth),
                    shape=tuple(p.shape))
                buckets(leaf, p.device)
                leaves.append(leaf)
            else:
                z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                leaves.append(SketchDense(m=z, v=z))
        tel = None
        if cfg.telemetry:
            sidx = tuple(i for i, leaf in enumerate(leaves)
                         if isinstance(leaf, SketchLeaf))
            tel = init_sketch_snapshot(
                len(sidx), leaf_indices=sidx,
                device=next(iter(params.values())).device if params
                else "cpu")
        return SketchState(step=0, leaves=tuple(leaves), telemetry=tel)

    def update(grads, state: SketchState, params):
        del params
        step = state.step + 1
        bc1, bc2 = bias_corrections(cfg.b1, cfg.b2, step)
        dirs, new_leaves, occs, overs = {}, [], [], []
        for (name, g), leaf in zip(grads.items(), state.leaves):
            if isinstance(leaf, SketchLeaf):
                g32 = g.float()
                rows, inner = g.shape[0], leaf.table.shape[-1]
                idx, order, offsets = buckets(leaf, g.device)
                table_new, q = ops.sketch_update(
                    leaf.table, g.reshape(rows, inner), idx, cfg.b2,
                    order=order, offsets=offsets)
                vhat = (q / bc2).reshape(g.shape)
                if leaf.m is not None:
                    m_new = cfg.b1 * leaf.m + (1.0 - cfg.b1) * g32
                    mhat = m_new / bc1
                else:
                    m_new, mhat = None, g32
                dirs[name] = mhat / (torch.sqrt(vhat) + cfg.eps)
                new_leaves.append(dataclasses.replace(
                    leaf, table=table_new, m=m_new))
                if state.telemetry is not None:
                    # occupancy: the share of buckets holding any mass;
                    # overestimate: queried mass over table mass (one
                    # depth row holds it all), >= 1, 1 without collisions
                    hit = torch.amax(table_new, dim=-1) > 0.0
                    occs.append(torch.mean(hit.float()))
                    overs.append(torch.sum(q) / torch.clamp_min(
                        torch.sum(table_new[0]), 1e-30))
            else:
                dirs[name], m, v = adam_leaf(g, leaf.m, leaf.v, cfg.b1,
                                             cfg.b2, cfg.eps, bc1, bc2)
                new_leaves.append(SketchDense(m=m, v=v))
        tel = state.telemetry
        if tel is not None:
            stack = lambda xs: (torch.stack(xs) if xs else torch.zeros(
                (0,), dtype=torch.float32, device=tel.occupancy.device))
            tel = SketchSnapshot(step=step, occupancy=stack(occs),
                                 overestimate=stack(overs),
                                 leaf_indices=tel.leaf_indices)
        return dirs, SketchState(step=step, leaves=tuple(new_leaves),
                                 telemetry=tel)

    def spec(state: SketchState, param_specs: dict):
        leaves = []
        for pspec, leaf in zip(param_specs.values(), state.leaves):
            if isinstance(leaf, SketchLeaf):
                parts = list(pspec)
                parts += [None] * (len(leaf.shape) - len(parts))
                # the hashed row axis is gone from the table; the inner
                # axis keeps param axis 1's spec only when nothing was
                # flattened into it (a 2-D leaf), else it is replicated
                inner = parts[1] if len(leaf.shape) == 2 else None
                leaves.append(SketchLeaf(
                    table=P(None, None, inner),
                    m=P(*parts) if leaf.m is not None else None,
                    seeds=leaf.seeds, shape=leaf.shape))
            else:
                leaves.append(SketchDense(m=pspec, v=pspec))
        return SketchState(step=P(), leaves=tuple(leaves),
                           telemetry=snapshot_spec(state.telemetry))

    return GradientTransformation(init, update, spec)


def sketch(cfg: SketchConfig,
           decay_mask: Optional[Callable] = None) -> GradientTransformation:
    """Sketch-Adam as a chain (see module docstring)."""
    return chain(
        scale_by_sketch(cfg),
        add_decayed_weights(cfg.weight_decay, decay_mask),
        scale_by_schedule(cfg.lr),
        scale(-1.0),
    )


def sketch_state(state) -> SketchState:
    """The ``SketchState`` inside a chain or partition state."""
    for sub in find_states(state, SketchState):
        return sub
    raise ValueError("no SketchState found in optimizer state")
