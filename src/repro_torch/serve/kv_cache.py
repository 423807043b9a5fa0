"""Paged KV cache: fixed-size blocks, a free-list allocator, per-slot
block tables -- the port's copy of the JAX package's
``serve/kv_cache.py``.

The device side is one pool per layer, ``(L, num_blocks, block_size, KV,
dh)``, built by ``model.init_paged_cache`` and shared by every serving
slot.  A sequence owns an ordered list of block ids (its block table) and
grows it as its position advances; on completion the blocks return to the
free list and the next admitted request reuses them, so a prompt costs
``ceil(len / block_size)`` blocks instead of a dense ``cache_len`` row.

Block 0 is the null block and is never handed out: block tables are padded
(and idle decode rows parked) with 0, so padding never aliases a live
sequence's blocks.  Its contents are garbage by design: every read of them
is masked to exactly zero softmax weight (``models/attention.py``).

``BlockAllocator`` also keeps a reservation ledger, so admission can
guarantee a request's worst-case span (prompt + budget) up front while the
blocks are allocated lazily: ``reserve`` at admission, ``alloc`` against
the reservation as the sequence reaches a block, ``release`` the leftover
at completion.  A request admitted so never meets pool exhaustion
mid-decode, and ``occupancy()`` ((allocated + reserved) / usable) is the
admission watermark and the ``kind="serve"`` events' occupancy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

NULL_BLOCK = 0


class PoolExhausted(RuntimeError):
    """Raised when an alloc is attempted past the pool's capacity."""


class BlockAllocator:
    """Host-side free-list allocator over ``num_blocks`` blocks of
    ``block_size`` tokens.  Block 0 (the null block) is never allocated."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: a finished request's blocks are the next ones
        # handed out; ascending ids first
        self._free = list(range(num_blocks - 1, NULL_BLOCK, -1))
        self._reserved = 0

    # -- capacity ----------------------------------------------------------
    @property
    def usable(self) -> int:
        return self.num_blocks - 1

    def free_blocks(self) -> int:
        return len(self._free)

    def available(self) -> int:
        """Blocks neither allocated nor spoken for by a reservation."""
        return len(self._free) - self._reserved

    def occupancy(self) -> float:
        """(allocated + reserved) / usable: the admission watermark."""
        return 1.0 - self.available() / self.usable

    # -- reservations ------------------------------------------------------
    def reserve(self, n: int) -> bool:
        """Earmark ``n`` blocks for a later ``alloc(reserved=True)``.
        Returns False, reserving nothing, when they are not available."""
        if n > self.available():
            return False
        self._reserved += n
        return True

    def release(self, n: int) -> None:
        """Return ``n`` unused reserved blocks to the available set."""
        if n > self._reserved:
            raise ValueError(f"release({n}) exceeds outstanding "
                             f"reservation {self._reserved}")
        self._reserved -= n

    # -- alloc / free ------------------------------------------------------
    def alloc(self, n: int, *, reserved: bool = False) -> list[int]:
        """Pop ``n`` block ids.  ``reserved=True`` draws against an
        earlier ``reserve``; otherwise only unreserved blocks qualify."""
        if reserved:
            if n > self._reserved:
                raise ValueError(f"alloc({n}, reserved=True) exceeds "
                                 f"reservation {self._reserved}")
            self._reserved -= n
        elif n > self.available():
            raise PoolExhausted(f"alloc({n}): only {self.available()} "
                                f"of {self.usable} blocks available")
        return [self._free.pop() for _ in range(n)]

    def free(self, ids: list[int]) -> None:
        for b in ids:
            if not (NULL_BLOCK < b < self.num_blocks):
                raise ValueError(f"free: invalid block id {b}")
            if b in self._free:
                raise ValueError(f"free: double-free of block {b}")
        self._free.extend(ids)

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.block_size)


@dataclasses.dataclass
class SlotTable:
    """One slot's view of the pool: its block ids in logical order."""
    blocks: list[int] = dataclasses.field(default_factory=list)

    def capacity(self, block_size: int) -> int:
        return len(self.blocks) * block_size

    def padded(self, nbt: int) -> np.ndarray:
        """(nbt,) int32 table row, null-padded: what ``prefill_paged`` and
        ``decode_paged`` take."""
        row = np.full((nbt,), NULL_BLOCK, np.int32)
        row[:len(self.blocks)] = self.blocks
        return row


def pool_from_dense(model, dense_cache: dict, tables: list[SlotTable],
                    lengths: list[int], num_blocks: int,
                    block_size: int) -> dict:
    """Adopt a dense cache (``model.init_cache``'s layout, (L, B, S, KV,
    dh)) into a fresh block pool on its device: slot b's first
    ``lengths[b]`` positions are copied into its table's blocks.  Seeds
    the paged and the dense representation identically for the bitwise
    parity checks."""
    dense = dense_cache["kv"]
    pool = model.init_paged_cache(num_blocks, block_size,
                                  device=dense.k.device)
    with torch.inference_mode():
        for name in ("k", "v"):
            src, buf = getattr(dense, name), pool[name]
            for b, (table, n) in enumerate(zip(tables, lengths)):
                for j in range(math.ceil(n / block_size)):
                    lo, hi = j * block_size, min((j + 1) * block_size, n)
                    buf[:, table.blocks[j], :hi - lo] = src[:, b, lo:hi]
    return pool
