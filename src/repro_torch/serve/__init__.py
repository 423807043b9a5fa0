"""repro_torch.serve — batched greedy inference over the model zoo's KV
caches, the port of the JAX package's ``repro.serve``.

Two schedulers share the ``Request`` contract (greedy decode, per-request
``max_new_tokens``, optional EOS):

  ``Engine`` + ``ServeConfig`` (wave; dense cache)
      The lock-step baseline: admit up to ``slots`` requests, prefill as
      one right-aligned batch, decode until the whole wave drains.  Any
      family with ``init_cache`` / ``prefill`` / ``decode_step`` but the
      encoder-decoder, whose prefill needs ``embeds``, which no engine
      passes (as in JAX).

  ``ContinuousEngine`` + ``ContinuousConfig`` (continuous; paged cache)
      Per-slot cache positions, slot recycling the step a row finishes,
      bucketed chunked prefill interleaved with decode, admission gated
      on KV-block occupancy, ``kind="serve"`` telemetry through
      ``repro_torch.telemetry``'s JSONL sink.  Needs a model with
      ``decode_paged``: the dense, moe and vlm families.

  ``kv_cache`` — ``BlockAllocator`` (fixed-size blocks, LIFO free list,
      reservation ledger for admission that never meets exhaustion),
      ``SlotTable`` block tables and ``pool_from_dense``.  The device pool
      comes from ``model.init_paged_cache``; the paged read is bitwise the
      dense cache's at equal logical lengths (models/attention.py).

Launcher: ``python -m repro_torch.launch.serve`` (``--continuous`` /
``--paged`` selects the scheduler; ``--device cpu`` for the CPU).
"""
from repro_torch.serve.engine import (ContinuousConfig, ContinuousEngine,
                                      Engine, Request, ServeConfig)
from repro_torch.serve.kv_cache import (NULL_BLOCK, BlockAllocator,
                                        PoolExhausted, SlotTable,
                                        pool_from_dense)
