"""Batches for the model families, as the JAX package's
``configs/base.py`` builds them: ``make_batch`` draws concrete ones (the
text tokens and, for the vlm and encdec families, the stub frontend's
embeddings, ``embeds``), ``input_specs`` gives a shape cell's inputs as
tensors without storage, the dry run's stand-ins."""
from __future__ import annotations

import torch

from repro_torch.config import CELLS, ModelConfig, ShapeCell


def _token_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens = the sequence length minus the stub frontend's tokens
    (vlm)."""
    if cfg.family == "vlm":
        return seq_len - cfg.frontend_tokens
    return seq_len


def input_specs(cfg: ModelConfig, cell: "ShapeCell | str",
                device: "str | torch.device" = "meta") -> dict:
    """A cell's batch inputs with JAX's shapes, as empty tensors on
    ``device``: ``meta`` (no storage) by default; the dry run passes the
    CPU under a ``FakeTensorMode``, which makes them fake.  Decode cells
    take one token a row (the cache is built apart, by the model's
    ``init_cache``); train and prefill cells ``{"tokens": (B, S_txt)}``
    and, for vlm and encdec, ``"embeds"`` in ``cfg.dtype``.  Tokens are
    int64, the dtype the port's batches carry (``make_batch``), where
    JAX's are int32: the element counts are JAX's, the bytes twice."""
    if isinstance(cell, str):
        cell = CELLS[cell]
    b = cell.global_batch

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    if cell.kind == "decode":
        return {"tokens": empty((b, 1), torch.int64)}
    specs = {"tokens": empty((b, _token_len(cfg, cell.seq_len)),
                             torch.int64)}
    frames = {"vlm": cfg.frontend_tokens, "encdec": cfg.enc_seq}
    if cfg.family in frames:
        specs["embeds"] = empty((b, frames[cfg.family], cfg.d_model),
                                getattr(torch, cfg.dtype))
    return specs


def make_batch(cfg: ModelConfig, batch: int, seq_len: int,
               gen: torch.Generator) -> dict:
    """``{"tokens": (batch, S_txt) int64}`` uniform over the vocab and,
    for vlm, ``"embeds"`` (batch, frontend_tokens, D), for encdec (batch,
    enc_seq, D), standard normal in ``cfg.dtype``; drawn from ``gen``, on
    its device."""
    dev = gen.device
    out = {"tokens": torch.randint(0, cfg.vocab,
                                   (batch, _token_len(cfg, seq_len)),
                                   generator=gen, device=dev)}
    frames = {"vlm": cfg.frontend_tokens, "encdec": cfg.enc_seq}
    if cfg.family in frames:
        out["embeds"] = torch.randn(
            (batch, frames[cfg.family], cfg.d_model), generator=gen,
            device=dev).to(getattr(torch, cfg.dtype))
    return out
