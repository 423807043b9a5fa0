"""Concrete batches for the model families, as the JAX package's
``configs/base.py::make_batch`` builds them: the text tokens and, for the
vlm and encdec families, the stub frontend's embeddings (``embeds``).
Its ``input_specs`` (the dry run's allocation-free stand-ins) is not
ported here."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig


def _token_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens = the sequence length minus the stub frontend's tokens
    (vlm)."""
    if cfg.family == "vlm":
        return seq_len - cfg.frontend_tokens
    return seq_len


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
