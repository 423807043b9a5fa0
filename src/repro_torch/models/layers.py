"""Building blocks of the dense decoder, as functions on tensors.

Weights keep the JAX package's layout ``(d_in, d_out)`` with ``x @ W``
(not ``nn.Linear``'s ``(out, in)``), so leaf shapes, the factored (m, n)
orientation and the side S-RSI sketches all match the reference.  Master
weights are fp32; compute casts them to the activation dtype, as the JAX
models do with ``.astype(dt)``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

_aten = torch.ops.aten
# jax.checkpoint_policies.checkpoint_dots: keep the matmul outputs
_DOTS = (_aten.mm.default, _aten.bmm.default, _aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(mode: str, fn: Callable, *args):
    """``fn(*args)`` under the JAX package's ``remat`` choice: ``"none"``
    keeps every activation for the backward, ``"full"`` keeps only the
    inputs and recomputes the body in the backward, ``"dots"`` keeps the
    matmul outputs and recomputes the rest."""
    if mode == "none":
        return fn(*args)
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def dense_init(gen: torch.Generator, shape: tuple, d_in: int,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal weights of ``shape`` (trailing dims (d_in, d_out)) with
    std ``1/sqrt(d_in)`` unless ``scale`` is given."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device) * 0.02


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm computed in fp32, returned in ``x``'s dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computed in fp32, returned in ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def make_norm_params(cfg, shape: tuple, device) -> dict:
    """RMSNorm parameters of ``shape`` (leading stack dims, then d): a
    scale of ones."""
    return {"w": torch.ones(shape, device=device)}


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm with ``cfg.norm_eps``; the dense decoder calls
    ``layer_norm`` itself."""
    return rms_norm(x, p["w"], cfg.norm_eps)


def mlp_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP.  ``jax.nn.gelu`` defaults to the tanh approximation, so
    the port uses it too."""
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    if cfg.mlp_bias:
        h = h + p["b_up"].to(dt)
    h = F.gelu(h, approximate="tanh")
    out = h @ p["w_down"].to(dt)
    if cfg.mlp_bias:
        out = out + p["b_down"].to(dt)
    return out


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token-level cross entropy, logits upcast to fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long().unsqueeze(-1))[..., 0]
    return torch.mean(logz - gold)
