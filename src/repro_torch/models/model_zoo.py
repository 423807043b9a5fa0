"""Model registry: family -> implementation class (``build_model``).
A ``param_dtype`` other than float32 casts the init, so the master
parameters (and their gradients) are kept in that dtype."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.whisper import EncDecLM
from repro_torch.models.zamba2 import HybridLM

_FAMILIES = {
    "dense": TransformerLM,
    "moe": TransformerLM,
    "vlm": TransformerLM,
    "ssm": SSMLM,
    "hybrid": HybridLM,
    "encdec": EncDecLM,
}


def build_model(cfg: ModelConfig, mesh=None):
    """The family's model; ``mesh`` (a ``DeviceMesh``) routes the MoE
    block of the transformer families to its mesh paths, as the JAX
    package's ``build_model(cfg, mesh)``."""
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}; "
                         f"available: {sorted(_FAMILIES)}") from None
    model = cls(cfg, mesh) if cls is TransformerLM else cls(cfg)
    if cfg.param_dtype != "float32":
        # the init is drawn in fp32 and cast once, as in the JAX package
        dt = getattr(torch, cfg.param_dtype)
        inner = model.init
        model.init = lambda gen: _cast(inner(gen), dt)
    return model


def _cast(tree: dict, dt: torch.dtype) -> dict:
    return {k: _cast(v, dt) if isinstance(v, dict) else v.to(dt)
            for k, v in tree.items()}
