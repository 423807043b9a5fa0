"""Model registry: family -> implementation class (``build_model``)."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.models.transformer import TransformerLM

_FAMILIES = {"dense": TransformerLM, "ssm": SSMLM}


def build_model(cfg: ModelConfig):
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported to PyTorch yet; the "
            f"port has {sorted(_FAMILIES)} (see ROADMAP.md Queue A)") from None
    if cfg.param_dtype != "float32":
        raise NotImplementedError("the port keeps fp32 master parameters")
    return cls(cfg)
