"""Pure SSM language model (mamba2-370m), family "ssm": an
attention-free stack of RMSNorm + Mamba2 blocks, as the JAX package's
``models/ssm_lm.py``.

Parameters keep the JAX tree (``embed``, ``layers.{norm,mamba}.*`` stacked
``(L, ...)``, ``final_norm``, ``lm_head``), so ``repro_torch.convert``
carries the JAX parameters across unchanged; the forward walks the layers
with a Python loop over ``layers.unstack``'s views of the stack, as
``TransformerLM`` does.
The caches, prefill and decode belong to serving and are not ported yet
(ROADMAP.md Queue A, serving).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.base import TrainOnly


class SSMLM(TrainOnly, nn.Module):

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family != "ssm" or cfg.ssm is None or cfg.norm != "rmsnorm":
            raise ValueError(f"SSMLM needs family 'ssm', an SSMSpec and "
                             f"RMSNorm, got {cfg.family!r} / {cfg.ssm!r} / "
                             f"{cfg.norm!r}")
        self.cfg = cfg

    def init(self, gen: torch.Generator) -> dict:
        """Random fp32 master parameters on ``gen``'s device."""
        cfg = self.cfg
        n, d, dev = cfg.n_layers, cfg.d_model, gen.device
        return {
            "embed": L.embed_init(gen, cfg.vocab, d),
            "layers": {"norm": L.make_norm_params(cfg, (n, d), dev),
                       "mamba": M.mamba_init(gen, cfg, n)},
            "final_norm": L.make_norm_params(cfg, (d,), dev),
            "lm_head": L.dense_init(gen, (d, cfg.vocab), d, scale=0.02),
        }

    def _block(self, x: torch.Tensor, lp: dict) -> torch.Tensor:
        return x + M.mamba_apply(self.cfg, lp["mamba"],
                                 L.apply_norm(self.cfg, lp["norm"], x))

    def forward(self, params: dict, tokens: torch.Tensor):
        """tokens: (B, S) int -> ``(logits (B, S, V) in the compute dtype,
        aux)``, aux 0 (the JAX package's model API)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x = params["embed"].to(dt)[tokens]
        mode = L.layer_remat(cfg)
        for lp in L.unstack(params["layers"], cfg.n_layers):
            x = L.remat(mode, self._block, x, lp)
        x = L.apply_norm(cfg, params["final_norm"], x)
        return (x @ params["lm_head"].to(dt),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params: dict, batch: dict):
        """Next-token cross entropy; returns ``(loss, {"loss": loss})``."""
        tokens = batch["tokens"]
        logits, _ = self.forward(params, tokens)
        ce = L.softmax_xent(logits[:, :-1, :], tokens[:, 1:])
        return ce, {"loss": ce}
