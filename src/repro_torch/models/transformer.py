"""Decoder-only transformer LM, family "dense", GPT-2 flavour.

Block parameters are stacked ``(L, ...)`` leaves, as in the JAX package,
so the optimizer sees the same ``(L, m, n)`` matrices; the forward walks
the layers with a Python loop over slices of the stack, each layer's body
under ``cfg.remat`` (``layers.remat``), as the JAX package's scan body.  The model holds
no parameters itself: ``init`` returns a nested dict of fp32 master
tensors and ``forward`` / ``loss`` take it, mirroring the JAX API
(``repro_torch.convert`` loads the JAX package's parameters into it).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

# What the port's TransformerLM implements: GPT-2's choices.
_SUPPORTED = dict(family="dense", act="gelu", norm="layernorm",
                  pos_embedding="learned", tie_embeddings=True,
                  qk_norm=False, qkv_bias=False)


class TransformerLM(nn.Module):

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        for field, want in _SUPPORTED.items():
            if getattr(cfg, field) != want:
                raise NotImplementedError(
                    f"TransformerLM: {field}={getattr(cfg, field)!r} is not "
                    f"ported to PyTorch yet (the port has {field}={want!r});"
                    f" see ROADMAP.md Queue A")
        self.cfg = cfg

    def init(self, gen: torch.Generator) -> dict:
        """Random fp32 master parameters on ``gen``'s device."""
        cfg = self.cfg
        n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
        dev = gen.device
        ones = lambda *s: torch.ones(s, device=dev)
        zeros = lambda *s: torch.zeros(s, device=dev)
        mlp = {"w_up": L.dense_init(gen, (n, d, f), d),
               "w_down": L.dense_init(gen, (n, f, d), f)}
        if cfg.mlp_bias:
            mlp.update(b_up=zeros(n, f), b_down=zeros(n, d))
        return {
            "embed": L.embed_init(gen, cfg.vocab, d),
            "pos_embed": L.embed_init(gen, cfg.max_seq_len, d),
            "blocks": {"attn": A.attn_init(gen, cfg, n), "mlp": mlp,
                       "norm1": {"w": ones(n, d), "b": zeros(n, d)},
                       "norm2": {"w": ones(n, d), "b": zeros(n, d)}},
            "final_norm": {"w": ones(d), "b": zeros(d)},
        }

    def _block(self, x: torch.Tensor, bp: dict) -> torch.Tensor:
        cfg = self.cfg
        h = L.layer_norm(x, bp["norm1"]["w"], bp["norm1"]["b"], cfg.norm_eps)
        x = x + A.attn_apply_causal(cfg, bp["attn"], h)
        h = L.layer_norm(x, bp["norm2"]["w"], bp["norm2"]["b"], cfg.norm_eps)
        return x + L.mlp_apply(cfg, bp["mlp"], h)

    def forward(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int -> logits (B, S, V) in the compute dtype."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x = params["embed"].to(dt)[tokens]
        x = x + params["pos_embed"].to(dt)[None, :tokens.shape[1], :]
        for i in range(cfg.n_layers):
            x = L.remat(cfg.remat, self._block, x,
                        _slice(params["blocks"], i))
        fn = params["final_norm"]
        x = L.layer_norm(x, fn["w"], fn["b"], cfg.norm_eps)
        return x @ params["embed"].to(dt).T

    def loss(self, params: dict, batch: dict):
        """Next-token cross entropy; returns ``(loss, {"loss": loss})``."""
        tokens = batch["tokens"]
        logits = self.forward(params, tokens)
        ce = L.softmax_xent(logits[:, :-1, :], tokens[:, 1:])
        return ce, {"loss": ce}


def _slice(tree: dict, i: int) -> dict:
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
