"""Decoder-only transformer LM, families "dense", "moe" and "vlm": GPT-2's
LayerNorm, learned positions and tied GELU MLP, and the RMSNorm, RoPE,
SwiGLU / ReLU^2, qk-norm, QKV-bias, GQA and untied-head decoders, with an
MoE block in place of the MLP where the config has one.  The vlm family's
stub frontend hands the model its embeddings (``embeds``, (B, F, D)),
which go before the text tokens' embeddings; the loss is over the text.

Block parameters are stacked ``(L, ...)`` leaves, as in the JAX package,
so the optimizer sees the same ``(L, m, n)`` matrices (``(L, E, m, n)``
for the experts); the forward walks the layers with a Python loop over
``layers.unstack``'s views of the stack, each layer's body under
``cfg.remat`` (``layers.remat``), as the JAX package's scan body.  The
model holds no parameters itself: ``init`` returns a nested dict of fp32
master tensors and ``forward`` / ``loss`` take it, mirroring the JAX API
(``repro_torch.convert`` loads the JAX package's parameters into it).
Serving (caches, prefill, decode) is not ported yet (``TrainOnly``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.base import TrainOnly

# The loss takes the chunked cross entropy from the hiddens (the (B, S, V)
# logits never exist) for an untied head at vocab * S at least this.
FUSED_XENT_MIN = 2 ** 26


class TransformerLM(TrainOnly, nn.Module):

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.is_moe = cfg.moe is not None

    def init(self, gen: torch.Generator) -> dict:
        """Random fp32 master parameters on ``gen``'s device."""
        cfg = self.cfg
        n, d = cfg.n_layers, cfg.d_model
        dev = gen.device
        ffn = (("moe", MOE.moe_init(gen, cfg, n)) if self.is_moe
               else ("mlp", L.mlp_init(gen, cfg, n, d, cfg.d_ff)))
        params = {"embed": L.embed_init(gen, cfg.vocab, d)}
        if cfg.pos_embedding == "learned":
            params["pos_embed"] = L.embed_init(gen, cfg.max_seq_len, d)
        params["blocks"] = {"attn": A.attn_init(gen, cfg, n), ffn[0]: ffn[1],
                            "norm1": L.make_norm_params(cfg, (n, d), dev),
                            "norm2": L.make_norm_params(cfg, (n, d), dev)}
        params["final_norm"] = L.make_norm_params(cfg, (d,), dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, (d, cfg.vocab), d,
                                             scale=0.02)
        return params

    def _block(self, x: torch.Tensor, bp: dict):
        """One layer: ``(x, aux)``, aux the MoE load-balance loss or None."""
        cfg = self.cfg
        h = L.apply_norm(cfg, bp["norm1"], x)
        x = x + A.attn_apply_full(cfg, bp["attn"], h, causal=True)
        h = L.apply_norm(cfg, bp["norm2"], x)
        if not self.is_moe:
            return x + L.mlp_apply(cfg, bp["mlp"], h), None
        y, aux = MOE.moe_apply_local(cfg, bp["moe"], h)
        return x + y, aux

    def _trunk(self, params: dict, x: torch.Tensor):
        """Every layer, then the final norm: ``(x, aux summed over the
        layers)``."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for bp in L.unstack(params["blocks"], cfg.n_layers):
            x, a = L.remat(cfg.remat, self._block, x, bp)
            if a is not None:
                aux = aux + a
        return L.apply_norm(cfg, params["final_norm"], x), aux

    def forward(self, params: dict, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None):
        """tokens: (B, S_txt) int, embeds: (B, F, D) the stub frontend's
        output or None -> ``(logits (B, F + S_txt, V) in the compute dtype,
        aux)``."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x = params["embed"].to(dt)[tokens]
        if embeds is not None:
            x = torch.cat([embeds.to(dt), x], dim=1)
        if cfg.pos_embedding == "learned":
            x = x + params["pos_embed"].to(dt)[None, :x.shape[1], :]
        x, aux = self._trunk(params, x)
        head = (params["embed"].to(dt).T if cfg.tie_embeddings
                else params["lm_head"].to(dt))
        return x @ head, aux

    def _hidden(self, params: dict, tokens: torch.Tensor):
        """Forward up to the final norm (no LM head), as the JAX package's
        ``_hidden``: it adds no learned positions (no arch combines them
        with an untied head)."""
        dt = getattr(torch, self.cfg.dtype)
        return self._trunk(params, params["embed"].to(dt)[tokens])

    def loss(self, params: dict, batch: dict):
        """Next-token cross entropy over the text tokens plus 0.01 x the
        MoE aux loss; returns ``(total, {"loss": ce, "aux_loss": aux})``, as
        the JAX package.  With ``batch["embeds"]`` the logits of the
        frontend's positions are dropped, and the chunked cross entropy is
        never taken."""
        cfg = self.cfg
        tokens = batch["tokens"]
        embeds = batch.get("embeds")
        if (not cfg.tie_embeddings and embeds is None
                and cfg.vocab * tokens.shape[1] >= FUSED_XENT_MIN):
            x, aux = self._hidden(params, tokens)
            ce = L.fused_xent_from_hidden(x, params["lm_head"], tokens)
        else:
            logits, aux = self.forward(params, tokens, embeds)
            n_front = 0 if embeds is None else embeds.shape[1]
            ce = L.softmax_xent(logits[:, n_front:-1, :], tokens[:, 1:])
        return ce + 0.01 * aux, {"loss": ce, "aux_loss": aux}

