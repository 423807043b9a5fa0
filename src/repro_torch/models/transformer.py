"""Decoder-only transformer LM, families "dense" and "moe": GPT-2's
LayerNorm, learned positions and tied GELU MLP, and the RMSNorm, RoPE,
SwiGLU / ReLU^2, qk-norm, QKV-bias, GQA and untied-head decoders, with an
MoE block in place of the MLP where the config has one.

Block parameters are stacked ``(L, ...)`` leaves, as in the JAX package,
so the optimizer sees the same ``(L, m, n)`` matrices (``(L, E, m, n)``
for the experts); the forward walks the layers with a Python loop over
slices of the stack, each layer's body under ``cfg.remat``
(``layers.remat``), as the JAX package's scan body.  The model holds no
parameters itself: ``init`` returns a nested dict of fp32 master tensors
and ``forward`` / ``loss`` take it, mirroring the JAX API
(``repro_torch.convert`` loads the JAX package's parameters into it).
The vlm family's stub frontend (``embeds``) is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

# The loss takes the chunked cross entropy from the hiddens (the (B, S, V)
# logits never exist) for an untied head at vocab * S at least this.
FUSED_XENT_MIN = 2 ** 26


class TransformerLM(nn.Module):

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
        x = x + A.attn_apply_causal(cfg, bp["attn"], h)
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
        for i in range(cfg.n_layers):
            x, a = L.remat(cfg.remat, self._block, x,
                           _slice(params["blocks"], i))
            if a is not None:
                aux = aux + a
        return L.apply_norm(cfg, params["final_norm"], x), aux

    def forward(self, params: dict, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None):
        """tokens: (B, S) int -> ``(logits (B, S, V) in the compute dtype,
        aux)``."""
        _no_embeds(embeds)
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x = params["embed"].to(dt)[tokens]
        if cfg.pos_embedding == "learned":
            x = x + params["pos_embed"].to(dt)[None, :tokens.shape[1], :]
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
        """Next-token cross entropy plus 0.01 x the MoE aux loss; returns
        ``(total, {"loss": ce, "aux_loss": aux})``, as the JAX package."""
        cfg = self.cfg
        tokens = batch["tokens"]
        _no_embeds(batch.get("embeds"))
        if (not cfg.tie_embeddings
                and cfg.vocab * tokens.shape[1] >= FUSED_XENT_MIN):
            x, aux = self._hidden(params, tokens)
            ce = L.fused_xent_from_hidden(x, params["lm_head"], tokens)
        else:
            logits, aux = self.forward(params, tokens)
            ce = L.softmax_xent(logits[:, :-1, :], tokens[:, 1:])
        return ce + 0.01 * aux, {"loss": ce, "aux_loss": aux}


def _no_embeds(embeds) -> None:
    if embeds is not None:
        raise NotImplementedError(
            "TransformerLM: precomputed frontend embeddings (the vlm "
            "family's stub frontend) are not ported to PyTorch yet; see "
            "ROADMAP.md Queue A")


def _slice(tree: dict, i: int) -> dict:
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
