"""Whisper-style encoder-decoder LM, family "encdec" (arXiv:2212.04356),
the training path of the JAX package's ``models/whisper.py``.

The conv / mel frontend is a stub, as there: the batch carries the
frame embeddings (``embeds``, (B, enc_seq, D)).  The encoder adds its
learned positions and runs full (non-causal) self-attention blocks, then
``enc_norm``; the decoder adds its learned positions (``dec_pos``,
``max_seq_len`` rows) to the token embeddings and runs causal
self-attention, cross-attention on the encoder's output (naive
``_sdpa`` with an all-true mask, as in JAX), the MLP, then ``dec_norm``
and the tied head.

Parameters keep the JAX tree (``embed``, ``enc_pos``, ``dec_pos``,
``enc_blocks`` stacked ``(enc_layers, ...)``, ``dec_blocks`` stacked
``(n_layers, ...)``, ``enc_norm``, ``dec_norm``).  Under any ``remat`` but
"none" each encoder and decoder layer is recomputed in the backward, as
the JAX package checkpoints both scan bodies.

Serving, as the JAX model: ``init_cache`` holds a self-attention KV cache
per decoder layer and the cross K / V, ``(L, 2, B, enc_seq, KV, dh)``;
``prefill`` encodes the frames once, fills both and returns the last
position's logits; ``decode_step`` attends to the cached cross K / V.
Both run under ``torch.inference_mode`` and write the caches in place.
``prefill`` needs ``embeds``: without them it stops with the JAX model's
``AttributeError`` (no serving engine passes them, in either package).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L


class EncDecLM(nn.Module):

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family != "encdec" or cfg.enc_layers <= 0:
            raise ValueError(f"EncDecLM needs family 'encdec' and "
                             f"enc_layers > 0, got {cfg.family!r} / "
                             f"{cfg.enc_layers}")
        self.cfg = cfg

    def init(self, gen: torch.Generator) -> dict:
        """Random fp32 master parameters on ``gen``'s device."""
        cfg = self.cfg
        d, dev = cfg.d_model, gen.device
        ne, nd = cfg.enc_layers, cfg.n_layers
        norm = lambda n: L.make_norm_params(cfg, (n, d), dev)
        return {
            "embed": L.embed_init(gen, cfg.vocab, d),
            "enc_pos": L.embed_init(gen, cfg.enc_seq, d),
            "dec_pos": L.embed_init(gen, cfg.max_seq_len, d),
            "enc_blocks": {"norm1": norm(ne),
                           "attn": A.attn_init(gen, cfg, ne),
                           "norm2": norm(ne),
                           "mlp": L.mlp_init(gen, cfg, ne, d, cfg.d_ff)},
            "dec_blocks": {"norm1": norm(nd),
                           "self_attn": A.attn_init(gen, cfg, nd),
                           "norm_x": norm(nd),
                           "cross_attn": A.attn_init(gen, cfg, nd),
                           "norm2": norm(nd),
                           "mlp": L.mlp_init(gen, cfg, nd, d, cfg.d_ff)},
            "enc_norm": L.make_norm_params(cfg, (d,), dev),
            "dec_norm": L.make_norm_params(cfg, (d,), dev),
        }

    def param_specs(self) -> dict:
        """Logical axes of every parameter, the structure of ``init``."""
        cfg = self.cfg
        norm, attn, mlp = L.norm_specs(cfg), A.attn_specs(cfg), \
            L.mlp_specs(cfg)
        return {
            "embed": ("vocab", "embed"),
            "enc_pos": (None, "embed"),
            "dec_pos": (None, "embed"),
            "enc_blocks": L.stacked_specs("layers", {
                "norm1": norm, "attn": attn, "norm2": norm, "mlp": mlp}),
            "dec_blocks": L.stacked_specs("layers", {
                "norm1": norm, "self_attn": attn, "norm_x": norm,
                "cross_attn": attn, "norm2": norm, "mlp": mlp}),
            "enc_norm": norm,
            "dec_norm": norm,
        }

    def _enc_block(self, x: torch.Tensor, bp: dict,
                   use=L.no_gather) -> torch.Tensor:
        cfg = self.cfg
        bp = use(bp, "enc_blocks")
        h = L.apply_norm(cfg, bp["norm1"], x)
        x = x + A.attn_apply_full(cfg, bp["attn"], h, causal=False)
        h = L.apply_norm(cfg, bp["norm2"], x)
        return x + L.mlp_apply(cfg, bp["mlp"], h)

    def encode(self, params: dict, enc_embeds: torch.Tensor) -> torch.Tensor:
        """enc_embeds: (B, S_enc, D) -> the encoder's output (B, S_enc, D)
        in the compute dtype."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        use = L.gather_hook()
        s = enc_embeds.shape[1]
        x = (enc_embeds.to(dt)
             + use(params["enc_pos"], "enc_pos").to(dt)[None, :s, :])
        for bp in L.unstack(use(params["enc_blocks"], "enc_blocks",
                                stack=True), cfg.enc_layers):
            x = L.remat(L.layer_remat(cfg), self._enc_block, x, bp, use)
        return L.apply_norm(cfg, use(params["enc_norm"], "enc_norm"), x)

    def _cross_kv(self, bp: dict, enc_out: torch.Tensor):
        cfg = self.cfg
        b, s, _ = enc_out.shape
        p, dt = bp["cross_attn"], enc_out.dtype
        shape = (b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
        return ((enc_out @ p["wk"].to(dt)).reshape(shape),
                (enc_out @ p["wv"].to(dt)).reshape(shape))

    def _cross_attend(self, bp: dict, h: torch.Tensor, ek: torch.Tensor,
                      ev: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = h.shape
        p, dt = bp["cross_attn"], h.dtype
        q = (h @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads,
                                         cfg.resolved_head_dim)
        mask = torch.ones((1, s, ek.shape[1]), dtype=torch.bool,
                          device=h.device)
        return A._sdpa(cfg, q, ek, ev, mask) @ p["wo"].to(dt)

    def _dec_block(self, x: torch.Tensor, enc_out: torch.Tensor,
                   bp: dict, use=L.no_gather) -> torch.Tensor:
        cfg = self.cfg
        bp = use(bp, "dec_blocks")
        h = L.apply_norm(cfg, bp["norm1"], x)
        x = x + A.attn_apply_full(cfg, bp["self_attn"], h, causal=True)
        h = L.apply_norm(cfg, bp["norm_x"], x)
        x = x + self._cross_attend(bp, h, *self._cross_kv(bp, enc_out))
        h = L.apply_norm(cfg, bp["norm2"], x)
        return x + L.mlp_apply(cfg, bp["mlp"], h)

    def forward(self, params: dict, tokens: torch.Tensor,
                embeds: torch.Tensor):
        """tokens: (B, S) int, embeds: (B, S_enc, D) the stub frontend's
        output -> ``(logits (B, S, V) in the compute dtype, aux)``, aux 0."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        use = L.gather_hook()
        enc_out = self.encode(params, embeds)
        s = tokens.shape[1]
        # the tied embedding gathered once for the lookup and the head
        embed = use(params["embed"], "embed")
        x = (embed.to(dt)[tokens]
             + use(params["dec_pos"], "dec_pos").to(dt)[None, :s, :])
        for bp in L.unstack(use(params["dec_blocks"], "dec_blocks",
                                stack=True), cfg.n_layers):
            x = L.remat(L.layer_remat(cfg), self._dec_block, x, enc_out, bp,
                        use)
        x = L.apply_norm(cfg, use(params["dec_norm"], "dec_norm"), x)
        return (x @ embed.to(dt).T,
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params: dict, batch: dict):
        """Next-token cross entropy of the decoder; returns ``(loss,
        {"loss": loss})``.  ``batch["embeds"]`` is required (KeyError
        without it, as in JAX)."""
        tokens = batch["tokens"]
        logits, _ = self.forward(params, tokens, batch["embeds"])
        ce = L.softmax_xent(logits[:, :-1, :], tokens[:, 1:])
        return ce, {"loss": ce}

    # -- serving -------------------------------------------------------------
    @torch.inference_mode()
    def init_cache(self, batch: int, cache_len: int, device=None) -> dict:
        """``{"kv": KVCache of (L, B, cache_len, KV, dh), "cross": (L, 2, B,
        enc_seq, KV, dh), "pos": 0}``, zeros in the compute dtype."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        cross = torch.zeros((cfg.n_layers, 2, batch, cfg.enc_seq,
                             cfg.n_kv_heads, cfg.resolved_head_dim),
                            dtype=dt, device=device)
        return {"kv": A.init_kv_cache(batch, cache_len, cfg, dt, device,
                                      layers=cfg.n_layers),
                "cross": cross, "pos": 0}

    def _decoder(self, params: dict, x: torch.Tensor, cache: dict,
                 self_attend, cross_kv) -> torch.Tensor:
        """The decoder layers with ``self_attend(p, h, layer cache)`` and
        ``cross_kv(i, bp) -> (k, v)``, then ``dec_norm`` and the tied head
        of the last position."""
        cfg = self.cfg
        kv = cache["kv"]
        for i, bp in enumerate(L.unstack(params["dec_blocks"],
                                         cfg.n_layers)):
            h = L.apply_norm(cfg, bp["norm1"], x)
            x = x + self_attend(bp["self_attn"], h,
                                A.KVCache(kv.k[i], kv.v[i]))[0]
            h = L.apply_norm(cfg, bp["norm_x"], x)
            x = x + self._cross_attend(bp, h, *cross_kv(i, bp))
            h = L.apply_norm(cfg, bp["norm2"], x)
            x = x + L.mlp_apply(cfg, bp["mlp"], h)
        x = L.apply_norm(cfg, params["dec_norm"], x)
        return x[:, -1:, :] @ params["embed"].to(x.dtype).T

    @torch.inference_mode()
    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict,
                embeds: Optional[torch.Tensor] = None):
        """Encode ``embeds`` (B, enc_seq, D), then the prompt tokens (B, S)
        through the decoder, filling the self-attention cache and each
        layer's cross K / V.  Returns ``(logits (B, 1, V), cache at pos
        S)``."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        enc_out = self.encode(params, embeds)
        s = tokens.shape[1]
        x = (params["embed"].to(dt)[tokens]
             + params["dec_pos"].to(dt)[None, :s, :])
        cross = cache["cross"]

        def cross_kv(i, bp):
            ek, ev = self._cross_kv(bp, enc_out)
            cross[i, 0] = ek.to(dt)
            cross[i, 1] = ev.to(dt)
            return ek, ev

        logits = self._decoder(
            params, x, cache, lambda p, h, c: A.attn_prefill(cfg, p, h, c),
            cross_kv)
        return logits, {"kv": cache["kv"], "cross": cross, "pos": s}

    @torch.inference_mode()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) at ``cache["pos"]`` (its learned position clamped
        to ``dec_pos``, as JAX's ``dynamic_slice`` clamps it) -> ``(logits
        (B, 1, V), cache at pos + 1)``."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        pos = int(cache["pos"])
        table = params["dec_pos"].to(dt)
        x = (params["embed"].to(dt)[tokens]
             + table[min(max(pos, 0), table.shape[0] - 1)][None, None, :])
        cross = cache["cross"]
        logits = self._decoder(
            params, x, cache,
            lambda p, h, c: A.attn_decode(cfg, p, h, c, pos),
            lambda i, bp: (cross[i, 0], cross[i, 1]))
        return logits, {"kv": cache["kv"], "cross": cross, "pos": pos + 1}
