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

On a model axis (the ``tp`` strategy; :meth:`EncDecLM.split_products`)
the encoder's attention, the decoder's self and cross attention and both
MLPs split over ``model`` as the transformer's do (heads, hidden units),
the cross attention through ``attention.cross_attn_split``, and the tied
embedding by vocabulary rows where the axis divides them.  Serving on a
mesh (``distributed.sharding.serving_view``) runs the same on the rank's
parameter blocks and its blocks of the caches: the self-attention cache's
sequence split over ``model``, the cross cache's encoder rows over
``model`` where they divide (decode combined by log-sum-exp over the
rank's rows), else every row on every rank; the logits whole on every
rank.
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

    def split_products(self, split: L.ModelSplit) -> dict:
        """``{path: (dim, lo, hi)}``: the parameters whose products split
        over the model axis under ``split`` (see
        ``TransformerLM.split_products``): the encoder's attention, the
        decoder's self and cross attention (their heads), both MLPs (their
        hidden units) and, where the vocabulary divides by the axis, the
        tied embedding."""
        cfg = self.cfg
        attn, mlp = A.attn_split_ranges(cfg, split), \
            L.mlp_split_ranges(cfg, split)
        out = {}
        for path in ("enc_blocks/attn", "dec_blocks/self_attn",
                     "dec_blocks/cross_attn"):
            out.update({f"{path}/{k}": r for k, r in attn.items()})
        for path in ("enc_blocks/mlp", "dec_blocks/mlp"):
            out.update({f"{path}/{k}": r for k, r in mlp.items()})
        vocab = L.vocab_split_ranges(cfg, split)
        vocab.pop("lm_head", None)          # the head is the tied embed
        out.update(vocab)
        return out

    def _enc_block(self, x: torch.Tensor, bp: dict,
                   use=L.no_gather) -> torch.Tensor:
        cfg = self.cfg
        split = L.model_split(use)
        bp = use(bp, "enc_blocks")
        h = L.apply_norm(cfg, bp["norm1"], x)
        x = x + A.attn_apply_full(cfg, bp["attn"], h, causal=False,
                                  split=split)
        h = L.apply_norm(cfg, bp["norm2"], x)
        return x + L.mlp_apply(cfg, bp["mlp"], h, split)

    def encode(self, params: dict, enc_embeds: torch.Tensor) -> torch.Tensor:
        """enc_embeds: (B, S_enc, D) -> the encoder's output (B, S_enc, D)
        in the compute dtype (whole on every rank of a model group under a
        split)."""
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
        split = L.model_split(use)
        bp = use(bp, "dec_blocks")
        h = L.apply_norm(cfg, bp["norm1"], x)
        x = x + A.attn_apply_full(cfg, bp["self_attn"], h, causal=True,
                                  split=split)
        h = L.apply_norm(cfg, bp["norm_x"], x)
        if split is None:
            x = x + self._cross_attend(bp, h, *self._cross_kv(bp, enc_out))
        else:
            x = x + A.cross_attn_split(cfg, bp["cross_attn"], h, split,
                                       enc=enc_out)[0]
        h = L.apply_norm(cfg, bp["norm2"], x)
        return x + L.mlp_apply(cfg, bp["mlp"], h, split)

    def forward(self, params: dict, tokens: torch.Tensor,
                embeds: torch.Tensor):
        """tokens: (B, S) int, embeds: (B, S_enc, D) the stub frontend's
        output -> ``(logits (B, S, V) in the compute dtype, aux)``, aux 0.
        Under the vocabulary's split the rank's block of the logits."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        use = L.gather_hook()
        vsplit = L.vocab_split(cfg, use)
        enc_out = self.encode(params, embeds)
        s = tokens.shape[1]
        # the tied embedding gathered once for the lookup and the head
        embed = use(params["embed"], "embed").to(dt)
        x = (L.embed_rows(embed, tokens, vsplit)
             + use(params["dec_pos"], "dec_pos").to(dt)[None, :s, :])
        for bp in L.unstack(use(params["dec_blocks"], "dec_blocks",
                                stack=True), cfg.n_layers):
            x = L.remat(L.layer_remat(cfg), self._dec_block, x, enc_out, bp,
                        use)
        x = L.apply_norm(cfg, use(params["dec_norm"], "dec_norm"), x)
        return (L.head_logits(x, embed.T, vsplit),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params: dict, batch: dict):
        """Next-token cross entropy of the decoder; returns ``(loss,
        {"loss": loss})``; under the vocabulary's split reduced over the
        model axis.  ``batch["embeds"]`` is required (KeyError without it,
        as in JAX)."""
        tokens = batch["tokens"]
        logits, _ = self.forward(params, tokens, batch["embeds"])
        ce = L.softmax_xent(logits[:, :-1, :], tokens[:, 1:],
                            L.vocab_split(self.cfg, L.gather_hook()))
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

    def _cross_serve(self, p: dict, h: torch.Tensor, cross: torch.Tensor,
                     enc_out: Optional[torch.Tensor], split):
        """The cross attention of one layer in serving, ``cross`` its (2, B,
        n, KV, dh) block of the cross cache: from ``enc_out`` in the
        prefill (the cache written), else from the cache.  Under ``split``
        the block holds the rank's encoder rows of every kv head where n
        is less than ``enc_seq`` (written by ``A.cross_cache_rows``, read
        by ``A.cross_decode_rows``), else every row (the rank's heads
        attend over its kv heads of them)."""
        cfg = self.cfg
        dt = cross.dtype
        if split is None:
            bp = {"cross_attn": p}
            if enc_out is not None:
                ek, ev = self._cross_kv(bp, enc_out)
                cross[0] = ek.to(dt)
                cross[1] = ev.to(dt)
                return self._cross_attend(bp, h, ek, ev)
            return self._cross_attend(bp, h, cross[0], cross[1])
        n = cross.shape[2]
        if n != cfg.enc_seq and n * split.size != cfg.enc_seq:
            raise ValueError(f"a cross cache block of {n} encoder rows: "
                             f"neither {cfg.enc_seq} nor their share of "
                             f"{split.size} ranks")
        if enc_out is not None:
            out, k, v = A.cross_attn_split(cfg, p, h, split, enc=enc_out)
            rows = A.cross_cache_rows(cfg, p, enc_out, k, v, n, split)
            cross[0] = rows[0].to(dt)
            cross[1] = rows[1].to(dt)
            return out
        if n < cfg.enc_seq:
            return A.cross_decode_rows(cfg, p, h, cross[0], cross[1], split)
        return A.cross_attn_split(cfg, p, h, split,
                                  kv=(cross[0], cross[1]))[0]

    def _serve(self, params: dict, tokens: torch.Tensor, cache: dict,
               pos: int, enc_out: Optional[torch.Tensor]) -> torch.Tensor:
        """The decoder layers against the caches (written in place), the
        prefill for ``enc_out`` given (the prompt's positions ``[0, S)``),
        else one token's decode at ``pos`` (its learned position clamped
        to ``dec_pos``, as JAX's ``dynamic_slice`` clamps it); the
        parameters through the gather hook layer by layer (a decode step
        reads no cross ``wk`` / ``wv``), then ``dec_norm`` and the tied
        head: whole logits (B, 1, V) of the last position."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        use = L.gather_hook()
        split, seq = L.model_split(use), L.cache_seq_split(use)
        vsplit = L.vocab_split(cfg, use)
        embed = use(params["embed"], "embed").to(dt)
        table = use(params["dec_pos"], "dec_pos").to(dt)
        prefill = enc_out is not None
        s = tokens.shape[1]
        where = (table[None, :s, :] if prefill else
                 table[min(max(pos, 0), table.shape[0] - 1)][None, None, :])
        x = L.embed_rows(embed, tokens, vsplit) + where
        kv, cross = cache["kv"], cache["cross"]
        for i, bp in enumerate(L.unstack(use(params["dec_blocks"],
                                             "dec_blocks", stack=True),
                                         cfg.n_layers)):
            cp = bp.pop("cross_attn")
            if not prefill:
                cp = {k: v for k, v in cp.items() if k not in ("wk", "wv")}
            bp = use(bp, "dec_blocks")
            cp = use(cp, "dec_blocks/cross_attn")
            h = L.apply_norm(cfg, bp["norm1"], x)
            c = A.KVCache(kv.k[i], kv.v[i])
            if prefill:
                a_out, _ = A.attn_prefill(cfg, bp["self_attn"], h, c, split,
                                          seq)
            else:
                a_out, _ = A.attn_decode(cfg, bp["self_attn"], h, c, pos,
                                         split, seq)
            x = x + a_out
            h = L.apply_norm(cfg, bp["norm_x"], x)
            x = x + self._cross_serve(cp, h, cross[i], enc_out, split)
            h = L.apply_norm(cfg, bp["norm2"], x)
            x = x + L.mlp_apply(cfg, bp["mlp"], h, split)
        x = L.apply_norm(cfg, use(params["dec_norm"], "dec_norm"), x)
        return L.whole_logits(L.head_logits(x[:, -1:, :], embed.T, vsplit),
                              vsplit)

    @torch.inference_mode()
    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict,
                embeds: Optional[torch.Tensor] = None):
        """Encode ``embeds`` (B, enc_seq, D), then the prompt tokens (B, S)
        through the decoder, filling the self-attention cache and each
        layer's cross K / V.  Returns ``(logits (B, 1, V), cache at pos
        S)``."""
        logits = self._serve(params, tokens, cache, 0,
                             self.encode(params, embeds))
        return logits, {"kv": cache["kv"], "cross": cache["cross"],
                        "pos": tokens.shape[1]}

    @torch.inference_mode()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) at ``cache["pos"]`` -> ``(logits (B, 1, V), cache
        at pos + 1)``."""
        pos = int(cache["pos"])
        return self._serve(params, tokens, cache, pos, None), {
            "kv": cache["kv"], "cross": cache["cross"], "pos": pos + 1}
