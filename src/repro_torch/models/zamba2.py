"""Zamba2-style hybrid LM, family "hybrid" (arXiv:2411.15242): a Mamba2
backbone with shared attention + MLP blocks applied after every
``hybrid_attn_every``-th layer, the training path of the JAX package's
``models/zamba2.py``.

The ``n_shared_blocks`` shared blocks are stored once, stacked
``(n_shared_blocks, ...)``, and alternate over the application points:
after layer i when ``i % every == every - 1``, block ``(i // every) %
n_shared_blocks``.  Each application reads its block's parameters as a
view of the stack, so a block's gradient is the sum over its application
points.  As in the JAX package (its simplification of the released
model), the shared block takes the running hidden state, not its concat
with the original embedding.

Parameters keep the JAX tree (``embed``, ``layers.{norm,mamba}.*``
stacked ``(n_layers, ...)``, ``shared.{norm1,attn,norm2,mlp}.*``,
``final_norm``, ``lm_head``), so ``repro_torch.convert`` carries the JAX
parameters across unchanged.  The layers run as a Python loop; under any
``remat`` but "none" each layer's body, its shared block included, is
recomputed in the backward, as the JAX package checkpoints its scan body.
The Mamba2 block is ``models/mamba2.py`` (the SSD block B7), the shared
attention ``models/attention.py`` (B6 under ``attn_impl="chunked"``, or
"auto" past 4096 tokens).  Under the ``tp`` strategy on a model axis
every product splits over it (:meth:`HybridLM.split_products`): the
Mamba2 blocks by SSM heads (``mamba2.mamba_split_ranges``), the shared
block as the transformer's (its heads, the MLP's hidden units) and,
where it divides, the vocabulary.

Serving, as the JAX model: per-layer Mamba caches plus one KV cache per
shared-block application point (``n_layers // hybrid_attn_every`` of
them; point ``i // every``), in ``init_cache``; ``prefill`` (the prompt
through ``mamba_apply`` and ``attn_prefill``) and ``decode_step``
(``mamba_decode``, ``attn_decode``) under ``torch.inference_mode``,
writing the caches in place.  On a mesh (``distributed.sharding.
serving_view``) they run on the rank's parameter blocks and its blocks of
the caches, the KV cache's sequence kept split over ``model`` (over the
dp axes and ``model`` in the ``long_500k`` cells) and decode combined by
log-sum-exp over those ranks, the logits whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M


class HybridLM(nn.Module):

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        every = cfg.hybrid_attn_every
        if (cfg.family != "hybrid" or cfg.ssm is None or every <= 0
                or cfg.n_layers % every):
            raise ValueError(
                f"HybridLM needs family 'hybrid', an SSMSpec and n_layers "
                f"a multiple of hybrid_attn_every > 0, got {cfg.family!r} / "
                f"{cfg.ssm!r} / {cfg.n_layers} % {every}")
        self.cfg = cfg
        self.n_apps = cfg.n_layers // every

    def init(self, gen: torch.Generator) -> dict:
        """Random fp32 master parameters on ``gen``'s device."""
        cfg = self.cfg
        n, nb, d, dev = cfg.n_layers, cfg.n_shared_blocks, cfg.d_model, \
            gen.device
        return {
            "embed": L.embed_init(gen, cfg.vocab, d),
            "layers": {"norm": L.make_norm_params(cfg, (n, d), dev),
                       "mamba": M.mamba_init(gen, cfg, n)},
            "shared": {"norm1": L.make_norm_params(cfg, (nb, d), dev),
                       "attn": A.attn_init(gen, cfg, nb),
                       "norm2": L.make_norm_params(cfg, (nb, d), dev),
                       "mlp": L.mlp_init(gen, cfg, nb, d, cfg.d_ff)},
            "final_norm": L.make_norm_params(cfg, (d,), dev),
            "lm_head": L.dense_init(gen, (d, cfg.vocab), d, scale=0.02),
        }

    def param_specs(self) -> dict:
        """Logical axes of every parameter, the structure of ``init``."""
        cfg = self.cfg
        return {"embed": ("vocab", "embed"),
                "layers": L.stacked_specs("layers", {
                    "norm": L.norm_specs(cfg), "mamba": M.mamba_specs(cfg)}),
                "shared": L.stacked_specs("shared", {
                    "norm1": L.norm_specs(cfg), "attn": A.attn_specs(cfg),
                    "norm2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}),
                "final_norm": L.norm_specs(cfg),
                "lm_head": ("embed", "vocab")}

    def split_products(self, split: L.ModelSplit) -> dict:
        """``{path: (dim, lo, hi)}``: the parameters whose products split
        over the model axis under ``split`` (see
        ``TransformerLM.split_products``): the Mamba2 leaves, the shared
        block's attention and MLP, and the embedding and head where the
        vocabulary divides by the axis."""
        cfg = self.cfg
        out = {f"layers/mamba/{k}": r for k, r in
               M.mamba_split_ranges(cfg, split).items()}
        out.update({f"shared/attn/{k}": r for k, r in
                    A.attn_split_ranges(cfg, split).items()})
        out.update({f"shared/mlp/{k}": r for k, r in
                    L.mlp_split_ranges(cfg, split).items()})
        out.update(L.vocab_split_ranges(cfg, split))
        return out

    def _shared_block(self, sp: dict, x: torch.Tensor,
                      split=None) -> torch.Tensor:
        cfg = self.cfg
        h = L.apply_norm(cfg, sp["norm1"], x)
        x = x + A.attn_apply_full(cfg, sp["attn"], h, causal=True,
                                  split=split)
        h = L.apply_norm(cfg, sp["norm2"], x)
        return x + L.mlp_apply(cfg, sp["mlp"], h, split)

    def _layer(self, x: torch.Tensor, lp: dict, sp: Optional[dict],
               use=L.no_gather) -> torch.Tensor:
        """One Mamba2 layer, then the shared block ``sp`` if this layer is
        an application point; on a mesh both are gathered here, the shared
        block at each of its applications, whose gradient blocks autograd
        adds in the backward's order."""
        cfg = self.cfg
        split = L.model_split(use)
        lp = use(lp, "layers")
        sp = None if sp is None else use(sp, "shared")
        x = x + M.mamba_apply(cfg, lp["mamba"],
                              L.apply_norm(cfg, lp["norm"], x), split=split)
        return x if sp is None else self._shared_block(sp, x, split)

    def forward(self, params: dict, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None):
        """tokens: (B, S) int -> ``(logits (B, S, V) in the compute dtype,
        aux)``, aux 0; ``embeds`` is taken and unused, as in the JAX
        package (the hybrid has no frontend).  Under the vocabulary's
        split the rank's block of the logits."""
        cfg = self.cfg
        every = cfg.hybrid_attn_every
        dt = getattr(torch, cfg.dtype)
        use = L.gather_hook()
        vsplit = L.vocab_split(cfg, use)
        x = L.embed_rows(use(params["embed"], "embed").to(dt), tokens,
                         vsplit)
        layers = L.unstack(use(params["layers"], "layers", stack=True),
                           cfg.n_layers)
        shared = L.unstack(use(params["shared"], "shared", stack=True),
                           cfg.n_shared_blocks)
        mode = L.layer_remat(cfg)
        for i, lp in enumerate(layers):
            sp = (shared[(i // every) % cfg.n_shared_blocks]
                  if i % every == every - 1 else None)
            x = L.remat(mode, self._layer, x, lp, sp, use)
        x = L.apply_norm(cfg, use(params["final_norm"], "final_norm"), x)
        return (L.head_logits(x, use(params["lm_head"], "lm_head"), vsplit),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params: dict, batch: dict):
        """Next-token cross entropy; returns ``(loss, {"loss": loss})``;
        under the vocabulary's split reduced over the model axis."""
        tokens = batch["tokens"]
        logits, _ = self.forward(params, tokens)
        ce = L.softmax_xent(logits[:, :-1, :], tokens[:, 1:],
                            L.vocab_split(self.cfg, L.gather_hook()))
        return ce, {"loss": ce}

    # -- serving -------------------------------------------------------------
    def _serve(self, params: dict, tokens: torch.Tensor, cache: dict,
               pos: int) -> torch.Tensor:
        """Every layer against its caches (written in place), prefill for
        S > 1 and decode at ``pos`` for one token, the parameters through
        the gather hook layer by layer (each shared block at each of its
        application points), then the final norm and the head: whole
        logits (B, 1, V) of the last position."""
        cfg = self.cfg
        every = cfg.hybrid_attn_every
        dt = getattr(torch, cfg.dtype)
        use = L.gather_hook()
        split, seq = L.model_split(use), L.cache_seq_split(use)
        vsplit = L.vocab_split(cfg, use)
        x = L.embed_rows(use(params["embed"], "embed").to(dt), tokens,
                         vsplit)
        mc, kv = cache["mamba"], cache["kv"]
        shared = L.unstack(use(params["shared"], "shared", stack=True),
                           cfg.n_shared_blocks)
        prefill = x.shape[1] > 1
        for i, lp in enumerate(L.unstack(use(params["layers"], "layers",
                                             stack=True), cfg.n_layers)):
            lp = M.serve_params(use, lp, "layers", not prefill)
            h = L.apply_norm(cfg, lp["norm"], x)
            c = M.MambaCache(mc.conv[i], mc.ssm[i])
            if prefill:
                mo, new = M.mamba_apply(cfg, lp["mamba"], h, c, split)
            else:
                mo, new = M.mamba_decode(cfg, lp["mamba"], h, c, split)
            mc.conv[i] = new.conv
            mc.ssm[i] = new.ssm
            x = x + mo
            if i % every != every - 1:
                continue
            app = i // every
            sp = use(shared[app % cfg.n_shared_blocks], "shared")
            c = A.KVCache(kv.k[app], kv.v[app])
            h = L.apply_norm(cfg, sp["norm1"], x)
            if prefill:
                a_out, _ = A.attn_prefill(cfg, sp["attn"], h, c, split, seq)
            else:
                a_out, _ = A.attn_decode(cfg, sp["attn"], h, c, pos, split,
                                         seq)
            x = x + a_out
            x = x + L.mlp_apply(cfg, sp["mlp"],
                                L.apply_norm(cfg, sp["norm2"], x), split)
        x = L.apply_norm(cfg, use(params["final_norm"], "final_norm"), x)
        return L.whole_logits(
            L.head_logits(x[:, -1:, :], use(params["lm_head"], "lm_head"),
                          vsplit), vsplit)

    @torch.inference_mode()
    def init_cache(self, batch: int, cache_len: int, device=None) -> dict:
        """``{"mamba": (L, ...) Mamba caches, "kv": (n_apps, B, cache_len,
        KV, dh) KV caches, "pos": 0}``."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        return {"mamba": M.init_mamba_cache(batch, cfg, dt, device,
                                            layers=cfg.n_layers),
                "kv": A.init_kv_cache(batch, cache_len, cfg, dt, device,
                                      layers=self.n_apps),
                "pos": 0}

    @torch.inference_mode()
    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict):
        """``(logits (B, 1, V) of the last position, cache at pos S)``."""
        logits = self._serve(params, tokens, cache, 0)
        return logits, {"mamba": cache["mamba"], "kv": cache["kv"],
                        "pos": tokens.shape[1]}

    @torch.inference_mode()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> ``(logits (B, 1, V), cache at pos + 1)``."""
        pos = int(cache["pos"])
        return self._serve(params, tokens, cache, pos), {
            "mamba": cache["mamba"], "kv": cache["kv"], "pos": pos + 1}
