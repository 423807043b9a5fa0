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
"auto" past 4096 tokens).

Serving, as the JAX model: per-layer Mamba caches plus one KV cache per
shared-block application point (``n_layers // hybrid_attn_every`` of
them; point ``i // every``), in ``init_cache``; ``prefill`` (the prompt
through ``mamba_apply`` and ``attn_prefill``) and ``decode_step``
(``mamba_decode``, ``attn_decode``) under ``torch.inference_mode``,
writing the caches in place.
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

    def _shared_block(self, sp: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.apply_norm(cfg, sp["norm1"], x)
        x = x + A.attn_apply_full(cfg, sp["attn"], h, causal=True)
        h = L.apply_norm(cfg, sp["norm2"], x)
        return x + L.mlp_apply(cfg, sp["mlp"], h)

    def _layer(self, x: torch.Tensor, lp: dict, sp: Optional[dict],
               use=L.no_gather) -> torch.Tensor:
        """One Mamba2 layer, then the shared block ``sp`` if this layer is
        an application point; on a mesh both are gathered here, the shared
        block at each of its applications, whose gradient blocks autograd
        adds in the backward's order."""
        cfg = self.cfg
        lp = use(lp, "layers")
        sp = None if sp is None else use(sp, "shared")
        x = x + M.mamba_apply(cfg, lp["mamba"],
                              L.apply_norm(cfg, lp["norm"], x))
        return x if sp is None else self._shared_block(sp, x)

    def forward(self, params: dict, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None):
        """tokens: (B, S) int -> ``(logits (B, S, V) in the compute dtype,
        aux)``, aux 0; ``embeds`` is taken and unused, as in the JAX
        package (the hybrid has no frontend)."""
        cfg = self.cfg
        every = cfg.hybrid_attn_every
        dt = getattr(torch, cfg.dtype)
        use = L.gather_hook()
        x = use(params["embed"], "embed").to(dt)[tokens]
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
        return (x @ use(params["lm_head"], "lm_head").to(dt),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params: dict, batch: dict):
        """Next-token cross entropy; returns ``(loss, {"loss": loss})``."""
        tokens = batch["tokens"]
        logits, _ = self.forward(params, tokens)
        ce = L.softmax_xent(logits[:, :-1, :], tokens[:, 1:])
        return ce, {"loss": ce}

    # -- serving -------------------------------------------------------------
    def _serve(self, params: dict, tokens: torch.Tensor, cache: dict,
               pos: int) -> torch.Tensor:
        """Every layer against its caches (written in place), prefill for
        S > 1 and decode at ``pos`` for one token, then the final norm and
        the head: logits (B, S', V), S' 1."""
        cfg = self.cfg
        every = cfg.hybrid_attn_every
        dt = getattr(torch, cfg.dtype)
        x = params["embed"].to(dt)[tokens]
        mc, kv = cache["mamba"], cache["kv"]
        shared = L.unstack(params["shared"], cfg.n_shared_blocks)
        prefill = x.shape[1] > 1
        for i, lp in enumerate(L.unstack(params["layers"], cfg.n_layers)):
            h = L.apply_norm(cfg, lp["norm"], x)
            c = M.MambaCache(mc.conv[i], mc.ssm[i])
            if prefill:
                mo, new = M.mamba_apply(cfg, lp["mamba"], h, c)
            else:
                mo, new = M.mamba_decode(cfg, lp["mamba"], h, c)
            mc.conv[i] = new.conv
            mc.ssm[i] = new.ssm
            x = x + mo
            if i % every != every - 1:
                continue
            app = i // every
            sp = shared[app % cfg.n_shared_blocks]
            c = A.KVCache(kv.k[app], kv.v[app])
            h = L.apply_norm(cfg, sp["norm1"], x)
            if prefill:
                a_out, _ = A.attn_prefill(cfg, sp["attn"], h, c)
            else:
                a_out, _ = A.attn_decode(cfg, sp["attn"], h, c, pos)
            x = x + a_out
            x = x + L.mlp_apply(cfg, sp["mlp"],
                                L.apply_norm(cfg, sp["norm2"], x))
        x = L.apply_norm(cfg, params["final_norm"], x)
        return x[:, -1:, :] @ params["lm_head"].to(dt)

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
