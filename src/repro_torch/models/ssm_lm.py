"""Pure SSM language model (mamba2-370m), family "ssm": an
attention-free stack of RMSNorm + Mamba2 blocks, as the JAX package's
``models/ssm_lm.py``.

Parameters keep the JAX tree (``embed``, ``layers.{norm,mamba}.*`` stacked
``(L, ...)``, ``final_norm``, ``lm_head``), so ``repro_torch.convert``
carries the JAX parameters across unchanged; the forward walks the layers
with a Python loop over ``layers.unstack``'s views of the stack, each
gathered at use on a mesh, as ``TransformerLM`` does.  Under the ``tp``
strategy on a model axis (the hook's ``layers.ModelSplit``) the Mamba2
blocks run on each rank's heads (:meth:`SSMLM.split_products`,
``mamba2.mamba_split_ranges``) and, where the vocabulary divides by the
axis, the lookup, the logits and the cross entropy on its rows.

Serving, as the JAX model: one ``MambaCache`` per layer, stacked
(``init_cache``); ``prefill`` and ``decode_step`` run a length-1 input
through ``mamba_decode`` and a longer one through ``mamba_apply`` with the
cache, each under ``torch.inference_mode``, and write the new caches into
the stacks in place.  On a mesh (``distributed.sharding.serving_view``)
the layers pass the gather hook one by one, the blocks run on the rank's
heads and its block of the Mamba states, and the logits are whole on
every rank.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M


class SSMLM(nn.Module):

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

    def param_specs(self) -> dict:
        """Logical axes of every parameter, the structure of ``init``."""
        cfg = self.cfg
        return {"embed": ("vocab", "embed"),
                "layers": L.stacked_specs("layers", {
                    "norm": L.norm_specs(cfg), "mamba": M.mamba_specs(cfg)}),
                "final_norm": L.norm_specs(cfg),
                "lm_head": ("embed", "vocab")}

    def split_products(self, split: L.ModelSplit) -> dict:
        """``{path: (dim, lo, hi)}``: the parameters whose products split
        over the model axis under ``split`` (see
        ``TransformerLM.split_products``): every Mamba2 leaf
        (``mamba2.mamba_split_ranges``), and the embedding and head where
        the vocabulary divides by the axis."""
        out = {f"layers/mamba/{k}": r for k, r in
               M.mamba_split_ranges(self.cfg, split).items()}
        out.update(L.vocab_split_ranges(self.cfg, split))
        return out

    def _block(self, x: torch.Tensor, lp: dict,
               use=L.no_gather) -> torch.Tensor:
        lp = use(lp, "layers")
        return x + M.mamba_apply(self.cfg, lp["mamba"],
                                 L.apply_norm(self.cfg, lp["norm"], x),
                                 split=L.model_split(use))

    def forward(self, params: dict, tokens: torch.Tensor):
        """tokens: (B, S) int -> ``(logits (B, S, V) in the compute dtype,
        aux)``, aux 0 (the JAX package's model API); under the
        vocabulary's split the rank's block of the logits."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        use = L.gather_hook()
        vsplit = L.vocab_split(cfg, use)
        x = L.embed_rows(use(params["embed"], "embed").to(dt), tokens,
                         vsplit)
        mode = L.layer_remat(cfg)
        for lp in L.unstack(use(params["layers"], "layers", stack=True),
                            cfg.n_layers):
            x = L.remat(mode, self._block, x, lp, use)
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
    def _serve(self, params: dict, tokens: torch.Tensor, cache: dict):
        """Every layer against its cache (written in place), the layers'
        parameters through the gather hook one by one, then the final
        norm and the head: whole logits (B, 1, V) of the last
        position."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        use = L.gather_hook()
        split = L.model_split(use)
        vsplit = L.vocab_split(cfg, use)
        x = L.embed_rows(use(params["embed"], "embed").to(dt), tokens,
                         vsplit)
        mc = cache["mamba"]
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
        x = L.apply_norm(cfg, use(params["final_norm"], "final_norm"), x)
        return L.whole_logits(
            L.head_logits(x[:, -1:, :], use(params["lm_head"], "lm_head"),
                          vsplit), vsplit)

    @torch.inference_mode()
    def init_cache(self, batch: int, cache_len: int, device=None) -> dict:
        """``{"mamba": MambaCache of (L, ...) stacks, "pos": 0}``; the
        state does not grow with ``cache_len``."""
        cfg = self.cfg
        return {"mamba": M.init_mamba_cache(batch, cfg,
                                            getattr(torch, cfg.dtype),
                                            device, layers=cfg.n_layers),
                "pos": 0}

    @torch.inference_mode()
    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict):
        """``(logits (B, 1, V) of the last position, cache at pos S)``."""
        return self._serve(params, tokens, cache), {
            "mamba": cache["mamba"], "pos": tokens.shape[1]}

    @torch.inference_mode()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> ``(logits (B, 1, V), cache at pos + 1)``."""
        return self._serve(params, tokens, cache), {
            "mamba": cache["mamba"], "pos": int(cache["pos"]) + 1}
