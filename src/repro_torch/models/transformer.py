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
``cfg.remat`` (``layers.remat``), as the JAX package's scan body, which
gathers the layer's parameters at use on a mesh (``layers.gather_hook``;
the leaves outside the layers where they are used, a tied embedding once
for both its uses).  Under the ``tp`` strategy the hook carries a
``layers.ModelSplit`` and the products split over ``model``
(:meth:`TransformerLM.split_products`): the heads, the MLP's hidden
units and, where the vocabulary divides, the vocabulary (the lookup, the
logits and the cross entropy); the MoE block keeps its expert-parallel
mesh path.  The
model holds no parameters itself: ``init`` returns a nested dict of fp32
master tensors and ``forward`` / ``loss`` take it, mirroring the JAX API
(``repro_torch.convert`` loads the JAX package's parameters into it).

Serving, as the JAX model: a dense KV cache per layer (``init_cache``,
``prefill`` with the vlm family's ``embeds``, ``decode_step`` at the
cache's position; on a mesh, under ``distributed.sharding.serving_view``,
each on the rank's parameter blocks and its block of the cache, the
heads, MLP and vocabulary split over ``model`` as in training and the
cache's sequence split over it too, the logits whole on every rank) and
a paged block pool shared by the serving slots, without a mesh
(``init_paged_cache``, ``prefill_paged`` one chunk of one slot,
``decode_paged`` every slot at its own position; ``serve/``).  Each runs
under ``torch.inference_mode`` and writes the cache in place.  Learned
positions past the table clamp to its last row, as JAX's gathers do.
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


def _pos_rows(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``table[positions]`` with the indices clamped to the table, as the
    JAX package's gathers and ``dynamic_slice`` clamp them."""
    return table[torch.clamp(positions, 0, table.shape[0] - 1)]


def _no_split() -> None:
    """The paged cache serves without a mesh, as the JAX package's
    engines do."""
    if L.model_split(L.gather_hook()) is not None:
        raise ValueError("the paged cache runs without a model split")


class TransformerLM(nn.Module):

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.is_moe = cfg.moe is not None
        # a DeviceMesh routes the MoE block to its mesh paths ("train":
        # moe_apply_sharded, "decode": moe_apply_ep_tp), as in JAX
        self.mesh = mesh
        self.moe_mode = "train"

    @staticmethod
    def constrain(x: torch.Tensor) -> torch.Tensor:
        """The activation-placement hook the launcher sets under a mesh
        (``distributed.sharding.make_act_constrainer``), applied to the
        residual stream after each attention and each layer, as in JAX."""
        return x

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

    def param_specs(self) -> dict:
        """Logical axes of every parameter, the structure of ``init``."""
        cfg = self.cfg
        block = {"norm1": L.norm_specs(cfg), "attn": A.attn_specs(cfg),
                 "norm2": L.norm_specs(cfg)}
        if self.is_moe:
            block["moe"] = MOE.moe_specs(cfg)
        else:
            block["mlp"] = L.mlp_specs(cfg)
        specs = {"embed": ("vocab", "embed"),
                 "blocks": L.stacked_specs("layers", block),
                 "final_norm": L.norm_specs(cfg)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = ("embed", "vocab")
        if cfg.pos_embedding == "learned":
            specs["pos_embed"] = (None, "embed")
        return specs

    def mesh_local_leaves(self) -> tuple:
        """The parameters the forward takes as this rank's blocks under its
        mesh (the expert stacks of the MoE mesh paths); every other
        parameter it takes whole."""
        if self.mesh is None or not self.is_moe or self.cfg.moe.impl != "sort":
            return ()
        return tuple(f"blocks/moe/{w}" for w in ("w_gate", "w_up", "w_down"))

    def split_products(self, split: L.ModelSplit) -> dict:
        """``{path: (dim, lo, hi)}``: the parameters whose products split
        over the model axis under ``split``, and the range of dimension
        ``dim`` rank ``split.rank`` uses (``dim`` None: the leaf whole, its
        gradient a part on each rank).  The train step gathers these over
        the dp axes only where the stored block is that range, else whole
        (``distributed.sharding.GatherAtUse``); the embedding and an
        untied head only where the vocabulary divides by the axis."""
        cfg = self.cfg
        out = {f"blocks/attn/{k}": r
               for k, r in A.attn_split_ranges(cfg, split).items()}
        if not self.is_moe:
            out.update({f"blocks/mlp/{k}": r for k, r in
                        L.mlp_split_ranges(cfg, split).items()})
        vocab = L.vocab_split_ranges(cfg, split)
        if cfg.tie_embeddings:
            vocab.pop("lm_head", None)
        out.update(vocab)
        return out

    def _moe_or_mlp(self, bp: dict, h: torch.Tensor, split=None):
        """``(y, aux)``, aux the MoE load-balance loss or None."""
        cfg = self.cfg
        if not self.is_moe:
            return L.mlp_apply(cfg, bp["mlp"], h, split), None
        if self.mesh is not None and cfg.moe.impl == "sort":
            names = self.mesh.mesh_dim_names or ()
            dp = tuple(a for a in ("pod", "data") if a in names)
            if self.moe_mode == "decode":
                return MOE.moe_apply_ep_tp(cfg, bp["moe"], h, self.mesh,
                                           batch_axes=dp)
            gather = tuple(a for a in ("data",) if a in names)
            return MOE.moe_apply_sharded(cfg, bp["moe"], h, self.mesh,
                                         dp_axes=dp, gather_axes=gather)
        return MOE.moe_apply_local(cfg, bp["moe"], h)

    def _block(self, x: torch.Tensor, bp: dict, use=L.no_gather):
        """One layer: ``(x, aux)``."""
        cfg = self.cfg
        split = L.model_split(use)
        bp = use(bp, "blocks")
        h = L.apply_norm(cfg, bp["norm1"], x)
        x = self.constrain(
            x + A.attn_apply_full(cfg, bp["attn"], h, causal=True,
                                  split=split))
        y, aux = self._moe_or_mlp(bp, L.apply_norm(cfg, bp["norm2"], x),
                                  split)
        return self.constrain(x + y), aux

    def _lm_head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The logits; under the vocabulary's split this rank's block of
        them, ``x`` entering through ``copy_to``."""
        use = L.gather_hook()
        split = L.vocab_split(self.cfg, use)
        if self.cfg.tie_embeddings:
            return L.head_logits(x, use(params["embed"], "embed").T, split)
        return L.head_logits(x, use(params["lm_head"], "lm_head"), split)

    def _tied(self, params: dict) -> dict:
        """``params`` with a tied embedding gathered once for both of its
        uses (the lookup and the head), so that its gradient is summed
        over the ranks once."""
        if not self.cfg.tie_embeddings:
            return params
        return dict(params, embed=L.gather_hook()(params["embed"], "embed"))

    def _trunk(self, params: dict, x: torch.Tensor):
        """Every layer, then the final norm: ``(x, aux summed over the
        layers)``."""
        cfg = self.cfg
        use = L.gather_hook()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for bp in L.unstack(use(params["blocks"], "blocks", stack=True),
                            cfg.n_layers):
            x, a = L.remat(cfg.remat, self._block, x, bp, use)
            if a is not None:
                aux = aux + a
        return L.apply_norm(cfg, use(params["final_norm"], "final_norm"),
                            x), aux

    def forward(self, params: dict, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None):
        """tokens: (B, S_txt) int, embeds: (B, F, D) the stub frontend's
        output or None -> ``(logits (B, F + S_txt, V) in the compute dtype,
        aux)``."""
        params = self._tied(params)
        x, aux = self._trunk(params, self._embed(params, tokens,
                                                 embeds=embeds))
        return self._lm_head(params, x), aux

    def _hidden(self, params: dict, tokens: torch.Tensor):
        """Forward up to the final norm (no LM head), as the JAX package's
        ``_hidden``: it adds no learned positions (no arch combines them
        with an untied head)."""
        dt = getattr(torch, self.cfg.dtype)
        use = L.gather_hook()
        return self._trunk(params, L.embed_rows(
            use(params["embed"], "embed").to(dt), tokens,
            L.vocab_split(self.cfg, use)))

    def loss(self, params: dict, batch: dict):
        """Next-token cross entropy over the text tokens plus 0.01 x the
        MoE aux loss; returns ``(total, {"loss": ce, "aux_loss": aux})``, as
        the JAX package.  With ``batch["embeds"]`` the logits of the
        frontend's positions are dropped, and the chunked cross entropy is
        never taken.  Under the vocabulary's split the cross entropy
        reduces over the model axis and is the same on every rank."""
        cfg = self.cfg
        tokens = batch["tokens"]
        embeds = batch.get("embeds")
        use = L.gather_hook()
        split = L.vocab_split(self.cfg, use)
        if (not cfg.tie_embeddings and embeds is None
                and cfg.vocab * tokens.shape[1] >= FUSED_XENT_MIN):
            x, aux = self._hidden(params, tokens)
            ce = L.fused_xent_from_hidden(
                x, use(params["lm_head"], "lm_head"), tokens, split=split)
        else:
            logits, aux = self.forward(params, tokens, embeds)
            n_front = 0 if embeds is None else embeds.shape[1]
            ce = L.softmax_xent(logits[:, n_front:-1, :], tokens[:, 1:],
                                split)
        return ce + 0.01 * aux, {"loss": ce, "aux_loss": aux}


    # -- serving -------------------------------------------------------------
    def _serve_layers(self, params: dict, x: torch.Tensor, caches, attend):
        """Every layer with ``attend(attn params, h, layer cache, split) ->
        (out, ...)`` in place of full attention, then the final norm.
        ``caches`` is a list of per-layer caches (views of the stacks).
        The parameters pass the gather hook layer by layer, as in
        ``_trunk``; under a serving split (``sharding.serving_view``) the
        MLP and the attention run on the rank's blocks."""
        cfg = self.cfg
        use = L.gather_hook()
        split = L.model_split(use)
        layers = L.unstack(use(params["blocks"], "blocks", stack=True),
                           cfg.n_layers)
        for bp, cache in zip(layers, caches):
            bp = use(bp, "blocks")
            h = L.apply_norm(cfg, bp["norm1"], x)
            x = x + attend(bp["attn"], h, cache, split)[0]
            y, _ = self._moe_or_mlp(bp, L.apply_norm(cfg, bp["norm2"], x),
                                    split)
            x = x + y
        return L.apply_norm(cfg, use(params["final_norm"], "final_norm"), x)

    def _whole_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The serving paths' logits: every rank's vocabulary block
        concatenated over the model axis under the vocabulary's split, so
        each rank returns the whole (B, S, V)."""
        return L.whole_logits(self._lm_head(params, x),
                              L.vocab_split(self.cfg, L.gather_hook()))

    def _embed(self, params: dict, tokens: torch.Tensor, positions=None,
               embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings (after ``embeds``), plus the learned positions
        at ``positions`` (default 0 .. S - 1)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        use = L.gather_hook()
        x = L.embed_rows(use(params["embed"], "embed").to(dt), tokens,
                         L.vocab_split(self.cfg, use))
        if embeds is not None:
            x = torch.cat([embeds.to(dt), x], dim=1)
        if cfg.pos_embedding == "learned":
            pos = use(params["pos_embed"], "pos_embed").to(dt)
            if positions is None:
                x = x + pos[None, :x.shape[1], :]
            else:
                x = x + _pos_rows(pos, positions)
        return x

    @torch.inference_mode()
    def init_cache(self, batch: int, cache_len: int, device=None) -> dict:
        """``{"kv": KVCache of (L, B, cache_len, KV, dh) zeros in the
        compute dtype, "pos": 0}``."""
        cfg = self.cfg
        return {"kv": A.init_kv_cache(batch, cache_len, cfg,
                                      getattr(torch, cfg.dtype), device,
                                      layers=cfg.n_layers),
                "pos": 0}

    @torch.inference_mode()
    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict,
                embeds: Optional[torch.Tensor] = None):
        """The prompt (``embeds`` (B, F, D) before ``tokens`` (B, S)) into
        the cache; returns ``(logits (B, 1, V) of the last position,
        cache at pos F + S)``."""
        cfg = self.cfg
        x = self._embed(params, tokens, embeds=embeds)
        kv = cache["kv"]
        caches = [A.KVCache(k, v) for k, v in zip(kv.k, kv.v)]
        seq = L.cache_seq_split(L.gather_hook())
        x = self._serve_layers(
            params, x, caches,
            lambda p, h, c, split: A.attn_prefill(cfg, p, h, c, split, seq))
        return (self._whole_logits(params, x[:, -1:, :]),
                {"kv": kv, "pos": x.shape[1]})

    @torch.inference_mode()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1): one step at ``cache["pos"]``; returns ``(logits
        (B, 1, V), cache at pos + 1)``."""
        cfg = self.cfg
        pos = int(cache["pos"])
        x = self._embed(params, tokens, positions=torch.full(
            (1, 1), pos, device=tokens.device))
        kv = cache["kv"]
        caches = [A.KVCache(k, v) for k, v in zip(kv.k, kv.v)]
        seq = L.cache_seq_split(L.gather_hook())
        x = self._serve_layers(
            params, x, caches,
            lambda p, h, c, split: A.attn_decode(cfg, p, h, c, pos, split,
                                                 seq))
        return self._whole_logits(params, x), {"kv": kv, "pos": pos + 1}

    # -- paged serving (block-table KV cache; see serve/kv_cache.py) --------
    @torch.inference_mode()
    def init_paged_cache(self, num_blocks: int, block_size: int,
                         device=None) -> dict:
        """The block pool every slot shares: ``{"k", "v"}`` zeros of (L,
        num_blocks, block_size, KV, dh).  Block tables and positions are
        the engine's, passed per call."""
        cfg = self.cfg
        shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        dt = getattr(torch, cfg.dtype)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    @torch.inference_mode()
    def prefill_paged(self, params: dict, pool: dict, tokens: torch.Tensor,
                      block_table: torch.Tensor, p0: int, last_idx: int):
        """One prompt chunk of one slot: tokens (1, C) at positions p0 ..
        p0 + C - 1, block_table (nbt,); returns ``(logits (1, 1, V) at
        chunk index last_idx (the last real prompt token), pool)``."""
        cfg = self.cfg
        _no_split()
        c = tokens.shape[1]
        x = self._embed(params, tokens, positions=(
            p0 + torch.arange(c, device=tokens.device))[None])
        x = self._serve_layers(
            params, x, list(zip(pool["k"], pool["v"])),
            lambda p, h, kv, split: A.attn_prefill_paged(
                cfg, p, h, *kv, block_table, p0))
        return self._lm_head(params, x[:, last_idx:last_idx + 1]), pool

    @torch.inference_mode()
    def decode_paged(self, params: dict, pool: dict, tokens: torch.Tensor,
                     block_tables: torch.Tensor, positions: torch.Tensor):
        """One step for every slot at its own position: tokens (B, 1),
        block_tables (B, nbt), positions (B,).  Idle rows point at the null
        block.  Returns ``(logits (B, 1, V), pool)``."""
        cfg = self.cfg
        _no_split()
        x = self._embed(params, tokens, positions=positions[:, None])
        x = self._serve_layers(
            params, x, list(zip(pool["k"], pool["v"])),
            lambda p, h, kv, split: A.attn_decode_paged(
                cfg, p, h, *kv, block_tables, positions))
        return self._lm_head(params, x), pool
