"""The paper's own GPT-2 configs (Table 1), Mamba2-370m, and their
reduced smoke configs, as in the JAX package's ``configs/archs.py``.  The
other architectures there belong to model families the port has not
reached yet."""
from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig, SSMSpec


def _smoke(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced config of the same family: few layers, thin width, tiny
    vocab, every structural feature kept (GQA ratio and the SSD block
    included)."""
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=512, head_dim=16, max_seq_len=256, remat="none")
    if cfg.ssm is not None:
        base["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                          chunk=16)
    base.update(over)
    return dataclasses.replace(cfg, **base)


GPT2_117M = ModelConfig(
    arch="gpt2-117m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=50_257, act="gelu",
    norm="layernorm", pos_embedding="learned", tie_embeddings=True,
    mlp_bias=True, max_seq_len=1024)

GPT2_345M = ModelConfig(
    arch="gpt2-345m", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=50_257, act="gelu",
    norm="layernorm", pos_embedding="learned", tie_embeddings=True,
    mlp_bias=True, max_seq_len=1024)

# --- ssm: SSD (state-space duality) [arXiv:2405.21060] ----------------------
MAMBA2_370M = ModelConfig(
    arch="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50_280,
    ssm=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                chunk=256),
    max_seq_len=524_288)

ARCHS: dict[str, ModelConfig] = {
    c.arch: c for c in [GPT2_117M, GPT2_345M, MAMBA2_370M]}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; the port has "
                         f"{sorted(ARCHS)}") from None


def get_smoke_config(arch: str, **over) -> ModelConfig:
    return _smoke(get_config(arch), **over)
