"""The JAX package's 13 archs and their reduced smoke configs, copied
field for field from its ``configs/archs.py`` (its values, not the
published ones: every arch keeps ``rope_theta`` 10,000 there): the
paper's own GPT-2 configs (Table 1), the dense and MoE decoders,
Mamba2-370m, the Zamba2 hybrid, the Whisper encoder-decoder and the
LLaVA-NeXT decoder behind its stub vision frontend."""
from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig, MoESpec, SSMSpec


def _smoke(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced config of the same family: few layers, thin width, tiny
    vocab, every structural feature kept (GQA ratio, qk_norm, MoE top-k,
    the SSD block, the hybrid period, the encoder, the frontend tokens)."""
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=512, head_dim=16, max_seq_len=256, remat="none")
    if cfg.moe is not None:
        base["moe"] = dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                          d_ff_expert=32)
    if cfg.ssm is not None:
        base["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                          chunk=16)
    if cfg.family == "hybrid":
        base["n_layers"] = 4
        base["hybrid_attn_every"] = 2
    if cfg.family == "encdec":
        base["enc_layers"] = 2
        base["enc_seq"] = 32
    if cfg.family == "vlm":
        base["frontend_tokens"] = 8
    base.update(over)
    return dataclasses.replace(cfg, **base)


# --- hybrid: Mamba2 + shared attention blocks [arXiv:2411.15242; hf] -------
ZAMBA2_2P7B = ModelConfig(
    arch="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
    ssm=SSMSpec(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                chunk=256),
    hybrid_attn_every=6, n_shared_blocks=2, act="gelu",
    max_seq_len=524_288)

# --- dense: pruned nemotron [arXiv:2407.14679; hf] --------------------------
MINITRON_4B = ModelConfig(
    arch="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=9216, vocab=256_000, act="relu2",
    head_dim=128, max_seq_len=32_768)

# --- dense: GQA, QKV bias [arXiv:2407.10671; hf] ----------------------------
QWEN2_7B = ModelConfig(
    arch="qwen2-7b", family="dense", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18_944, vocab=152_064, qkv_bias=True,
    max_seq_len=32_768)

# --- dense: llama-arch [arXiv:2401.02954; hf] -------------------------------
DEEPSEEK_67B = ModelConfig(
    arch="deepseek-67b", family="dense", n_layers=95, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22_016, vocab=102_400,
    max_seq_len=32_768)

# --- dense: qk_norm, GQA [hf:Qwen/Qwen3-8B; hf] -----------------------------
QWEN3_14B = ModelConfig(
    arch="qwen3-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=17_408, vocab=151_936, qk_norm=True,
    head_dim=128, max_seq_len=32_768)

# --- moe: 64 experts top-8 [arXiv:2409.02060; hf] ---------------------------
OLMOE_1B_7B = ModelConfig(
    arch="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50_304,
    moe=MoESpec(n_experts=64, top_k=8, d_ff_expert=1024),
    max_seq_len=32_768)

# --- moe: Kimi K2 trillion-param MoE (paper-table) [arXiv:2501.kimi2] -------
KIMI_K2 = ModelConfig(
    arch="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163_840, head_dim=112,
    moe=MoESpec(n_experts=384, top_k=8, d_ff_expert=2048),
    param_dtype="bfloat16",       # 1T params: fp32 master cannot fit a pod
    max_seq_len=32_768)

# --- audio: enc-dec, conv frontend STUB [arXiv:2212.04356] ------------------
WHISPER_LARGE_V3 = ModelConfig(
    arch="whisper-large-v3", family="encdec", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51_866,
    enc_layers=32, enc_seq=1500, act="gelu", norm="layernorm",
    pos_embedding="learned", tie_embeddings=True, frontend="audio",
    max_seq_len=32_768)

# --- vlm: anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf] --------------
LLAVA_NEXT_MISTRAL_7B = ModelConfig(
    arch="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14_336, vocab=32_000,
    frontend="vision", frontend_tokens=576, max_seq_len=32_768)

# --- synthetic: embedding-dominated probe for the sketch backend ------------
# Large multilingual-style vocab over a thin trunk: ~134M of ~147M params
# sit in the (tied) token embedding, so optimizer-state memory is decided
# by what happens to that one leaf.
EMBED_HEAVY_256K = ModelConfig(
    arch="embed-heavy-256k", family="dense", n_layers=4, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab=262_144,
    tie_embeddings=True, max_seq_len=2048)

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
    c.arch: c for c in [
        ZAMBA2_2P7B, MINITRON_4B, QWEN2_7B, DEEPSEEK_67B, QWEN3_14B,
        OLMOE_1B_7B, KIMI_K2, WHISPER_LARGE_V3, MAMBA2_370M,
        LLAVA_NEXT_MISTRAL_7B, GPT2_117M, GPT2_345M, EMBED_HEAVY_256K]}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; the port has "
                         f"{sorted(ARCHS)}") from None


def get_smoke_config(arch: str, **over) -> ModelConfig:
    return _smoke(get_config(arch), **over)
