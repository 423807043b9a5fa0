"""Config module for qwen3-14b (``archs.py`` has the config)."""
from repro_torch.configs.archs import QWEN3_14B as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("qwen3-14b", **over)
