"""Config module for qwen2-7b (``archs.py`` has the config)."""
from repro_torch.configs.archs import QWEN2_7B as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("qwen2-7b", **over)
