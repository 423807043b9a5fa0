"""Config module for kimi-k2-1t-a32b (``archs.py`` has the config)."""
from repro_torch.configs.archs import KIMI_K2 as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("kimi-k2-1t-a32b", **over)
