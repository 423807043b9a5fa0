"""Config module for deepseek-67b (``archs.py`` has the config)."""
from repro_torch.configs.archs import DEEPSEEK_67B as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("deepseek-67b", **over)
