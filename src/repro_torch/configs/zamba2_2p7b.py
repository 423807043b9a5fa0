"""Config module for zamba2-2.7b (``archs.py`` has the config)."""
from repro_torch.configs.archs import ZAMBA2_2P7B as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("zamba2-2.7b", **over)
