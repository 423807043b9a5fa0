"""Config module for mamba2-370m (``archs.py`` has the config)."""
from repro_torch.configs.archs import MAMBA2_370M as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("mamba2-370m", **over)
