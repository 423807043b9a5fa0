"""Config module for minitron-4b (``archs.py`` has the config)."""
from repro_torch.configs.archs import MINITRON_4B as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("minitron-4b", **over)
