"""Config module for olmoe-1b-7b (``archs.py`` has the config)."""
from repro_torch.configs.archs import OLMOE_1B_7B as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("olmoe-1b-7b", **over)
