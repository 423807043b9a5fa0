"""Config module for gpt2-345m (``archs.py`` has the config)."""
from repro_torch.configs.archs import GPT2_345M as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("gpt2-345m", **over)
