"""Config module for gpt2-117m (``archs.py`` has the config)."""
from repro_torch.configs.archs import GPT2_117M as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("gpt2-117m", **over)
