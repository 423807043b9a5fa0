"""Config module for whisper-large-v3 (``archs.py`` has the config)."""
from repro_torch.configs.archs import WHISPER_LARGE_V3 as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("whisper-large-v3", **over)
