"""Config module for llava-next-mistral-7b (``archs.py`` has the config)."""
from repro_torch.configs.archs import LLAVA_NEXT_MISTRAL_7B as CONFIG
from repro_torch.configs.archs import get_smoke_config


def model_config():
    return CONFIG


def smoke_config(**over):
    return get_smoke_config("llava-next-mistral-7b", **over)
