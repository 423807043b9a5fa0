"""The port's model zoo: dense / GQA transformer, MoE, Mamba2 / SSD,
Zamba2 hybrid, Whisper encoder-decoder and the VLM backbone, each with its
stacked layers and logical-axis parameter specs."""
from repro_torch.models.model_zoo import build_model
