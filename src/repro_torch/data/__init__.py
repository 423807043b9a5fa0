"""The port's data pipeline: the JAX package's deterministic synthetic and
corpus token streams (``pipeline.py``)."""
from repro_torch.data.pipeline import DataConfig, DataIterator, make_source
