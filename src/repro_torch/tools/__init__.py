"""Command-line tools of the port (``python -m repro_torch.tools.<name>``),
counterparts of the JAX package's ``tools/`` scripts."""
