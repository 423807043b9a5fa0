"""PyTorch + CUDA port of the Adapprox reproduction (``repro``), for one
NVIDIA H100.  Imports ``torch`` and never ``jax`` or ``repro``; see
README.md and ROADMAP.md for what is ported."""
