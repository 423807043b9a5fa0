"""The port's hand-written CUDA kernels for the optimizer's and the
models' hot paths, each beside its plain PyTorch version.

  * ``ops.py``: the only entry point callers use.  It dispatches by the
    tensors' device: CPU tensors take the plain versions in ``ref.py``,
    CUDA tensors launch the kernels (or the launch raises).
  * ``fused_update.py``, ``lowrank_update.py``, ``srsi_matmul.py``,
    ``sketch_update.py``, ``flash_attention.py``, ``ssd_chunk.py``: the
    wrappers of the kernels in ``csrc/``, each counting its launches.
  * ``cuda.py``: builds a source with nvcc for ``sm_90a`` at first use.

Importing the package builds and loads no CUDA library: a wrapper loads
its kernel's library the first time it launches it.
"""
from repro_torch.kernels import ops
