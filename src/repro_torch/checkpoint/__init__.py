"""Checkpointing for the port, in the JAX package's on-disk format: atomic,
checksummed saves (``serialization.py``) and the manager that saves
asynchronously, keeps the last few, restores past corrupt ones and writes
a preemption checkpoint (``manager.py``)."""
from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.checkpoint.serialization import (CheckpointCorruptError,
                                                  latest_checkpoint,
                                                  list_checkpoints, read_meta,
                                                  restore_pytree, save_pytree,
                                                  verify_checkpoint)
