"""Fault tolerance for the port's training stack, the counterpart of the
JAX package's ``repro.resilience``: the skip-step guard and the xi
watchdog (``guards.py``; ``OptimizerConfig.guards``) and deterministic
fault injection (``chaos.py``).  Everything is config-gated and
default-off; the hardened checkpoint I/O is ``repro_torch.checkpoint``.
"""
from repro_torch.resilience.chaos import (FaultPlan,
                                          corrupt_latest_checkpoint,
                                          flip_bit, inject_faults,
                                          remesh_after_loss, truncate_file)
from repro_torch.resilience.guards import (GuardConfig, GuardedState,
                                           GuardState, guard_updates,
                                           init_guard_state,
                                           tree_all_finite)
