"""The port's optimizers as composable gradient transformations, the
counterpart of the JAX package's ``repro.core``, exporting the same names.

``build_optimizer(OptimizerConfig)`` (``core/build.py``) is the entry
point for launchers, benchmarks and the examples; :func:`make_optimizer`
is the kwargs-level registry for tests and experiments, as in the JAX
package.  Both build the same chains.  ``rank_metrics(opt_state)`` gives
the mean effective rank and xi of the factored leaves for logging.

The chain functions ``adapprox``, ``adamw``, ``adafactor``, ``came`` and
``sketch`` share their names with the modules that define them, and the
package exports the functions, as JAX's does: after ``import
repro_torch.core`` both ``from repro_torch.core import adapprox`` and
``import repro_torch.core.adapprox as A`` give the function.  Import the
module's names from it (``from repro_torch.core.adapprox import
scale_by_adapprox``), or take the module itself from
``importlib.import_module("repro_torch.core.adapprox")``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.types import (EmptyState, GradientTransformation,
                                    Schedule, apply_updates, chain,
                                    clip_by_global_norm, constant_schedule,
                                    global_norm, replicate_state_spec,
                                    state_sharding_spec, tree_nbytes)
from repro_torch.core.transform import (CountState, PartitionState,
                                        add_decayed_weights, clip_update_rms,
                                        mask_nd, partition, scale,
                                        scale_by_relative_step,
                                        scale_by_schedule)
from repro_torch.core.srsi import (ImplicitV, SRSIResult, cholesky_qr2,
                                   make_implicit_v, reconstruct, srsi_dense,
                                   srsi_implicit)
from repro_torch.core.rank import RankConfig, f_increment, resolve_k_max
from repro_torch.core.factored import DenseLeaf, FactoredLeaf
from repro_torch.core.adapprox import (AdapproxConfig, AdapproxState,
                                       adapprox, adapprox_state,
                                       rank_metrics, scale_by_adapprox)
from repro_torch.core.adamw import (AdamWConfig, AdamWState, adamw,
                                    scale_by_adam)
from repro_torch.core.adafactor import (AdafactorConfig, AdafactorState,
                                        adafactor, scale_by_factored_rms)
from repro_torch.core.came import CAMEConfig, CAMEState, came, scale_by_came
from repro_torch.core.sketch import (SketchConfig, SketchDense, SketchLeaf,
                                     SketchState, scale_by_sketch,
                                     should_sketch, sketch, sketch_state)
from repro_torch.core.build import build_optimizer

_REGISTRY = {}


def register(name):
    """Decorator: ``make_optimizer(name, **kw)`` calls the decorated
    factory with ``kw`` untouched."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def make_optimizer(name: str, **kwargs):
    """Build an optimizer by name; ``kwargs`` override the config's
    defaults (``decay_mask`` goes to the decay stage, the ``RankConfig``
    fields of adapprox to its rank config).  Returns a
    ``GradientTransformation``."""
    if name in _REGISTRY:
        return _REGISTRY[name](**kwargs)
    decay_mask = kwargs.pop("decay_mask", None)
    if name == "adapprox":
        rank_keys = {f.name for f in dataclasses.fields(RankConfig)}
        rank = RankConfig(**{k: kwargs.pop(k) for k in list(kwargs)
                             if k in rank_keys})
        return adapprox(AdapproxConfig(rank=rank, **kwargs),
                        decay_mask=decay_mask)
    if name == "adamw":
        return adamw(AdamWConfig(**kwargs), decay_mask=decay_mask)
    if name == "adafactor":
        return adafactor(AdafactorConfig(**kwargs), decay_mask=decay_mask)
    if name == "came":
        return came(CAMEConfig(**kwargs), decay_mask=decay_mask)
    if name == "sketch":
        return sketch(SketchConfig(**kwargs), decay_mask=decay_mask)
    raise ValueError(f"unknown optimizer {name!r}; "
                     f"available: adapprox, adamw, adafactor, came, "
                     f"sketch, {sorted(_REGISTRY)}")
