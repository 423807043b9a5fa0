"""The port's optimizers as composable gradient transformations.

``build_optimizer(OptimizerConfig)`` (``core/build.py``) is the entry
point for launchers and benchmarks; :func:`make_optimizer` is the
kwargs-level registry for tests and experiments, as in the JAX package.
Both build the same chains.
"""
from __future__ import annotations

import dataclasses

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
    ``GradientTransformation``.  The factories are imported here, not at
    the package's top, so that ``repro_torch.core.adapprox`` (and the
    other optimizer modules) stay the modules, not their chain functions
    of the same name."""
    from repro_torch.core.adafactor import AdafactorConfig, adafactor
    from repro_torch.core.adamw import AdamWConfig, adamw
    from repro_torch.core.adapprox import AdapproxConfig, adapprox
    from repro_torch.core.came import CAMEConfig, came
    from repro_torch.core.rank import RankConfig
    from repro_torch.core.sketch import SketchConfig, sketch
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
