"""The port's sharding rules and state specs against the JAX package's,
leaf for leaf, with no device and no process group on either side (both
derive specs from mesh axis sizes alone).

Parameters: all 13 archs' smoke configs on {data: 4, model: 2} and
{pod: 2, data: 4, model: 2}, FSDP on and off, kinds train and decode, and
``parallel_strategy="fsdp"``.  Optimizer state: Adapprox with and without
m1, under the guards, with telemetry and the dynamic cadence; AdamW,
Adafactor, CAME and the launcher's mixed groups, each through its
``state_sharding_spec`` hook.  Batch and cache specs of every arch.  The
JAX side's ``eval_shape`` structures are built once per arch and module.

A leaf's spec is compared as its ``str`` under its JAX key path, which is
what a checkpoint manifest records.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import build_optimizer as jax_build_optimizer
from repro.core import types as JT
from repro.distributed import sharding as JSH
from repro.launch.train import optimizer_config as jax_optimizer_config
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.checkpoint.serialization import spec_leaves
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.build import build_optimizer
from repro_torch.core.types import P
from repro_torch.distributed import sharding as SH
from repro_torch.launch.train import optimizer_config
from repro_torch.models.model_zoo import build_model
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

MESHES = {"dm": {"data": 4, "model": 2},
          "pdm": {"pod": 2, "data": 4, "model": 2}}


@functools.cache
def _jax_model(arch, **over):
    model = jax_build_model(jax_smoke_config(arch, **over))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.cache
def _port_model(arch, **over):
    model = build_model(get_smoke_config(arch, **over))
    return model, tree.flatten(model.init(torch.Generator().manual_seed(0)))


def _jax_list(spec_tree, prefix=""):
    return [(prefix + jax.tree_util.keystr(kp), str(s)) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                spec_tree, is_leaf=lambda x: isinstance(x, JP))[0]]


def _port_list(spec_tree, prefix=""):
    return [(prefix + path, str(getattr(s, "spec", s) if s is not None
                                else P())) for path, s in
            spec_leaves(spec_tree)]


def _port_params_list(pspecs: dict):
    return [("".join(f"[{k!r}]" for k in name.split("/")), str(s))
            for name, s in pspecs.items()]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(arch, mesh):
    sizes = MESHES[mesh]
    jmodel, _ = _jax_model(arch)
    model, params = _port_model(arch)
    cases = [(kind, fsdp) for kind in ("train", "decode")
             for fsdp in (True, False)]
    for kind, fsdp in cases:
        want = _jax_list(JSH.param_pspecs(jmodel, sizes, kind, fsdp))
        got = _port_params_list(SH.param_pspecs(model, sizes, kind, fsdp,
                                                params=params))
        assert got == want, (kind, fsdp)
    # ZeRO-3 over every axis
    jz, _ = _jax_model(arch, parallel_strategy="fsdp")
    mz = build_model(get_smoke_config(arch, parallel_strategy="fsdp"))
    assert _port_params_list(SH.param_pspecs(mz, sizes, params=params)) == \
        _jax_list(JSH.param_pspecs(jz, sizes, "train"))
    # every split divides its dimension
    for name, spec in SH.param_pspecs(model, sizes, params=params).items():
        assert SH.sanitize_spec(spec, params[name].shape, sizes) == spec


OPT_CASES = {
    "adapprox-m1": ("adapprox", {}, {}),
    "adapprox-no-m1": ("adapprox", {}, {"b1": 0.0}),
    "adapprox-guards": ("adapprox", dict(guards=True, max_demotions=1), {}),
    "adapprox-telemetry": ("adapprox", dict(telemetry=True), {}),
    "adapprox-dynamic": ("adapprox", dict(telemetry=True,
                                          dynamic_refresh=True), {}),
    "adapprox-mixed": ("adapprox", dict(mixed_groups=True,
                                        embedding_min_rows=256,
                                        sketch_width=64, sketch_depth=2),
                       {}),
    "adapprox-mixed-guards": ("adapprox", dict(
        mixed_groups=True, embedding_min_rows=256, sketch_width=64,
        sketch_depth=2, guards=True, max_demotions=1, telemetry=True,
        dynamic_refresh=True), {}),
    "adamw": ("adamw", {}, {}),
    "adafactor": ("adafactor", {}, {}),
    "came": ("came", {}, {}),
    "adamw-mixed": ("adamw", dict(mixed_groups=True), {}),
}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_opt_state_specs_match_jax(case, mesh):
    """Every optimizer-state leaf's spec, through the hooks, on the smoke
    GPT-2 and the smoke OLMoE (expert stacks: (L, E, m, n) leaves)."""
    name, kw, over = OPT_CASES[case]
    sizes = MESHES[mesh]
    for arch in ("gpt2-117m", "olmoe-1b-7b"):
        jmodel, jstruct = _jax_model(arch)
        model, params = _port_model(arch)
        jcfg = dataclasses.replace(jax_optimizer_config(name, 10, 1e-3,
                                                        **kw), **over)
        cfg = dataclasses.replace(optimizer_config(name, 10, 1e-3, **kw),
                                  **over)
        jopt, opt = jax_build_optimizer(jcfg), build_optimizer(cfg)
        jp = JSH.param_pspecs(jmodel, sizes, "train")
        jstate = jax.eval_shape(jopt.init, jstruct)
        want = _jax_list(JT.state_sharding_spec(jopt, jstate, jp))
        pp = SH.param_pspecs(model, sizes, params=params)
        state = opt.init({k: torch.empty_like(v, device="meta")
                          for k, v in params.items()})
        got = _port_list(SH.opt_state_pspecs(opt, state, pp))
        assert got == want, (arch, case)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_cache_specs_match_jax(arch):
    jmodel, _ = _jax_model(arch)
    model, _ = _port_model(arch)
    cfg = model.cfg
    for name, sizes in MESHES.items():
        amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
        shapes = {"tokens": (8, 64)}
        if cfg.family in ("vlm", "encdec"):
            shapes["embeds"] = (8, 16, cfg.d_model)
        jb = JSH.batch_shardings(
            jmodel.cfg, "train", amesh,
            {k: jax.ShapeDtypeStruct(s, np.float32)
             for k, s in shapes.items()})
        assert {k: str(v.spec) for k, v in jb.items()} == {
            k: str(v) for k, v in
            SH.batch_pspecs(cfg, "train", sizes, shapes).items()}, name
        for long_context, batch in ((False, 8), (True, 1)):
            jc = jax.eval_shape(lambda: jmodel.init_cache(batch, 64))
            want = [(p, str(s.spec)) for p, s in _jax_named(
                JSH.cache_shardings(jmodel.cfg, amesh, jc, long_context))]
            cache = model.init_cache(batch, 64, device="meta")
            got = _port_list(SH.cache_pspecs(cfg, sizes, cache,
                                             long_context))
            assert got == want, (name, long_context)


def _jax_named(tree_):
    from jax.sharding import NamedSharding
    return [(jax.tree_util.keystr(kp), s) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                tree_, is_leaf=lambda x: isinstance(x, NamedSharding))[0]]


def test_logits_spec_matches_jax():
    for sizes in MESHES.values():
        amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
        for lc in (False, True):
            assert str(SH.logits_pspec(sizes, lc)) == \
                str(JSH.logits_sharding(amesh, lc).spec)


@pytest.mark.parametrize("spec,shape,want", [
    (P(("pod", "data", "model")), (256,), P(("data", "model"))),
    (P("model", None), (3, 4), P(None, None)),
    (P(("data", "model")), (8,), P(("data", "model"))),
    (P("stage"), (8,), P(None)),
])
def test_sanitize_spec_matches_jax(spec, shape, want):
    sizes = {"pod": 2, "data": 4, "model": 2}
    if shape == (256,):
        sizes = {"pod": 2, "data": 16, "model": 16}
    got = SH.sanitize_spec(spec, shape, sizes)
    jwant = JSH.sanitize_spec(JP(*spec), shape, sizes)
    assert got == want and str(got) == str(jwant)


def test_partition_spec_prints_as_jax():
    for parts in [(), ("data",), ("data", None), (("data", "model"), None),
                  (None, "model", ("pod", "data"))]:
        assert str(P(*parts)) == str(JP(*parts))
