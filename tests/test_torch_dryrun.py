"""The port's dry run (``repro_torch.launch.dryrun``, ``launch/step_cost.py``,
the shape cells, ``input_specs``) against the JAX package's, on the CPU.

(a) JAX's pure functions case for case: ``CELLS``, ``applicable_cells``,
    ``input_specs``, ``microbatches_for`` on both production meshes,
    ``dryrun_opt_config``, ``plan`` and its ``SKIPS``, ``param_count`` /
    ``active_param_count``, ``snapshot_spec`` and ``guard_spec``; the
    per-arch config modules held to ``archs.py`` and to JAX's modules.
(b) Per-rank parameter and optimizer-state bytes of every assigned arch's
    ``train_4k`` cell at full size on the (16, 16) and (2, 16, 16) meshes,
    placed on fake tensors over a fake process group, leaf for leaf equal
    to the bytes JAX's ``eval_shape`` shapes and specs give; no storage on
    either side.
(c) The cost counter: a 7-iteration loop of (128, 128) products counts
    7 x 2 x 128^3 FLOPs, and each collective kind's link bytes follow
    JAX's formulas over a fake (2, 2) mesh.
(d) ``python -m repro_torch.launch.dryrun --preset test`` in a subprocess
    for the JAX test's three combinations, its records' bytes held to
    JAX's specs at smoke size and its telemetry stream to both
    validators; a record in ``--out`` is reused only for its own mesh and
    preset.

The JAX package's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported;
the fixture imports it after JAX's backend is up and restores the
variable, so no later subprocess of this worker inherits it.
"""
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro import config as JC
from repro.configs import ARCHS as JARCHS
from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import input_specs as jax_input_specs
from repro.core import types as JT
from repro.distributed import sharding as JSH
from repro.models import build_model as jax_build_model
from repro.resilience.guards import guard_spec as jax_guard_spec
from repro.resilience.guards import init_guard_state as jax_init_guard_state
from repro.telemetry.snapshot import init_snapshot as jax_init_snapshot
from repro.telemetry.snapshot import snapshot_spec as jax_snapshot_spec
from repro.train.steps import TrainState as JTrainState
from repro_torch import config as C
from repro_torch.checkpoint.serialization import (leaves_with_paths,
                                                  spec_leaves)
from repro_torch.configs import (ARCHS, ASSIGNED, get_config,
                                 get_smoke_config, input_specs)
from repro_torch.core.types import P
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.step_cost import StepCost
from repro_torch.models.model_zoo import build_model
from repro_torch.resilience.guards import guard_spec, init_guard_state
from repro_torch.telemetry.snapshot import init_snapshot, snapshot_spec
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}
TEST_SIZES = {"pod": 2, "data": 2, "model": 2}


@pytest.fixture(scope="module")
def jdry():
    """The JAX package's dry-run module, imported without leaving its
    ``XLA_FLAGS`` behind."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


@pytest.fixture(scope="module")
def fake_group():
    """The fake process group the module's meshes start; torn down after
    (it cannot share the worker with a real group)."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (a) JAX's pure functions
# ---------------------------------------------------------------------------

def test_cells_and_applicable_cells_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in C.CELLS.items()} == {
        k: dataclasses.asdict(v) for k, v in JC.CELLS.items()}
    assert list(C.CELLS) == list(JC.CELLS)
    assert sorted(ARCHS) == sorted(JARCHS) and len(ARCHS) == 13
    for arch in ARCHS:
        assert C.applicable_cells(get_config(arch)) == JC.applicable_cells(
            jax_get_config(arch)), arch
    assert ASSIGNED == JASSIGNED


def test_param_counts_match_jax():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert cfg.param_count() == jcfg.param_count(), arch
        assert cfg.active_param_count() == jcfg.active_param_count(), arch
    kimi = get_config("kimi-k2-1t-a32b")
    assert kimi.active_param_count() < kimi.param_count() // 10


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_jax(arch):
    """Shapes and element counts of every applicable cell's inputs; the
    embeds' dtype is JAX's, the tokens int64 (the port's batches) where
    JAX's are int32; no storage (meta)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for cell in C.applicable_cells(cfg):
        got, want = input_specs(cfg, cell), jax_input_specs(jcfg, cell)
        assert list(got) == list(want), (arch, cell)
        for k, t in got.items():
            assert tuple(t.shape) == tuple(want[k].shape), (arch, cell, k)
            assert t.numel() == math.prod(want[k].shape)
            assert t.device.type == "meta"
        assert got["tokens"].dtype == torch.int64
        if "embeds" in got:
            assert str(got["embeds"].dtype).split(".")[-1] == \
                str(want["embeds"].dtype)


def test_microbatches_and_opt_config_match_jax(jdry, fake_group):
    for name, sizes in MESHES.items():
        amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
        for arch in ASSIGNED:
            for cell in C.CELLS:
                assert D.microbatches_for(arch, cell, sizes) == \
                    jdry.microbatches_for(arch, cell, amesh), (arch, cell)
        assert D.microbatches_for("kimi-k2-1t-a32b", "train_4k") == 16
    mesh = make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    assert D.microbatches_for("deepseek-67b", "train_4k", mesh) == 8
    assert D.FSDP_TRAIN_ARCHS == jdry.FSDP_TRAIN_ARCHS
    for arch in ASSIGNED:
        got = dataclasses.asdict(D.dryrun_opt_config(arch))
        want = dataclasses.asdict(jdry.dryrun_opt_config(arch))
        assert set(got) == set(want)
        assert got == want, arch
    assert D.dryrun_opt_config("kimi-k2-1t-a32b").b1 == 0.0


def test_plan_and_skips_match_jax(jdry):
    cells = list(C.CELLS)
    D.SKIPS.clear()
    jdry.SKIPS.clear()
    assert list(D.plan(ASSIGNED, cells)) == list(jdry.plan(JASSIGNED, cells))
    assert D.SKIPS == jdry.SKIPS
    assert len(D.SKIPS) == 8 and all(c == "long_500k" for _, c in D.SKIPS)


ARCH_MODULES = {a.replace("-", "_").replace(".", "p"): a for a in ARCHS
                if a != "embed-heavy-256k"}


def test_arch_modules_are_jaxs():
    def modules(pkg):
        return sorted(p.stem for p in (ROOT / "src" / pkg / "configs").glob(
            "*.py") if p.stem not in ("__init__", "archs", "base"))
    assert modules("repro_torch") == modules("repro") == sorted(
        ARCH_MODULES)
    assert len(ARCH_MODULES) == 12


@pytest.mark.parametrize("name", sorted(ARCH_MODULES))
def test_arch_module_holds_to_archs(name):
    """``configs/<arch>.py`` gives ``archs.py``'s config and smoke config
    (overrides applied), and counts what JAX's module counts."""
    arch = ARCH_MODULES[name]
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    jmod = importlib.import_module(f"repro.configs.{name}")
    assert mod.model_config() is get_config(arch)
    assert mod.smoke_config() == get_smoke_config(arch)
    one = mod.smoke_config(n_layers=1)
    assert one == get_smoke_config(arch, n_layers=1) and one.n_layers == 1
    for got, want in ((mod.model_config(), jmod.model_config()),
                      (mod.smoke_config(), jmod.smoke_config())):
        assert got.param_count() == want.param_count()
        assert (got.d_model, got.n_layers, got.vocab) == (
            want.d_model, want.n_layers, want.vocab)


def _jax_list(spec_tree):
    return [(jax.tree_util.keystr(kp), str(s)) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                spec_tree, is_leaf=lambda x: isinstance(x, JP))[0]]


def test_snapshot_and_guard_specs_match_jax():
    """``snapshot_spec`` replicates every telemetry leaf and
    ``guard_spec`` replicates the counters and splits each shadow buffer
    like its parameter, as JAX's."""
    snap = init_snapshot(3, 5, 4, leaf_indices=(0, 2, 4),
                         dense_indices=(1, 3))
    jsnap = jax_init_snapshot(3, 5, 4, leaf_indices=(0, 2, 4),
                              dense_indices=(1, 3))
    got = [(p, str(s)) for p, s in spec_leaves(snapshot_spec(snap))]
    assert got == _jax_list(jax_snapshot_spec(jsnap)) and got
    assert snapshot_spec(None) is None
    shapes = [(4, 8), (2, 6, 4)]
    pspecs = [P("data", None), P(None, "model", None)]
    for demotions in (0, 2):
        gs = init_guard_state(shapes, demotions)
        jgs = jax_init_guard_state(shapes, demotions)
        got = [(p, str(s)) for p, s in spec_leaves(guard_spec(gs, pspecs))]
        want = _jax_list(jax_guard_spec(jgs, [JP(*s) for s in pspecs]))
        assert got == want, demotions
    assert len(guard_spec(init_guard_state(shapes, 2), pspecs).dense_v) == 2


# ---------------------------------------------------------------------------
# (b) per-rank bytes at full size
# ---------------------------------------------------------------------------

def _rank_bytes(shape, dtype, spec, sizes) -> int:
    split = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            split *= sizes[a]
    n = math.prod(shape) * np.dtype(dtype).itemsize
    assert n % split == 0
    return n // split


def _jax_rank_bytes(tree_, specs, sizes) -> dict:
    """``{key path: per-rank bytes}`` of JAX's array leaves by their
    specs."""
    leaves = jax.tree_util.tree_flatten_with_path(tree_)[0]
    spec_list = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_list)
    return {jax.tree_util.keystr(kp): _rank_bytes(x.shape, x.dtype, s, sizes)
            for (kp, x), s in zip(leaves, spec_list)}


def _port_rank_bytes(tree_) -> dict:
    """``{key path: this rank's bytes}`` of the port's leaves (a DTensor's
    local block), ``None`` for a leaf the port holds on the host (a
    Python counter, the derived PRNG key)."""
    out = {}
    for path, leaf in leaves_with_paths(tree_):
        if isinstance(leaf, torch.Tensor):
            loc = leaf.to_local() if hasattr(leaf, "to_local") else leaf
            out[path] = loc.numel() * loc.element_size()
        else:
            out[path] = None
    return out


def _held_to_jax(got: dict, want: dict, per_leaf: bool = True) -> int:
    """The port's leaves are JAX's, path for path, and (``per_leaf``) each
    device tensor's per-rank bytes JAX's; what JAX holds where the port
    holds host numbers is a few scalars and the key.  Returns JAX's
    per-rank bytes of the port's device tensors."""
    assert list(got) == list(want)
    dev = {k: want[k] for k, v in got.items() if v is not None}
    if per_leaf:
        assert dev == {k: v for k, v in got.items() if v is not None}
    assert sum(want[k] for k in got if got[k] is None) <= 24
    return sum(dev.values())


def _jax_train_bytes(jdry, arch: str, sizes: dict, smoke: bool = False):
    """Per-rank ``(param, opt_state)`` bytes by path of the JAX dry run's
    train cell: ``eval_shape`` shapes, ``param_pspecs`` and the optimizer
    state's specs through its hook."""
    jcfg = jax_smoke_config(arch) if smoke else jax_get_config(arch)
    if not smoke and arch in jdry.FSDP_TRAIN_ARCHS:
        jcfg = dataclasses.replace(jcfg, parallel_strategy="fsdp")
    jmodel = jax_build_model(jcfg)
    jopt = jdry.dryrun_optimizer(arch)
    pstruct = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    sstruct = jax.eval_shape(lambda p: JTrainState.create(p, jopt), pstruct)
    jp = JSH.param_pspecs(jmodel, sizes, "train")
    ospecs = JT.state_sharding_spec(jopt, sstruct.opt_state, jp)
    return (_jax_rank_bytes(pstruct, jp, sizes),
            _jax_rank_bytes(sstruct.opt_state, ospecs, sizes))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_full_size_train_bytes_match_jax(arch, mesh, jdry, fake_group):
    """The train_4k cell's placed state at full size: the parameters and
    the optimizer state have JAX's leaves under JAX's key paths, every
    tensor's per-rank bytes JAX's (the few scalars and the key JAX holds
    where the port holds host numbers apart); the record's totals are the
    sums."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sizes = MESHES[mesh]
    fmesh = make_fake_mesh(tuple(sizes.values()), tuple(sizes))
    c = D.build_cell(arch, "train_4k", fmesh)
    with FakeTensorMode():
        inputs = D.place_inputs(c)
    state = inputs["state"]
    want_p, want_o = _jax_train_bytes(jdry, arch, sizes)
    got_p = _port_rank_bytes(state.params)
    assert got_p == want_p
    assert inputs["param_bytes"] == sum(want_p.values())
    assert inputs["opt_state_bytes"] == _held_to_jax(
        _port_rank_bytes(state.opt_state), want_o)
    assert inputs["cache_bytes"] == 0
    # no full-size tensor has storage
    assert all(isinstance(v.to_local() if hasattr(v, "to_local") else v,
                          torch._subclasses.fake_tensor.FakeTensor)
               for v in state.params.values())


# ---------------------------------------------------------------------------
# (c) the cost counter
# ---------------------------------------------------------------------------

def test_step_cost_counts_every_loop_iteration():
    """7 iterations of a (128, 128) product count 7 x 2 x 128^3 FLOPs, as
    the JAX walker counts the scan's 7 trips; bytes accessed count each
    product's operands and output; the peak counts the live storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro.launch.hlo_cost import parse_hlo_costs

    def f(x):
        def body(c, _):
            return c @ x, None
        return jax.lax.scan(body, x, None, length=7)[0]

    walker = parse_hlo_costs(jax.jit(f).lower(
        jax.ShapeDtypeStruct((128, 128), jnp.float32)).compile().as_text())
    expect = 7 * 2 * 128 ** 3
    with FakeTensorMode():
        x = torch.empty(128, 128)
        cost = StepCost()
        cost.track(x)
        with cost:
            c = x
            for _ in range(7):
                c = c @ x
    assert cost.flops == expect
    assert abs(walker.flops - cost.flops) / expect < 0.05
    assert cost.bytes_accessed == 7 * 3 * 128 * 128 * 4
    assert 2 * 128 * 128 * 4 <= cost.peak_bytes <= 3 * 128 * 128 * 4
    assert not cost.collectives


_HLO = {
    "all-gather": "%a = f32[8,4]{1,0} all-gather(f32[4,4]{1,0} %p), "
                  "replica_groups={{0,1}}, dimensions={0}",
    "all-reduce": "%r = f32[4,4]{1,0} all-reduce(f32[4,4]{1,0} %p), "
                  "replica_groups={{0,1}}, to_apply=%add",
    "reduce-scatter": "%s = f32[2,4]{1,0} reduce-scatter(f32[4,4]{1,0} %p),"
                      " replica_groups={{0,1}}, dimensions={0}, "
                      "to_apply=%add",
    "all-to-all": "%t = f32[4,4]{1,0} all-to-all(f32[4,4]{1,0} %p), "
                  "replica_groups={{0,1}}, dimensions={0}",
    "collective-permute": "%c = f32[4,4]{1,0} collective-permute(f32[4,4]"
                          "{1,0} %p), source_target_pairs={{0,1},{1,0}}",
}


def _collectives(kind: str, group, functional: bool):
    import torch.distributed._functional_collectives as fc
    x = torch.ones(4, 4)
    if kind == "all-gather":
        if functional:
            fc.wait_tensor(fc.all_gather_tensor(x, 0, group))
        else:
            dist.all_gather([torch.empty(4, 4) for _ in range(2)], x,
                            group=group)
    elif kind == "all-reduce":
        if functional:
            fc.wait_tensor(fc.all_reduce(x, "sum", group))
        else:
            dist.all_reduce(x, group=group)
    elif kind == "reduce-scatter":
        if functional:
            fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0, group))
        else:
            dist.reduce_scatter_tensor(torch.empty(2, 4), x, group=group)
    elif kind == "all-to-all":
        if functional:
            fc.wait_tensor(fc.all_to_all_single(x, None, None, group))
        else:
            dist.all_to_all_single(torch.empty(4, 4), x, group=group)
    else:
        dist.send(x, dst=1, group=group)


@pytest.mark.filterwarnings("ignore::FutureWarning")
@pytest.mark.parametrize("kind,functional", [
    (k, f) for k in sorted(_HLO) for f in (False, True)
    if not (k == "collective-permute" and f)])   # no functional send
def test_collective_link_bytes_follow_jax(kind, functional, jdry,
                                          fake_group):
    """Each kind over the model axis of a fake (2, 2) mesh, through
    ``torch.distributed`` (what ``distributed/comm.py`` calls) and the
    functional collectives (what DTensor calls): count 1 and the link
    bytes JAX's ``parse_collectives`` gives the same collective in HLO."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    with FakeTensorMode():
        cost = StepCost()
        with cost:
            _collectives(kind, mesh.get_group("model"), functional)
    want = jdry.parse_collectives(_HLO[kind])
    assert dict(cost.collectives) == want
    assert cost.collective_bytes == want[kind]["bytes"]


# ---------------------------------------------------------------------------
# (d) the dry run's test preset
# ---------------------------------------------------------------------------

def _smoke_cell(cell: str) -> "JC.ShapeCell":
    return dataclasses.replace(JC.CELLS[cell], seq_len=64, global_batch=4)


def _jax_serve_bytes(arch: str, cell: str):
    """Per-rank ``(param, cache)`` bytes on the JAX package's device
    leaves for a smoke serving cell on the test mesh."""
    jcfg = jax_smoke_config(arch)
    jmodel = jax_build_model(jcfg)
    kind = JC.CELLS[cell].kind
    pstruct = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = _jax_rank_bytes(pstruct, JSH.param_pspecs(
        jmodel, TEST_SIZES, kind), TEST_SIZES)
    sc = _smoke_cell(cell)
    cstruct = jax.eval_shape(lambda: jmodel.init_cache(sc.global_batch,
                                                       sc.seq_len))
    amesh = AbstractMesh(tuple(TEST_SIZES.values()), tuple(TEST_SIZES))
    cshard = JSH.cache_shardings(jcfg, amesh, cstruct, cell == "long_500k")
    cspecs = jax.tree.map(lambda s: s.spec, cshard, is_leaf=lambda s: hasattr(
        s, "spec"))
    cache = _jax_rank_bytes(cstruct, cspecs, TEST_SIZES)
    port = _port_rank_bytes(build_model(get_smoke_config(arch)).init_cache(
        sc.global_batch, sc.seq_len, device="meta"))
    return sum(params.values()), _held_to_jax(port, cache, per_leaf=False)


PRESET = [("qwen2-7b", "train_4k,decode_32k"),
          ("olmoe-1b-7b", "train_4k"),
          ("zamba2-2.7b", "train_4k,long_500k")]


@pytest.mark.parametrize("arch,cells", PRESET)
def test_dryrun_test_preset(tmp_path, arch, cells, jdry):
    """The dry run end to end over 8 fake ranks: exit 0, every cell's
    record with FLOPs, a peak and 8 devices, its per-rank bytes JAX's at
    smoke size, and its telemetry stream valid under both packages'
    validators."""
    from repro.telemetry import validate_dir as jax_validate_dir
    from repro_torch.telemetry import validate as port_validate
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tel = tmp_path / "tel"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--preset",
         "test", "--arch", arch, "--cell", cells, "--out",
         str(tmp_path / "out"), "--force", "--telemetry-dir", str(tel),
         "--trace-dir", str(tel)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "all dry-run cells compiled" in out.stdout
    recs = {json.loads(p.read_text())["cell"]: json.loads(p.read_text())
            for p in (tmp_path / "out").glob("*.json")}
    assert sorted(recs) == sorted(cells.split(","))
    for cell, rec in recs.items():
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["stored_bytes"]
        assert rec["memory"]["peak_bytes"] > 0
        assert rec["devices"] == 8 and rec["route"] == "plain"
        assert rec["collective_bytes"] > 0
        assert rec["mesh_shape"] == TEST_SIZES
        if rec["kind"] == "train":
            want_p, want_o = _jax_train_bytes(jdry, arch, TEST_SIZES,
                                              smoke=True)
            assert rec["param_bytes"] == sum(want_p.values())
            model = build_model(get_smoke_config(arch))
            # which leaves the port holds on the host, from its state's
            # structure (whole, on meta tensors)
            state = D.dryrun_optimizer(arch).init(SH.param_structs(model))
            assert rec["opt_state_bytes"] == _held_to_jax(
                _port_rank_bytes(state), want_o, per_leaf=False)
            assert rec["cache_bytes"] == 0
            # tokens (4, 64) over the dp axes (pod, data): one row a rank
            assert rec["batch_bytes"] == 64 * 8
        else:
            params, cache = _jax_serve_bytes(arch, cell)
            assert (rec["param_bytes"], rec["cache_bytes"]) == (params,
                                                                cache)
            assert rec["opt_state_bytes"] == 0
            rows = 4 if cell == "long_500k" else 1
            assert rec["batch_bytes"] == rows * 8
    assert port_validate.main([str(tel)]) == 0
    assert jax_validate_dir(str(tel)) >= len(recs) + 1
    kinds = [json.loads(line)["kind"] for p in tel.glob("events-*.jsonl")
             for line in p.read_text().splitlines()]
    assert kinds.count("dryrun_cell") == len(recs)
    assert kinds.count("span") >= 3 * len(recs)


def test_cached_records_only_for_their_mesh_and_preset(tmp_path, capsys,
                                                      fake_group):
    """``--preset test`` and a full-size run of the same cell into one
    ``--out`` keep two records, each reused only by its own kind of run;
    a record made for another mesh is made anew."""
    out = tmp_path / "out"
    args = ["--arch", "mamba2-370m", "--cell", "decode_32k", "--out",
            str(out)]

    def run(*extra):
        D.main(args + list(extra))
        lines = [x for x in capsys.readouterr().out.splitlines()
                 if x.startswith("OK ")]
        assert len(lines) == 1, lines
        return lines[0].endswith(", cached)")

    assert not run("--preset", "test")
    smoke = D.record_path(out, "mamba2-370m", "decode_32k", "pod", True)
    full = D.record_path(out, "mamba2-370m", "decode_32k", "pod")
    assert smoke.exists() and not full.exists()
    assert not run()
    recs = {p: json.loads(p.read_text()) for p in (smoke, full)}
    assert (recs[smoke]["devices"], recs[smoke]["preset"]) == (8, "test")
    assert (recs[full]["devices"], recs[full]["preset"]) == (256, None)
    assert recs[full]["mesh_shape"] == MESHES["pod"]
    assert run("--preset", "test") and run()
    # a record of another mesh under the full run's name: made anew
    full.write_text(json.dumps(recs[smoke]))
    assert not run()
    assert json.loads(full.read_text())["devices"] == 256
    assert run("--force") is False


def test_importing_the_dry_run_starts_nothing():
    """Importing the dry run (and its mesh module) starts no process group
    and changes no environment variable; a fake mesh then starts one of
    the mesh's size, and a real group refuses a fake mesh."""
    code = (
        "import os, sys\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch.dryrun\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "assert dict(os.environ) == before\n"
        "assert 'torch.testing._internal.distributed.fake_pg' not in "
        "sys.modules\n"
        "from repro_torch.launch.mesh import make_fake_mesh\n"
        "m = make_fake_mesh((2, 16, 16), ('pod', 'data', 'model'))\n"
        "assert dist.get_world_size() == 512 and m.size() == 512\n"
        "dist.destroy_process_group()\n"
        "dist.init_process_group('gloo', init_method='tcp://localhost:'\n"
        "    + str(__import__('repro_torch.launch.mesh', fromlist=['x'])"
        "._free_port()), rank=0, world_size=1)\n"
        "try:\n"
        "    make_fake_mesh((2, 2), ('data', 'model'))\n"
        "    raise SystemExit('a fake mesh beside a real group')\n"
        "except RuntimeError as e:\n"
        "    assert 'process of its own' in str(e)\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", \
        out.stderr[-2000:]


def test_probe_memory_stages_bisect_the_step(fake_group):
    """``tools/probe_memory.py``'s stages on a smoke train cell over 8
    fake ranks: each peaks above the placed state it starts from, the
    forward below the gradients, the whole step at least as high as the
    forward and the update."""
    from repro_torch.tools import probe_memory as PM
    mesh = make_fake_mesh(*D.TEST_MESH)
    peaks = {}
    for stage in PM.STAGES:
        peak, held = PM.stage_peak(
            D.build_cell("qwen2-7b", "train_4k", mesh, smoke=True), stage)
        assert peak > held > 0
        peaks[stage] = peak
    assert peaks["fwd"] < peaks["grad"]
    assert peaks["train"] >= max(peaks["fwd"], peaks["opt"])
