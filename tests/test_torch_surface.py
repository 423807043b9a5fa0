"""The port's package surface and its tools, against the JAX package.

  * Exports: every name that a JAX package ``src/repro/<pkg>/__init__.py``
    imports (read with ``ast``) is an attribute of ``repro_torch.<pkg>``,
    for all eleven packages, with no exception.  The chain functions
    ``adapprox`` / ``adamw`` / ``adafactor`` / ``came`` / ``sketch`` are
    the package's names, as in JAX; the modules of the same names stay
    reachable through ``importlib``.  Importing ``repro_torch.kernels``
    builds and loads no CUDA library, and the packages import in any
    order in a fresh interpreter (``core`` imports ``kernels.ops``, which
    imports ``core.quantized``).
  * ``rank_metrics``: three steps of ``examples/quickstart.py``'s
    optimizer config (rank_mode "paper", k_max 16) on the GPT-2 smoke
    model's leaves, from JAX's init with JAX's S-RSI draws injected
    (``SketchSource``): the mean rank exact, the mean xi within 1e-5
    relative of JAX's ``rank_metrics``.  A partition state (the
    launcher's mixed groups), int8 and bucketed states count the same
    way, and a state with no factored leaf gives ``{}``.
  * ``repro_torch.tools.traceview`` against JAX's ``tools/traceview.py``
    on one event directory from the port's train loop: the same text,
    the same ``--check`` exit codes there and on a copy with an orphaned
    span, equal ``--chrome-trace`` JSON.
  * ``repro_torch.tools.hillclimb --preset test``: its counts are
    ``dryrun.measure``'s of the same cell, its overrides move what they
    should, its roofline terms are the counts over the H100 constants
    the module names, and it holds no TPU figure.
"""
import ast
import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.telemetry as JT
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.core import build_optimizer as jax_build_optimizer
from repro.core import rank_metrics as jax_rank_metrics
from repro.core.factored import should_factor as jax_should_factor
from repro_torch import tree
from repro_torch import telemetry as T
from repro_torch.config import OptimizerConfig
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import (adamw, adapprox, adapprox_state,
                              build_optimizer, make_optimizer, rank_metrics)
from repro_torch.core.factored import FactoredLeaf
from repro_torch.core.quantized import QuantizedMatrix
from repro_torch.core.transform import PartitionState
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.train import optimizer_config
from repro_torch.models.model_zoo import build_model
from repro_torch.tools import hillclimb, traceview
from repro_torch.train.train_loop import LoopConfig, train
from test_torch_parity import _grads, _jax_params
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("core", "data", "distributed", "models", "train", "kernels",
            "configs", "resilience", "telemetry", "serve", "checkpoint")
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

def _jax_exports(pkg: str) -> list:
    """The names ``src/repro/<pkg>/__init__.py`` imports from the JAX
    package (its public surface)."""
    src = (ROOT / "src" / "repro" / pkg / "__init__.py").read_text()
    return [a.asname or a.name for node in ast.parse(src).body
            if isinstance(node, ast.ImportFrom) and node.module
            and node.module.split(".")[0] == "repro"
            for a in node.names]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_every_jax_name(pkg):
    names = _jax_exports(pkg)
    assert names, pkg
    mod = importlib.import_module(f"repro_torch.{pkg}")
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"repro_torch.{pkg} lacks {missing}"


def test_chain_functions_shadow_their_modules():
    """As in JAX, ``repro_torch.core.adapprox`` is the chain function; the
    module stays reachable by ``importlib``, and ``make_optimizer`` builds
    the same chain."""
    mod = importlib.import_module("repro_torch.core.adapprox")
    assert callable(adapprox) and adapprox is mod.adapprox
    assert mod.rank_metrics is rank_metrics
    assert adamw is importlib.import_module("repro_torch.core.adamw").adamw
    params = {"w": torch.zeros(64, 64)}
    assert (type(make_optimizer("adapprox").init(params))
            is type(adapprox(mod.AdapproxConfig()).init(params)))


def _fresh(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("first", ["repro_torch.kernels", "repro_torch.core",
                                   "repro_torch.telemetry",
                                   "repro_torch.kernels.ops",
                                   "repro_torch.core.adapprox"])
def test_packages_import_in_any_order(first):
    out = _fresh(
        "import importlib\n"
        f"importlib.import_module({first!r})\n"
        f"for p in {PACKAGES!r}:\n"
        "    importlib.import_module('repro_torch.' + p)\n"
        "import repro_torch.core as C, repro_torch.kernels as K\n"
        "assert callable(C.adapprox) and callable(K.ops.fused_apply)\n"
        "print('ok')\n")
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_kernels_package_loads_no_cuda_library():
    """Importing the kernels package (and the core, which imports it)
    builds nothing and opens no shared library: each wrapper loads its
    kernel's library at its first launch."""
    out = _fresh(
        "import ctypes, importlib, torch\n"
        "opened = []\n"
        "real = ctypes.CDLL\n"
        "ctypes.CDLL = lambda *a, **k: opened.append(a) or real(*a, **k)\n"
        "import repro_torch.kernels, repro_torch.core\n"
        "from repro_torch.kernels import cuda\n"
        "libs = [importlib.import_module('repro_torch.kernels.' + m)._LIB\n"
        "        for m in ('fused_update', 'lowrank_update', 'srsi_matmul',\n"
        "                  'sketch_update', 'flash_attention', 'ssd_chunk')]\n"
        "print(len(opened), len(cuda.BUILD_LOG), libs.count(None))\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "0", "6"]


# ---------------------------------------------------------------------------
# rank_metrics
# ---------------------------------------------------------------------------

QUICKSTART_MIN_DIM = 32


def _quickstart_opt(cls, steps=3):
    """``examples/quickstart.py``'s optimizer config."""
    return cls(name="adapprox", lr=3e-3, schedule="cosine", warmup_steps=10,
               total_steps=steps, min_lr=0.0, b1=0.9, weight_decay=0.1,
               k=1, k_max=16, rank_mode="paper", xi_thresh=0.01, delta_s=10,
               min_dim_factor=QUICKSTART_MIN_DIM, implicit=False)


class _JaxDraws:
    """The S-RSI draws JAX's Adapprox makes for leaf ``i`` at step ``t``
    (``fold_in(fold_in(PRNGKey(0), t), i)``, split once per matrix of a
    stacked leaf), in the order the port asks for them: every refresh
    step (all of them at the default cadence), factored leaves in flatten
    order."""

    def __init__(self, flat_shapes, steps):
        fact = [i for i, s in enumerate(flat_shapes)
                if jax_should_factor(s, QUICKSTART_MIN_DIM)]
        self.calls = [(t, i) for t in range(1, steps + 1) for i in fact]

    def __call__(self, shape, generator):
        t, i = self.calls.pop(0)
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(0), t), i)
        *bd, n, r = shape
        keys = jax.random.split(key, int(np.prod(bd))) if bd else [key]
        draws = np.stack([np.asarray(jax.random.normal(k, (n, r),
                                                       jnp.float32))
                          for k in keys])
        return torch.tensor(draws.reshape(tuple(shape)))


def test_rank_metrics_matches_jax_on_quickstart_config():
    steps = 3
    _, params_np = _jax_params()
    flat_np = tree.flatten(params_np)
    draws = _JaxDraws([v.shape for v in flat_np.values()], steps)
    jopt = jax_build_optimizer(_quickstart_opt(JOptimizerConfig, steps))
    topt = build_optimizer(_quickstart_opt(OptimizerConfig, steps),
                           sketch=draws)
    jparams = jax.tree.map(jnp.asarray, params_np)
    tparams = tree.flatten(params_from_numpy(params_np))
    jst, tst = jopt.init(jparams), topt.init(tparams)
    jupdate = jax.jit(jopt.update)
    for t in range(1, steps + 1):
        g_np = _grads(flat_np, t)
        jg = tree.unflatten({k: jnp.asarray(v) for k, v in g_np.items()})
        _, jst = jupdate(jg, jst, jparams)
        _, tst = topt.update({k: torch.tensor(v) for k, v in g_np.items()},
                             tst, tparams)
        want = {k: float(v) for k, v in jax_rank_metrics(jst).items()}
        got = rank_metrics(tst)
        assert set(got) == set(want) == {"adapprox/mean_rank",
                                         "adapprox/mean_xi"}
        for v in got.values():
            assert v.dim() == 0 and v.dtype == torch.float32
            assert v.device == CPU
        assert float(got["adapprox/mean_rank"]) == want["adapprox/mean_rank"]
        np.testing.assert_allclose(float(got["adapprox/mean_xi"]),
                                   want["adapprox/mean_xi"], rtol=1e-5)
    assert not draws.calls


def _manual(state) -> tuple:
    """Mean over factored leaves of each leaf's mean k and mean xi, in
    float64 from the host."""
    fact = [leaf for leaf in adapprox_state(state).leaves
            if isinstance(leaf, FactoredLeaf)]
    return (np.mean([leaf.k.double().mean().item() for leaf in fact]),
            np.mean([leaf.xi.double().mean().item() for leaf in fact]))


def _smoke_run(ocfg, steps=2):
    cfg = get_smoke_config("gpt2-117m", max_seq_len=64)
    state, _ = train(build_model(cfg), build_optimizer(ocfg),
                     DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2),
                     LoopConfig(total_steps=steps, log_every=1), device=CPU)
    return state.opt_state


@pytest.mark.parametrize("kind", ["partition", "int8", "bucketed"])
def test_rank_metrics_counts_every_state_kind(kind):
    """The launcher's mixed groups (a partition), int8 factors and a
    bucketed stage: the same means as the leaves give, and the same as
    the bare ``AdapproxState``'s."""
    kw = dict(refresh_every=2, mixed_groups=True, embedding_min_rows=256,
              sketch_width=256, sketch_depth=2)
    if kind == "int8":
        kw["quantize_factors"] = True
    if kind == "bucketed":
        kw.update(bucketed=True, warm_start=True)
    opt_state = _smoke_run(optimizer_config("adapprox", 2, 3e-3, **kw))
    assert isinstance(opt_state, PartitionState)
    leaves = adapprox_state(opt_state).leaves
    if kind == "int8":
        assert any(isinstance(leaf.q, QuantizedMatrix) for leaf in leaves
                   if isinstance(leaf, FactoredLeaf))
    got = rank_metrics(opt_state)
    bare = rank_metrics(adapprox_state(opt_state))
    assert {k: float(v) for k, v in got.items()} == {
        k: float(v) for k, v in bare.items()}
    rank, xi = _manual(opt_state)
    assert float(got["adapprox/mean_rank"]) == pytest.approx(rank, rel=1e-7)
    assert float(got["adapprox/mean_xi"]) == pytest.approx(xi, rel=1e-6)


def test_rank_metrics_empty_without_factored_leaves():
    params = {"b": torch.zeros(8), "w": torch.zeros(64, 64)}
    assert rank_metrics(make_optimizer("adamw").init(params)) == {}
    assert rank_metrics(make_optimizer("adapprox").init(
        {"b": torch.zeros(8)})) == {}
    assert rank_metrics({}) == {}


# ---------------------------------------------------------------------------
# traceview
# ---------------------------------------------------------------------------

def _jax_traceview():
    spec = importlib.util.spec_from_file_location(
        "jax_traceview", ROOT / "tools" / "traceview.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def loop_events(tmp_path_factory):
    """Span events of the port's train loop: 4 smoke steps with a
    checkpoint save every 2."""
    from repro_torch.checkpoint import CheckpointConfig
    d = tmp_path_factory.mktemp("trace")
    sink = T.TelemetrySink(T.SinkConfig(directory=str(d / "events")))
    tracer = T.Tracer(sink=sink)
    cfg = get_smoke_config("gpt2-117m", max_seq_len=32)
    train(build_model(cfg), make_optimizer("adamw"),
          DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2),
          LoopConfig(total_steps=4, log_every=1, ckpt=CheckpointConfig(
              directory=str(d / "ckpt"), save_every=2, async_save=False)),
          device=CPU, tracer=tracer)
    tracer.flush()
    sink.close()
    return d / "events"


def _both(capsys, argv):
    """Each viewer's exit code and printed text (stdout, stderr)."""
    out = []
    for main in (traceview.main, _jax_traceview().main):
        rc = main(list(argv))
        text = capsys.readouterr()
        out.append((rc, text.out, text.err))
    return out


def test_traceview_prints_what_jax_prints(loop_events, capsys, tmp_path):
    port, jax_ = _both(capsys, [str(loop_events), "--check"])
    assert port == jax_
    assert port[0] == 0 and "train_step" in port[1]
    assert "check OK" in port[1]
    assert T.validate_dir(loop_events) == JT.validate_dir(loop_events) > 0


def test_traceview_check_fails_on_an_orphan_as_jax_does(loop_events, capsys,
                                                        tmp_path):
    bad = tmp_path / "bad"
    shutil.copytree(loop_events, bad)
    events = T.load_events(bad)
    span = next(e for e in events if e["kind"] == "span")
    orphan = dict(span, span="orphan", parent="no-such-span")
    f = sorted(bad.glob("events-*.jsonl"))[-1]
    with f.open("a") as fh:
        fh.write(json.dumps(orphan) + "\n")
    port, jax_ = _both(capsys, [str(bad), "--check"])
    assert port == jax_
    assert port[0] == 1 and "CHECK FAILED" in port[2]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert [r[0] for r in _both(capsys, [str(empty)])] == [1, 1]


def test_traceview_chrome_trace_equals_jax(loop_events, capsys, tmp_path):
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    assert traceview.main([str(loop_events), "--chrome-trace", str(a)]) == 0
    assert _jax_traceview().main([str(loop_events), "--chrome-trace",
                                  str(b)]) == 0
    capsys.readouterr()
    assert json.loads(a.read_text()) == json.loads(b.read_text())


def test_serve_waterfalls_match_jax():
    events = [
        {"schema": 1, "kind": "span", "name": "request", "trace": "t1",
         "span": "root", "t0_s": 0.0, "dur_s": 0.5, "uid": 1,
         "attrs": {"tokens": 4}},
        {"schema": 1, "kind": "span", "name": "prefill_chunk", "trace": "t1",
         "span": "a", "parent": "root", "t0_s": 0.1, "dur_s": 0.1},
        {"schema": 1, "kind": "span", "name": "prefill_chunk", "trace": "t1",
         "span": "b", "parent": "root", "t0_s": 0.2, "dur_s": 0.1},
        {"schema": 1, "kind": "span", "name": "request", "trace": "t0",
         "span": "root", "t0_s": 0.0, "dur_s": 0.2, "uid": 0,
         "attrs": {"rejected": True}}]
    jv = _jax_traceview()
    wf = traceview.serve_waterfalls(events)
    assert wf == jv.serve_waterfalls(events)
    assert wf["rows"][1]["prefill_chunks"] == 2
    for limit in (1, 12):
        assert (traceview.format_waterfalls(wf, limit)
                == jv.format_waterfalls(wf, limit))


# ---------------------------------------------------------------------------
# hillclimb
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_group():
    """The fake process group the tool's meshes start; torn down after
    (it cannot share the worker with a real group)."""
    DR.quiet_redistribute()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


ARCH, CELL = "gpt2-117m", "train_4k"


def test_hillclimb_counts_are_the_dry_runs(fake_group, tmp_path, capsys,
                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    rec = hillclimb.main([ARCH, CELL, "--preset", "test", "--tag", "base"])
    m = DR.measure(DR.build_cell(ARCH, CELL, make_fake_mesh(*DR.TEST_MESH),
                                 smoke=True))
    assert rec["flops"] == m["flops"] > 0
    assert rec["bytes"] == m["bytes_accessed"] > 0
    assert rec["peak_gib"] == m["peak_bytes"] / 2**30
    assert rec["collective_bytes"] == m["collective_bytes"] > 0
    assert rec["t_compute"] == rec["flops"] / 989e12
    assert rec["t_memory"] == rec["bytes"] / 3.35e12
    assert rec["t_collective"] == rec["collective_bytes"] / 450e9
    sites = rec["top_sites"]
    assert len(sites) == 10 and sites == sorted(sites, key=lambda s: -s[1])
    assert sum(b for _, b in sites) <= rec["bytes"]
    assert not any(s.split()[0] == "device" for s, _ in sites)
    saved = json.loads((tmp_path / "experiments" / "perf_torch" /
                        f"{ARCH}__{CELL}__base.json").read_text())
    assert saved["flops"] == rec["flops"] and saved["preset"] == "test"
    assert "t_comp=" in capsys.readouterr().out


def test_hillclimb_overrides_move_what_they_should(fake_group, tmp_path,
                                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    none = hillclimb.main([ARCH, CELL, "--preset", "test", "--set",
                           "remat=none", "--tag", "none"])
    full = hillclimb.main([ARCH, CELL, "--preset", "test", "--set",
                           "remat=full", "--tag", "full"])
    assert none["overrides"] == {"remat": "none"}
    assert none["peak_gib"] > full["peak_gib"]
    assert full["flops"] > none["flops"]       # the forward again
    # the test preset leaves one sequence a data rank on TEST_MESH: a
    # (2, 2) mesh leaves two, which split into 2 microbatches
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    one = hillclimb.measure(ARCH, CELL, mb=1, preset="test", mesh=mesh,
                            tag="mb1")
    two = hillclimb.measure(ARCH, CELL, mb=2, preset="test", mesh=mesh,
                            tag="mb2")
    assert (one["microbatches"], two["microbatches"]) == (1, 2)
    assert two["flops"] == one["flops"]
    assert two["peak_gib"] < one["peak_gib"]
    opt = hillclimb.measure(ARCH, CELL, preset="test",
                            opt_overrides={"b1": 0.0}, tag="b1")
    base = hillclimb.measure(ARCH, CELL, preset="test", tag="b")
    assert opt["opt_overrides"] == {"b1": 0.0}
    assert opt["peak_gib"] < base["peak_gib"]       # no first moment


def test_build_cell_without_overrides_is_the_dry_runs(fake_group):
    mesh = make_fake_mesh(*DR.TEST_MESH)
    a = DR.build_cell(ARCH, CELL, mesh, smoke=True)
    b = DR.build_cell(ARCH, CELL, mesh, smoke=True, overrides={},
                      microbatches=None, opt_overrides=None)
    assert a.cfg == b.cfg and a.microbatches == b.microbatches == 1
    assert dataclasses.replace(a.cfg, remat="dots") == DR.build_cell(
        ARCH, CELL, mesh, smoke=True, overrides={"remat": "dots"}).cfg


def test_hillclimb_names_h100_constants_and_no_tpu_figure():
    src = (ROOT / "src" / "repro_torch" / "tools" / "hillclimb.py"
           ).read_text()
    assert (hillclimb.PEAK_FLOPS, hillclimb.HBM_BW, hillclimb.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert "H100 SXM5 80GB" in src
    numbers = {n.value for n in ast.walk(ast.parse(src))
               if isinstance(n, ast.Constant)
               and isinstance(n.value, (int, float))}
    assert not numbers & {197e12, 819e9, 50e9}     # the JAX tool's TPU's
    for word in ("TPU", "ICI", "v5e"):
        assert word not in src, word
