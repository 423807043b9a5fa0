"""Guards of the PyTorch port: it never falls back to the CPU, never
silently swaps the optimizer the user asked for, refuses the parts that
are not ported yet and the misuse of those that are (and builds and steps
those that are), and never imports JAX or the JAX package."""
import ast
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import telemetry as T
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.config import OptimizerConfig, TelemetryConfig
from repro_torch.core.adafactor import AdafactorState
from repro_torch.core.build import build_optimizer
from repro_torch.core.came import CAMEState
from repro_torch.core.factored import FactoredLeaf
from repro_torch.core.quantized import QuantizedMatrix
from repro_torch.core.sketch import SketchConfig, scale_by_sketch
from repro_torch.core.transform import PartitionState
from repro_torch.device import resolve_device
from repro_torch.launch import train as launcher
from repro_torch.resilience import (GuardConfig, GuardedState, GuardState,
                                    guard_updates)

TA = importlib.import_module("repro_torch.core.adapprox")
ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--smoke", "--steps", "1", "--batch", "2", "--seq", "16"]


def test_launcher_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(SMOKE + ["--no-mixed-groups"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("flags", [[], ["--mixed-groups"]])
def test_mixed_groups_raise_instead_of_switching(flags):
    """--mixed-groups is the adapprox default, as in the JAX launcher:
    with no flag and with the flag the launcher builds the three-family
    partition (sketch on embeddings, Adapprox on matrices, dense Adam on
    the rest) and never silently swaps it for another optimizer."""
    state, _ = launcher.main(SMOKE + ["--device", "cpu",
                                      "--embedding-min-rows", "256",
                                      "--sketch-width", "64"] + flags)
    assert isinstance(state.opt_state, PartitionState)
    assert set(state.opt_state.labels) == {"embeddings", "factored",
                                           "dense"}


@pytest.mark.parametrize("flag", [["--mesh", "2"]])
def test_unported_launcher_flags_raise(flag):
    """--mesh raised NotImplementedError until it was ported; now a mesh
    of two devices in one process raises as JAX's parse_mesh does when
    the devices are missing (one rank a device, started by torchrun)."""
    with pytest.raises(ValueError, match="needs 2 devices"):
        launcher.main(SMOKE + ["--device", "cpu", "--no-mixed-groups"]
                      + flag)


@pytest.mark.parametrize("knob", [dict(telemetry=True),
                                  dict(dynamic_refresh=True)])
def test_unported_adapprox_knobs_raise(knob):
    """Both knobs were refused until the telemetry slice ported them.  Now
    they build and step, and what still raises is their misuse: a cadence
    set on a state that carries none, or one below 1."""
    params = {"w": torch.ones((128, 160)), "b": torch.ones(8)}
    state = _step_twice(TA.scale_by_adapprox(TA.AdapproxConfig(
        min_dim_factor=64, **knob)), params)
    if "telemetry" in knob:
        assert state.telemetry.step == 2 and state.refresh_every is None
        with pytest.raises(ValueError, match="dynamic_refresh"):
            T.set_refresh_every(state, {"default": 2})
    else:
        assert state.telemetry is None and state.refresh_every == 1
        with pytest.raises(ValueError, match=">= 1"):
            T.set_refresh_every(state, 0)


def _factored_leaves(state):
    return [leaf for leaf in TA.adapprox_state(state).leaves
            if isinstance(leaf, FactoredLeaf)]


def _step_twice(opt, params):
    """Init ``opt`` on ``params`` and take two steps with fixed grads;
    every update must be finite."""
    state = opt.init(params)
    for _ in range(2):
        upd, state = opt.update({k: 1e-2 * v for k, v in params.items()},
                                state, params)
        assert all(bool(torch.isfinite(x).all()) for x in upd.values())
    return state


@pytest.mark.parametrize("way", [
    "--quantize-factors", "factor_dtype", "use_kernels", "--warm-start",
    "--bucketed", "implicit", "bucketed", "warm_start", "adafactor", "came",
    "OptimizerConfig()", "--guards", "--ckpt-dir", "guards=",
    "guards=True"])
def test_ported_knobs_build_their_state(way, tmp_path):
    """--quantize-factors (launcher) and factor_dtype="int8" (config) store
    int8 factors; use_kernels, implicit, warm_start and bucketed build and
    step with fp32 factors; --warm-start and --bucketed run in the
    launcher; build_optimizer builds the adafactor and came families and
    the default OptimizerConfig() (implicit=True); --guards (launcher),
    guards=GuardConfig() (AdapproxConfig) and guards=True
    (OptimizerConfig) build and step the skip-step guard and the xi
    watchdog; --ckpt-dir writes a checkpoint.  Each raised
    NotImplementedError until it was ported."""
    if way.startswith("--"):
        argv = SMOKE + ["--device", "cpu", "--no-mixed-groups", way]
        if way == "--warm-start":      # step 2 is a warm refresh
            argv[argv.index("--steps") + 1] = "2"
        if way == "--ckpt-dir":
            argv.append(str(tmp_path))
        state, hist = launcher.main(argv)
        leaves = _factored_leaves(state.opt_state)
        assert hist and leaves
        if way == "--guards":
            assert isinstance(state.opt_state, GuardedState)
            assert state.opt_state.steps == 1
            assert TA.adapprox_state(state.opt_state).guards is not None
        if way == "--ckpt-dir":
            assert CheckpointManager(CheckpointConfig(
                directory=str(tmp_path))).latest_step() == 1
        if way == "--quantize-factors":
            assert all(isinstance(leaf.q, QuantizedMatrix)
                       and isinstance(leaf.u, QuantizedMatrix)
                       for leaf in leaves)
        else:
            assert all(bool(torch.isfinite(leaf.q).all()) for leaf in leaves)
        return
    params = {"w": torch.ones((128, 160)), "w2": torch.ones((128, 160)),
              "b": torch.ones(8)}
    if way == "guards=":
        # a guarded Adapprox runs inside the skip-step guard, which
        # advances its watchdog's counters
        state = TA.adapprox_state(_step_twice(guard_updates(
            TA.scale_by_adapprox(TA.AdapproxConfig(
                min_dim_factor=64, guards=GuardConfig(max_demotions=1)))),
            params))
        assert isinstance(state.guards, GuardState) and state.pending is None
        assert state.guards.trips.shape == (2,)
        assert len(state.guards.dense_v) == 2
        assert len(_factored_leaves(state)) == 2
        return
    if way == "guards=True":
        state = _step_twice(build_optimizer(OptimizerConfig(
            guards=True, min_dim_factor=64)), params)
        assert isinstance(state, GuardedState) and state.steps == 2
        assert state.skipped == 0 and len(_factored_leaves(state)) == 2
        return
    if way in ("adafactor", "came", "OptimizerConfig()"):
        cfg = (OptimizerConfig() if way == "OptimizerConfig()"
               else OptimizerConfig(name=way, min_dim_factor=64))
        state = _step_twice(build_optimizer(cfg), params)
        if way == "OptimizerConfig()":
            assert cfg.implicit and len(_factored_leaves(state)) == 2
            return
        (sub,) = [s for s in state
                  if isinstance(s, (AdafactorState, CAMEState))]
        assert isinstance(sub, AdafactorState if way == "adafactor"
                          else CAMEState)
        assert sub.step == 2 and sub.leaves[0].r.shape == (128,)
        return
    knob = (dict(factor_dtype="int8") if way == "factor_dtype"
            else {way: True})
    state = _step_twice(TA.scale_by_adapprox(
        TA.AdapproxConfig(min_dim_factor=64, **knob)), params)
    leaves = _factored_leaves(state)
    quant = way == "factor_dtype"
    assert len(leaves) == 2
    for leaf in leaves:
        assert isinstance(leaf.q, QuantizedMatrix) == quant
        assert (leaf.q.q8 if quant else leaf.q).dtype == (
            torch.int8 if quant else torch.float32)


@pytest.mark.parametrize("change", [dict(telemetry=True),
                                    dict(dynamic_refresh=True)])
def test_build_optimizer_refuses_what_is_not_ported(change):
    """Ported now: build_optimizer builds each knob alone, and the
    closed-loop controller refuses, at the first step, an optimizer that
    lacks the other half (snapshots to observe, a cadence to move)."""
    cfg = dataclasses.replace(OptimizerConfig(implicit=False,
                                              min_dim_factor=64), **change)
    state = _step_twice(build_optimizer(cfg),
                        {"w": torch.ones((128, 160)), "b": torch.ones(8)})
    runtime = T.TelemetryRuntime(TelemetryConfig(enabled=True,
                                                 auto_refresh=True))
    with pytest.raises(ValueError, match="dynamic_refresh=True"
                       if "telemetry" in change else "telemetry=True"):
        runtime.on_step(2, state)


def test_sketch_telemetry_raises():
    """SketchConfig.telemetry builds a snapshot now; reading its host
    copy before a transfer has brought it over raises."""
    opt = scale_by_sketch(SketchConfig(telemetry=True, min_rows=4))
    params = {"e": torch.ones((16, 8))}
    state = opt.init(params)
    _, state = opt.update({"e": torch.ones((16, 8))}, state, params)
    assert state.telemetry.step == 1
    with pytest.raises(RuntimeError, match="read to the host"):
        state.telemetry.host("occupancy")
    T.snapshot.fetch_host([state.telemetry])
    assert 0.0 < float(state.telemetry.host("occupancy")[0]) <= 1.0


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of repro_torch (the telemetry package's too),
    the chunked attention path's entry points (``ops.FlashAttention``, ``sdpa_auto``), the Mamba2
    path's (``ops.SSDChunk``, ``ssd_chunked``, ``SSMLM``), the MoE block's
    (``moe_apply_local``), the chaos tool, the serving engines and
    launcher (``repro_torch.serve``, ``launch.serve``) and chip_smoke.py
    in a fresh interpreter and inspect sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels.ops import FlashAttention\n"
        "from repro_torch.models.attention import sdpa_auto\n"
        "from repro_torch.kernels.ops import SSDChunk\n"
        "from repro_torch.models.mamba2 import ssd_chunked\n"
        "from repro_torch.models.ssm_lm import SSMLM\n"
        "from repro_torch.models.moe import moe_apply_local\n"
        "from repro_torch.tools.chaos import main\n"
        "from repro_torch.serve import ContinuousEngine, Engine\n"
        "from repro_torch.launch.serve import main as serve_main\n"
        "import chip_smoke\n"
        "tel = ('collect', 'controller', 'metrics', 'runtime', 'sink', "
        "'snapshot', 'trace', 'validate')\n"
        "assert all('repro_torch.telemetry.' + m in sys.modules "
        "for m in tel)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_port_examples_import_neither_jax_nor_the_jax_package():
    """The examples under ``examples/torch`` (scripts: what they import
    runs when they run) import nothing from ``jax``, ``jaxlib`` or
    ``repro``, read from their source with ``ast``."""
    files = sorted((ROOT / "examples" / "torch").glob("*.py"))
    assert len(files) == 4
    for f in files:
        mods = set()
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                mods.add(node.module or "")
        bad = sorted(m for m in mods
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, (f.name, bad)
        assert any(m.startswith("repro_torch") for m in mods), f.name


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result;
    alone in a directory (no repro_torch beside it) it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def _qkv(dtype=torch.float32):
    q = torch.zeros((1, 64, 4, 16), dtype=dtype)
    k = torch.zeros((1, 64, 2, 16), dtype=dtype)
    return q, k, k.clone()


def test_flash_attention_wrapper_refuses_cpu_tensors():
    """The CUDA wrappers check before they build or launch anything; the
    dispatch raises for a device that is neither the CPU nor CUDA."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    q, k, v = _qkv()
    lse = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.forward(q, k, v, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.backward(q, k, v, q, lse, q, True)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        FA.forward(*_qkv(torch.float16), True)
    assert FA.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkdv": 0}
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(*(t.to("meta") for t in (q, k, v)))


@pytest.mark.parametrize("fault", ["nvcc fails", "no nvcc"])
def test_flash_attention_build_failure_raises(monkeypatch, tmp_path, fault):
    """A tensor the dispatch sends to the kernel meets a failed build as
    an error, never as the plain version's result."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "kernels")
    if fault == "nvcc fails":
        monkeypatch.setattr(cuda, "_nvcc", lambda: "false")
    else:
        monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(FA, "_LIB", None)
    # stand in for a CUDA tensor: the dispatch picks the kernel, the
    # wrapper's checks pass, and the build is what fails
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(cuda, "check", lambda *a, **kw: None)
    monkeypatch.setattr(cuda, "stream", lambda t: 0)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.flash_attention_fwd(*_qkv(), True)
    assert FA._LIB is None and FA.LAUNCHES["flash_fwd"] == 0


def test_mamba2_launcher_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "mamba2-370m"] + SMOKE
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(argv)
    _, hist = launcher.main(argv + ["--device", "cpu", "--sketch-width",
                                    "64", "--embedding-min-rows", "256"])
    assert len(hist) == 1


def _ssd_inputs(dtype=torch.float32):
    bt, s, h, g, p, n = 1, 16, 2, 1, 4, 4
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt)
    return (z(bt, s, h, p, dt=dtype), z(bt, s, g, n, dt=dtype),
            z(bt, s, g, n, dt=dtype), z(bt, s, h), z(bt, s, h),
            z(bt, 1, h, n, p), z(h))


def test_ssd_chunk_wrapper_refuses_cpu_tensors():
    """The SSD kernels' wrappers check before they build or launch
    anything: CPU tensors and fp16 are refused, nothing is counted."""
    from repro_torch.kernels import ssd_chunk as SSD
    ins = _ssd_inputs()
    with pytest.raises(ValueError, match="CUDA tensor"):
        SSD.forward(*ins)
    with pytest.raises(ValueError, match="CUDA tensor"):
        SSD.backward(*ins, torch.zeros_like(ins[0]))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        SSD.forward(*_ssd_inputs(torch.float16))
    assert SSD.LAUNCHES == {"ssd_fwd": 0, "ssd_bwd_rows": 0,
                            "ssd_bwd_cols": 0}
