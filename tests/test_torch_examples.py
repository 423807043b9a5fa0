"""The four examples of ``examples/torch`` on the CPU, at few steps.

Each runs in process through its ``main`` with ``--device cpu`` (the only
way onto the CPU), and without ``--device`` on a torch with no GPU it
raises through ``repro_torch.device.resolve_device``:

  * quickstart.py: the loss falls, ``rank_metrics`` gives a mean rank in
    [1, k_max] and a finite mean xi, and the trace passes both packages'
    validators and both trace viewers' ``--check``;
  * elastic_restart.py prints the JAX example's plan line (``plan_remesh``
    is pure, so JAX's gives the same numbers) and a bitwise restore;
  * serve_batched.py: every request's continuous stream equals the same
    request served alone on the wave engine (a one-slot wave).  The
    example's own 4-slot waves mix prompt lengths: the wave engine
    right-aligns a wave's prompts and attends the pad, as JAX's does, so
    those streams are another input's and are not compared;
  * train_gpt2_pile.py (the smoke config) trains, checkpoints, and its
    second run restores at the last step and takes none.
"""
import ast
import importlib.util
from pathlib import Path

import pytest
import torch

import repro.telemetry as JT
from repro.distributed import plan_remesh as jax_plan_remesh
from repro_torch import telemetry as T
from repro_torch.tools import traceview
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
NAMES = ("quickstart", "serve_batched", "elastic_restart", "train_gpt2_pile")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_traceview_main(argv) -> int:
    spec = importlib.util.spec_from_file_location(
        "jax_traceview", ROOT / "tools" / "traceview.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_without_a_gpu_unless_asked(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main([])


@pytest.mark.parametrize("name", NAMES)
def test_example_mirrors_the_jax_example(name):
    """Each port example sits beside the JAX one of its name and imports
    nothing of JAX (``tests/test_torch_guards.py`` checks the imports of
    every file under ``examples/torch``)."""
    assert (ROOT / "examples" / f"{name}.py").exists()
    src = (EXAMPLES / f"{name}.py").read_text()
    assert '"--device"' in src
    assert any(isinstance(n, ast.FunctionDef) and n.name == "main"
               for n in ast.parse(src).body)


def test_quickstart_trains_and_traces(tmp_path, capsys):
    trace = tmp_path / "trace"
    out = _example("quickstart").main(["--steps", "12", "--trace-dir",
                                       str(trace), "--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 12 and losses[-1] < losses[0]
    rm = out["rank_metrics"]
    assert 1 <= rm["adapprox/mean_rank"] <= out["k_max"] == 16
    assert 0 <= rm["adapprox/mean_xi"] < float("inf")
    text = capsys.readouterr().out
    assert "mean_rank" in text and "step-time breakdown" in text
    n = T.validate_dir(trace)
    assert n == JT.validate_dir(trace) == 4 * 12    # four spans a step
    assert traceview.main([str(trace), "--check"]) == 0
    assert _jax_traceview_main([str(trace), "--check"]) == 0


def test_elastic_restart_prints_jax_plan_and_restores_bitwise(capsys):
    out = _example("elastic_restart").main(["--device", "cpu"])
    plan = jax_plan_remesh(available_devices=496, target_model=16)
    text = capsys.readouterr().out
    assert (f"re-mesh plan after node loss: pods={plan.pods} "
            f"data={plan.data} model={plan.model} ({plan.devices} "
            f"devices)") in text
    assert "restored step 123; params bit-identical: True" in text
    assert out["bit_identical"] is True and out["step"] == 123
    assert (out["plan"].pods, out["plan"].data, out["plan"].model) == (
        plan.pods, plan.data, plan.model)


def test_serve_batched_continuous_streams_equal_solo_waves(capsys):
    mod = _example("serve_batched")
    out = mod.main(["--device", "cpu"])
    cont, c_reqs = out["continuous"]
    wave, w_reqs = out["wave"]
    assert [r.uid for r in c_reqs] == [r.uid for r in w_reqs]
    solo = mod.clone(c_reqs)
    mod.Engine(cont.model, cont.params, mod.ServeConfig(
        slots=1, cache_len=mod.CACHE_LEN)).run(solo)
    for c, s in zip(c_reqs, solo):
        assert c.out_tokens == s.out_tokens, f"request {c.uid}"
        assert len(c.out_tokens) == c.max_new_tokens and c.done
    assert all(len(w.out_tokens) == w.max_new_tokens for w in w_reqs)
    assert "p99 gap" in capsys.readouterr().out


def test_train_gpt2_pile_resumes_at_its_last_checkpoint(tmp_path):
    ckpt = tmp_path / "ckpt"
    (state, hist), (again, hist2) = _example("train_gpt2_pile").main(
        ["--steps", "3", "--ckpt-dir", str(ckpt), "--log-every", "1",
         "--device", "cpu"])
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert again.step == state.step == 3 and hist2 == []
    assert sorted(p.name for p in ckpt.iterdir()
                  if p.name.startswith("step_")) == ["step_000000003"]
    for k, v in state.params.items():
        assert torch.equal(v, again.params[k]), k
