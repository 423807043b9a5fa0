"""The port's chaos tool (``python -m repro_torch.tools.chaos``), the
counterpart of the JAX package's ``tools/chaos.py``: with the default
plan (NaN gradients at steps 7, 8 and 19 of 30) it exits 0, and its event
stream passes both packages' validators and carries ``kind="fault"``
events; a plan it cannot test exits 2.  Torch runs on one intra-op
thread (restored after)."""
import json

import pytest

from repro.telemetry import validate_dir as jax_validate_dir
from repro_torch.telemetry import validate as port_validate
from repro_torch.tools import chaos
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)


def test_chaos_tool_default_plan_passes_both_validators(tmp_path, capsys):
    out = tmp_path / "events"
    assert chaos.main(["--out", str(out), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "guard skipped 3 (last at 19)" in printed and "chaos: OK" in printed
    assert port_validate.main([str(out)]) == 0
    assert jax_validate_dir(str(out)) > 0
    events = [json.loads(line) for f in sorted(out.glob("events-*.jsonl"))
              for line in f.read_text().splitlines()]
    faults = [(e["step"], e["event"]) for e in events
              if e["kind"] == "fault"]
    assert faults == [(7, "skip"), (8, "skip"), (19, "skip")]


@pytest.mark.parametrize("plan", [["--nan-steps", ""],
                                  ["--nan-steps", "30"],
                                  ["--nan-steps", "", "--inf-steps", "31"]])
def test_chaos_tool_refuses_a_plan_it_cannot_test(tmp_path, plan):
    """An empty plan, or a fault at or past the last step (30), exits 2
    before it trains."""
    assert chaos.main(["--out", str(tmp_path), "--device", "cpu"]
                      + plan) == 2
    assert not list(tmp_path.iterdir())
