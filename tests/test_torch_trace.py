"""Span tracing, the metrics registry and the launcher's telemetry flags in
the port (``repro_torch.telemetry.trace`` / ``metrics``, the instrumented
loop and checkpoint manager, ``repro_torch.launch.train``), against the
JAX package's tools.

  * Span API (the port's copy): nesting and trace inheritance, attrs,
    after-the-fact records, the preemption drain emitting once, the null
    tracer; the events pass both packages' validators, and the analysis
    helpers (``span_stats``, ``chrome_trace``, ``check_events``) read the
    same events as JAX's.
  * Train loop: a ``train_step`` span a step with ``data_wait`` /
    ``step_dispatch`` / ``device_sync`` children; tracing is bitwise
    invisible; refresh and fold steps are told apart by the snapshot's
    host counters; checkpoint save and restore spans.
  * Metrics: ``render`` / ``parse_prometheus`` round trip against the JAX
    package's parser both ways; the snapshot is a valid ``kind="metric"``
    event; the loop's metric cadence.
  * Launcher: ``--telemetry-dir D --trace-dir D --metrics-every N
    --auto-refresh`` on a CPU smoke run: the stream passes both
    validators and both viewers' ``--check`` (the port's
    ``repro_torch.tools.traceview`` and JAX's ``tools/traceview.py``), ``metrics.prom``
    parses with both parsers; ``--auto-refresh`` alone builds the
    dynamic cadence; ``--mesh 2`` in one process raises.

Not ported: JAX's ``test_bench_trace_overhead_within_3pct`` (a CPU
wall-time ratio of a committed benchmark); the port's overhead is
measured on the card (``chip_smoke.py`` ``[telemetry]``).
"""
import importlib.util
from pathlib import Path

import pytest
import torch

import repro.telemetry as JT
from repro_torch import telemetry as T
from repro_torch.checkpoint import CheckpointConfig
from repro_torch.config import OptimizerConfig
from repro_torch.core.build import build_optimizer
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as launcher
from repro_torch.telemetry import validate as validate_cli
from repro_torch.telemetry.trace import ROOT_SPAN
from repro_torch.tools import traceview
from repro_torch.train.train_loop import LoopConfig, train
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _traceview_check(directory) -> int:
    """``python -m repro_torch.tools.traceview --check DIRECTORY``'s exit
    code, in process."""
    return traceview.main([str(directory), "--check"])


def _jax_traceview_check(directory) -> int:
    """The JAX package's ``tools/traceview.py --check DIRECTORY``'s exit
    code, in process: the port's events in JAX's schema."""
    spec = importlib.util.spec_from_file_location(
        "traceview", ROOT / "tools" / "traceview.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main([str(directory), "--check"])


def _tracer(tmp_path, sub="trace"):
    sink = T.TelemetrySink(T.SinkConfig(directory=str(tmp_path / sub)))
    return T.Tracer(sink=sink), sink, tmp_path / sub


def _drain(sink, d):
    sink.flush()
    sink.close()
    return T.load_events(d)


# ---------------------------------------------------------------------------
# span API and analysis
# ---------------------------------------------------------------------------

def test_nesting_inherits_trace_and_parent(tmp_path):
    tracer, sink, d = _tracer(tmp_path)
    with tracer.span("outer") as o:
        with tracer.span("inner", step=7, uid=3, phase="fold") as i:
            assert i.trace == o.trace
    events = _drain(sink, d)
    assert T.validate_dir(d) == JT.validate_dir(d) == 2
    by_name = {e["name"]: e for e in events}
    inner, outer = by_name["inner"], by_name["outer"]
    assert inner["parent"] == outer["span"] and "parent" not in outer
    assert inner["trace"] == outer["trace"]
    assert inner["step"] == 7 and inner["uid"] == 3
    assert inner["attrs"] == {"phase": "fold"}
    assert outer["dur_s"] >= inner["dur_s"] >= 0
    assert T.check_events(events) == JT.check_events(events) == []


def test_record_drain_and_null_tracer(tmp_path):
    """An after-the-fact waterfall rooted at ``ROOT_SPAN``; a span open
    when ``drain_open`` fires is emitted once, truncated; the null tracer
    and a sinkless tracer do nothing."""
    tracer, sink, d = _tracer(tmp_path)
    t = tracer.new_trace("req")
    tracer.record("queued", 0.0, 0.5, t, parent=ROOT_SPAN)
    tracer.record("request", 0.0, 2.0, t, span=ROOT_SPAN)
    cm = tracer.span("interrupted")
    cm.__enter__()
    tracer.drain_open()
    cm.__exit__(None, None, None)
    events = _drain(sink, d)
    assert T.check_events(events) == []
    cut = [e for e in events if e["name"] == "interrupted"]
    assert len(cut) == 1 and cut[0]["truncated"] is True
    with T.NULL_TRACER.span("x") as h:
        h.set(step=1)
    T.NULL_TRACER.record("y", 0, 1, "t")
    T.NULL_TRACER.drain_open()
    with T.Tracer().span("z"):
        pass


def _sp(**kw):
    e = {"kind": "span", "schema": 1, "trace": "t", "t0_s": 0.0,
         "dur_s": 1.0}
    e.update(kw)
    return e


def test_analysis_helpers_read_as_jaxs(tmp_path):
    events = [{"kind": "span", "name": "s", "trace": "t", "span": f"s{i}",
               "t0_s": 0.0, "dur_s": float(i)} for i in range(1, 101)]
    s = T.span_stats(events)["s"]
    assert s == JT.span_stats(events)["s"]
    assert s["count"] == 100 and s["p50_s"] == pytest.approx(50.5)
    bad = [_sp(name="child", span="s1", parent="missing"),
           _sp(name="neg", span="s2", dur_s=-0.1)]
    probs = T.check_events(bad)
    assert probs == JT.check_events(bad)
    assert any("orphaned" in p for p in probs)
    assert any("negative" in p for p in probs)
    tracer, sink, d = _tracer(tmp_path)
    with tracer.span("a", step=1):
        with tracer.span("b"):
            pass
    evs = _drain(sink, d)
    assert T.chrome_trace(evs) == JT.chrome_trace(evs)


# ---------------------------------------------------------------------------
# the train loop and the checkpoint manager
# ---------------------------------------------------------------------------

class _QuadraticModel:
    """The train-loop protocol's smallest model: its 8 x 8 leaf is
    factorable under min_dim_factor=4 (the refresh / fold test)."""

    def init(self, generator):
        del generator
        return {"w": torch.ones((8, 8))}

    def loss(self, params, batch):
        del batch
        loss = torch.sum(torch.square(params["w"])) * 1e-3
        return loss, {"loss": loss}


_DATA = DataConfig(vocab=8, seq_len=4, global_batch=2)


def _adamw():
    return build_optimizer(OptimizerConfig(name="adamw",
                                           schedule="constant", lr=1e-3))


def _adapprox(**kw):
    return build_optimizer(OptimizerConfig(
        name="adapprox", schedule="constant", lr=1e-3, k=2,
        rank_mode="static", min_dim_factor=4, implicit=False,
        refresh_every=2, **kw))


def test_step_spans_and_breakdown(tmp_path):
    tracer, sink, d = _tracer(tmp_path)
    train(_QuadraticModel(), _adamw(), _DATA,
          LoopConfig(total_steps=5, log_every=1), device=CPU, tracer=tracer)
    events = _drain(sink, d)
    assert T.check_events(events) == []
    stats = T.span_stats(events)
    for name in ("train_step", "data_wait", "step_dispatch", "device_sync"):
        assert stats[name]["count"] == 5, name
    steps = {e["span"]: e for e in events if e["name"] == "train_step"}
    for e in events:
        if e["name"] in ("data_wait", "step_dispatch", "device_sync"):
            assert e["parent"] in steps
    bd = T.step_breakdown(events)
    assert bd == JT.step_breakdown(events) and bd["steps"] == 5
    assert sum(p["share"] for p in bd["phases"]) == pytest.approx(1.0)


@pytest.mark.parametrize("opt", ["adamw", "adapprox_telemetry"])
def test_tracing_is_bitwise_invisible(tmp_path, opt):
    """Spans touch no tensor: the trained parameters are bitwise equal
    with tracing (and, for Adapprox, telemetry and metrics) on and off."""
    make = (_adamw if opt == "adamw"
            else lambda: _adapprox(telemetry=True))
    ref, _ = train(_QuadraticModel(), make(), _DATA,
                   LoopConfig(total_steps=4, log_every=2), device=CPU)
    tracer, sink, _ = _tracer(tmp_path)
    traced, _ = train(_QuadraticModel(), make(), _DATA,
                      LoopConfig(total_steps=4, log_every=2), device=CPU,
                      tracer=tracer, metrics_every=2)
    sink.close()
    assert torch.equal(ref.params["w"], traced.params["w"])


def test_refresh_vs_fold_attribution(tmp_path):
    """refresh_every 2: steps 1 and 3 refresh, 2 and 4 fold, read from
    the snapshot's host counters; the breakdown splits them."""
    tracer, sink, d = _tracer(tmp_path)
    train(_QuadraticModel(), _adapprox(telemetry=True), _DATA,
          LoopConfig(total_steps=4, log_every=1), device=CPU, tracer=tracer)
    events = _drain(sink, d)
    steps = sorted((e for e in events if e["name"] == "train_step"),
                   key=lambda e: e["step"])
    assert [e["attrs"]["phase"] for e in steps] == ["refresh", "fold",
                                                    "refresh", "fold"]
    assert set(T.step_breakdown(events)["refresh_vs_fold"]) == {"refresh",
                                                                "fold"}
    # without telemetry the span carries no phase
    tracer, sink, d = _tracer(tmp_path, "off")
    train(_QuadraticModel(), _adapprox(), _DATA,
          LoopConfig(total_steps=2, log_every=1), device=CPU, tracer=tracer)
    assert all("attrs" not in e for e in _drain(sink, d)
               if e["name"] == "train_step")


def test_checkpoint_spans(tmp_path):
    tracer, sink, d = _tracer(tmp_path)
    ck = CheckpointConfig(directory=str(tmp_path / "ck"), save_every=2,
                          async_save=False)
    train(_QuadraticModel(), _adamw(), _DATA,
          LoopConfig(total_steps=4, log_every=2, ckpt=ck), device=CPU,
          tracer=tracer)
    train(_QuadraticModel(), _adamw(), _DATA,
          LoopConfig(total_steps=5, log_every=2, ckpt=ck), device=CPU,
          tracer=tracer)
    events = _drain(sink, d)
    assert T.check_events(events) == []
    stats = T.span_stats(events)
    for name in ("checkpoint_save", "ckpt_gather", "ckpt_write"):
        assert stats[name]["count"] >= 2, name
    assert stats["ckpt_restore"]["count"] == 1


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _populated(mod):
    reg = mod.MetricsRegistry()
    reg.counter("steps_total", "steps run").inc(7)
    reg.gauge("loss").set(0.125, split="train")
    reg.counter("c").inc(1, path='a"b\\c')
    h = reg.histogram("step_seconds", "step wall", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0):
        h.observe(v)
    return reg


def test_render_parse_round_trips_against_jax():
    """The port's exposition parses with JAX's parser and JAX's with the
    port's, to the same samples; the snapshot is a valid metric event in
    both packages, keyed by the exposition's sample names."""
    ours, theirs = _populated(T), _populated(JT)
    assert ours.render() == theirs.render()
    parsed = JT.parse_prometheus(ours.render())
    assert parsed == T.parse_prometheus(theirs.render())
    s = parsed["samples"]
    assert s["steps_total"] == 7 and s['loss{split="train"}'] == 0.125
    assert s['c{path="a\\"b\\\\c"}'] == 1
    assert s['step_seconds_bucket{le="1"}'] == 2
    assert s["step_seconds_sum"] == pytest.approx(2.55)
    ev = ours.snapshot(t_s=1.25, step=7)
    JT.validate_event(dict(ev, schema=1))
    T.validate_event(dict(ev, schema=1))
    for k in list(ev["counters"]) + list(ev["gauges"]):
        assert k in s, k
    assert T.DEFAULT_BUCKETS == JT.DEFAULT_BUCKETS


def test_train_loop_metric_cadence(tmp_path):
    """6 steps, metrics_every 2: three registry snapshots in the sink at
    steps 2, 4 and 6, with the loop's counter, histogram and gauge."""
    sink = T.TelemetrySink(T.SinkConfig(directory=str(tmp_path)))
    reg = T.MetricsRegistry()
    train(_QuadraticModel(), _adamw(), _DATA,
          LoopConfig(total_steps=6, log_every=3), device=CPU,
          tracer=T.Tracer(sink=sink, registry=reg), metrics_every=2)
    sink.close()
    assert JT.validate_dir(tmp_path) > 0
    snaps = [e for e in T.load_events(tmp_path) if e["kind"] == "metric"]
    assert [s["step"] for s in snaps] == [2, 4, 6]
    assert snaps[-1]["counters"]["train_steps_total"] == 6
    assert snaps[-1]["histograms"]["train_step_seconds"]["count"] == 6
    assert "train_loss" in snaps[-1]["gauges"]
    assert reg.counter("train_steps_total").value() == 6


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SMOKE = ["--smoke", "--device", "cpu", "--fused-update", "--refresh-every",
         "3", "--embedding-min-rows", "256", "--sketch-width", "256",
         "--sketch-depth", "2", "--steps", "6", "--log-every", "1"]


def test_launcher_telemetry_flags(tmp_path, capsys):
    """The four flags on a CPU smoke run, one shared stream: both
    validators, both viewers' ``--check`` (the port's
    ``repro_torch.tools.traceview`` and JAX's ``tools/traceview.py``) and
    both Prometheus parsers accept its output; every step has its span,
    phase and optimizer event; the controller is armed (``--auto-refresh``)."""
    d = tmp_path / "events"
    state, hist = launcher.main(SMOKE + [
        "--telemetry-dir", str(d), "--trace-dir", str(d), "--metrics-every",
        "2", "--auto-refresh"])
    assert len(hist) == 6
    n = T.validate_dir(d)
    assert n == JT.validate_dir(d) > 0
    events = T.load_events(d)
    kinds = {e["kind"] for e in events}
    assert kinds == {"optimizer", "sketch", "span", "metric"}
    phases = [e["attrs"]["phase"] for e in sorted(
        (e for e in events if e["kind"] == "span"
         and e["name"] == "train_step"), key=lambda e: e["step"])]
    assert phases == ["refresh", "fold", "fold", "refresh", "fold", "fold"]
    assert T.get_refresh_every(state.opt_state) == {"factored": 3}
    assert _traceview_check(d) == _jax_traceview_check(d) == 0
    text = (d / "metrics.prom").read_text()
    assert (T.parse_prometheus(text) == JT.parse_prometheus(text))
    assert T.parse_prometheus(text)["samples"]["train_steps_total"] == 6
    assert validate_cli.main([str(d)]) == 0
    assert f"OK: {n} events" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--telemetry-dir"], ["--trace-dir"]])
def test_launcher_separate_streams(tmp_path, flags):
    """``--telemetry-dir`` alone writes optimizer events and no spans;
    ``--trace-dir`` alone spans and ``metrics.prom``, and the optimizer
    carries no snapshot."""
    d = tmp_path / "d"
    state, _ = launcher.main(SMOKE[:-4] + ["--steps", "2"] + flags
                             + [str(d)])
    kinds = {e["kind"] for e in T.load_events(d)}
    if flags == ["--telemetry-dir"]:
        assert kinds == {"optimizer", "sketch"}
        assert T.named_snapshots(state.opt_state)
    else:
        assert kinds == {"span"} and (d / "metrics.prom").exists()
        assert T.named_snapshots(state.opt_state) == {}


def test_launcher_mesh_still_raises():
    """--mesh is ported (tests/test_torch_mesh.py); what still raises is a
    mesh of two devices in one process, as JAX's parse_mesh raises when
    the devices are missing."""
    with pytest.raises(ValueError, match="needs 2 devices"):
        launcher.main(SMOKE + ["--mesh", "2"])
