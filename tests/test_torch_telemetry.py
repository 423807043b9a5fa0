"""The port's telemetry subsystem (``repro_torch.telemetry``) against the
JAX package's ``repro.telemetry``.

  * Controller: the same synthetic xi sequences (drift then calm, anomaly
    bursts, a mid-interval ``state_dict`` round trip) give identical
    cadence changes and state dicts in both packages.
  * Sink and schema: the schema is JAX's; a port stream passes JAX's
    validator and a JAX stream the port's; rotation; malformed events are
    refused.
  * Snapshots: the GPT-2 smoke model on the launcher's mixed groups,
    fused, refresh_every 3, with JAX's draws, 6 steps: the per-step
    optimizer and sketch events of both runtimes agree (counters and
    clip_rate exactly; xi, k, k_frac, occupancy and overestimate within
    1e-5 absolute); the port's parameters are bitwise those with telemetry off,
    with a constant dynamic cadence, and under the guards.
  * Closed loop: ``auto_refresh`` at interval 2 gives JAX's cadence log
    and parameters within 1e-4 of JAX's (every interval mean at least
    1e-3 from both thresholds, so a tolerance-sized difference cannot
    flip a decision); a run killed mid-interval and restored reproduces
    the log and the parameters bitwise; a JAX checkpoint with controller
    meta in its manifest continues in the port, and a port checkpoint of
    a telemetry-on, dynamic-cadence state passes JAX's deep verify.
  * Host transfers: telemetry and the guards make at most one
    device-to-host copy a step, none under the guards, none on a step
    nothing reads.

Not ported: JAX's ``test_bench_*_overhead_within_3pct``, which pin CPU
wall-time ratios; the port's overhead is measured on the card
(``chip_smoke.py`` ``[telemetry]``).
"""
import dataclasses
import importlib
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.telemetry as JT
from repro.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.checkpoint import serialization as JSER
from repro.config import TelemetryConfig as JTelemetryConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import build_optimizer as jax_build_optimizer
from repro.core.rank import RankConfig as JRankConfig
from repro.data import DataConfig as JDataConfig
from repro.launch.train import optimizer_config as jax_optimizer_config
from repro.models import build_model as jax_build_model
from repro.resilience import GuardConfig as JGuardConfig
from repro.train import LoopConfig as JLoopConfig
from repro.train import TrainState as JTrainState
from repro.train import train as jax_train
from repro_torch import telemetry as T
from repro_torch import tree
from repro_torch.checkpoint import CheckpointConfig
from repro_torch.checkpoint import serialization as SER
from repro_torch.config import OptimizerConfig, TelemetryConfig
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import (adapprox_state_from_numpy,
                                 params_from_numpy, sketch_state_from_numpy)
from repro_torch.core.build import build_optimizer
from repro_torch.core.rank import RankConfig
from repro_torch.core.types import apply_updates
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as launcher
from repro_torch.launch.train import optimizer_config
from repro_torch.models.model_zoo import build_model
from repro_torch.resilience import GuardConfig, guard_updates
from repro_torch.train.train_loop import LoopConfig, train
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

JA = importlib.import_module("repro.core.adapprox")
TA = importlib.import_module("repro_torch.core.adapprox")
JC = importlib.import_module("repro.telemetry.controller")
CPU = torch.device("cpu")
SMALL = dict(embedding_min_rows=256, sketch_width=256, sketch_depth=2)


class KeyedJaxSketch:
    """JAX's S-RSI draws for the (step, leaf) the port's generator stands
    for (``tests/test_torch_resilience.py`` has the same source)."""

    def __init__(self, steps: int, n_leaves: int, seed: int = 0):
        self.seed = seed
        self.table = {
            TA._sketch_generator(seed, t, i, CPU).initial_seed(): (t, i)
            for t in range(1, steps + 1) for i in range(n_leaves)}

    def __call__(self, shape, generator):
        t, i = self.table[generator.initial_seed()]
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(self.seed), t), i)
        *bd, n, r = shape
        keys = jax.random.split(key, int(np.prod(bd))) if bd else [key]
        draws = np.stack([np.asarray(jax.random.normal(k, (n, r),
                                                       jnp.float32))
                          for k in keys])
        return torch.tensor(draws.reshape(tuple(shape)))


def _close(a, b, tol, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(
        a, b, rtol=0, atol=tol * max(float(np.max(np.abs(b))), 1e-30),
        err_msg=what)


def _within(a, b, tol, what):
    """Absolute tolerance, for the snapshots' rates and ratios (xi, k_frac
    and occupancy in [0, 1], the overestimate ratio near 1; k counts)."""
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=tol,
                               err_msg=what)


def _events(directory) -> list:
    return [json.loads(line) for p in sorted(Path(directory).glob(
        "events-*.jsonl")) for line in open(p)]


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

def _scenario(name):
    """(ControllerConfig kwargs, [(step, xi, anomaly)], t0, stop-at)."""
    if name == "drift_then_calm":
        xs = ([(s, 0.8, False) for s in range(1, 11)]
              + [(s, 0.2, False) for s in range(11, 16)]
              + [(s, 0.02, False) for s in range(16, 41)])
        return dict(interval=5, t_min=1, t_max=16, xi_high=0.4, xi_low=0.1,
                    relax_patience=2, relax_add=2), xs, 8, None
    if name == "anomaly_bursts":
        xs = [(s, 0.02, s in (7, 8, 19)) for s in range(1, 31)]
        xs += [(s, 0.5, s == 33) for s in range(31, 41)]
        return dict(interval=4, xi_high=0.3, xi_low=0.05,
                    relax_patience=1), xs, 6, None
    seq = [0.5, 0.4, 0.01, 0.02, 0.6, 0.01, 0.03, 0.01, 0.02, 0.01, 0.01,
           0.02]
    return (dict(interval=4, xi_high=0.3, xi_low=0.05, relax_patience=1),
            [(s, seq[s - 1], False) for s in range(1, 13)], 6, 6)


@pytest.mark.parametrize("scenario", ["drift_then_calm", "anomaly_bursts",
                                      "mid_interval_roundtrip"])
def test_controller_matches_jax(scenario):
    """Both packages' controllers, fed the same (step, xi, anomaly)
    sequence, decide alike at every step and end in equal state dicts;
    the round trip moves both to a fresh controller mid-interval."""
    kw, xs, t0, stop = _scenario(scenario)
    ctls = [T.RefreshController(T.ControllerConfig(**kw)),
            JC.RefreshController(JC.ControllerConfig(**kw))]
    ts, logs = [t0, t0], [[], []]
    for step, xi, anomaly in xs:
        for j, ctl in enumerate(ctls):
            c = ctl.observe(step, "g", xi, ts[j], anomaly=anomaly)
            if c is not None:
                logs[j].append(dataclasses.astuple(c))
                ts[j] = c.new
        if step == stop:
            ctls = [_reloaded(c) for c in ctls]
    assert logs[0] == logs[1] and logs[0], scenario
    assert ctls[0].state_dict() == ctls[1].state_dict()
    if scenario == "anomaly_bursts":
        # the bursts at 7-8 and 19 hold the cadence their intervals would
        # have relaxed; the burst at 33 does not stop the tightening
        steps = [c[0] for c in logs[0]]
        assert 8 not in steps and 20 not in steps and 36 in steps


def _reloaded(ctl):
    """A fresh controller of the same package, loaded from ``ctl``'s state
    dict through JSON (a checkpoint manifest)."""
    fresh = type(ctl)(ctl.cfg)
    fresh.load_state_dict(json.loads(json.dumps(ctl.state_dict())))
    return fresh


def test_controller_loads_a_state_dict_without_anomalies():
    """A manifest written before the anomaly pause has no ``anomalies``:
    both packages load it as 0."""
    state = {"groups": {"g": {"xi_sum": 0.5, "n": 2, "calm": 1}}}
    for ctl in (T.RefreshController(), JC.RefreshController()):
        ctl.load_state_dict(state)
        assert ctl.state_dict()["groups"]["g"]["anomalies"] == 0


def test_telemetry_config_is_jaxs_and_validates():
    assert ([(f.name, f.default) for f in dataclasses.fields(
        TelemetryConfig)] == [(f.name, f.default) for f in
                              dataclasses.fields(JTelemetryConfig)])
    with pytest.raises(ValueError, match="emit_every"):
        TelemetryConfig(emit_every=0)
    with pytest.raises(ValueError, match="rotate_bytes"):
        TelemetryConfig(rotate_bytes=0)
    with pytest.raises(ValueError, match="hysteresis"):
        T.ControllerConfig(xi_low=0.5, xi_high=0.1)


# ---------------------------------------------------------------------------
# sink and schema
# ---------------------------------------------------------------------------

def test_schema_is_jaxs():
    assert T.SCHEMA_VERSION == JT.SCHEMA_VERSION
    assert T.EVENT_SCHEMA == JT.EVENT_SCHEMA


def test_sink_writes_rotates_and_validates_in_both_packages(tmp_path):
    sink = T.TelemetrySink(T.SinkConfig(directory=str(tmp_path),
                                        rotate_bytes=400))
    for i in range(1, 21):
        sink.emit({"kind": "optimizer", "step": i, "group": "g",
                   "refresh_every": 1, "did_refresh": True,
                   "refresh_steps": i, "fold_steps": 0, "clip_rate": 0.5})
    sink.flush()
    sink.close()
    assert len(sink.paths()) > 1, "rotate_bytes=400 should have rotated"
    assert T.validate_dir(tmp_path) == JT.validate_dir(tmp_path) == 20
    assert [e["step"] for e in _events(tmp_path)] == list(range(1, 21))


def test_sink_rotation_sequence_is_monotone(tmp_path):
    for i in (0, 2):
        (tmp_path / f"events-0000{i}.jsonl").write_text(
            '{"kind": "run_meta", "schema": 1, "source": "old-run"}\n')
    sink = T.TelemetrySink(T.SinkConfig(directory=str(tmp_path)))
    sink.emit({"kind": "run_meta", "source": "new-run"})
    sink.close()
    assert (tmp_path / "events-00003.jsonl").exists()
    assert T.validate_dir(tmp_path) == 3


def test_sink_rejects_malformed_events(tmp_path):
    sink = T.TelemetrySink(T.SinkConfig(directory=str(tmp_path)))
    bad = [({"kind": "nope"}, "unknown event kind"),
           ({"kind": "cadence", "step": 1}, "missing required"),
           ({"kind": "run_meta", "source": "x", "extra": 1},
            "unknown field"),
           ({"kind": "cadence", "step": "one", "group": "g", "old": 1,
             "new": 2, "interval_mean_xi": 0.1}, "expected")]
    try:
        for event, match in bad:
            with pytest.raises(ValueError, match=match):
                sink.emit(dict(event))
            with pytest.raises(ValueError, match=match):
                JT.validate_event(dict(event, schema=1))
    finally:
        sink.close()
    p = tmp_path / "events-00099.jsonl"
    p.write_text('{"kind": "run_meta", "schema": 1}\n')
    with pytest.raises(ValueError, match="missing required"):
        T.validate_file(p)


def test_straggler_monitor_emits_to_the_runtime_sink(tmp_path):
    from repro_torch.distributed.straggler import (StragglerConfig,
                                                   StragglerMonitor)
    runtime = T.TelemetryRuntime(TelemetryConfig(enabled=True,
                                                 dir=str(tmp_path)))
    mon = StragglerMonitor(StragglerConfig(window=20, min_steps=5,
                                           persist=2, z_thresh=3.0),
                           sink=runtime.sink)
    for _ in range(10):
        mon.observe(0.1)
    mon.observe(10.0)
    mon.observe(10.0)
    runtime.close()
    kinds = [(e["kind"], e["event"]) for e in _events(tmp_path)]
    assert ("straggler", "flagged") in kinds
    assert ("straggler", "escalated") in kinds
    assert JT.validate_dir(tmp_path) == len(kinds)


# ---------------------------------------------------------------------------
# snapshots on the GPT-2 smoke model, against JAX
# ---------------------------------------------------------------------------

def _smoke_cfgs():
    jcfg = dataclasses.replace(jax_smoke_config("gpt2-117m", max_seq_len=32),
                               dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("gpt2-117m", max_seq_len=32),
                               dtype="float32")
    return jcfg, tcfg


def _jax_run(directory, steps, okw, tkw, ckpt=None):
    jcfg, _ = _smoke_cfgs()
    jmodel = jax_build_model(jcfg)
    init = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    rt = JT.TelemetryRuntime(JTelemetryConfig(enabled=True,
                                              dir=str(directory), **tkw))
    jopt = jax_build_optimizer(jax_optimizer_config(
        "adapprox", steps, 3e-3, telemetry=True, **okw, **SMALL))
    jstate, _ = jax_train(jmodel, jopt, JDataConfig(vocab=jcfg.vocab,
                                                    seq_len=32,
                                                    global_batch=4),
                          JLoopConfig(total_steps=steps, log_every=1,
                                      ckpt=ckpt), telemetry=rt)
    rt.close()
    return init, jstate, rt


def _port_run(init, steps, okw, tkw=None, directory=None, ckpt=None,
              telemetry=True, sketch_steps=None):
    """The port's run from JAX's init with JAX's draws; ``tkw`` None runs
    without a runtime."""
    _, tcfg = _smoke_cfgs()
    opt = build_optimizer(
        optimizer_config("adapprox", steps, 3e-3, telemetry=telemetry,
                         **okw, **SMALL),
        sketch=KeyedJaxSketch(sketch_steps or steps,
                              len(tree.flatten(init))))
    rt = None
    if tkw is not None:
        rt = T.TelemetryRuntime(TelemetryConfig(
            enabled=True, dir=None if directory is None else str(directory),
            **tkw))
    state, _ = train(build_model(tcfg), opt,
                     DataConfig(vocab=tcfg.vocab, seq_len=32,
                                global_batch=4),
                     LoopConfig(total_steps=steps, log_every=1, ckpt=ckpt),
                     device=CPU, params=params_from_numpy(init),
                     telemetry=rt)
    if rt is not None:
        rt.close()
    return state, rt


SNAP_OPT = dict(refresh_every=3, fused_update=True, mixed_groups=True)


@pytest.fixture(scope="module")
def snapshot_runs(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax_events")
    tdir = tmp_path_factory.mktemp("port_events")
    init, _, _ = _jax_run(jdir, 6, SNAP_OPT, {})
    state, _ = _port_run(init, 6, SNAP_OPT, {}, tdir)
    return dict(init=init, jax=_events(jdir), port=_events(tdir),
                state=state, jdir=jdir, tdir=tdir)


def _by_kind(events, kind):
    return [e for e in events if e["kind"] == kind]


def test_snapshot_events_match_jax(snapshot_runs):
    """One optimizer event a step for the Adapprox group ("factored"):
    refreshes at 1 and 4, counters and clip_rate exactly JAX's, xi, k and
    k_frac within 1e-5."""
    jev = _by_kind(snapshot_runs["jax"], "optimizer")
    tev = _by_kind(snapshot_runs["port"], "optimizer")
    assert [e["step"] for e in tev] == list(range(1, 7))
    assert [e["did_refresh"] for e in tev] == [True, False, False, True,
                                               False, False]
    exact = ("step", "group", "refresh_every", "did_refresh",
             "refresh_steps", "fold_steps", "clip_rate", "leaf_indices")
    for a, b in zip(tev, jev):
        assert set(a) == set(b)
        assert {k: a[k] for k in exact} == {k: b[k] for k in exact}
        assert a["group"] == "factored"
        assert a["refresh_steps"] + a["fold_steps"] == a["step"]
        for k in ("xi", "k", "k_frac"):
            _within(a[k], b[k], 1e-5, f"{k} at step {a['step']}")
    assert any(0.0 < e["clip_rate"] for e in tev)


def test_sketch_snapshot_events_match_jax(snapshot_runs):
    jev = _by_kind(snapshot_runs["jax"], "sketch")
    tev = _by_kind(snapshot_runs["port"], "sketch")
    assert [e["step"] for e in tev] == list(range(1, 7))
    for a, b in zip(tev, jev):
        assert set(a) == set(b) and a["group"] == b["group"] == "embeddings"
        assert a["leaf_indices"] == b["leaf_indices"]
        for k in ("occupancy", "overestimate"):
            _within(a[k], b[k], 1e-5, f"{k} at step {a['step']}")
        assert all(v >= 1.0 for v in a["overestimate"])


def test_streams_pass_each_others_validator(snapshot_runs):
    assert JT.validate_dir(snapshot_runs["tdir"]) == len(
        snapshot_runs["port"]) > 0
    assert T.validate_dir(snapshot_runs["jdir"]) == len(
        snapshot_runs["jax"]) > 0


@pytest.mark.parametrize("variant", ["telemetry_off", "dynamic_constant",
                                     "guards"])
def test_port_run_is_bitwise_the_telemetry_run(snapshot_runs, variant):
    """The same run with telemetry off, with a dynamic cadence that stays
    at 3 (no controller), and under the guards (their transfer carries the
    snapshot): every parameter bitwise equal."""
    okw = dict(SNAP_OPT)
    kw = {}
    if variant == "telemetry_off":
        kw["telemetry"] = False
    elif variant == "dynamic_constant":
        okw["dynamic_refresh"] = True
    else:
        okw.update(guards=True, guard_xi_trip=1.0)
    state, _ = _port_run(snapshot_runs["init"], 6, okw, **kw)
    ref = snapshot_runs["state"].params
    for k, p in state.params.items():
        assert torch.equal(p, ref[k]), k


# ---------------------------------------------------------------------------
# every route, on toy parameters
# ---------------------------------------------------------------------------

def _toy_params():
    rng = np.random.default_rng(0)
    return {"b": np.zeros((48,), np.float32),
            "stack": (rng.standard_normal((2, 64, 48)) * 0.02).astype(
                np.float32),
            "w": (rng.standard_normal((64, 48)) * 0.02).astype(np.float32),
            "w2": (rng.standard_normal((64, 48)) * 0.02).astype(np.float32)}


def _toy_grads(t):
    rng = np.random.default_rng(100 + t)
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in _toy_params().items()}


def _toy_cfg(pkg, **kw):
    mod, rank = (TA, RankConfig) if pkg == "port" else (JA, JRankConfig)
    return mod.AdapproxConfig(lr=1e-3, min_dim_factor=32, oversample=2,
                              n_iter=2, rank=rank(k_init=2, k_max=8,
                                                  mode="paper"), **kw)


ROUTES = {"default": {}, "refresh_warm": dict(refresh_every=3,
                                              warm_start=True),
          "bucketed": dict(bucketed=True, refresh_every=2),
          "fused": dict(fused_update=True, refresh_every=2),
          "b1_zero": dict(b1=0.0), "int8": dict(factor_dtype="int8",
                                                fused_update=True),
          "implicit": dict(implicit=True, refresh_every=2),
          "guards_demoted": dict(guards=GuardConfig(xi_trip=1e-6,
                                                    max_demotions=2),
                                 refresh_every=3)}


def _toy_run(route, steps=5, **extra):
    """The port's Adapprox on the toy parameters; returns each step's
    updates and states."""
    cfg = _toy_cfg("port", sketch=KeyedJaxSketch(steps, 4), **ROUTES[route],
                   **extra)
    opt = TA.scale_by_adapprox(cfg)
    if cfg.guards is not None:
        opt = guard_updates(opt)
    params = {k: torch.tensor(v) for k, v in _toy_params().items()}
    state, out = opt.init(params), []
    for t in range(1, steps + 1):
        upd, state = opt.update({k: torch.tensor(v)
                                 for k, v in _toy_grads(t).items()},
                                state, params)
        apply_updates(params, upd)
        out.append((upd, TA.adapprox_state(state)))
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_updates_bitwise_identical_with_telemetry(route):
    """Telemetry on is bitwise telemetry off, and a dynamic cadence left
    at its start is bitwise the static one, on every route (bucketed,
    int8, implicit, the guarded and the demoted included); the counters
    add up and follow the cadence."""
    off = _toy_run(route)
    on = _toy_run(route, telemetry=True)
    dyn = _toy_run(route, telemetry=True, dynamic_refresh=True)
    t_cfg = ROUTES[route].get("refresh_every", 1)
    for t, ((ua, _), (ub, sb), (uc, sc)) in enumerate(zip(off, on, dyn), 1):
        for k in ua:
            assert torch.equal(ua[k], ub[k]) and torch.equal(ua[k], uc[k]), (
                f"{route} step {t} {k}")
        snap = sb.telemetry
        assert snap.step == t and snap.refresh_every == t_cfg
        assert snap.refresh_steps + snap.fold_steps == t
        assert snap.did_refresh == float(TA._refresh_pred(t, t_cfg)
                                         or t_cfg == 1)
        assert snap.leaf_indices == (1, 2, 3) and snap.dense_indices == (0,)
        assert tuple(snap.xi.shape) == (3,) and tuple(
            snap.clip_rate.shape) == (4,)
        assert sc.refresh_every == t_cfg and sc.telemetry.step == t


@pytest.mark.parametrize("route", ["bucketed", "guards_demoted"])
def test_route_snapshots_match_jax(route):
    """The bucketed route and the guarded route that demotes every leaf
    at its second trip, against JAX's snapshot after each step: counters
    and clip_rate exactly, xi / k / k_frac within 1e-5."""
    kw = dict(ROUTES[route], telemetry=True)
    steps = 4
    port = _toy_run(route, steps, telemetry=True)
    if "guards" in kw:
        g = kw.pop("guards")
        kw["guards"] = JGuardConfig(xi_trip=g.xi_trip,
                                    max_demotions=g.max_demotions)
    jopt = JA.scale_by_adapprox(_toy_cfg("jax", **kw))
    jp = {k: jnp.asarray(v) for k, v in _toy_params().items()}
    jst, jupdate = jopt.init(jp), jax.jit(jopt.update)
    for t in range(1, steps + 1):
        ju, jst = jupdate({k: jnp.asarray(v) for k, v in
                               _toy_grads(t).items()}, jst, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        js = jax.device_get(JA.adapprox_state(jst).telemetry)
        ts = port[t - 1][1].telemetry
        assert (ts.step, ts.did_refresh, ts.refresh_steps, ts.fold_steps,
                ts.refresh_every) == (int(js.step), float(js.did_refresh),
                                      int(js.refresh_steps),
                                      int(js.fold_steps),
                                      int(js.refresh_every)), f"step {t}"
        np.testing.assert_array_equal(ts.clip_rate.numpy(), js.clip_rate)
        for k in ("xi", "k", "k_frac"):
            _within(getattr(ts, k).numpy(), getattr(js, k), 1e-5,
                    f"{route} {k} at step {t}")
    if "guards" in kw:
        assert int(port[-1][1].guards.demotions) == 3
        assert np.all(port[-1][1].telemetry.xi.numpy() == 0.0)


def test_collect_names_groups_and_sets_the_cadence():
    """Group names and aggregates as JAX's: a bare chain's instance is
    "default", a partition's its label; the metric keys are JAX's;
    set_refresh_every validates like JAX's."""
    params = {k: torch.tensor(v) for k, v in _toy_params().items()}
    base = dict(name="adapprox", schedule="constant", lr=1e-3, k=8,
                rank_mode="paper", min_dim_factor=32, implicit=False)
    for groups, name in (((), "default"),
                         (launcher.default_mixed_groups(), "factored")):
        opt = build_optimizer(OptimizerConfig(
            telemetry=True, dynamic_refresh=True, groups=groups, **base))
        st = opt.init(params)
        _, st = opt.update({k: torch.tensor(v) for k, v in
                            _toy_grads(1).items()}, st, params)
        assert list(T.named_snapshots(st)) == [name]
        assert T.get_refresh_every(st) == {name: 1}
        keys = set(T.telemetry_metrics(st))
        assert keys == {f"telemetry/{name}/{k}" for k in (
            "mean_xi", "max_xi", "mean_k", "mean_k_frac", "clip_rate",
            "refresh_every", "did_refresh")}
        st2 = T.set_refresh_every(st, 4)
        assert T.get_refresh_every(st2) == {name: 4}
        assert T.get_refresh_every(st) == {name: 1}
        with pytest.raises(ValueError, match="no Adapprox group"):
            T.set_refresh_every(st, {"nope": 2})
        with pytest.raises(ValueError, match=">= 1"):
            T.set_refresh_every(st, {name: 0})
    st = build_optimizer(OptimizerConfig(telemetry=True, **base)).init(params)
    with pytest.raises(ValueError, match="dynamic_refresh"):
        T.set_refresh_every(st, {"default": 2})
    assert T.named_snapshots(build_optimizer(OptimizerConfig(
        **base)).init(params)) == {}


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------

# interval 2 from refresh_every 3: xi 0.138 over steps 1-2 tightens to 1,
# then every interval's mean (0.051 at most) relaxes by 1
LOOP_OPT = dict(refresh_every=3, fused_update=True, mixed_groups=True,
                dynamic_refresh=True)
LOOP_TEL = dict(auto_refresh=True, interval=2, xi_high=0.09, xi_low=0.06,
                relax_patience=1)


@pytest.fixture(scope="module")
def closed_loop(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax_loop")
    tdir = tmp_path_factory.mktemp("port_loop")
    ck = JCheckpointConfig(directory=str(jdir / "ckpt"), save_every=5,
                           async_save=False)
    init, jstate, jrt = _jax_run(jdir, 12, LOOP_OPT, LOOP_TEL, ckpt=ck)
    state, rt = _port_run(init, 12, LOOP_OPT, LOOP_TEL, tdir)
    return dict(init=init, jstate=jstate, jrt=jrt, state=state, rt=rt,
                jdir=jdir, port=_events(tdir))


def _params_close(state, jstate, tol):
    jflat = tree.flatten(jax.device_get(jstate.params))
    for k, p in state.params.items():
        _close(p.detach(), jflat[k], tol, f"param {k}")


def test_closed_loop_matches_jax(closed_loop):
    log = closed_loop["jrt"].cadence_log
    assert closed_loop["rt"].cadence_log == log
    assert log[0] == (2, "factored", 3, 1) and len(log) >= 4, log
    assert all(new == old + 1 for _, _, old, new in log[1:])
    _params_close(closed_loop["state"], closed_loop["jstate"], 1e-4)
    # no interval mean within 1e-3 of a threshold: the decisions are
    # robust to the 1e-5 the snapshots may differ by
    xi = [e["mean_xi"] for e in _by_kind(closed_loop["port"], "optimizer")]
    means = [float(np.mean(xi[i:i + 2])) for i in range(0, 12, 2)]
    for m in means:
        assert min(abs(m - 0.09), abs(m - 0.06)) >= 1e-3, means
    # every refresh where _refresh_pred puts it under the cadence then
    for e in _by_kind(closed_loop["port"], "optimizer"):
        assert e["did_refresh"] == (e["refresh_every"] <= 1 or TA._refresh_pred(
            e["step"], e["refresh_every"]))
    cad = _by_kind(closed_loop["port"], "cadence")
    assert [(c["step"], c["group"], c["old"], c["new"]) for c in cad] == log


def test_jax_checkpoint_with_controller_meta_continues_in_port(
        closed_loop, tmp_path):
    """JAX's step-5 checkpoint (mid-interval: the controller's half
    interval rides its manifest) restored by the port's loop, which
    continues to step 12: JAX's cadence log and parameters within 1e-4."""
    src = Path(closed_loop["jdir"]) / "ckpt" / "step_000000005"
    shutil.copytree(src, tmp_path / src.name)
    meta = json.loads((src / "manifest.json").read_text())["meta"]
    assert meta["telemetry"]["controller"]["groups"]["factored"]["n"] == 1
    state, rt = _port_run(closed_loop["init"], 12, LOOP_OPT, LOOP_TEL,
                          ckpt=CheckpointConfig(directory=str(tmp_path),
                                                save_every=100,
                                                async_save=False))
    assert rt.cadence_log == closed_loop["jrt"].cadence_log
    _params_close(state, closed_loop["jstate"], 1e-4)


def _tiny_setup():
    """JAX's ``_auto_refresh_setup``: a tiny run whose controller relaxes
    the cadence by 1 every 5-step interval, clamped at 4."""
    cfg = get_smoke_config("gpt2-117m", vocab=64)
    opt = build_optimizer(OptimizerConfig(
        name="adapprox", schedule="constant", lr=3e-3, weight_decay=0.1,
        min_dim_factor=32, k=4, rank_mode="static", implicit=False,
        telemetry=True, dynamic_refresh=True))
    runtime = T.TelemetryRuntime(TelemetryConfig(
        enabled=True, auto_refresh=True, interval=5, xi_high=2.0,
        xi_low=1.9, relax_patience=1, relax_add=1, t_max=4))
    return build_model(cfg), opt, runtime, DataConfig(
        vocab=64, seq_len=32, global_batch=4, seed=3)


def test_controller_kill_restore_reproduces_cadence_sequence(tmp_path):
    """JAX's test of the same name: killed at step 8 (inside the 6-10
    interval) and restored, the run gives the same cadence changes and
    bitwise the same parameters and optimizer state."""
    total, kill_at = 18, 8
    want_log = [(5, "default", 1, 2), (10, "default", 2, 3),
                (15, "default", 3, 4)]
    model, opt, rt_a, data_cfg = _tiny_setup()
    state_a, _ = train(model, opt, data_cfg,
                       LoopConfig(total_steps=total, log_every=5),
                       device=CPU, telemetry=rt_a)
    assert rt_a.cadence_log == want_log
    assert T.get_refresh_every(state_a.opt_state) == {"default": 4}
    ck = CheckpointConfig(directory=str(tmp_path), save_every=kill_at,
                          async_save=False)
    model, opt, rt_b1, _ = _tiny_setup()
    train(model, opt, data_cfg, LoopConfig(total_steps=kill_at, log_every=5,
                                           ckpt=ck),
          device=CPU, telemetry=rt_b1)
    assert rt_b1.cadence_log == want_log[:1]
    model, opt, rt_b2, _ = _tiny_setup()
    state_b, _ = train(model, opt, data_cfg,
                       LoopConfig(total_steps=total, log_every=5, ckpt=ck),
                       device=CPU, telemetry=rt_b2)
    assert rt_b2.cadence_log == want_log
    for k, p in state_a.params.items():
        assert torch.equal(p, state_b.params[k]), k
    la = SER.leaves_with_paths(state_a.opt_state)
    lb = SER.leaves_with_paths(state_b.opt_state)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, a), (_, b) in zip(la, lb):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(a, b)), path


def test_runtime_emits_and_controls(tmp_path):
    """JAX's test of the same name on the port: xi < 1 always, so every
    3-step interval relaxes by 3 (1 -> 4 -> 7, t_max); the manifest meta
    restores the log in a fresh runtime."""
    params = {k: torch.tensor(v) for k, v in _toy_params().items()}
    opt = TA.scale_by_adapprox(_toy_cfg("port", telemetry=True,
                                        dynamic_refresh=True))
    state = opt.init(params)
    rt = T.TelemetryRuntime(TelemetryConfig(
        enabled=True, dir=str(tmp_path), auto_refresh=True, interval=3,
        xi_high=2.0, xi_low=1.9, relax_patience=1, relax_add=3, t_max=7))
    for t in range(1, 10):
        _, state = opt.update({k: torch.tensor(v) for k, v in
                               _toy_grads(t).items()}, state, params)
        state = rt.on_step(t, state)
    rt.close()
    assert [(s, o, n) for s, _, o, n in rt.cadence_log] == [(3, 1, 4),
                                                           (6, 4, 7)]
    assert T.get_refresh_every(state) == {"default": 7}
    assert state.telemetry.refresh_every == 7
    assert JT.validate_dir(tmp_path) >= 9
    meta = rt.manifest_meta()["telemetry"]
    assert meta["cadence"] == {"default": 7}
    rt2 = T.TelemetryRuntime(TelemetryConfig(enabled=True,
                                             auto_refresh=True))
    rt2.restore_meta({"telemetry": json.loads(json.dumps(meta))})
    assert rt2.cadence_log == rt.cadence_log


def test_runtime_auto_refresh_requires_dynamic_cadence_at_step_one():
    params = {k: torch.tensor(v) for k, v in _toy_params().items()}
    grads = {k: torch.tensor(v) for k, v in _toy_grads(1).items()}
    for kw, match in ((dict(telemetry=True), "dynamic_refresh=True"),
                      (dict(dynamic_refresh=True), "telemetry=True")):
        opt = TA.scale_by_adapprox(_toy_cfg("port", **kw))
        state = opt.init(params)
        _, state = opt.update(grads, state, params)
        rt = T.TelemetryRuntime(TelemetryConfig(enabled=True,
                                                auto_refresh=True))
        with pytest.raises(ValueError, match=match):
            rt.on_step(1, state)


@pytest.mark.parametrize("setting", ["emit", "emit_every_3", "controller",
                                     "guards"])
def test_host_transfer_rule(setting, tmp_path, monkeypatch):
    """At most one device-to-host copy of the snapshots a step: one where
    something reads them, none on a step that ``emit_every`` skips with no
    controller, none under the guards (their one transfer carries the
    vectors)."""
    from repro_torch.telemetry import snapshot as SN
    copies = []
    fetch = SN.fetch_host
    monkeypatch.setattr("repro_torch.telemetry.runtime.fetch_host",
                        lambda snaps: copies.append(fetch(snaps))
                        or copies[-1])
    params = {k: torch.tensor(v) for k, v in _toy_params().items()}
    kw = dict(telemetry=True, dynamic_refresh=True)
    if setting == "guards":
        kw["guards"] = GuardConfig(xi_trip=1.0)
    opt = TA.scale_by_adapprox(_toy_cfg("port", **kw))
    if setting == "guards":
        opt = guard_updates(opt)
    rt = T.TelemetryRuntime(TelemetryConfig(
        enabled=True, dir=str(tmp_path),
        emit_every=3 if setting == "emit_every_3" else 1,
        auto_refresh=setting in ("controller", "guards"), xi_high=2.0,
        xi_low=1.9))
    state = opt.init(params)
    for t in range(1, 7):
        _, state = opt.update({k: torch.tensor(v) for k, v in
                               _toy_grads(t).items()}, state, params)
        state = rt.on_step(t, state)
    rt.close()
    want = {"emit": [1] * 6, "emit_every_3": [1, 1],
            "controller": [1] * 6, "guards": [0] * 6}[setting]
    assert copies == want
    assert rt.transfers == sum(want)
    assert len(_by_kind(_events(tmp_path), "optimizer")) == (
        2 if setting == "emit_every_3" else 6)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_port_checkpoint_with_telemetry_passes_jax_deep_verify(tmp_path):
    """The launcher's smoke run with --auto-refresh --guards --ckpt-dir:
    its checkpoint lists the JAX state's leaves (the snapshots and the
    dynamic cadence included) under their key paths, shapes and dtypes,
    passes JAX's deep verify, and carries the controller meta."""
    launcher.main(["--smoke", "--device", "cpu", "--fused-update",
                   "--refresh-every", "3", "--guards", "--auto-refresh",
                   "--embedding-min-rows", "256", "--sketch-width", "256",
                   "--sketch-depth", "2", "--steps", "2", "--log-every", "1",
                   "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    (step_dir,) = SER.list_checkpoints(tmp_path)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    ours = [(p, leaf["shape"], leaf["dtype"])
            for p, leaf in zip(manifest["paths"], manifest["leaves"])]
    model = jax_build_model(jax_smoke_config("gpt2-117m", max_seq_len=128))
    jst = JTrainState.create(model.init(jax.random.PRNGKey(0)),
                             jax_build_optimizer(jax_optimizer_config(
                                 "adapprox", 2, 3e-3, refresh_every=3,
                                 fused_update=True, mixed_groups=True,
                                 telemetry=True, dynamic_refresh=True,
                                 guards=True, **SMALL)))
    want = [(jax.tree_util.keystr(kp), list(np.shape(x)), str(x.dtype))
            for kp, x in jax.tree_util.tree_flatten_with_path(jst)[0]]
    assert ours == want
    assert any(p.endswith(".telemetry.xi") for p, _, _ in ours)
    assert any(p.endswith(".refresh_every") for p, _, _ in ours)
    assert JSER.verify_checkpoint(step_dir, deep=True)
    meta = JSER.read_meta(step_dir)["telemetry"]
    assert meta["cadence"] == {"factored": 3} and "controller" in meta


def test_convert_carries_snapshots_and_cadence():
    """A JAX telemetry-on state through ``convert``: the snapshot's
    counters host numbers, its vectors tensors, the dynamic cadence an
    int; the sketch snapshot likewise."""
    jopt = jax_build_optimizer(jax_optimizer_config(
        "adapprox", 2, 3e-3, telemetry=True, dynamic_refresh=True,
        refresh_every=4))
    jp = {"w": jnp.ones((96, 64)), "b": jnp.ones(48)}
    jst = jax.device_get(JA.adapprox_state(jopt.init(jp)))
    st = adapprox_state_from_numpy(0, jst.leaves, telemetry=jst.telemetry,
                                   refresh_every=jst.refresh_every)
    assert st.refresh_every == 4 and st.telemetry.refresh_every == 4
    assert st.telemetry.leaf_indices == (1,)
    assert st.telemetry.xi.dtype == torch.float32
    jsk = jax.device_get(importlib.import_module(
        "repro.core.sketch").sketch_state(jax_build_optimizer(
            jax_optimizer_config("adapprox", 2, 3e-3, telemetry=True,
                                 mixed_groups=True, **SMALL)).init(
            {"embed": jnp.ones((512, 8)), "b": jnp.ones(8)})))
    sk = sketch_state_from_numpy(0, jsk.leaves, telemetry=jsk.telemetry)
    assert sk.telemetry.leaf_indices == tuple(jsk.telemetry.leaf_indices)
    assert float(sk.telemetry.overestimate[0]) == 1.0
