"""The port's serving engines (``repro_torch.serve``): the JAX package's
serving contracts, held within the port on the CPU, and the engines'
streams against the JAX package's engines.

Within the port (the gpt2-117m smoke model, bf16 compute, the port's
seed-0 init), as ``tests/test_serve.py`` holds the JAX package:

  * the allocator scenarios of ``TestBlockAllocator``, on the port's
    ``BlockAllocator`` / ``SlotTable``;
  * paged decode is BITWISE the dense decode, the pool seeded from one
    dense prefill by ``pool_from_dense``;
  * the wave and the continuous engine emit identical greedy streams for
    equal-length prompts, and the continuous engine on mixed lengths
    equals each request served alone; every run drains the allocator;
  * EOS on the first token, a zero budget, admission backing off under
    occupancy (with its telemetry), load shedding, the oversized request
    refused;
  * span waterfalls and ``kind="serve"`` events that pass both the
    port's and the JAX package's validators.

Against JAX: both engines' streams equal the JAX engines' in fp32 compute
from the JAX init (``repro_torch.convert``), where the frameworks differ
in summation order only and no greedy step of these requests is a
near-tie.  And the launcher, wave and ``--continuous``, on ``--device
cpu``, and its error on whisper (no engine passes ``embeds``), as the JAX
launcher's.

JAX's ``test_request_churn_never_recompiles_decode`` has no counterpart:
the port calls the model eagerly, with no jit cache to count.  The
bucketed chunk plan is kept all the same, and
``test_chunk_plan_and_span_are_jax_s`` holds it to JAX's.  Torch runs on
one intra-op thread (restored after).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro import serve as JS
from repro.telemetry import validate_dir as jax_validate_dir
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import (NULL_BLOCK, BlockAllocator, ContinuousConfig,
                               ContinuousEngine, Engine, PoolExhausted,
                               Request, ServeConfig, SlotTable,
                               pool_from_dense)
from repro_torch.telemetry import (MetricsRegistry, SinkConfig, TelemetrySink,
                                   Tracer, check_events, load_events,
                                   validate_dir)
from repro_torch.telemetry.trace import ROOT_SPAN
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

CACHE_LEN = 128
BLOCK_SIZE = 16
NBT = CACHE_LEN // BLOCK_SIZE
VOCAB = 512


@pytest.fixture(scope="module")
def model_and_params():
    model = build_model(get_smoke_config("gpt2-117m"))
    return model, model.init(torch.Generator().manual_seed(0))


def _reqs(lengths, budgets, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(uid=i,
                prompt=rng.integers(0, VOCAB, size=n).astype(np.int32),
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lengths, budgets))]


def _clone(reqs, cls=Request):
    return [cls(uid=r.uid, prompt=r.prompt.copy(),
                max_new_tokens=r.max_new_tokens) for r in reqs]


def _cont(model, params, **over):
    kw = dict(slots=4, cache_len=CACHE_LEN, block_size=BLOCK_SIZE,
              prefill_chunk=32)
    kw.update(over)
    return ContinuousEngine(model, params, ContinuousConfig(**kw))


def _drained(eng):
    assert eng.alloc.free_blocks() == eng.alloc.usable
    assert eng.alloc.available() == eng.alloc.usable
    assert eng.alloc.occupancy() == 0.0


# ---------------------------------------------------------------------------
# block allocator: JAX's scenarios on the port's
# ---------------------------------------------------------------------------

class TestBlockAllocator:
    def test_null_block_never_allocated(self):
        a = BlockAllocator(9, BLOCK_SIZE)
        ids = a.alloc(8)
        assert NULL_BLOCK not in ids
        assert sorted(ids) == list(range(1, 9))

    def test_free_then_reuse(self):
        a = BlockAllocator(5, BLOCK_SIZE)
        first = a.alloc(4)
        assert a.free_blocks() == 0
        a.free(first)
        assert a.free_blocks() == 4
        again = a.alloc(4)
        assert sorted(again) == sorted(first)

    def test_lifo_order_is_jax_s(self):
        """Ascending ids first, and a freed block is the next handed out:
        the JAX allocator's order, step for step."""
        a, j = BlockAllocator(7, BLOCK_SIZE), JS.BlockAllocator(7, BLOCK_SIZE)
        for op in (("alloc", 3), ("free", None), ("alloc", 2),
                   ("alloc", 3), ("free", None), ("alloc", 1)):
            if op[0] == "alloc":
                got, want = a.alloc(op[1]), j.alloc(op[1])
                assert got == want
                last = got
            else:
                a.free(last)
                j.free(last)
            assert a.free_blocks() == j.free_blocks()

    def test_double_free_and_bad_ids_raise(self):
        a = BlockAllocator(5, BLOCK_SIZE)
        ids = a.alloc(2)
        a.free(ids)
        with pytest.raises(ValueError, match="double-free"):
            a.free([ids[0]])
        with pytest.raises(ValueError, match="invalid block id"):
            a.free([NULL_BLOCK])
        with pytest.raises(ValueError, match="invalid block id"):
            a.free([99])

    def test_exhaustion(self):
        a = BlockAllocator(5, BLOCK_SIZE)
        a.alloc(3)
        with pytest.raises(PoolExhausted):
            a.alloc(2)
        with pytest.raises(ValueError, match="null block"):
            BlockAllocator(1, BLOCK_SIZE)

    def test_reservation_ledger(self):
        a = BlockAllocator(9, BLOCK_SIZE)       # 8 usable
        assert a.reserve(5)
        assert a.available() == 3
        assert a.occupancy() == pytest.approx(5 / 8)
        with pytest.raises(PoolExhausted):
            a.alloc(4)
        got = a.alloc(3, reserved=True)
        assert len(got) == 3
        assert a.available() == 3
        a.release(2)
        assert a.available() == 5
        assert not a.reserve(6)
        assert a.available() == 5
        with pytest.raises(ValueError, match="exceeds"):
            a.release(1)
        with pytest.raises(ValueError, match="exceeds"):
            a.alloc(1, reserved=True)

    def test_blocks_for(self):
        a = BlockAllocator(5, 16)
        assert a.blocks_for(1) == 1
        assert a.blocks_for(16) == 1
        assert a.blocks_for(17) == 2

    def test_slot_table_padded(self):
        t = SlotTable([3, 1, 2])
        row = t.padded(6)
        assert row.dtype == np.int32
        assert row.tolist() == [3, 1, 2, 0, 0, 0]
        assert t.capacity(16) == 48


def test_chunk_plan_and_span_are_jax_s(model_and_params):
    """The bucketed chunk plan and the reserved span, which set the pool's
    occupancy, equal the JAX engine's for every prompt length up to 70
    and a few budgets."""
    model, params = model_and_params
    jax_eng = JS.ContinuousEngine.__new__(JS.ContinuousEngine)
    for chunk in (16, 32):
        eng = _cont(model, params, prefill_chunk=chunk)
        jax_eng.cfg = JS.ContinuousConfig(prefill_chunk=chunk)
        for n in range(1, 71):
            assert eng._chunk_plan(n) == jax_eng._chunk_plan(n), (chunk, n)
            for m in (0, 1, 9):
                r = Request(uid=0, prompt=np.zeros(n, np.int32),
                            max_new_tokens=m)
                assert eng._span(r) == jax_eng._span(r), (chunk, n, m)


# ---------------------------------------------------------------------------
# paged cache vs dense cache: bitwise
# ---------------------------------------------------------------------------

def test_paged_decode_bitwise_matches_dense(model_and_params):
    """The block pool seeded from one dense prefill (``pool_from_dense``),
    then both representations stepped on the same fed tokens: the logits
    equal bitwise every step."""
    model, params = model_and_params
    rng = np.random.default_rng(7)
    b, plen = 2, 16
    prompts = torch.from_numpy(
        rng.integers(0, VOCAB, size=(b, plen)).astype(np.int64))
    cache = model.init_cache(b, CACHE_LEN)
    logits, cache = model.prefill(params, prompts, cache)
    alloc = BlockAllocator(b * NBT + 1, BLOCK_SIZE)
    tables = [SlotTable(alloc.alloc(NBT)) for _ in range(b)]
    pool = pool_from_dense(model, cache, tables, [plen] * b,
                           b * NBT + 1, BLOCK_SIZE)
    tabs = torch.from_numpy(np.stack([t.padded(NBT) for t in tables])).long()
    toks = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    pos = torch.full((b,), plen)
    for _ in range(6):
        ld, cache = model.decode_step(params, cache, toks)
        lp, pool = model.decode_paged(params, pool, toks, tabs, pos)
        assert torch.equal(ld, lp)
        toks = torch.argmax(ld[:, -1, :], dim=-1)[:, None]
        pos += 1


# ---------------------------------------------------------------------------
# stream parity between schedulers
# ---------------------------------------------------------------------------

def test_wave_and_continuous_identical_streams(model_and_params):
    """Equal-length prompts, one arrival order: both schedulers emit the
    same greedy streams, request by request, and the run drains the
    allocator."""
    model, params = model_and_params
    reqs = _reqs([12] * 6, [5, 17, 3, 9, 1, 7])
    wave_reqs, cont_reqs = _clone(reqs), _clone(reqs)
    Engine(model, params,
           ServeConfig(slots=4, cache_len=CACHE_LEN)).run(wave_reqs)
    eng = _cont(model, params)
    eng.run(cont_reqs)
    for w, c in zip(wave_reqs, cont_reqs):
        assert w.out_tokens == c.out_tokens, f"req {w.uid} diverged"
        assert len(c.out_tokens) == c.max_new_tokens
        assert c.done and c.done_s is not None
    _drained(eng)


def test_continuous_mixed_lengths_match_solo_reference(model_and_params):
    """Mixed prompt lengths batched continuously equal each request served
    alone (a one-slot wave): per-slot positions and block tables isolate
    the rows."""
    model, params = model_and_params
    reqs = _reqs([5, 33, 17, 8, 26], [6, 4, 9, 3, 5], seed=3)
    cont_reqs = _clone(reqs)
    eng = _cont(model, params, prefill_chunk=16)
    eng.run(cont_reqs)
    _drained(eng)
    solo = Engine(model, params, ServeConfig(slots=1, cache_len=CACHE_LEN))
    for r in reqs:
        ref = _clone([r])
        solo.run(ref)
        got = next(c for c in cont_reqs if c.uid == r.uid)
        assert got.out_tokens == ref[0].out_tokens, f"req {r.uid} diverged"


# ---------------------------------------------------------------------------
# EOS, budgets, admission, load shedding
# ---------------------------------------------------------------------------

def test_eos_on_first_token(model_and_params):
    """EOS straight out of prefill ends the sequence at one token, in both
    engines."""
    model, params = model_and_params
    probe = _reqs([10], [1], seed=11)
    Engine(model, params,
           ServeConfig(slots=2, cache_len=CACHE_LEN)).run(probe)
    eos = probe[0].out_tokens[0]
    reqs = _reqs([10], [64], seed=11)
    Engine(model, params,
           ServeConfig(slots=2, cache_len=CACHE_LEN, eos_id=eos)).run(reqs)
    assert reqs[0].out_tokens == [eos]
    assert reqs[0].done and reqs[0].first_token_s is not None
    cont = _reqs([10], [64], seed=11)
    eng = _cont(model, params, eos_id=eos)
    eng.run(cont)
    assert cont[0].out_tokens == [eos]
    _drained(eng)


def test_zero_budget_emits_nothing(model_and_params):
    model, params = model_and_params
    for make in (lambda: Engine(model, params,
                                ServeConfig(slots=2, cache_len=CACHE_LEN)),
                 lambda: _cont(model, params)):
        reqs = _reqs([9, 9], [0, 3], seed=5)
        make().run(reqs)
        assert reqs[0].out_tokens == []
        assert reqs[0].done and reqs[0].done_s is not None
        assert len(reqs[1].out_tokens) == 3


def _events(path):
    return [json.loads(line) for p in sorted(path.glob("events-*.jsonl"))
            for line in p.read_text().splitlines()]


def test_admission_backs_off_under_full_occupancy(model_and_params,
                                                  tmp_path):
    """A pool sized for one request serves three: admission waits at the
    occupancy watermark (a backoff event) and recycles blocks as requests
    finish; never PoolExhausted.  The stream passes both validators."""
    model, params = model_and_params
    cache_len, nbt = 64, 64 // BLOCK_SIZE
    sink = TelemetrySink(SinkConfig(directory=str(tmp_path)))
    eng = ContinuousEngine(
        model, params,
        ContinuousConfig(slots=2, cache_len=cache_len,
                         block_size=BLOCK_SIZE, prefill_chunk=16,
                         num_blocks=nbt + 1), sink=sink)
    reqs = _reqs([16, 16, 16], [48 - 16, 40 - 16, 20], seed=9)
    eng.run(reqs)
    sink.flush()
    sink.close()
    for r in reqs:
        assert len(r.out_tokens) == r.max_new_tokens
        assert r.done
    _drained(eng)
    events = _events(tmp_path)
    kinds = {e["event"] for e in events}
    assert "backoff" in kinds
    assert {"admit", "first_token", "finish"} <= kinds
    assert validate_dir(tmp_path) == len(events)
    assert jax_validate_dir(tmp_path) == len(events)


def test_bounded_queue_load_sheds(model_and_params):
    model, params = model_and_params
    eng = _cont(model, params, slots=1, max_queue=2)
    reqs = _reqs([8] * 4, [4] * 4, seed=2)
    eng.run(reqs)
    served = [r for r in reqs if not r.rejected]
    shed = [r for r in reqs if r.rejected]
    assert len(shed) == 2
    assert all(r.out_tokens == [] and r.done for r in shed)
    assert all(len(r.out_tokens) == r.max_new_tokens for r in served)
    _drained(eng)


def test_oversized_request_rejected_upfront(model_and_params):
    model, params = model_and_params
    eng = _cont(model, params)
    with pytest.raises(ValueError, match="span"):
        eng.run(_reqs([64], [CACHE_LEN], seed=1))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.run([Request(uid=0, prompt=np.zeros(0, np.int32),
                         max_new_tokens=4)])


def test_continuous_engine_refuses_models_without_paged_decode():
    """As the JAX engine: the ssm, hybrid and encdec families have no
    ``decode_paged``."""
    for arch in ("mamba2-370m", "zamba2-2.7b", "whisper-large-v3"):
        model = build_model(get_smoke_config(arch))
        with pytest.raises(TypeError, match="no paged decode"):
            ContinuousEngine(model, {"x": torch.zeros(1)},
                             ContinuousConfig(slots=1, cache_len=32))


# ---------------------------------------------------------------------------
# span waterfalls and serve events
# ---------------------------------------------------------------------------

def _run_traced(tmp_path, engine, reqs):
    sink = TelemetrySink(SinkConfig(directory=str(tmp_path)))
    tracer = Tracer(sink=sink, registry=MetricsRegistry())
    engine.sink = sink
    engine.set_tracer(tracer)
    engine.run(reqs)
    tracer.flush()
    sink.flush()
    sink.close()
    events = load_events(tmp_path)
    assert validate_dir(tmp_path) == len(events) > 0
    assert jax_validate_dir(tmp_path) == len(events)
    return events, tracer


def test_continuous_waterfalls(model_and_params, tmp_path):
    """Every finish joins its waterfall by trace id: a root ``request``
    span with ``queued`` and ``prefill_chunk`` phases under it (two chunks
    for the prompts past ``prefill_chunk`` 32), and the registry counts
    the requests."""
    model, params = model_and_params
    reqs = _reqs([5, 17, 33, 9, 40], [6, 3, 5, 1, 4])
    events, tracer = _run_traced(tmp_path, _cont(model, params), reqs)
    assert check_events(events) == []
    spans = [e for e in events if e["kind"] == "span"]
    finishes = [e for e in events
                if e["kind"] == "serve" and e["event"] == "finish"]
    assert len(finishes) == len(reqs)
    for f in finishes:
        mine = [s for s in spans if s["trace"] == f["trace"]]
        assert {"request", "queued", "prefill_chunk"} <= {
            s["name"] for s in mine}
        root = next(s for s in mine if s["name"] == "request")
        assert root["span"] == ROOT_SPAN and root["uid"] == f["uid"]
        assert root["attrs"]["tokens"] == f["tokens"]
        for s in mine:
            if s is not root:
                assert s["parent"] == ROOT_SPAN
                assert s["t0_s"] >= root["t0_s"] - 1e-6
    for t in (f["trace"] for f in finishes if f["uid"] in (2, 4)):
        assert sum(1 for s in spans if s["trace"] == t
                   and s["name"] == "prefill_chunk") == 2
    assert tracer.registry.counter("serve_requests_total").value(
        scheduler="continuous") == len(reqs)


def test_wave_waterfalls_and_untraced_stream(model_and_params, tmp_path):
    """The wave engine's waterfalls (request, queued, prefill per
    request); and without a tracer the serve stream carries no span and no
    trace id."""
    model, params = model_and_params
    reqs = _reqs([8, 8, 8], [4, 2, 6])
    eng = Engine(model, params, ServeConfig(slots=4, cache_len=CACHE_LEN))
    events, _ = _run_traced(tmp_path / "wave", eng, reqs)
    assert check_events(events) == []
    spans = [e for e in events if e["kind"] == "span"]
    for name in ("request", "queued", "prefill"):
        assert sum(1 for s in spans if s["name"] == name) == len(reqs)
    sink = TelemetrySink(SinkConfig(directory=str(tmp_path / "plain")))
    eng = _cont(model, params)
    eng.sink = sink
    eng.run(_reqs([5, 9], [3, 2]))
    sink.flush()
    sink.close()
    events = load_events(tmp_path / "plain")
    assert events and all(e["kind"] == "serve" for e in events)
    assert all("trace" not in e for e in events)
    assert jax_validate_dir(tmp_path / "plain") == len(events)


# ---------------------------------------------------------------------------
# against the JAX package's engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pair():
    """The gpt2-117m smoke model in fp32 compute, both packages, from the
    JAX init."""
    cfg_j = dataclasses.replace(jax_smoke_config("gpt2-117m"),
                                dtype="float32")
    cfg_t = dataclasses.replace(get_smoke_config("gpt2-117m"),
                                dtype="float32")
    jm = jax_build_model(cfg_j)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, params, build_model(cfg_t), params_from_numpy(params)


def test_engines_streams_equal_jax_engines(jax_pair):
    """Mixed lengths through the wave engine (two slots: a pad-attending
    wave) and the continuous engine (prefill chunk 16), each against the
    JAX engine with the same config: the same tokens, request by
    request."""
    jm, jp, tm, tp = jax_pair
    lengths, budgets = [5, 33, 17, 8, 26], [6, 4, 9, 3, 5]
    for wave in (True, False):
        jr = _reqs(lengths, budgets, seed=3, cls=JS.Request)
        tr = _reqs(lengths, budgets, seed=3)
        if wave:
            JS.Engine(jm, jp, JS.ServeConfig(slots=2,
                                             cache_len=CACHE_LEN)).run(jr)
            Engine(tm, tp, ServeConfig(slots=2, cache_len=CACHE_LEN)).run(tr)
        else:
            kw = dict(slots=3, cache_len=CACHE_LEN, block_size=BLOCK_SIZE,
                      prefill_chunk=16)
            JS.ContinuousEngine(jm, jp, JS.ContinuousConfig(**kw)).run(jr)
            eng = ContinuousEngine(tm, tp, ContinuousConfig(**kw))
            eng.run(tr)
            _drained(eng)
        for a, b in zip(tr, jr):
            assert a.out_tokens == b.out_tokens, (wave, a.uid)
            assert len(a.out_tokens) == a.max_new_tokens


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_on_cpu_wave_and_continuous(capsys, tmp_path):
    """Wave and ``--continuous`` on ``--device cpu``: equal streams for
    equal-length prompts, the JAX launcher's summary line, a drained
    allocator, and the telemetry stream valid for both validators."""
    argv = ["--arch", "gpt2-117m", "--smoke", "--requests", "4",
            "--max-new", "6", "--device", "cpu"]
    _, wave = launcher.main(argv)
    eng, cont = launcher.main(argv + ["--continuous", "--telemetry-dir",
                                      str(tmp_path), "--trace-dir",
                                      str(tmp_path)])
    out = capsys.readouterr().out
    assert "4 requests (wave, 2 waves), 24 tokens in" in out
    assert "4 requests (continuous," in out and "mean ttft" in out
    assert [r.out_tokens for r in wave] == [r.out_tokens for r in cont]
    _drained(eng)
    n = validate_dir(tmp_path)
    assert n > 0 and jax_validate_dir(tmp_path) == n
    assert (tmp_path / "metrics.prom").exists()


def test_launcher_needs_cuda_and_stops_on_whisper(monkeypatch):
    """Without a GPU the launcher raises unless ``--device cpu``; on
    whisper it stops where the JAX launcher stops (the wave engine's
    prefill gets no ``embeds``: AttributeError), and ``--continuous``
    refuses the family (TypeError)."""
    from repro.launch import serve as jax_launcher
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launcher.main(["--smoke", "--arch", "gpt2-117m"])
    argv = ["--arch", "whisper-large-v3", "--smoke", "--requests", "1",
            "--max-new", "2"]
    with pytest.raises(AttributeError) as port_err:
        launcher.main(argv + ["--device", "cpu"])
    with pytest.raises(AttributeError) as jax_err:
        jax_launcher.main(argv)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(TypeError, match="no paged decode"):
        launcher.main(argv + ["--device", "cpu", "--continuous"])
