"""Span tracing: waterfalls for train steps and serve requests; a copy of
the JAX package's ``telemetry/trace.py`` (stdlib only).  The serve
waterfall checks come with it and apply once serving is ported.

Zero-dependency (stdlib-only) span API over the existing async JSONL
sink: context-manager spans with monotonic clocks, trace/span ids and a
thread-local span stack record ``kind="span"`` events through the same
:class:`~repro_torch.telemetry.sink.TelemetrySink` every other telemetry kind
uses — one stream, one schema, one ``validate_dir``.  Spans are
HOST-SIDE ONLY: nothing here touches a tensor, so a traced run is
bitwise the untraced one (tests/test_torch_trace.py); a span around a
dispatch measures host wall time, and a span around an explicit
``torch.cuda.synchronize`` measures device drain.

Two recording styles:

  * ``with tracer.span("data_wait"): ...`` — live spans.  Nesting is
    tracked per thread: an inner span's ``parent`` is the enclosing
    span's id, and an inner span inherits the enclosing trace id.
  * ``tracer.record(name, t0_s, dur_s, trace, ...)`` — after-the-fact
    spans for lifecycles whose phases are only known at the end (a serve
    request's queued/admitted/prefill/decode waterfall).  The serving
    engines use the fixed span id ``"root"`` for the per-request
    ``"request"`` root and parent every phase under it.

Trace-id join contract with ``kind="serve"``: the continuous/wave
engines stamp each request's trace id into its per-request serve events
(``admit`` / ``first_token`` / ``finish`` / ``reject`` carry an optional
``trace`` field), so a consumer joins the span waterfall to the serve
lifecycle by trace id alone.  ``check_events`` enforces the resulting
completeness invariant (every finished request reconstructs a
queued→finish waterfall) and is what ``tools/traceview.py --check``
gates CI on.

Signal-safety mirrors the sink: the tracer keeps its open-span table in
a plain dict (GIL-atomic ops, no mutex), so ``drain_open()`` — which the
train loop's preemption handler calls to flush in-flight spans as
``"truncated": true`` events — can run from a signal handler that
interrupted ``emit`` mid-call without deadlocking.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

from repro_torch.telemetry.sink import validate_event

ROOT_SPAN = "root"          # fixed span id for per-request root spans

# span names a finished serve request must have recorded (see
# check_events): prefill may be chunked (continuous) or whole (wave)
_PREFILL_NAMES = {"prefill", "prefill_chunk"}


class SpanHandle:
    """Mutable handle a live span yields: set attributes mid-span
    (e.g. the refresh-vs-fold phase, known only after the device sync)."""

    __slots__ = ("trace", "id", "name", "t0_s", "parent", "attrs")

    def __init__(self, name, trace, sid, t0_s, parent, attrs):
        self.name = name
        self.trace = trace
        self.id = sid
        self.t0_s = t0_s
        self.parent = parent
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class _NullHandle:
    trace = ""
    id = ""

    def set(self, **attrs) -> None:
        pass


_NULL_HANDLE = _NullHandle()


class NullTracer:
    """No-op twin of :class:`Tracer` so instrumented code paths need no
    ``if tracer is not None`` forests; ``engine.py`` / ``manager.py``
    default to the shared :data:`NULL_TRACER` instance."""

    sink = None
    registry = None

    def span(self, name, trace=None, **attrs):
        return contextlib.nullcontext(_NULL_HANDLE)

    def record(self, *args, **kwargs) -> None:
        pass

    def new_trace(self, tag=None) -> str:
        return ""

    def now(self) -> float:
        return 0.0

    def drain_open(self) -> None:
        pass

    def flush(self) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Span recorder over a :class:`TelemetrySink` (both optional: with
    ``sink=None`` spans are timed and discarded, with ``registry`` set
    every span duration is also observed into the
    ``span_duration_seconds`` histogram labelled by span name)."""

    def __init__(self, sink=None, registry=None):
        self.sink = sink
        self.registry = registry
        self._epoch = time.monotonic()
        self._ids = itertools.count()
        # distinct per process so streams from restarts never collide
        self._run = f"{os.getpid():x}"
        self._local = threading.local()
        # open-span table: plain dict (GIL-atomic), readable from a
        # signal handler — see module docstring
        self._open: "dict[str, SpanHandle]" = {}

    # -- clocks / ids ------------------------------------------------------
    def now(self) -> float:
        """Seconds since this tracer was created (monotonic)."""
        return time.monotonic() - self._epoch

    def new_trace(self, tag: Optional[str] = None) -> str:
        return f"{self._run}-{tag or 't'}-{next(self._ids):x}"

    def _new_span_id(self) -> str:
        return f"s{next(self._ids):x}"

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- live spans --------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, trace: Optional[str] = None, **attrs):
        """Context-manager span.  With no explicit ``trace``, nests under
        the innermost open span on this thread (inheriting its trace) or
        starts a fresh trace."""
        stack = self._stack()
        parent = None
        if trace is None:
            if stack:
                trace, parent = stack[-1]
            else:
                trace = self.new_trace(name)
        elif stack and stack[-1][0] == trace:
            parent = stack[-1][1]
        sid = self._new_span_id()
        handle = SpanHandle(name, trace, sid, self.now(), parent, dict(attrs))
        self._open[sid] = handle
        stack.append((trace, sid))
        try:
            yield handle
        finally:
            stack.pop()
            # drain_open may have already emitted this span (truncated)
            # from the preemption handler: the pop decides exactly one
            # event per span id
            if self._open.pop(sid, None) is not None:
                self._emit(handle.name, handle.trace, sid, handle.t0_s,
                           self.now() - handle.t0_s, handle.parent,
                           handle.attrs)

    # -- after-the-fact spans ----------------------------------------------
    def record(self, name: str, t0_s: float, dur_s: float, trace: str,
               span: Optional[str] = None, parent: Optional[str] = None,
               attrs: Optional[dict] = None) -> None:
        """Emit a span whose boundaries were measured by the caller —
        request waterfalls are reconstructed this way at finish time."""
        self._emit(name, trace, span if span is not None
                   else self._new_span_id(), t0_s, dur_s, parent,
                   attrs or {})

    # -- preemption --------------------------------------------------------
    def drain_open(self) -> None:
        """Emit every still-open span with ``"truncated": true`` — the
        preemption-handler chain calls this so a SIGTERM'd run's trace
        ends with explicit partial spans instead of silent holes.
        Acquires no locks (dict ops + the sink's lock-free emit)."""
        now = self.now()
        for sid in list(self._open):
            handle = self._open.pop(sid, None)
            if handle is None:          # closed concurrently
                continue
            self._emit(handle.name, handle.trace, sid, handle.t0_s,
                       now - handle.t0_s, handle.parent, handle.attrs,
                       truncated=True)

    def flush(self) -> None:
        if self.sink is not None:
            self.sink.flush()

    # -- event assembly ----------------------------------------------------
    def _emit(self, name, trace, sid, t0_s, dur_s, parent, attrs,
              truncated=False) -> None:
        if self.registry is not None:
            self.registry.histogram(
                "span_duration_seconds",
                help="span wall time by span name").observe(
                    max(float(dur_s), 0.0), name=name)
        if self.sink is None:
            return
        ev = {"kind": "span", "name": name, "trace": trace, "span": sid,
              "t0_s": round(float(t0_s), 6), "dur_s": round(float(dur_s), 6)}
        if parent:
            ev["parent"] = parent
        if truncated:
            ev["truncated"] = True
        if attrs:
            a = dict(attrs)
            step = a.pop("step", None)
            uid = a.pop("uid", None)
            if step is not None:
                ev["step"] = int(step)
            if uid is not None:
                ev["uid"] = int(uid)
            if a:
                ev["attrs"] = a
        self.sink.emit(ev)


# ---------------------------------------------------------------------------
# analysis helpers (shared by tools/traceview.py, benches, quickstart)
# ---------------------------------------------------------------------------

def load_events(path, pattern: Optional[str] = None) -> list:
    """Read every event from a JSONL file, or every ``events-*.jsonl``
    under a directory (``pattern`` overrides the default glob, e.g.
    ``"**/events-*.jsonl"`` for nested run dirs).  Files are read in
    numeric rotation order."""
    p = Path(path)
    if p.is_file():
        files = [p]
    else:
        files = sorted(p.glob(pattern or "events-*.jsonl"), key=str)
    events = []
    for f in files:
        with open(f) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
    return events


def span_events(events: list) -> list:
    return [e for e in events if e.get("kind") == "span"]


def _pct(sorted_vals: list, q: float) -> float:
    """Percentile with linear interpolation (numpy default), stdlib-only."""
    if not sorted_vals:
        return 0.0
    k = (len(sorted_vals) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    if lo == hi:
        return float(sorted_vals[lo])
    return float(sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo])
                 * (k - lo))


def span_stats(events: list) -> dict:
    """Per-span-name duration stats: count / total / mean / p50 / p95 /
    p99 (seconds)."""
    durs = defaultdict(list)
    for e in span_events(events):
        durs[e["name"]].append(float(e["dur_s"]))
    out = {}
    for name, d in sorted(durs.items()):
        d.sort()
        out[name] = {
            "count": len(d),
            "total_s": sum(d),
            "mean_s": sum(d) / len(d),
            "p50_s": _pct(d, 50),
            "p95_s": _pct(d, 95),
            "p99_s": _pct(d, 99),
        }
    return out


def format_span_stats(stats: dict) -> str:
    lines = [f"{'span':<20} {'count':>6} {'p50 ms':>9} {'p95 ms':>9} "
             f"{'p99 ms':>9} {'total s':>9}"]
    for name, s in stats.items():
        lines.append(f"{name:<20} {s['count']:>6} "
                     f"{s['p50_s'] * 1e3:>9.2f} {s['p95_s'] * 1e3:>9.2f} "
                     f"{s['p99_s'] * 1e3:>9.2f} {s['total_s']:>9.3f}")
    return "\n".join(lines)


def step_breakdown(events: list) -> dict:
    """Where train-step time went: per-phase totals/shares from the
    children of ``train_step`` spans, plus the refresh-vs-fold split
    from the step spans' ``phase`` attribution."""
    spans = span_events(events)
    by_id = {(e["trace"], e["span"]): e for e in spans}
    steps = [e for e in spans if e["name"] == "train_step"]
    total = sum(float(e["dur_s"]) for e in steps)
    child = defaultdict(list)
    for e in spans:
        parent = by_id.get((e["trace"], e.get("parent")))
        if parent is not None and parent["name"] == "train_step":
            child[e["name"]].append(float(e["dur_s"]))
    phases = []
    accounted = 0.0
    for name, d in sorted(child.items(), key=lambda kv: -sum(kv[1])):
        tot = sum(d)
        accounted += tot
        phases.append({"phase": name, "count": len(d), "total_s": tot,
                       "mean_ms": tot / len(d) * 1e3,
                       "share": tot / total if total else 0.0})
    if steps and total > accounted:
        phases.append({"phase": "(other)", "count": len(steps),
                       "total_s": total - accounted,
                       "mean_ms": (total - accounted) / len(steps) * 1e3,
                       "share": (total - accounted) / total})
    split = {}
    for mode in ("refresh", "fold"):
        d = [float(e["dur_s"]) for e in steps
             if e.get("attrs", {}).get("phase") == mode]
        if d:
            split[mode] = {"count": len(d),
                           "mean_ms": sum(d) / len(d) * 1e3}
    return {"steps": len(steps), "total_s": total, "phases": phases,
            "refresh_vs_fold": split}


def format_breakdown(bd: dict) -> str:
    if not bd["steps"]:
        return "no train_step spans"
    lines = [f"step-time breakdown over {bd['steps']} steps "
             f"({bd['total_s']:.3f}s total):",
             f"  {'phase':<18} {'count':>6} {'mean ms':>9} {'share':>7}"]
    for p in bd["phases"]:
        lines.append(f"  {p['phase']:<18} {p['count']:>6} "
                     f"{p['mean_ms']:>9.2f} {p['share'] * 100:>6.1f}%")
    for mode, s in bd["refresh_vs_fold"].items():
        lines.append(f"  {mode + ' steps':<18} {s['count']:>6} "
                     f"{s['mean_ms']:>9.2f}")
    return "\n".join(lines)


def chrome_trace(events: list) -> dict:
    """Chrome-trace/Perfetto JSON (``chrome://tracing`` loads it): one
    complete-duration ("X") event per span, traces mapped to tids."""
    tids: "dict[str, int]" = {}
    trace_events = []
    for e in span_events(events):
        tid = tids.setdefault(e["trace"], len(tids))
        args = dict(e.get("attrs", {}))
        for key in ("step", "uid", "truncated"):
            if key in e:
                args[key] = e[key]
        trace_events.append({
            "name": e["name"], "ph": "X", "cat": "span",
            "ts": round(float(e["t0_s"]) * 1e6, 3),
            "dur": round(float(e["dur_s"]) * 1e6, 3),
            "pid": 0, "tid": tid, "args": args,
        })
    for trace, tid in tids.items():
        trace_events.append({"name": "thread_name", "ph": "M", "pid": 0,
                             "tid": tid, "args": {"name": trace}})
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def check_events(events: list) -> list:
    """Structural validation for a JSONL event set; returns a list of
    problem strings (empty = clean).  Checks: every event conforms to
    the schema; no negative span durations; every span's ``parent``
    resolves within its trace (no orphans); and every ``kind="serve"``
    ``finish`` event that carries a trace id joins to a COMPLETE
    waterfall — ``request`` + ``queued`` spans, a prefill span when any
    token was emitted, a ``decode`` span when more than one was.  Traces
    holding truncated spans (preempted runs) are exempt from the
    completeness rule, not from the structural ones."""
    problems = []
    for i, e in enumerate(events):
        try:
            validate_event(e)
        except ValueError as err:
            problems.append(f"event {i}: schema violation: {err}")
    spans = span_events(events)
    by_trace = defaultdict(list)
    for e in spans:
        if float(e.get("dur_s", 0.0)) < 0:
            problems.append(f"span {e.get('trace')}/{e.get('span')} "
                            f"({e.get('name')}): negative duration")
        by_trace[e.get("trace")].append(e)
    for trace, tspans in by_trace.items():
        ids = {e["span"] for e in tspans}
        for e in tspans:
            parent = e.get("parent")
            if parent is not None and parent not in ids:
                problems.append(f"orphaned span {trace}/{e['span']} "
                                f"({e['name']}): parent {parent!r} "
                                f"not in trace")
    for e in events:
        if (e.get("kind") != "serve" or e.get("event") != "finish"
                or "trace" not in e):
            continue
        tspans = by_trace.get(e["trace"], [])
        if any(s.get("truncated") for s in tspans):
            continue
        names = {s["name"] for s in tspans}
        uid = e.get("uid")
        missing = {"request", "queued"} - names
        tokens = e.get("tokens", 0)
        if tokens >= 1 and not (_PREFILL_NAMES & names):
            missing.add("prefill")
        if tokens > 1 and "decode" not in names:
            missing.add("decode")
        if missing:
            problems.append(f"request uid={uid} trace={e['trace']}: "
                            f"incomplete waterfall, missing "
                            f"{sorted(missing)} (has {sorted(names)})")
    return problems
