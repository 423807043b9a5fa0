"""Async, buffered JSONL telemetry sink with size-based rotation: a copy of
the JAX package's ``telemetry/sink.py`` (stdlib only), so the two
packages write one schema, kind for kind and field for field.

One event stream, one schema: optimizer snapshots, cadence changes,
straggler flags and dry-run compile records all flow through
:class:`TelemetrySink` as single-line JSON objects (see
``repro_torch.telemetry``'s package docstring for the field reference, and
:func:`validate_event` for the machine-checkable form CI validates
against).

Design mirrors ``checkpoint/manager.py``'s async save: ``emit`` validates
and enqueues (never blocks on IO), a daemon writer thread drains the
queue to the current ``<prefix>-NNNNN.jsonl`` file (rotating when it
exceeds ``rotate_bytes``), and any writer-side exception is captured and
re-raised on the next ``flush()`` / ``close()`` instead of dying
silently.  ``flush()`` blocks until every emitted event is on disk — the
train loop's preemption handler chain calls it before the final
checkpoint flush hands the signal on.

Signal-safety: the producer/consumer channel is a lock-free
``collections.deque`` plus single-writer counters, NOT a
``queue.Queue``.  A SIGTERM can land while the main thread is inside
``emit`` — with a mutex-based queue, a ``flush()`` from the preemption
handler (same thread) would then try to re-acquire the mutex the
interrupted ``emit`` still holds and deadlock the teardown.  Here
``emit`` is an atomic ``deque.append`` + int increment and ``flush``
spin-waits on counters each owned by exactly one thread, so the handler
path acquires no lock at all.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Optional

SCHEMA_VERSION = 1

# kind -> (required fields, optional fields); values are accepted types.
# Numbers: int is always an acceptable float (JSON does not distinguish).
_NUM = (int, float)
EVENT_SCHEMA = {
    "optimizer": {
        "required": {"step": int, "group": str, "refresh_every": int,
                     "did_refresh": bool, "refresh_steps": int,
                     "fold_steps": int, "clip_rate": _NUM},
        "optional": {"xi": list, "k": list, "k_frac": list,
                     "mean_xi": _NUM, "max_xi": _NUM, "mean_k": _NUM,
                     "mean_k_frac": _NUM, "leaf_indices": list,
                     "dense_indices": list},
    },
    "sketch": {
        "required": {"step": int, "group": str, "mean_occupancy": _NUM,
                     "mean_overestimate": _NUM},
        "optional": {"occupancy": list, "overestimate": list,
                     "max_occupancy": _NUM, "max_overestimate": _NUM,
                     "leaf_indices": list},
    },
    "cadence": {
        "required": {"step": int, "group": str, "old": int, "new": int,
                     "interval_mean_xi": _NUM},
        "optional": {"reason": str},
    },
    "straggler": {
        "required": {"event": str, "n_steps": int, "step_time_s": _NUM,
                     "median_s": _NUM},
        "optional": {"z": _NUM, "flags": int, "detail": str},
    },
    "dryrun_cell": {
        "required": {"arch": str, "cell": str, "mesh": str, "devices": int,
                     "flops": _NUM, "bytes_accessed": _NUM},
        "optional": {"peak_bytes": _NUM, "collective_bytes": _NUM,
                     "compile_s": _NUM, "kind": str, "params": _NUM},
    },
    "run_meta": {
        "required": {"source": str},
        "optional": {"argv": list, "config": dict, "note": str},
    },
    # resilience guards (repro_torch.resilience): skip-steps from the chain-level
    # non-finite guard, per-leaf xi trips / forced refreshes / dense
    # demotions from the Adapprox xi watchdog.  ``event`` names the fault
    # ("skip" | "xi_trip" | "demote"); counters are CUMULATIVE, so a
    # consumer diffs consecutive events to recover per-interval rates.
    "fault": {
        "required": {"step": int, "group": str, "event": str},
        "optional": {"skipped": int, "last_skip": int, "trips": int,
                     "demotions": int, "leaf": int, "xi": _NUM,
                     "detail": str},
    },
    # serving engines (the JAX package's repro.serve): request lifecycle ("admit" |
    # "first_token" | "finish" | "reject"), admission back-pressure
    # ("backoff" when KV-block occupancy crosses the watermark) and
    # periodic "stats" lines.  ``t_s`` is seconds since the engine run
    # started; ``tokens`` counters are CUMULATIVE on "stats" lines and
    # per-request on "finish" lines.
    # ``trace`` joins a request's serve events to its span waterfall
    # (kind="span" events sharing the trace id) — see telemetry/trace.py.
    "serve": {
        "required": {"event": str, "t_s": _NUM, "scheduler": str},
        "optional": {"uid": int, "step": int, "queue_depth": int,
                     "ttft_s": _NUM, "latency_s": _NUM, "tokens": int,
                     "tok_per_s": _NUM, "occupancy": _NUM,
                     "slots_active": int, "reason": str, "trace": str},
    },
    # host-side timing spans (telemetry/trace.py): ``trace`` groups a
    # waterfall (one train run / serve request / engine), ``span`` is
    # unique within it, ``parent`` nests.  ``t0_s``/``dur_s`` are seconds
    # on the emitting tracer's monotonic clock.  ``truncated`` marks a
    # span the preemption drain closed early.
    "span": {
        "required": {"name": str, "trace": str, "span": str,
                     "t0_s": _NUM, "dur_s": _NUM},
        "optional": {"parent": str, "step": int, "uid": int,
                     "truncated": bool, "attrs": dict},
    },
    # periodic registry snapshot (telemetry/metrics.py): sample keys are
    # the Prometheus sample names, so the JSONL and text expositions
    # agree; histogram values carry buckets/counts/sum/count.
    "metric": {
        "required": {"t_s": _NUM, "counters": dict, "gauges": dict,
                     "histograms": dict},
        "optional": {"step": int},
    },
}


def _json_default(x):
    """JSON fallback for numpy scalars / arrays."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if hasattr(x, "item"):
        return x.item()
    raise TypeError(f"not JSON-serializable: {type(x).__name__}")


def validate_event(event: dict) -> None:
    """Raise ``ValueError`` when ``event`` does not conform to the schema
    (unknown kind, missing required field, wrong type).  Extra fields not
    listed in the schema are rejected so the schema stays the single
    source of truth for consumers."""
    if not isinstance(event, dict):
        raise ValueError(f"event must be a dict, got {type(event).__name__}")
    kind = event.get("kind")
    if kind not in EVENT_SCHEMA:
        raise ValueError(f"unknown event kind {kind!r}; "
                         f"known: {sorted(EVENT_SCHEMA)}")
    if event.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"schema must be {SCHEMA_VERSION}, "
                         f"got {event.get('schema')!r}")
    spec = EVENT_SCHEMA[kind]
    for field, typ in spec["required"].items():
        if field not in event:
            raise ValueError(f"{kind} event missing required field "
                             f"{field!r}")
        if not isinstance(event[field], typ) or (
                typ is int and isinstance(event[field], bool)):
            raise ValueError(f"{kind} event field {field!r}: expected "
                             f"{typ}, got {type(event[field]).__name__}")
    known = set(spec["required"]) | set(spec["optional"]) | {"kind", "schema"}
    for field, value in event.items():
        if field not in known:
            raise ValueError(f"{kind} event has unknown field {field!r}")
        if field in spec["optional"] and not isinstance(
                value, spec["optional"][field]):
            raise ValueError(f"{kind} event field {field!r}: expected "
                             f"{spec['optional'][field]}, "
                             f"got {type(value).__name__}")


def validate_file(path: "str | Path") -> int:
    """Validate every line of one JSONL file; returns the event count."""
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                validate_event(json.loads(line))
            except (ValueError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}:{lineno}: {e}") from e
            n += 1
    return n


def _file_index(p: Path) -> int:
    """Rotation sequence number parsed from ``<prefix>-NNNNN.jsonl``
    (-1 for files that don't carry one)."""
    try:
        return int(p.stem.rsplit("-", 1)[-1])
    except ValueError:
        return -1


def validate_dir(directory: "str | Path", prefix: str = "events") -> int:
    """Validate every ``<prefix>-*.jsonl`` under ``directory``; returns
    the total event count (0 when no files exist)."""
    total = 0
    for p in sorted(Path(directory).glob(f"{prefix}-*.jsonl"),
                    key=_file_index):
        total += validate_file(p)
    return total


@dataclasses.dataclass
class SinkConfig:
    directory: str
    prefix: str = "events"
    rotate_bytes: int = 32 * 1024 * 1024
    validate: bool = True          # schema-check at emit (cheap, catches
                                   # producer bugs at the source)


class TelemetrySink:
    # writer-thread poll period while the channel is idle; also the
    # flush() spin period (no condition variables: see module docstring)
    _IDLE_S = 0.005
    _FLUSH_TIMEOUT_S = 30.0

    def __init__(self, cfg: SinkConfig):
        self.cfg = cfg
        self.directory = Path(cfg.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._dq: "deque[str]" = deque()
        # single-writer counters (ints are GIL-atomic to read): _emitted
        # is written only by the producer thread, _written / _flushed
        # only by the writer thread
        self._emitted = 0
        self._written = 0
        self._flushed = 0
        self._error: Optional[BaseException] = None
        self._file = None
        self._bytes = 0
        # Monotonic rotation sequence: resume PAST the highest existing
        # index, not at the file count — with a gap in the sequence
        # (pruned early files) count-based numbering would collide with a
        # live later file and interleave two streams, and ordering in
        # validate_dir / paths() would be ambiguous.
        self._index = max((_file_index(p) for p in
                           self.directory.glob(f"{cfg.prefix}-*.jsonl")),
                          default=-1) + 1
        self._closed = False
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- producer side ----------------------------------------------------
    def emit(self, event: dict) -> None:
        """Validate + enqueue one event (non-blocking, lock-free; IO
        happens on the writer thread)."""
        if self._closed:
            raise RuntimeError("sink is closed")
        event.setdefault("schema", SCHEMA_VERSION)
        if self.cfg.validate:
            validate_event(event)
        self._dq.append(json.dumps(event, default=_json_default))
        self._emitted += 1

    def flush(self) -> None:
        """Block until every event emitted so far is written AND flushed
        to disk.  Acquires no locks, so it is safe to call from a signal
        handler that interrupted ``emit`` mid-call."""
        target = self._emitted
        deadline = time.monotonic() + self._FLUSH_TIMEOUT_S
        while self._flushed < target and self._error is None \
                and self._thread.is_alive():
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"telemetry sink flush timed out "
                    f"({self._flushed}/{target} events on disk)")
            time.sleep(self._IDLE_S)
        self._raise_if_failed()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop = True
        self._thread.join()
        if self._file is not None:
            self._file.close()
            self._file = None
        self._raise_if_failed()

    def paths(self) -> "list[Path]":
        return sorted(self.directory.glob(f"{self.cfg.prefix}-*.jsonl"),
                      key=_file_index)

    # -- writer thread -----------------------------------------------------
    def _open_next(self):
        if self._file is not None:
            # rotation is the file's last write: flush + fsync before
            # letting go, so a crash right after rotation can't lose the
            # tail of a file readers already consider complete
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
        path = self.directory / f"{self.cfg.prefix}-{self._index:05d}.jsonl"
        self._index += 1
        self._file = open(path, "a")
        self._bytes = path.stat().st_size

    def _worker(self):
        while True:
            try:
                item = self._dq.popleft()
            except IndexError:
                # drained: sync the file so flush() waiters can finish,
                # then idle-poll (or exit once close() asked us to stop)
                if self._file is not None and self._flushed < self._written:
                    try:
                        self._file.flush()
                    except BaseException as e:  # noqa: BLE001
                        self._error = e
                self._flushed = self._written
                if self._stop:
                    return
                time.sleep(self._IDLE_S)
                continue
            try:
                if self._file is None or self._bytes >= self.cfg.rotate_bytes:
                    self._open_next()
                line = item + "\n"
                self._file.write(line)
                self._bytes += len(line.encode())
            except BaseException as e:  # noqa: BLE001 — surfaced on flush()
                self._error = e
            self._written += 1

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("telemetry sink write failed") from err
