"""Process-wide metrics registry: counters, gauges, histograms; a copy of
the JAX package's ``telemetry/metrics.py`` (stdlib only).

Deterministic, dependency-free metrics with two exposition surfaces:

  * ``MetricsRegistry.render()`` — Prometheus text format (``# HELP`` /
    ``# TYPE`` + samples; histograms as cumulative ``_bucket{le=...}`` +
    ``_sum`` / ``_count``), suitable for a textfile collector or any
    scraper; ``parse_prometheus`` is the matching stdlib parser the
    round-trip test pins the format with.
  * ``MetricsRegistry.snapshot(t_s)`` — a ``kind="metric"`` JSONL event
    for the shared telemetry sink, so periodic metric snapshots ride the
    same stream (and the same ``validate_dir``) as spans and serve
    events.  Sample keys in the snapshot are EXACTLY the Prometheus
    sample names (``name{label="v"}``), so the two surfaces agree.

Histogram bucket boundaries are FIXED (``DEFAULT_BUCKETS``, overridable
per histogram at first creation only) so output across runs is
deterministic and diffs cleanly.

Signal-safety: all mutation is plain-dict arithmetic under the GIL — no
locks — so the tracer may observe span durations into a histogram from
the preemption handler's ``drain_open`` without deadlock (the same rule
the sink's lock-free deque enforces; see sink.py's module docstring).
"""
from __future__ import annotations

import bisect
import re
from typing import Optional

# second-scaled latency buckets: 0.5ms .. 10s, fixed for determinism
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _label_str(labels: dict) -> str:
    """Canonical (sorted, escaped) Prometheus label block; "" if none."""
    if not labels:
        return ""
    parts = []
    for k, v in sorted(labels.items()):
        if not _NAME_RE.match(k):
            raise ValueError(f"bad label name {k!r}")
        v = str(v).replace("\\", r"\\").replace('"', r'\"')
        v = v.replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _merge_le(label_key: str, le: str) -> str:
    if not label_key:
        return f'{{le="{le}"}}'
    return label_key[:-1] + f',le="{le}"}}'


def _fmt(v: float) -> str:
    return format(float(v), "g")


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: "dict[str, float]" = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        key = _label_str(labels)
        self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return self._values.get(_label_str(labels), 0.0)

    def samples(self) -> dict:
        return {self.name + k: v for k, v in sorted(self._values.items())}


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: "dict[str, float]" = {}

    def set(self, v: float, **labels) -> None:
        self._values[_label_str(labels)] = float(v)

    def value(self, **labels) -> float:
        return self._values.get(_label_str(labels), 0.0)

    def samples(self) -> dict:
        return {self.name + k: v for k, v in sorted(self._values.items())}


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError("buckets must be strictly increasing")
        self._counts: "dict[str, list]" = {}   # per-bucket (+overflow)
        self._sums: "dict[str, float]" = {}
        self._totals: "dict[str, int]" = {}

    def observe(self, v: float, **labels) -> None:
        key = _label_str(labels)
        row = self._counts.get(key)
        if row is None:
            row = self._counts[key] = [0] * (len(self.buckets) + 1)
            self._sums[key] = 0.0
            self._totals[key] = 0
        # le semantics: v lands in the first bucket with v <= bound
        row[bisect.bisect_left(self.buckets, v)] += 1
        self._sums[key] += float(v)
        self._totals[key] += 1

    def count(self, **labels) -> int:
        return self._totals.get(_label_str(labels), 0)

    def sum(self, **labels) -> float:
        return self._sums.get(_label_str(labels), 0.0)

    def samples(self) -> dict:
        out = {}
        for key in sorted(self._counts):
            out[self.name + key] = {
                "buckets": list(self.buckets),
                "counts": list(self._counts[key]),
                "sum": self._sums[key],
                "count": self._totals[key],
            }
        return out


class MetricsRegistry:
    """Get-or-create registry; re-registering a name with a different
    metric type (or different histogram buckets) is a programming error
    and raises."""

    def __init__(self):
        self._metrics: "dict[str, object]" = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            if not _NAME_RE.match(name):
                raise ValueError(f"bad metric name {name!r}")
            m = self._metrics[name] = cls(name, help, **kwargs)
        elif type(m) is not cls:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}, not {cls.__name__}")
        elif kwargs.get("buckets") is not None \
                and tuple(float(b) for b in kwargs["buckets"]) != m.buckets:
            raise ValueError(f"histogram {name!r} already registered "
                             f"with different buckets")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._get(Histogram, name, help,
                         buckets=buckets if buckets is not None
                         else DEFAULT_BUCKETS)

    def clear(self) -> None:
        self._metrics.clear()

    # -- exposition --------------------------------------------------------
    def snapshot(self, t_s: float, step: Optional[int] = None) -> dict:
        """One ``kind="metric"`` event for the telemetry sink."""
        counters, gauges, histograms = {}, {}, {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                counters.update(m.samples())
            elif isinstance(m, Gauge):
                gauges.update(m.samples())
            else:
                histograms.update(m.samples())
        ev = {"kind": "metric", "t_s": round(float(t_s), 6),
              "counters": counters, "gauges": gauges,
              "histograms": histograms}
        if step is not None:
            ev["step"] = int(step)
        return ev

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                for key in sorted(m._values):
                    lines.append(f"{name}{key} {_fmt(m._values[key])}")
            else:
                for key in sorted(m._counts):
                    cum = 0
                    for bound, c in zip(m.buckets, m._counts[key]):
                        cum += c
                        lines.append(f"{name}_bucket"
                                     f"{_merge_le(key, _fmt(bound))} {cum}")
                    cum += m._counts[key][-1]
                    lines.append(f"{name}_bucket"
                                 f"{_merge_le(key, '+Inf')} {cum}")
                    lines.append(f"{name}_sum{key} {_fmt(m._sums[key])}")
                    lines.append(f"{name}_count{key} {m._totals[key]}")
        return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> dict:
    """Parse Prometheus text exposition back into ``{"types": {name:
    type}, "help": {name: text}, "samples": {sample_name: value}}`` —
    the round-trip half of the exposition contract (label values must
    not contain a literal space followed by nothing; values are the last
    space-separated token, as the format specifies)."""
    types, helps, samples = {}, {}, {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ", 3)
            types[name] = typ
        elif line.startswith("# HELP "):
            _, _, name, rest = line.split(" ", 3)
            helps[name] = rest
        elif line.startswith("#"):
            continue
        else:
            try:
                key, val = line.rsplit(" ", 1)
                samples[key] = float(val)
            except ValueError as e:
                raise ValueError(f"line {lineno}: {line!r}: {e}") from e
    return {"types": types, "help": helps, "samples": samples}


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the launchers and engines share."""
    return _DEFAULT_REGISTRY
