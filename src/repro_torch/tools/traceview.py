"""Trace viewer: reconstruct span waterfalls from a telemetry JSONL
directory (the port's counterpart of the JAX package's
``tools/traceview.py``: the same arguments, output and exit codes).

    PYTHONPATH=src python -m repro_torch.tools.traceview /tmp/trace
    PYTHONPATH=src python -m repro_torch.tools.traceview /tmp/trace --check
    PYTHONPATH=src python -m repro_torch.tools.traceview /tmp/trace \
        --chrome-trace /tmp/trace.json

Prints per-span-kind p50/p95/p99 latency, the train step-time breakdown
(where each step went: data wait / dispatch / device sync / checkpoint,
refresh vs fold steps) when ``train_step`` spans are present, and a
per-request serve waterfall summary when request roots are present.

``--chrome-trace OUT.json`` additionally exports the spans as a
Chrome-trace/Perfetto JSON (load it in ``chrome://tracing`` or
https://ui.perfetto.dev).

``--check`` runs the structural validation (``trace.check_events``) and
exits 1 on any schema violation, negative duration, orphaned parent span,
or serve request whose waterfall is incomplete.  A directory with no span
event exits 1 too.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

from repro_torch.telemetry.trace import (check_events, chrome_trace,
                                         format_breakdown, format_span_stats,
                                         load_events, span_events,
                                         span_stats, step_breakdown)


def serve_waterfalls(events: list) -> dict:
    """Per-request phase summary from the serving engines' span
    waterfalls: one row per ``request`` root span, phases keyed by span
    name (chunked prefill summed)."""
    by_trace = defaultdict(list)
    for e in span_events(events):
        by_trace[e["trace"]].append(e)
    rows = []
    for trace, spans in by_trace.items():
        root = next((s for s in spans if s["name"] == "request"), None)
        if root is None:
            continue
        phases = defaultdict(float)
        chunks = 0
        for s in spans:
            if s is root:
                continue
            phases[s["name"]] += float(s["dur_s"])
            if s["name"] == "prefill_chunk":
                chunks += 1
        attrs = root.get("attrs", {})
        rows.append({
            "trace": trace, "uid": root.get("uid"),
            "total_s": float(root["dur_s"]),
            "tokens": attrs.get("tokens"),
            "rejected": bool(attrs.get("rejected")),
            "prefill_chunks": chunks,
            "phases_s": dict(phases),
        })
    rows.sort(key=lambda r: (r["uid"] is None, r["uid"]))
    return {"requests": len(rows), "rows": rows}


def format_waterfalls(wf: dict, limit: int = 12) -> str:
    """The first ``limit`` rows of :func:`serve_waterfalls` as a table."""
    phase_order = ["queued", "admitted", "prefill", "prefill_chunk",
                   "decode"]
    lines = [f"serve waterfalls ({wf['requests']} requests):",
             f"  {'uid':>5} {'total ms':>9} {'tokens':>6} "
             + " ".join(f"{p + ' ms':>12}" for p in phase_order)]
    for r in wf["rows"][:limit]:
        cells = []
        for p in phase_order:
            v = r["phases_s"].get(p)
            cells.append(f"{v * 1e3:>12.2f}" if v is not None
                         else f"{'-':>12}")
        tok = r["tokens"] if r["tokens"] is not None else "-"
        flag = " REJECTED" if r["rejected"] else ""
        uid = r["uid"] if r["uid"] is not None else "?"
        lines.append(f"  {uid:>5} {r['total_s'] * 1e3:>9.2f} {tok:>6} "
                     + " ".join(cells) + flag)
    if wf["requests"] > limit:
        lines.append(f"  ... {wf['requests'] - limit} more")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="telemetry directory or one .jsonl file")
    ap.add_argument("--glob", default=None,
                    help="event-file glob under PATH (default "
                         "'events-*.jsonl'; e.g. '**/events-*.jsonl' "
                         "for nested run dirs)")
    ap.add_argument("--chrome-trace", default=None, metavar="OUT.json",
                    help="export spans as Chrome-trace/Perfetto JSON")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on schema violations, orphaned spans or "
                         "incomplete request waterfalls")
    args = ap.parse_args(argv)

    events = load_events(args.path, pattern=args.glob)
    spans = span_events(events)
    if not spans:
        print(f"no kind=\"span\" events under {args.path}",
              file=sys.stderr)
        return 1
    print(f"{len(events)} events, {len(spans)} spans, "
          f"{len({e['trace'] for e in spans})} traces\n")
    print(format_span_stats(span_stats(events)))

    bd = step_breakdown(events)
    if bd["steps"]:
        print()
        print(format_breakdown(bd))

    wf = serve_waterfalls(events)
    if wf["requests"]:
        print()
        print(format_waterfalls(wf))

    if args.chrome_trace:
        out = Path(args.chrome_trace)
        out.write_text(json.dumps(chrome_trace(events)))
        print(f"\nchrome trace -> {out}")

    if args.check:
        problems = check_events(events)
        if problems:
            print(f"\nCHECK FAILED ({len(problems)} problems):",
                  file=sys.stderr)
            for p in problems:
                print(f"  {p}", file=sys.stderr)
            return 1
        print("\ncheck OK: schema valid, no orphans, waterfalls complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
