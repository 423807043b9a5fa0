"""CLI: validate a telemetry JSONL event stream against the schema (a copy
of the JAX package's ``telemetry/validate.py``; the schema is the same).

    python -m repro_torch.telemetry.validate DIR_OR_FILE [--min-events N]
    python -m repro_torch.telemetry.validate RUNS_DIR --glob '**/events-*.jsonl'

Exits 0 when every event parses and conforms (and at least ``N`` events
exist, default 1 — an empty stream usually means the producer was never
wired up); exits 1 with a diagnostic otherwise — an unknown ``kind`` is
a schema violation, never skipped.  ``--glob`` validates nested run
directories (one parent holding many per-run telemetry dirs) in one
pass.  CI runs this against the artifacts the dry-run and observability
smokes emit.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.telemetry.sink import validate_dir, validate_file


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="telemetry directory or one .jsonl file")
    ap.add_argument("--min-events", type=int, default=1)
    ap.add_argument("--prefix", default="events")
    ap.add_argument("--glob", default=None,
                    help="validate every file matching this pattern "
                         "under PATH (e.g. '**/events-*.jsonl' for "
                         "nested run dirs) instead of the flat "
                         "<prefix>-*.jsonl layout")
    args = ap.parse_args(argv)

    p = Path(args.path)
    try:
        if args.glob is not None:
            if not p.is_dir():
                raise ValueError(f"--glob needs a directory, "
                                 f"got {p}")
            files = sorted(p.glob(args.glob), key=str)
            if not files:
                raise ValueError(f"no files match {args.glob!r} "
                                 f"under {p}")
            n = sum(validate_file(f) for f in files)
        elif p.is_dir():
            n = validate_dir(p, prefix=args.prefix)
        else:
            n = validate_file(p)
    except (ValueError, OSError) as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    if n < args.min_events:
        print(f"INVALID: {n} events found, expected >= {args.min_events}",
              file=sys.stderr)
        return 1
    print(f"OK: {n} events conform to schema")
    return 0


if __name__ == "__main__":
    sys.exit(main())
