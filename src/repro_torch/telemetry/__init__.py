"""repro_torch.telemetry: optimizer observability and closed-loop refresh
control, the port of the JAX package's ``repro.telemetry``.  It imports
neither JAX nor the JAX package; the stdlib modules (``controller``,
``sink``, ``validate``, ``metrics``, ``trace``) are copies of the JAX
package's, so the two packages write one event schema.

Three layers, as in JAX:

  Collection (snapshot.py; ``AdapproxConfig.telemetry``)
      ``TelemetrySnapshot``: per-leaf xi, effective rank k, rank occupancy
      k / k_max, update-RMS clip activation, refresh and fold counters and
      the cadence in effect, assembled inside ``scale_by_adapprox``'s
      update from values the update already computes (the updates are
      bitwise those with telemetry off) and carried in the optimizer state,
      so it checkpoints with it; ``SketchSnapshot`` does the same for the
      count-min sketch (``SketchConfig.telemetry``).  The counters are
      host numbers; the per-leaf vectors reach the host in at most one
      copy a step (the snapshot module says how).  ``collect.py`` walks
      any chain or partition state for named snapshots and scalar
      aggregates (``telemetry_metrics``, merged into the step metrics).

  Host-side sink (sink.py)
      ``TelemetrySink``: async, buffered JSONL writer with size-based
      rotation (``events-NNNNN.jsonl``), one stream and one schema for the
      optimizer snapshots, cadence decisions, guard faults, the straggler
      monitor, spans and metric snapshots; ``validate_event`` /
      ``validate_dir`` are the machine check
      (``python -m repro_torch.telemetry.validate DIR``).

  Closed-loop controller (controller.py + runtime.py; ``--auto-refresh``)
      ``RefreshController``: deterministic, checkpointable hysteresis
      feedback that retunes ``refresh_every`` per parameter group from the
      observed xi (tighten when xi regresses, relax after sustained calm,
      a dead band between).  It needs ``AdapproxConfig.dynamic_refresh``,
      which carries the cadence on the optimizer state.
      ``TelemetryRuntime`` is the train loop's handle on all three
      (``train_loop.train(..., telemetry=runtime)``).

Span tracing (trace.py) and the metrics registry (metrics.py) write to the
same sink: ``train_step`` spans with ``data_wait`` / ``step_dispatch`` /
``device_sync`` children and a refresh-or-fold ``phase``, the checkpoint
spans, and ``kind="metric"`` registry snapshots with a Prometheus text
exposition.

The JSONL event schema (version 1) is the JAX package's, kind for kind
and field for field: ``sink.EVENT_SCHEMA`` is its machine form and the JAX
package's ``repro.telemetry`` docstring its field reference.  A port stream
passes the JAX package's validator and ``tools/traceview.py --check``, and
a JAX stream passes the port's.
"""
from repro_torch.telemetry.collect import (chain_guard_state,
                                           get_refresh_every,
                                           named_guard_states,
                                           named_sketch_snapshots,
                                           named_sketch_states,
                                           named_snapshots, named_states,
                                           set_refresh_every,
                                           telemetry_metrics)
from repro_torch.telemetry.controller import (CadenceChange,
                                              ControllerConfig,
                                              RefreshController)
from repro_torch.telemetry.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                           Histogram, MetricsRegistry,
                                           default_registry,
                                           parse_prometheus)
from repro_torch.telemetry.runtime import TelemetryRuntime
from repro_torch.telemetry.trace import (NULL_TRACER, NullTracer, Tracer,
                                         check_events, chrome_trace,
                                         format_breakdown, format_span_stats,
                                         load_events, span_stats,
                                         step_breakdown)
from repro_torch.telemetry.sink import (EVENT_SCHEMA, SCHEMA_VERSION,
                                        SinkConfig, TelemetrySink,
                                        validate_dir, validate_event,
                                        validate_file)
from repro_torch.telemetry.snapshot import (SketchSnapshot,
                                            TelemetrySnapshot,
                                            init_sketch_snapshot,
                                            init_snapshot, snapshot_spec)
