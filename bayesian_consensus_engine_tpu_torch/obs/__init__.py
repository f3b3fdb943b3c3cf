"""obs — host-side observability: metrics, timelines, tracing, SLO, ledger.

The port's copies of the JAX package's ``obs`` modules, with the same
metric names, span names, bucket layouts and export bytes. Five pillars,
one contract:

* :mod:`~.obs.metrics` — process-local counters/gauges/log-spaced
  histograms with deterministic sorted-JSON export and a zero-overhead
  null-object disabled mode (the default).
* :mod:`~.obs.timeline` — named ``perf_counter`` phase spans with
  exclusive attribution, thread-locally activated, so a run's wall clock
  decomposes additively into the canonical :data:`~.obs.timeline.PHASES`.
* :mod:`~.obs.trace` — request-scoped span chains with deterministic
  ids, a bounded per-component flight recorder, and Chrome/Perfetto
  trace-event export.
* :mod:`~.obs.slo` — per-request latency objectives and goodput
  accounting (met / violated / shed / rejected / failed →
  ``goodput_within_slo``, cumulative and windowed).
* :mod:`~.obs.ledger` — an append-only JSONL record of measurements
  (host load, backend, repeat index) plus the min-of-N repeat-policy
  helpers and their renderers.

The read side — the live telemetry plane — is three modules that are not
re-exported here (importers name them): :mod:`~.obs.export` (the stdlib
HTTP exporter: deterministic ``/metrics``, ``/snapshot``, ``/healthz``),
:mod:`~.obs.fleet` (deterministic cross-host snapshot merge with
explicit ``hosts_absent``) and :mod:`~.obs.health` (multi-window SLO
burn-rate verdicts).

The store (``state/tensor_store.py``, ``state/sqlite_store.py``), the
journal (``state/journal.py``), the pipeline (``pipeline.py``: its phase
spans, the ``ingest.*``/``intern.*`` counters and the stream's
``stream.*`` counters and gauges) and the serve driver
(``serve/driver.py``: the resident session's counters and the ``hbm.*``
gauges) record into them.

The contract: obs is pure host, stdlib-only, and write-only from the
engine's point of view — enabling it changes no settlement byte.
"""

from bayesian_consensus_engine_tpu_torch.obs.ledger import (
    RunLedger,
    diff_bands,
    host_snapshot,
    min_of_repeats,
    read_ledger,
    render_diff,
    summarize,
)
from bayesian_consensus_engine_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_REGISTRY,
    log_spaced_bounds,
    metrics_registry,
    quantile_from_snapshot,
    set_metrics_registry,
)
from bayesian_consensus_engine_tpu_torch.obs.slo import (
    LatencyObjective,
    OUTCOMES,
    SloTracker,
    goodput_from_counts,
)
from bayesian_consensus_engine_tpu_torch.obs.timeline import (
    NULL_TIMELINE,
    PHASES,
    PhaseTimeline,
    active_timeline,
    recording,
)
from bayesian_consensus_engine_tpu_torch.obs.trace import (
    NULL_TRACER,
    REQUEST_STAGES,
    TraceContext,
    Tracer,
    active_tracer,
    load_trace_jsonl,
    set_tracer,
    to_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LatencyObjective",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "NULL_TIMELINE",
    "NULL_TRACER",
    "OUTCOMES",
    "PHASES",
    "PhaseTimeline",
    "REQUEST_STAGES",
    "RunLedger",
    "SloTracker",
    "TraceContext",
    "Tracer",
    "active_timeline",
    "active_tracer",
    "diff_bands",
    "goodput_from_counts",
    "host_snapshot",
    "load_trace_jsonl",
    "log_spaced_bounds",
    "metrics_registry",
    "min_of_repeats",
    "quantile_from_snapshot",
    "read_ledger",
    "recording",
    "render_diff",
    "set_metrics_registry",
    "set_tracer",
    "summarize",
    "to_chrome_trace",
]
