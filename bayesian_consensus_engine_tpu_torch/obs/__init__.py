"""obs — host-side observability: metrics, timelines and tracing.

The port's copies of three of the JAX package's ``obs`` modules, with the
same names, phases and export bytes:

* :mod:`~.obs.metrics` — process-local counters/gauges/log-spaced
  histograms with deterministic sorted-JSON export and a zero-overhead
  null-object disabled mode (the default).
* :mod:`~.obs.timeline` — named ``perf_counter`` phase spans with
  exclusive attribution, thread-locally activated, so a run's wall clock
  decomposes additively into the canonical :data:`~.obs.timeline.PHASES`.
* :mod:`~.obs.trace` — request-scoped span chains with deterministic
  ids, a bounded per-component flight recorder, and Chrome/Perfetto
  trace-event export.

The store (``state/tensor_store.py``, ``state/sqlite_store.py``) and the
journal (``state/journal.py``) record into them. The JAX package's other
``obs`` modules (``slo``, ``health``, ``ledger``, ``export``, ``fleet``)
and the pipeline's own spans and counters are not ported yet.

The contract: obs is pure host, stdlib-only, and write-only from the
engine's point of view — enabling it changes no settlement byte.
"""

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
    "MetricsRegistry",
    "NULL_REGISTRY",
    "NULL_TIMELINE",
    "NULL_TRACER",
    "PHASES",
    "PhaseTimeline",
    "REQUEST_STAGES",
    "TraceContext",
    "Tracer",
    "active_timeline",
    "active_tracer",
    "load_trace_jsonl",
    "log_spaced_bounds",
    "metrics_registry",
    "quantile_from_snapshot",
    "recording",
    "set_metrics_registry",
    "set_tracer",
    "to_chrome_trace",
]
