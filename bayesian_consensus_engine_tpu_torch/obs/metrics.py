"""Process-local metrics: counters, gauges, and log-spaced histograms.

The port's copy of the JAX package's ``obs/metrics.py``: the same metric
names, bucket layout and export bytes, so the two packages' registries
dump equal JSON for the same calls. One home for process-local
instrumentation:

* :class:`Counter` — monotone event count (journal epochs appended, rows
  written).
* :class:`Gauge` — last-written value (pending chain depth, store rows).
* :class:`Histogram` — fixed-bound, log-spaced duration/size buckets.
  Bounds are frozen at construction: a changed bucket edge silently
  re-bins every historical capture, so the layout is part of the schema.

**Export is deterministic**: :meth:`MetricsRegistry.export` sorts every
name and :meth:`MetricsRegistry.to_json` dumps with sorted keys and fixed
separators, so two registries that saw the same observations produce the
same BYTES regardless of registration order.

**Disabled mode is the default** and costs nothing on the hot path: the
module-level registry starts as :data:`NULL_REGISTRY`, whose
``counter``/``gauge``/``histogram`` all return one shared no-op metric
object — no allocation, no locking, no branching at the call site.
Callers write ``metrics_registry().counter("x").inc()`` unconditionally;
enabling observability (``set_metrics_registry(MetricsRegistry())``) is
the only switch. Settlement math never reads a metric back: obs is
write-only from the engine's point of view.

Stdlib-only: the store, the journal and scripts import it, and it never
pulls torch or numpy into them.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, Optional, Sequence, Tuple


class Counter:
    """Monotonically increasing event counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-written value (not aggregated; a snapshot, not a rate)."""

    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


def log_spaced_bounds(
    lo: float, hi: float, per_decade: int
) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds from *lo* to *hi* inclusive.

    ``bound(i) = lo * 10**(i / per_decade)`` — a pure closed form, so the
    layout is reproducible from its three parameters alone (and pinned by
    tests). *hi* must be a whole number of decades above *lo*.
    """
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(
            f"need 0 < lo < hi and per_decade >= 1; got {lo}, {hi}, "
            f"{per_decade}"
        )
    decades = math.log10(hi / lo)
    steps = round(decades * per_decade)
    if abs(decades * per_decade - steps) > 1e-9:
        raise ValueError(
            f"hi/lo spans {decades} decades — not a whole multiple of "
            f"1/{per_decade} decade steps"
        )
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(steps + 1))


#: Default histogram layout: 1 µs → 100 s, 2 buckets per decade (17 edges,
#: 18 counting the +inf overflow bucket). Durations in seconds — the span
#: from a null-op timer tick to a full interchange export.
DEFAULT_BOUNDS = log_spaced_bounds(1e-6, 100.0, 2)


class Histogram:
    """Fixed-bound log-spaced histogram.

    ``bounds`` are UPPER bucket edges (value ≤ edge lands in that bucket);
    values above the last edge land in the implicit overflow bucket, so
    ``len(counts) == len(bounds) + 1``. ``sum``/``count`` ride along for
    mean computation without the bucket-resolution loss.
    """

    __slots__ = ("_bounds", "_counts", "_count", "_lock", "_sum")

    def __init__(self, bounds: Optional[Sequence[float]] = None) -> None:
        self._bounds = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        if list(self._bounds) != sorted(self._bounds):
            raise ValueError("histogram bounds must be sorted ascending")
        self._counts = [0] * (len(self._bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    @property
    def bounds(self) -> Tuple[float, ...]:
        return self._bounds

    def observe(self, value: float) -> None:
        value = float(value)
        # Linear scan is fine: bucket counts are small and fixed; bisect
        # would save nothing measurable at 18 edges.
        index = len(self._bounds)
        for i, edge in enumerate(self._bounds):
            if value <= edge:
                index = i
                break
        with self._lock:
            self._counts[index] += 1
            self._count += 1
            self._sum += value

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "bounds": list(self._bounds),
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
            }

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (see
        :func:`quantile_from_snapshot`); ``None`` before any observation."""
        return quantile_from_snapshot(self.snapshot(), q)

    def summary(
        self, quantiles: Sequence[float] = (0.5, 0.99)
    ) -> Dict[str, object]:
        """``{"count", "sum", "p50", "p99", ...}`` — the latency digest a
        load report quotes. Quantile keys are ``p`` + the percentile with
        any fractional digits retained (``0.999`` → ``"p99.9"``)."""
        snap = self.snapshot()
        out: Dict[str, object] = {"count": snap["count"], "sum": snap["sum"]}
        for q in quantiles:
            out[f"p{q * 100:g}"] = quantile_from_snapshot(snap, q)
        return out


def quantile_from_snapshot(
    snapshot: Dict[str, object], q: float
) -> Optional[float]:
    """Quantile *q* of a :meth:`Histogram.snapshot`-shaped dict.

    The standard bucket interpolation (what Prometheus'
    ``histogram_quantile`` computes): find the bucket where the
    cumulative count crosses ``q * count`` and interpolate linearly
    between its lower and upper edges (the first bucket's lower edge is
    0). A rank landing exactly on a bucket's cumulative count returns
    that bucket's UPPER edge exactly — the log-spaced layout makes every
    published quantile reproducible from counts alone, with resolution
    bounded by the bucket width (½ decade at the default layout). Ranks
    in the overflow bucket clamp to the last finite edge (reported as a
    lower bound, never an invented value). ``None`` when the histogram
    is empty. Works on merged snapshots too — sum the ``counts`` of
    same-``bounds`` histograms first (the ledger's cross-repeat path).
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1]; got {q}")
    bounds = list(snapshot["bounds"])
    counts = list(snapshot["counts"])
    total = sum(counts)
    if total == 0:
        return None
    target = q * total
    cumulative = 0.0
    for i, bucket_count in enumerate(counts):
        if bucket_count == 0:
            continue
        if cumulative + bucket_count >= target:
            if i >= len(bounds):
                return bounds[-1] if bounds else None  # overflow: clamp
            lower = bounds[i - 1] if i > 0 else 0.0
            upper = bounds[i]
            fraction = (target - cumulative) / bucket_count
            return lower + (upper - lower) * min(max(fraction, 0.0), 1.0)
        cumulative += bucket_count
    return bounds[-1] if bounds else None


class MetricsRegistry:
    """Named metric namespace with deterministic export.

    One instance per enabled scope (a bench leg, a soak run). Metric
    creation is idempotent — ``counter("x")`` returns the same object on
    every call — so call sites need no registration phase.
    """

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            metric = self._counters.get(name)
            if metric is None:
                metric = self._counters[name] = Counter()
            return metric

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            metric = self._gauges.get(name)
            if metric is None:
                metric = self._gauges[name] = Gauge()
            return metric

    def histogram(
        self, name: str, bounds: Optional[Sequence[float]] = None
    ) -> Histogram:
        with self._lock:
            metric = self._histograms.get(name)
            if metric is None:
                metric = self._histograms[name] = Histogram(bounds)
            elif bounds is not None and tuple(bounds) != metric.bounds:
                raise ValueError(
                    f"histogram {name!r} already exists with different "
                    "bounds — the layout is fixed at first creation"
                )
            return metric

    def export(self) -> Dict[str, Dict[str, object]]:
        """Plain-dict snapshot, every name in sorted order."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            histograms = sorted(self._histograms.items())
        return {
            "counters": {name: c.value for name, c in counters},
            "gauges": {name: g.value for name, g in gauges},
            "histograms": {name: h.snapshot() for name, h in histograms},
        }

    def to_json(self) -> str:
        """Byte-deterministic export: sorted keys, fixed separators."""
        return json.dumps(
            self.export(), sort_keys=True, separators=(",", ":")
        )


class _NullMetric:
    """Shared do-nothing Counter/Gauge/Histogram stand-in."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def quantile(self, q: float) -> None:
        return None

    def summary(
        self, quantiles: Sequence[float] = (0.5, 0.99)
    ) -> Dict[str, object]:
        out: Dict[str, object] = {"count": 0, "sum": 0.0}
        for q in quantiles:
            out[f"p{q * 100:g}"] = None
        return out

    @property
    def value(self) -> int:
        return 0


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Disabled-mode registry: every lookup returns ONE shared no-op
    metric (identity pinned by tests — the zero-overhead proof is that no
    object is ever allocated and no lock ever taken on the hot path)."""

    enabled = False

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def histogram(
        self, name: str, bounds: Optional[Sequence[float]] = None
    ) -> _NullMetric:
        return _NULL_METRIC

    def export(self) -> Dict[str, Dict[str, object]]:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def to_json(self) -> str:
        return json.dumps(
            self.export(), sort_keys=True, separators=(",", ":")
        )


NULL_REGISTRY = NullRegistry()

_active_registry = NULL_REGISTRY


def metrics_registry():
    """The process's active registry (the shared null one when disabled)."""
    return _active_registry


def set_metrics_registry(registry) -> object:
    """Install *registry* (``None`` → disabled); returns the previous one."""
    global _active_registry
    previous = _active_registry
    _active_registry = registry if registry is not None else NULL_REGISTRY
    return previous
