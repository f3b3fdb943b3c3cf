"""SLO classification and goodput accounting for the serving path.

The port's copy of the JAX package's ``obs/slo.py``: the same outcome
vocabulary, window and goodput arithmetic, so the two packages' trackers
report equal snapshots for the same classification sequence. System
health is goodput within an objective, not peak throughput: rejected and
shed requests never enter a latency histogram, so a p99 alone cannot say
that a service answered fast only while refusing half its traffic.

* :class:`LatencyObjective` — the declared per-request objective
  (seconds, submit → durable in journal mode, submit → settled without
  one).
* :class:`SloTracker` — classifies every request that LEFT the service
  into exactly one of :data:`OUTCOMES` (``met`` / ``violated`` /
  ``shed`` / ``rejected`` / ``failed``) and maintains both cumulative
  counts and a sliding window of the last N outcomes, so a drift storm
  shows up as a windowed goodput dip even over a long healthy run.
* ``goodput_within_slo`` — met / offered, offered summing ALL outcome
  buckets: the fraction of OFFERED traffic that completed inside the
  objective. Refused traffic counts against the service, and so does
  traffic lost to a dispatch/journal failure (``failed``).

Like every ``obs`` module: stdlib-only, pure host, write-only (the
tracker never feeds back into admission or settlement), and
deterministic given the same classification sequence.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional, Union

#: Every request that left the service lands in exactly one bucket
#: (``failed`` = lost to a dispatch/journal failure, never settled).
OUTCOMES = ("met", "violated", "shed", "rejected", "failed")

#: Default sliding-window length (outcomes, not seconds): long enough to
#: smooth a batch boundary, short enough that an overload storm moves it
#: within one bench act.
DEFAULT_WINDOW = 512


@dataclass(frozen=True)
class LatencyObjective:
    """A per-request latency objective, in seconds.

    The measurement endpoint is the service's strongest completion
    signal: the durable watermark in journal mode (a reply that could
    still be lost to a crash has not "completed" in any sense an SLO
    should credit), plain settlement otherwise.
    """

    objective_s: float

    def __post_init__(self) -> None:
        if not self.objective_s > 0:
            raise ValueError(
                f"objective_s must be > 0; got {self.objective_s}"
            )

    @classmethod
    def coerce(
        cls, value: Union["LatencyObjective", float, int]
    ) -> "LatencyObjective":
        """A bare number is an objective in seconds."""
        if isinstance(value, cls):
            return value
        return cls(float(value))


def goodput_from_counts(counts: Dict[str, int]) -> Optional[float]:
    """``met / offered`` over an :data:`OUTCOMES`-keyed count mapping.

    ``None`` when nothing has been classified (a fraction of zero offered
    requests is not 1.0 — and not 0.0 either). Unknown keys are ignored,
    so snapshots merged across repeats can carry extra fields.
    """
    offered = sum(int(counts.get(name, 0)) for name in OUTCOMES)
    if offered == 0:
        return None
    return int(counts.get("met", 0)) / offered


class SloTracker:
    """Classify request outcomes against one latency objective.

    Thread-safe (the serving layer classifies from both the event-loop
    thread — shed/rejected — and the dispatch worker — met/violated).
    Pure accounting: nothing here reads a clock; latencies are passed in
    by the caller that measured them.
    """

    def __init__(
        self,
        objective: Union[LatencyObjective, float, int],
        window: int = DEFAULT_WINDOW,
    ) -> None:
        if window < 1:
            raise ValueError("window must be >= 1")
        self.objective = LatencyObjective.coerce(objective)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {name: 0 for name in OUTCOMES}
        self._window: deque = deque(maxlen=window)

    def classify(self, latency_s: float) -> str:
        """``met`` iff *latency_s* is within the objective (no recording)."""
        return (
            "met" if latency_s <= self.objective.objective_s else "violated"
        )

    def record(self, outcome: str) -> str:
        """Count one terminal *outcome* (an :data:`OUTCOMES` member)."""
        if outcome not in self._counts:
            raise ValueError(
                f"outcome must be one of {OUTCOMES}; got {outcome!r}"
            )
        with self._lock:
            self._counts[outcome] += 1
            self._window.append(outcome)
        return outcome

    def record_latency(self, latency_s: float) -> str:
        """Classify one COMPLETED request and count it; returns the
        outcome (``met``/``violated``)."""
        return self.record(self.classify(latency_s))

    def goodput_within_slo(self) -> Optional[float]:
        """Cumulative met / offered (``None`` before any outcome)."""
        with self._lock:
            return goodput_from_counts(self._counts)

    def snapshot(self) -> Dict[str, object]:
        """The accounting as data — what the run ledger records.

        ``{"objective_s", "counts", "offered", "goodput_within_slo",
        "window": {"n", "goodput_within_slo"}}``. ``counts`` merge across
        repeats by per-key summation (:func:`goodput_from_counts` on the
        sum — the ledger's cross-repeat rule).
        """
        with self._lock:
            counts = dict(self._counts)
            window_counts: Dict[str, int] = {name: 0 for name in OUTCOMES}
            for outcome in self._window:
                window_counts[outcome] += 1
        return {
            "objective_s": self.objective.objective_s,
            "counts": counts,
            "offered": sum(counts.values()),
            "goodput_within_slo": goodput_from_counts(counts),
            "window": {
                "n": sum(window_counts.values()),
                "goodput_within_slo": goodput_from_counts(window_counts),
            },
        }
