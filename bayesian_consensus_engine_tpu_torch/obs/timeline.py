"""Host-side phase timeline: named ``perf_counter`` spans with exclusive
attribution.

The port's copy of the JAX package's ``obs/timeline.py``. A batch's host
phases (pack, upload, settle dispatch, fetch, journal fsync, interchange
export) get NAMES and one accounting rule here, so a run's wall clock
decomposes into an additive breakdown instead of overlapping stopwatch
readings:

* **Canonical phase vocabulary** — :data:`PHASES`. Callers may record any
  name, but the store and journal wiring sticks to this set so captures
  compare across runs and across the two packages.
* **Exclusive attribution** — a span nested inside another span charges
  its parent only for the parent's OWN time (parent total minus child
  totals). ``checkpoint`` wrapping a journal append therefore reports the
  drain/snapshot overhead while the fsync inside reports as
  ``journal_fsync`` — the two sum to the outer wall time instead of
  double-counting it.
* **Thread-local activation** — :func:`recording` installs a timeline for
  the CURRENT thread only. Worker threads (background SQLite flush,
  background journal epoch) deliberately record nothing: their work
  overlaps the consumer's wall clock by design, and charging it to the
  timeline would make the phase sum exceed the wall it is meant to
  decompose.

Disabled is the default and free: :func:`active_timeline` returns a
shared null timeline whose ``span()`` hands back one reusable no-op
context manager — no ``perf_counter`` read, no allocation. Timing spans
never touch settlement data, so results are byte-exact with a timeline
active.

Stdlib-only.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from time import perf_counter
from typing import Dict, Optional

#: Canonical phase names, in pipeline order. ``pack`` is the consumer's
#: wait on plan ingest (the non-overlapped part of pack/intern/fill);
#: ``upload`` is host→device state/plan transfer; ``state_adopt`` is the
#: resident sharded session carrying its device block onto a new plan's
#: layout after a topology miss (host traffic scales with rows entering
#: the active set — the steady-state topology HIT records nothing here);
#: ``settle_dispatch`` is the unfenced kernel dispatch; ``analytics`` is
#: the analytics tier's own overhead beside a fused dispatch — graph
#: alignment/upload and fused-program resolution; the kernel time stays
#: on ``settle_dispatch`` and the shared preamble/commit stay where
#: plain ``settle`` leaves them (exclusive nesting, so the additive sum
#: still ≡ wall); ``fetch`` is the
#: deferred device→host merge; ``journal_fsync`` is the durability
#: write+fsync (on the caller's thread only — an async epoch's fsync runs
#: on a worker thread, which by design records nothing);
#: ``journal_async_wait`` is the consumer's join on an in-flight
#: background epoch (near zero when the write overlapped the batches
#: between cadences — the async-durability win is literally this phase
#: staying empty); ``checkpoint`` is checkpoint-call overhead around the
#: inner phases; ``interchange_export`` is the SQLite interchange write.
#: ``replay`` is the counterfactual replay lab's phase (``replay/``):
#: trace-frame capture inside a recording ``settle_stream``, and the
#: sweep's per-batch device dispatch when a replay harness runs under a
#: recording timeline.
PHASES = (
    "pack",
    "upload",
    "state_adopt",
    "settle_dispatch",
    "analytics",
    "fetch",
    "journal_fsync",
    "journal_async_wait",
    "checkpoint",
    "interchange_export",
    "replay",
)

_tls = threading.local()


class _Span:
    """One live span; exclusive time lands on the timeline at exit."""

    __slots__ = ("_child_s", "_name", "_parent", "_start", "_timeline")

    def __init__(self, timeline: "PhaseTimeline", name: str) -> None:
        self._timeline = timeline
        self._name = name

    def __enter__(self) -> "_Span":
        self._parent = getattr(_tls, "span", None)
        _tls.span = self
        self._child_s = 0.0
        self._start = perf_counter()
        return self

    def __exit__(self, *exc_info: object) -> None:
        duration = perf_counter() - self._start
        _tls.span = self._parent
        if self._parent is not None:
            self._parent._child_s += duration
        self._timeline.add(self._name, duration - self._child_s)


class PhaseTimeline:
    """Accumulated exclusive seconds (and span counts) per phase name."""

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seconds: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add(self, name: str, seconds: float) -> None:
        """Record *seconds* of exclusive time against phase *name*."""
        with self._lock:
            self._seconds[name] = self._seconds.get(name, 0.0) + seconds
            self._counts[name] = self._counts.get(name, 0) + 1

    def totals(self) -> Dict[str, float]:
        """Copy of per-phase exclusive seconds, names sorted."""
        with self._lock:
            return {name: self._seconds[name] for name in sorted(self._seconds)}

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {name: self._counts[name] for name in sorted(self._counts)}

    @staticmethod
    def delta(before: Dict[str, float], after: Dict[str, float]) -> Dict[str, float]:
        """Per-phase seconds elapsed between two :meth:`totals` snapshots
        (phases that did not advance are omitted)."""
        out = {}
        for name in sorted(after):
            gained = after[name] - before.get(name, 0.0)
            if gained > 0.0:
                out[name] = gained
        return out


class _NullSpan:
    """Reusable no-op context manager (one shared instance)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc_info: object) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _NullTimeline:
    """Disabled-mode timeline: ``span()`` is allocation-free."""

    enabled = False

    def span(self, name: str) -> _NullSpan:
        return _NULL_SPAN

    def add(self, name: str, seconds: float) -> None:
        pass

    def totals(self) -> Dict[str, float]:
        return {}

    def counts(self) -> Dict[str, int]:
        return {}


NULL_TIMELINE = _NullTimeline()


def active_timeline():
    """This THREAD's active timeline (the shared null one by default)."""
    return getattr(_tls, "timeline", NULL_TIMELINE)


@contextmanager
def recording(timeline: Optional[PhaseTimeline]):
    """Install *timeline* as this thread's active timeline for the block.

    ``None`` records nothing (explicitly disables inside an outer
    recording). Restores the previous timeline on exit, so recordings
    nest.
    """
    previous = getattr(_tls, "timeline", NULL_TIMELINE)
    _tls.timeline = timeline if timeline is not None else NULL_TIMELINE
    try:
        yield _tls.timeline
    finally:
        _tls.timeline = previous
