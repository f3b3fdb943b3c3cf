"""Request-scoped tracing and the flight recorder.

The port's copy of the JAX package's ``obs/trace.py``. A latency
histogram cannot answer "why was request X slow?"; this module is the
attribution layer: every request and every micro-batch gets a chain of
structured span events, and the last N events per component stay
resident in a bounded ring (the flight recorder) so a dispatch or
journal failure has a postmortem artifact.

**Deterministic identity.** Trace ids are never wall-clock, ``id()``, or
random: a request's id is its SUBMIT SEQUENCE NUMBER, and a batch's id is
its flush index. Every event within one ``(scope, key)`` chain carries a
per-chain ordinal assigned in causal order. Two runs of the same request
trace therefore produce IDENTICAL span logs once the two wall fields
(``wall_ts``, ``dur_s``) are masked — the same contract journal epochs
keep with their maskable ``wall_unix_ts``.

**Scopes and propagation.** Three scopes:

* ``request`` — the per-request life cycle, recorded by a serving layer:
  ``enqueue`` → ``window_join`` → ``flush`` → ``settled`` → ``durable``
  (or the terminal ``rejected`` / ``shed`` / ``failed``). A
  :class:`TraceContext` rides each request across threads.
* ``batch`` — the per-micro-batch phases. :meth:`Tracer.batch` installs a
  :class:`TraceTimeline` as the current thread's phase timeline for the
  block, so every ``active_timeline().span(...)`` the state tier takes
  (``fetch``/``journal_fsync``/``interchange_export``/… — the canonical
  :data:`~.timeline.PHASES` vocabulary) lands as a trace span event with
  no new instrumentation at those sites.
* ``journal`` — epoch appends, recorded by the journal writer itself
  (keyed by epoch tag; the writes serialise, so the chain stays
  deterministic even when the append runs on the background writer
  thread).

**Export.** :meth:`Tracer.write_jsonl` dumps the sorted span log one
sorted-key JSON line per event; :func:`to_chrome_trace` converts it to
Chrome trace-event JSON that loads in Perfetto.

Pure host, stdlib-only, write-only — tracing on vs off changes no
settlement byte; disabled is the default and free (one shared null
tracer, one shared no-op scope).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from time import perf_counter
from typing import Dict, List, Optional, Tuple, Union

from bayesian_consensus_engine_tpu_torch.obs.timeline import (
    active_timeline,
    recording,
)

#: Canonical scopes. Anything else is allowed (the vocabulary is open),
#: but the serving wiring sticks to these three so chains compare across
#: runs.
REQUEST_SCOPE = "request"
BATCH_SCOPE = "batch"
JOURNAL_SCOPE = "journal"

#: A request chain's stages in causal order (journal-mode service; a
#: journal-less service ends at ``settled``, a refused request at its
#: terminal ``rejected``/``shed``, a batch-failure casualty at
#: ``failed``, and a settled-but-never-fsynced straggler at
#: ``durable_unconfirmed``).
REQUEST_STAGES = ("enqueue", "window_join", "flush", "settled", "durable")

#: Flight-recorder component per scope (overridable per event).
_COMPONENT_BY_SCOPE = {
    REQUEST_SCOPE: "service",
    BATCH_SCOPE: "driver",
    JOURNAL_SCOPE: "journal",
}


@dataclass(frozen=True)
class TraceContext:
    """The per-request trace identity the serving layer propagates.

    ``seq`` is the submit sequence number — assigned on the event-loop
    thread in submission order, carried on the request object across the
    asyncio boundary onto the dispatch worker, and used as the trace id
    for every event in the request's chain. Deterministic by
    construction: no clock, no randomness, no object identity.
    """

    seq: int
    market_id: str = ""


class Tracer:
    """Structured span-event recorder with a per-component flight ring.

    Events are grouped by ``(scope, key)`` chain; each event gets the
    chain's next ordinal under the tracer lock. :meth:`events` returns
    the retained log sorted by ``(scope, key, ordinal)`` — a
    deterministic order because every chain's events are recorded
    causally (one submitting loop thread, one dispatch worker,
    serialised journal writes). The per-component rings keep the last
    *flight_capacity* events for :meth:`flight_dump`.

    **Bounded by default.** A long-lived traced service must not grow an
    unbounded log (the same rule ``record_batches`` follows):
    *log_capacity* caps the RETAINED span log — past it, the globally
    oldest events are evicted (their chains keep their ordinals, so a
    truncated export is a suffix, never a renumbering). The flight rings
    are unaffected: a postmortem always has the last *flight_capacity*
    events per component. ``log_capacity=None`` keeps everything — for
    bounded runs (tests, benches, trace captures) that export the full
    log.
    """

    enabled = True

    def __init__(
        self,
        flight_capacity: int = 256,
        log_capacity: Optional[int] = 100_000,
    ) -> None:
        if flight_capacity < 1:
            raise ValueError("flight_capacity must be >= 1")
        if log_capacity is not None and log_capacity < 1:
            raise ValueError("log_capacity must be >= 1 (or None)")
        self._lock = threading.Lock()
        self._chains: Dict[Tuple[str, int], List[dict]] = {}
        self._next_seq: Dict[Tuple[str, int], int] = {}
        self._order: deque = deque()  # global FIFO backing log eviction
        self._log_capacity = log_capacity
        self._rings: Dict[str, deque] = {}
        self._flight_capacity = flight_capacity
        #: The most recent :meth:`flight_dump` result (the postmortem the
        #: serving layer keeps when a dispatch/journal failure fired).
        self.last_flight_dump: Optional[dict] = None

    # -- recording -----------------------------------------------------------

    def span_event(
        self,
        scope: str,
        key: int,
        name: str,
        dur_s: Optional[float] = None,
        args: Optional[dict] = None,
        component: Optional[str] = None,
    ) -> dict:
        """Record one event on chain ``(scope, key)``; returns the event.

        ``wall_ts`` (record time) and ``dur_s`` are the ONLY run-varying
        fields — everything else must be a deterministic function of the
        request trace (the caller's contract; no ``id()``, no clock-
        derived ids). ``dur_s`` given means the event describes a span
        ending at ``wall_ts``; absent means an instant.
        """
        event = {
            "scope": str(scope),
            "key": int(key),
            "name": str(name),
            "component": component or _COMPONENT_BY_SCOPE.get(scope, scope),
            "args": dict(args) if args else {},
            "dur_s": None if dur_s is None else float(dur_s),
            "wall_ts": time.time(),
        }
        chain_key = (event["scope"], event["key"])
        with self._lock:
            event["seq"] = self._next_seq.get(chain_key, 0)
            self._next_seq[chain_key] = event["seq"] + 1
            self._chains.setdefault(chain_key, []).append(event)
            if self._log_capacity is not None:
                self._order.append(event)
                while len(self._order) > self._log_capacity:
                    oldest = self._order.popleft()
                    oldest_key = (oldest["scope"], oldest["key"])
                    chain = self._chains[oldest_key]
                    # Chains append in global insertion order, so the
                    # globally oldest event is its chain's head.
                    chain.pop(0)
                    if not chain:
                        del self._chains[oldest_key]
            ring = self._rings.get(event["component"])
            if ring is None:
                ring = self._rings[event["component"]] = deque(
                    maxlen=self._flight_capacity
                )
            ring.append(event)
        return event

    def request_event(
        self,
        ctx: Union[TraceContext, int],
        name: str,
        dur_s: Optional[float] = None,
        args: Optional[dict] = None,
    ) -> dict:
        """Record one stage of a request's chain (component ``service``)."""
        seq = ctx.seq if isinstance(ctx, TraceContext) else int(ctx)
        return self.span_event(
            REQUEST_SCOPE, seq, name, dur_s=dur_s, args=args,
            component="service",
        )

    def batch_event(
        self,
        index: int,
        name: str,
        dur_s: Optional[float] = None,
        args: Optional[dict] = None,
    ) -> dict:
        """Record one event on a batch's chain (component ``driver``)."""
        return self.span_event(
            BATCH_SCOPE, index, name, dur_s=dur_s, args=args,
            component="driver",
        )

    def batch(self, index: int, args: Optional[dict] = None) -> "_BatchScope":
        """Scope one micro-batch's dispatch: ``with tracer.batch(i): ...``.

        For the block, the CURRENT thread's phase timeline is wrapped in
        a :class:`TraceTimeline`, so every canonical phase span the
        pipeline/state tiers take inside lands on batch *index*'s chain
        (exclusive-time accounting still flows to the wrapped timeline
        untouched). On exit one ``batch`` span event records the whole
        scope's wall. Reentrancy is the caller's affair: the serving
        worker and the stream consumer each install exactly one scope
        per batch.
        """
        return _BatchScope(self, int(index), dict(args) if args else {})

    # -- export --------------------------------------------------------------

    def events(self) -> List[dict]:
        """The span log, sorted by ``(scope, key, ordinal)`` — the
        deterministic export order (masking ``wall_ts``/``dur_s`` makes
        two same-trace runs byte-compare equal)."""
        with self._lock:
            keys = sorted(self._chains)
            return [
                dict(event) for key in keys for event in self._chains[key]
            ]

    def write_jsonl(self, path) -> int:
        """Dump the span log: one sorted-key JSON line per event.

        The file is the input to :func:`to_chrome_trace` (Perfetto
        export) after :func:`load_trace_jsonl`.
        Returns the event count.
        """
        events = self.events()
        with open(path, "w", encoding="utf-8") as f:
            for event in events:
                f.write(json.dumps(event, sort_keys=True) + "\n")
        return len(events)

    def ring_depths(self) -> Dict[str, int]:
        """Events currently resident per flight-recorder component ring
        (names sorted) — the ``/snapshot`` telemetry endpoint's measure
        of how much postmortem context a crash would capture right now."""
        with self._lock:
            return {name: len(self._rings[name]) for name in sorted(self._rings)}

    def flight_dump(self, reason: Optional[str] = None) -> dict:
        """Snapshot the per-component rings — the postmortem artifact.

        Each component holds its last *flight_capacity* events oldest-
        first. The serving layer calls this on an unhandled dispatch or
        journal failure (and on ``close()``), so the failing request's
        span chain is in the dump without having kept the full log.
        """
        with self._lock:
            components = {
                name: [dict(event) for event in self._rings[name]]
                for name in sorted(self._rings)
            }
        dump = {
            "reason": reason,
            "capacity": self._flight_capacity,
            "components": components,
            "wall_ts": time.time(),
        }
        self.last_flight_dump = dump
        return dump


class TraceTimeline:
    """Phase-timeline decorator: spans land on a batch's trace chain.

    Delegates the exclusive-time accounting (and the enabled flag) to the
    wrapped timeline untouched — a null inner timeline stays free of
    phase bookkeeping — while every span additionally records its
    INCLUSIVE duration as a span event on the owning batch's chain.
    Installed thread-locally by :meth:`Tracer.batch`; worker threads
    outside a batch scope keep recording nothing, exactly like the plain
    timeline contract.
    """

    def __init__(self, tracer: Tracer, inner, key: int) -> None:
        self._tracer = tracer
        self._inner = inner
        self._key = key

    @property
    def enabled(self) -> bool:
        return self._inner.enabled

    def span(self, name: str) -> "_TracedSpan":
        return _TracedSpan(self, name)

    def add(self, name: str, seconds: float) -> None:
        self._inner.add(name, seconds)

    def totals(self) -> Dict[str, float]:
        return self._inner.totals()

    def counts(self) -> Dict[str, int]:
        return self._inner.counts()


class _TracedSpan:
    """One timeline span mirrored onto the batch chain at exit."""

    __slots__ = ("_inner_span", "_name", "_owner", "_start")

    def __init__(self, owner: TraceTimeline, name: str) -> None:
        self._owner = owner
        self._name = name
        self._inner_span = owner._inner.span(name)

    def __enter__(self) -> "_TracedSpan":
        self._inner_span.__enter__()
        self._start = perf_counter()
        return self

    def __exit__(self, *exc_info: object) -> None:
        duration = perf_counter() - self._start
        self._inner_span.__exit__(*exc_info)
        self._owner._tracer.span_event(
            BATCH_SCOPE, self._owner._key, self._name, dur_s=duration
        )


class _BatchScope:
    """``with tracer.batch(i):`` — the per-batch recording window."""

    __slots__ = ("_args", "_key", "_recording", "_start", "_tracer")

    def __init__(self, tracer: Tracer, key: int, args: dict) -> None:
        self._tracer = tracer
        self._key = key
        self._args = args

    def __enter__(self) -> "_BatchScope":
        self._start = perf_counter()
        self._recording = recording(
            TraceTimeline(self._tracer, active_timeline(), self._key)
        )
        self._recording.__enter__()
        return self

    def __exit__(self, *exc_info: object) -> None:
        self._recording.__exit__(*exc_info)
        self._tracer.span_event(
            BATCH_SCOPE, self._key, "batch",
            dur_s=perf_counter() - self._start, args=self._args,
        )


class _NullScope:
    """Shared no-op batch scope (one instance, no allocation)."""

    __slots__ = ()

    def __enter__(self) -> "_NullScope":
        return self

    def __exit__(self, *exc_info: object) -> None:
        pass


_NULL_SCOPE = _NullScope()


class NullTracer:
    """Disabled-mode tracer: every record is a no-op, every scope the one
    shared null scope. ``enabled`` is the hot-path guard: call sites that
    would build an args dict check it first, so a disabled trace costs
    one attribute read."""

    enabled = False

    def span_event(self, scope, key, name, dur_s=None, args=None,
                   component=None) -> None:
        return None

    def request_event(self, ctx, name, dur_s=None, args=None) -> None:
        return None

    def batch_event(self, index, name, dur_s=None, args=None) -> None:
        return None

    def batch(self, index, args=None) -> _NullScope:
        return _NULL_SCOPE

    def events(self) -> List[dict]:
        return []

    def ring_depths(self) -> Dict[str, int]:
        return {}

    def write_jsonl(self, path) -> int:
        """No events, no file: a disabled tracer never touches disk."""
        return 0

    def flight_dump(self, reason: Optional[str] = None) -> None:
        return None


NULL_TRACER = NullTracer()

_active_tracer = NULL_TRACER


def active_tracer():
    """The process's active tracer (the shared null one when disabled)."""
    return _active_tracer


def set_tracer(tracer) -> object:
    """Install *tracer* (``None`` → disabled); returns the previous one."""
    global _active_tracer
    previous = _active_tracer
    _active_tracer = tracer if tracer is not None else NULL_TRACER
    return previous


# -- Chrome/Perfetto export ---------------------------------------------------

#: One display lane per scope; unknown scopes share a catch-all lane.
_SCOPE_TID = {REQUEST_SCOPE: 1, BATCH_SCOPE: 2, JOURNAL_SCOPE: 3}
_OTHER_TID = 4


def load_trace_jsonl(path) -> List[dict]:
    """Parse a :meth:`Tracer.write_jsonl` span log.

    A torn FINAL line is dropped (a crashed process mid-dump), torn
    interior lines raise — the same tolerance rule as the run ledger.
    """
    events: List[dict] = []
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                break
            raise ValueError(f"{path}: malformed trace line {i + 1}")
    return events


def to_chrome_trace(events: List[dict]) -> dict:
    """Span log → Chrome trace-event JSON (the Perfetto input format).

    Events with a duration become ``"ph": "X"`` complete events (``ts``
    back-computed as ``wall_ts − dur``, microseconds); instants become
    ``"ph": "i"``. Requests, batches, and journal epochs each get their
    own named lane, so a request's chain reads against the batch phases
    that served it. Load the output at https://ui.perfetto.dev (or
    ``chrome://tracing``) — side by side with a device profile when one
    was captured.
    """
    trace_events: List[dict] = [
        {
            "ph": "M", "name": "process_name", "pid": 1, "tid": 0,
            "ts": 0, "args": {"name": "bce-tpu serving"},
        },
    ]
    for label, tid in (
        ("requests", _SCOPE_TID[REQUEST_SCOPE]),
        ("batches", _SCOPE_TID[BATCH_SCOPE]),
        ("journal", _SCOPE_TID[JOURNAL_SCOPE]),
    ):
        trace_events.append(
            {
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "ts": 0, "args": {"name": label},
            }
        )
    for event in events:
        scope = event.get("scope", "")
        tid = _SCOPE_TID.get(scope, _OTHER_TID)
        key = event.get("key", 0)
        args = {"key": key, "seq": event.get("seq", 0)}
        args.update(event.get("args") or {})
        wall = float(event.get("wall_ts") or 0.0)
        dur_s = event.get("dur_s")
        name = f"{scope}:{key} {event.get('name', '?')}"
        if dur_s is not None:
            trace_events.append(
                {
                    "ph": "X", "name": name, "cat": scope or "trace",
                    "pid": 1, "tid": tid,
                    "ts": (wall - float(dur_s)) * 1e6,
                    "dur": float(dur_s) * 1e6, "args": args,
                }
            )
        else:
            trace_events.append(
                {
                    "ph": "i", "s": "t", "name": name,
                    "cat": scope or "trace", "pid": 1, "tid": tid,
                    "ts": wall * 1e6, "args": args,
                }
            )
    return {"displayTimeUnit": "ms", "traceEvents": trace_events}
