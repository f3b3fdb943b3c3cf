"""`ConsensusService` — online micro-batch coalescing over the resident
settlement session.

The port's copy of the JAX package's ``serve/coalesce.py``. Callers
submit per-market signal updates and outcome reports one at a time; the
service coalesces them into topology-stable micro-batches and drives ONE
:class:`~.serve.driver.SessionDriver` — the loop body of
:func:`~.pipeline.settle_stream` — so the served path gives the stream's
results, store state, journal epochs and SQLite bytes over the same
coalesced batch sequence, and the JAX package's on the same trace.

**Coalescing.** Requests accumulate in an ordered list of open
*windows*. A request joins the FIRST window that does not already hold
its market and has room (two slots of one market in one plan would race
in the scatter, so a same-market successor joins a later window, and a
market's updates settle in submission order, one batch apart). A window
flushes when it reaches ``max_batch`` markets, when its oldest request
has waited ``max_delay_s``, or on :meth:`drain`/:meth:`close`; windows
flush oldest first, so the batch sequence, and every byte derived from
it, is a function of the submission order.

Steady traffic re-creates identically composed windows, so consecutive
batches share a topology fingerprint: the :class:`~.serve.driver.PlanCache`
serves them with a probability-only refresh and the resident session
uploads one probability block a batch. Drifted traffic misses the
fingerprint once and pays one session ``adopt()``.

**Tenant classes.** ``qos=`` declares
:class:`~.serve.admission.QosClass` classes; every submit lands in one
(``qos_class=`` names it; ``None`` takes the first declared). Each class
runs its own latency objective, admission budget, overload policy and,
with ``shed_when_burning``, its own burn-rate monitor. Shedding is
variance-aware (:func:`~.serve.admission.shed_rank_key`): the victim is
the pending request whose market the analytics tier reports widest
(highest ``band_stderr``, kept live from analytics dispatches or seeded
with :meth:`ConsensusService.seed_band_stderr`), ties oldest first. The
class decision runs before the service-wide bound; a single-tenant
service (``qos=None``) takes none of these paths.

**Admission.** ``admission`` bounds the requests resident in the service
(submitted, not yet settled). At the bound ``policy="reject"`` refuses
the arrival with :class:`~.serve.admission.Overloaded` and
``policy="shed_oldest"`` drops a not-yet-flushed request in favour of
the arrival (its future fails with :class:`~.serve.admission.ShedError`);
with nothing left to shed it degrades to rejection.

**Latency accounting.** Each request's life is recorded in the process
metrics registry (no-ops unless obs is enabled):
``serve.latency_enqueue_s``, ``serve.latency_coalesce_s``,
``serve.latency_dispatch_s``, ``serve.latency_durable_s`` (journal mode)
and ``serve.latency_total_s``. Only completed requests enter the
histograms; shed and rejected ones are counted in ``serve.shed`` /
``serve.rejected`` and classified by the SLO tracker.

**Tracing and SLO.** With a tracer active (:func:`~.obs.trace.set_tracer`)
every request carries a :class:`~.obs.trace.TraceContext` whose id is its
submit sequence number, and its chain (``enqueue`` → ``window_join`` →
``flush`` → ``settled`` → ``durable``, or a terminal ``rejected``/
``shed``/``failed``) is recorded across the event loop → worker
boundary. On a dispatch or journal failure, and on :meth:`close`, the
service snapshots the flight recorder into :attr:`flight_dump`.
``slo=`` classifies every request that left the service as met /
violated / shed / rejected / failed; :meth:`goodput` summarises it. Both
are write-only: on or off, no settlement byte moves.

**Threads and the device.** Coalescing runs on the asyncio event-loop
thread, which never touches a tensor: it only builds host columns and
resolves futures with Python floats. Settlement runs on ONE dispatch
worker thread, inside the store's device scope (``torch.cuda.device``
of the store's card, fixed when the service is built), so a launch
never depends on the worker's current device. Each batch's consensus
and analytics columns come to the host in one copy on that worker,
before its checkpoint; every per-request float is then read from host
arrays. A second single-thread executor, the pack thread, runs the
store-free half of each batch's plan build
(:meth:`~.serve.driver.PlanCache.stage`: fingerprint, grouping, the
probability-only refresh on a hit — host arrays only) while the
previous batch holds the card; the dispatch worker waits for the staged
result and, on a miss, finishes the interning and block assembly
(:meth:`~.serve.driver.PlanCache.bind`) in batch order. Interning never
leaves the dispatch thread, so the served bytes stay a function of the
submission order; a bound-event chain sequences ``stage(N+1)`` after
``bind(N)``, which makes the plan-cache decisions exactly
:class:`~.pipeline.PlanPrefetcher`'s. The worker's wait is the ``pack``
phase span and accumulates in the ``serve.ingest_wait_s`` gauge.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import threading
import time as _time
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.obs.health import (
    DEFAULT_WINDOWS,
    HealthMonitor,
)
from bayesian_consensus_engine_tpu_torch.obs.metrics import metrics_registry
from bayesian_consensus_engine_tpu_torch.obs.slo import SloTracker
from bayesian_consensus_engine_tpu_torch.obs.timeline import active_timeline
from bayesian_consensus_engine_tpu_torch.obs.trace import TraceContext, active_tracer
from bayesian_consensus_engine_tpu_torch.ops.propagate import PropagatedBeliefs
from bayesian_consensus_engine_tpu_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    Overloaded,
    QosClass,
    ServiceClosed,
    ShedError,
    shed_rank_key,
)
from bayesian_consensus_engine_tpu_torch.serve.driver import PlanCache, SessionDriver

Signal = Union[Mapping[str, Any], tuple]


@dataclass(frozen=True)
class ServeResult:
    """What a settled request's future resolves to.

    The analytics fields are populated only under
    ``ConsensusService(analytics=...)``: ``band_lo``/``band_hi`` bound
    the credible interval around the point consensus,
    ``band_stderr`` is its standard error, and ``propagated`` is the
    graph-relaxed consensus when the options carry a
    :class:`~.analytics.graph.MarketGraph`. Under the moments sweep
    (``AnalyticsOptions(inference=...)``) ``propagated_stderr``
    additionally carries the sweep's propagated standard error — the
    neighbour-tightened uncertainty that also refreshes the
    variance-aware shed ranking. All ``None`` with analytics off — and
    the point ``consensus`` is byte-identical either way (the
    analytics on/off parity contract)."""

    market_id: str
    consensus: float
    batch_index: int
    band_lo: Optional[float] = None
    band_hi: Optional[float] = None
    band_stderr: Optional[float] = None
    propagated: Optional[float] = None
    propagated_stderr: Optional[float] = None


class AdaptiveWindow:
    """Deterministic max-delay controller aimed at a latency SLO.

    Without it the coalescer takes a FIXED ``max_delay_s``; this
    controller aims the window at a target p99 instead: every completed
    batch feeds its requests' submit→settled latencies in and nudges the
    delay multiplicatively —
    HALVE when the observed p99 overshoots the target (smaller windows,
    lower queueing delay), grow by 25% when p99 sits below half the
    target (larger windows, better coalescing), hold in between —
    clamped to ``[floor_s, cap_s]``.

    The observation window RESETS at every :meth:`step`: each nudge
    reads the p99 of the latencies observed since the previous nudge
    (one batch's worth in the service wiring), not a lifetime-
    cumulative quantile — a cumulative view would freeze the controller
    as uptime grows (a latency regression is invisible until it
    outweighs 1% of all history). The p99 itself is EXACT over the
    window's raw latencies (a sort per nudge, bounded by the batch
    size), not a log-bucket estimate: the serving histograms' bucket
    edges overestimate a quantile by up to a half-decade bucket, which
    against an exact threshold would pin a comfortably-within-SLO
    service at the window floor forever. The multiplicative ±steps
    give the smoothing; the window gives the responsiveness.

    Deterministic by construction: the nudge sequence is a pure
    function of the observed latency sequence and its batching (fixed
    factors, exact order statistics, reset points at the trace's own
    batch boundaries, no wall-clock reads of its own) — a fixed trace
    of latencies yields a fixed window sequence.
    """

    def __init__(
        self,
        target_p99_s: float,
        initial_delay_s: float,
        floor_s: Optional[float] = None,
        cap_s: Optional[float] = None,
    ) -> None:
        if target_p99_s <= 0:
            raise ValueError("target_p99_s must be > 0")
        if initial_delay_s <= 0:
            raise ValueError(
                "adaptive windowing needs a positive initial max_delay_s"
            )
        self.target_p99_s = float(target_p99_s)
        self.delay_s = float(initial_delay_s)
        self.floor_s = (
            float(floor_s) if floor_s is not None
            else min(initial_delay_s, self.target_p99_s / 100.0)
        )
        self.cap_s = (
            float(cap_s) if cap_s is not None else 4.0 * initial_delay_s
        )
        self._window: list = []
        #: Every applied delay, in batch order — the window sequence the
        #: determinism test replays.
        self.delay_log: list = [self.delay_s]

    def observe(self, latency_s: float) -> None:
        """Feed one completed request's submit→settled latency."""
        self._window.append(latency_s)

    def step(self) -> float:
        """One nudge over the latencies observed since the last nudge
        (call once per completed batch); returns the new delay, also
        appended to :attr:`delay_log`. Resets the observation window."""
        p99 = None
        if self._window:
            ordered = sorted(self._window)
            p99 = ordered[
                max(0, -(-99 * len(ordered) // 100) - 1)
            ]
            self._window = []
        if p99 is not None:
            if p99 > self.target_p99_s:
                self.delay_s *= 0.5
            elif p99 < 0.5 * self.target_p99_s:
                self.delay_s *= 1.25
            self.delay_s = min(max(self.delay_s, self.floor_s), self.cap_s)
        self.delay_log.append(self.delay_s)
        return self.delay_s


class _Request:
    __slots__ = (
        "market_id", "source_ids", "probabilities", "outcome", "future",
        "ctx", "qos", "t_submit", "t_enqueued", "t_flush",
    )

    def __init__(self, market_id, source_ids, probabilities, outcome, future,
                 ctx, qos=None):
        self.market_id = market_id
        self.source_ids = source_ids
        self.probabilities = probabilities
        self.outcome = outcome
        self.future = future
        self.ctx = ctx
        self.qos = qos  # QoS class NAME; None on an unclassed service
        self.t_submit = 0.0
        self.t_enqueued = 0.0
        self.t_flush = 0.0


class _QosState:
    """One tenant class's live state inside the service: its own SLO
    tracker, optional burn-rate monitor, pending count, and metric
    family (``serve.qos.<name>.*`` — class-labeled series the fleet
    merge folds per class)."""

    __slots__ = (
        "cls", "slo", "health", "pending", "burn_seq",
        "admitted", "rejected", "shed", "goodput_gauge", "pending_gauge",
    )

    def __init__(self, cls: QosClass) -> None:
        self.cls = cls
        self.slo = SloTracker(cls.slo_s)
        # The per-class monitor exists only where the class consumes it
        # (shed_when_burning) or explicitly shapes it (burn_windows):
        # a monitor nobody reads is ring-buffer churn per request.
        self.health = (
            HealthMonitor(
                objective_goodput=cls.objective_goodput,
                windows=cls.burn_windows or DEFAULT_WINDOWS,
                metric_prefix=f"serve.qos.{cls.name}.health",
            )
            if (cls.shed_when_burning or cls.burn_windows is not None)
            else None
        )
        self.pending = 0
        self.burn_seq = 0
        registry = metrics_registry()
        prefix = f"serve.qos.{cls.name}"
        self.admitted = registry.counter(f"{prefix}.admitted")
        self.rejected = registry.counter(f"{prefix}.rejected")
        self.shed = registry.counter(f"{prefix}.shed")
        self.goodput_gauge = registry.gauge(f"{prefix}.goodput_within_slo")
        self.pending_gauge = registry.gauge(f"{prefix}.pending")

    def record_outcome(self, outcome: str, feed_health: bool = True) -> None:
        """Classify one terminal outcome against THIS class's objective
        and (unless burn-driven) feed the class monitor."""
        self.slo.record(outcome)
        if self.health is not None and feed_health:
            self.health.record(outcome)
        goodput = self.slo.goodput_within_slo()
        if goodput is not None:
            self.goodput_gauge.set(goodput)

    def set_pending(self, pending: int) -> None:
        self.pending = pending
        self.pending_gauge.set(float(pending))

    def snapshot(self) -> dict:
        """The class as data — the ``/snapshot`` qos block's per-class
        record, the fleet-merge unit, and a ledger record's extra.
        ``slo_s`` + sorted outcome ``counts`` are the merge vocabulary
        (conflicting vocabularies refuse, like histogram layouts)."""
        snap = self.slo.snapshot()
        return {
            "slo_s": self.cls.slo_s,
            "max_pending": self.cls.max_pending,
            "policy": self.cls.policy,
            "pending": self.pending,
            "counts": snap["counts"],
            "offered": snap["offered"],
            "goodput_within_slo": snap["goodput_within_slo"],
            "burning": (
                self.health.burning if self.health is not None else False
            ),
        }


class _Window:
    """One open micro-batch: requests in submission order, markets unique."""

    __slots__ = ("requests", "markets", "t_created")

    def __init__(self, t_created: float) -> None:
        self.requests: list[_Request] = []
        self.markets: set[str] = set()
        self.t_created = t_created


def _settle_device(store, mesh) -> torch.device:
    """The card (or the CPU) a service's batches settle on: the mesh's
    first device, else the store's, with a CUDA index made explicit."""
    device = torch.device(
        mesh.devices[0][0] if mesh is not None else store.device
    )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _device_scope(device: torch.device):
    """Make *device* current on the calling (worker) thread."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _host_columns(result, analytics_tier):
    """A batch's consensus and analytics columns on the host, in ONE
    device→host copy: the per-market columns are stacked as float64
    (exact for float32 values, NaN kept) and fetched together. Returns
    ``(consensus, bands, propagated, propagated_stderr)`` as numpy arrays
    (``bands`` a dict of ``lo``/``hi``/``stderr``; ``None`` where the
    tier is off)."""
    columns = {"consensus": result}
    if analytics_tier is not None:
        _tiebreak, band_views, prop_view = analytics_tier
        columns.update(lo=band_views.lo, hi=band_views.hi,
                       stderr=band_views.stderr)
        if isinstance(prop_view, PropagatedBeliefs):
            # The moments sweep: a (mean, stderr, iters, residual) bundle
            # rather than a bare mean vector.
            columns.update(propagated=prop_view.mean,
                           propagated_stderr=prop_view.stderr)
        elif prop_view is not None:
            columns["propagated"] = prop_view
    # The result and a session's columns are lazy host views of device
    # vectors; stack the vectors themselves, on the consensus's device.
    vectors = [getattr(column, "vector", column) for column in columns.values()]
    block = torch.stack([
        vector.to(device=vectors[0].device, dtype=torch.float64)
        for vector in vectors
    ]).cpu().numpy()
    host = dict(zip(columns, block))
    bands = (
        {key: host[key] for key in ("lo", "hi", "stderr")}
        if analytics_tier is not None else None
    )
    return (
        host["consensus"], bands, host.get("propagated"),
        host.get("propagated_stderr"),
    )


def _normalise_signals(signals: Sequence[Signal]):
    """Accept reference-payload dicts or (source_id, probability) pairs."""
    source_ids: list[str] = []
    probabilities: list[float] = []
    for signal in signals:
        if isinstance(signal, Mapping):
            source_ids.append(signal["sourceId"])
            probabilities.append(float(signal["probability"]))
        else:
            sid, prob = signal
            source_ids.append(sid)
            probabilities.append(float(prob))
    return source_ids, probabilities


class ConsensusService:
    """Asyncio front end coalescing per-market requests into micro-batches.

    One service instance owns one :class:`~.serve.driver.SessionDriver`
    (and, under ``mesh=``, its long-lived resident session) plus the
    durability cadence ``settle_stream`` would run on the same batches:
    a journal epoch (or rolling SQLite flush) every *checkpoint_every*
    batches and a tail flush on :meth:`close`, which always leaves a
    journal on a JOINED (fsynced) epoch. ``now`` is the first batch's
    settlement day, advancing one day per batch — ``None`` stamps wall
    clock, exactly like the stream.

    ``dtype`` is the settle dtype, ``torch.float32`` (the default, ``None``)
    or ``torch.float64``, as :func:`~.pipeline.settle` takes it; the
    batches settle on the store's device (the mesh's under ``mesh=``), so
    a service over a CUDA store runs on the card and one over a
    ``device="cpu"`` store on the CPU.

    ``record_batches=True`` keeps every flushed batch (columnar columns +
    outcomes) in :attr:`batch_log` — the replay artefact the byte-
    exactness tests (and a crash post-mortem) feed back through
    ``settle_stream``. Off by default: a long-running service must not
    grow an unbounded log.

    ``band_stderr_bound`` caps the variance-aware shed ranking's
    per-market stderr map: past the bound the oldest-settled
    markets are evicted first (ties by market id, live markets never),
    so a long-running analytics service stops growing the map without
    ever changing the shed order among pending requests.

    ``slo`` declares the per-request latency objective (seconds or a
    :class:`~.obs.slo.LatencyObjective`): every request that leaves the
    service is classified met / violated / shed / rejected and
    :meth:`goodput` reports the ``goodput_within_slo`` fraction.
    Tracing rides the process tracer (:func:`~.obs.trace.set_tracer`) —
    see the module docstring for the span chain and the
    :attr:`flight_dump` postmortem contract.
    """

    def __init__(
        self,
        store,
        steps: int = 1,
        now: Optional[float] = None,
        mesh=None,
        dtype=None,
        journal=None,
        db_path=None,
        checkpoint_every: int = 1,
        sync_checkpoints: bool = False,
        num_slots: "int | str | None" = "bucket",
        max_batch: int = 256,
        max_delay_s: Optional[float] = 0.005,
        admission: Optional[AdmissionConfig] = None,
        qos: Optional[Sequence[QosClass]] = None,
        slo=None,
        health=None,
        record_batches: bool = False,
        analytics=None,
        target_p99_s: Optional[float] = None,
        intern_mode: str = "auto",
        band_stderr_bound: int = 4096,
    ) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if band_stderr_bound < 1:
            raise ValueError("band_stderr_bound must be >= 1")
        if max_delay_s is not None and max_delay_s < 0:
            raise ValueError("max_delay_s must be >= 0 (or None)")
        if target_p99_s is not None and (
            max_delay_s is None or max_delay_s <= 0
        ):
            raise ValueError(
                "target_p99_s= adapts the coalescing window, so it needs "
                "a positive initial max_delay_s"
            )
        owns_journal = False
        if journal is not None and not hasattr(journal, "append_epoch"):
            from bayesian_consensus_engine_tpu_torch.state.journal import (
                JournalWriter,
            )

            journal = JournalWriter(journal)
            owns_journal = True
        self._store = store
        self._now = now
        self._max_batch = max_batch
        self._max_delay_s = max_delay_s
        self._record_batches = record_batches
        self._plans = PlanCache(
            store, num_slots=num_slots, intern_mode=intern_mode
        )
        self._driver = SessionDriver(
            store,
            steps=steps,
            mesh=mesh,
            dtype=dtype,
            journal=journal,
            owns_journal=owns_journal,
            db_path=db_path,
            checkpoint_every=checkpoint_every,
            sync_checkpoints=sync_checkpoints,
            analytics=analytics,
        )
        self._analytics_mode = self._driver._analytics is not None
        #: Where the dispatch worker settles: fixed here, so a launch
        #: never depends on the worker thread's current device.
        self._device = _settle_device(store, mesh)
        #: The adaptive coalescing window:
        #: None runs the fixed max_delay_s; with ``target_p99_s=`` every
        #: completed batch nudges the delay toward the SLO (see
        #: :class:`AdaptiveWindow` — delay_log is the window sequence).
        self.window = (
            AdaptiveWindow(target_p99_s, max_delay_s)
            if target_p99_s is not None else None
        )
        self._journal_mode = journal is not None
        self._admission = AdmissionController(
            admission if admission is not None else AdmissionConfig()
        )
        #: Tenant classes: class name → live per-class
        #: state, in DECLARATION order (the first class is the default
        #: for unclassed submits). None = the single-tenant service,
        #: whose admission sequence and bytes are unchanged.
        self._qos_states: "Optional[dict[str, _QosState]]" = None
        if qos:
            states: "dict[str, _QosState]" = {}
            for cls in qos:
                if not isinstance(cls, QosClass):
                    raise TypeError(
                        f"qos= takes QosClass instances; got {cls!r}"
                    )
                if cls.name in states:
                    raise ValueError(f"duplicate QoS class {cls.name!r}")
                states[cls.name] = _QosState(cls)
            self._qos_states = states
            self._default_class = next(iter(states))
        else:
            self._default_class = None
        #: Per-market band standard error, maintained from every
        #: analytics-mode dispatch (and seedable via
        #: :meth:`seed_band_stderr`) — the variance-aware shed policy's
        #: ranking input. Markets absent here rank NARROW (shed last,
        #: in arrival order), so the policy degrades to shed-oldest
        #: when no analytics ran. BOUNDED: the map holds at
        #: most ``band_stderr_bound`` markets; past the bound the
        #: oldest-settled markets are evicted first (ties by market id),
        #: and markets with a pending request are never evicted — so
        #: eviction can never reorder the shed ranking among LIVE
        #: markets.
        self._band_stderr: "dict[str, float]" = {}
        #: Settled-age stamps for the eviction order: market id → the
        #: value of ``_stderr_seq`` when its stderr last refreshed. One
        #: seq tick per settled batch (or seed call), so every market in
        #: a batch shares an age and ties break by market id.
        self._stderr_settled_at: "dict[str, int]" = {}
        self._stderr_seq = 0
        self._band_stderr_bound = band_stderr_bound

        #: SLO accounting (obs/slo.py): classify every request that left
        #: the service; None when no objective was declared.
        self._slo = SloTracker(slo) if slo is not None else None
        #: Burn-rate health (obs/health.py): every outcome the
        #: SLO tracker classifies also feeds the monitor, whose
        #: ``burning`` verdict is (a) the ``/healthz`` answer when this
        #: service runs a telemetry exporter and (b) the admission
        #: signal ``AdmissionConfig(shed_when_burning=True)`` consumes.
        if health is not None and slo is None:
            raise ValueError(
                "health= evaluates burn rates over SLO-classified "
                "outcomes — declare slo= alongside it"
            )
        self._health = health
        #: The live telemetry exporter (obs/export.py), when this
        #: service started one via :meth:`start_telemetry`.
        self.telemetry = None
        #: Submit sequence — the deterministic trace id. Every arrival
        #: burns one (admitted, shed, or rejected), so ids are a pure
        #: function of the request trace, never of timing or identity.
        self._submit_seq = 0
        #: The latest flight-recorder snapshot (obs/trace.py): taken at
        #: the moment of an unhandled dispatch/journal failure, or on a
        #: clean close. None when no tracer was active.
        self.flight_dump = None

        self._windows: list[_Window] = []
        self._resident = 0  # submitted and not yet settled (the bound)
        self._next_batch = 0
        self._timer: Optional[asyncio.TimerHandle] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._inflight: set = set()
        self._closed = False
        self._failure: Optional[BaseException] = None
        #: requests settled but not yet covered by a joined journal epoch,
        #: as (batch_index, [(request, t_settled)]). Worker-thread-only.
        self._await_durable: list = []
        self.batch_log: list = []

        registry = metrics_registry()
        self._requests_counter = registry.counter("serve.requests")
        self._batches_counter = registry.counter("serve.batches")
        self._pending_gauge = registry.gauge("serve.pending_requests")
        self._hist_enqueue = registry.histogram("serve.latency_enqueue_s")
        self._hist_coalesce = registry.histogram("serve.latency_coalesce_s")
        self._hist_dispatch = registry.histogram("serve.latency_dispatch_s")
        self._hist_durable = registry.histogram("serve.latency_durable_s")
        self._hist_total = registry.histogram("serve.latency_total_s")
        self._slo_met_counter = registry.counter("serve.slo_met")
        self._slo_violated_counter = registry.counter("serve.slo_violated")
        self._goodput_gauge = registry.gauge("serve.goodput_within_slo")

        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="bce-serve-dispatch"
        )
        #: The pack thread: runs PlanCache.stage (store-free grouping /
        #: refresh) one batch ahead of the dispatch worker. ONE thread,
        #: fed in flush order, so the plan-reuse chain stays sequential.
        self._pack_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="bce-serve-pack"
        )
        #: Bound-event chain: batch N's event fires once its plan can no
        #: longer mutate the store (stage-complete on a hit, bind-complete
        #: on a miss) — the gate stage(N+1) waits behind.
        self._last_bound: Optional[threading.Event] = None
        #: Cumulative dispatch-worker seconds spent waiting on (and
        #: finishing) plan builds — the served path's ingest wait.
        self._ingest_wait_s = 0.0
        self._ingest_wait_gauge = registry.gauge("serve.ingest_wait_s")
        #: Dispatch-worker seconds inside the pair-interning pass — the
        #: component of the ingest wait the epoch-persistent pair table
        #: shrinks (zero on fingerprint hits; the pair-delta's walk on a
        #: drifted miss). Same gauge name as the stream side so ledgers
        #: read one number.
        self._intern_wait_s = 0.0
        self._intern_wait_gauge = registry.gauge("stream.intern_wait_s")

    # -- submission (event-loop thread) --------------------------------------

    @property
    def settled_batches(self) -> int:
        """Batches fully settled — the resume point after a crash
        (``batch_log[settled_batches:]`` holds the unsettled tail)."""
        return self._driver.settled_through + 1

    @property
    def pending_requests(self) -> int:
        return self._resident

    @property
    def ingest_wait_s(self) -> float:
        """Cumulative dispatch-worker seconds blocked on plan builds —
        the served path's ingest wait (also the ``serve.ingest_wait_s``
        gauge). ≈ 0 in the steady state: staging overlaps the previous
        batch's device window on the pack thread."""
        return self._ingest_wait_s

    @property
    def intern_wait_s(self) -> float:
        """Cumulative dispatch-worker seconds inside the pair-interning
        pass (the ``stream.intern_wait_s`` gauge) — the slice of
        :attr:`ingest_wait_s` that CANNOT overlap onto the pack thread,
        because interning order decides row assignment and journal
        epoch membership. The epoch-persistent pair table is what keeps
        it near zero under drift."""
        return self._intern_wait_s

    def submit(self, market_id: str, signals: Sequence[Signal],
               outcome: bool,
               qos_class: Optional[str] = None,
               ) -> "asyncio.Future[ServeResult]":
        """Enqueue one market's signal update + outcome report.

        Returns an :class:`asyncio.Future` resolving to
        :class:`ServeResult` once the request's micro-batch has settled
        (and, in journal mode, been through its checkpoint cadence).
        Raises :class:`~.serve.admission.Overloaded` at the admission
        bound under the reject policy and :class:`ServiceClosed` after
        :meth:`close` began. Must be called on the event-loop thread —
        the coalescer is loop-owned state.

        ``qos_class`` names the request's tenant class on a service
        constructed with ``qos=`` (``None`` lands in the FIRST declared
        class — the declaration order is policy); the class's own
        budget/policy/burn verdict decides first, then the service-wide
        bound backstops the aggregate. On an unclassed service passing
        a class name is an error, never a silent ignore.
        """
        t_submit = _time.perf_counter()
        if self._closed:
            raise ServiceClosed("submit after close() began draining")
        if self._failure is not None:
            raise ServiceClosed(
                f"service failed: {self._failure!r}"
            ) from self._failure
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        qos_state = self._resolve_class(qos_class)
        self._requests_counter.inc()
        # Validate BEFORE any admission decision: a malformed request
        # must refuse on its own defect, never first evict a healthy
        # pending request under shed_oldest and then fail — via the
        # net/ front door that ordering would let one bad frame kill
        # one legitimate in-flight request per send.
        source_ids, probabilities = _normalise_signals(signals)
        ctx = TraceContext(self._submit_seq, market_id)
        self._submit_seq += 1
        tracer = active_tracer()
        # -- per-class admission: the tenant's own budget/policy/burn
        # verdict decides first (class-scoped: a burning best-effort
        # class sheds ITS pending, never the premium class's).
        class_shed_replaced = False
        if qos_state is not None:
            decision, cls_burn_driven = self._class_decision(qos_state)
            if decision == "reject":
                self._refuse_rejected(
                    ctx, qos_state, feed_health=not cls_burn_driven,
                    retry_after_s=qos_state.cls.retry_after_s,
                    pending=qos_state.pending,
                )
            if decision == "shed_oldest":
                if self._shed_victim(
                    class_name=qos_state.cls.name,
                    feed_health=not cls_burn_driven,
                ):
                    # The arrival REPLACES its victim: aggregate pending
                    # is unchanged, so the service-wide bound cannot
                    # newly overflow — count_shed records the pair
                    # (victim shed, arrival admitted) and the global
                    # controller is NOT consulted again (consulting it
                    # would count the same arrival admitted twice).
                    self._admission.count_shed()
                    class_shed_replaced = True
                else:
                    self._refuse_rejected(
                        ctx, qos_state, feed_health=not cls_burn_driven,
                        retry_after_s=qos_state.cls.retry_after_s,
                        pending=qos_state.pending,
                    )
        if not class_shed_replaced:
            burning = (
                self._health.burning if self._health is not None else False
            )
            config = self._admission.config
            # A burn-driven refusal (below the pending bound, refused
            # only because the budget is burning) counts against goodput
            # like any refusal but is NOT fed back into the health
            # monitor: feeding it would hold the error windows full of
            # our own refusals and the verdict could never clear — the
            # monitor sees organic outcomes only.
            burn_driven = bool(
                burning and config.shed_when_burning
                and self._resident < config.max_pending
            )
            try:
                decision = self._admission.decide(
                    self._resident, burning=burning
                )
            except Overloaded:
                if qos_state is not None:
                    qos_state.rejected.inc()
                self._count_refused(
                    ctx, "rejected", qos_state=qos_state,
                    feed_health=not burn_driven,
                )
                raise
            if decision == "shed_oldest":
                if self._shed_victim(feed_health=not burn_driven):
                    self._admission.count_shed()
                else:
                    # Everything resident is already dispatch-bound —
                    # nothing left to shed; degrade to rejection so the
                    # bound holds.
                    self._refuse_rejected(
                        ctx, qos_state, feed_health=not burn_driven,
                        retry_after_s=self._admission.config.retry_after_s,
                        pending=self._resident,
                    )
        request = _Request(
            market_id, source_ids, probabilities, bool(outcome),
            self._loop.create_future(), ctx,
            qos=qos_state.cls.name if qos_state is not None else None,
        )
        request.t_submit = t_submit
        window = self._place(request)
        self._resident += 1
        self._pending_gauge.set(float(self._resident))
        if qos_state is not None:
            qos_state.admitted.inc()
            qos_state.set_pending(qos_state.pending + 1)
        request.t_enqueued = _time.perf_counter()
        # The enqueue span is OBSERVED at flush time (with coalesce), so
        # a later-shed request never lands in the latency histograms as a
        # phantom completion; its trace event still records here.
        if tracer.enabled:
            tracer.request_event(
                ctx, "enqueue", dur_s=request.t_enqueued - t_submit,
                args={"market": market_id},
            )
            tracer.request_event(
                ctx, "window_join",
                args={"window_position": len(window.requests) - 1},
            )
        # Size trigger: only the window this request joined can have
        # newly filled (an O(1) check — scanning every open window would
        # be O(windows) per submit on the hot-key path). When it fills,
        # flush oldest-first up to and including it — usually it IS the
        # oldest; under heavy duplicate traffic its underfull
        # predecessors go out ahead of it so batches never overtake each
        # other (flush order IS submission order).
        if len(window.requests) >= self._max_batch:
            while True:
                oldest = self._windows[0]
                self._flush_oldest()
                if oldest is window:
                    break
        self._arm_timer()
        return request.future

    def _place(self, request: _Request) -> "_Window":
        for window in self._windows:
            if (
                request.market_id not in window.markets
                and len(window.requests) < self._max_batch
            ):
                window.requests.append(request)
                window.markets.add(request.market_id)
                return window
        window = _Window(_time.perf_counter())
        window.requests.append(request)
        window.markets.add(request.market_id)
        self._windows.append(window)
        return window

    def _resolve_class(self, qos_class: Optional[str]):
        """Class name → live state; validates against the declared set."""
        if self._qos_states is None:
            if qos_class is not None:
                raise ValueError(
                    f"request names QoS class {qos_class!r} but the "
                    "service declared no qos= classes"
                )
            return None
        name = qos_class if qos_class is not None else self._default_class
        state = self._qos_states.get(name)
        if state is None:
            raise ValueError(
                f"unknown QoS class {name!r}; declared: "
                f"{sorted(self._qos_states)}"
            )
        return state

    def _class_decision(self, state: _QosState):
        """The per-class admission verdict: ``("accept" | "reject" |
        "shed_oldest", burn_driven)``. Mirrors
        :meth:`~.serve.admission.AdmissionController.decide` over the
        class's own pending count and burn verdict — kept inline so the
        class tier counts only its ``serve.qos.<name>.*`` series (the
        service-wide controller owns the aggregate counters)."""
        cls = state.cls
        over = state.pending >= cls.max_pending
        burn_driven = False
        if (
            not over and cls.shed_when_burning
            and state.health is not None and state.health.burning
        ):
            # Same probe discipline as the global controller: every Nth
            # burn arrival is admitted so organic outcomes keep flowing
            # and a recovered class can clear its own verdict.
            state.burn_seq += 1
            burn_driven = over = (
                state.burn_seq % cls.burn_probe_every != 0
            )
        if not over:
            return "accept", False
        if cls.policy == "reject":
            return "reject", burn_driven
        return "shed_oldest", burn_driven

    def _shed_victim(
        self, class_name: Optional[str] = None, feed_health: bool = True
    ) -> bool:
        """Drop the variance-aware shed victim among the not-yet-flushed
        requests (optionally within one QoS class); False when none.

        The victim is the MINIMUM of :func:`~.serve.admission.
        shed_rank_key` over the candidates: widest known ``band_stderr``
        first (the analytics tier's per-market standard error, live in
        :attr:`market_band_stderr`), unknown-band markets after every
        known one, ties oldest-first by submit sequence — a pure
        function of (class, stderr ranking, arrival order), so a fixed
        trace sheds a fixed sequence.
        With no stderr known this IS plain shed-oldest — served by
        an O(1) first-match pop rather than the ranking scan, so a
        non-analytics service under sustained overload keeps the cheap
        per-arrival shed it always had (the scan is O(pending) and only
        analytics-fed services pay it).
        """
        victim = victim_window = victim_key = None
        if not self._band_stderr:
            # Every candidate ranks unknown: take the first pending
            # request in window placement order — windows are created
            # (and flushed) oldest-first, so this is exactly the
            # shed-oldest victim, at O(1) cost.
            for window in self._windows:
                for request in window.requests:
                    if class_name is None or request.qos == class_name:
                        victim, victim_window = request, window
                        break
                if victim is not None:
                    break
        else:
            for window in self._windows:
                for request in window.requests:
                    if class_name is not None and request.qos != class_name:
                        continue
                    key = shed_rank_key(
                        self._band_stderr.get(request.market_id),
                        request.ctx.seq,
                    )
                    if victim_key is None or key < victim_key:
                        victim, victim_window, victim_key = (
                            request, window, key,
                        )
        if victim is None:
            return False
        victim_window.requests.remove(victim)
        victim_window.markets.discard(victim.market_id)
        if not victim_window.requests:
            self._windows.remove(victim_window)
        self._resident -= 1
        self._pending_gauge.set(float(self._resident))
        victim_state = (
            self._qos_states.get(victim.qos)
            if self._qos_states is not None and victim.qos is not None
            else None
        )
        if victim_state is not None:
            victim_state.shed.inc()
            victim_state.set_pending(victim_state.pending - 1)
        if not victim.future.done():
            victim.future.set_exception(
                ShedError(
                    f"request for {victim.market_id!r} shed under "
                    "overload (variance-aware shed policy)"
                )
            )
        self._count_refused(
            victim.ctx, "shed", qos_state=victim_state,
            feed_health=feed_health,
        )
        return True

    def _refuse_rejected(
        self, ctx: TraceContext, qos_state, *, feed_health: bool,
        retry_after_s: float, pending: int,
    ) -> None:
        """Degraded-reject bookkeeping shared by every refusal that the
        admission CONTROLLER did not itself count: class-budget rejects,
        failed class sheds, and the nothing-left-to-shed degrade. Counts
        the refusal (class + service-wide + SLO/trace) and raises
        :class:`~.serve.admission.Overloaded`."""
        if qos_state is not None:
            qos_state.rejected.inc()
        self._admission.count_degraded_reject()
        self._count_refused(
            ctx, "rejected", qos_state=qos_state, feed_health=feed_health,
        )
        raise Overloaded(retry_after_s, pending)

    def _count_refused(
        self, ctx: TraceContext, outcome: str, qos_state=None,
        feed_health: bool = True,
    ) -> None:
        """A request that will never settle: SLO-classify and trace it.

        Refused requests count AGAINST goodput (the whole point of the
        goodput-within-objective framing) but never enter the latency
        histograms — there is no completion latency to record.
        ``feed_health=False`` marks a BURN-DRIVEN refusal: it still
        counts against goodput, but the health monitors (service-wide
        AND per-class) must not see their own shedding as fresh budget
        burn (the feedback loop that would pin the verdict at burning
        forever). ``qos_state`` classifies the refusal against the
        request's class too.
        """
        if self._slo is not None:
            self._slo.record(outcome)
            self._update_goodput_gauge()
            if self._health is not None and feed_health:
                self._health.record(outcome)
        if qos_state is not None:
            qos_state.record_outcome(outcome, feed_health=feed_health)
        tracer = active_tracer()
        if tracer.enabled:
            args = {"market": ctx.market_id, "pending": self._resident}
            if qos_state is not None:
                args["class"] = qos_state.cls.name
            tracer.request_event(ctx, outcome, args=args)

    def _update_goodput_gauge(self) -> None:
        goodput = self._slo.goodput_within_slo()
        if goodput is not None:
            self._goodput_gauge.set(goodput)

    def _count_failed(self, requests) -> None:
        """Requests lost to a dispatch/journal failure (worker thread):
        they count against goodput like refused traffic — a goodput
        number that forgot crash-eaten requests would overstate health
        exactly when it matters. Classified per request so each QoS
        class's goodput carries its own share of the damage."""
        for request in requests:
            if self._slo is not None:
                self._slo.record("failed")
                if self._health is not None:
                    self._health.record("failed")
            state = self._class_state_of(request)
            if state is not None:
                state.record_outcome("failed")
        if self._slo is not None:
            self._update_goodput_gauge()

    def _class_state_of(self, request: _Request):
        if self._qos_states is None or request.qos is None:
            return None
        return self._qos_states.get(request.qos)

    # -- flushing (event-loop thread) ----------------------------------------

    def _apply_window_delay(self, delay_s: float) -> None:
        """Adopt the adaptive controller's new max delay (loop thread —
        the timer owner). Already-armed timers keep their old deadline;
        the next arm uses the new window."""
        self._max_delay_s = delay_s

    def _arm_timer(self) -> None:
        if (
            self._max_delay_s is None
            or self._timer is not None
            or not self._windows
            or self._loop is None
        ):
            return
        deadline = self._windows[0].t_created + self._max_delay_s
        delay = max(0.0, deadline - _time.perf_counter())
        self._timer = self._loop.call_later(delay, self._on_timer)

    def _on_timer(self) -> None:
        self._timer = None
        if self._closed:
            return
        now = _time.perf_counter()
        while self._windows and (
            now - self._windows[0].t_created >= self._max_delay_s
        ):
            self._flush_oldest()
        self._arm_timer()

    def _flush_oldest(self) -> None:
        window = self._windows.pop(0)
        requests = window.requests
        if not requests:
            return
        t_flush = _time.perf_counter()
        batch_index = self._next_batch
        self._next_batch += 1
        tracer = active_tracer()
        keys = [r.market_id for r in requests]
        source_ids: list[str] = []
        probabilities: list[float] = []
        offsets = np.zeros(len(requests) + 1, dtype=np.int64)
        for i, request in enumerate(requests):
            source_ids.extend(request.source_ids)
            probabilities.extend(request.probabilities)
            offsets[i + 1] = len(source_ids)
            request.t_flush = t_flush
            # Flush commits the request to a batch: only now do its
            # enqueue/coalesce spans enter the histograms (a shed victim
            # never reaches this point, so never counts).
            self._hist_enqueue.observe(request.t_enqueued - request.t_submit)
            self._hist_coalesce.observe(t_flush - request.t_enqueued)
            if tracer.enabled:
                tracer.request_event(
                    request.ctx, "flush",
                    dur_s=t_flush - request.t_enqueued,
                    args={"batch": batch_index},
                )
        probabilities = np.asarray(probabilities, dtype=np.float64)
        outcomes = [r.outcome for r in requests]
        self._batches_counter.inc()
        if self._record_batches:
            self.batch_log.append(
                ((keys, source_ids, probabilities, offsets), outcomes)
            )
        # The micro-batch columnar is built — hand its store-free plan
        # stage to the pack thread NOW, so it overlaps the previous
        # batch's device window. The bound-event chain (created here, on
        # the loop thread, in flush order) sequences the stages.
        prev_bound = self._last_bound
        bound = threading.Event()
        self._last_bound = bound
        pack_future = self._pack_executor.submit(
            self._stage_batch, prev_bound, bound,
            keys, source_ids, probabilities, offsets,
        )
        future = self._loop.run_in_executor(
            self._executor, self._run_batch,
            batch_index, pack_future, bound, keys, outcomes, requests,
        )
        self._inflight.add(future)
        future.add_done_callback(self._inflight.discard)

    # -- plan staging (pack thread) ------------------------------------------

    def _stage_batch(self, prev_bound, bound, keys, source_ids,
                     probabilities, offsets):
        """Store-free plan stage for one batch, sequenced behind its
        predecessor's bound point (see the module docstring)."""
        from bayesian_consensus_engine_tpu_torch.pipeline import StagedColumnarPlan

        if prev_bound is not None:
            prev_bound.wait()
        try:
            staged = self._plans.stage(
                keys, source_ids, probabilities, offsets
            )
        except BaseException:
            # Successors must never deadlock behind a failed stage; the
            # error itself surfaces on the dispatch worker's future wait.
            bound.set()
            raise
        if not isinstance(staged, StagedColumnarPlan):
            # Fingerprint hit: the refresh twin is a complete plan and
            # the store was never touched — the next stage may proceed.
            bound.set()
        return staged

    # -- dispatch (worker thread) --------------------------------------------

    def _run_batch(self, batch_index, pack_future, bound, keys, outcomes,
                   requests) -> None:
        loop = self._loop
        tracer = active_tracer()
        if self._failure is not None:
            # The abandoned batch still fires its bound event, or the
            # pack thread would deadlock behind it forever.
            bound.set()
            failure = ServiceClosed(
                f"batch {batch_index} abandoned after an earlier failure"
            )
            if tracer.enabled:
                for request in requests:
                    tracer.request_event(
                        request.ctx, "failed",
                        args={"batch": batch_index, "abandoned": True},
                    )
            self._count_failed(requests)
            for request in requests:
                loop.call_soon_threadsafe(
                    self._resolve, request, None, failure
                )
            return
        try:
            # The batch scope: every canonical phase span taken inside
            # (the plan-stage wait here, upload/settle_dispatch in
            # dispatch, checkpoint/journal in the durability step) lands
            # on batch `batch_index`'s trace chain — the TraceContext
            # propagation across the asyncio → worker boundary, without
            # new instrumentation at the span sites.
            with _device_scope(self._device), tracer.batch(
                batch_index, args={"markets": len(keys)}
            ):
                # The pack phase is now mostly a WAIT on the pack
                # thread's staged result (plus, on a fingerprint miss,
                # the interning+assembly that must stay on THIS thread
                # in batch order — see the module docstring).
                t_pack = _time.perf_counter()
                with active_timeline().span("pack"):
                    try:
                        plan = self._plans.bind(pack_future.result())
                    finally:
                        bound.set()
                self._ingest_wait_s += _time.perf_counter() - t_pack
                self._ingest_wait_gauge.set(self._ingest_wait_s)
                intern_stats = getattr(plan, "intern_stats", None)
                if intern_stats is not None:
                    self._intern_wait_s += intern_stats["intern_s"]
                    self._intern_wait_gauge.set(self._intern_wait_s)
                batch_now = (
                    None if self._now is None else self._now + batch_index
                )
                result = self._driver.dispatch(
                    plan, outcomes, now=batch_now, band=None
                )
                # One device→host copy of the batch's columns, here on
                # the worker and before the checkpoint: every per-request
                # float below reads host arrays, and the event-loop
                # thread only ever moves Python floats.
                consensus, bands, propagated, prop_stderr = _host_columns(
                    result,
                    self._driver.last_analytics
                    if self._analytics_mode else None,
                )
                if bands is not None:
                    # Refresh the variance-aware shed ranking with this
                    # batch's live per-market standard errors (plain
                    # dict assignment — GIL-atomic; the loop thread
                    # reads it at shed time). When the moments sweep
                    # ran, a finite propagated stderr supersedes the
                    # band stderr: neighbour evidence tightens a
                    # market's uncertainty, and the shed policy should
                    # rank on what the sweep knows, not what the band
                    # alone shows. One age tick for the whole batch,
                    # then evict past the bound.
                    stderr_col = bands["stderr"]
                    self._stderr_seq += 1
                    for i, request in enumerate(requests):
                        live_stderr = float(stderr_col[i])
                        if prop_stderr is not None and np.isfinite(
                            prop_stderr[i]
                        ):
                            live_stderr = float(prop_stderr[i])
                        self._band_stderr[request.market_id] = live_stderr
                        self._stderr_settled_at[request.market_id] = (
                            self._stderr_seq
                        )
                    self._evict_band_stderr()
                t_settled = _time.perf_counter()
                self._driver.checkpoint(batch_index)
                if self._journal_mode:
                    # Appended AFTER the checkpoint: a batch whose own
                    # checkpoint raised is classified failed on the
                    # except path, never double-counted as a straggler.
                    self._await_durable.append(
                        (batch_index, [(r, t_settled) for r in requests])
                    )
        except BaseException as exc:  # noqa: BLE001 — routed to futures
            self._failure = exc
            if tracer.enabled:
                for request in requests:
                    tracer.request_event(
                        request.ctx, "failed", args={"batch": batch_index}
                    )
                # The postmortem is snapshotted AT the failure, while the
                # flight rings still hold the failing batch's chains.
                self.flight_dump = tracer.flight_dump(
                    reason=f"dispatch failure at batch {batch_index}: "
                           f"{exc!r}"
                )
            self._count_failed(requests)
            for request in requests:
                loop.call_soon_threadsafe(self._resolve, request, None, exc)
            return
        if self.window is not None:
            # The adaptive window: feed this batch's submit→settled
            # latencies and apply one deterministic nudge. The new delay
            # lands on the loop thread (the timer owner); the nudge
            # sequence itself is a pure function of the observed
            # latencies (AdaptiveWindow.delay_log records it).
            for request in requests:
                self.window.observe(t_settled - request.t_submit)
            loop.call_soon_threadsafe(
                self._apply_window_delay, self.window.step()
            )
        # Resolution happens AFTER the checkpoint — the service analogue
        # of settle_stream yielding after the cadence — so a caller never
        # observes a result whose durability window has silently failed.
        for i, request in enumerate(requests):
            self._hist_dispatch.observe(t_settled - request.t_flush)
            if tracer.enabled:
                tracer.request_event(
                    request.ctx, "settled",
                    dur_s=t_settled - request.t_flush,
                    args={"batch": batch_index},
                )
            value = ServeResult(
                request.market_id, float(consensus[i]), batch_index,
                band_lo=(
                    float(bands["lo"][i]) if bands is not None else None
                ),
                band_hi=(
                    float(bands["hi"][i]) if bands is not None else None
                ),
                band_stderr=(
                    float(bands["stderr"][i]) if bands is not None
                    else None
                ),
                propagated=(
                    float(propagated[i]) if propagated is not None
                    else None
                ),
                propagated_stderr=(
                    float(prop_stderr[i]) if prop_stderr is not None
                    else None
                ),
            )
            if not self._journal_mode:
                self._hist_total.observe(t_settled - request.t_submit)
                self._classify_completion(
                    request, t_settled - request.t_submit
                )
            loop.call_soon_threadsafe(self._resolve, request, value, None)
        self._observe_durable()

    def _observe_durable(self) -> None:
        """Fold the driver's durable watermark into per-request spans."""
        durable_through = self._driver.durable_through
        t_durable = _time.perf_counter()
        tracer = active_tracer()
        while self._await_durable and (
            self._await_durable[0][0] <= durable_through
        ):
            batch_index, entries = self._await_durable.pop(0)
            for request, t_settled in entries:
                self._hist_durable.observe(t_durable - t_settled)
                self._hist_total.observe(t_durable - request.t_submit)
                if tracer.enabled:
                    tracer.request_event(
                        request.ctx, "durable",
                        dur_s=t_durable - t_settled,
                        args={"batch": batch_index},
                    )
                self._classify_completion(
                    request, t_durable - request.t_submit
                )

    def _classify_completion(self, request: _Request,
                             latency_s: float) -> None:
        """SLO-classify one COMPLETED request (its strongest signal:
        durable in journal mode, settled otherwise) — against the
        service-wide objective AND the request's own class objective
        (each QoS class meets or violates its OWN ``slo_s``, which is
        what makes per-class goodput a tiering verdict rather than a
        relabeling of the global one)."""
        if self._slo is not None:
            outcome = self._slo.record_latency(latency_s)
            (
                self._slo_met_counter if outcome == "met"
                else self._slo_violated_counter
            ).inc()
            if self._health is not None:
                self._health.record(outcome)
            self._update_goodput_gauge()
        state = self._class_state_of(request)
        if state is not None:
            state.record_outcome(state.slo.classify(latency_s))

    @property
    def health(self):
        """The burn-rate monitor (``None`` when not declared) — readable
        so the shed policy, the telemetry exporter, and operators share
        one verdict."""
        return self._health

    def start_telemetry(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        host_id: int = 0,
        epoch: int = 0,
    ):
        """Expose this service's live telemetry plane.

        Starts an :class:`~.obs.export.TelemetryServer` over the process
        metrics registry, this service's burn-rate monitor (so
        ``/healthz`` answers with the burn verdict), and the active
        tracer's flight-ring depths; returns the server (also kept as
        :attr:`telemetry` and shut down by :meth:`close`). ``port=0``
        binds an ephemeral port — read ``server.port`` back. The server
        only READS obs state: serving scrapes changes no settlement byte
        (the write-only contract).
        """
        # Lazy import: the exporter is the read side of obs — only a
        # service that actually serves telemetry pays for http.server.
        from bayesian_consensus_engine_tpu_torch.obs.export import TelemetryServer

        if self.telemetry is not None:
            return self.telemetry
        self.telemetry = TelemetryServer(
            health=self._health,
            tracer=active_tracer(),
            host=host,
            port=port,
            host_id=host_id,
            epoch=epoch,
            # The per-class QoS block: scraped live into
            # /snapshot so `stats --live` and the fleet merge
            # see class-labeled goodput, not just the global fraction.
            qos=self.qos_snapshot,
        ).start()
        return self.telemetry

    def goodput(self) -> Optional[dict]:
        """The SLO tracker's snapshot (``None`` without an objective):
        per-outcome counts, the cumulative ``goodput_within_slo``
        fraction, and the sliding-window fraction — the record the
        overload readings land in a run ledger."""
        return self._slo.snapshot() if self._slo is not None else None

    # -- tenant classes (QoS) -----------------------------------------------

    @property
    def qos_classes(self) -> Optional[tuple]:
        """The declared :class:`~.serve.admission.QosClass` set, in
        declaration order (``None`` on a single-tenant service)."""
        if self._qos_states is None:
            return None
        return tuple(state.cls for state in self._qos_states.values())

    @property
    def market_band_stderr(self) -> dict:
        """The live per-market band standard errors the variance-aware
        shed policy ranks by (read-only view semantics: mutate through
        :meth:`seed_band_stderr` or by serving analytics batches).

        Growth contract: at most ``band_stderr_bound``
        markets — past the bound the oldest-settled markets (by the
        per-batch age stamp, ties by market id) are evicted first, and
        markets with a pending request are never evicted, so eviction
        cannot change the shed order among live markets. An evicted
        market simply re-ranks as unknown-band (shed last, arrival
        order) until its next analytics settle refreshes it.
        Shed-time ranking over the map is O(pending) per victim search,
        bounded by the class's ``max_pending`` budget, not by market
        cardinality."""
        return dict(self._band_stderr)

    def seed_band_stderr(self, stderr_by_market: Mapping[str, float]) -> None:
        """Pre-rank markets for the variance-aware shed policy.

        Analytics-mode dispatches maintain the ranking live; this seeds
        (or overrides) it explicitly — a recovered service can import
        the ranking from its analytics tier before the first batch
        settles, and the fixed-trace shed-determinism tests pin the
        policy against a known map. Seeded entries share one age stamp
        (ties break by market id) and count against
        ``band_stderr_bound`` like settled ones.
        """
        self._stderr_seq += 1
        for market, stderr in stderr_by_market.items():
            self._band_stderr[str(market)] = float(stderr)
            self._stderr_settled_at[str(market)] = self._stderr_seq
        self._evict_band_stderr()

    def _evict_band_stderr(self) -> None:
        """Trim the shed-ranking stderr map back under its bound.

        Victims are the OLDEST-settled markets first (smallest age
        stamp, ties by market id — a pure function of the settle/seed
        trace, never of timing), and a market with a pending request is
        never evicted: the shed ranking the loop thread reads for LIVE
        markets is exactly what it would be unbounded. Runs on the
        dispatch worker thread; the live-market snapshot copies each
        window's market set with one C-level ``list()`` per set, so the
        loop thread's concurrent window edits can't break iteration.
        """
        excess = len(self._band_stderr) - self._band_stderr_bound
        if excess <= 0:
            return
        live: set = set()
        for window in list(self._windows):
            live.update(list(window.markets))
        evictable = sorted(
            (
                (self._stderr_settled_at.get(market, 0), market)
                for market in self._band_stderr
                if market not in live
            ),
        )[:excess]
        for _age, market in evictable:
            del self._band_stderr[market]
            self._stderr_settled_at.pop(market, None)

    def qos_snapshot(self) -> Optional[dict]:
        """Per-class QoS accounting as data (``None`` when no classes).

        Class name → ``{slo_s, max_pending, policy, pending, counts,
        offered, goodput_within_slo, burning}`` in declaration order —
        the ``/snapshot`` qos block (:meth:`start_telemetry` wires it),
        the :func:`~.obs.fleet.merge_fleet` per-class merge unit, and
        a ledger record's per-class extra.
        """
        if self._qos_states is None:
            return None
        return {
            name: state.snapshot()
            for name, state in self._qos_states.items()
        }

    def _resolve(self, request: _Request, value, exc) -> None:
        self._resident -= 1
        self._pending_gauge.set(float(self._resident))
        state = self._class_state_of(request)
        if state is not None:
            state.set_pending(state.pending - 1)
        if request.future.done():
            return
        if exc is not None:
            request.future.set_exception(exc)
        else:
            request.future.set_result(value)

    # -- drain / shutdown (event-loop thread) --------------------------------

    async def flush(self) -> None:
        """Flush every open window now (oldest first), without waiting."""
        while self._windows:
            self._flush_oldest()

    async def drain(self) -> None:
        """Flush everything and wait until every in-flight batch settled."""
        await self.flush()
        while self._inflight:
            await asyncio.gather(
                *list(self._inflight), return_exceptions=True
            )

    async def close(self) -> None:
        """Drain, finalize durability, and shut the dispatch worker down.

        Stops admitting (subsequent :meth:`submit` raises
        :class:`ServiceClosed`), flushes every open window, waits for the
        in-flight batches, then runs the driver's exit contract on the
        worker thread — the tail journal epoch covering every settled
        batch, written and fsynced synchronously, so a clean close always
        leaves the journal on a JOINED epoch (crash recovery replays to
        exactly the served state). A failure from a batch or from the
        finalize itself is re-raised here, never dropped.
        """
        if self._closed:
            return
        self._closed = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        await self.drain()
        try:
            await self._loop.run_in_executor(
                self._executor, self._finalize_worker
            )
        finally:
            self._pack_executor.shutdown(wait=True)
            self._executor.shutdown(wait=True)
            if self.telemetry is not None:
                self.telemetry.close()
            # The shutdown postmortem: a failure path already snapshotted
            # at the moment of failure (those rings are closer to the
            # truth) — a clean close records the final state.
            tracer = active_tracer()
            if tracer.enabled and self.flight_dump is None:
                self.flight_dump = tracer.flight_dump(
                    reason=(
                        "close" if self._failure is None
                        else f"close after failure: {self._failure!r}"
                    )
                )
        if self._failure is not None:
            raise self._failure

    def _finalize_worker(self) -> None:
        try:
            with _device_scope(self._device):
                self._driver.finalize()
            self._observe_durable()
        except BaseException as exc:  # noqa: BLE001 — surfaced by close()
            if self._failure is None:
                self._failure = exc
        finally:
            if self._await_durable:
                # Settled but durability never confirmed (the journal
                # died before their covering epoch fsynced — only a
                # failure path leaves entries here: a clean finalize's
                # tail epoch drains them all). Their replies went out,
                # but goodput must not credit a completion a crash may
                # have eaten: classify against the objective as failed.
                tracer = active_tracer()
                unconfirmed = []
                for batch_index, entries in self._await_durable:
                    for request, _t_settled in entries:
                        unconfirmed.append(request)
                        if tracer.enabled:
                            tracer.request_event(
                                request.ctx, "durable_unconfirmed",
                                args={"batch": batch_index},
                            )
                self._await_durable.clear()
                self._count_failed(unconfirmed)

    async def __aenter__(self) -> "ConsensusService":
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        # A body that already failed should surface ITS error; close's
        # drain still runs so the journal ends joined where possible.
        if exc_type is None:
            await self.close()
        else:
            try:
                await self.close()
            except BaseException:  # noqa: BLE001 — body error wins
                pass
