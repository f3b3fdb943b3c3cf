"""`SessionDriver` — drive one batch at a time over a resident settlement
session, with the stream's durability cadence factored out of the loop.

The port's copy of the JAX package's ``serve/driver.py``:

* :class:`SessionDriver` owns the per-batch dispatch (``dispatch``: the
  flat settle, a per-batch session, or ONE resident session that
  refreshes on a topology hit and adopts on a miss), the rolling
  durability cadence (``checkpoint``: journal epochs or background SQLite
  flushes), and the exit contract (``finalize``).
  :func:`~.pipeline.settle_stream` runs on it, so a caller that drives
  the driver directly gets the stream's bytes.
* :class:`PlanCache` is the topology-fingerprint plan-reuse step
  (:class:`~.pipeline.PlanPrefetcher`'s ``reuse_plans`` logic) as a
  synchronous object, for callers that build plans on their own
  schedule: a fingerprint hit refreshes the previous plan's probability
  block, a miss rebuilds — bit-identical to the prefetcher.
* :func:`drive_trace` re-drives a recorded trace through both.

The driver is not thread-safe: one driver, one driving thread. The store
underneath is thread-safe; the driver's session and durability
bookkeeping are not shared state.
"""

from __future__ import annotations

import time as _time
from typing import Optional, Sequence

import numpy as np

from bayesian_consensus_engine_tpu_torch.core.batch import topology_fingerprint
from bayesian_consensus_engine_tpu_torch.obs.metrics import metrics_registry
from bayesian_consensus_engine_tpu_torch.obs.timeline import active_timeline
from bayesian_consensus_engine_tpu_torch.obs.trace import active_tracer


def _sample_device_memory(registry, device) -> None:
    """``hbm.*`` gauges at a phase boundary — the runtime memory view.

    Samples :func:`~.utils.profiling.device_memory_stats` of *device* (the
    mesh's first device) into ``hbm.bytes_in_use`` / ``hbm.peak_bytes``,
    so the sharded stream reports live device memory next to its latency
    numbers. Zeros on the CPU. Only runs with a live registry: disabled
    obs never touches the device API.
    """
    if not registry.enabled:
        return
    from bayesian_consensus_engine_tpu_torch.utils.profiling import (
        device_memory_stats,
    )

    stats = device_memory_stats(device)
    registry.gauge("hbm.bytes_in_use").set(stats["bytes_in_use"] or 0)
    registry.gauge("hbm.peak_bytes").set(stats["peak_bytes_in_use"] or 0)


class PlanCache:
    """Fingerprint-keyed plan reuse for caller-scheduled (columnar) builds.

    The delta-ingest compare :class:`~.pipeline.PlanPrefetcher` runs on its
    worker thread, exposed synchronously: ``plan_for`` fingerprints the
    batch's topology and, when it matches the previous batch's, refreshes
    the cached plan with the new probabilities (probs-only twin — pack,
    intern, and block fill all skipped) instead of rebuilding. Identical
    decisions and identical plans to ``PlanPrefetcher(reuse_plans=True)``
    on the same batch sequence, by construction: same fingerprint, same
    ``SettlementPlan.refresh``, same columnar builder on a miss.

    ``plan_for`` splits into :meth:`stage` (fingerprint + grouping +
    refresh — NO store interaction) and :meth:`bind` (the interning pass
    + block assembly) so the serving front end can run the staging half
    ahead on a pack thread while the previous batch holds the device:
    a fingerprint HIT completes entirely at stage time (the refresh twin
    never touches the store), a MISS returns a
    :class:`~.pipeline.StagedColumnarPlan` for ``bind`` to finish on the
    dispatch thread — in batch order, so row assignment (and which
    journal epoch a new pair's table row lands in) stays a deterministic
    function of the batch sequence. ``bind(stage(...)) ≡ plan_for(...)``
    bit-for-bit.

    ``intern_mode`` (``"auto"`` default) routes a miss's interning pass
    through the store's epoch-persistent pair table, so a drifted batch
    interns only its pair-delta on the dispatch thread; ``"full"`` is
    the legacy every-pair walk. Byte-identical plans and durability
    bytes either way — the mode only moves time.
    """

    def __init__(self, store, num_slots: "int | str | None" = "bucket",
                 intern_mode: str = "auto"):
        self._store = store
        self._num_slots = num_slots
        self._intern_mode = intern_mode
        self._last = None

    @property
    def last_plan(self):
        return self._last

    def stage(self, market_keys, source_ids, probabilities, offsets):
        """Store-free half: a complete plan on a fingerprint hit, a
        :class:`~.pipeline.StagedColumnarPlan` for :meth:`bind` on a miss.

        Calls for consecutive batches must be SEQUENTIAL (one pack
        thread): the fingerprint compares against the previous batch's
        plan, and on a miss the chain advances only when :meth:`bind`
        completes — the caller sequences stage(N+1) after bind(N) (the
        serving front end's bound-event chain).
        """
        from bayesian_consensus_engine_tpu_torch.pipeline import (
            stage_settlement_plan_columnar,
        )

        probabilities = np.ascontiguousarray(probabilities, dtype=np.float64)
        digest = topology_fingerprint(market_keys, source_ids, offsets)
        prev = self._last
        if prev is not None and prev.fingerprint == digest:
            plan = prev.refresh(probabilities)
            self._last = plan
            return plan
        return stage_settlement_plan_columnar(
            market_keys, source_ids, probabilities, offsets,
            num_slots=self._num_slots, fingerprint=digest,
            intern_mode=self._intern_mode,
        )

    def bind(self, staged):
        """Finish a :meth:`stage` result: interning + assembly on a miss
        (the only store-touching step), identity on a hit."""
        from bayesian_consensus_engine_tpu_torch.pipeline import (
            StagedColumnarPlan,
        )

        if isinstance(staged, StagedColumnarPlan):
            plan = staged.bind(self._store)
            self._last = plan
            return plan
        return staged

    def plan_for(self, market_keys, source_ids, probabilities, offsets):
        """Plan for one columnar batch; reuses on a topology-digest hit."""
        return self.bind(
            self.stage(market_keys, source_ids, probabilities, offsets)
        )


class SessionDriver:
    """One batch at a time over a resident session, durability included.

    The loop body of :func:`~.pipeline.settle_stream` as a reusable
    object. A driver holds (lazily) ONE long-lived
    :class:`~.pipeline.ShardedSettlementSession` under ``mesh=`` — served
    resident across batches exactly as the stream does: topology hits
    refresh the probs block, misses ``adopt()`` with the block held on
    the device — plus the durability ladder: journal epochs (sync or
    async) or rolling SQLite flushes every *checkpoint_every* batches,
    and the tail-flush/join contract on :meth:`finalize`.

    Protocol per batch ``i`` (indexes must be sequential from 0):

    1. ``result = driver.dispatch(plan, outcomes, now=..., band=...)``
    2. ``checkpoint_s = driver.checkpoint(i)`` (``None`` when not due)

    and once, on EVERY exit path (success, consumer break, batch error):

    3. ``driver.finalize()`` — joins/ writes the tail epoch covering every
       fully settled batch (never one that raised mid-settle), re-raises
       any background write failure, closes an owned journal, and tail-
       flushes SQLite. After a clean ``finalize`` a journal's last epoch
       is JOINED (fsynced) — the drain contract the serving front end's
       shutdown leans on.

    ``last_adopt`` after a dispatch is how the session served it
    (``"start"``/``"refresh"``/``"relayout"``/``"rebuild:<reason>"`` —
    the reason names the remaining fallback, see
    :meth:`~.pipeline.ShardedSettlementSession.adopt`; ``None`` on
    the flat path and with ``resident_session=False``), and
    ``durable_through`` is the highest batch index whose journal epoch is
    known fsynced — the watermark per-request durability accounting reads.
    """

    def __init__(
        self,
        store,
        steps: int = 1,
        mesh=None,
        dtype=None,
        resident_session: bool = True,
        journal=None,
        owns_journal: bool = False,
        db_path=None,
        checkpoint_every: int = 1,
        sync_checkpoints: bool = False,
        lazy_checkpoints: bool = False,
        analytics=None,
    ) -> None:
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if analytics is not None and analytics is not False:
            from bayesian_consensus_engine_tpu_torch.analytics.bands import (
                AnalyticsOptions,
            )

            if analytics is True:
                # The shorthand is BANDS-ONLY: the serving surface has
                # no per-request tie-break field, so the default must
                # not spend a ring pass per batch on an unreachable
                # output. Pass AnalyticsOptions(tiebreak=True) to keep
                # the full tier on `last_analytics`.
                analytics = AnalyticsOptions(tiebreak=False)
            if not isinstance(analytics, AnalyticsOptions):
                raise TypeError(
                    "analytics= takes True, an AnalyticsOptions, or None"
                )
            if mesh is None or not resident_session:
                raise ValueError(
                    "analytics= needs the resident sharded session "
                    "(mesh= with resident_session=True): bands read the "
                    "device-resident reliability block"
                )
        else:
            analytics = None
        if journal is not None and lazy_checkpoints:
            raise ValueError(
                "journal= epochs are drained truth by contract; "
                "lazy_checkpoints cannot combine with a journal"
            )
        self._store = store
        self._steps = steps
        self._mesh = mesh
        self._dtype = dtype
        self._resident_session = resident_session
        self._journal = journal
        self._owns_journal = owns_journal
        self._db_path = db_path
        self._checkpoint_every = checkpoint_every
        self._sync_checkpoints = sync_checkpoints
        self._lazy_checkpoints = lazy_checkpoints
        self._analytics = analytics
        #: The last dispatch's analytics tier, when ``analytics=`` is on:
        #: ``(RingTieBreakResult, UncertaintyBands, propagated-or-None)``
        #: of per-market band views over the batch's markets. ``None``
        #: with analytics off. Pure-additive: reading (or ignoring) it
        #: never moves a settlement byte.
        self.last_analytics = None

        registry = metrics_registry()
        self._adopts_counter = registry.counter("stream.session_adopts")
        self._resident_gauge = registry.gauge("stream.resident_rows")
        #: Counts every batch the resident session could NOT serve
        #: resident — an adopt that fell back to dropping the block
        #: (``rebuild:<reason>``) or a mid-stream session replacement
        #: (band change). A healthy stream holds this at 0, and where
        #: it moves ``stats["session_adopt"]``'s reason suffix names
        #: the fallback.
        self._fallback_counter = registry.counter(
            "stream.resident_fallbacks"
        )

        self._session = None  # the mesh path's long-lived resident session
        self._session_band = None
        self._handle = None  # in-flight background SQLite flush
        self._journal_handle = None  # in-flight background journal epoch
        self._flushed_through = -1
        self._journaled_through = -1
        self._settled_through = -1
        self._started_through = -1  # batches BEGUN (≥ settled on a raise)
        self._journal_write_failed = False
        self.last_adopt: Optional[str] = None
        #: Highest batch index whose journal epoch is known fsynced. Sync
        #: mode advances it at each checkpoint; async mode advances it to
        #: the PREVIOUS epoch when the next checkpoint (or finalize) joins
        #: the in-flight write — the "yield implies epoch N−1 fsynced"
        #: contract as a readable watermark.
        self.durable_through = -1

    # -- dispatch ------------------------------------------------------------

    @property
    def settled_through(self) -> int:
        """Index of the last batch that fully settled (−1 before any)."""
        return self._settled_through

    @property
    def session(self):
        return self._session

    def dispatch(
        self,
        plan,
        outcomes: Sequence[bool],
        now: Optional[float] = None,
        band=None,
    ):
        """Settle one batch; returns its :class:`~.pipeline.SettlementResult`.

        ``mesh=None`` → the flat :func:`~.pipeline.settle` chain.
        ``mesh`` + ``resident_session=False`` → the legacy per-batch
        session (abandoned unclosed so its merge recipe stays deferred).
        Otherwise ONE resident session across calls: started on the first
        batch (or a band change), topology hits served by a probs-only
        refresh, misses adopted with the block held on the device. How
        the batch was served is ``self.last_adopt``.
        """
        from bayesian_consensus_engine_tpu_torch.pipeline import (
            ShardedSettlementSession,
            settle,
        )

        store = self._store
        self._started_through += 1
        self.last_adopt = None
        if self._mesh is None:
            result = settle(
                store, plan, outcomes, steps=self._steps, now=now,
                dtype=self._dtype,
            )
        elif not self._resident_session:
            # LEGACY per-batch session (A/B benches + tests), abandoned
            # without close: the settle registered the store's merge
            # recipe, and closing here would sync it eagerly — serialising
            # the device→host gather against this thread. Left pending,
            # the NEXT batch's state build (or the checkpoint flush)
            # resolves it instead.
            result = ShardedSettlementSession(
                store, plan, self._mesh, dtype=self._dtype, band=band
            ).settle(outcomes, steps=self._steps, now=now)
        else:
            # ONE resident session across batches: a topology hit uploads
            # only the probs block, a miss adopts the new plan with the
            # block held on the device (never closed mid-stream — the
            # standing recipe resolves at the next checkpoint/overlap like
            # the per-batch shape's deferred gathers; a crash restart
            # simply builds a fresh session for the resume stream).
            if self._session is None or band != self._session_band:
                if self._session is not None:
                    # The replaced session's standing gather is no longer
                    # session-pinned: let its bytes count against the
                    # deferral budget again. Dropping a LIVE session is a
                    # resident fallback (the block did not survive the
                    # band change) — counted so the retirement of every
                    # teardown path stays measurable in ledgers.
                    self._session._release_standing()
                    self._fallback_counter.inc()
                self._session = ShardedSettlementSession(
                    store, plan, self._mesh, dtype=self._dtype, band=band
                )
                self._session_band = band
                self.last_adopt = "start"
            else:
                self.last_adopt = self._session.adopt(plan, band=band)
                if self.last_adopt != "refresh":
                    self._adopts_counter.inc()
                if self.last_adopt.startswith("rebuild"):
                    self._fallback_counter.inc()
            self._resident_gauge.set(float(self._session._touched.size))
            if self._analytics is not None:
                # The fused co-resident program: settlement bytes (and
                # the consensus itself) equal the plain entry's — the
                # analytics on/off byte-parity contract — with the
                # bands (+ optional sweep) riding the same dispatch.
                result, tiebreak, bands, propagated = (
                    self._session.settle_with_analytics(
                        outcomes, steps=self._steps, now=now,
                        analytics=self._analytics,
                    )
                )
                self.last_analytics = (tiebreak, bands, propagated)
            else:
                result = self._session.settle(
                    outcomes, steps=self._steps, now=now
                )
        if self._mesh is not None:
            # Phase boundary: the settle just dispatched — sample live
            # device memory into the hbm.* gauges (no-op obs-disabled).
            _sample_device_memory(
                metrics_registry(), self._mesh.devices[0][0]
            )
        self._settled_through = self._started_through
        return result

    # -- durability ----------------------------------------------------------

    def checkpoint_due(self, index: int) -> bool:
        return (
            (index + 1) % self._checkpoint_every == 0
            and (self._journal is not None or self._db_path is not None)
        )

    def checkpoint(self, index: int) -> Optional[float]:
        """Run the rolling durability step for settled batch *index*.

        Journal mode appends one epoch (tag = *index*): in-loop
        write+fsync under ``sync_checkpoints``, else snapshotted here and
        written on the background thread — the join inside surfaces the
        PREVIOUS epoch's completion or failure. SQLite mode backgrounds
        the rolling flush. Returns the serial seconds spent, or ``None``
        when this index is not on the cadence. A journal-write failure is
        remembered so :meth:`finalize` does not retry the broken journal
        and shadow the original error.
        """
        if not self.checkpoint_due(index):
            return None
        store, timeline = self._store, active_timeline()
        checkpoint_start = _time.perf_counter()
        if self._journal is not None:
            try:
                with timeline.span("checkpoint"):
                    if self._sync_checkpoints:
                        store.flush_to_journal(self._journal, tag=index)
                        self.durable_through = index
                    else:
                        previous_inflight = (
                            self._journaled_through
                            if self._journal_handle is not None
                            else self.durable_through
                        )
                        self._journal_handle = store.flush_to_journal_async(
                            self._journal, tag=index
                        )
                        # The async call joined any in-flight epoch before
                        # writing: the previous cadence is durable now.
                        self.durable_through = previous_inflight
            except BaseException:
                self._journal_write_failed = True
                raise
            self._journaled_through = index
        else:
            # Joins any in-flight write first (flushes serialise), so a
            # prior background failure surfaces here, not silently.
            with timeline.span("checkpoint"):
                self._handle = store.flush_to_sqlite_async(
                    self._db_path,
                    resolve_pending=not self._lazy_checkpoints,
                )
            if not self._lazy_checkpoints:
                self._flushed_through = index
        if self._mesh is not None:
            # Phase boundary: the checkpoint drain just resolved pending
            # device results — the second hbm.* sample point per batch.
            _sample_device_memory(
                metrics_registry(), self._mesh.devices[0][0]
            )
        tracer = active_tracer()
        if tracer.enabled:
            # The watermark the per-request durable spans read, as a
            # batch-chain event: deterministic (a pure function of the
            # checkpoint cadence), wall-free args.
            tracer.batch_event(
                index, "durable_watermark",
                args={
                    "durable_through": self.durable_through,
                    "flushed_through": self._flushed_through,
                },
            )
        return _time.perf_counter() - checkpoint_start

    def finalize(self) -> None:
        """The exit contract — run on EVERY exit path, exactly once.

        The in-flight journal write is always joined (a background
        failure must never be dropped) and every fully settled batch
        reaches the checkpoint file, with every pair the store has
        interned. Tail epochs and flushes cover through
        ``settled_through`` only — a batch that RAISED mid-settle is
        never claimed as durable. When the caller is exiting BECAUSE a
        journal write failed, the tail epoch is skipped: retrying the
        broken journal here would raise again and replace the original
        error — the journal's durable point is simply the last epoch that
        landed. After a clean return the journal (if any) ends on a
        JOINED, fsynced epoch.
        """
        store, timeline = self._store, active_timeline()
        try:
            if self._journal is not None and not self._journal_write_failed:
                settled_past_epoch = (
                    self._settled_through > self._journaled_through
                )
                if not settled_past_epoch and self._journal_handle is not None:
                    # No batch settled since the last cadence, whose epoch
                    # may still be in flight: the stream must not end
                    # before its durability (or failure) is known.
                    with timeline.span("journal_async_wait"):
                        self._journal_handle.result()
                    self.durable_through = self._journaled_through
                # A stream's prefetch worker interns the pairs of batches
                # ahead of the consumer; pairs interned after the last
                # epoch's snapshot go into a tail epoch too, so replay
                # rebuilds the store's row assignment after an early exit.
                if settled_past_epoch or (
                    self._settled_through >= 0
                    and len(store) > self._journal.rows_covered
                ):
                    # Joins any in-flight background epoch first, so the
                    # tail epoch lands after (and surfaces any failure
                    # of) the last cadence's write.
                    store.flush_to_journal(
                        self._journal, tag=self._settled_through
                    )
                    self.durable_through = self._settled_through
        finally:
            tracer = active_tracer()
            if tracer.enabled and self._settled_through >= 0:
                tracer.batch_event(
                    self._settled_through, "finalize",
                    args={"durable_through": self.durable_through},
                )
            if self._owns_journal and self._journal is not None:
                self._journal.close()
            if self._db_path is not None and self._started_through >= 0:
                if self._handle is not None:
                    self._handle.result()
                if self._flushed_through != self._started_through:
                    store.flush_to_sqlite(self._db_path)


def drive_trace(
    store,
    trace,
    mesh=None,
    dtype=None,
    journal=None,
    db_path=None,
    checkpoint_every: int = 1,
    num_slots: "int | str | None" = "bucket",
    intern_mode: str = "auto",
):
    """Re-drive a recorded trace through the REAL settle machinery.

    The authoritative lane of a counterfactual replay: each
    :class:`~.state.journal.TraceBatch` re-plans from its recorded
    columnar columns (the same :class:`PlanCache`
    stage/bind chain the serving front end runs, so pair interning
    happens in the recorded admission order), dispatches through ONE
    :class:`SessionDriver` — flat (``mesh=None``) or sharded-resident —
    at the recorded settlement day and step count, and runs the recorded
    checkpoint cadence against *journal* / *db_path* when given. Because
    this IS the live loop body over the live inputs, the rebuilt store is
    byte-identical to the recorded run's settled state (digest + SQLite
    bytes — the replay lab's lane-0 contract) structurally,
    not by a parallel implementation kept honest.

    Returns the per-batch :class:`~.pipeline.SettlementResult` list.
    """
    batches = list(trace)
    results: list = []
    if not batches:
        return results
    steps_seen = {int(batch.steps) for batch in batches}
    if len(steps_seen) != 1:
        raise ValueError(
            f"trace mixes step counts {sorted(steps_seen)}; one driver "
            "runs one compiled step shape — split the trace"
        )
    owns_journal = False
    if journal is not None and not hasattr(journal, "append_epoch"):
        from bayesian_consensus_engine_tpu_torch.state.journal import (
            JournalWriter,
        )

        journal = JournalWriter(journal)
        owns_journal = True
    driver = SessionDriver(
        store,
        steps=steps_seen.pop(),
        mesh=mesh,
        dtype=dtype,
        journal=journal,
        owns_journal=owns_journal,
        db_path=db_path,
        checkpoint_every=checkpoint_every,
    )
    plans = PlanCache(store, num_slots=num_slots, intern_mode=intern_mode)
    timeline = active_timeline()
    try:
        for position, batch in enumerate(batches):
            with timeline.span("replay"):
                plan = plans.plan_for(
                    list(batch.market_keys),
                    list(batch.source_ids),
                    batch.probabilities,
                    batch.offsets,
                )
                results.append(
                    driver.dispatch(
                        plan, batch.outcomes, now=float(batch.now_days)
                    )
                )
                driver.checkpoint(position)
    finally:
        driver.finalize()
    return results
