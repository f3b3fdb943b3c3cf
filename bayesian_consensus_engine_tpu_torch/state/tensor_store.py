"""Device-tensor reliability store — the port of ``state/tensor_store.py``.

The same state as the JAX package's store, as flat arrays indexed by
interned (source, market) pair row:

    reliability f[R]   confidence f[R]   updated_days f[R]   exists bool[R]

The host keeps the authoritative float64 arrays plus the string sidecars
(pair interner, ISO timestamps); the device tier holds torch tensors on the
store's device. Three access tiers:

  1. **Record API** — get/update/list/put with the reference's cold-start
     semantics, scalar host math.
  2. **Row API** — ``rows_for_pairs`` / ``rows_for_arrays`` /
     ``rows_for_indexed``: one interning pass per batch;
     ``rows_for_pairs_delta`` interns only a batch's delta against the
     last bound batch (the epoch pair table).
  3. **Device tier** — ``take_device_state`` hands the flat state to the
     settle kernel, ``defer_absorb`` adopts the settled state as pending,
     and the host merges it lazily (``sync``), fetching only the rows a
     settle touched. The resident session reads its rows with
     ``host_rows`` and registers its merges with ``defer_settle_recipe``
     (no flat state; ``pending_overlaps`` says when it must sync first).

Durability, two tiers:

  * **SQLite** — ``from_sqlite`` / ``flush_to_sqlite`` keep on-disk
    checkpoints byte-compatible with the JAX package's and the reference's
    DB files. With the port's C interner (``native/internmap.c``) a flush
    to a file sorts and writes in C against a dlopen()ed ``libsqlite3``;
    otherwise it goes through the ``sqlite3`` module, with the same
    records. ``flush_to_sqlite_async`` snapshots the rows at the call and
    writes them on a background thread (the C writer with the GIL
    released), returning a :class:`FlushHandle`.
  * **Journal** — ``flush_to_journal`` / ``flush_to_journal_async`` append
    one epoch of the rows dirtied since the last epoch to a
    :class:`~.journal.JournalWriter` (``state/journal.py``), with the JAX
    package's bytes; ``replay_journal`` rebuilds a store from it.

The two tiers keep separate dirty flags, so neither steals rows from the
other. Beside them, ``save_checkpoint`` / ``load_checkpoint`` snapshot
the whole store (its four row arrays, pair ids and ISO stamps) through
``state/checkpoint.CycleCheckpointer``, deferred device truth synced
first, for a settle chain to resume after a preemption; the bytes are
the port's own, where the JAX package writes orbax's. The device is
explicit (``device=None`` means CUDA, and a machine without CUDA raises
unless ``device="cpu"`` was asked for).
"""

from __future__ import annotations

import threading
from functools import wraps
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.obs.metrics import (
    metrics_registry as _metrics_registry,
)
from bayesian_consensus_engine_tpu_torch.obs.timeline import (
    active_timeline as _active_timeline,
)
from bayesian_consensus_engine_tpu_torch.state.checkpoint import CycleCheckpointer
from bayesian_consensus_engine_tpu_torch.state.decay import (
    apply_reliability_decay,
    days_since_update,
)
from bayesian_consensus_engine_tpu_torch.state.records import ReliabilityRecord
from bayesian_consensus_engine_tpu_torch.state.sqlite_store import (
    SQLiteReliabilityStore,
    interchange_fingerprint,
)
from bayesian_consensus_engine_tpu_torch.state.update_math import (
    apply_outcome,
    apply_outcome_batch,
)
from bayesian_consensus_engine_tpu_torch.utils.config import (
    DECAY_HALF_LIFE_DAYS,
    DECAY_MINIMUM,
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
)
from bayesian_consensus_engine_tpu_torch.utils.device import (
    resolve_device,
    resolve_dtype,
)
from bayesian_consensus_engine_tpu_torch.utils import interning as _interning
from bayesian_consensus_engine_tpu_torch.utils.interning import make_pair_interner
from bayesian_consensus_engine_tpu_torch.utils.timeconv import (
    NEVER,
    days_to_iso,
    iso_to_days,
    now_days,
    utc_now_iso,
)

_GROW = 2
_MIN_CAPACITY = 64
# Deferred settle recipes pin device memory; beyond this, the oldest links
# apply early — always safe, they describe values that were final when
# gathered.
_MAX_DEFERRED_BYTES = 2 * 1024**3


def _to_numpy(value) -> np.ndarray:
    """Host copy of a tensor (or array-like) as numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _held_nbytes(rel_touched) -> int:
    """Device bytes a recipe's reliabilities pin: a tensor's size, or a
    lazy gather's ``held_nbytes`` (0 while its session holds the block)."""
    if isinstance(rel_touched, torch.Tensor):
        return rel_touched.numel() * rel_touched.element_size()
    return int(rel_touched.held_nbytes)


def _device_take(tensor: torch.Tensor, rows: np.ndarray) -> np.ndarray:
    """Device-side gather of *rows*, fetched to the host."""
    index = torch.as_tensor(rows, dtype=torch.int64, device=tensor.device)
    return _to_numpy(tensor[index])


def _locked(method):
    """Serialise a host-tier method on the store's reentrant lock, so plan
    building on one thread and settle-side host reads on another cannot
    lose a write when interning grows the flat arrays."""

    @wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._host_lock:
            return method(self, *args, **kwargs)

    return wrapper


class FlushHandle:
    """An in-flight background SQLite checkpoint (``flush_to_sqlite_async``).

    ``result()`` joins the writer thread and returns the written row count,
    re-raising the writer's failure after ROLLING BACK the store's flush
    bookkeeping (the snapshotted rows are re-marked dirty and the last-
    flush target is restored, so the next flush re-covers everything this
    one claimed — the on-disk file itself is untouched by a failed write:
    the writer is one SQLite transaction). The store joins any in-flight
    handle before starting another flush, so writes to a target never
    interleave.
    """

    __slots__ = ("_store", "_thread", "_writer", "_rows", "_exc",
                 "_restore", "_finished", "_fingerprint")

    def __init__(self, store, writer, restore) -> None:
        self._store = store
        self._writer = writer
        self._restore = restore  # (selected, dead, prev_path, prev_fp) | None
        self._rows: Optional[int] = None
        self._exc: Optional[BaseException] = None
        self._finished = False
        # Captured by the writer thread AFTER its transaction commits: the
        # target's post-write content identity, recorded on the store at
        # join so the next auto-incremental flush can verify nothing else
        # touched the file in between (see _plan_flush).
        self._fingerprint = None
        self._thread = threading.Thread(
            target=self._run, name="bce-flush", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        # No store lock in here: the writer touches only snapshot data, and
        # taking the lock from this thread could deadlock with a joiner
        # that already holds it (result() is called under the store lock by
        # the flush entry points).
        try:
            self._rows, self._fingerprint = self._writer()
        except BaseException as exc:  # noqa: BLE001 — re-raised in result()
            self._exc = exc

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None) -> int:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("background flush still running")
        if self._finished:
            if self._exc is not None:
                raise self._exc
            return self._rows
        self._finished = True
        if self._exc is not None:
            store = self._store
            with store._host_lock:
                if store._flush_inflight is self:
                    store._flush_inflight = None
                if self._restore is not None:
                    selected, dead, prev_path, prev_fp = self._restore
                    store._dirty[selected] = True
                    if dead:
                        store._dirty[dead] = True
                    store._last_flush_path = prev_path
                    store._last_flush_fp = prev_fp
            raise self._exc
        with self._store._host_lock:
            if self._store._flush_inflight is self:
                self._store._flush_inflight = None
            if self._restore is not None:
                # Restorable target ⇒ this flush claimed it: record its
                # post-write identity for the next incremental check.
                self._store._last_flush_fp = self._fingerprint
        return self._rows


class JournalFlushHandle:
    """An in-flight background journal epoch (``flush_to_journal_async``).

    The durability twin of :class:`FlushHandle` for the journal tier: the
    epoch's CONTENT was snapshotted synchronously under the store lock
    (the drained truth as of the ``flush_to_journal_async`` call); only
    the framing, CRC, append, and fsync run on the writer thread.
    ``result()`` joins and returns the epoch's dirty-row count; a failed
    write re-raises here with the snapshot's rows re-marked
    journal-dirty (the next epoch re-covers them) and the journal file
    truncated back to its pre-append length (best effort — the writer
    never advanced its epoch index, so a resumed/continuing writer
    appends at the same valid end replay stops at). The store joins any
    in-flight epoch before starting another, so epochs never interleave.
    """

    __slots__ = ("_store", "_thread", "_writer", "_rows", "_exc",
                 "_restore_idx", "_finished")

    def __init__(self, store, writer, restore_idx) -> None:
        self._store = store
        self._writer = writer
        self._restore_idx = restore_idx  # rows to re-mark journal-dirty
        self._rows: Optional[int] = None
        self._exc: Optional[BaseException] = None
        self._finished = False
        self._thread = threading.Thread(
            target=self._run, name="bce-journal-flush", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        # Same lock discipline as FlushHandle._run: snapshot data only.
        try:
            self._rows = self._writer()
        except BaseException as exc:  # noqa: BLE001 — re-raised in result()
            self._exc = exc

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None) -> int:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("background journal epoch still running")
        if self._finished:
            if self._exc is not None:
                raise self._exc
            return self._rows
        self._finished = True
        store = self._store
        with store._host_lock:
            if store._journal_inflight is self:
                store._journal_inflight = None
            if self._exc is not None:
                store._journal_dirty[self._restore_idx] = True
        if self._exc is not None:
            raise self._exc
        return self._rows


class _PairEpochTable:
    """One epoch of resolved pair interning — the delta-interning cache.

    Holds the LAST bound batch's pair columns (market table in payload
    order, code-point-sorted source table, grouped (rank, market) pair
    arrays with CSR offsets), the store rows that batch resolved to, and
    the batch's pair-set fingerprint (:func:`~.core.batch.pair_fingerprint`).
    A later batch interns only its delta against this table: an equal
    fingerprint reuses ``rows`` outright; otherwise unchanged markets match
    per market (:func:`~.utils.interning.delta_match_rows`) and only the
    mismatched markets' pairs walk the interner. Every mapping in here was
    witnessed by a real intern pass against this store, and the interner
    is append-only, so a cached (pair → row) can never go stale within one
    store.
    """

    __slots__ = (
        "fingerprint", "market_keys", "src_table", "pair_rank",
        "pair_market", "pair_offsets", "rows", "_src_index", "_mkt_index",
    )

    def __init__(self, fingerprint, market_keys, src_table, pair_rank,
                 pair_market, pair_offsets, rows) -> None:
        self.fingerprint = fingerprint
        self.market_keys = market_keys
        self.src_table = src_table
        self.pair_rank = pair_rank
        self.pair_market = pair_market
        self.pair_offsets = pair_offsets
        self.rows = rows
        self._src_index = None
        self._mkt_index = None

    def src_index(self) -> dict:
        """source id → rank in this epoch's table (built lazily: the
        same-table fast path never needs it)."""
        if self._src_index is None:
            self._src_index = {s: i for i, s in enumerate(self.src_table)}
        return self._src_index

    def market_index(self) -> dict:
        """market id → position in this epoch's market table (lazy: a
        stream with a stable market list never builds it)."""
        if self._mkt_index is None:
            self._mkt_index = {k: i for i, k in enumerate(self.market_keys)}
        return self._mkt_index


class DeviceReliabilityState(NamedTuple):
    """The flat device state the settle kernel consumes.

    ``updated_days`` is epoch-days relative to the ``epoch0`` that travels
    beside it (small magnitudes keep float32 elapsed-time subtraction
    exact to ~seconds); 0 means never updated.
    """

    reliability: torch.Tensor
    confidence: torch.Tensor
    updated_days: torch.Tensor
    exists: torch.Tensor


class TensorReliabilityStore:
    """Reliability scores in flat tensors with interned (source, market) rows."""

    def __init__(self, capacity: int = _MIN_CAPACITY, device=None) -> None:
        self.device = resolve_device(device)
        capacity = max(capacity, _MIN_CAPACITY)
        self._pairs = make_pair_interner()
        self._rel = np.full(capacity, DEFAULT_RELIABILITY, dtype=np.float64)
        self._conf = np.full(capacity, DEFAULT_CONFIDENCE, dtype=np.float64)
        self._days = np.full(capacity, NEVER, dtype=np.float64)
        self._exists = np.zeros(capacity, dtype=bool)
        self._iso: List[str] = []
        self._device_cache = None  # (DeviceReliabilityState, epoch0)
        # Deferred-absorb pending state: a settled device state whose
        # rel/days/exists the host has NOT yet merged (confidences are
        # host-authoritative throughout — the settle path replays them
        # exactly). Synced lazily on the first host read/write that needs
        # it; chained settles hand it forward device-resident instead.
        self._pending = None  # (DeviceReliabilityState, epoch0)
        # Settle sync recipes: [(touched_rows, rel_touched_dev, epoch0,
        # stamp_rel)] — the cheap path _sync_pending takes when set (fetch
        # only touched rows; stamps/existence are closed-form).
        self._pending_sync = None
        # True when _device_cache's confidences are the device trajectory
        # (ulp-drifted from the authoritative host replay): acceptable for
        # the settle chain, refreshed from host for device_state consumers.
        self._cache_conf_drifted = False
        # Rows changed since the last flush to ``_last_flush_path``
        # (UPSERT only what changed), and the content identity that flush
        # left there.
        self._dirty = np.zeros(capacity, dtype=bool)
        self._last_flush_path: Optional[str] = None
        self._last_flush_fp = None
        # Separate dirty tracking for the durability journal
        # (state/journal.py): journal epochs and SQLite flushes are
        # independent tiers — a journal epoch must not steal rows from
        # the next SQLite checkpoint or vice versa.
        self._journal_dirty = np.zeros(capacity, dtype=bool)
        # The last bound batch's resolved pairs (rows_for_pairs_delta).
        # Dropped by the recovery paths (absorb_replayed_rows, journal
        # replay), so a bind after recovery re-witnesses every pair.
        self._pair_epoch: Optional[_PairEpochTable] = None
        # One reentrant lock over every public host-side method; the
        # background writers (FlushHandle, JournalFlushHandle) never take
        # it while they write.
        self._host_lock = threading.RLock()
        self._flush_inflight: Optional[FlushHandle] = None
        self._journal_inflight: Optional[JournalFlushHandle] = None

    # -- row management ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._pairs)

    @_locked
    def live_row_count(self) -> int:
        """Rows with a live record (``exists``) — what ``list_sources``
        would return, without materialising and sorting the records."""
        self._sync_pending()
        return int(self._exists[: len(self._pairs)].sum())

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= len(self._rel):
            return
        new_cap = len(self._rel)
        while new_cap < needed:
            new_cap *= _GROW

        def grow(array: np.ndarray, fill) -> np.ndarray:
            out = np.full(new_cap, fill, dtype=array.dtype)
            out[: len(array)] = array
            return out

        self._rel = grow(self._rel, DEFAULT_RELIABILITY)
        self._conf = grow(self._conf, DEFAULT_CONFIDENCE)
        self._days = grow(self._days, NEVER)
        self._exists = grow(self._exists, False)
        self._dirty = grow(self._dirty, False)
        self._journal_dirty = grow(self._journal_dirty, False)

    def _row_for(self, source_id: str, market_id: str) -> int:
        """Row for a pair, allocating (but NOT marking existing) if new."""
        before = len(self._pairs)
        row = self._pairs.intern((source_id, market_id))
        if row == before:  # freshly allocated
            self._iso.append("")
            self._ensure_capacity(row + 1)
        return row

    def _invalidate(self) -> None:
        # Pending state survives cache invalidation: it holds un-merged
        # settlement results and is dropped only by sync or hand-forward.
        self._device_cache = None
        self._cache_conf_drifted = False

    def _sync_pending(self) -> None:
        """Merge any deferred settlement results into the host arrays.

        Confidences are NOT merged — the host's are authoritative (the
        settle path replays the exact trajectory eagerly); rel/days/exists
        come from the device. With settle sync recipes the merge is
        DELTA-SHAPED: the pending flat state subsumes every recipe of the
        chain, so one device-side take of the UNION of touched rows feeds
        :meth:`_merge_device_rows`, and the cost scales with the rows
        touched since the last sync, not the store size. The device-to-
        host transfer is the ``fetch`` phase of the obs timeline.
        """
        if self._pending is None and self._pending_sync is None:
            return
        timeline = _active_timeline()
        recipes = self._pending_sync
        self._pending_sync = None
        if recipes is not None:
            pend = self._pending
            self._pending = None
            if pend is not None:
                state, epoch0 = pend
                union = np.unique(np.concatenate(
                    [np.asarray(t, dtype=np.int64) for t, _r, _e, _s
                     in recipes]
                    + [np.empty(0, dtype=np.int64)]
                ))
                if union.size and int(union[-1]) >= int(
                    state.reliability.shape[0]
                ):
                    raise ValueError(
                        "sync recipe touches rows beyond the pending state"
                    )
                if union.size:
                    with timeline.span("fetch"):
                        rel_u = _device_take(state.reliability, union)
                        days_u = _device_take(state.updated_days, union)
                        exists_u = _device_take(
                            state.exists, union
                        ).astype(bool)
                    self._merge_device_rows(
                        union, rel_u, None, days_u, exists_u, epoch0
                    )
                    _metrics_registry().counter("store.delta_sync_rows").inc(
                        int(union.size)
                    )
            else:
                # Orphaned recipes (the pending state was handed forward
                # and its successor never deferred): their own gathered
                # reliabilities are still exact.
                with timeline.span("fetch"):
                    for (touched, rel_touched_dev, recipe_epoch0,
                         stamp_rel) in recipes:
                        self._apply_settle_recipe(
                            touched, _to_numpy(rel_touched_dev),
                            recipe_epoch0, stamp_rel,
                        )
            # The flat device state is still EXACTLY the host's truth for
            # rel/days/exists, so it stays as the cache: a settle after a
            # flush or read chains with zero re-upload. Only its
            # confidences carry the device trajectory's ulp drift (flagged).
            if pend is not None:
                self._device_cache = pend
                self._cache_conf_drifted = True
            else:
                self._device_cache = None
            return
        state, epoch0 = self._pending
        self._pending = None
        # Merge at the PENDING state's length: pairs interned after the
        # settle have host-only (cold) rows — correct.
        used = int(state.reliability.shape[0])
        with timeline.span("fetch"):
            self._merge_device_rows(
                slice(0, used),
                _to_numpy(state.reliability),
                None,  # confidences: host-authoritative
                _to_numpy(state.updated_days),
                _to_numpy(state.exists).astype(bool),
                epoch0,
            )
        self._device_cache = None
        self._cache_conf_drifted = False

    def _append_sync_recipe(
        self, recipes, touched_rows, rel_touched, epoch0: float, stamp_rel
    ):
        """Recipe-chain maintenance: a link covering the same rows as an
        earlier one replaces it (same array object for a cached plan,
        content equality for a rebuilt one); the chain is bounded by length
        and pinned bytes, applying the oldest links early (always safe)."""
        kept = [
            r for r in (recipes or [])
            if r[0] is not touched_rows
            and not (
                len(r[0]) == len(touched_rows)
                and np.array_equal(r[0], touched_rows)
            )
        ]
        kept.append((touched_rows, rel_touched, epoch0, stamp_rel))

        def held_bytes():
            return sum(_held_nbytes(r[1]) for r in kept)

        while len(kept) > 8 or (
            len(kept) > 1 and held_bytes() > _MAX_DEFERRED_BYTES
        ):
            touched, rel_dev, r_epoch0, r_stamp = kept.pop(0)
            self._apply_settle_recipe(
                touched, _to_numpy(rel_dev), r_epoch0, r_stamp
            )
        return kept

    def _apply_settle_recipe(
        self, touched: np.ndarray, rel_new, epoch0: float, stamp_rel
    ) -> None:
        """Merge one settle's results: device reliabilities for *touched*
        rows plus closed-form stamps/existence — row for row what
        :meth:`_merge_device_rows` does over the full state."""
        if touched.size == 0:
            return
        device_dtype = rel_new.dtype
        host_rel = self._rel[touched]
        rel_changed = rel_new != host_rel.astype(device_dtype)
        self._rel[touched] = np.where(
            rel_changed, rel_new.astype(np.float64), host_rel
        )

        host_days = self._days[touched]
        host_relative = np.where(
            host_days > NEVER, host_days - epoch0, 0.0
        ).astype(device_dtype)
        stamps_changed = host_relative != stamp_rel
        stamp_abs = float(np.float64(stamp_rel) + epoch0)
        self._days[touched] = np.where(stamps_changed, stamp_abs, host_days)

        newly_existing = ~self._exists[touched]
        self._exists[touched] = True
        changed = touched[rel_changed | stamps_changed | newly_existing]
        self._dirty[changed] = True
        self._journal_dirty[changed] = True
        changed_rows = touched[stamps_changed]
        if changed_rows.size:
            iso_value = days_to_iso(stamp_abs)
            iso = self._iso
            for row in changed_rows.tolist():
                iso[row] = iso_value

    # -- record API ----------------------------------------------------------

    @_locked
    def get_reliability(
        self,
        source_id: str,
        market_id: str,
        apply_decay: bool = False,
    ) -> ReliabilityRecord:
        """Scalar read; cold-start defaults (never allocating) when absent."""
        self._sync_pending()
        row = self._pairs.get((source_id, market_id))
        if row < 0 or not self._exists[row]:
            return ReliabilityRecord(
                source_id=source_id,
                market_id=market_id,
                reliability=DEFAULT_RELIABILITY,
                confidence=DEFAULT_CONFIDENCE,
                updated_at="",
            )
        reliability = float(self._rel[row])
        updated_at = self._iso[row]
        if apply_decay and updated_at:
            elapsed = days_since_update(updated_at)
            if elapsed > 0:
                reliability = apply_reliability_decay(
                    reliability, elapsed, DECAY_HALF_LIFE_DAYS, DECAY_MINIMUM
                )
        return ReliabilityRecord(
            source_id=source_id,
            market_id=market_id,
            reliability=reliability,
            confidence=float(self._conf[row]),
            updated_at=updated_at,
        )

    @_locked
    def compute_update(
        self,
        source_id: str,
        market_id: str,
        outcome_correct: bool,
    ) -> ReliabilityRecord:
        """Dry-run update math on the undecayed stored value; zero writes."""
        current = self.get_reliability(source_id, market_id)
        new_rel, new_conf = apply_outcome(
            current.reliability, current.confidence, outcome_correct
        )
        return ReliabilityRecord(
            source_id=source_id,
            market_id=market_id,
            reliability=new_rel,
            confidence=new_conf,
            updated_at=utc_now_iso(),
        )

    @_locked
    def update_reliability(
        self,
        source_id: str,
        market_id: str,
        outcome_correct: bool,
        dry_run: bool = False,
    ) -> ReliabilityRecord:
        record = self.compute_update(source_id, market_id, outcome_correct)
        if dry_run:
            return record
        self.put_record(record)
        return record

    @_locked
    def put_record(self, record: ReliabilityRecord) -> None:
        """Upsert a fully-specified record (import/seed path)."""
        self._sync_pending()
        row = self._row_for(record.source_id, record.market_id)
        self._rel[row] = record.reliability
        self._conf[row] = record.confidence
        self._days[row] = iso_to_days(record.updated_at)
        self._exists[row] = True
        self._iso[row] = record.updated_at
        self._dirty[row] = True
        self._journal_dirty[row] = True
        self._invalidate()

    @_locked
    def list_sources(self, market_id: Optional[str] = None) -> List[ReliabilityRecord]:
        self._sync_pending()
        selected = [
            (key, row)
            for key, row in self._pairs.items()
            if self._exists[row] and (market_id is None or key[1] == market_id)
        ]
        selected.sort(key=lambda item: item[0])  # (source_id, market_id) order
        return [
            ReliabilityRecord(
                source_id=key[0],
                market_id=key[1],
                reliability=float(self._rel[row]),
                confidence=float(self._conf[row]),
                updated_at=self._iso[row],
            )
            for key, row in selected
        ]

    @_locked
    def close(self) -> None:
        """Join any in-flight background checkpoint (the writer threads
        are daemons — dropped at interpreter exit, which would silently
        lose the checkpoint; a SQLite transaction rolls back and a torn
        journal epoch is dropped at replay, but the caller asked for
        durability). A prior write failure re-raises here with the flush
        bookkeeping rolled back, like any flush entry point. The journal
        tier joins first — its epoch is the rolling durability floor."""
        if self._journal_inflight is not None:
            self._journal_inflight.result()
        if self._flush_inflight is not None:
            self._flush_inflight.result()

    def __enter__(self) -> "TensorReliabilityStore":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()

    # -- row API -------------------------------------------------------------

    @_locked
    def rows_for_pairs(
        self,
        pairs: Sequence[tuple[str, str]],
        allocate: bool = True,
    ) -> np.ndarray:
        """Intern pairs → int32 rows (−1 for unknown when not allocating).
        Newly allocated rows get sidecar slots but are NOT marked existing."""
        return self.rows_for_arrays(
            [p[0] for p in pairs], [p[1] for p in pairs], allocate=allocate
        )

    @_locked
    def rows_for_arrays(
        self,
        sources: Sequence[str],
        markets: Sequence[str],
        allocate: bool = True,
    ) -> np.ndarray:
        """Column-form twin of :meth:`rows_for_pairs`."""
        if not allocate:
            return self._pairs.lookup_arrays(sources, markets)
        try:
            return self._pairs.intern_arrays(sources, markets)
        finally:
            self._resync_sidecars()

    def _resync_sidecars(self) -> None:
        """Grow sidecars/columns to the interner's row count — also after
        an interning pass that raised mid-batch, so rows interned before
        the failure still get their sidecar slots. A grown store makes any
        cached device state the wrong SHAPE, so the cache is dropped;
        pending state is unaffected (take_device_state shape-checks it)."""
        after = len(self._pairs)
        if after > len(self._iso):
            self._iso.extend([""] * (after - len(self._iso)))
            self._ensure_capacity(after)
            self._invalidate()

    @_locked
    def rows_for_indexed(
        self,
        source_table: Sequence[str],
        source_codes: np.ndarray,
        market_table: Sequence[str],
        market_codes: np.ndarray,
    ) -> np.ndarray:
        """Interning twin of :meth:`rows_for_arrays` for tabled ids: pairs
        arrive as (unique string table, int32 codes) per half, in batch
        order. The C interner resolves each table entry once; without it
        the columns are materialised. Always allocates."""
        return self._intern_indexed(
            source_table, source_codes, market_table, market_codes,
            sharded=False,
        )

    def _intern_indexed(
        self, source_table, source_codes, market_table, market_codes,
        sharded: bool = True,
    ) -> np.ndarray:
        """One interning pass over (table, code) pair columns, in batch
        order (caller holds the lock). ``sharded=True`` lets the pass split
        its probes across worker threads when the miss set is large AND
        the table already holds a comparable key count (probing an almost
        empty table re-walks what the serial insert would). The commit
        stays serial and ordered either way, so the rows are the same.
        """
        interner = self._pairs
        count = len(source_codes)
        try:
            if not _interning.probe_supported(interner):
                return interner.intern_arrays(
                    [source_table[c] for c in np.asarray(source_codes).tolist()],
                    [market_table[c] for c in np.asarray(market_codes).tolist()],
                )
            if (
                sharded
                and count >= _interning.SHARD_MIN_PAIRS
                and len(interner) * 2 >= count
                and _interning.intern_workers() > 1
            ):
                return interner.intern_indexed_sharded(
                    source_table, source_codes, market_table, market_codes
                )
            return interner.intern_arrays_indexed(
                source_table, source_codes, market_table, market_codes
            )
        finally:
            self._resync_sidecars()

    @_locked
    def rows_for_pairs_delta(
        self,
        source_table: Sequence[str],
        source_codes: np.ndarray,
        market_table: Sequence[str],
        market_codes: np.ndarray,
        pair_offsets: np.ndarray,
        fingerprint: "bytes | None" = None,
    ) -> "tuple[np.ndarray, dict]":
        """Delta-interning twin of :meth:`rows_for_indexed`: consult the
        epoch pair table so only the batch's pair delta walks the
        interner. Returns ``(rows, stats)``.

        Three tiers, cheapest first:

        1. *fingerprint hit* — the batch's pair-set fingerprint equals the
           table's: the previous epoch's rows apply verbatim.
        2. *per-market match* — unchanged markets (same id, same ordered
           source set) copy their rows from the table
           (:func:`~.utils.interning.delta_match_rows`).
        3. *miss intern* — the remaining pairs walk the interner in batch
           order (sharded probe + serial ordered commit when the miss set
           is large and mostly re-probes known keys).

        Every matched row was witnessed by a real intern against this
        store's append-only interner, and misses intern in ascending batch
        position, so the rows (and the row assignment and SQLite bytes
        downstream) equal one full :meth:`rows_for_indexed` pass over the
        same columns. The resolve then becomes the new epoch table.

        ``stats``: ``pairs`` (batch total), ``matched_pairs`` (served from
        the table), ``interned_pairs`` (walked the interner),
        ``fingerprint_hit``.
        """
        source_codes = np.ascontiguousarray(source_codes, dtype=np.int32)
        market_codes = np.ascontiguousarray(market_codes, dtype=np.int32)
        pair_offsets = np.ascontiguousarray(pair_offsets, dtype=np.int64)
        total = len(source_codes)
        cache = self._pair_epoch
        if (
            cache is not None
            and fingerprint is not None
            and cache.fingerprint == fingerprint
        ):
            return cache.rows, {
                "pairs": total,
                "matched_pairs": total,
                "interned_pairs": 0,
                "fingerprint_hit": True,
            }
        if cache is None:
            rows = np.asarray(self._intern_indexed(
                source_table, source_codes, market_table, market_codes
            ))
            interned = total
        else:
            if market_table == cache.market_keys:
                prev_of = None
            else:
                index = cache.market_index()
                prev_of = np.fromiter(
                    (index.get(k, -1) for k in market_table),
                    np.int64, len(market_table),
                )
            if source_table == cache.src_table:
                rank_map = None
            else:
                index = cache.src_index()
                rank_map = np.fromiter(
                    (index.get(s, -1) for s in source_table),
                    np.int32, len(source_table),
                )
            rows = _interning.delta_match_rows(
                rank_map, source_codes, pair_offsets,
                cache.pair_rank, cache.pair_offsets, prev_of, cache.rows,
            )
            miss = np.flatnonzero(rows < 0)
            if miss.size:
                rows[miss] = self._intern_indexed(
                    source_table, source_codes[miss],
                    market_table, market_codes[miss],
                )
            interned = int(miss.size)
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        rows.setflags(write=False)
        self._pair_epoch = _PairEpochTable(
            fingerprint, market_table, source_table,
            source_codes, market_codes, pair_offsets, rows,
        )
        return rows, {
            "pairs": total,
            "matched_pairs": total - interned,
            "interned_pairs": interned,
            "fingerprint_hit": False,
        }

    @_locked
    def batch_get_reliability(
        self,
        pairs: Sequence[tuple[str, str]],
        apply_decay: bool = False,
        now: Optional[float] = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorised read → (reliability, confidence, exists) arrays.

        Decay (when requested) is evaluated at the single instant ``now``
        (epoch-days; defaults to the current time) for every pair, so a
        batch is self-consistent.
        """
        self._sync_pending()
        rows = self.rows_for_pairs(pairs, allocate=False)
        valid = rows >= 0
        safe = np.where(valid, rows, 0)
        exists = self._exists[safe] & valid
        rel = np.where(exists, self._rel[safe], DEFAULT_RELIABILITY)
        conf = np.where(exists, self._conf[safe], DEFAULT_CONFIDENCE)
        if apply_decay:
            stamp = np.where(exists, self._days[safe], NEVER)
            current = now_days() if now is None else now
            elapsed = np.maximum(current - stamp, 0.0)
            eligible = exists & (stamp > NEVER) & (elapsed > 0)
            factor = np.exp2(-elapsed / DECAY_HALF_LIFE_DAYS)
            decayed = np.clip(
                DECAY_MINIMUM + (rel - DECAY_MINIMUM) * factor, DECAY_MINIMUM, 1.0
            )
            rel = np.where(eligible, decayed, rel)
        return rel, conf, exists

    @_locked
    def batch_update_reliability(
        self,
        pairs: Sequence[tuple[str, str]],
        correct: Sequence[bool],
    ) -> None:
        """Vectorised post-outcome update for any number of pairs.

        Same per-element math as the scalar path (undecayed read, capped
        delta, clamped, confidence growth); every touched row is stamped
        with one shared timestamp. Duplicate pairs in one call apply once
        (last direction wins), unlike sequential scalar calls.
        """
        self._sync_pending()
        rows = self.rows_for_pairs(pairs, allocate=True)
        correct_arr = np.asarray(correct, dtype=bool)
        stamp_iso = utc_now_iso()
        stamp_days = iso_to_days(stamp_iso)

        new_rel, new_conf = apply_outcome_batch(
            self._rel[rows], self._conf[rows], correct_arr
        )
        self._rel[rows] = new_rel
        self._conf[rows] = new_conf
        self._days[rows] = stamp_days
        self._exists[rows] = True
        self._dirty[rows] = True
        self._journal_dirty[rows] = True
        for row in rows:
            self._iso[row] = stamp_iso
        self._invalidate()

    @_locked
    def host_confidences(self, rows: np.ndarray) -> np.ndarray:
        """Exact f64 host confidences for *rows* (a copy; defaults when cold).

        Deliberately does NOT sync pending state: host confidences are
        authoritative at all times (the settle replay maintains them), and
        skipping the sync is what lets chained settles stay device-resident.
        """
        return self._conf[rows].copy()

    @_locked
    def host_rows(
        self, rows: np.ndarray, sync: bool = True
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Raw exact host state for flat *rows*: (rel, conf, days, exists).

        Fancy-indexed copies, no cold-start defaulting — the session's
        gather (it applies its own masking and defaults per slot).
        ``sync=False`` skips resolving deferred settlements; only valid
        after ``pending_overlaps(rows)`` returned False (the host values
        for *rows* are then exact with the deferral left standing).
        """
        if sync:
            self._sync_pending()
        return (
            self._rel[rows],
            self._conf[rows],
            self._days[rows],
            self._exists[rows],
        )

    @_locked
    def overwrite_confidences(self, rows: np.ndarray, values: np.ndarray) -> None:
        """Replace confidences for *rows* with exact host-computed values.

        The settlement pipeline keeps stored confidences bit-identical to
        the scalar chain this way: the growth trajectory is data-independent
        (one step per settled cycle), so the host replays it exactly
        whatever rounding the device used.
        """
        self._conf[rows] = values
        self._dirty[rows] = True
        self._journal_dirty[rows] = True
        if self._pending is None:
            self._invalidate()
        # With a pending settled state the cache stays: stored confidences
        # are always restored from the host side.

    # -- device tier ---------------------------------------------------------

    @_locked
    def device_state(self, dtype=None, donate: bool = False):
        """The flat device state, exactly ``len(store)`` rows, cached until
        the next host write. Returns ``(DeviceReliabilityState, epoch0)``
        with ``updated_days`` relative to ``epoch0``. Pending settlement
        state is synced first, so the values are host-exact.

        The tensors are the store's cache; the next settle may take them
        over and update them in place. ``donate=True`` hands them to the
        caller instead: the store forgets its cache at once and never
        touches those tensors again (they stay on the store's device).
        """
        self._sync_pending()
        wanted = resolve_dtype(dtype)
        if self._device_cache is not None:
            state, cached_epoch0 = self._device_cache
            if (
                state.reliability.shape[0] != len(self._pairs)
                or state.reliability.dtype != wanted
            ):
                self._device_cache = None
                self._cache_conf_drifted = False
            else:
                if self._cache_conf_drifted:
                    # Restore the host-exact confidences (one column upload)
                    # before handing the cache to a host-exact consumer.
                    used = int(state.confidence.shape[0])
                    state = state._replace(
                        confidence=torch.tensor(
                            self._conf[:used], dtype=wanted, device=self.device
                        )
                    )
                    self._device_cache = (state, cached_epoch0)
                    self._cache_conf_drifted = False
                cached = self._device_cache
                if donate:
                    self._device_cache = None
                return cached

        exported = self._build_device_export(len(self._pairs), wanted)
        if not donate:
            self._device_cache = exported
            self._cache_conf_drifted = False
        return exported

    def _build_device_export(self, length: int, dtype: torch.dtype):
        """Host→device build of the first *length* rows (relative stamps).
        Always a copy: on the CPU a shared buffer would let host writes
        leak into a device state the settle chain still holds."""
        stamps = self._days[:length]
        epoch0 = self.epoch_origin()
        relative = np.where(stamps > NEVER, stamps - epoch0, 0.0)
        state = DeviceReliabilityState(
            reliability=torch.tensor(
                self._rel[:length], dtype=dtype, device=self.device
            ),
            confidence=torch.tensor(
                self._conf[:length], dtype=dtype, device=self.device
            ),
            updated_days=torch.tensor(relative, dtype=dtype, device=self.device),
            exists=torch.tensor(self._exists[:length], device=self.device),
        )
        return state, epoch0

    @_locked
    def epoch_origin(self, sync: bool = True) -> float:
        """The epoch-days origin for relative device stamps (min live −1).

        ``sync=False`` computes it from the host arrays as they stand.
        Safe for a caller building state over rows no pending recipe
        touches: those rows' host stamps are exact and take part in the
        min, so the origin is ≤ every stamp the caller re-expresses.
        """
        if sync:
            self._sync_pending()
        used = len(self._pairs)
        stamps = self._days[:used]
        live = stamps[stamps > NEVER]
        return float(live.min()) - 1.0 if live.size else 0.0

    @_locked
    def take_device_state(self, dtype=None):
        """Pop the device state for a consumer that WILL ``defer_absorb`` a
        successor (the settle path's private entry).

        With a pending settled state, hand it forward WITHOUT syncing: the
        successor subsumes every change in it, so chained settles stay
        device-resident. A retained post-sync cache is consumed as-is,
        drifted confidences included (stored confidences are always the
        host replay). The arrays are CAPACITY-length: rows beyond
        ``len(store)`` are cold-start pads, so a state survives new
        interning up to the capacity it was exported at.
        """
        wanted = resolve_dtype(dtype)

        if self._pending is not None:
            state, epoch0 = self._pending
            if (
                state.reliability.shape[0] >= len(self._pairs)
                and state.reliability.dtype == wanted
            ):
                self._pending = None
                self._device_cache = None
                self._cache_conf_drifted = False
                return state, epoch0
            # The store outgrew the pending arrays, or the caller wants a
            # different precision: merge and rebuild from the host.
            self._sync_pending()
        if self._device_cache is not None:
            state, epoch0 = self._device_cache
            if (
                state.reliability.shape[0] >= len(self._pairs)
                and state.reliability.dtype == wanted
            ):
                self._device_cache = None
                self._cache_conf_drifted = False
                return state, epoch0
        self._sync_pending()
        return self._build_device_export(self._rel.shape[0], wanted)

    @_locked
    def defer_absorb(
        self,
        state: DeviceReliabilityState,
        epoch0: float,
        sync_recipe=None,
    ) -> None:
        """Adopt a settled device state as the pending (unsynced) state.

        rel/days/exists merge into the host lazily, on the first host
        read/write that needs them; confidences must be kept host-exact by
        the caller via ``overwrite_confidences``. *state* also serves as
        the device cache for a chained settle.

        ``sync_recipe`` — ``(touched_rows, rel_touched_dev, stamp_rel)`` —
        lets the eventual sync fetch only the touched rows. Recipes
        accumulate across chained settles; without one, the sync falls
        back to the full-state merge (which subsumes them).
        """
        if state.reliability.shape[0] > self._rel.shape[0]:
            raise ValueError("pending state size exceeds the store capacity")
        if self._pending is not None:
            # Not chained through take_device_state: the predecessor's
            # changes are not in *state* — merge them first.
            self._sync_pending()
        if sync_recipe is None:
            self._pending_sync = None
        else:
            touched_rows, rel_touched_dev, stamp_rel = sync_recipe
            self._pending_sync = self._append_sync_recipe(
                self._pending_sync, touched_rows, rel_touched_dev, epoch0,
                stamp_rel,
            )
        self._pending = (state, epoch0)
        self._device_cache = (state, epoch0)

    @_locked
    def defer_settle_recipe(
        self, touched_rows: np.ndarray, rel_touched, epoch0: float, stamp_rel
    ) -> None:
        """Register a settle's host-merge recipe WITHOUT a flat device state.

        The resident session's deferral: its state lives as a plan-shaped
        (K, M) block, not in the store's flat layout, so only the merge
        recipe is registered. ``rel_touched`` may be any
        ``np.asarray``-able (the session's lazy band gather); it is
        resolved at sync time. Same rules as :meth:`defer_absorb`'s
        recipes: a recipe over the same touched rows replaces the older
        one, the chain is bounded by early application, and orphaned
        recipes still sync.
        """
        if self._pending is not None:
            # A flat pending state holds changes this recipe does not
            # describe: merge it first.
            self._sync_pending()
        self._pending_sync = self._append_sync_recipe(
            self._pending_sync, touched_rows, rel_touched, epoch0, stamp_rel
        )
        # The flat device cache no longer reflects these rows.
        self._device_cache = None
        self._cache_conf_drifted = False

    @_locked
    def sync(self) -> None:
        """Force any deferred settlement state into the host arrays now."""
        self._sync_pending()

    @_locked
    def pending_overlaps(self, rows) -> bool:
        """Must deferred state merge before *rows* can be read raw?

        True with a flat pending device state (it covers every row) or any
        pending settle recipe touching one of *rows*. False means the host
        arrays are exact for *rows* as they stand; callers that skip the
        sync read through ``host_rows(..., sync=False)`` and
        ``epoch_origin(sync=False)`` and touch only *rows*.
        """
        if self._pending is not None:
            return True
        if not self._pending_sync:
            return False
        rows = np.asarray(rows)
        return any(
            len(touched) and np.isin(rows, touched).any()
            for touched, _rel, _epoch0, _stamp in self._pending_sync
        )

    @_locked
    def absorb(self, state: DeviceReliabilityState, epoch0: float) -> None:
        """Write a mutated device state back into host-authoritative state.

        Rows whose timestamp changed get a fresh ISO string derived from the
        device stamp; all other sidecar strings are preserved exactly.
        """
        self._sync_pending()
        used = len(self._pairs)
        new_rel = _to_numpy(state.reliability)
        if len(new_rel) != used:
            raise ValueError(
                f"device state has {len(new_rel)} rows, store has {used}"
            )
        self._merge_device_rows(
            slice(0, used),
            new_rel,
            _to_numpy(state.confidence),
            _to_numpy(state.updated_days),
            _to_numpy(state.exists).astype(bool),
            epoch0,
        )

    @_locked
    def absorb_rows(
        self,
        rows: np.ndarray,
        reliability: np.ndarray,
        confidence: np.ndarray,
        updated_days: np.ndarray,
        exists: np.ndarray,
        epoch0: float,
    ) -> None:
        """Absorb device results for a subset of flat rows.

        Same merge semantics as :meth:`absorb`, touching only *rows* (host
        arrays or tensors; *rows* must be unique, as a settlement plan's
        rows are).
        """
        self._sync_pending()
        self._merge_device_rows(
            _to_numpy(rows),
            _to_numpy(reliability),
            _to_numpy(confidence),
            _to_numpy(updated_days),
            _to_numpy(exists).astype(bool),
            epoch0,
        )

    def _merge_device_rows(
        self, idx, new_rel, new_conf, new_days_rel, new_exists, epoch0
    ) -> None:
        """Shared device→host merge. ``idx`` selects host rows: a ZERO-BASED
        slice (whose positions are then the row numbers) or a unique row
        array. ``new_conf=None`` skips the confidence merge."""
        # The device may run float32; an untouched row's value round-trips
        # through f32 and must NOT clobber the exact f64 host value.
        # Overwrite only where the value changed *in device precision*.
        device_dtype = new_rel.dtype
        new_days = np.where(
            new_days_rel > 0, new_days_rel.astype(np.float64) + epoch0, NEVER
        )
        host_days = self._days[idx]
        host_relative = np.where(
            host_days > NEVER, host_days - epoch0, 0.0
        ).astype(device_dtype)
        stamps_changed = new_days_rel != host_relative

        host_rel = self._rel[idx]
        rel_changed = new_rel != host_rel.astype(device_dtype)
        self._rel[idx] = np.where(
            rel_changed, new_rel.astype(np.float64), host_rel
        )
        if new_conf is None:
            conf_changed = False
        else:
            host_conf = self._conf[idx]
            conf_changed = new_conf != host_conf.astype(device_dtype)
            self._conf[idx] = np.where(
                conf_changed, new_conf.astype(np.float64), host_conf
            )
        self._days[idx] = np.where(stamps_changed, new_days, host_days)
        touched = (
            rel_changed | conf_changed | stamps_changed
            | (new_exists != self._exists[idx])
        )
        self._exists[idx] = new_exists
        if isinstance(idx, slice):
            self._dirty[idx] |= touched
            self._journal_dirty[idx] |= touched
        else:
            self._dirty[idx[touched]] = True
            self._journal_dirty[idx[touched]] = True
        # A settlement stamps every touched row with the same handful of
        # day values, so format each UNIQUE stamp once.
        changed_rows = (
            np.nonzero(stamps_changed)[0] if isinstance(idx, slice)
            else idx[stamps_changed]
        )
        if changed_rows.size:
            uniq, inverse = np.unique(
                self._days[changed_rows], return_inverse=True
            )
            iso_by_stamp = [days_to_iso(float(v)) for v in uniq]
            for row, j in zip(changed_rows.tolist(), inverse.tolist()):
                self._iso[row] = iso_by_stamp[j]
        self._invalidate()

    # -- durability (SQLite checkpoint format) -------------------------------

    @classmethod
    def from_sqlite(
        cls, db_path: Union[str, Path], device=None
    ) -> "TensorReliabilityStore":
        """Load a reference-format SQLite DB into a store (checkpoint resume)."""
        store = cls(device=device)
        with SQLiteReliabilityStore(db_path) as sqlite_store:
            for record in sqlite_store.list_sources():
                store.put_record(record)
        # The freshly-loaded state IS the file's state: flushing back to the
        # same path stays incremental while the file still carries it.
        used = len(store._pairs)
        store._dirty[:used] = False
        if str(db_path) != ":memory:":
            store._last_flush_path = str(Path(db_path).resolve())
            store._last_flush_fp = interchange_fingerprint(db_path)
        return store

    @_locked
    def save_checkpoint(self, directory: Union[str, Path], step: int = 0) -> None:
        """Snapshot the whole store as checkpoint *step* of *directory*
        (``state/checkpoint.CycleCheckpointer``, one step kept): the four
        row arrays as float64 and bool tensors, the pair ids in row order
        and the ISO stamps as ``meta``. Deferred device truth (a pending
        settled state, sync recipes) is merged first, so a snapshot taken
        mid-chain holds every settled row. Returns once the step is on
        disk."""
        self._sync_pending()
        used = len(self._pairs)
        state = {
            "reliability": torch.from_numpy(self._rel[:used]),
            "confidence": torch.from_numpy(self._conf[:used]),
            "updated_days": torch.from_numpy(self._days[:used]),
            "exists": torch.from_numpy(self._exists[:used]),
        }
        meta = {
            "pairs": [list(pair) for pair in self._pairs.ids()],
            "iso": self._iso[:used],
        }
        with CycleCheckpointer(directory, max_to_keep=1) as checkpointer:
            checkpointer.save(step, state, meta=meta, force=True)

    @classmethod
    def load_checkpoint(
        cls, directory: Union[str, Path], step: Optional[int] = None,
        device=None,
    ) -> "TensorReliabilityStore":
        """A store rebuilt from :meth:`save_checkpoint` (*step*, default
        the latest), on *device* (``None``: CUDA). The pairs are interned
        in the saved row order, so a plan built again binds to the same
        rows."""
        with CycleCheckpointer(directory) as checkpointer:
            state, meta = checkpointer.restore(step)
        rel = state["reliability"].numpy().astype(np.float64)
        used = len(rel)
        store = cls(capacity=max(used, _MIN_CAPACITY), device=device)
        rows = store._pairs.intern_all(tuple(pair) for pair in meta["pairs"])
        if list(rows) != list(range(used)):
            raise ValueError(f"{directory}: the saved pairs are not {used} "
                             "distinct rows")
        store._rel[:used] = rel
        store._conf[:used] = state["confidence"].numpy()
        store._days[:used] = state["updated_days"].numpy()
        store._exists[:used] = state["exists"].numpy()
        store._iso = list(meta["iso"])
        return store

    @_locked
    def flush_to_sqlite(
        self, db_path: Union[str, Path], incremental: Optional[bool] = None
    ) -> int:
        """Checkpoint existing rows into a reference-format SQLite DB.

        Returns the number of rows written. ``incremental=None`` (auto)
        upserts ONLY rows dirtied since the last flush when *db_path* is
        the file that flush (or ``from_sqlite``) targeted and still carries
        its content; otherwise it writes every row. Forcing ``True``
        against another target raises. Rows are written in
        (source_id, market_id) order, so repeated full flushes of the same
        state produce identical DB bytes. Joins any in-flight
        :meth:`flush_to_sqlite_async` first (a failure there surfaces
        here).
        """
        target, incremental, selected, dead, used, _deferred = self._plan_flush(
            db_path, incremental
        )
        written = self._write_sqlite_rows(db_path, selected, incremental, used)
        if dead:
            with SQLiteReliabilityStore(db_path) as sqlite_store:
                id_of = self._pairs.id_of
                sqlite_store.delete_rows(id_of(r) for r in dead)
        if incremental:
            _metrics_registry().counter("interchange.delta_rows").inc(
                int(selected.size)
            )
        if target is not None:
            self._dirty[:used] = False
            self._last_flush_path = target
            self._last_flush_fp = interchange_fingerprint(target)
        return written

    def _plan_flush(self, db_path, incremental: Optional[bool],
                    resolve_pending: bool = True):
        """Shared flush-entry bookkeeping: join any in-flight background
        flush, sync pending device state, resolve the incremental mode,
        and select the rows to write / delete. Returns
        ``(target, incremental, selected, dead, used, deferred)``.

        ``resolve_pending=False`` checkpoints the host truth AS APPLIED —
        deferred settle results (a session's recipes, a flat chain's
        recipes) are left deferred instead of drained, so the flush never
        blocks on the device. Rows behind a deferred recipe are left out
        whole (``deferred``) and stay dirty: the file is a complete, valid
        snapshot of every APPLIED settlement, and a later resolving flush
        (the default) makes it current.
        """
        if self._flush_inflight is not None:
            # Serialise checkpoints: a second flush may not interleave with
            # (or outrun) an in-flight one; a prior failure surfaces here.
            self._flush_inflight.result()
        # ":memory:" is a fresh empty DB on every open — never a valid
        # incremental target.
        in_memory = str(db_path) == ":memory:"
        deferred = np.empty(0, dtype=np.int64)
        if resolve_pending:
            self._sync_pending()
        elif self._pending is not None and not self._pending_sync:
            # A recipe-less flat pending state: its changed rows are
            # unknowable, so a consistent partial snapshot is impossible —
            # resolve rather than write torn records.
            self._sync_pending()
        elif self._pending_sync:
            # Rows behind deferred recipes must be excluded ENTIRELY: the
            # settle's eager confidence replay already updated (and
            # dirtied) their host confidences, while reliability/stamp
            # wait on the recipe — writing them now would pair new
            # confidence with old reliability, a state that never
            # existed. They stay dirty so the next resolving flush covers
            # them whole.
            deferred = np.unique(np.concatenate([
                np.asarray(touched, dtype=np.int64)
                for touched, _rel, _e, _s in self._pending_sync
            ]))
        target = None if in_memory else str(Path(db_path).resolve())
        same_target = (
            target is not None
            and self._last_flush_path == target
            and Path(target).exists()
            and (
                self._last_flush_fp is None
                or interchange_fingerprint(target) == self._last_flush_fp
            )
        )
        if incremental is None:
            incremental = same_target
        elif incremental and not same_target:
            raise ValueError(
                f"incremental flush to {db_path} but the last full flush "
                f"went to {self._last_flush_path!r} (or the file's content "
                "fingerprint no longer matches that export) — an "
                "incremental write would be an incomplete checkpoint"
            )

        used = len(self._pairs)
        select = self._exists[:used].copy()
        if incremental:
            select &= self._dirty[:used]
        # Rows whose exists flag flipped False since the last flush (only
        # reachable through absorb() of a mutated device state) are DELETED
        # from the file, or an incremental flush would strand them.
        dead_mask = self._dirty[:used] & ~self._exists[:used]
        deferred = deferred[deferred < used]
        if deferred.size:
            select[deferred] = False
            dead_mask[deferred] = False
        dead = np.nonzero(dead_mask)[0].tolist() if same_target else []
        selected = np.nonzero(select)[0]
        return target, incremental, selected, dead, used, deferred

    @_locked
    def flush_to_sqlite_async(
        self,
        db_path: Union[str, Path],
        incremental: Optional[bool] = None,
        resolve_pending: bool = True,
    ) -> FlushHandle:
        """Checkpoint like :meth:`flush_to_sqlite`, writing on a background
        thread so the caller overlaps the SQLite transaction with further
        host or device work.

        The expensive write is split from a cheap synchronous SNAPSHOT: row
        selection, key/value/timestamp capture, and dirty-flag bookkeeping
        all happen before this returns (the checkpoint's content is exactly
        the store's state as of this call); only the SQLite transaction runs
        on the thread — through the C writer with the GIL RELEASED
        (``NativePairInterner.flush_snapshot``) when the C interner is in
        use and the target is a file, so the overlap is real. Mutating the
        store after this call is safe and does not affect the in-flight
        checkpoint; the file's bytes equal :meth:`flush_to_sqlite`'s.

        Returns a :class:`FlushHandle`; call ``result()`` to join and get
        the written row count (a failed write rolls the bookkeeping back —
        see FlushHandle). Any subsequent flush joins the in-flight one
        first, so checkpoints never interleave. A ``:memory:`` target also
        runs on the thread — harmless (each connection opens a fresh
        transient DB, exactly like the synchronous path) — so always join
        via ``result()``, never assume completion.

        ``resolve_pending=False`` snapshots the APPLIED host truth without
        draining deferred device results (see ``_plan_flush``): the call
        never blocks on the device, at the cost of the file lagging by
        the deferred chain until a later resolving flush.
        """
        target, incremental, selected, dead, used, deferred = self._plan_flush(
            db_path, incremental, resolve_pending
        )
        dead_ids = [self._pairs.id_of(r) for r in dead]
        writer = self._build_snapshot_writer(db_path, selected, incremental,
                                             used, dead_ids)
        if incremental:
            # Counted AFTER the background write lands (as the journal
            # tier does): a failed write must not claim its rows, and the
            # retry would otherwise count them twice.
            inner_writer = writer
            delta_count = int(selected.size)

            def writer():
                out = inner_writer()
                _metrics_registry().counter("interchange.delta_rows").inc(
                    delta_count
                )
                return out

        prev_path = self._last_flush_path
        prev_fp = self._last_flush_fp
        if target is not None:
            self._dirty[:used] = False
            if deferred.size:
                # Excluded-for-consistency rows (behind deferred recipes)
                # were not written: keep them dirty so the next resolving
                # flush covers them whole.
                self._dirty[deferred] = True
            self._last_flush_path = target
            restore = (selected, dead, prev_path, prev_fp)
        else:
            restore = None
        handle = FlushHandle(self, writer, restore)
        self._flush_inflight = handle
        return handle

    def _ordered_flush_rows(self, selected, incremental, used):
        """The sqlite3-module route's parameter columns — source ids,
        market ids, reliabilities, confidences, stamps — of the selected
        rows in (source_id, market_id) key order: one home for the
        checkpoint write order, shared by the synchronous flush and the
        async snapshot (their files must be byte-identical). Touches only
        the selected rows when few are selected."""
        rows = selected.tolist()
        if incremental and len(rows) * 8 < used:
            id_of = self._pairs.id_of
            keys = {r: id_of(r) for r in rows}
        else:
            keys = self._pairs.ids()
        rows.sort(key=keys.__getitem__)
        order = np.asarray(rows, dtype=np.int64)
        key_sel = [keys[r] for r in rows]
        iso = self._iso
        return ([k[0] for k in key_sel], [k[1] for k in key_sel],
                self._rel[order].tolist(), self._conf[order].tolist(),
                [iso[r] for r in rows])

    def _c_writer_for(self, db_path) -> bool:
        """Whether a flush to *db_path* takes the C writer: the C interner
        with ``libsqlite3`` loadable, and a file target. Checked up front,
        so a real write error (a locked file, a full disk) propagates
        instead of running the flush again through the fallback."""
        return str(db_path) != ":memory:" and getattr(
            self._pairs, "sqlite_writer_available", bool)()

    def _build_snapshot_writer(self, db_path, selected, incremental, used,
                               dead_ids):
        """A zero-argument callable that writes the snapshotted rows and
        returns ``(rows written, the target's fingerprint)``.

        C route: one ``snapshot_rows`` blob (key halves + stamps + values
        copied out of the live arena) written by ``flush_snapshot`` with
        the GIL released. Fallback: the sqlite3-module parameter rows are
        materialised NOW, in :meth:`_ordered_flush_rows` order (snapshot
        semantics), and executed on the thread — sqlite3 releases the GIL
        during its own C work, so the overlap degrades gracefully rather
        than disappearing.
        """

        def delete_dead(path):
            if dead_ids:
                with SQLiteReliabilityStore(path) as sqlite_store:
                    sqlite_store.delete_rows(iter(dead_ids))

        if self._c_writer_for(db_path):
            order = self._pairs.sorted_rows(
                np.ascontiguousarray(selected, dtype=np.int32)
            )
            blob = self._pairs.snapshot_rows(
                order, self._rel, self._conf, self._iso
            )
            flush_snapshot = self._pairs.flush_snapshot
            path = str(db_path)

            def writer():
                written = flush_snapshot(path, blob)
                delete_dead(path)
                return written, interchange_fingerprint(path)

            return writer

        columns = self._ordered_flush_rows(selected, incremental, used)

        def writer():
            with SQLiteReliabilityStore(db_path) as sqlite_store:
                sqlite_store.put_rows(zip(*columns))
            delete_dead(db_path)
            if str(db_path) == ":memory:":
                return len(columns[0]), None
            return len(columns[0]), interchange_fingerprint(db_path)

        return writer

    def _write_sqlite_rows(
        self, db_path, selected: np.ndarray, incremental: bool, used: int
    ) -> int:
        """Write *selected* rows in (source_id, market_id) order; returns
        the row count.

        With the C interner and a file target (:meth:`_c_writer_for`), the
        key-order sort and the row writes run in C against a dlopen()ed
        libsqlite3 (``sorted_rows`` / ``flush_sqlite``): the same schema,
        statements, WAL mode and single transaction as the sqlite3-module
        route below, and the same records. The C write is the
        ``interchange_export`` phase of the obs timeline (the sqlite3
        route records the same phase inside ``put_rows``).
        """
        if self._c_writer_for(db_path):
            order = self._pairs.sorted_rows(
                np.ascontiguousarray(selected, dtype=np.int32)
            )
            with _active_timeline().span("interchange_export"):
                return self._pairs.flush_sqlite(
                    str(db_path), order, self._rel, self._conf, self._iso
                )
        columns = self._ordered_flush_rows(selected, incremental, used)
        with SQLiteReliabilityStore(db_path) as sqlite_store:
            sqlite_store.put_rows(zip(*columns))
        return len(columns[0])

    # -- durability (journal) ------------------------------------------------

    def _journal_epoch_snapshot(self, journal):
        """Select + copy one journal epoch's content (caller holds the
        lock): ``(used, idx, append_args)``. The copies make the snapshot
        independent of later store mutation — what lets the async path
        hand it to a writer thread. Dirty flags are NOT cleared here."""
        self._sync_pending()
        self._resync_sidecars()
        used = len(self._pairs)
        if used < journal.rows_covered:
            raise ValueError(
                f"store holds {used} rows but the journal already covers "
                f"{journal.rows_covered} — resume a journal only with a "
                "store replayed from it"
            )
        if journal.epoch_index == 0:
            select = self._exists[:used] | self._journal_dirty[:used]
        else:
            select = self._journal_dirty[:used]
        idx = np.flatnonzero(select)
        if hasattr(self._pairs, "pair_blob"):
            # C fast path: wire-format bytes straight from the key arena.
            new_pairs = self._pairs.pair_blob(journal.rows_covered, used)
        else:
            new_pairs = [
                self._pairs.id_of(r) for r in range(journal.rows_covered, used)
            ]
        iso = self._iso
        args = (
            used,
            new_pairs,
            idx,
            self._rel[idx],  # fancy indexing: already a copy
            self._conf[idx],
            self._days[idx],
            self._exists[idx],
            [iso[i] for i in idx.tolist()],
        )
        return used, idx, args

    @_locked
    def _join_journal_inflight(self) -> None:
        """Join any in-flight background epoch (epochs serialise; a prior
        background failure surfaces HERE, never silently). The wait is the
        ``journal_async_wait`` phase — near zero when the write overlapped
        the work since the last epoch."""
        if self._journal_inflight is not None:
            with _active_timeline().span("journal_async_wait"):
                self._journal_inflight.result()

    @_locked
    def flush_to_journal(self, journal, tag: int = 0) -> int:
        """Append one durability epoch to *journal* (state/journal.py).

        Joins any in-flight background epoch first (epochs serialise),
        then resolves pending device results (the delta sync: one
        touched-rows transfer) and appends only the rows dirtied since the
        LAST journal epoch plus any newly interned pairs. Journal dirtiness
        is tracked separately from SQLite dirtiness: an epoch here never
        shrinks the next :meth:`flush_to_sqlite` and vice versa. The first
        epoch on a journal is a full snapshot, so replay is self-contained
        even when the journal is attached to a non-empty store. Returns the
        number of rows written. *tag* is the replay watermark
        (:func:`~.journal.replay_journal` returns the last complete
        epoch's tag).
        """
        self._join_journal_inflight()
        used, idx, args = self._journal_epoch_snapshot(journal)
        journal.append_epoch(*args, tag=tag)
        self._journal_dirty[:used] = False
        return int(idx.size)

    @_locked
    def flush_to_journal_async(self, journal, tag: int = 0
                               ) -> JournalFlushHandle:
        """Append an epoch like :meth:`flush_to_journal`, with the frame/
        CRC/write/fsync on a background thread so the epoch's durability
        wait overlaps the caller's next batch instead of blocking it.

        The epoch's CONTENT is pinned synchronously: any in-flight epoch
        is joined (epochs serialise, and a background failure surfaces at
        that join), pending device results drain (the delta sync), and
        the dirty rows/new pairs are snapshotted under the lock before
        this returns — mutating the store afterwards cannot leak into the
        epoch, and the file's bytes equal :meth:`flush_to_journal`'s.
        Returns a :class:`JournalFlushHandle`; ``result()`` joins and
        returns the row count (a failed write re-marks the snapshot rows
        journal-dirty and truncates the torn frame — see the handle).
        """
        self._join_journal_inflight()
        used, idx, args = self._journal_epoch_snapshot(journal)
        self._journal_dirty[:used] = False

        def writer():
            journal.append_epoch(*args, tag=tag)
            return int(idx.size)

        handle = JournalFlushHandle(self, writer, idx)
        self._journal_inflight = handle
        return handle

    def absorb_replayed_rows(
        self, rows, rel, conf, days, exists, iso_values
    ) -> None:
        """Overwrite *rows* with journal-replayed values (a recovery merge).

        The remapped twin of :meth:`_apply_journal_epoch`'s value half: the
        caller has already interned the epoch's pairs (obtaining *rows* —
        this store's assignment, not the journal's) and replays the dirty
        columns onto them verbatim. Values land exactly as written (f64
        host truth, ISO sidecars included) and the rows are marked dirty
        for both durability tiers, so the adopting store's NEXT journal
        epoch and SQLite flush carry them.

        Callers adopting into a LIVE store must hand rows disjoint from
        any pending device settlement — this method does not resolve
        deferrals.
        """
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        with self._host_lock:
            if rows.size and int(rows.max()) >= len(self._pairs):
                raise ValueError(
                    f"row {int(rows.max())} is beyond this store's "
                    f"{len(self._pairs)} interned pairs"
                )
            # Recovery invalidates the epoch pair table: the adopted rows
            # were interned outside the bind trace, so the next delta
            # resolve must re-witness against the post-adoption interner.
            self._pair_epoch = None
            self._ensure_capacity(max(len(self._pairs), 1))
            self._resync_sidecars()
            self._rel[rows] = rel
            self._conf[rows] = conf
            self._days[rows] = days
            self._exists[rows] = exists
            iso = self._iso
            for row, value in zip(rows.tolist(), iso_values):
                iso[row] = value
            self._dirty[rows] = True
            self._journal_dirty[rows] = True
            self._invalidate()

    def _apply_journal_epoch(
        self, used_after, pairs, idx, rel, conf, days, exists, iso_values
    ) -> None:
        """Replay hook for :func:`~.journal.replay_journal`: intern the
        epoch's new pairs in row order — which reproduces the original row
        assignment — then overwrite the epoch's dirty rows. The new pairs
        go through the interner's batch pass (one C call with the C
        interner); rows must extend the store contiguously, as one
        ``intern`` a pair would give them."""
        with self._host_lock:
            before = len(self._pairs)
            try:
                rows = self._pairs.intern_arrays(
                    [p[0] for p in pairs], [p[1] for p in pairs]
                )
            finally:
                self._resync_sidecars()
            if not np.array_equal(rows, np.arange(before, used_after)):
                raise ValueError(
                    "journal pairs do not extend the store contiguously "
                    f"(rows {before}..{used_after} expected)"
                )
            # Same recovery rule as absorb_replayed_rows: replayed epochs
            # intern outside the bind trace — drop the pair table.
            self._pair_epoch = None
            self._ensure_capacity(max(used_after, 1))
            self._rel[idx] = rel
            self._conf[idx] = conf
            self._days[idx] = days
            self._exists[idx] = exists
            iso = self._iso
            for row, value in zip(idx.tolist(), iso_values):
                iso[row] = value
            self._dirty[idx] = True
            self._journal_dirty[idx] = True
            self._invalidate()
