"""Durable SQLite reliability store — the compatibility/checkpoint backend.

API and observable semantics match the reference store
(reference: src/bayesian_engine/reliability.py:59-285):

  * per-(source_id, market_id) rows, WAL journal, autocommit
  * cold-start reads return defaults WITHOUT persisting a row
  * ``apply_decay=True`` decays reliability at read time only
  * ``compute_update`` / ``update_reliability(dry_run=True)`` never write
  * UPSERT on conflict; ``list_sources`` returns sorted records

In the port this store is the *durable checkpoint format*: the
device-resident :class:`~.tensor_store.TensorReliabilityStore` imports from
and flushes to this exact schema, so on-disk state stays byte-compatible
with the JAX package's checkpoints and the reference's DB files. A copy of
``bayesian_consensus_engine_tpu/state/sqlite_store.py``, recording into the
port's own ``obs`` (the ``interchange_export`` span and the
``sqlite.rows_written`` counter).
"""

from __future__ import annotations

import os
import sqlite3
from pathlib import Path
from typing import Iterable, List, Optional, Protocol, Union, runtime_checkable

from bayesian_consensus_engine_tpu_torch.obs.metrics import metrics_registry
from bayesian_consensus_engine_tpu_torch.obs.timeline import active_timeline
from bayesian_consensus_engine_tpu_torch.utils.config import (
    DECAY_HALF_LIFE_DAYS,
    DECAY_MINIMUM,
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
)
from bayesian_consensus_engine_tpu_torch.state.decay import (
    apply_reliability_decay,
    days_since_update,
)
from bayesian_consensus_engine_tpu_torch.state.records import ReliabilityRecord
from bayesian_consensus_engine_tpu_torch.state.update_math import apply_outcome
from bayesian_consensus_engine_tpu_torch.utils.timeconv import utc_now_iso

_SCHEMA_SQL = """
CREATE TABLE IF NOT EXISTS sources (
    source_id   TEXT    NOT NULL,
    market_id   TEXT    NOT NULL,
    reliability REAL    NOT NULL DEFAULT 0.5,
    confidence  REAL    NOT NULL DEFAULT 0.5,
    updated_at  TEXT    NOT NULL,
    PRIMARY KEY (source_id, market_id)
);
"""

_UPSERT_SQL = """
INSERT INTO sources (source_id, market_id, reliability, confidence, updated_at)
VALUES (?, ?, ?, ?, ?)
ON CONFLICT(source_id, market_id)
DO UPDATE SET reliability = excluded.reliability,
              confidence  = excluded.confidence,
              updated_at  = excluded.updated_at
"""

# Empty-table bulk-load twin of _UPSERT_SQL (see put_rows).
_FRESH_INSERT_SQL = """
INSERT OR REPLACE INTO sources
    (source_id, market_id, reliability, confidence, updated_at)
VALUES (?, ?, ?, ?, ?)
"""


def interchange_fingerprint(db_path: Union[str, Path]):
    """Cheap content identity of an interchange file, or ``None``.

    The incremental-flush guard (``TensorReliabilityStore._plan_flush``):
    an O(1) probe — file size, nanosecond mtime, and the 100-byte SQLite
    header (which carries the file change counter, schema cookie, and
    WAL checkpoint sequence) — captured right after each export and
    compared right before the next. A mismatch means someone else wrote
    (or rotated) the file since our export, so upserting only the dirty
    delta would silently produce a checkpoint that is neither our state
    nor theirs; the flush falls back to a full write instead. A false
    MISMATCH merely costs one full rewrite; a false match would need an
    external writer that preserves size, mtime_ns, and every header byte
    — not something SQLite does. The ``-wal`` sidecar's (size, mtime_ns)
    rides along: a foreign writer whose commit still sits un-checkpointed
    in the WAL leaves the main file untouched, and the sidecar is the
    only place that write is visible (our own exports close their last
    connection, which checkpoints and DELETES the sidecar — after a
    clean export the component is None). ``None`` (unreadable/absent
    file) never matches anything.
    """
    path = str(db_path)
    try:
        stat = os.stat(path)
        with open(path, "rb") as fh:
            header = fh.read(100)
    except OSError:
        return None
    try:
        wal = os.stat(path + "-wal")
        wal_mark = (wal.st_size, wal.st_mtime_ns)
    except OSError:
        wal_mark = None
    return (stat.st_size, stat.st_mtime_ns, header, wal_mark)


@runtime_checkable
class ReliabilityStore(Protocol):
    """Interface every reliability backend implements.

    Every backend implements it: SQLite (durable) and the device-tensor
    store.
    """

    def get_reliability(
        self, source_id: str, market_id: str, apply_decay: bool = False
    ) -> ReliabilityRecord: ...

    def update_reliability(
        self,
        source_id: str,
        market_id: str,
        outcome_correct: bool,
        dry_run: bool = False,
    ) -> ReliabilityRecord: ...

    def list_sources(self, market_id: Optional[str] = None) -> List[ReliabilityRecord]: ...

    def close(self) -> None: ...


class SQLiteReliabilityStore:
    """SQLite-backed per-(source, market) reliability scores.

    Use ``":memory:"`` (the default) for an ephemeral store in tests.
    """

    def __init__(self, db_path: Union[str, Path] = ":memory:") -> None:
        self._db_path = str(db_path)
        # Autocommit (isolation_level=None) + WAL: single-writer workload with
        # cheap concurrent reads, matching the reference's durability contract.
        self._conn = sqlite3.connect(self._db_path, isolation_level=None)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._conn.row_factory = sqlite3.Row
        self._conn.executescript(_SCHEMA_SQL)

    # -- reads ---------------------------------------------------------------

    def get_reliability(
        self,
        source_id: str,
        market_id: str,
        apply_decay: bool = False,
    ) -> ReliabilityRecord:
        """Fetch one record; cold-start defaults if absent (never persisted).

        With ``apply_decay=True`` the returned reliability is decayed by time
        since ``updated_at``; the stored value is untouched.
        """
        row = self._conn.execute(
            "SELECT reliability, confidence, updated_at FROM sources"
            " WHERE source_id = ? AND market_id = ?",
            (source_id, market_id),
        ).fetchone()

        if row is None:
            return ReliabilityRecord(
                source_id=source_id,
                market_id=market_id,
                reliability=DEFAULT_RELIABILITY,
                confidence=DEFAULT_CONFIDENCE,
                updated_at="",
            )

        reliability = row["reliability"]
        updated_at = row["updated_at"]
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
            confidence=row["confidence"],
            updated_at=updated_at,
        )

    def list_sources(self, market_id: Optional[str] = None) -> List[ReliabilityRecord]:
        """All stored records, sorted; optionally filtered to one market."""
        if market_id is None:
            rows = self._conn.execute(
                "SELECT source_id, market_id, reliability, confidence, updated_at"
                " FROM sources ORDER BY source_id, market_id"
            ).fetchall()
        else:
            rows = self._conn.execute(
                "SELECT source_id, market_id, reliability, confidence, updated_at"
                " FROM sources WHERE market_id = ? ORDER BY source_id",
                (market_id,),
            ).fetchall()
        return [
            ReliabilityRecord(
                source_id=r["source_id"],
                market_id=r["market_id"],
                reliability=r["reliability"],
                confidence=r["confidence"],
                updated_at=r["updated_at"],
            )
            for r in rows
        ]

    # -- writes --------------------------------------------------------------

    def compute_update(
        self,
        source_id: str,
        market_id: str,
        outcome_correct: bool,
    ) -> ReliabilityRecord:
        """Dry-run the post-outcome update: new values, zero writes.

        Reads the UNDECAYED stored value (decay is read-time only —
        reference: reliability.py:161, quirk preserved).
        """
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

    def update_reliability(
        self,
        source_id: str,
        market_id: str,
        outcome_correct: bool,
        dry_run: bool = False,
    ) -> ReliabilityRecord:
        """Apply (and, unless ``dry_run``, persist) a post-outcome update."""
        record = self.compute_update(source_id, market_id, outcome_correct)
        if dry_run:
            return record
        self._conn.execute(
            _UPSERT_SQL,
            (
                record.source_id,
                record.market_id,
                record.reliability,
                record.confidence,
                record.updated_at,
            ),
        )
        return record

    def put_record(self, record: ReliabilityRecord) -> None:
        """Upsert a fully-specified record (bulk import/seed path).

        Extension over the reference surface: used by the tensor store's
        checkpoint flush and by namespaced seeding.
        """
        self._conn.execute(
            _UPSERT_SQL,
            (
                record.source_id,
                record.market_id,
                record.reliability,
                record.confidence,
                record.updated_at,
            ),
        )

    def put_records(self, records: List[ReliabilityRecord]) -> None:
        """Bulk upsert inside one transaction (checkpoint-flush fast path)."""
        self.put_rows(
            (r.source_id, r.market_id, r.reliability, r.confidence, r.updated_at)
            for r in records
        )

    def put_rows(self, rows: Iterable[tuple]) -> None:
        """Bulk upsert raw ``(source_id, market_id, reliability, confidence,
        updated_at)`` tuples inside one transaction.

        Autocommit mode would otherwise commit per row; one explicit
        transaction makes a 400k-row flush ~10× faster with identical
        resulting bytes. The columnar flush (tensor_store.flush_to_sqlite)
        feeds this directly, skipping record-object construction.

        When the table is empty (a full flush into a fresh checkpoint file —
        the common bulk case) rows skip the UPSERT machinery for an
        ``INSERT OR REPLACE``: measurably faster at millions of rows, and
        identical last-wins semantics if one batch carries duplicate keys
        (nothing pre-existing can conflict — the table is empty).
        """
        empty = self._conn.execute(
            "SELECT NOT EXISTS (SELECT 1 FROM sources)"
        ).fetchone()[0]
        sql = _FRESH_INSERT_SQL if empty else _UPSERT_SQL
        # Bulk-load page cache (the default ~2 MB thrashes on multi-million-
        # row B-trees), restored afterwards so a long-lived store connection
        # does not keep a 256 MB cache ceiling from one bulk call. The
        # transaction is the "interchange_export" phase of the obs timeline
        # (the SQLite floor the journal tier exists to duck) — a no-op span
        # unless this thread is recording.
        prior_cache = self._conn.execute("PRAGMA cache_size").fetchone()[0]
        self._conn.execute("PRAGMA cache_size=-262144")
        try:
            with active_timeline().span("interchange_export"):
                self._conn.execute("BEGIN")
                try:
                    cursor = self._conn.executemany(sql, rows)
                except BaseException:
                    self._conn.execute("ROLLBACK")
                    raise
                self._conn.execute("COMMIT")
            if cursor.rowcount > 0:
                metrics_registry().counter("sqlite.rows_written").inc(
                    cursor.rowcount
                )
        finally:
            self._conn.execute(f"PRAGMA cache_size={int(prior_cache)}")

    def delete_rows(self, pairs: Iterable[tuple]) -> None:
        """Delete ``(source_id, market_id)`` rows in one transaction.

        The checkpoint-maintenance twin of :meth:`put_rows`: incremental
        flushes use it to drop rows whose device state transitioned to
        non-existing, so the file never resurrects rows the store has
        retired. (The reference never deletes — its store has no
        exists-flip — so this is additive surface, not a parity one.)
        """
        self._conn.execute("BEGIN")
        try:
            self._conn.executemany(
                "DELETE FROM sources WHERE source_id = ? AND market_id = ?",
                pairs,
            )
        except BaseException:
            self._conn.execute("ROLLBACK")
            raise
        self._conn.execute("COMMIT")

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "SQLiteReliabilityStore":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()
