"""The port's background SQLite checkpoint ≡ its synchronous one ≡ the JAX
package's, and the async flush's bookkeeping, on the CPU.

``flush_to_sqlite_async`` snapshots the rows at the call and writes them on
a daemon thread (the C writer with the GIL released on the C route). The
file's ``SELECT *`` digest and ``iterdump()`` equal the synchronous
flush's and the JAX package's (its Python twins) on both of the port's
interner routes; a failed write rolls its bookkeeping back and surfaces at
the next flush or at ``close()``; ``resolve_pending=False`` leaves a
session's deferred rows out whole. Last, the port's ``obs`` registry
dump, timeline phases and journal span chain equal the JAX package's for
the same journal and flush calls.
"""

import contextlib
import hashlib
import sqlite3
import threading
import time

import numpy as np
import pytest

from bayesian_consensus_engine_tpu import obs as jobs
from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.state import journal as jjournal
from bayesian_consensus_engine_tpu.state.records import (
    ReliabilityRecord as JaxRecord,
)
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import obs
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.state.journal import JournalWriter
from bayesian_consensus_engine_tpu_torch.state.records import ReliabilityRecord
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)

ROUTES = ["native", "python"]


@pytest.fixture(autouse=True)
def native_route(monkeypatch):
    """Each test starts on the C route whatever the environment says."""
    monkeypatch.delenv("BCE_NO_NATIVE", raising=False)


def seeded_store(n=25, make=lambda: TensorReliabilityStore(device="cpu"),
                 record=ReliabilityRecord):
    store = make()
    for i in range(n):
        store.put_record(record(
            source_id=f"src-{i}", market_id=f"mkt-{i % 4}",
            reliability=0.5 + 0.01 * (i % 9),
            confidence=0.25 + 0.01 * (i % 7),
            updated_at=f"2026-07-{10 + i % 19:02d}T12:00:00+00:00",
        ))
    return store


def bump(store, source_id, market_id, rel=0.77, record=ReliabilityRecord):
    """A deterministic dirty-making write."""
    store.put_record(record(
        source_id=source_id, market_id=market_id, reliability=rel,
        confidence=0.4, updated_at="2026-07-29T09:00:00+00:00",
    ))


def db_records(path):
    with contextlib.closing(sqlite3.connect(path)) as conn:
        return conn.execute(
            "SELECT source_id, market_id, reliability, confidence, updated_at"
            " FROM sources ORDER BY source_id, market_id"
        ).fetchall()


def table_digest(path):
    with contextlib.closing(sqlite3.connect(path)) as conn:
        rows = conn.execute(
            "SELECT * FROM sources ORDER BY source_id, market_id").fetchall()
    return hashlib.sha256(repr(rows).encode()).hexdigest()


def dump(path):
    """``iterdump()`` with the CREATE statement's whitespace normalised
    (the C writer's schema text is one line, the sqlite3 module's
    several)."""
    with contextlib.closing(sqlite3.connect(path)) as conn:
        return [" ".join(line.split()) if line.startswith("CREATE") else line
                for line in conn.iterdump()]


def expected_file(tmp_path, *bumps):
    """A synchronous flush of the seeded store with *bumps* applied."""
    twin = seeded_store()
    for args in bumps:
        bump(twin, *args)
    path = tmp_path / "expect.db"
    twin.flush_to_sqlite(path)
    return path


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The JAX package's sync and async files of the seeded store (its
    Python twins)."""
    base = tmp_path_factory.mktemp("jax")
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("BCE_NO_NATIVE", "1")
        seeded_store(make=JaxStore, record=JaxRecord).flush_to_sqlite(
            base / "sync.db")
        seeded_store(make=JaxStore, record=JaxRecord).flush_to_sqlite_async(
            base / "async.db").result()
    return base / "sync.db", base / "async.db"


@pytest.mark.parametrize("route", ROUTES)
def test_async_file_equals_sync_and_jax(tmp_path, monkeypatch, jax_files,
                                        route):
    if route == "python":
        monkeypatch.setenv("BCE_NO_NATIVE", "1")
    seeded_store().flush_to_sqlite(tmp_path / "sync.db")
    store = seeded_store()
    handle = store.flush_to_sqlite_async(tmp_path / "async.db")
    assert handle.result() == 25 and handle.done()
    assert store._flush_inflight is None
    digests = {table_digest(p) for p in (tmp_path / "sync.db",
                                         tmp_path / "async.db", *jax_files)}
    assert len(digests) == 1
    assert dump(tmp_path / "async.db") == dump(tmp_path / "sync.db") == dump(
        jax_files[0]) == dump(jax_files[1])


@pytest.mark.parametrize("route", ROUTES)
def test_memory_target(monkeypatch, route):
    if route == "python":
        monkeypatch.setenv("BCE_NO_NATIVE", "1")
    store = seeded_store()
    assert store.flush_to_sqlite_async(":memory:").result() == 25
    assert store._last_flush_path is None


def test_incremental_async_writes_only_dirty(tmp_path):
    db = tmp_path / "ckpt.db"
    store = seeded_store()
    store.flush_to_sqlite_async(db).result()
    bump(store, "src-3", "mkt-3")
    bump(store, "src-7", "mkt-3", rel=0.11)
    assert store.flush_to_sqlite_async(db).result() == 2
    expect = expected_file(tmp_path, ("src-3", "mkt-3"),
                           ("src-7", "mkt-3", 0.11))
    assert db_records(db) == db_records(expect)


def _broken(message):
    def builder(*args, **kwargs):
        def writer():
            raise RuntimeError(message)

        return writer

    return builder


def test_failed_write_rolls_back_bookkeeping(tmp_path, monkeypatch):
    db = tmp_path / "ckpt.db"
    store = seeded_store()
    store.flush_to_sqlite(db)
    bump(store, "src-5", "mkt-1")
    monkeypatch.setattr(store, "_build_snapshot_writer", _broken("disk on fire"))
    handle = store.flush_to_sqlite_async(db)
    with pytest.raises(RuntimeError, match="disk on fire"):
        handle.result()
    with pytest.raises(RuntimeError, match="disk on fire"):
        handle.result()  # a second join re-raises, rolls back nothing more
    monkeypatch.undo()
    # The failed flush re-marked its row dirty and restored the target:
    # the retry still covers the update incrementally.
    assert store.flush_to_sqlite(db) == 1
    assert db_records(db) == db_records(
        expected_file(tmp_path, ("src-5", "mkt-1")))


def test_prior_failure_surfaces_on_next_flush(tmp_path, monkeypatch):
    db = tmp_path / "ckpt.db"
    store = seeded_store()
    monkeypatch.setattr(store, "_build_snapshot_writer",
                        _broken("transient outage"))
    store.flush_to_sqlite_async(db)  # handle dropped
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="transient outage"):
        store.flush_to_sqlite(db)
    assert store.flush_to_sqlite(db) == 25  # the full checkpoint
    assert db_records(db) == db_records(expected_file(tmp_path))


def test_flushes_serialise_never_interleave(tmp_path):
    db = tmp_path / "ckpt.db"
    store = seeded_store()
    first = store.flush_to_sqlite_async(db)
    bump(store, "src-1", "mkt-1")
    second = store.flush_to_sqlite_async(db)  # joins the first
    assert first.done()
    assert second.result() == 1
    assert db_records(db) == db_records(
        expected_file(tmp_path, ("src-1", "mkt-1")))


def _gated(store, monkeypatch):
    gate = threading.Event()
    real_builder = store._build_snapshot_writer

    def gated_builder(*args, **kwargs):
        writer = real_builder(*args, **kwargs)

        def slow_writer():
            gate.wait(timeout=30)
            return writer()

        return slow_writer

    monkeypatch.setattr(store, "_build_snapshot_writer", gated_builder)
    return gate


@pytest.mark.parametrize("route", ROUTES)
def test_mutations_after_snapshot_do_not_leak(tmp_path, monkeypatch, route):
    if route == "python":
        monkeypatch.setenv("BCE_NO_NATIVE", "1")
    db = tmp_path / "ckpt.db"
    store = seeded_store()
    gate = _gated(store, monkeypatch)
    handle = store.flush_to_sqlite_async(db)
    bump(store, "src-2", "mkt-2")  # after the snapshot, while gated
    bump(store, "src-new", "mkt-new")  # grows the interner too
    gate.set()
    assert handle.result() == 25
    assert db_records(db) == db_records(expected_file(tmp_path))
    assert store.flush_to_sqlite(db) == 2  # still pending for the next one


def test_close_joins_inflight_checkpoint(tmp_path, monkeypatch):
    store = seeded_store()
    gate = _gated(store, monkeypatch)
    handle = store.flush_to_sqlite_async(tmp_path / "ckpt.db")
    closer = threading.Thread(target=store.close)
    closer.start()
    closer.join(timeout=0.3)
    assert closer.is_alive(), "close() returned before the write landed"
    gate.set()
    closer.join(timeout=30)
    assert not closer.is_alive() and handle.done()
    assert len(db_records(tmp_path / "ckpt.db")) == 25


def test_close_surfaces_background_failure(tmp_path, monkeypatch):
    store = seeded_store()
    monkeypatch.setattr(store, "_build_snapshot_writer",
                        _broken("checkpoint disk gone"))
    store.flush_to_sqlite_async(tmp_path / "ckpt.db")
    with pytest.raises(RuntimeError, match="checkpoint disk gone"):
        store.close()
    store.close()  # idempotent after the failure surfaced


def test_close_joins_journal_first(tmp_path, monkeypatch):
    store = seeded_store()
    order = []
    gate = _gated(store, monkeypatch)
    journal = JournalWriter(tmp_path / "c.jrnl")
    real_append = journal.append_epoch

    def slow_append(*args, **kwargs):
        time.sleep(0.05)
        real_append(*args, **kwargs)
        order.append("journal")

    journal.append_epoch = slow_append
    flush = store.flush_to_sqlite_async(tmp_path / "c.db")
    store.flush_to_journal_async(journal, tag=0)
    gate.set()
    store.close()
    order.append("sqlite" if flush.done() else "sqlite-pending")
    assert order == ["journal", "sqlite"]
    journal.close()


def test_writers_under_concurrent_mutation(tmp_path):
    """More mutating threads than cores, a short switch interval, and async
    epochs and flushes issued while they write: no write is lost to either
    tier (each background writer works on its snapshot, and the next
    flush re-covers whatever landed after it)."""
    import os
    import sys

    from bayesian_consensus_engine_tpu_torch.state.journal import (
        replay_journal,
    )

    store = seeded_store()
    workers = (os.cpu_count() or 4) + 2
    errors = []

    def mutate(worker):
        try:
            for i in range(60):
                bump(store, f"w{worker}", f"m{i % 20}", rel=0.001 * (i + 1))
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    previous = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with JournalWriter(tmp_path / "s.jrnl", fsync=False) as journal:
            threads = [threading.Thread(target=mutate, args=(w,))
                       for w in range(workers)]
            for thread in threads:
                thread.start()
            for tag in range(6):
                store.flush_to_journal_async(journal, tag=tag)
                store.flush_to_sqlite_async(tmp_path / "s.db")
            for thread in threads:
                thread.join(timeout=60)
                assert not thread.is_alive()
            store.flush_to_journal(journal, tag=6)
            store.flush_to_sqlite(tmp_path / "s.db")
    finally:
        sys.setswitchinterval(previous)
    assert not errors
    assert len(store) == 25 + workers * 20
    replayed, tag = replay_journal(tmp_path / "s.jrnl", device="cpu")
    assert tag == 6 and replayed.list_sources() == store.list_sources()
    store.flush_to_sqlite(tmp_path / "full.db", incremental=False)
    assert db_records(tmp_path / "s.db") == db_records(tmp_path / "full.db")


def test_lazy_flush_leaves_a_sessions_deferred_rows_out(tmp_path):
    """``resolve_pending=False`` writes only applied truth: the rows behind
    a resident session's pending recipe are left out whole (their replayed
    confidences must not pair with stale reliabilities) and stay dirty for
    the next resolving flush."""
    store = seeded_store()
    payloads = [("mkt-0", [{"sourceId": "src-0", "probability": 0.9},
                           {"sourceId": "src-4", "probability": 0.2}]),
                ("mkt-9", [{"sourceId": "src-new", "probability": 0.7}])]
    plan = tpipe.build_settlement_plan(store, payloads)
    db = tmp_path / "lazy.db"
    with tpipe.ShardedSettlementSession(store, plan) as session:
        session.settle([True, False], steps=2, now=20_000.25)
        assert store._pending_sync
        touched = np.unique(np.concatenate(
            [np.asarray(t) for t, _r, _e, _s in store._pending_sync]))
        written = store.flush_to_sqlite_async(
            db, resolve_pending=False).result()
        used = len(store)
        assert written == used - len(touched) == 23
        assert store._pending_sync  # still deferred
        assert store._dirty[touched].all()
        deferred_ids = {store._pairs.id_of(int(r)) for r in touched}
        assert not {r[:2] for r in db_records(db)} & deferred_ids
    store.flush_to_sqlite(db)  # the resolving flush completes the file
    assert len(db_records(db)) == used
    assert not store._pending_sync


def test_c_writer_overlaps_the_host(tmp_path, monkeypatch):
    """On the C route the background write runs with the GIL released: the
    caller's Python loop keeps running for most of the C write's time, and
    the file's digest equals the synchronous flush's."""
    store = TensorReliabilityStore(device="cpu")
    if not store._pairs.sqlite_writer_available():
        pytest.skip("libsqlite3 cannot be loaded by the C writer here")
    count = 100_000
    rows = store.rows_for_arrays([f"src-{i % 997}" for i in range(count)],
                                 [f"mkt-{i}" for i in range(count)])
    store._rel[rows] = np.linspace(0.1, 0.9, count)
    store._conf[rows] = 0.5
    store._exists[rows] = True
    for row in rows.tolist():
        store._iso[row] = "2026-07-29T09:00:00+00:00"
    window = {}
    real = type(store._pairs).flush_snapshot

    def timed_snapshot(path, blob):
        window["start"] = time.perf_counter()
        try:
            return real(path, blob)
        finally:
            window["end"] = time.perf_counter()

    monkeypatch.setattr(type(store._pairs), "flush_snapshot",
                        staticmethod(timed_snapshot))
    handle = store.flush_to_sqlite_async(tmp_path / "async.db")
    ticks = []
    while not handle.done():
        ticks.append(time.perf_counter())
    assert handle.result() == count
    inside = [window["start"]] + [
        t for t in ticks if window["start"] <= t <= window["end"]
    ] + [window["end"]]
    write_seconds = window["end"] - window["start"]
    # A held GIL would stop the loop for the whole C write; released, the
    # loop's longest pause is a small part of it.
    assert len(inside) > 2
    assert max(np.diff(inside)) < 0.25 * write_seconds
    store.flush_to_sqlite(tmp_path / "sync.db")
    assert table_digest(tmp_path / "async.db") == table_digest(
        tmp_path / "sync.db")


def _obs_run(tmp_path, name, make, record, writer_cls, pipe, obs_module):
    """Journal and flush calls under a registry and a recording timeline:
    a snapshot epoch (its drain is the deferred settle's fetch), an async
    epoch joined by the next one, a full and an incremental SQLite flush,
    an async one, and an async epoch joined by ``close``.
    The settle runs before the registry is installed (the port's pipeline
    records no spans or counters of its own yet)."""
    store = seeded_store(make=make, record=record)
    payloads = [("mkt-1", [{"sourceId": "src-1", "probability": 0.8},
                           {"sourceId": "src-x", "probability": 0.3}])]
    plan = pipe.build_settlement_plan(store, payloads)
    pipe.settle(store, plan, [True], steps=2, now=20_000.25)
    registry = obs_module.MetricsRegistry()
    timeline = obs_module.PhaseTimeline()
    tracer = obs_module.Tracer(log_capacity=None)
    previous = obs_module.set_metrics_registry(registry)
    previous_tracer = obs_module.set_tracer(tracer)
    try:
        with obs_module.recording(timeline), \
                writer_cls(tmp_path / f"{name}.jrnl") as journal:
            store.flush_to_journal(journal, tag=0)
            bump(store, "src-2", "mkt-2", record=record)
            store.flush_to_journal_async(journal, tag=1)
            db = tmp_path / f"{name}.db"
            store.flush_to_sqlite(db)
            bump(store, "src-3", "mkt-3", record=record)
            store.flush_to_sqlite(db)
            bump(store, "src-4", "mkt-0", record=record)
            store.flush_to_sqlite_async(db).result()
            store.flush_to_journal_async(journal, tag=2)  # joins tag 1
            store.close()
    finally:
        obs_module.set_metrics_registry(previous)
        obs_module.set_tracer(previous_tracer)
    # The journal's span chain, with the two wall fields masked.
    events = [{k: v for k, v in e.items() if k not in ("wall_ts", "dur_s")}
              for e in tracer.events()]
    return registry.to_json(), timeline.counts(), events


def test_obs_dump_and_phases_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("BCE_NO_NATIVE", "1")  # one SQLite route for both
    monkeypatch.setattr(time, "time", lambda: 9_876.5)
    port = _obs_run(tmp_path, "port", lambda: TensorReliabilityStore(
        device="cpu"), ReliabilityRecord, JournalWriter, tpipe, obs)
    jax = _obs_run(tmp_path, "jax", JaxStore, JaxRecord,
                   jjournal.JournalWriter, jpipe, jobs)
    assert port == jax
    dumped, phases, events = port
    assert [(e["key"], e["args"]["epoch"]) for e in events] == [
        (0, 0), (1, 1), (2, 2)]
    assert set(phases) == {"fetch", "interchange_export", "journal_fsync",
                           "journal_async_wait"}
    for name in ("journal.epochs", "journal.bytes", "journal.delta_rows",
                 "interchange.delta_rows", "sqlite.rows_written",
                 "store.delta_sync_rows"):
        assert f'"{name}"' in dumped
