"""The port's durability journal ≡ the JAX package's, byte for byte, and
the journal's own contracts, on the CPU.

Cross-package: the same operations on a port store (``device="cpu"``) and
a JAX store write equal journal files, CRCs included, with the clock
pinned (``time.time`` patched once; both modules read it there) and every
ISO stamp fixed (``put_record`` with literal stamps, ``settle(now=...)``).
That holds on both of the port's interner routes (the C interner and the
dict one under ``BCE_NO_NATIVE=1``; the JAX side always runs its Python
twins) and through each interning entry point (``rows_for_pairs``,
``rows_for_arrays``, ``rows_for_indexed``, ``rows_for_pairs_delta``):
the epochs carry row numbers, so equal files mean equal row assignment.
Replay in either package rebuilds the same records, stamps and rows, and
the admitted-trace sidecar's files are equal too.

Port-only: the JAX package's journal cases (round trip, torn tail,
directory fsync, the semantic resume scan, writer validation, compaction,
async epochs), delta-against-full sync and interning, and the recovery
paths dropping the epoch pair table.
"""

import os
import random
import stat
import struct
import threading
import time
import zlib
from dataclasses import astuple

import numpy as np
import pytest

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
from bayesian_consensus_engine_tpu_torch.state import journal as tjournal
from bayesian_consensus_engine_tpu_torch.state import (
    JournalWriter,
    compact_journal,
    replay_journal,
)
from bayesian_consensus_engine_tpu_torch.state.records import ReliabilityRecord
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)

CLOCK = 9_876.5
NOW = 20_000.25  # epoch-days
ROUTES = ["native", "python"]


@pytest.fixture(autouse=True)
def native_route(monkeypatch):
    """Each test starts on the C route whatever the environment says."""
    monkeypatch.delenv("BCE_NO_NATIVE", raising=False)


def use_route(monkeypatch, route):
    if route == "python":
        monkeypatch.setenv("BCE_NO_NATIVE", "1")


def cpu_store():
    return TensorReliabilityStore(device="cpu")


def replay(path):
    return replay_journal(path, device="cpu")


def records(seed, n):
    rng = random.Random(seed)
    return [
        dict(source_id=f"src-{i % 7}", market_id=f"mkt-{i}",
             reliability=round(rng.random(), 6),
             confidence=round(rng.random(), 6),
             updated_at=f"2026-07-{10 + (i % 19):02d}T12:00:00+00:00")
        for i in range(n)
    ]


def seeded_store(n=40, seed=3, make=cpu_store, record=ReliabilityRecord):
    store = make()
    for fields in records(seed, n):
        store.put_record(record(**fields))
    return store


def put(store, source_id, market_id, rel=0.625, record=ReliabilityRecord):
    """A deterministic dirty-making write (``update_reliability`` stamps
    the wall clock)."""
    store.put_record(record(
        source_id=source_id, market_id=market_id, reliability=rel,
        confidence=0.5, updated_at="2026-07-31T00:00:00+00:00",
    ))


def store_fingerprint(store):
    """Everything replay must reproduce: records AND row assignment."""
    store.sync()
    return (store.list_sources(), store._pairs.ids())


def host_state(store):
    store.sync()
    used = len(store)
    return (store._rel[:used].tobytes(), store._conf[:used].tobytes(),
            store._days[:used].tobytes(), store._exists[:used].tobytes(),
            list(store._iso[:used]), store._pairs.ids())


def settle_payloads(seed, markets=9, universe=15):
    rng = random.Random(seed)
    payloads = []
    for m in range(markets):
        signals = [{"sourceId": f"src-{rng.randrange(universe)}",
                    "probability": round(rng.random(), 6)}
                   for _ in range(rng.randint(1, 5))]
        # Every third market re-settles a seeded pair's market.
        payloads.append((f"mkt-{m}" if m % 3 == 0 else f"jm-{m}", signals))
    outcomes = [rng.random() < 0.5 for _ in range(markets)]
    return payloads, outcomes


# -- cross-package byte contract ---------------------------------------------


def scenario(path, make, record, writer_cls, pipe):
    """Seed 40 records, a snapshot epoch, a 2-step settle of payloads that
    re-touch and extend the store, a write, an async epoch, an empty epoch."""
    store = seeded_store(make=make, record=record)
    with writer_cls(path) as journal:
        assert store.flush_to_journal(journal, tag=0) == 40
        payloads, outcomes = settle_payloads(11)
        plan = pipe.build_settlement_plan(store, payloads)
        pipe.settle(store, plan, outcomes, steps=2, now=NOW)
        put(store, "src-new", "mkt-new", record=record)
        delta = store.flush_to_journal_async(journal, tag=1).result()
        assert store.flush_to_journal(journal, tag=2) == 0
    return store, delta


@pytest.fixture(scope="module")
def jax_scenario(tmp_path_factory):
    """The JAX package's journal of :func:`scenario` (its Python twins)."""
    path = tmp_path_factory.mktemp("jax") / "jax.jrnl"
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("BCE_NO_NATIVE", "1")
        patch.setattr(time, "time", lambda: CLOCK)
        store, delta = scenario(path, JaxStore, JaxRecord,
                                jjournal.JournalWriter, jpipe)
    return path, store, delta


@pytest.mark.parametrize("route", ROUTES)
def test_journal_bytes_equal_jax(tmp_path, monkeypatch, jax_scenario, route):
    jax_path, jax_store, jax_delta = jax_scenario
    use_route(monkeypatch, route)
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    path = tmp_path / "port.jrnl"
    store, delta = scenario(path, cpu_store, ReliabilityRecord,
                            JournalWriter, tpipe)
    expected = {"native": "NativePairInterner", "python": "IdInterner"}
    assert type(store._pairs).__name__ == expected[route]
    assert delta == jax_delta > 0
    assert path.read_bytes() == jax_path.read_bytes()
    assert store._pairs.ids() == jax_store._pairs.ids()


@pytest.mark.parametrize("route", ROUTES)
def test_replay_rebuilds_what_jax_rebuilds(monkeypatch, jax_scenario, route):
    jax_path, jax_store, _ = jax_scenario
    use_route(monkeypatch, route)
    replayed, tag = replay(jax_path)
    with monkeypatch.context() as patch:
        patch.setenv("BCE_NO_NATIVE", "1")
        jax_replayed, jax_tag = jjournal.replay_journal(jax_path)
    assert tag == jax_tag == 2
    assert host_state(replayed) == host_state(jax_replayed) == host_state(
        jax_store)
    assert [astuple(r) for r in replayed.list_sources()] == [
        astuple(r) for r in jax_store.list_sources()]


def _intern_through(store, entry, pairs):
    """Intern *pairs* through one of the store's row entry points."""
    sources = [p[0] for p in pairs]
    markets = [p[1] for p in pairs]
    if entry == "rows_for_pairs":
        return store.rows_for_pairs(pairs)
    if entry == "rows_for_arrays":
        return store.rows_for_arrays(sources, markets)
    source_table = sorted(set(sources))
    market_table = list(dict.fromkeys(markets))
    source_codes = np.asarray([source_table.index(s) for s in sources],
                              np.int32)
    market_codes = np.asarray([market_table.index(m) for m in markets],
                              np.int32)
    if entry == "rows_for_indexed":
        return store.rows_for_indexed(source_table, source_codes,
                                      market_table, market_codes)
    offsets = np.searchsorted(market_codes, np.arange(len(market_table) + 1))
    return store.rows_for_pairs_delta(
        source_table, source_codes, market_table, market_codes, offsets,
    )[0]


def _interning_journal(path, make, record, writer_cls, entry):
    """Two interning passes through *entry* (market-grouped batches with
    duplicates and known pairs), records written in key order, one epoch
    after each pass."""
    rng = random.Random(5)
    store = make()
    with writer_cls(path) as journal:
        for tag in range(2):
            pairs = []
            for m in range(12):
                for _ in range(rng.randint(1, 4)):
                    pairs.append((f"s{rng.randrange(9)}", f"m{m + 6 * tag}"))
            _intern_through(store, entry, pairs)
            for i, (source, market) in enumerate(sorted(set(pairs))):
                put(store, source, market, rel=0.01 * (i + 1), record=record)
            store.flush_to_journal(journal, tag=tag)
    return store


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("entry", ["rows_for_pairs", "rows_for_arrays",
                                   "rows_for_indexed", "rows_for_pairs_delta"])
def test_every_interning_route_assigns_jax_rows(tmp_path, monkeypatch, route,
                                                entry):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    with monkeypatch.context() as patch:
        patch.setenv("BCE_NO_NATIVE", "1")
        jax_store = _interning_journal(tmp_path / "jax.jrnl", JaxStore,
                                       JaxRecord, jjournal.JournalWriter,
                                       entry)
    use_route(monkeypatch, route)
    store = _interning_journal(tmp_path / "port.jrnl", cpu_store,
                               ReliabilityRecord, JournalWriter, entry)
    assert store._pairs.ids() == jax_store._pairs.ids()
    assert (tmp_path / "port.jrnl").read_bytes() == (
        tmp_path / "jax.jrnl").read_bytes()


def _trace_batches():
    rng = np.random.default_rng(17)
    batches = []
    for b in range(3):
        counts = rng.integers(0, 4, 5)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        batches.append((
            [f"m{b}-{i}" for i in range(5)],
            [f"src-{int(c)}" for c in rng.integers(0, 6, int(offsets[-1]))],
            rng.random(int(offsets[-1])), offsets,
            (rng.random(5) < 0.5).tolist(), NOW + b, 2,
        ))
    return batches


def test_trace_sidecar_bytes_equal_jax_and_round_trip(tmp_path):
    batches = _trace_batches()
    for module, name in ((tjournal, "port"), (jjournal, "jax")):
        with module.TraceWriter(tmp_path / f"{name}.trace") as writer:
            for batch in batches:
                writer.append_batch(*batch)
    raw = (tmp_path / "port.trace").read_bytes()
    assert raw == (tmp_path / "jax.trace").read_bytes()
    got = tjournal.read_trace(tmp_path / "port.trace", strict=True)
    assert [b.index for b in got] == [0, 1, 2]
    for batch, (keys, sids, probs, offsets, outs, now, steps) in zip(
            got, batches):
        assert batch.market_keys == tuple(keys)
        assert batch.source_ids == tuple(sids)
        np.testing.assert_array_equal(batch.probabilities, probs)
        np.testing.assert_array_equal(batch.offsets, offsets)
        np.testing.assert_array_equal(batch.outcomes, outs)
        assert (batch.now_days, batch.steps) == (now, steps)


@pytest.mark.parametrize("strict", [False, True])
def test_torn_trace_tail(tmp_path, strict):
    path = tmp_path / "t.trace"
    with tjournal.TraceWriter(path) as writer:
        for batch in _trace_batches():
            writer.append_batch(*batch)
    path.write_bytes(path.read_bytes()[:-5])
    if strict:
        with pytest.raises(tjournal.TornTraceError, match="mid-frame"):
            tjournal.read_trace(path, strict=True)
        return
    assert [b.index for b in tjournal.read_trace(path)] == [0, 1]
    with tjournal.TraceWriter(path, resume=True) as writer:
        assert writer.batch_index == 2
        writer.append_batch(*_trace_batches()[2])
    assert len(tjournal.read_trace(path, strict=True)) == 3


@pytest.mark.parametrize("strict", [False, True])
def test_extract_trace_is_bounded_by_the_journal_tag(tmp_path, strict):
    journal_path = tmp_path / "run.jrnl"
    store = seeded_store(n=6)
    with JournalWriter(journal_path) as journal, \
            tjournal.TraceWriter(tjournal.trace_path_for(journal_path)) as trace:
        for index, batch in enumerate(_trace_batches()):
            trace.append_batch(*batch)
            if index < 2:  # the third batch never became durable
                put(store, "src-1", f"mkt-{index}")
                store.flush_to_journal(journal, tag=index)
    if strict:
        with pytest.raises(tjournal.TornTraceError, match="tag=1"):
            tjournal.extract_trace(journal_path, strict=True)
        return
    batches, tag = tjournal.extract_trace(journal_path)
    assert tag == 1 and [b.index for b in batches] == [0, 1]


def test_trace_writer_refuses_existing_and_mismatched_shapes(tmp_path):
    path = tmp_path / "x.trace"
    with tjournal.TraceWriter(path) as writer:
        keys, sids, probs, offsets, outs, now, steps = _trace_batches()[0]
        with pytest.raises(ValueError, match="shape mismatch"):
            writer.append_batch(keys, sids, probs, offsets, outs[:-1], now,
                                steps)
        with pytest.raises(ValueError, match="signal count"):
            writer.append_batch(keys, sids[:-1], probs, offsets, outs, now,
                                steps)
        writer.append_batch(keys, sids, probs, offsets, outs, now, steps)
    with pytest.raises(ValueError, match="refusing to truncate"):
        tjournal.TraceWriter(path)


# -- the journal's contracts (the JAX package's cases, on the port) ----------


class TestJournalRoundTrip:
    def test_single_epoch_replay_exact(self, tmp_path):
        store = seeded_store()
        path = tmp_path / "a.jrnl"
        with JournalWriter(path) as journal:
            assert store.flush_to_journal(journal, tag=7) == len(store)
        replayed, tag = replay(path)
        assert tag == 7
        assert replayed.device.type == "cpu"
        assert store_fingerprint(replayed) == store_fingerprint(store)

    def test_incremental_epochs_write_only_dirty(self, tmp_path):
        store = seeded_store(n=30)
        path = tmp_path / "b.jrnl"
        with JournalWriter(path) as journal:
            assert store.flush_to_journal(journal, tag=0) == 30
            # Three touched rows and two new pairs: the next epoch is
            # exactly those five rows, not a re-snapshot.
            for i in (4, 9, 11):
                store.update_reliability(f"src-{i % 7}", f"mkt-{i}", True)
            put(store, "src-new", "mkt-new-1", rel=0.625)
            put(store, "src-new", "mkt-new-2", rel=0.125)
            assert store.flush_to_journal(journal, tag=1) == 5
            assert store.flush_to_journal(journal, tag=2) == 0
        replayed, tag = replay(path)
        assert tag == 2
        assert store_fingerprint(replayed) == store_fingerprint(store)

    def test_journal_dirty_is_independent_of_sqlite_dirty(self, tmp_path):
        store = seeded_store(n=12)
        path = tmp_path / "c.jrnl"
        db = tmp_path / "c.db"
        with JournalWriter(path) as journal:
            store.flush_to_journal(journal, tag=0)
            assert store.flush_to_sqlite(db) == 12
            store.update_reliability("src-1", "mkt-1", False)
            assert store.flush_to_sqlite(db) == 1
            assert store.flush_to_journal(journal, tag=1) == 1
        replayed, _ = replay(path)
        assert store_fingerprint(replayed) == store_fingerprint(store)

    def test_replayed_store_flushes_full_sqlite(self, tmp_path):
        import contextlib
        import sqlite3

        store = seeded_store(n=9)
        path = tmp_path / "d.jrnl"
        with JournalWriter(path) as journal:
            store.flush_to_journal(journal)
        replayed, _ = replay(path)
        replayed.flush_to_sqlite(tmp_path / "replayed.db")
        store.flush_to_sqlite(tmp_path / "orig.db")
        rows = []
        for name in ("replayed.db", "orig.db"):
            with contextlib.closing(sqlite3.connect(tmp_path / name)) as conn:
                rows.append(conn.execute(
                    "SELECT * FROM sources ORDER BY source_id, market_id"
                ).fetchall())
        assert rows[0] == rows[1] and len(rows[0]) == 9


def _two_epoch_journal(tmp_path, n=20):
    store = seeded_store(n=n)
    path = tmp_path / "torn.jrnl"
    with JournalWriter(path) as journal:
        store.flush_to_journal(journal, tag=0)
        store.update_reliability("src-2", "mkt-2", True)
        store.flush_to_journal(journal, tag=1)
    return path, store


class TestTornTail:
    @pytest.mark.parametrize("damage", ["truncate_crc", "flip_payload_byte"])
    def test_damaged_tail_drops_last_epoch_only(self, tmp_path, damage):
        path, store = _two_epoch_journal(tmp_path)
        raw = bytearray(path.read_bytes())
        if damage == "truncate_crc":
            raw = raw[:-7]
        else:
            raw[-20] ^= 0xFF
        path.write_bytes(bytes(raw))
        replayed, tag = replay(path)
        assert tag == 0
        assert len(replayed) == len(store)

    def test_resume_truncates_torn_tail_and_appends(self, tmp_path):
        path, store = _two_epoch_journal(tmp_path)
        path.write_bytes(path.read_bytes()[:-7])
        with JournalWriter(path, resume=True) as journal:
            assert journal.epoch_index == 1
            store._journal_dirty[:] = False
            store.update_reliability("src-3", "mkt-3", True)
            store.flush_to_journal(journal, tag=9)
        replayed, tag = replay(path)
        assert tag == 9
        assert replayed.get_reliability("src-3", "mkt-3") == (
            store.get_reliability("src-3", "mkt-3"))

    def test_store_behind_journal_rejected(self, tmp_path):
        path, _ = _two_epoch_journal(tmp_path)
        with JournalWriter(path, resume=True) as journal:
            with pytest.raises(ValueError, match="journal already covers"):
                cpu_store().flush_to_journal(journal)

    def test_existing_journal_refuses_truncation(self, tmp_path):
        path, _ = _two_epoch_journal(tmp_path)
        with pytest.raises(ValueError, match="refusing to truncate"):
            JournalWriter(path)

    def test_empty_journal_replays_to_empty_store(self, tmp_path):
        path = tmp_path / "empty.jrnl"
        JournalWriter(path).close()
        store, tag = replay(path)
        assert tag is None and len(store) == 0

    def test_bad_magic_raises(self, tmp_path):
        path = tmp_path / "bad.jrnl"
        path.write_bytes(b"NOTAJRNL" + b"\x00" * 32)
        with pytest.raises(ValueError, match="magic"):
            replay(path)


def _fsync_log(monkeypatch):
    real_fsync = os.fsync
    log = []

    def logging_fsync(fd):
        log.append("dir" if stat.S_ISDIR(os.fstat(fd).st_mode) else "file")
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", logging_fsync)
    return log


class TestDirectoryFsync:
    """A fresh journal and a compaction's ``os.replace`` fsync the parent
    directory; each epoch fsyncs the file; ``fsync=False`` does neither."""

    def test_fresh_journal_fsyncs_parent_directory(self, tmp_path,
                                                   monkeypatch):
        log = _fsync_log(monkeypatch)
        JournalWriter(tmp_path / "fresh.jrnl").close()
        assert "dir" in log

    def test_append_epoch_fsyncs_the_file(self, tmp_path, monkeypatch):
        store = seeded_store(n=4)
        journal = JournalWriter(tmp_path / "a.jrnl")
        log = _fsync_log(monkeypatch)
        with journal:
            store.flush_to_journal(journal, tag=0)
        assert "file" in log

    def test_fsync_false_skips_both(self, tmp_path, monkeypatch):
        log = _fsync_log(monkeypatch)
        with JournalWriter(tmp_path / "nf.jrnl", fsync=False) as journal:
            seeded_store(n=3).flush_to_journal(journal)
        assert log == []

    def test_compaction_fsyncs_directory_after_replace(self, tmp_path,
                                                       monkeypatch):
        path, store = _two_epoch_journal(tmp_path, n=10)
        events = []
        log = _fsync_log(monkeypatch)
        real_replace = os.replace

        def logging_replace(src, dst):
            events.append(len(log))
            return real_replace(src, dst)

        monkeypatch.setattr(os, "replace", logging_replace)
        compact_journal(path, device="cpu")
        (at,) = events
        assert "dir" in log[at:]
        replayed, tag = replay(path)
        assert tag == 1
        assert store_fingerprint(replayed) == store_fingerprint(store)


def _append_raw_frame(path, epoch_index, used_after, pair_blob, idx,
                      iso_values, tag=0):
    """Append a CRC-VALID frame with caller-chosen (possibly garbage)
    semantics."""
    iso_blob = b"".join(
        struct.pack("<I", len(v.encode())) + v.encode() for v in iso_values
    )
    dirty = len(idx)
    header = tjournal._EPOCH_HDR.pack(
        epoch_index, used_after, len(pair_blob), dirty, len(iso_blob), 0.0,
        tag,
    )
    payload = b"".join((
        header, pair_blob, np.asarray(idx, np.uint64).tobytes(),
        np.full(dirty, 0.5).tobytes(), np.full(dirty, 0.5).tobytes(),
        np.zeros(dirty).tobytes(), np.ones(dirty, np.uint8).tobytes(),
        iso_blob,
    ))
    with open(path, "ab") as f:
        f.write(payload)
        f.write(struct.pack("<I", zlib.crc32(payload)))


class TestSemanticResumeScan:
    """The resume scan applies the same semantic checks replay does, so a
    CRC-valid but malformed epoch stops both at the same place."""

    def _garbage_tail(self, tmp_path, kind):
        store = seeded_store(n=8)
        path = tmp_path / "g.jrnl"
        with JournalWriter(path) as journal:
            store.flush_to_journal(journal, tag=0)
        rows = len(store)
        if kind == "idx_out_of_bounds":
            _append_raw_frame(path, 1, rows, b"", [rows + 7],
                              ["2026-08-01T00:00:00+00:00"], tag=1)
        else:  # claims one new pair but ships an empty blob
            _append_raw_frame(path, 1, rows + 1, b"", [0], ["x"], tag=1)
        return path, rows

    @pytest.mark.parametrize("kind", ["idx_out_of_bounds",
                                      "unparseable_pair_blob"])
    def test_replay_and_resume_stop_at_the_same_epoch(self, tmp_path, kind):
        path, rows = self._garbage_tail(tmp_path, kind)
        replayed, tag = replay(path)
        assert tag == 0
        before = path.stat().st_size
        with JournalWriter(path, resume=True) as journal:
            assert path.stat().st_size < before  # the garbage is gone
            assert journal.epoch_index == 1
            assert journal.rows_covered == rows == len(replayed)
            replayed._journal_dirty[:] = False
            replayed.update_reliability("src-2", "mkt-2", True)
            assert replayed.flush_to_journal(journal, tag=5) == 1
        again, tag = replay(path)
        assert tag == 5
        assert store_fingerprint(again) == store_fingerprint(replayed)


class TestWriterValidation:
    def test_used_after_regression_rejected(self, tmp_path):
        with JournalWriter(tmp_path / "v.jrnl") as journal:
            seeded_store(n=4).flush_to_journal(journal)
            with pytest.raises(ValueError, match="used_after"):
                journal.append_epoch(
                    2, [], np.array([], np.int64), np.array([]),
                    np.array([]), np.array([]), np.array([], np.uint8), [],
                )

    def test_column_length_mismatch_rejected(self, tmp_path):
        with JournalWriter(tmp_path / "w.jrnl") as journal:
            with pytest.raises(ValueError, match="length"):
                journal.append_epoch(
                    0, [], np.array([0], np.int64), np.array([0.5]),
                    np.array([]), np.array([0.0]), np.array([1], np.uint8),
                    ["x"],
                )


def _grown_journal(tmp_path, epochs):
    store = seeded_store(n=40)
    path = tmp_path / "grow.jrnl"
    with JournalWriter(path) as journal:
        store.flush_to_journal(journal, tag=0)
        for e in range(1, epochs):
            # Re-touch the same rows every epoch: the journal grows while
            # the live state stays 40 rows.
            for i in range(0, 40, 3):
                put(store, f"src-{i % 7}", f"mkt-{i}", rel=0.01 * e)
            store.flush_to_journal(journal, tag=e)
    return path, store


class TestCompaction:
    def test_compaction_shrinks_and_preserves_state_and_tag(self, tmp_path):
        path, store = _grown_journal(tmp_path, 6)
        before_state, before_tag = replay(path)
        before_size = path.stat().st_size
        assert compact_journal(path, device="cpu") == len(store)
        assert path.stat().st_size < before_size
        after_state, after_tag = replay(path)
        assert after_tag == before_tag == 5
        assert store_fingerprint(after_state) == store_fingerprint(before_state)

    def test_resume_after_compaction_appends(self, tmp_path):
        path, store = _grown_journal(tmp_path, 3)
        compact_journal(path, device="cpu")
        with JournalWriter(path, resume=True) as journal:
            assert journal.epoch_index == 1  # the snapshot epoch
            store._journal_dirty[:] = False
            store.update_reliability("src-1", "mkt-1", True)
            store.flush_to_journal(journal, tag=9)
        replayed, tag = replay(path)
        assert tag == 9
        assert replayed.get_reliability("src-1", "mkt-1") == (
            store.get_reliability("src-1", "mkt-1"))

    def test_epochless_journal_compacts_to_empty_not_tag_zero(self, tmp_path):
        path = tmp_path / "fresh.jrnl"
        JournalWriter(path).close()
        assert compact_journal(path, device="cpu") == 0
        store, tag = replay(path)
        assert tag is None and len(store) == 0

    def test_stale_compact_leftover_is_discarded(self, tmp_path):
        path, store = _grown_journal(tmp_path, 2)
        stale = tmp_path / "grow.jrnl.compact"
        stale.write_bytes(b"BCEJRNL1leftover-from-a-crash")
        assert compact_journal(path, device="cpu") == len(store)
        assert not stale.exists()
        replayed, tag = replay(path)
        assert tag == 1
        assert store_fingerprint(replayed) == store_fingerprint(store)

    def test_compaction_of_torn_journal_keeps_valid_prefix(self, tmp_path):
        path, _ = _grown_journal(tmp_path, 3)
        path.write_bytes(path.read_bytes()[:-9])
        want_state, want_tag = replay(path)
        compact_journal(path, device="cpu")
        got_state, got_tag = replay(path)
        assert got_tag == want_tag == 1
        assert store_fingerprint(got_state) == store_fingerprint(want_state)


class _TornFile:
    """Writes the first *allow* bytes then fails: a full disk mid append."""

    def __init__(self, real, allow):
        self._real = real
        self._allow = allow

    def write(self, data):
        chunk = data[: self._allow]
        self._real.write(chunk)
        self._allow -= len(chunk)
        if len(chunk) < len(data):
            raise OSError(28, "No space left on device")
        return len(chunk)

    def __getattr__(self, name):
        return getattr(self._real, name)


class TestAsyncEpochs:
    def test_async_epochs_byte_identical_to_sync(self, tmp_path, monkeypatch):
        monkeypatch.setattr(time, "time", lambda: CLOCK)

        def run(async_mode):
            path = tmp_path / ("a.jrnl" if async_mode else "s.jrnl")
            store = seeded_store()
            with JournalWriter(path) as journal:
                for round_no in range(3):
                    if async_mode:
                        assert store.flush_to_journal_async(
                            journal, tag=round_no).result() >= 0
                    else:
                        store.flush_to_journal(journal, tag=round_no)
                    put(store, f"src-{round_no}", f"mkt-{round_no}", rel=0.6)
            return path.read_bytes()

        assert run(async_mode=True) == run(async_mode=False)

    def test_epochs_serialise_without_explicit_joins(self, tmp_path):
        store = seeded_store()
        with JournalWriter(tmp_path / "chain.jrnl") as journal:
            for round_no in range(4):
                store.update_reliability("src-1", f"mkt-{round_no}", True)
                handle = store.flush_to_journal_async(journal, tag=round_no)
            handle.result()
        replayed, tag = replay(tmp_path / "chain.jrnl")
        assert tag == 3
        assert store_fingerprint(replayed) == store_fingerprint(store)

    def test_crash_mid_async_epoch_recovers_last_joined(self, tmp_path):
        path = tmp_path / "torn.jrnl"
        store = seeded_store()
        journal = JournalWriter(path)
        store.flush_to_journal_async(journal, tag=0).result()
        durable = store_fingerprint(store)
        store.update_reliability("src-0", "mkt-1", True)
        real_file = journal._file
        journal._file = _TornFile(real_file, allow=32)
        handle = store.flush_to_journal_async(journal, tag=1)
        with pytest.raises(OSError, match="No space"):
            handle.result()
        journal._file = real_file
        replayed, tag = replay(path)
        assert tag == 0
        assert store_fingerprint(replayed) == durable
        # The failed epoch's rows were re-marked dirty: the retry re-covers
        # them and replay reaches the live state.
        store.flush_to_journal(journal, tag=1)
        journal.close()
        replayed, tag = replay(path)
        assert tag == 1
        assert store_fingerprint(replayed) == store_fingerprint(store)

    def test_background_failure_surfaces_at_next_flush(self, tmp_path):
        store = seeded_store()
        journal = JournalWriter(tmp_path / "fail.jrnl")
        store.flush_to_journal_async(journal, tag=0).result()
        store.update_reliability("src-0", "mkt-2", True)
        journal._file = _TornFile(journal._file, allow=0)
        store.flush_to_journal_async(journal, tag=1)  # handle dropped
        store.update_reliability("src-1", "mkt-3", True)
        with pytest.raises(OSError, match="No space"):
            store.flush_to_journal_async(journal, tag=2)
        journal.close()

    def test_store_close_joins_inflight_epoch(self, tmp_path):
        store = seeded_store()
        journal = JournalWriter(tmp_path / "join.jrnl")
        store.flush_to_journal_async(journal, tag=0)
        store.close()
        journal.close()
        _, tag = replay(tmp_path / "join.jrnl")
        assert tag == 0

    def test_delta_counters_in_metrics_dump(self, tmp_path):
        registry = obs.MetricsRegistry()
        previous = obs.set_metrics_registry(registry)
        try:
            store = seeded_store()
            with JournalWriter(tmp_path / "m.jrnl") as journal:
                store.flush_to_journal(journal, tag=0)  # full snapshot
                store.update_reliability("src-0", "mkt-0", True)
                store.update_reliability("src-1", "mkt-1", False)
                store.flush_to_journal_async(journal, tag=1).result()
            db = tmp_path / "x.db"
            store.flush_to_sqlite(db)  # full export
            store.update_reliability("src-2", "mkt-2", True)
            store.flush_to_sqlite(db)  # incremental
        finally:
            obs.set_metrics_registry(previous)
        counters = registry.export()["counters"]
        assert counters["journal.delta_rows"] == 2
        assert counters["journal.epochs"] == 2
        assert counters["journal.dirty_rows"] == 42
        assert counters["interchange.delta_rows"] == 1


# -- delta against full: the sync and the interning --------------------------


def _chained_settles(store):
    """Two chained settles: a duplicate signal in batch 1, new interning
    and a row overlap in batch 2 (the union-take path)."""
    batch1 = [
        ("m0", [{"sourceId": "a", "probability": 0.9},
                {"sourceId": "a", "probability": 0.4},
                {"sourceId": "b", "probability": 0.3}]),
        ("m1", [{"sourceId": "a", "probability": 0.7}]),
    ]
    tpipe.settle(store, tpipe.build_settlement_plan(store, batch1),
                 [True, False], steps=2, now=21_000.0)
    batch2 = [
        ("m2", [{"sourceId": "c", "probability": 0.6},
                {"sourceId": "a", "probability": 0.2}]),
        ("m0", [{"sourceId": "b", "probability": 0.8}]),
    ]
    tpipe.settle(store, tpipe.build_settlement_plan(store, batch2),
                 [True, True], steps=1, now=21_001.0)


def test_journal_after_delta_sync_equals_full_sync(tmp_path, monkeypatch):
    registry = obs.MetricsRegistry()
    previous = obs.set_metrics_registry(registry)
    try:
        delta, full = cpu_store(), cpu_store()
        _chained_settles(delta)
        _chained_settles(full)
        assert delta._pending is not None and delta._pending_sync
        full._pending_sync = None  # leaves only the full-column sync
        delta.sync()
        full.sync()
    finally:
        obs.set_metrics_registry(previous)
    # Union of the two settles' touched rows: 3 + 3 with one overlap.
    assert registry.export()["counters"]["store.delta_sync_rows"] == 5
    used = len(delta)
    assert delta._journal_dirty[:used].tobytes() == (
        full._journal_dirty[:used].tobytes())
    monkeypatch.setattr(time, "time", lambda: 1_234.5)
    for store, name in ((delta, "delta"), (full, "full")):
        with JournalWriter(tmp_path / f"{name}.jrnl") as writer:
            store.flush_to_journal(writer, tag=7)
    assert (tmp_path / "delta.jrnl").read_bytes() == (
        tmp_path / "full.jrnl").read_bytes()


def _drifting_batches():
    rng = np.random.default_rng(31)
    batches = []
    for b in range(3):
        keys = [f"m-{i}" for i in range(b * 3, 12 + b * 3)]
        counts = rng.integers(1, 4, len(keys))
        offsets = np.concatenate([[0], np.cumsum(counts)])
        sids = [f"src-{int(c)}" for c in rng.integers(0, 8, int(offsets[-1]))]
        batches.append((keys, sids, rng.random(int(offsets[-1])), offsets,
                        (rng.random(len(keys)) < 0.5).tolist()))
    return batches


@pytest.mark.parametrize("route", ROUTES)
def test_delta_interning_journal_equals_full(tmp_path, monkeypatch, route):
    use_route(monkeypatch, route)
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    for mode in ("auto", "full"):
        store = cpu_store()
        with JournalWriter(tmp_path / f"{mode}.jrnl") as journal:
            for i, (keys, sids, probs, offsets, outcomes) in enumerate(
                    _drifting_batches()):
                plan = tpipe.build_settlement_plan_columnar(
                    store, keys, sids, probs, offsets, intern_mode=mode)
                tpipe.settle(store, plan, outcomes, steps=2, now=NOW + i)
                store.flush_to_journal(journal, tag=i)
    assert (tmp_path / "auto.jrnl").read_bytes() == (
        tmp_path / "full.jrnl").read_bytes()


# -- recovery drops the epoch pair table --------------------------------------


class TestRecoveryInvalidation:
    """Adoption and replay intern outside the bind trace: the epoch table
    drops, and a post-recovery delta bind re-witnesses every pair."""

    @staticmethod
    def _bind(store, batch, mode="auto"):
        keys, sids, probs, offsets, _outcomes = batch
        return tpipe.stage_settlement_plan_columnar(
            keys, sids, probs, offsets, intern_mode=mode).bind(store)

    def _warm(self):
        store = cpu_store()
        self._bind(store, _drifting_batches()[0])
        assert store._pair_epoch is not None
        return store

    def test_absorb_replayed_rows_drops_the_table(self):
        store = self._warm()
        rows = store.rows_for_arrays(["x"], ["y"])
        store.absorb_replayed_rows(
            rows, np.array([0.7]), np.array([0.6]), np.array([20_000.0]),
            np.array([True]), ["2024-09-30T00:00:00+00:00"],
        )
        assert store._pair_epoch is None
        assert store._journal_dirty[int(rows[0])]
        with pytest.raises(ValueError, match="beyond"):
            store.absorb_replayed_rows(
                [len(store)], [0.5], [0.5], [0.0], [True], ["x"])

    def test_journal_replay_drops_the_table(self):
        store = self._warm()
        store._apply_journal_epoch(
            len(store) + 1, [("zz", "qq")], np.array([len(store)], np.int64),
            np.array([0.5]), np.array([0.5]), np.array([20_100.0]),
            np.array([True]), ["2024-01-01T00:00:00+00:00"],
        )
        assert store._pair_epoch is None
        with pytest.raises(ValueError, match="contiguously"):
            store._apply_journal_epoch(
                len(store) + 1, [("zz", "qq")], np.array([], np.int64),
                np.array([]), np.array([]), np.array([]),
                np.array([], bool), [],
            )

    def test_post_adoption_delta_bind_matches_full(self):
        adopted = (["adopted-src"], ["adopted-mkt"])
        values = (np.array([0.9]), np.array([0.8]), np.array([20_050.0]),
                  np.array([True]), ["2024-11-30T00:00:00+00:00"])
        store = self._warm()
        store.absorb_replayed_rows(store.rows_for_arrays(*adopted), *values)
        drift = _drifting_batches()[1]
        plan_delta = self._bind(store, drift)
        assert plan_delta.intern_stats["matched_pairs"] == 0  # re-witness
        reference = cpu_store()
        self._bind(reference, _drifting_batches()[0], mode="full")
        reference.absorb_replayed_rows(
            reference.rows_for_arrays(*adopted), *values)
        plan_full = self._bind(reference, drift, mode="full")
        np.testing.assert_array_equal(plan_delta.slot_rows,
                                      plan_full.slot_rows)
        assert store._pairs.ids() == reference._pairs.ids()


# -- the journal under settle_stream -------------------------------------------


def stream_batches(num_batches=4, markets=9, seed=61):
    rng = random.Random(seed)
    out = []
    for b in range(num_batches):
        payloads = []
        for m in range(markets):
            payloads.append((f"jm-b{b}-{m}", [
                {"sourceId": f"src-{rng.randrange(15)}",
                 "probability": round(rng.random(), 6)}
                for _ in range(rng.randint(1, 5))]))
        out.append((payloads, [rng.random() < 0.5 for _ in range(markets)]))
    return out


def _db_rows(path):
    import sqlite3

    with sqlite3.connect(path) as conn:
        return conn.execute("SELECT * FROM sources ORDER BY source_id, "
                            "market_id").fetchall()


class TestSettleStreamJournal:
    """The JAX package's ``settle_stream`` journal cases, on the port."""

    @staticmethod
    def _run(batches, db=None, journal=None, **kw):
        store = cpu_store()
        results = list(tpipe.settle_stream(
            store, batches, steps=2, now=21_300.0, db_path=db,
            journal=journal, **kw))
        return store, results

    def test_journal_mode_matches_plain_stream_and_replays(self, tmp_path):
        batches = stream_batches()
        plain_store, plain_results = self._run(batches, db=tmp_path / "p.db")
        store, results = self._run(batches, db=tmp_path / "s.db",
                                   journal=tmp_path / "s.jrnl",
                                   checkpoint_every=2)
        for mine, ref in zip(results, plain_results):
            np.testing.assert_array_equal(mine.consensus, ref.consensus)
        # The interchange file holds the same rows in journal mode.
        assert _db_rows(tmp_path / "s.db") == _db_rows(tmp_path / "p.db")
        replayed, tag = replay(tmp_path / "s.jrnl")
        assert tag == len(batches) - 1
        assert store_fingerprint(replayed) == store_fingerprint(store)
        assert store_fingerprint(store) == store_fingerprint(plain_store)

    def test_journal_only_mode_needs_no_db(self, tmp_path):
        store, _ = self._run(stream_batches(num_batches=3),
                             journal=tmp_path / "only.jrnl")
        replayed, tag = replay(tmp_path / "only.jrnl")
        assert tag == 2
        assert store_fingerprint(replayed) == store_fingerprint(store)

    def test_break_recovery_resumes_from_watermark(self, tmp_path):
        batches = stream_batches(num_batches=5)
        full_store, _ = self._run(batches)
        stream = tpipe.settle_stream(cpu_store(), batches, steps=2,
                                     now=21_300.0, journal=tmp_path / "r.jrnl")
        for i, _result in enumerate(stream):
            if i == 1:
                stream.close()  # GeneratorExit -> tail epoch, tag 1
                break
        replayed, tag = replay(tmp_path / "r.jrnl")
        assert tag == 1
        with pytest.raises(ValueError, match="refusing to truncate"):
            JournalWriter(tmp_path / "r.jrnl")
        resumed = list(tpipe.settle_stream(
            replayed, batches[tag + 1:], steps=2, now=21_300.0 + tag + 1,
            journal=JournalWriter(tmp_path / "r.jrnl", resume=True)))
        assert len(resumed) == 3
        assert store_fingerprint(replayed) == store_fingerprint(full_store)
        again, tag2 = replay(tmp_path / "r.jrnl")
        assert tag2 == 2  # the resumed stream's own batch indices
        assert store_fingerprint(again) == store_fingerprint(full_store)

    @pytest.mark.parametrize("shape", [(1, 1), (1, 4)])
    def test_sharded_stream_journal_matches_flat(self, tmp_path, shape):
        from bayesian_consensus_engine_tpu_torch.parallel.mesh import make_mesh

        batches = stream_batches(num_batches=3, seed=71)
        flat_store, flat_results = self._run(batches)
        store, results = self._run(
            batches, journal=tmp_path / "m.jrnl", checkpoint_every=2,
            mesh=make_mesh(shape, ["cpu"] * (shape[0] * shape[1])))
        for mine, ref in zip(results, flat_results):
            if shape == (1, 1):
                np.testing.assert_array_equal(np.asarray(mine.consensus),
                                              ref.consensus)
            else:  # the sources split re-associates each market's sum
                np.testing.assert_allclose(np.asarray(mine.consensus),
                                           ref.consensus, rtol=2e-6,
                                           atol=1e-7)
        replayed, tag = replay(tmp_path / "m.jrnl")
        assert tag == 2
        assert store_fingerprint(replayed) == store_fingerprint(store)

    def test_lazy_checkpoints_rejected_with_journal(self, tmp_path):
        with pytest.raises(ValueError, match="lazy"):
            list(tpipe.settle_stream(cpu_store(), [],
                                     journal=tmp_path / "x.jrnl",
                                     lazy_checkpoints=True))
        assert not (tmp_path / "x.jrnl").exists()

    def test_settle_raise_never_claims_failed_batch(self, tmp_path):
        batches = stream_batches(num_batches=3, seed=81)
        bad = (batches[1][0], batches[1][1][:2])  # truncated outcomes
        with pytest.raises(ValueError, match="outcomes"):
            list(tpipe.settle_stream(
                cpu_store(), [batches[0], bad, batches[2]], steps=1,
                now=21_400.0, journal=tmp_path / "f.jrnl"))
        _, tag = replay(tmp_path / "f.jrnl")
        assert tag == 0

    def test_stream_journal_bytes_equal_jax(self, tmp_path, monkeypatch):
        from test_torch_stream import run_stream

        batches = stream_batches(num_batches=4, seed=91)
        port = run_stream("torch", batches, tmp_path, "port", journal=True,
                          checkpoint_every=2)
        ref = run_stream("jax", batches, tmp_path, "jax", journal=True,
                         checkpoint_every=2)
        assert port.journal.read_bytes() == ref.journal.read_bytes()
        replayed, tag = jjournal.replay_journal(port.journal)
        assert tag == 3
        replayed.sync()
        assert replayed.list_sources() == ref.store.list_sources()


class TestAsyncEpochsUnderTheStream:
    """The JAX package's two ``settle_stream`` cases of its async-epoch
    class, on the port."""

    def test_stream_async_journal_byte_identical_to_sync(self, tmp_path):
        from test_torch_stream import run_stream

        batches = stream_batches(num_batches=4, seed=91)
        runs = [run_stream("torch", batches, tmp_path, name, db=False,
                           journal=True, checkpoint_every=2,
                           sync_checkpoints=sync)
                for name, sync in (("async", False), ("sync", True))]
        assert runs[0].journal.read_bytes() == runs[1].journal.read_bytes()

    def test_stream_consumer_break_joins_inflight(self, tmp_path):
        store = cpu_store()
        stream = tpipe.settle_stream(
            store, stream_batches(num_batches=4, seed=93), steps=2,
            now=21_300.0, journal=tmp_path / "brk.jrnl", checkpoint_every=2)
        for i, _result in enumerate(stream):
            if i == 1:
                stream.close()
                break
        replayed, tag = replay(tmp_path / "brk.jrnl")
        assert tag == 1
        assert store_fingerprint(replayed) == store_fingerprint(store)

    def test_stream_break_journals_pairs_the_prefetch_interned(
            self, tmp_path):
        # The prefetch worker takes batch 2 only after batch 1's epoch was
        # snapshotted, and the break comes only after it built batch 2 (it
        # asks for batch 3 once batch 2's plan is queued): the live store
        # holds pairs interned after the last epoch. The exit's tail epoch
        # must journal them, so replay equals the store.
        batches = stream_batches(num_batches=4, seed=93)
        checkpointed = threading.Event()
        built_ahead = threading.Event()

        def source():
            for index, batch in enumerate(batches):
                if index == 2:
                    checkpointed.wait(timeout=30)
                if index == 3:
                    built_ahead.set()
                yield batch

        store = cpu_store()
        stream = tpipe.settle_stream(
            store, source(), steps=2, now=21_300.0,
            journal=tmp_path / "pre.jrnl", checkpoint_every=2)
        for i, _result in enumerate(stream):
            if i == 1:
                checkpointed.set()
                assert built_ahead.wait(timeout=30)
                stream.close()
                break
        settled = cpu_store()
        list(tpipe.settle_stream(settled, batches[:2], steps=2,
                                 now=21_300.0))
        assert len(store) > len(settled)  # batch 2's pairs are interned
        replayed, tag = replay(tmp_path / "pre.jrnl")
        assert tag == 1
        assert store_fingerprint(replayed) == store_fingerprint(store)
