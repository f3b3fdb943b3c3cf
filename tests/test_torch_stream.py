"""The port's streamed service ≡ the JAX package's flat stream, on the CPU.

The same seeded batches (dict payloads and columnar tuples) go through
``bayesian_consensus_engine_tpu.pipeline.settle_stream`` on a JAX store
and the port's ``settle_stream`` on a ``device="cpu"`` store, with
``now`` fixed and the wall clock pinned (``time.time``: the journal
frames carry it). The prefetch worker takes batch k only once the stream
has yielded batch k-1 (``Gated``): an epoch records the pairs interned
when it is snapshotted, and an ungated worker interns ahead, so the pair
tables of the epochs would depend on thread timing in either package.
After each stream:

* the consensus of every batch agrees within rtol=1e-5, atol=1e-6 (f32;
  XLA's ``exp2`` and slot-sum order), NaNs in the same places;
* ``list_sources()`` is equal field for field (reliability, confidence,
  ISO stamps: bit-equal);
* the SQLite ``iterdump()`` is equal (the CREATE statement's whitespace
  normalised: the port's C writer keeps its schema on one line; the JAX
  side takes its sqlite3 writer under ``BCE_NO_NATIVE=1``), and the
  journal files are byte-equal, CRCs included;
* the per-batch ``stats`` carry the JAX package's keys and its
  ``plan_reused``, ``interned_pairs`` and checkpoint cadence.

Port-only, as the JAX package pins them for itself: ``PlanPrefetcher``
against the serial build loop (dict and columnar, a build error on
``next()``, close mid-stream), the stream against the serial build →
settle → flush loop (bit-equal), ``checkpoint_every`` with the tail
flush, ``reuse_plans`` bit-exact with rebuilds (stable topology,
duplicate signals, columnar, reordered markets and signals, drift), a
batch error, a failed background flush and an early break. The JAX
streams run once per module.
"""

import os
import sqlite3
import threading
import time

import numpy as np
import pytest

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.pipeline import (
    PlanPrefetcher,
    build_settlement_plan,
    build_settlement_plan_columnar,
    settle,
    settle_stream,
)
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)

CLOCK = 9_876.5
NOW = 21_300.0
TOL = dict(rtol=1e-5, atol=1e-6)


def cpu_store():
    return TensorReliabilityStore(device="cpu")


def random_payloads(rng, num_markets, universe=15, max_signals=5, tag=""):
    """Dict payloads with 1..max_signals signals from a small universe, so
    sources repeat within a market (duplicate-signal averaging)."""
    payloads = []
    for m in range(num_markets):
        count = int(rng.integers(1, max_signals + 1))
        payloads.append((
            f"market{tag}-{m}",
            [{"sourceId": f"src-{int(s)}",
              "probability": float(np.round(rng.random(), 6))}
             for s in rng.integers(0, universe, count)],
        ))
    return payloads


def stream_batches(seed, num_batches=4, markets=9, universe=15, tag="s"):
    rng = np.random.default_rng(seed)
    return [
        (random_payloads(rng, markets, universe, tag=f"-{tag}{b}"),
         (rng.random(markets) < 0.5).tolist())
        for b in range(num_batches)
    ]


def stable_batches(seed, num_batches=4, markets=9, universe=12,
                   duplicates=False):
    """One (source, market) universe, new probabilities and outcomes each
    batch: the daily re-settlement shape plan reuse exists for."""
    rng = np.random.default_rng(seed)
    base = []
    for m in range(markets):
        sids = [f"src-{int(s)}"
                for s in rng.integers(0, universe, int(rng.integers(1, 5)))]
        if duplicates and len(sids) > 1:
            sids[-1] = sids[0]
        base.append((f"mkt-r{m}", sids))
    return [
        ([(market_id, [{"sourceId": sid,
                        "probability": float(np.round(rng.random(), 6))}
                       for sid in sids]) for market_id, sids in base],
         (rng.random(markets) < 0.5).tolist())
        for _ in range(num_batches)
    ]


def to_columns(payloads):
    keys, sources, probs, offsets = [], [], [], [0]
    for market_id, signals in payloads:
        keys.append(market_id)
        sources.extend(s["sourceId"] for s in signals)
        probs.extend(s["probability"] for s in signals)
        offsets.append(len(sources))
    return (keys, sources, np.asarray(probs, dtype=np.float64),
            np.asarray(offsets, dtype=np.int64))


def columnar(batches):
    return [(to_columns(payloads), outcomes) for payloads, outcomes in batches]


def records(store):
    return [(r.source_id, r.market_id, r.reliability, r.confidence,
             r.updated_at) for r in store.list_sources()]


def dump(path):
    with sqlite3.connect(path) as conn:
        lines = [" ".join(line.split()) if line.startswith("CREATE") else line
                 for line in conn.iterdump()]
    return lines


class Gated:
    """Batches the prefetch worker may take only as the consumer releases
    them: batch k after the stream yielded batch k-1 (so after its
    checkpoint). A journal epoch records the pairs interned when it is
    snapshotted, and an ungated worker interns the next batches' pairs
    while the current one settles, so without the gate the epochs' pair
    tables depend on thread timing — in either package."""

    def __init__(self, batches):
        self._batches = list(batches)
        self._released = threading.Semaphore(0)

    def __iter__(self):
        for index, batch in enumerate(self._batches):
            if index:
                self._released.acquire()
            yield batch

    def release(self):
        self._released.release()


def consume(stream, gate):
    results = []
    for result in stream:
        results.append(result)
        gate.release()
    return results


class Run:
    """One stream's outputs: store, consensus per batch, stats, files."""

    def __init__(self, store, consensus, stats, db, journal):
        self.store, self.consensus, self.stats = store, consensus, stats
        self.db, self.journal = db, journal


def run_stream(kind, batches, tmp, name, db=True, journal=False,
               python_route=False, **kw):
    """settle_stream on a fresh store of *kind* ("jax" or "torch"), with
    the wall clock pinned; the JAX side on its Python twins, the port on
    its C route unless *python_route*."""
    db_path = tmp / f"{name}.db" if db else None
    jrnl = tmp / f"{name}.jrnl" if journal else None
    stats = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: CLOCK)
        if kind == "jax":
            mp.setenv("BCE_NO_NATIVE", "1")
            store, pipe = JaxStore(), jpipe
        else:
            if python_route:
                mp.setenv("BCE_NO_NATIVE", "1")
            else:
                mp.delenv("BCE_NO_NATIVE", raising=False)
            store, pipe = cpu_store(), tpipe
        kw.setdefault("steps", 2)
        kw.setdefault("now", NOW)
        gate = Gated(batches)
        results = consume(pipe.settle_stream(
            store, gate, db_path=db_path, journal=jrnl, stats=stats, **kw),
            gate)
        store.sync()
    return Run(store, [np.asarray(r.consensus) for r in results], stats,
               db_path, jrnl)


def assert_same_stream(port, ref, bitwise=False):
    assert len(port.consensus) == len(ref.consensus)
    for mine, theirs in zip(port.consensus, ref.consensus):
        if bitwise:
            np.testing.assert_array_equal(mine, theirs)
        else:
            np.testing.assert_allclose(mine, theirs.astype(mine.dtype), **TOL)
    assert records(port.store) == records(ref.store)
    if port.db is not None:
        assert dump(port.db) == dump(ref.db)
    if port.journal is not None:
        assert port.journal.read_bytes() == ref.journal.read_bytes()


SCENARIOS = {
    # name: (batches, settle_stream keywords)
    "plain": (lambda: stream_batches(31), dict(journal=False)),
    "journal": (lambda: stream_batches(37), dict(journal=True,
                                                 checkpoint_every=2)),
    "sync_journal": (lambda: stream_batches(37), dict(
        journal=True, checkpoint_every=2, sync_checkpoints=True)),
    "every2": (lambda: stream_batches(41, num_batches=3), dict(
        journal=False, checkpoint_every=2, steps=1)),
    "columnar": (lambda: columnar(stream_batches(43, num_batches=3)), dict(
        journal=False, columnar=True)),
    "reuse": (lambda: stable_batches(23) + stable_batches(23, markets=10),
              dict(journal=True, reuse_plans=True, checkpoint_every=2)),
    "reuse_columnar": (lambda: columnar(stable_batches(29, duplicates=True)),
                       dict(journal=False, reuse_plans=True, columnar=True)),
    "full_intern": (lambda: stream_batches(47, num_batches=3), dict(
        journal=True, reuse_plans=True, intern_mode="full")),
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_streams")
    return {name: run_stream("jax", make(), tmp, name, **dict(kw))
            for name, (make, kw) in SCENARIOS.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_flat_stream_equals_jax(tmp_path, jax_runs, name):
    make, kw = SCENARIOS[name]
    port = run_stream("torch", make(), tmp_path, name, **dict(kw))
    ref = jax_runs[name]
    assert_same_stream(port, ref)
    assert [set(s) for s in port.stats] == [set(s) for s in ref.stats]
    for key in ("batch", "markets", "plan_reused", "session_adopt",
                "interned_pairs"):
        assert [s[key] for s in port.stats] == [s[key] for s in ref.stats]
    assert [s["checkpoint_s"] is None for s in port.stats] == [
        s["checkpoint_s"] is None for s in ref.stats]


def test_reuse_stats_hit_miss_pattern(jax_runs):
    assert [s["plan_reused"] for s in jax_runs["reuse"].stats] == [
        False, True, True, True, False, True, True, True]
    # A refreshed plan never interns; a drifted rebuild interns its delta.
    assert [s["interned_pairs"] == 0 for s in jax_runs["reuse"].stats] == [
        False, True, True, True, False, True, True, True]


def _serial(batches, db, steps=2, now=NOW, checkpoint_every=1):
    store = cpu_store()
    results = []
    for i, (payloads, outcomes) in enumerate(batches):
        plan = build_settlement_plan(store, payloads, num_slots="bucket")
        results.append(settle(store, plan, outcomes, steps=steps, now=now + i))
        if (i + 1) % checkpoint_every == 0:
            store.flush_to_sqlite(db)
    store.flush_to_sqlite(db)
    store.sync()
    return Run(store, [r.consensus for r in results], [], db, None)


@pytest.mark.parametrize("every", [1, 2])
def test_stream_equals_serial_loop(tmp_path, every):
    batches = stream_batches(53, num_batches=3)
    serial = _serial(batches, tmp_path / "serial.db", checkpoint_every=every)
    port = run_stream("torch", batches, tmp_path, "stream",
                      checkpoint_every=every)
    assert_same_stream(port, serial, bitwise=True)
    assert (tmp_path / "stream.db").read_bytes() == (
        tmp_path / "serial.db").read_bytes()


def test_columnar_batches_match_dict_batches(tmp_path):
    batches = stream_batches(59, num_batches=3, markets=8, universe=12)
    by_dict = run_stream("torch", batches, tmp_path, "dict")
    by_cols = run_stream("torch", columnar(batches), tmp_path, "cols",
                         columnar=True)
    assert_same_stream(by_cols, by_dict, bitwise=True)
    assert (tmp_path / "dict.db").read_bytes() == (
        tmp_path / "cols.db").read_bytes()


@pytest.mark.parametrize("case", ["stable", "duplicates", "columnar",
                                  "reordered_markets", "reordered_signals",
                                  "drift"])
def test_reuse_plans_bit_exact_with_rebuild(tmp_path, case):
    if case == "drift":
        batches = stable_batches(47, num_batches=2) + stable_batches(
            47, num_batches=2, markets=10)
        expected = [False, True, False, True]
    else:
        batches = stable_batches(61, duplicates=case == "duplicates")
        expected = [False, True, True, True]
    kw = {}
    if case == "columnar":
        batches, kw = columnar(batches), dict(columnar=True)
    if case == "reordered_markets":
        payloads, outcomes = batches[1]
        batches[1] = (payloads[::-1], outcomes[::-1])
        expected = [False, False, False, True]
    if case == "reordered_signals":
        # Batch 1 misses; batch 2 (the original order again) misses
        # against it.
        payloads, outcomes = batches[1]
        batches[1] = ([(m, signals[::-1]) for m, signals in payloads],
                      outcomes)
        expected = [False, False, False, True]
    off = run_stream("torch", batches, tmp_path, "off", checkpoint_every=2,
                     reuse_plans=False, **kw)
    on = run_stream("torch", batches, tmp_path, "on", checkpoint_every=2,
                    reuse_plans=True, **kw)
    assert_same_stream(on, off, bitwise=True)
    assert (tmp_path / "on.db").read_bytes() == (tmp_path / "off.db").read_bytes()
    assert [s["plan_reused"] for s in off.stats] == [False] * len(batches)
    assert [s["plan_reused"] for s in on.stats] == expected


def test_stats_reports_per_batch_timings(tmp_path):
    port = run_stream("torch", stream_batches(67, num_batches=3), tmp_path,
                      "s", steps=1, checkpoint_every=2)
    assert [s["batch"] for s in port.stats] == [0, 1, 2]
    assert [s["checkpoint_s"] is not None for s in port.stats] == [
        False, True, False]
    for entry in port.stats:
        assert entry["markets"] == 9 and entry["session_adopt"] is None
        assert entry["plan_wait_s"] >= 0 and entry["settle_dispatch_s"] >= 0
        assert "phases" not in entry  # no timeline recording


def test_no_db_means_no_flush():
    store = cpu_store()
    results = list(settle_stream(store, stream_batches(71, num_batches=2),
                                 now=NOW))
    assert len(results) == 2
    assert store._last_flush_path is None


def test_batch_error_propagates(tmp_path):
    good = stream_batches(73, num_batches=1)[0]
    bad = ([("dup", [{"sourceId": "s", "probability": 0.5}]),
            ("dup", [{"sourceId": "t", "probability": 0.5}])], [True, False])
    stream = settle_stream(cpu_store(), [good, bad], now=NOW,
                           db_path=tmp_path / "x.db")
    assert next(stream).market_keys == [k for k, _ in good[0]]
    with pytest.raises(ValueError, match="duplicate market ids"):
        next(stream)


def test_failed_background_flush_surfaces(tmp_path, monkeypatch):
    store = cpu_store()
    real_builder = store._build_snapshot_writer
    armed = {"once": True}

    def sometimes_broken(*args, **kwargs):
        if armed.pop("once", False):
            def writer():
                raise RuntimeError("checkpoint disk gone")

            return writer
        return real_builder(*args, **kwargs)

    monkeypatch.setattr(store, "_build_snapshot_writer", sometimes_broken)
    stream = settle_stream(store, stream_batches(79, num_batches=2), now=NOW,
                           db_path=tmp_path / "x.db")
    next(stream)  # batch 0 settles; its background flush is the broken one
    with pytest.raises(RuntimeError, match="checkpoint disk gone"):
        next(stream)  # batch 1's flush joins it and re-raises


def db_rows(path):
    with sqlite3.connect(path) as conn:
        return conn.execute(
            "SELECT source_id, market_id, reliability, confidence, updated_at"
            " FROM sources ORDER BY source_id, market_id").fetchall()


def test_early_break_still_tail_flushes_and_joins(tmp_path):
    batches = stream_batches(83)
    db = tmp_path / "stream.db"
    for i, _result in enumerate(settle_stream(
            cpu_store(), batches, steps=1, now=NOW, db_path=db,
            checkpoint_every=3)):
        if i == 1:
            break  # two batches settled, no periodic flush yet
    serial = _serial(batches[:2], tmp_path / "serial.db", steps=1)
    assert db_rows(db) == db_rows(serial.db)


@pytest.mark.parametrize("kwargs, message", [
    (dict(checkpoint_every=0), "checkpoint_every must be >= 1"),
    (dict(band=(0, 4)), "band= requires mesh="),
    (dict(journal="j.jrnl", lazy_checkpoints=True), "lazy_checkpoints"),
    (dict(mesh="m", band=(0, 4)), "globally-agreed integer num_slots"),
    (dict(trace="t.trace"), "pass columnar=True"),
])
def test_validation_messages_equal_jax(tmp_path, kwargs, message):
    errors = []
    for pipe, store in ((jpipe, JaxStore()), (tpipe, cpu_store())):
        kw = {k: str(tmp_path / v) if k in ("journal", "trace") else v
              for k, v in kwargs.items()}
        with pytest.raises(ValueError, match=message) as info:
            list(pipe.settle_stream(store, [], **kw))
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert not any(p.endswith(".jrnl") for p in os.listdir(tmp_path))


# -- PlanPrefetcher -------------------------------------------------------------


def _prefetch_batches(num_batches=4, markets=17):
    rng = np.random.default_rng(99)
    return [random_payloads(rng, markets, 40, tag=f"-b{b}")
            for b in range(num_batches)], [
        (rng.random(markets) < 0.5).tolist() for _ in range(num_batches)]


@pytest.mark.parametrize("mode", ["dict", "columnar", "reuse"])
def test_prefetched_plans_match_serial_and_jax(mode):
    payload_batches, outcome_batches = _prefetch_batches()
    items = ([to_columns(p) for p in payload_batches] if mode == "columnar"
             else payload_batches)
    kw = dict(columnar=mode == "columnar", reuse_plans=mode == "reuse")

    serial_store, jax_store, store = cpu_store(), JaxStore(), cpu_store()
    serial_results, results = [], []
    with PlanPrefetcher(store, items, **kw) as plans, \
            jpipe.PlanPrefetcher(jax_store, items, **kw) as jax_plans:
        for plan, jax_plan, payloads, outcomes in zip(
                plans, jax_plans, payload_batches, outcome_batches):
            serial_plan = build_settlement_plan(serial_store, payloads)
            for expect in (serial_plan, jax_plan):
                np.testing.assert_array_equal(plan.slot_rows, expect.slot_rows)
                np.testing.assert_array_equal(plan.probs, expect.probs)
                np.testing.assert_array_equal(plan.mask, expect.mask)
                assert plan.binding == expect.binding
            serial_results.append(settle(serial_store, serial_plan, outcomes,
                                         steps=2, now=NOW))
            results.append(settle(store, plan, outcomes, steps=2, now=NOW))
    for mine, ref in zip(results, serial_results):
        np.testing.assert_array_equal(mine.consensus, ref.consensus)
    store.sync()
    serial_store.sync()
    assert records(store) == records(serial_store)


def test_columnar_prefetch_matches_dict_builds():
    payload_batches, _ = _prefetch_batches(num_batches=2)
    dict_store, col_store = cpu_store(), cpu_store()
    expected = [build_settlement_plan(dict_store, p) for p in payload_batches]
    with PlanPrefetcher(col_store, [to_columns(p) for p in payload_batches],
                        columnar=True) as plans:
        for plan, expect in zip(plans, expected):
            np.testing.assert_array_equal(plan.slot_rows, expect.slot_rows)
            np.testing.assert_array_equal(plan.probs, expect.probs)
            assert plan.binding == expect.binding
    one_shot = build_settlement_plan_columnar(
        cpu_store(), *to_columns(payload_batches[0]))
    assert one_shot.binding == expected[0].binding


def test_build_error_raises_on_next():
    good = [("m-1", [{"sourceId": "s", "probability": 0.5}])]
    bad = [("dup", [{"sourceId": "s", "probability": 0.5}]),
           ("dup", [{"sourceId": "t", "probability": 0.5}])]
    with PlanPrefetcher(cpu_store(), [good, bad, good]) as plans:
        assert next(plans).market_keys == ["m-1"]
        with pytest.raises(ValueError, match="duplicate market ids"):
            next(plans)
        with pytest.raises(StopIteration):  # terminated; later batches dropped
            next(plans)


def test_iterator_error_surfaces_on_next():
    def batches():
        yield [("m-1", [{"sourceId": "s", "probability": 0.5}])]
        raise OSError("payload source gone")

    with PlanPrefetcher(cpu_store(), batches()) as plans:
        next(plans)
        with pytest.raises(OSError, match="payload source gone"):
            next(plans)


def test_close_mid_stream_joins_worker():
    rng = np.random.default_rng(1)
    batches = [random_payloads(rng, 5, tag=f"-c{b}") for b in range(50)]
    prefetcher = PlanPrefetcher(cpu_store(), batches, depth=1)
    next(prefetcher)
    prefetcher.close()
    assert not prefetcher._worker.is_alive()
    with pytest.raises(ValueError, match="depth"):
        PlanPrefetcher(cpu_store(), batches, depth=0)


def test_worker_builds_ahead_of_the_consumer():
    rng = np.random.default_rng(2)
    batches = [random_payloads(rng, 40, tag=f"-o{b}") for b in range(3)]
    with PlanPrefetcher(cpu_store(), batches, depth=2) as plans:
        next(plans)
        deadline = time.monotonic() + 30.0
        while plans._queue.empty() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not plans._queue.empty()
        assert plans._worker.name == "bce-plan-prefetch"
        assert plans._worker is not threading.current_thread()
