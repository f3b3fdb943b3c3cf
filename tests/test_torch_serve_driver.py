"""The port's serve driver ≡ the JAX package's, on the CPU.

``SessionDriver`` is ``settle_stream``'s loop body as an API (dispatch,
the checkpoint cadence, the exit contract), ``PlanCache`` the stream's
plan-reuse step for caller-scheduled builds, and ``drive_trace`` the
re-drive of a recorded trace through both. The same seeded columnar
batches go through the JAX package's and the port's objects on the CPU
(the port on ``device="cpu"`` stores and a (1, 1) CPU mesh), the wall
clock pinned, ``now`` fixed:

* a driver fed plans by a ``PlanCache`` equals ``settle_stream`` over the
  same batches (gated, see ``tests/test_torch_stream.py``) in store,
  journal bytes and SQLite bytes, flat and resident, and equals the JAX
  driver (journal bytes, SQLite ``iterdump()``, ``list_sources()``; the
  consensus within rtol=1e-5, atol=1e-6 (f32)), with the same reuse
  decisions, adopt strings and durability watermarks;
* after a failed journal write ``finalize`` surfaces the original error
  and writes no tail epoch (the journal's durable point is the last epoch
  that landed), and still tail-flushes SQLite;
* ``drive_trace`` of a traced stream rebuilds the recorded store: the
  same records, SQLite bytes and journal bytes, flat and resident, and
  the JAX package's ``drive_trace`` of the port's trace file rebuilds the
  same records;
* ``analytics=`` moves no settlement byte: consensus, SQLite and journal
  bytes are bit-equal on and off, and the bands it adds agree with the
  JAX driver's within rtol=1e-5, atol=1e-3 (the band stderr cancels, see
  ``tests/test_torch_analytics_math.py``).
"""

import jax
import numpy as np
import pytest

from bayesian_consensus_engine_tpu import analytics as janalytics
from bayesian_consensus_engine_tpu.parallel.mesh import make_mesh as jax_mesh
from bayesian_consensus_engine_tpu.serve import driver as jdriver
from bayesian_consensus_engine_tpu.state import journal as jjournal
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import analytics as tanalytics
from bayesian_consensus_engine_tpu_torch.parallel.mesh import make_mesh
from bayesian_consensus_engine_tpu_torch.pipeline import PlanPrefetcher
from bayesian_consensus_engine_tpu_torch.serve import driver as tdriver
from bayesian_consensus_engine_tpu_torch.state import journal as tjournal
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)
from test_torch_stream import (
    CLOCK,
    NOW,
    TOL,
    columnar,
    cpu_store,
    dump,
    random_payloads,
    records,
    run_stream,
    stable_batches,
)

ANALYTICS_TOL = dict(rtol=1e-5, atol=1e-3)


def serve_batches():
    """A steady round, its probabilities again, a drifted round, that
    again, and fresh markets: hits, misses and growth."""
    steady = stable_batches(3, num_batches=2, markets=12, universe=10)
    drifted = stable_batches(4, num_batches=2, markets=16, universe=14)
    rng = np.random.default_rng(6)
    fresh = [(random_payloads(rng, 20, 18, tag="-fresh"),
              (rng.random(20) < 0.5).tolist())]
    return columnar(steady + drifted + fresh)


def side_objects(kind, mesh_shape):
    if kind == "jax":
        mesh = (jax_mesh(mesh_shape, devices=jax.devices()[:1])
                if mesh_shape else None)
        return JaxStore(), jdriver, jjournal, mesh
    mesh = make_mesh(mesh_shape, ["cpu"]) if mesh_shape else None
    return cpu_store(), tdriver, tjournal, mesh


def manual_drive(kind, batches, tmp, name, mesh_shape=None, analytics=None,
                 monkeypatch=None):
    """Drive *batches* through a SessionDriver fed by a PlanCache, journal
    and SQLite on a checkpoint cadence of 2. Returns (store, consensus,
    adopts, reuse flags, watermarks, analytics)."""
    store, driver_mod, journal_mod, mesh = side_objects(kind, mesh_shape)
    kw = {} if analytics is None else dict(analytics=analytics)
    driver = driver_mod.SessionDriver(
        store, steps=2, mesh=mesh,
        journal=journal_mod.JournalWriter(tmp / f"{name}.jrnl"),
        owns_journal=True, db_path=tmp / f"{name}.db", checkpoint_every=2,
        **kw)
    plans = driver_mod.PlanCache(store)
    consensus, adopts, reused, marks, tiers = [], [], [], [], []
    try:
        for index, ((keys, sids, probs, offsets), outcomes) in enumerate(
                batches):
            plan = plans.plan_for(keys, sids, probs, offsets)
            reused.append(getattr(plan, "_refreshed_from", None) is not None)
            result = driver.dispatch(plan, outcomes, now=NOW + index)
            consensus.append(np.asarray(result.consensus))
            adopts.append(driver.last_adopt)
            tiers.append(driver.last_analytics)
            driver.checkpoint(index)
            marks.append(driver.durable_through)
    finally:
        driver.finalize()
    marks.append(driver.durable_through)
    store.sync()
    return store, consensus, adopts, reused, marks, tiers


@pytest.fixture
def pinned(monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: CLOCK)
    return monkeypatch


@pytest.mark.parametrize("mesh_shape", [None, (1, 1)])
def test_manual_drive_equals_stream_and_jax(tmp_path, pinned, mesh_shape):
    batches = serve_batches()
    port = manual_drive("torch", batches, tmp_path, "port", mesh_shape)
    pinned.setenv("BCE_NO_NATIVE", "1")
    ref = manual_drive("jax", batches, tmp_path, "jax", mesh_shape)
    pinned.delenv("BCE_NO_NATIVE")
    stream = run_stream(
        "torch", batches, tmp_path, "stream", journal=True, columnar=True,
        reuse_plans=True, checkpoint_every=2,
        mesh=make_mesh(mesh_shape, ["cpu"]) if mesh_shape else None)
    # The driver IS the stream's loop body: the same bytes.
    assert records(port[0]) == records(stream.store)
    assert (tmp_path / "port.jrnl").read_bytes() == stream.journal.read_bytes()
    assert (tmp_path / "port.db").read_bytes() == stream.db.read_bytes()
    for mine, theirs in zip(port[1], stream.consensus):
        np.testing.assert_array_equal(mine, theirs)
    assert port[2] == [s["session_adopt"] for s in stream.stats]
    assert port[3] == [s["plan_reused"] for s in stream.stats]
    # ...and the JAX package's driver.
    assert records(port[0]) == records(ref[0])
    assert (tmp_path / "port.jrnl").read_bytes() == (
        tmp_path / "jax.jrnl").read_bytes()
    assert dump(tmp_path / "port.db") == dump(tmp_path / "jax.db")
    for mine, theirs in zip(port[1], ref[1]):
        np.testing.assert_allclose(mine, theirs, **TOL)
    assert port[2:5] == ref[2:5]
    assert port[3] == [False, True, False, True, False]
    if mesh_shape:
        assert port[2] == ["start", "refresh", "relayout", "refresh",
                           "relayout"]
    # Async epochs: a checkpoint makes the previous cadence durable, and
    # finalize the last.
    assert port[4] == [-1, -1, -1, 1, 1, 4]


def test_plan_cache_makes_the_prefetchers_decisions():
    batches = [payload for payload, _ in serve_batches()]
    cache_store, prefetch_store = cpu_store(), cpu_store()
    cache = tdriver.PlanCache(cache_store)
    with PlanPrefetcher(prefetch_store, batches, columnar=True,
                        num_slots="bucket", reuse_plans=True) as plans:
        for columns, prefetched in zip(batches, plans):
            staged = cache.stage(*columns)
            plan = cache.bind(staged)
            assert plan is cache.last_plan
            assert (getattr(plan, "_refreshed_from", None) is not None) == (
                getattr(prefetched, "_refreshed_from", None) is not None)
            np.testing.assert_array_equal(plan.slot_rows, prefetched.slot_rows)
            np.testing.assert_array_equal(plan.probs, prefetched.probs)
            assert plan.binding == prefetched.binding
            assert plan.fingerprint == prefetched.fingerprint


@pytest.mark.parametrize("kwargs, message", [
    (dict(checkpoint_every=0), "checkpoint_every must be >= 1"),
    (dict(lazy_checkpoints=True, journal=object()), "lazy_checkpoints"),
    (dict(analytics=True), "needs the resident sharded session"),
    (dict(analytics="bands", mesh="m"), "takes True, an AnalyticsOptions"),
])
def test_driver_validates_like_jax(kwargs, message):
    errors = []
    for store, module in ((JaxStore(), jdriver), (cpu_store(), tdriver)):
        with pytest.raises((ValueError, TypeError), match=message) as info:
            module.SessionDriver(store, **kwargs)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_finalize_after_failed_journal_write_keeps_the_original_error(
        tmp_path, monkeypatch):
    """The second epoch's write fails: the error reaches the caller
    through ``finalize``, no tail epoch is tried (a retry would raise
    again and replace it), the journal's durable point is the first epoch,
    and SQLite still gets the tail flush of every settled batch."""
    batches = serve_batches()
    store = cpu_store()
    real_async = TensorReliabilityStore.flush_to_journal_async
    calls = {"async": 0, "tail": 0}

    def broken_second(self, journal, tag=0):
        calls["async"] += 1
        if calls["async"] == 2:
            raise RuntimeError("journal disk gone")
        return real_async(self, journal, tag=tag)

    def tail(self, journal, tag=0):
        calls["tail"] += 1
        raise RuntimeError("tail epoch retried")

    monkeypatch.setattr(TensorReliabilityStore, "flush_to_journal_async",
                        broken_second)
    monkeypatch.setattr(TensorReliabilityStore, "flush_to_journal", tail)
    writer = tjournal.JournalWriter(tmp_path / "f.jrnl")
    driver = tdriver.SessionDriver(
        store, steps=2, journal=writer, db_path=tmp_path / "f.db",
        checkpoint_every=2)
    plans = tdriver.PlanCache(store)
    settled = 0
    with pytest.raises(RuntimeError, match="journal disk gone"):
        try:
            for index, (columns, outcomes) in enumerate(batches):
                driver.dispatch(plans.plan_for(*columns), outcomes,
                                now=NOW + index)
                settled += 1
                driver.checkpoint(index)
        finally:
            driver.finalize()
    assert settled == 4 and calls == {"async": 2, "tail": 0}
    assert driver.settled_through == 3 and driver.durable_through == -1
    store.close()  # joins the first epoch's write
    writer.close()
    replayed, tag = tjournal.replay_journal(tmp_path / "f.jrnl", device="cpu")
    assert tag == 1
    store.sync()
    assert len(store.list_sources()) > len(replayed.list_sources()) > 0
    reference = cpu_store()
    for index, (columns, outcomes) in enumerate(batches[:4]):
        tdriver.SessionDriver(reference, steps=2).dispatch(
            tdriver.PlanCache(reference).plan_for(*columns), outcomes,
            now=NOW + index)
    reference.flush_to_sqlite(tmp_path / "r.db")
    assert dump(tmp_path / "f.db") == dump(tmp_path / "r.db")


@pytest.mark.parametrize("mesh_shape", [None, (1, 1)])
def test_drive_trace_rebuilds_the_traced_stream(tmp_path, pinned, mesh_shape):
    batches = serve_batches()
    mesh = make_mesh(mesh_shape, ["cpu"]) if mesh_shape else None
    live = run_stream("torch", batches, tmp_path, "live", journal=True,
                      columnar=True, reuse_plans=True, checkpoint_every=2,
                      mesh=mesh, trace=tmp_path / "live.trace")
    trace = tjournal.read_trace(tmp_path / "live.trace", strict=True)
    assert [b.index for b in trace] == list(range(len(batches)))
    redriven = cpu_store()
    results = tdriver.drive_trace(
        redriven, trace, mesh=mesh, journal=tmp_path / "again.jrnl",
        db_path=tmp_path / "again.db", checkpoint_every=2)
    redriven.sync()
    assert records(redriven) == records(live.store)
    assert (tmp_path / "again.db").read_bytes() == live.db.read_bytes()
    assert (tmp_path / "again.jrnl").read_bytes() == live.journal.read_bytes()
    for mine, theirs in zip(results, live.consensus):
        np.testing.assert_array_equal(np.asarray(mine.consensus), theirs)
    # The JAX package re-drives the port's trace file to the same records.
    pinned.setenv("BCE_NO_NATIVE", "1")
    jax_store = JaxStore()
    jdriver.drive_trace(jax_store, jjournal.read_trace(tmp_path / "live.trace"))
    jax_store.sync()
    assert records(jax_store) == records(live.store)


def test_drive_trace_edge_cases(tmp_path):
    assert tdriver.drive_trace(cpu_store(), []) == []
    batches = serve_batches()[:2]
    with tjournal.TraceWriter(tmp_path / "mixed.trace") as writer:
        for index, ((keys, sids, probs, offsets), outcomes) in enumerate(
                batches):
            writer.append_batch(keys, sids, probs, offsets, outcomes,
                                now_days=NOW + index, steps=1 + index)
    with pytest.raises(ValueError, match="mixes step counts"):
        tdriver.drive_trace(cpu_store(),
                            tjournal.read_trace(tmp_path / "mixed.trace"))


def test_analytics_moves_no_settlement_byte(tmp_path, pinned):
    batches = serve_batches()
    off = manual_drive("torch", batches, tmp_path, "off", (1, 1))
    on = manual_drive("torch", batches, tmp_path, "on", (1, 1),
                      analytics=True)
    full = manual_drive("torch", batches, tmp_path, "full", (1, 1),
                        analytics=tanalytics.AnalyticsOptions(tiebreak=True))
    for run, name in ((on, "on"), (full, "full")):
        for mine, ref in zip(run[1], off[1]):
            np.testing.assert_array_equal(mine, ref)
        assert records(run[0]) == records(off[0])
        assert (tmp_path / f"{name}.db").read_bytes() == (
            tmp_path / "off.db").read_bytes()
        assert (tmp_path / f"{name}.jrnl").read_bytes() == (
            tmp_path / "off.jrnl").read_bytes()
    assert all(tier is None for tier in off[5])
    assert all(tier[0] is None and tier[2] is None for tier in on[5])
    assert all(tier[0] is not None for tier in full[5])
    pinned.setenv("BCE_NO_NATIVE", "1")
    ref = manual_drive("jax", batches, tmp_path, "jax_on", (1, 1),
                       analytics=janalytics.AnalyticsOptions(tiebreak=False))
    for (_tb, bands, _p), (_jtb, jbands, _jp) in zip(on[5], ref[5]):
        for got, want in zip(bands, jbands):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       **ANALYTICS_TOL)
    assert records(on[0]) == records(ref[0])
