"""The port's resident session service ≡ the JAX package's, on the CPU.

``settle_stream(mesh=...)`` settles every batch through ONE long-lived
``ShardedSettlementSession``: a topology hit refreshes the probability
block, a miss adopts the new plan and re-lays the resident block out on
the device. The same seeded batches — two stable-topology batches, two
of a drifted topology overlapping them (rows staying, entering and
leaving) and one of fresh markets that grows the store — stream through
the JAX package on a (1, 1) and a (1, 4) mesh of CPU devices and through
the port on meshes of the same shapes (``make_mesh(shape, [cpu] * n)``),
with ``now`` fixed, the wall clock pinned and the prefetch worker gated
(see ``tests/test_torch_stream.py``). Then:

* ``stats[i]["session_adopt"]`` is the JAX package's,
  ``["start", "refresh", "relayout", "refresh", "relayout"]``;
* ``list_sources()``, the SQLite ``iterdump()`` and the journal files
  are equal (bit for bit and byte for byte), and each batch's consensus
  agrees within rtol=1e-5, atol=1e-6 (f32);
* within the port, the resident stream on the (1, 1) mesh equals the
  flat stream and the per-batch-session stream (``resident_session=
  False``) bit for bit — results, store, SQLite and journal bytes; on
  the sources-sharded (1, 4) mesh it stays within an ulp of the flat
  stream (consensus rtol=2e-6, atol=1e-7; reliability within 1e-6,
  confidences and stamps equal), the JAX package's envelope.

The session's ``refresh`` and ``adopt`` are also held against the JAX
session call by call — a hit, drift, rows re-entering behind an older
deferred recipe, growth of K and of M, a backdated entering stamp, and
an adopt before any settle: the same returned strings and a bit-equal
resident block after every settle. Port-only: the relayout never
rebuilds from the host, the adopt drops the resident binding before
anything that can raise, ``relayout_slot_state`` against a numpy gather,
the resident counters and the ``state_adopt`` phase, the crash resume
with a fresh session, and one session per batch under
``resident_session=False``.
"""

import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.parallel.mesh import make_mesh as jax_mesh
from bayesian_consensus_engine_tpu.state.records import (
    ReliabilityRecord as JaxRecord,
)
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import convert, obs
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_slot_block,
    unshard_slot_block,
)
from bayesian_consensus_engine_tpu_torch.parallel.sharded import (
    relayout_slot_state,
)
from bayesian_consensus_engine_tpu_torch.state.journal import (
    JournalWriter,
    replay_journal,
)
from bayesian_consensus_engine_tpu_torch.state.records import ReliabilityRecord
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)
from test_torch_stream import (
    NOW,
    TOL,
    assert_same_stream,
    cpu_store,
    dump,
    random_payloads,
    records,
    run_stream,
    stable_batches,
    to_columns,
)

CPU = torch.device("cpu")
SHAPES = {"1x1": (1, 1), "1x4": (1, 4)}
ADOPTS = ["start", "refresh", "relayout", "refresh", "relayout"]


def mixed_batches():
    """Hits, drift and growth in one stream."""
    stable = stable_batches(47, num_batches=2)
    drifted = stable_batches(47, num_batches=2, markets=40, universe=30)
    rng = np.random.default_rng(5)
    growth = [(random_payloads(rng, 60, universe=40, tag="-grow"),
               (rng.random(60) < 0.5).tolist())]
    return stable + drifted + growth


def port_mesh(shape):
    return make_mesh(shape, [CPU] * (shape[0] * shape[1]))


def stream_kw(journal=True):
    return dict(journal=journal, checkpoint_every=2, reuse_plans=True)


@pytest.fixture(scope="module")
def jax_resident(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_resident")
    return {
        name: run_stream(
            "jax", mixed_batches(), tmp, name,
            mesh=jax_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]]),
            **stream_kw())
        for name, shape in SHAPES.items()
    }


@pytest.fixture(scope="module")
def port_flat(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_flat")
    return run_stream("torch", mixed_batches(), tmp, "flat", **stream_kw())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_resident_stream_equals_jax(tmp_path, jax_resident, name):
    port = run_stream("torch", mixed_batches(), tmp_path, name,
                      mesh=port_mesh(SHAPES[name]), **stream_kw())
    ref = jax_resident[name]
    assert [s["session_adopt"] for s in port.stats] == ADOPTS
    assert [s["session_adopt"] for s in ref.stats] == ADOPTS
    assert [s["plan_reused"] for s in port.stats] == [
        s["plan_reused"] for s in ref.stats]
    assert_same_stream(port, ref)


def test_resident_and_per_batch_equal_flat_bitwise(tmp_path, port_flat):
    mesh = port_mesh((1, 1))
    resident = run_stream("torch", mixed_batches(), tmp_path, "on",
                          mesh=mesh, **stream_kw())
    per_batch = run_stream("torch", mixed_batches(), tmp_path, "off",
                           mesh=mesh, resident_session=False, **stream_kw())
    assert [s["session_adopt"] for s in per_batch.stats] == [None] * 5
    for run in (resident, per_batch):
        assert_same_stream(run, port_flat, bitwise=True)
        assert run.db.read_bytes() == port_flat.db.read_bytes()


def test_sources_sharded_stream_within_an_ulp_of_flat(tmp_path, port_flat):
    sharded = run_stream("torch", mixed_batches(), tmp_path, "2d",
                         mesh=port_mesh((1, 4)), **stream_kw(journal=False))
    for mine, ref in zip(sharded.consensus, port_flat.consensus):
        np.testing.assert_allclose(mine, ref, rtol=2e-6, atol=1e-7)
    mine, theirs = sharded.store.list_sources(), port_flat.store.list_sources()
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert (a.source_id, a.market_id) == (b.source_id, b.market_id)
        assert abs(a.reliability - b.reliability) < 1e-6
        assert a.confidence == b.confidence
        assert a.updated_at == b.updated_at


def test_relayout_never_rebuilds_from_host(tmp_path, monkeypatch):
    """The drift batches are served by the device relayout: the state is
    built from the host once (batch 0), and afterwards the host is read
    only for rows entering the active set."""
    builds, reads = [], []
    real_build = tpipe.ShardedSettlementSession._build_state
    real_rows = TensorReliabilityStore.host_rows

    def counting_build(self, epoch0):
        builds.append(epoch0)
        return real_build(self, epoch0)

    def counting_rows(self, rows, sync=True):
        reads.append((len(builds), np.asarray(rows).size))
        return real_rows(self, rows, sync=sync)

    monkeypatch.setattr(tpipe.ShardedSettlementSession, "_build_state",
                        counting_build)
    monkeypatch.setattr(TensorReliabilityStore, "host_rows", counting_rows)
    port = run_stream("torch", mixed_batches(), tmp_path, "count",
                      mesh=port_mesh((1, 1)), **stream_kw(journal=False))
    assert len(builds) == 1
    assert [s["session_adopt"] for s in port.stats] == ADOPTS
    after_start = [size for built, size in reads if built]
    # The drifted batch touches every row of the stable topology again; a
    # rebuild would read them all, the relayout only the entering ones.
    drifted = tpipe.build_settlement_plan(cpu_store(), mixed_batches()[2][0])
    growth = tpipe.build_settlement_plan(cpu_store(), mixed_batches()[4][0])
    assert sum(after_start[1:]) < int(drifted.mask.sum() + growth.mask.sum())


def test_resident_counters_gauges_and_adopt_phase(tmp_path):
    registry = obs.MetricsRegistry()
    previous = obs.set_metrics_registry(registry)
    timeline = obs.PhaseTimeline()
    try:
        with obs.recording(timeline):
            port = run_stream("torch", mixed_batches(), tmp_path, "obs",
                              mesh=port_mesh((1, 1)),
                              **stream_kw(journal=False))
    finally:
        obs.set_metrics_registry(previous)
    export = registry.export()
    assert export["counters"]["stream.session_adopts"] == 2
    assert export["counters"]["stream.resident_fallbacks"] == 0
    assert export["gauges"]["stream.resident_rows"] > 0
    assert export["gauges"]["hbm.bytes_in_use"] == 0  # the CPU has no stats
    adopted = [s["session_adopt"] == "relayout" for s in port.stats]
    assert ["state_adopt" in s["phases"] for s in port.stats] == adopted
    assert timeline.totals()["state_adopt"] > 0.0


def test_crash_resume_with_fresh_session(tmp_path, monkeypatch, port_flat):
    """A failing journal epoch kills the resident stream; restarting from
    ``batches[len(stats):]`` with a fresh session on the same store ends
    where the uninterrupted run ends, and the journal replays to it."""
    batches = mixed_batches()
    mesh = port_mesh((1, 1))
    store = cpu_store()
    jrnl = tmp_path / "crash.jrnl"
    real_flush = TensorReliabilityStore.flush_to_journal_async
    calls = {"n": 0}

    def broken_second(self, journal, tag=0):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("journal disk gone")
        return real_flush(self, journal, tag=tag)

    monkeypatch.setattr(TensorReliabilityStore, "flush_to_journal_async",
                        broken_second)
    stats = []
    writer = JournalWriter(jrnl)
    with pytest.raises(RuntimeError, match="journal disk gone"):
        for _result in tpipe.settle_stream(
                store, batches, steps=2, now=NOW, checkpoint_every=2,
                stats=stats, reuse_plans=True, mesh=mesh, journal=writer):
            pass
    writer.close()
    monkeypatch.setattr(TensorReliabilityStore, "flush_to_journal_async",
                        real_flush)
    settled = len(stats)
    assert 0 < settled < len(batches)
    resume_stats = []
    for _result in tpipe.settle_stream(
            store, batches[settled:], steps=2, now=NOW + settled,
            checkpoint_every=2, stats=resume_stats, reuse_plans=True,
            mesh=mesh, journal=JournalWriter(jrnl, resume=True)):
        pass
    store.sync()
    assert resume_stats[0]["session_adopt"] == "start"
    assert records(store) == records(port_flat.store)
    replayed, _tag = replay_journal(jrnl, device="cpu")
    replayed.sync()
    assert records(replayed) == records(store)
    store.flush_to_sqlite(tmp_path / "resumed.db")
    port_flat.store.flush_to_sqlite(tmp_path / "reference.db")
    assert (tmp_path / "resumed.db").read_bytes() == (
        tmp_path / "reference.db").read_bytes()


def test_per_batch_flag_builds_a_session_per_batch(tmp_path):
    batches = mixed_batches()[:3]
    builds = []
    real_init = tpipe.ShardedSettlementSession.__init__

    def counting_init(self, *args, **kwargs):
        builds.append(1)
        return real_init(self, *args, **kwargs)

    with mock.patch.object(tpipe.ShardedSettlementSession, "__init__",
                           counting_init):
        run_stream("torch", batches, tmp_path, "ab", mesh=port_mesh((1, 1)),
                   resident_session=False, **stream_kw(journal=False))
    assert len(builds) == len(batches)


def test_gated_resident_journal_equals_ungated_replay(tmp_path):
    """Without the gate the epochs' pair tables may differ by timing, but
    the journal still replays to the live store."""
    store = cpu_store()
    jrnl = tmp_path / "free.jrnl"
    list(tpipe.settle_stream(store, mixed_batches(), steps=2, now=NOW,
                             mesh=port_mesh((1, 1)), journal=jrnl,
                             **{k: v for k, v in stream_kw().items()
                                if k != "journal"}))
    store.sync()
    replayed, tag = replay_journal(jrnl, device="cpu")
    replayed.sync()
    assert tag == 4 and records(replayed) == records(store)


# -- refresh and adopt, call by call ------------------------------------------


def _batch(seed, markets, universe, tag):
    rng = np.random.default_rng(seed)
    return (random_payloads(rng, markets, universe, tag=tag),
            (rng.random(markets) < 0.5).tolist())


def adopt_script():
    """(label, payloads, outcomes, how): ``how`` is "refresh" (the next
    probabilities of the same topology), "adopt" or "settle"."""
    a = _batch(1, 12, 10, "-a")
    b = _batch(2, 14, 10, "-b")  # fresh markets: A's rows leave
    wide = _batch(3, 30, 25, "-w")  # more markets and more slots
    rng = np.random.default_rng(4)
    a_again = ([(m, [dict(s, probability=float(np.round(rng.random(), 6)))
                     for s in signals]) for m, signals in a[0]],
               (rng.random(12) < 0.5).tolist())
    mixed = (a[0][:6] + b[0][:7] + wide[0][:5],
             (rng.random(18) < 0.5).tolist())
    return [
        ("start", *a, "settle"),
        ("hit", *a_again, "refresh"),
        ("drift", *b, "adopt"),
        ("re-enter", *a, "adopt"),
        ("grow", *wide, "adopt"),
        ("mixed", *mixed, "adopt"),
    ]


class SessionSide:
    def __init__(self, kind, shape):
        self.kind, self.shape = kind, shape
        if kind == "jax":
            self.store, self.pipe = JaxStore(), jpipe
            self.mesh = jax_mesh(shape,
                                 devices=jax.devices()[: shape[0] * shape[1]])
        else:
            self.store, self.pipe = cpu_store(), tpipe
            self.mesh = port_mesh(shape)
        self.session = None
        self.plan = None

    def build(self, payloads):
        keys, sids, probs, offsets = to_columns(payloads)
        return self.pipe.build_settlement_plan_columnar(
            self.store, keys, sids, probs, offsets, num_slots="bucket",
            fingerprint=True)

    def step(self, payloads, how):
        if how == "refresh":
            plan = self.plan.refresh(to_columns(payloads)[2])
            served = self.session.adopt(plan)
        elif self.session is None:
            plan = self.build(payloads)
            self.session = self.pipe.ShardedSettlementSession(
                self.store, plan, self.mesh)
            served = "start"
        else:
            plan = self.build(payloads)
            served = self.session.adopt(plan)
        self.plan = plan
        return served

    def settle(self, outcomes, now):
        result = self.session.settle(outcomes, steps=2, now=now)
        return np.asarray(result.consensus)

    def block(self):
        state = self.session._state
        if self.kind == "jax":
            return tuple(np.asarray(x) for x in state)
        return tuple(convert.sharded_block_to_numpy(state))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_refresh_and_adopt_match_jax_session(tmp_path, monkeypatch, shape):
    sides = [SessionSide("jax", SHAPES[shape]),
             SessionSide("torch", SHAPES[shape])]
    served_log = []
    for step, (label, payloads, outcomes, how) in enumerate(adopt_script()):
        served = [side.step(payloads, how) for side in sides]
        assert served[0] == served[1], label
        served_log.append(served[1])
        consensus = [side.settle(outcomes, NOW + 2 * step) for side in sides]
        np.testing.assert_allclose(consensus[1], consensus[0], **TOL,
                                   err_msg=label)
        for name, got, want in zip(
                ("reliability", "confidence", "updated_days", "exists"),
                sides[1].block(), sides[0].block()):
            np.testing.assert_array_equal(got, want, err_msg=f"{label} {name}")
    assert served_log == ["start", "refresh", "relayout", "relayout",
                          "relayout", "relayout"]
    monkeypatch.setenv("BCE_NO_NATIVE", "1")
    dumps = []
    for side in sides:
        side.session.close()
        path = tmp_path / f"{side.kind}.db"
        side.store.flush_to_sqlite(path)
        dumps.append(dump(path))
    assert records(sides[1].store) == records(sides[0].store)
    assert dumps[0] == dumps[1]


def test_adopt_rebuild_reasons_match_jax():
    """Before any settle an adopt has nothing to carry; an entering row
    stamped at or before the session epoch cannot be re-expressed."""
    reasons = []
    for kind, record in (("jax", JaxRecord), ("torch", ReliabilityRecord)):
        side = SessionSide(kind, (1, 1))
        # A live stamp before the session starts sets its epoch near it.
        side.store.put_record(record(
            source_id="seed-src", market_id="seed-mkt", reliability=0.6,
            confidence=0.3, updated_at="2026-07-10T00:00:00+00:00"))
        first, second = _batch(7, 6, 8, "-r1"), _batch(8, 6, 8, "-r2")
        side.step(first[0], "settle")
        got = [side.step(second[0], "adopt")]  # no resident state yet
        side.settle(second[1], NOW)
        market, signals = first[0][0]
        side.store.put_record(record(
            source_id=signals[0]["sourceId"], market_id=market,
            reliability=0.8, confidence=0.4,
            updated_at="2020-01-01T00:00:00+00:00"))
        got.append(side.step(first[0], "adopt"))
        consensus = side.settle(first[1], NOW + 1)
        side.session.close()
        reasons.append((got, consensus, records(side.store)))
    assert reasons[0][0] == reasons[1][0] == [
        "rebuild:no-resident-state", "rebuild:backdated-stamps"]
    np.testing.assert_allclose(reasons[1][1], reasons[0][1], **TOL)
    assert reasons[1][2] == reasons[0][2]


def test_refresh_refuses_a_foreign_plan_as_jax_does():
    messages = []
    for kind in ("jax", "torch"):
        side = SessionSide(kind, (1, 1))
        side.step(_batch(9, 5, 6, "-f1")[0], "settle")
        other = side.build(_batch(10, 5, 6, "-f2")[0])
        with pytest.raises(ValueError, match="probability-only twin") as info:
            side.session.refresh(other)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_adopt_band_raises_until_process_bands_are_ported():
    """Process bands are ported: adopting a plan under another band than
    the session's is a re-partition of the axis, served as the JAX package
    serves it (``rebuild:band-change``, no raise), and the next settle
    rebuilds to the JAX session's consensus."""
    served, consensus = [], []
    for kind in ("jax", "torch"):
        side = SessionSide(kind, (1, 1))
        side.step(_batch(11, 5, 6, "-b1")[0], "settle")
        side.settle(_batch(11, 5, 6, "-b1")[1], NOW)
        payloads, outcomes = _batch(12, 5, 6, "-b2")
        served.append(side.session.adopt(side.build(payloads), band=(0, 5)))
        consensus.append(side.settle(outcomes, NOW + 1))
    assert served == ["rebuild:band-change"] * 2
    np.testing.assert_array_equal(consensus[0], consensus[1])


def test_adopt_drops_the_resident_binding_before_it_can_raise(monkeypatch):
    """A failure inside the adopt leaves the rebuild posture, never the old
    block bound to the new plan: a retried settle rebuilds from the host
    and equals a fresh session's."""
    side = SessionSide("torch", (1, 1))
    first, second = _batch(13, 10, 8, "-x1"), _batch(14, 10, 8, "-x2")
    side.step(first[0], "settle")
    side.settle(first[1], NOW)
    plan = side.build(second[0])

    def broken(*_args, **_kwargs):
        raise RuntimeError("host read failed")

    with monkeypatch.context() as mp:
        mp.setattr(side.store, "host_rows", broken)
        with pytest.raises(RuntimeError, match="host read failed"):
            side.session.adopt(plan)
    assert side.session._state is None and side.session._plan is plan
    retried = side.settle(second[1], NOW + 2)

    fresh = SessionSide("torch", (1, 1))
    fresh.step(first[0], "settle")
    fresh.settle(first[1], NOW)
    fresh.session.close()
    fresh.session = None
    fresh.step(second[0], "settle")
    np.testing.assert_array_equal(retried, fresh.settle(second[1], NOW + 2))
    side.session.close()
    fresh.session.close()
    assert records(side.store) == records(fresh.store)


@pytest.mark.parametrize("shape", [(1, 1), (1, 4), (2, 2)])
def test_relayout_slot_state_against_numpy(shape):
    """The gather crosses the shards of the mesh; the old reliability
    blocks are left as they were (a standing recipe may read them)."""
    rng = np.random.default_rng(17)
    old_k, old_m, new_k, new_m = 8, 6, 12, 10
    old = [rng.random((old_k, old_m)).astype(np.float32) for _ in range(3)]
    old.append(rng.random((old_k, old_m)) < 0.5)
    mesh = port_mesh(shape)
    pieces = [shard_slot_block(field, mesh) for field in old]
    grid = tuple(
        tuple(MarketBlockState(*(p[i][j] for p in pieces))
              for j in range(shape[1]))
        for i in range(shape[0]))
    old_rel = [[shard.reliability.clone() for shard in row] for row in grid]
    src = np.full(new_k * new_m, -1, dtype=np.int64)
    carried = rng.choice(new_k * new_m, 30, replace=False)
    src[carried] = rng.choice(old_k * old_m, 30, replace=False)
    free = np.setdiff1d(np.arange(new_k * new_m), carried)
    enter = rng.choice(free, 9, replace=False)
    entered = [rng.random(9).astype(np.float32) for _ in range(3)]
    entered.append(rng.random(9) < 0.5)
    relaid = relayout_slot_state(grid, src, enter, *entered, (new_k, new_m),
                                 mesh=mesh)
    for f, (fill, field, values) in enumerate(zip(
            (0.5, 0.25, 0.0, False), old, entered)):
        want = np.full(new_k * new_m, fill, dtype=field.dtype)
        want[carried] = field.ravel()[src[carried]]
        want[enter] = values
        got = unshard_slot_block(
            tuple(tuple(shard[f] for shard in row) for row in relaid), CPU)
        np.testing.assert_array_equal(got.numpy().ravel(), want)
        assert relaid[0][0][f].device == mesh.devices[0][0]
    for row, before in zip(grid, old_rel):
        for shard, saved in zip(row, before):
            assert torch.equal(shard.reliability, saved)

