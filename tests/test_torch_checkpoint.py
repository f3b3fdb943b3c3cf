"""Snapshot and resume of the resident cycle state: the port's
``state/checkpoint.CycleCheckpointer`` and the store's
``save_checkpoint`` / ``load_checkpoint``, the counterparts of the JAX
package's ``tests/test_checkpoint.py`` and of ``tests/test_compact.py``'s
round trip.

The contract is the reference's durability test (write, reopen, read
back): snapshot the state mid-loop, "crash", restore, and the continued
run equals an uninterrupted one bit for bit. Each resume is also held
against the JAX package's uninterrupted run on the same inputs: the state
bit-equal, the consensus within rtol 1e-5, atol 1e-6 (``exp2`` and the
slot sums' order, as in ``tests/test_torch_pipeline.py``); a store
resumed from a checkpoint writes the SQLite bytes of the JAX package's
uninterrupted chain (both on the sqlite3 module: ``BCE_NO_NATIVE=1``).
A kill is a ``del`` of the session and store, as in the reference.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu import parallel as jpar
from bayesian_consensus_engine_tpu.parallel import compact as jcompact
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import parallel as tpar
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
from bayesian_consensus_engine_tpu_torch.parallel import compact as tcompact
from bayesian_consensus_engine_tpu_torch.parallel import mesh as tmesh
from bayesian_consensus_engine_tpu_torch.state import checkpoint as tcheckpoint
from bayesian_consensus_engine_tpu_torch.state.checkpoint import CycleCheckpointer
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)

M, K = 32, 8
BOUND = dict(rtol=1e-5, atol=1e-6)
FIELDS = MarketBlockState._fields


def cold(m=M, k=K):
    return tpar.init_block_state(m, k, device="cpu")


def inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((M, K)).astype(np.float32), rng.random((M, K)) < 0.8,
            rng.random(M) < 0.5)


def port_args(x):
    return tuple(torch.from_numpy(a.copy()) for a in x)


def assert_state_equal(got, want):
    for field, a, b in zip(FIELDS, got, want):
        if b is None:
            assert a is None, field
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=field)


# -- CycleCheckpointer ---------------------------------------------------------


def test_round_trip_state_and_meta(tmp_path):
    state = cold()
    with CycleCheckpointer(tmp_path / "ckpt") as ckpt:
        assert ckpt.latest_step() is None
        assert ckpt.save(0, state, meta={"now_days": 12.5, "note": "t0"})
        restored, meta = ckpt.restore()
    assert meta == {"now_days": 12.5, "note": "t0"}
    for field in FIELDS:
        assert restored[field].device.type == "cpu"
        assert torch.equal(restored[field], getattr(state, field)), field


def test_restore_like_preserves_structure_and_dtype(tmp_path):
    state = cold()
    with CycleCheckpointer(tmp_path / "ckpt") as ckpt:
        ckpt.save(3, state)
        restored, _ = ckpt.restore(like=state)
        f64 = MarketBlockState(*(x.double() if x.is_floating_point() else x
                                 for x in state))
        as_f64, _ = ckpt.restore(like=f64)
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore(like=cold(M, K + 1))
    assert isinstance(restored, MarketBlockState)
    assert restored.reliability.dtype == torch.float32
    assert restored.exists.dtype == torch.bool
    assert as_f64.reliability.dtype == torch.float64
    assert_state_equal(restored, state)


def test_missing_checkpoint_raises(tmp_path):
    with CycleCheckpointer(tmp_path / "empty") as ckpt:
        with pytest.raises(FileNotFoundError):
            ckpt.restore()
        with pytest.raises(FileNotFoundError):
            ckpt.restore(7)


def test_retention_prunes_old_steps_and_an_existing_step_needs_force(tmp_path):
    state = tpar.init_block_state(4, 2, device="cpu")
    with CycleCheckpointer(tmp_path / "ckpt", max_to_keep=2) as ckpt:
        for step in (1, 2, 3, 4):
            assert ckpt.save(step, state)
        assert ckpt.latest_step() == 4
        assert ckpt.all_steps() == [3, 4]
        assert not ckpt.save(4, state, meta={"again": True})
        assert ckpt.restore()[1] == {}
        assert ckpt.save(4, state, meta={"again": True}, force=True)
        assert ckpt.restore()[1] == {"again": True}
        assert ckpt.all_steps() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["3", "4"]


def test_exists_none_carry_round_trips(tmp_path):
    full = cold()
    state = MarketBlockState(full.reliability, full.confidence,
                             full.updated_days, None)
    with CycleCheckpointer(tmp_path / "ckpt") as ckpt:
        ckpt.save(0, state)
        restored, _ = ckpt.restore(like=state)
    assert isinstance(restored, MarketBlockState) and restored.exists is None
    assert torch.equal(restored.reliability, state.reliability)


def test_the_save_is_a_snapshot_and_commits_atomically(tmp_path, monkeypatch):
    """The tensors are copied when ``save`` returns (a later in-place
    update is not saved); a writer that dies mid-write leaves no step, its
    error reaches the caller, and the next checkpointer clears its
    leftovers."""
    state = cold()
    with CycleCheckpointer(tmp_path / "ckpt") as ckpt:
        ckpt.save(1, state)
        state.reliability.fill_(0.9)
        restored, _ = ckpt.restore(like=state)
    assert torch.equal(restored.reliability, torch.full((M, K), 0.5))

    def torn(obj, handle):
        handle.write(b"torn")
        raise OSError("disk gone")

    monkeypatch.setattr(tcheckpoint.torch, "save", torn)
    ckpt = CycleCheckpointer(tmp_path / "ckpt")
    assert ckpt.save(2, state)
    with pytest.raises(OSError, match="disk gone"):
        ckpt.wait()
    assert ckpt.all_steps() == [1]
    assert any(p.name.startswith(".tmp-") for p in (tmp_path / "ckpt").iterdir())
    monkeypatch.undo()
    with CycleCheckpointer(tmp_path / "ckpt") as again:
        assert again.latest_step() == 1
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["1"]


def test_a_grid_restores_onto_its_mesh(tmp_path):
    """``like`` a grid of per-shard blocks on a (4, 2) mesh: the restored
    grid has its shape, and each tensor its shard's device and dtype."""
    mesh = tmesh.make_mesh((4, 2), ["cpu"] * 8)
    full = cold()
    grids = [tmesh.shard_block(field, mesh) for field in full]
    state = tuple(tuple(MarketBlockState(*(g[i][j] for g in grids))
                        for j in range(2)) for i in range(4))
    with CycleCheckpointer(tmp_path / "ckpt") as ckpt:
        ckpt.save(0, state)
        restored, _ = ckpt.restore(like=state)
    assert len(restored) == 4 and all(len(row) == 2 for row in restored)
    for row, want_row in zip(restored, state):
        for shard, want in zip(row, want_row):
            assert isinstance(shard, MarketBlockState)
            assert shard.reliability.device == want.reliability.device
            assert_state_equal(shard, want)


# -- resume equals an uninterrupted run -----------------------------------------


@pytest.fixture(scope="module")
def jax_loops():
    """The JAX package's uninterrupted 5-step market-major loop on the
    whole block and on an (8, 1) mesh, per input seed."""
    cache = {}

    def get(seed, shape):
        key = (seed, shape)
        if key not in cache:
            probs, mask, outcome = (jnp.asarray(a) for a in inputs(seed))
            mesh = None if shape is None else jpar.make_mesh(
                shape, devices=jax.devices()[: shape[0] * shape[1]])
            loop = jpar.build_cycle_loop(mesh=mesh, slot_major=False,
                                         donate=False)
            state, consensus = loop(probs, mask, outcome,
                                    jpar.init_block_state(M, K),
                                    jnp.float32(10.0), 5)
            cache[key] = ([np.asarray(f) for f in state], np.asarray(consensus))
        return cache[key]

    return get


def test_resume_matches_uninterrupted_run(tmp_path, jax_loops):
    probs, mask, outcome = port_args(inputs(1))
    loop = tpar.build_cycle_loop(mesh=None, slot_major=False, donate=False)
    state0 = cold()
    full_state, full_consensus = loop(probs, mask, outcome, state0, 10.0, 5)

    mid_state, _ = loop(probs, mask, outcome, state0, 10.0, 3)
    with CycleCheckpointer(tmp_path / "ckpt") as ckpt:
        ckpt.save(3, mid_state, meta={"next_now": 13.0})
    with CycleCheckpointer(tmp_path / "ckpt") as ckpt:
        restored, meta = ckpt.restore(like=mid_state)
    resumed_state, resumed_consensus = loop(
        probs, mask, outcome, restored, meta["next_now"], 2)

    np.testing.assert_array_equal(resumed_consensus.numpy(),
                                  full_consensus.numpy())
    assert_state_equal(resumed_state, full_state)
    want_state, want_consensus = jax_loops(1, None)
    assert_state_equal(resumed_state, want_state)
    np.testing.assert_allclose(resumed_consensus.numpy(), want_consensus,
                               equal_nan=True, **BOUND)


def test_sharded_loop_resume(tmp_path, jax_loops):
    mesh = tmesh.make_mesh((8, 1), ["cpu"] * 8)
    probs, mask, outcome = inputs(2)
    p, m_ = tmesh.shard_block(probs, mesh), tmesh.shard_block(mask, mesh)
    o = tpar.shard_market(outcome, mesh)
    grids = [tmesh.shard_block(field, mesh) for field in cold()]
    sharded = tuple((MarketBlockState(*(g[i][0] for g in grids)),)
                    for i in range(8))
    loop = tpar.build_cycle_loop(mesh=mesh, slot_major=False, donate=False)

    full_state, full_consensus = loop(p, m_, o, sharded, 10.0, 5)
    mid_state, _ = loop(p, m_, o, sharded, 10.0, 2)
    with CycleCheckpointer(tmp_path / "ckpt") as ckpt:
        ckpt.save(2, mid_state)
        restored, _ = ckpt.restore(like=mid_state)
    resumed_state, resumed_consensus = loop(p, m_, o, restored, 12.0, 3)
    np.testing.assert_array_equal(resumed_consensus.numpy(),
                                  full_consensus.numpy())

    def whole(grid):
        return [tmesh.unshard_block(tuple(tuple(s[f] for s in row)
                                          for row in grid)).numpy()
                for f in range(4)]

    assert_state_equal(whole(resumed_state), whole(full_state))
    want_state, want_consensus = jax_loops(2, (8, 1))
    assert_state_equal(whole(resumed_state), want_state)
    np.testing.assert_allclose(resumed_consensus.numpy(), want_consensus,
                               equal_nan=True, **BOUND)


def test_compact_state_round_trips_and_resumes(tmp_path):
    """int8/uint8 counter states survive save → restore bit for bit with
    their dtypes, and the resumed compact loop continues bit for bit; its
    counters equal the JAX compact loop's uninterrupted run."""
    rng = np.random.default_rng(21)
    x = (rng.random((K, M)).astype(np.float32), rng.random((K, M)) < 0.9,
         rng.random(M) < 0.5)
    probs, mask, outcome = port_args(x)
    loop = tcompact.build_compact_cycle_loop(mesh=None)
    start = tcompact.init_compact_state(M, K, device="cpu")
    state, _ = loop(probs, mask, outcome, start, 1.0, 3)
    with CycleCheckpointer(tmp_path / "ckpt") as ckpt:
        ckpt.save(3, state, meta={"next_now": 4.0}, force=True)
        restored, meta = ckpt.restore(like=state)
    assert meta["next_now"] == 4.0
    for got, want in zip(restored, state):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    full_state, full_consensus = loop(probs, mask, outcome, start, 1.0, 5)
    res_state, res_consensus = loop(probs, mask, outcome, restored,
                                    meta["next_now"], 2)
    np.testing.assert_array_equal(res_consensus.numpy(), full_consensus.numpy())
    for got, want in zip(res_state, full_state):
        assert torch.equal(got, want)
    jloop = jcompact.build_compact_cycle_loop(mesh=None, donate=False)
    jstate, jconsensus = jloop(*(jnp.asarray(a) for a in x),
                               jcompact.init_compact_state(M, K),
                               jnp.float32(1.0), 5)
    for got, want in zip(res_state, jstate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(res_consensus.numpy(), np.asarray(jconsensus),
                               equal_nan=True, **BOUND)


# -- the store's checkpoint -------------------------------------------------------


def test_store_round_trip_bit_identical(tmp_path):
    store = TensorReliabilityStore(device="cpu")
    store.update_reliability("alpha", "m1", outcome_correct=True)
    store.update_reliability("beta", "m1", outcome_correct=False)
    store.update_reliability("alpha", "m2", outcome_correct=True)
    before = store.list_sources()

    store.save_checkpoint(tmp_path / "store_ckpt")
    loaded = TensorReliabilityStore.load_checkpoint(tmp_path / "store_ckpt",
                                                    device="cpu")
    assert loaded.device.type == "cpu"
    assert loaded.list_sources() == before  # f64 values + ISO strings
    assert loaded._pairs.ids() == store._pairs.ids()
    rec = loaded.get_reliability("never-seen", "m1")
    assert rec.reliability == store.get_reliability("never-seen", "m1").reliability
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            TensorReliabilityStore.load_checkpoint(tmp_path / "store_ckpt")


def test_store_checkpoint_then_device_cycle(tmp_path):
    """Restore → device_state → cycle → absorb keeps working."""
    store = TensorReliabilityStore(device="cpu")
    store.update_reliability("a", "m", outcome_correct=True)
    store.save_checkpoint(tmp_path / "ckpt", step=5)
    loaded = TensorReliabilityStore.load_checkpoint(tmp_path / "ckpt",
                                                    device="cpu")
    state, epoch0 = loaded.device_state()
    assert bool(state.exists.any())
    loaded.absorb(state, epoch0)
    assert loaded.list_sources() == store.list_sources()
    assert CycleCheckpointer(tmp_path / "ckpt").all_steps() == [5]


def fixture_payloads(seed=61, markets=24):
    rng = random.Random(seed)
    payloads = []
    for m in range(markets):
        signals = [
            {"sourceId": f"src-{rng.randrange(11)}",
             "probability": round(rng.random(), 6)}
            for _ in range(rng.randint(1, 5))
        ]
        payloads.append((f"market-{m}", signals))
    outcomes = [rng.random() < 0.5 for _ in range(markets)]
    return payloads, outcomes


def records(store):
    """``list_sources()`` field by field (the packages' record types
    differ)."""
    return [(r.source_id, r.market_id, r.reliability, r.confidence,
             r.updated_at) for r in store.list_sources()]


def sqlite_bytes(store, path):
    store.flush_to_sqlite(path)
    return path.read_bytes()


def test_kill_resume_mid_sharded_session(tmp_path, monkeypatch):
    """Two settles of a session on a (4, 2) mesh, a snapshot with the
    session's sync recipes outstanding, a kill; a fresh store from the
    snapshot finishes the chain as the JAX package's uninterrupted
    session does."""
    monkeypatch.setenv("BCE_NO_NATIVE", "1")
    days = [20850.0, 20851.0, 20852.0]
    payloads, outcomes = fixture_payloads()

    jstore = JaxStore()
    jmesh = jpar.make_mesh((4, 2), devices=jax.devices()[:8])
    with jpipe.ShardedSettlementSession(
            jstore, jpipe.build_settlement_plan(jstore, payloads), jmesh) as sess:
        for day in days:
            expected = sess.settle(outcomes, steps=2, now=day)

    mesh = tmesh.make_mesh((4, 2), ["cpu"] * 8)
    store_i = TensorReliabilityStore(device="cpu")
    session = tpipe.ShardedSettlementSession(
        store_i, tpipe.build_settlement_plan(store_i, payloads), mesh)
    for day in days[:2]:
        session.settle(outcomes, steps=2, now=day)
    assert store_i._pending_sync  # the deferred state is really there
    store_i.save_checkpoint(tmp_path / "preempt")
    del session, store_i  # kill -9: no close(), no sync()

    store_r = TensorReliabilityStore.load_checkpoint(tmp_path / "preempt",
                                                     device="cpu")
    plan_r = tpipe.build_settlement_plan(store_r, payloads)
    with tpipe.ShardedSettlementSession(store_r, plan_r, mesh) as sess:
        resumed = sess.settle(outcomes, steps=2, now=days[2])

    np.testing.assert_allclose(resumed.consensus,
                               np.asarray(expected.consensus),
                               equal_nan=True, **BOUND)
    assert records(store_r) == records(jstore)
    assert (sqlite_bytes(store_r, tmp_path / "port.db")
            == sqlite_bytes(jstore, tmp_path / "jax.db"))


def test_kill_resume_mid_flat_settle_chain(tmp_path, monkeypatch):
    monkeypatch.setenv("BCE_NO_NATIVE", "1")
    days = [20860.0, 20861.0, 20862.0]
    payloads, outcomes = fixture_payloads(seed=67)

    jstore = JaxStore()
    jplan = jpipe.build_settlement_plan(jstore, payloads)
    for day in days:
        expected = jpipe.settle(jstore, jplan, outcomes, steps=2, now=day)
    jstore.sync()

    store_i = TensorReliabilityStore(device="cpu")
    plan_i = tpipe.build_settlement_plan(store_i, payloads)
    for day in days[:2]:
        tpipe.settle(store_i, plan_i, outcomes, steps=2, now=day)
    assert store_i._pending is not None  # deferred device truth held
    store_i.save_checkpoint(tmp_path / "preempt")
    del store_i  # kill -9 mid-chain

    store_r = TensorReliabilityStore.load_checkpoint(tmp_path / "preempt",
                                                     device="cpu")
    plan_r = tpipe.build_settlement_plan(store_r, payloads)
    resumed = tpipe.settle(store_r, plan_r, outcomes, steps=2, now=days[2])
    store_r.sync()

    np.testing.assert_allclose(resumed.consensus,
                               np.asarray(expected.consensus),
                               equal_nan=True, **BOUND)
    assert records(store_r) == records(jstore)
    assert (sqlite_bytes(store_r, tmp_path / "port.db")
            == sqlite_bytes(jstore, tmp_path / "jax.db"))
