"""The port's delta pair interning ≡ one full intern pass ≡ the JAX
package's full pass.

``intern_mode="auto"`` (the store's epoch pair table,
``rows_for_pairs_delta``) and ``intern_mode="full"`` must give the same
plans, the same row assignment and the same SQLite bytes as the JAX
package's full pass on its Python twins (``BCE_NO_NATIVE=1``), across

    {base, stable, drift, reorder, shrink, grow}   batch shapes
  × {native, forced-fallback}                      the port's interner
  × {serial, sharded}                              probes (the sharded one
                                                   forced at toy sizes)

plus the C and numpy ``delta_match_rows`` twins against each other and the
JAX package's twin, and the resolve tiers. Host arithmetic on the same
inputs: equal bit for bit. Rows are made live with ``absorb_rows`` on
values derived from each plan, so the checkpoints have content.
"""

import contextlib
import sqlite3

import numpy as np
import pytest

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu.utils import interning as jinterning
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore as TorchStore,
)
from bayesian_consensus_engine_tpu_torch.utils import interning


@pytest.fixture(autouse=True)
def native_route(monkeypatch):
    """Each test starts on the C route whatever the environment says; the
    tests that want the Python twins set ``BCE_NO_NATIVE`` themselves."""
    monkeypatch.delenv("BCE_NO_NATIVE", raising=False)


def _columnar(rng, market_ids, universe, max_signals=4):
    keys = list(market_ids)
    sids, probs, offsets = [], [], [0]
    for _ in keys:
        for _ in range(int(rng.integers(1, max_signals + 1))):
            sids.append(f"src-{int(rng.integers(0, universe))}")
            probs.append(float(rng.random()))
        offsets.append(len(sids))
    return (keys, sids, np.asarray(probs, dtype=np.float64),
            np.asarray(offsets, dtype=np.int64))


def _splice(parts):
    """Markets taken one by one from (batch, market index) parts."""
    keys, sids, probs, offsets = [], [], [], [0]
    for batch, m in parts:
        lo, hi = int(batch[3][m]), int(batch[3][m + 1])
        keys.append(batch[0][m])
        sids.extend(batch[1][lo:hi])
        probs.extend(batch[2][lo:hi].tolist())
        offsets.append(len(sids))
    return keys, sids, np.asarray(probs), np.asarray(offsets, dtype=np.int64)


def matrix_batches(seed=31):
    """Base; stable (the base's pair set, new signal pattern); drift (3 of
    24 markets redrawn); reorder (the base shuffled); shrink (a prefix);
    grow (past the base)."""
    rng = np.random.default_rng(seed)
    markets = [f"m-{i}" for i in range(24)]
    base = _columnar(rng, markets, universe=12)
    keys, sids, _probs, offsets = base
    stable_sids, stable_offsets = [], [0]
    for m in range(len(keys)):
        stable_sids.extend(sorted(dict.fromkeys(sids[offsets[m]:offsets[m + 1]])))
        stable_offsets.append(len(stable_sids))
    stable = (list(keys), stable_sids, rng.random(len(stable_sids)),
              np.asarray(stable_offsets, dtype=np.int64))
    redrawn = _columnar(rng, markets, universe=12)
    drift = _splice([(redrawn if m % 8 == 0 else base, m)
                     for m in range(len(markets))])
    reorder = _splice([(base, m) for m in rng.permutation(len(markets)).tolist()])
    half = len(markets) // 2
    shrink = _splice([(base, m) for m in range(half)])
    grow = _columnar(rng, markets + [f"m-new-{i}" for i in range(8)], universe=16)
    return [base, stable, drift, reorder, shrink, grow]


def _make_live(store, plan, step):
    """Deterministic values for the plan's rows, absorbed as a settle
    would leave them."""
    rows = plan.slot_rows[plan.mask]
    probs = plan.probs[plan.mask]
    store.absorb_rows(rows, 0.25 + 0.5 * probs, 0.5 + 0.01 * step + 0 * probs,
                      np.full(len(rows), 3.0 + step), np.ones(len(rows), bool),
                      20000.0)


def dump(path):
    with contextlib.closing(sqlite3.connect(path)) as conn:
        return [" ".join(line.split()) if line.startswith("CREATE") else line
                for line in conn.iterdump()]


def _drive(pipe, store, mode, batches, path):
    plans = []
    for step, batch in enumerate(batches):
        plan = pipe.build_settlement_plan_columnar(store, *batch, intern_mode=mode)
        _make_live(store, plan, step)
        plans.append(plan)
    store.flush_to_sqlite(path)
    return plans, dump(path)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's full pass on its Python twins."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("BCE_NO_NATIVE", "1")
        store = JaxStore()
        plans, dumped = _drive(jpipe, store, "full", matrix_batches(),
                               tmp_path_factory.mktemp("ref") / "ref.db")
    return plans, dumped, store._pairs.ids()


@pytest.mark.parametrize("sharded", [False, True], ids=["serial", "sharded"])
@pytest.mark.parametrize("fallback", [False, True], ids=["native", "fallback"])
def test_delta_equals_full_and_reference(tmp_path, monkeypatch, reference,
                                         fallback, sharded):
    if fallback:
        monkeypatch.setenv("BCE_NO_NATIVE", "1")
    if sharded:
        monkeypatch.setattr(interning, "SHARD_MIN_PAIRS", 1)
        monkeypatch.setenv("BCE_INTERN_WORKERS", "3")
    want_plans, want_dump, want_ids = reference
    runs = {}
    for mode in ("auto", "full"):
        store = TorchStore(device="cpu")
        assert isinstance(store._pairs, interning.IdInterner) == fallback
        plans, dumped = _drive(tpipe, store, mode, matrix_batches(),
                               tmp_path / f"{mode}.db")
        runs[mode] = plans
        assert dumped == want_dump
        assert store._pairs.ids() == want_ids
        for mine, ref in zip(plans, want_plans):
            assert mine.market_keys == ref.market_keys
            np.testing.assert_array_equal(mine.slot_rows, ref.slot_rows)
            np.testing.assert_array_equal(mine.probs, ref.probs)
            assert mine.binding == ref.binding
    interned = {mode: [p.intern_stats["interned_pairs"] for p in plans]
                for mode, plans in runs.items()}
    assert [p.intern_stats["mode"] for p in runs["auto"]] == ["delta"] * 6
    assert interned["auto"][0] == interned["full"][0]  # cold: everything
    assert interned["auto"][1] == 0 and runs["auto"][1].intern_stats[
        "fingerprint_hit"]
    assert 0 < interned["auto"][2] < interned["full"][2]  # drift: the delta
    assert interned["auto"][3] < interned["full"][3]  # reorder
    assert interned["auto"][4] == 0  # shrink: a prefix of the reorder's pairs
    for plan in runs["auto"][2:5]:
        assert plan.intern_stats["matched_pairs"] > 0


def test_stable_batch_hits_the_fingerprint():
    base, stable = matrix_batches()[:2]
    store = TorchStore(device="cpu")
    first = tpipe.stage_settlement_plan_columnar(*base)
    again = tpipe.stage_settlement_plan_columnar(*stable)
    assert first.pair_fingerprint == again.pair_fingerprint
    assert first.intern_mode == "auto" and first.used_native
    plan0 = first.bind(store)
    plan1 = again.bind(store)
    assert plan1.intern_stats["fingerprint_hit"] is True
    assert plan1.intern_stats["interned_pairs"] == 0
    np.testing.assert_array_equal(plan1.slot_rows, plan0.slot_rows)


def test_full_mode_never_consults_or_updates_the_table():
    base = matrix_batches()[0]
    store = TorchStore(device="cpu")
    staged = tpipe.stage_settlement_plan_columnar(*base, intern_mode="full")
    assert staged.pair_fingerprint is None
    staged.bind(store)
    assert store._pair_epoch is None
    plan = tpipe.build_settlement_plan_columnar(store, *base)
    assert plan.intern_stats["matched_pairs"] == 0
    table = store._pair_epoch
    assert table.src_index() == {s: i for i, s in enumerate(table.src_table)}
    assert table.market_index()["m-3"] == 3


@pytest.mark.parametrize("builder", ["stage", "build"])
def test_unknown_intern_mode_raises(builder):
    base = matrix_batches()[0]
    with pytest.raises(ValueError, match='intern_mode=.*expected "full"'):
        if builder == "stage":
            tpipe.stage_settlement_plan_columnar(*base, intern_mode="lazy")
        else:
            tpipe.build_settlement_plan_columnar(
                TorchStore(device="cpu"), *base, intern_mode="lazy")


@pytest.mark.parametrize("native", [True, False])
def test_delta_match_twins_agree(native):
    rng = np.random.default_rng(7)
    for case in range(40):
        m_old, m_new = int(rng.integers(0 if case == 0 else 1, 9)), int(
            rng.integers(1, 9))
        counts_old = rng.integers(0, 4, m_old)
        counts_new = rng.integers(0, 4, m_new)
        if case % 5 == 1:
            counts_new[-1] = 0  # a trailing empty market
        po = np.concatenate([[0], np.cumsum(counts_old)]).astype(np.int64)
        pn = np.concatenate([[0], np.cumsum(counts_new)]).astype(np.int64)
        pr_old = rng.integers(0, 6, int(po[-1])).astype(np.int32)
        pr_new = rng.integers(0, 6, int(pn[-1])).astype(np.int32)
        rows_old = np.arange(int(po[-1]), dtype=np.int32) + 100
        prev_of = rng.integers(-1, max(m_old, 1), m_new).astype(np.int64)
        rank_map = rng.integers(-1, 6, 6).astype(np.int32)
        for args in ((rank_map, pr_new, pn, pr_old, po, prev_of, rows_old),
                     (None, pr_old, po, pr_old, po, None, rows_old)):
            if args[0] is None and m_old == 0:
                continue
            got = interning.delta_match_rows(*args, native=native)
            if len(args[3]) or not len(args[1]):
                want = jinterning.delta_match_rows(*args, native=False)
            else:
                # An epoch table of empty markets: the JAX package's twin
                # raises IndexError here; the C pass misses every pair.
                want = np.full(len(args[1]), -1, dtype=np.int32)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_sharded_probe_equals_serial():
    rng = np.random.default_rng(3)
    cols = ([f"s{i}" for i in range(12)], rng.integers(0, 12, 4096).astype(np.int32),
            [f"m{i}" for i in range(40)], rng.integers(0, 40, 4096).astype(np.int32))
    serial, sharded = interning.make_pair_interner(), interning.make_pair_interner()
    assert interning.probe_supported(serial)
    want = np.asarray(serial.intern_arrays_indexed(*cols))
    np.testing.assert_array_equal(sharded.intern_indexed_sharded(*cols, workers=3),
                                  want)
    assert serial.ids() == sharded.ids()
    rows, _hashes, _slots, _capacity = sharded.probe_pairs_sharded(*cols, workers=2)
    np.testing.assert_array_equal(rows, want)  # a warm probe hits everything
