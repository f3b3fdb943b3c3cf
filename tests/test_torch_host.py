"""The port's host half ≡ the JAX package's: packing, fingerprints, plan
layout, plan refresh, and the store's record, absorb and carry-over paths.

Everything compared here is host arithmetic on the same inputs, so every
value must be equal bit for bit (no tolerance).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.core import batch as jbatch
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.convert import store_from_records
from bayesian_consensus_engine_tpu_torch.core import batch as tbatch
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore as TorchStore,
)


def make_columns(seed, num_markets=80, universe=30, max_signals=7):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_signals + 1, num_markets)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    sources = [f"s{int(s)}" for s in rng.integers(0, universe, offsets[-1])]
    probs = np.round(rng.random(offsets[-1]), 5)
    keys = [f"mk-{m}" for m in range(num_markets)]
    return keys, sources, probs, offsets


def to_payloads(keys, sources, probs, offsets):
    return [
        (key, [{"sourceId": sources[i], "probability": float(probs[i])}
               for i in range(offsets[m], offsets[m + 1])])
        for m, key in enumerate(keys)
    ]


def _assert_plans_equal(ours, theirs):
    assert ours.market_keys == theirs.market_keys
    for field in ("slot_rows", "probs", "mask", "signals_per_market"):
        mine, ref = getattr(ours, field), getattr(theirs, field)
        assert mine.dtype == ref.dtype, field
        np.testing.assert_array_equal(mine, ref)
    assert ours.binding == theirs.binding
    assert ours.fingerprint == theirs.fingerprint


@pytest.mark.parametrize("num_slots", [None, "bucket", 12])
@pytest.mark.parametrize("builder", ["dict", "columnar"])
def test_plan_layout_matches_jax(builder, num_slots):
    keys, sources, probs, offsets = make_columns(1)
    jstore, tstore = JaxStore(), TorchStore(device="cpu")
    plans = []
    for pipe, store in ((jpipe, jstore), (tpipe, tstore)):
        # Two batches, so the second interns over existing rows.
        for seed in (1, 2):
            keys, sources, probs, offsets = make_columns(seed)
            if builder == "dict":
                plan = pipe.build_settlement_plan(
                    store, to_payloads(keys, sources, probs, offsets),
                    num_slots=num_slots, fingerprint=True,
                )
            else:
                plan = pipe.build_settlement_plan_columnar(
                    store, keys, sources, probs, offsets,
                    num_slots=num_slots, fingerprint=True,
                )
            plans.append(plan)
    for ours, theirs in zip(plans[2:], plans[:2]):
        _assert_plans_equal(ours, theirs)
    assert tstore._pairs.ids() == list(jstore._pairs.ids())


def test_packing_and_fingerprints_match_jax():
    keys, sources, probs, offsets = make_columns(3)
    payloads = to_payloads(keys, sources, probs, offsets)
    ours, theirs = tbatch.pack_markets(payloads), jbatch.pack_markets(payloads)
    for field in dataclasses.fields(theirs):
        mine, ref = getattr(ours, field.name), getattr(theirs, field.name)
        if isinstance(ref, np.ndarray):
            assert mine.dtype == ref.dtype, field.name
            np.testing.assert_array_equal(mine, ref)
        else:
            assert mine == ref, field.name

    t_cols = tbatch.columns_from_payloads(payloads)
    j_cols = jbatch.columns_from_payloads(payloads)
    assert list(t_cols[0]) == list(j_cols[0]) and list(t_cols[1]) == list(j_cols[1])
    np.testing.assert_array_equal(t_cols[2], j_cols[2])
    np.testing.assert_array_equal(t_cols[3], j_cols[3])

    t_codes = tbatch.encode_source_ids(sources)
    j_codes = jbatch.encode_source_ids(sources)
    np.testing.assert_array_equal(t_codes.codes, j_codes.codes)
    assert t_codes.table == list(j_codes.table)
    for source_ids in (sources, t_codes):
        assert tbatch.topology_fingerprint(keys, source_ids, offsets) == (
            jbatch.topology_fingerprint(keys, sources, offsets)
        )

    order = sorted(range(len(t_codes.table)), key=t_codes.table.__getitem__)
    rank_of_code = np.empty(len(order), dtype=np.int64)
    rank_of_code[order] = np.arange(len(order))
    t_groups = tbatch.group_columns(t_codes.codes, rank_of_code, offsets, probs)
    j_groups = jbatch.group_columns(t_codes.codes, rank_of_code, offsets, probs)
    for mine, ref in zip(t_groups, j_groups):
        np.testing.assert_array_equal(mine, ref)
    sid_of_rank = [t_codes.table[c] for c in order]
    args = (keys, sid_of_rank, t_groups[1], t_groups[2], t_groups[3])
    assert tbatch.pair_fingerprint(*args) == jbatch.pair_fingerprint(*args)


def test_refresh_matches_rebuild_and_jax():
    keys, sources, probs, offsets = make_columns(4)
    new_probs = np.round(np.random.default_rng(5).random(len(probs)), 5)
    tstore, jstore = TorchStore(device="cpu"), JaxStore()
    tplan = tpipe.build_settlement_plan_columnar(tstore, keys, sources, probs, offsets)
    jplan = jpipe.build_settlement_plan_columnar(jstore, keys, sources, probs, offsets)
    refreshed = tplan.refresh(new_probs)
    _assert_plans_equal(refreshed, jplan.refresh(new_probs))
    rebuilt = tpipe.build_settlement_plan_columnar(
        TorchStore(device="cpu"), keys, sources, new_probs, offsets
    )
    np.testing.assert_array_equal(refreshed.probs, rebuilt.probs)
    # A refreshed plan adopts its settled parent's device topology.
    outcomes = [True, False] * (len(keys) // 2)
    tpipe.settle(tstore, tplan, outcomes, now=20000.0)
    parent_rows = tplan._device_arrays[1]
    tpipe.settle(tstore, refreshed, outcomes, now=20001.0)
    assert refreshed._device_arrays[1] is parent_rows
    assert tplan._device_arrays is None


SEEDED = (
    ("a", "m1", 0.7, 0.3, "2024-08-01T00:00:00+00:00"),
    ("b", "m1", 0.2, 0.9, "2024-10-01T06:30:00+00:00"),
    ("a", "m2", 0.55, 0.25, ""),
)


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_absorb_matches_jax(name):
    """A mutated device state written back: changed rows take the new
    values and fresh ISO stamps, the rest keep their exact host values."""
    results = []
    for kind in ("jax", "torch"):
        store = JaxStore() if kind == "jax" else TorchStore(device="cpu")
        for source, market, rel, conf, iso in SEEDED:
            record = store.get_reliability(source, market)
            store.put_record(dataclasses.replace(
                record, reliability=rel, confidence=conf, updated_at=iso))
        if kind == "jax":
            with jax.enable_x64(name == "f64"):
                state, epoch0 = store.device_state()
                state = state._replace(
                    reliability=state.reliability.at[1].set(0.125),
                    updated_days=state.updated_days.at[2].set(
                        jnp.asarray(62.5, state.updated_days.dtype)),
                )
                store.absorb(state, epoch0)
        else:
            dtype = torch.float64 if name == "f64" else torch.float32
            state, epoch0 = store.device_state(dtype)
            rel, days = state.reliability.clone(), state.updated_days.clone()
            rel[1], days[2] = 0.125, 62.5
            store.absorb(state._replace(reliability=rel, updated_days=days), epoch0)
        results.append([dataclasses.astuple(r) for r in store.list_sources()])
    assert results[0] == results[1]
    assert results[1][0][2] == 0.7  # untouched f64 value survives an f32 trip


def test_store_from_columns_equals_records():
    records = TorchStore(device="cpu")
    for source, market, rel, conf, iso in SEEDED:
        record = records.get_reliability(source, market)
        records.put_record(dataclasses.replace(
            record, reliability=rel, confidence=conf, updated_at=iso))
    listed = records.list_sources()
    columns = tuple(list(col) for col in zip(*SEEDED))
    columns = (columns[0], columns[1], np.asarray(columns[2]),
               np.asarray(columns[3]), columns[4])
    for source in (listed, columns):
        store = store_from_records(source, device="cpu")
        assert store.list_sources() == listed
    with pytest.raises(ValueError, match="duplicate"):
        store_from_records(listed + listed[:1], device="cpu")


def test_record_api_matches_jax():
    """Cold-start reads, dry runs and capped updates through the scalar
    record API, on both stores."""
    values = []
    for store in (JaxStore(), TorchStore(device="cpu")):
        cold = store.get_reliability("x", "m")
        dry = store.update_reliability("x", "m", True, dry_run=True)
        assert store.get_reliability("x", "m").updated_at == ""
        up = store.update_reliability("x", "m", True)
        down = store.update_reliability("x", "m", False)
        down = store.update_reliability("x", "m", False)
        values.append([
            (r.reliability, r.confidence) for r in (cold, dry, up, down)
        ] + [(r.source_id, r.market_id) for r in store.list_sources()])
    assert values[0] == values[1]


def _seeded_pair(seed=0):
    """A JAX-package store and a port store holding the same records
    (SEEDED plus a random spread), with a queried pair list that mixes
    live, interned-but-dead and unknown pairs."""
    rng = np.random.default_rng(seed)
    rows = list(SEEDED) + [
        (f"s{i % 7}", f"m{i % 5}", float(rng.random()), float(rng.random()),
         f"2026-0{1 + i % 9}-1{i % 10}T0{i % 10}:00:00+00:00")
        for i in range(40)
    ]
    stores = [JaxStore(), TorchStore(device="cpu")]
    for store in stores:
        for source, market, rel, conf, iso in rows:
            record = store.get_reliability(source, market)
            store.put_record(dataclasses.replace(
                record, reliability=rel, confidence=conf, updated_at=iso))
        store.rows_for_pairs([("dead", "m1")])  # interned, never written
    pairs = [(s, m) for s, m, *_ in rows[::3]] + [("dead", "m1"), ("no", "one")]
    return stores, pairs


@pytest.mark.parametrize("decay", [False, True])
def test_batch_get_reliability_matches_jax(decay):
    (jstore, tstore), pairs = _seeded_pair()
    now = 20600.5  # epoch-days: after every seeded stamp
    want = jstore.batch_get_reliability(pairs, apply_decay=decay, now=now)
    got = tstore.batch_get_reliability(pairs, apply_decay=decay, now=now)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    if decay:
        # The decay's exp2: the tolerance ROADMAP.md states for decayed reads.
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-3)
        assert not np.array_equal(got[0], tstore.batch_get_reliability(pairs)[0])
    else:
        np.testing.assert_array_equal(got[0], want[0])
    assert len(tstore) == len(jstore)  # reads never allocate


def test_batch_update_reliability_matches_jax():
    (jstore, tstore), pairs = _seeded_pair(1)
    correct = [i % 3 != 0 for i in range(len(pairs))]
    for store in (jstore, tstore):
        store.batch_update_reliability(pairs, correct)
    got, want = tstore.list_sources(), jstore.list_sources()
    assert [(r.source_id, r.market_id, r.reliability, r.confidence)
            for r in got] == [(r.source_id, r.market_id, r.reliability,
                               r.confidence) for r in want]
    # One shared stamp on every updated row (the wall clock's, so the two
    # stores' may differ by the time between the calls).
    stamps = {tstore.get_reliability(s, m).updated_at for s, m in pairs}
    assert len(stamps) == 1 and "" not in stamps


def test_absorb_rows_matches_jax():
    (jstore, tstore), _pairs = _seeded_pair(2)
    rows = np.array([5, 1, 30, 17, 0, len(tstore) - 1], dtype=np.int64)
    rel = np.array([0.125, 0.7, 0.5, 0.875, 0.25, 0.0625])
    conf = np.array([0.6, 0.3, 0.9, 0.55, 0.65, 0.7])
    days = np.array([40.0, 0.0, 12.5, 7.25, 3.0, 1.0])
    exists = np.array([True, True, False, True, True, True])
    epoch0 = 20500.0
    jstore.absorb_rows(rows, rel, conf, days, exists, epoch0)
    tstore.absorb_rows(torch.from_numpy(rows), torch.from_numpy(rel),
                       torch.from_numpy(conf), torch.from_numpy(days),
                       torch.from_numpy(exists), epoch0)
    assert [dataclasses.astuple(r) for r in tstore.list_sources()] == [
        dataclasses.astuple(r) for r in jstore.list_sources()]


def test_device_state_donate_matches_jax():
    (jstore, tstore), _pairs = _seeded_pair(3)
    with jax.enable_x64(True):
        want, want_epoch0 = jstore.device_state(jnp.float64, donate=True)
    got, epoch0 = tstore.device_state(torch.float64, donate=True)
    assert epoch0 == want_epoch0
    for mine, ref in zip(got, want):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert tstore._device_cache is None
    kept, _ = tstore.device_state(torch.float64)
    assert tstore._device_cache[0] is kept and kept.reliability is not got.reliability
    # A donated cache is forgotten too, and the caller's tensors stay on the
    # store's device.
    donated, _ = tstore.device_state(torch.float64, donate=True)
    assert donated is kept and tstore._device_cache is None
    assert donated.reliability.device == tstore.device
