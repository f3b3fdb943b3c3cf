"""The port's settlement pipeline ≡ the JAX package's, end to end, on the CPU.

The same payloads (dict and columnar), outcomes, ``now`` and ``steps`` go
through ``bayesian_consensus_engine_tpu.pipeline.settle`` and the port's
``settle``, in float32 and float64 (JAX with x64 on), from stores holding
the same state. After each scenario:

* ``SettlementResult.consensus`` agrees within rtol=1e-5, atol=1e-6 (f32)
  or rtol=1e-12 (f64), with NaNs (zero-weight markets) in the same places
  — the consensus alone passes through ``exp2`` and a K-deep sum;
* ``list_sources()`` is equal field for field: stored reliabilities,
  confidences (the host replay), ISO stamps and existence are bit-equal;
* the SQLite ``iterdump()`` of both ``flush_to_sqlite`` files is equal
  (the JAX side takes its sqlite3-module writer under ``BCE_NO_NATIVE=1``).

Each scenario runs once per module and its cases share the result, so the
JAX settle programs compile once.
"""

import sqlite3

import numpy as np
import pytest
import torch

import jax

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.state.records import (
    ReliabilityRecord as JaxRecord,
)
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.convert import store_from_records
from bayesian_consensus_engine_tpu_torch.state.records import (
    ReliabilityRecord as TorchRecord,
)
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore as TorchStore,
)

NOW = 20000.25  # epoch-days, 2024-10-04
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "f64": dict(rtol=1e-12, atol=0.0)}
TORCH_DTYPE = {"f32": torch.float32, "f64": torch.float64}


def make_payloads(seed, num_markets, universe, max_signals=6, prefix="m"):
    """Dict payloads with duplicate-source signals, p = 0.5 exactly on
    some signals, and empty markets."""
    rng = np.random.default_rng(seed)
    payloads = []
    for m in range(num_markets):
        count = int(rng.integers(0, max_signals + 1))
        sources = [f"src-{int(s)}" for s in rng.integers(0, universe, count)]
        for i in range(1, count):
            if rng.random() < 0.2:
                sources[i] = sources[i - 1]
        probs = np.round(rng.random(count), 6)
        probs[rng.random(count) < 0.1] = 0.5
        payloads.append((
            f"{prefix}-{m}",
            [{"sourceId": s, "probability": float(p)}
             for s, p in zip(sources, probs)],
        ))
    outcomes = (rng.random(num_markets) < 0.5).tolist()
    return payloads, outcomes


def to_columns(payloads):
    keys, sources, probs, offsets = [], [], [], [0]
    for market_id, signals in payloads:
        keys.append(market_id)
        sources.extend(s["sourceId"] for s in signals)
        probs.extend(s["probability"] for s in signals)
        offsets.append(len(sources))
    return keys, sources, np.asarray(probs), np.asarray(offsets)


SEED_STAMPS = ("2024-08-01T00:00:00+00:00", "2024-10-03T12:00:00+00:00", "")


def seed_records(payloads, record_cls, seed=9):
    """Pre-existing state for some pairs: decay-eligible old stamps, a
    fresh one, and a never-stamped row."""
    rng = np.random.default_rng(seed)
    records = []
    for market_id, signals in payloads[::3]:
        for signal in signals[:2]:
            records.append(record_cls(
                source_id=signal["sourceId"], market_id=market_id,
                reliability=float(np.round(rng.random(), 6)),
                confidence=float(np.round(rng.random(), 6)),
                updated_at=SEED_STAMPS[int(rng.integers(0, 3))],
            ))
    return records


class Side:
    """One package's entry points, so a scenario runs the same on both."""

    def __init__(self, kind, name):
        self.kind, self.name = kind, name

    def store(self):
        return JaxStore() if self.kind == "jax" else TorchStore(device="cpu")

    def record(self, **fields):
        return (JaxRecord if self.kind == "jax" else TorchRecord)(**fields)

    @property
    def pipe(self):
        return jpipe if self.kind == "jax" else tpipe

    def settle(self, store, plan, outcomes, steps, now):
        if self.kind == "jax":
            return jpipe.settle(store, plan, outcomes, steps=steps, now=now)
        return tpipe.settle(store, plan, outcomes, steps=steps, now=now,
                            dtype=TORCH_DTYPE[self.name])

    def take_state(self, store):
        if self.kind == "jax":
            return store.take_device_state()
        return store.take_device_state(TORCH_DTYPE[self.name])

    def settle_payloads(self, store, payloads, outcomes, steps, now):
        if self.kind == "jax":
            return jpipe.settle_payloads(
                store, payloads, outcomes, steps=steps, now=now
            )
        return tpipe.settle_payloads(
            store, payloads, outcomes, steps=steps, now=now,
            dtype=TORCH_DTYPE[self.name],
        )


def _records(store):
    return [
        (r.source_id, r.market_id, r.reliability, r.confidence, r.updated_at)
        for r in store.list_sources()
    ]


def _dump(store, path):
    store.flush_to_sqlite(path)
    with sqlite3.connect(path) as conn:
        return list(conn.iterdump())


# -- scenarios ---------------------------------------------------------------


def scenario_single(side, tmp, steps):
    """Dict payloads over seeded state, one settle of *steps* cycles."""
    payloads, outcomes = make_payloads(1, 60, 25)
    store = side.store()
    for record in seed_records(payloads, side.record):
        store.put_record(record)
    result = side.settle_payloads(store, payloads, outcomes, steps, NOW)
    return [result.consensus], _records(store), _dump(store, tmp / "s.db")


def scenario_chain(side, tmp, _steps):
    """Chained settles through the deferred state, a store that grows
    between plan and settle, and a backdated settle."""
    payloads_a, outcomes_a = make_payloads(2, 40, 20)
    payloads_b, outcomes_b = make_payloads(3, 50, 30, prefix="b")
    payloads_c, outcomes_c = make_payloads(4, 70, 40, prefix="c")
    store = side.store()
    plan_a = side.pipe.build_settlement_plan(store, payloads_a)
    consensus = [side.settle(store, plan_a, outcomes_a, 2, NOW).consensus]
    # Chained: the second settle takes the first one's pending state.
    consensus.append(side.settle(store, plan_a, outcomes_a, 3, NOW + 2.5).consensus)
    # The store grows past its capacity after plan_b and again after
    # plan_c is built, before either settles.
    plan_b = side.pipe.build_settlement_plan(store, payloads_b)
    plan_c = side.pipe.build_settlement_plan(store, payloads_c)
    # Backdated: now precedes the stamps already written (epoch rebase).
    consensus.append(side.settle(store, plan_b, outcomes_b, 1, NOW - 40.0).consensus)
    consensus.append(side.settle(store, plan_c, outcomes_c, 2, NOW + 1.0).consensus)
    # A host read mid-chain, then a settle that reuses the synced cache.
    records_mid = _records(store)
    consensus.append(side.settle(store, plan_a, outcomes_a, 1, NOW + 4.0).consensus)
    return consensus, records_mid + _records(store), _dump(store, tmp / "c.db")


def scenario_orphan(side, tmp, _steps):
    """A chain link that took the pending state and never deferred a
    successor (its kernel raised): the settle's own sync recipe still
    brings its results to the host (closed-form stamps, gathered rows)."""
    payloads, outcomes = make_payloads(8, 40, 20)
    store = side.store()
    plan = side.pipe.build_settlement_plan(store, payloads)
    consensus = [side.settle(store, plan, outcomes, 3, NOW).consensus]
    side.take_state(store)  # the failed successor's hand-forward
    rows = _records(store)
    consensus.append(side.settle(store, plan, outcomes, 2, NOW + 1.0).consensus)
    return consensus, rows + _records(store), _dump(store, tmp / "o.db")


def scenario_columnar(side, tmp, _steps):
    """Columnar input with empty markets and one market of 40 sources."""
    payloads, outcomes = make_payloads(5, 90, 30)
    wide = [{"sourceId": f"wide-{i}", "probability": float(i % 7) / 6.0}
            for i in range(40)]
    payloads[17] = ("m-17", wide)
    payloads[18] = ("m-18", [])
    keys, sources, probs, offsets = to_columns(payloads)
    store = side.store()
    for record in seed_records(payloads, side.record, seed=11):
        store.put_record(record)
    plan = side.pipe.build_settlement_plan_columnar(
        store, keys, sources, probs, offsets
    )
    assert plan.num_slots == 40
    consensus = [side.settle(store, plan, outcomes, 2, NOW).consensus]
    consensus.append(side.settle(store, plan, outcomes, 5, NOW + 1.0).consensus)
    return consensus, _records(store), _dump(store, tmp / "k.db")


def scenario_carried(side, tmp, _steps):
    """State carried across: a JAX-settled store reaches the port through
    ``store_from_records`` and through its SQLite file; both then settle
    the same next batch as the JAX store does."""
    payloads, outcomes = make_payloads(6, 50, 20)
    later, later_outcomes = make_payloads(7, 50, 20)
    with jax.enable_x64():
        origin = JaxStore()
        jpipe.settle_payloads(origin, payloads, outcomes, steps=2, now=NOW)
        records = origin.list_sources()
        origin.flush_to_sqlite(tmp / "origin.db")
    origin_db = tmp / "origin.db"
    if side.kind == "jax":
        makers = [lambda: JaxStore.from_sqlite(origin_db)] * 2
    else:
        makers = [
            lambda: store_from_records(records, device="cpu"),
            lambda: TorchStore.from_sqlite(origin_db, device="cpu"),
        ]
    consensus, rows = [], []
    for make in makers:
        store = make()
        plan = side.pipe.build_settlement_plan(store, later)
        consensus.append(
            side.settle(store, plan, later_outcomes, 3, NOW + 5.0).consensus
        )
        rows.extend(_records(store))
    return consensus, rows, _dump(store, tmp / "r.db")


SCENARIOS = {
    "single": scenario_single,
    "chain": scenario_chain,
    "orphan": scenario_orphan,
    "columnar": scenario_columnar,
    "carried": scenario_carried,
}
CASES = (
    [("single", name, steps) for name in ("f32", "f64") for steps in (0, 1, 2, 5)]
    + [(kind, name, 0) for kind in ("chain", "orphan", "columnar", "carried")
       for name in ("f32", "f64")]
)
IDS = [f"{kind}-{name}-{steps}" for kind, name, steps in CASES]


@pytest.fixture(scope="module")
def outcomes_of(tmp_path_factory):
    """Both packages' results per case, computed once and shared."""
    cache = {}

    def run(case):
        if case not in cache:
            kind, name, steps = case
            scenario = SCENARIOS[kind]
            results = {}
            with pytest.MonkeyPatch.context() as patch:
                patch.setenv("BCE_NO_NATIVE", "1")
                for pkg in ("jax", "torch"):
                    tmp = tmp_path_factory.mktemp(f"{kind}-{name}-{pkg}")
                    side = Side(pkg, name)
                    if pkg == "jax" and name == "f64":
                        with jax.enable_x64():
                            results[pkg] = scenario(side, tmp, steps)
                    else:
                        results[pkg] = scenario(side, tmp, steps)
            cache[case] = results
        return cache[case]

    return run


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_consensus_matches_jax(outcomes_of, case):
    results = outcomes_of(case)
    ours, theirs = results["torch"][0], results["jax"][0]
    assert len(ours) == len(theirs)
    for mine, ref in zip(ours, theirs):
        mine, ref = np.asarray(mine), np.asarray(ref)
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(np.isnan(mine), np.isnan(ref))
        np.testing.assert_allclose(mine, ref, equal_nan=True, **TOL[case[1]])
    if case[0] == "single" and case[2] == 0:
        assert not np.any(ours[0])  # steps == 0: zeros, nothing settles


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_records_match_jax(outcomes_of, case):
    results = outcomes_of(case)
    assert results["torch"][1] == results["jax"][1]
    assert results["torch"][1]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sqlite_dump_matches_jax(outcomes_of, case):
    results = outcomes_of(case)
    assert results["torch"][2] == results["jax"][2]
