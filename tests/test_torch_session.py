"""The port's resident session ≡ the JAX package's one-device session.

The same payloads, outcomes, ``now`` and ``steps`` go through
``bayesian_consensus_engine_tpu.pipeline.ShardedSettlementSession`` on a
1×1 mesh of one CPU device and the port's ``ShardedSettlementSession`` on
the CPU, from stores holding the same records. Scenarios: chained
``settle_with_analytics`` (f32), the same with decaying reads,
``settle_with_tiebreak``, ``settle`` with the one-shot ``settle_sharded``,
``AnalyticsOptions(tiebreak=False)``, and that in float64 (JAX with x64
on; the reference has no float64 tie-break). After each scenario:

* the session's whole block state (reliability, confidence, stamps,
  existence), ``list_sources()`` and the SQLite ``iterdump()`` of both
  ``flush_to_sqlite`` files are bit-equal;
* the consensus agrees within rtol=1e-5, atol=1e-6 (f32) or rtol=1e-12
  (f64), NaNs in the same places;
* the tie-break and bands are bit-equal where no read decays (every
  stamp the settles read is ``now``); in the decaying scenario the JAX
  ``exp2`` differs by ulps: ``num_groups`` and the band count stay
  equal and the float fields agree within rtol=1e-5, atol=1e-3 (the band
  stderr, lo and hi cancel, see ``tests/test_torch_analytics_math.py``).

Probabilities lie on a 1/8 grid, so many markets hold tied groups. Each
scenario runs once per module and its cases share the result.
"""

import sqlite3

import numpy as np
import pytest
import torch

import jax

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.analytics import AnalyticsOptions as JaxOptions
from bayesian_consensus_engine_tpu.parallel.mesh import make_mesh
from bayesian_consensus_engine_tpu.state.records import (
    ReliabilityRecord as JaxRecord,
)
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import convert
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.analytics import AnalyticsOptions
from bayesian_consensus_engine_tpu_torch.state.records import (
    ReliabilityRecord as TorchRecord,
)
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore as TorchStore,
)
from bayesian_consensus_engine_tpu_torch.utils.timeconv import days_to_iso

NOW = 20000.25  # epoch-days, 2024-10-04
STEPS = 3
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "f64": dict(rtol=1e-12, atol=0.0)}
TORCH_DTYPE = {"f32": torch.float32, "f64": torch.float64}
ANALYTICS_TOL = dict(rtol=1e-5, atol=1e-3)  # stderr/lo/hi cancel: see module doc
STATE_FIELDS = ("reliability", "confidence", "updated_days", "exists")


def make_payloads(seed, num_markets=48, universe=14, max_signals=6):
    """Dict payloads on a 1/8 probability grid, with duplicate-source
    signals and empty markets."""
    rng = np.random.default_rng(seed)
    payloads = []
    for m in range(num_markets):
        count = int(rng.integers(0, max_signals + 1))
        sources = [f"src-{int(s)}" for s in rng.integers(0, universe, count)]
        probs = rng.integers(0, 9, count) / 8
        payloads.append((
            f"m-{m}",
            [{"sourceId": s, "probability": float(p)}
             for s, p in zip(sources, probs)],
        ))
    outcomes = (rng.random(num_markets) < 0.5).tolist()
    return payloads, outcomes


def seed_records(payloads, record_cls, stamps, seed=9):
    rng = np.random.default_rng(seed)
    records = []
    for market_id, signals in payloads[::3]:
        for signal in signals[:2]:
            records.append(record_cls(
                source_id=signal["sourceId"], market_id=market_id,
                reliability=float(np.round(rng.random(), 6)),
                confidence=float(np.round(rng.random(), 6)),
                updated_at=stamps[int(rng.integers(0, len(stamps)))],
            ))
    return records


class Side:
    """One package's session surface, so a scenario runs the same on both."""

    def __init__(self, kind, name):
        self.kind, self.name = kind, name

    def store(self, payloads, stamps):
        store = JaxStore() if self.kind == "jax" else TorchStore(device="cpu")
        record = JaxRecord if self.kind == "jax" else TorchRecord
        seen = set()
        for rec in seed_records(payloads, record, stamps):
            if (rec.source_id, rec.market_id) not in seen:
                seen.add((rec.source_id, rec.market_id))
                store.put_record(rec)
        return store

    def plan(self, store, payloads):
        pipe = jpipe if self.kind == "jax" else tpipe
        return pipe.build_settlement_plan(store, payloads)

    def session(self, store, plan):
        if self.kind == "jax":
            mesh = make_mesh((1, 1), devices=jax.devices()[:1])
            return jpipe.ShardedSettlementSession(store, plan, mesh)
        return tpipe.ShardedSettlementSession(
            store, plan, dtype=TORCH_DTYPE[self.name]
        )

    def settle_sharded(self, store, plan, outcomes, steps, now):
        if self.kind == "jax":
            mesh = make_mesh((1, 1), devices=jax.devices()[:1])
            return jpipe.settle_sharded(
                store, plan, outcomes, mesh, steps=steps, now=now
            )
        return tpipe.settle_sharded(
            store, plan, outcomes, steps=steps, now=now,
            dtype=TORCH_DTYPE[self.name],
        )

    def options(self, **fields):
        return (JaxOptions if self.kind == "jax" else AnalyticsOptions)(**fields)

    def block_state(self, session):
        if self.kind == "jax":
            return tuple(np.asarray(x) for x in session._state)
        return tuple(convert.sharded_block_to_numpy(session._state))


def _fields(result):
    return {name: np.asarray(x) for name, x in zip(result._fields, result)}


def _records(store):
    return [
        (r.source_id, r.market_id, r.reliability, r.confidence, r.updated_at)
        for r in store.list_sources()
    ]


def _dump(store, path):
    store.flush_to_sqlite(path)
    with sqlite3.connect(path) as conn:
        return list(conn.iterdump())


def run_scenario(side, kind, tmp):
    """Returns (consensus list, analytics list, block state, records, dump)."""
    exact = kind != "decayed"
    payloads, outcomes = make_payloads(1)
    stamps = (days_to_iso(NOW), "") if exact else (
        "2024-08-01T00:00:00+00:00", days_to_iso(NOW), ""
    )
    store = side.store(payloads, stamps)
    plan = side.plan(store, payloads)
    session = side.session(store, plan)
    # The second settle reads the first one's stamps (now + steps - 1) at
    # elapsed time 0, or, in the decaying scenario, 10 days later.
    times = (NOW, NOW + STEPS - 1) if exact else (NOW, NOW + STEPS + 9)
    consensus, analytics = [], []
    for now in times:
        if kind in ("analytics", "decayed", "bands_only"):
            options = side.options(tiebreak=kind != "bands_only")
            result, tiebreak, bands, propagated = session.settle_with_analytics(
                outcomes, steps=STEPS, now=now, analytics=options,
            )
            assert propagated is None
            assert (tiebreak is None) == (kind == "bands_only")
            if tiebreak is not None:
                analytics.append(_fields(tiebreak))
            analytics.append(_fields(bands))
        elif kind == "tiebreak":
            result, tiebreak = session.settle_with_tiebreak(
                outcomes, steps=STEPS, now=now,
            )
            analytics.append(_fields(tiebreak))
        else:
            result = session.settle(outcomes, steps=STEPS, now=now)
        result.fence()
        consensus.append(result.consensus)
    state = side.block_state(session)
    session.close()
    records = _records(store)
    if kind == "settle":
        other = side.store(payloads, stamps)
        other_plan = side.plan(other, payloads)
        consensus.append(side.settle_sharded(
            other, other_plan, outcomes, STEPS, NOW
        ).consensus)
        records += _records(other)
    return consensus, analytics, state, records, _dump(store, tmp / "s.db")


CASES = [("analytics", "f32"), ("decayed", "f32"), ("tiebreak", "f32"),
         ("settle", "f32"), ("bands_only", "f32"), ("bands_only", "f64")]
IDS = [f"{kind}-{name}" for kind, name in CASES]


@pytest.fixture(scope="module")
def outcomes_of(tmp_path_factory):
    """Both packages' results per case, computed once and shared."""
    cache = {}

    def run(case):
        if case not in cache:
            kind, name = case
            results = {}
            with pytest.MonkeyPatch.context() as patch:
                patch.setenv("BCE_NO_NATIVE", "1")
                for pkg in ("jax", "torch"):
                    tmp = tmp_path_factory.mktemp(f"{kind}-{name}-{pkg}")
                    side = Side(pkg, name)
                    if pkg == "jax" and name == "f64":
                        with jax.enable_x64():
                            results[pkg] = run_scenario(side, kind, tmp)
                    else:
                        results[pkg] = run_scenario(side, kind, tmp)
            cache[case] = results
        return cache[case]

    return run


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_block_state_matches_jax(outcomes_of, case):
    results = outcomes_of(case)
    for field, ours, theirs in zip(STATE_FIELDS, results["torch"][2],
                                   results["jax"][2]):
        assert ours.dtype == theirs.dtype, field
        np.testing.assert_array_equal(ours, theirs, err_msg=field)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_records_match_jax(outcomes_of, case):
    results = outcomes_of(case)
    assert results["torch"][3] == results["jax"][3]
    assert results["torch"][3]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sqlite_dump_matches_jax(outcomes_of, case):
    results = outcomes_of(case)
    assert results["torch"][4] == results["jax"][4]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_consensus_matches_jax(outcomes_of, case):
    results = outcomes_of(case)
    ours, theirs = results["torch"][0], results["jax"][0]
    assert len(ours) == len(theirs)
    for mine, ref in zip(ours, theirs):
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(np.isnan(mine), np.isnan(ref))
        np.testing.assert_allclose(mine, ref, equal_nan=True, **TOL[case[1]])


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "settle"],
                         ids=[i for i in IDS if not i.startswith("settle")])
def test_analytics_match_jax(outcomes_of, case):
    results = outcomes_of(case)
    ours, theirs = results["torch"][1], results["jax"][1]
    assert len(ours) == len(theirs) > 0
    for mine, ref in zip(ours, theirs):
        assert mine.keys() == ref.keys()
        for name in ref:
            a, b = mine[name], ref[name]
            assert a.dtype == b.dtype, name
            if case[0] != "decayed" or name in ("num_groups", "count"):
                np.testing.assert_array_equal(a, b, err_msg=name)
            elif a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, equal_nan=True, err_msg=name,
                                           **ANALYTICS_TOL)


# -- the port alone ----------------------------------------------------------


def _port_session(dtype=torch.float32, seed=2):
    payloads, outcomes = make_payloads(seed)
    store = Side("torch", "f32").store(payloads, ("2024-08-01T00:00:00+00:00",))
    plan = tpipe.build_settlement_plan(store, payloads)
    return store, plan, outcomes


def test_store_bytes_same_with_analytics_on_and_off(tmp_path):
    """Analytics only read: settle and settle_with_analytics leave the
    same store bytes and give the same consensus bits."""
    dumps, consensus, states = [], [], []
    for analytics in (False, True):
        store, plan, outcomes = _port_session()
        with tpipe.ShardedSettlementSession(store, plan) as session:
            for now in (NOW, NOW + 5.5):
                if analytics:
                    result = session.settle_with_analytics(
                        outcomes, steps=STEPS, now=now
                    )[0]
                else:
                    result = session.settle(outcomes, steps=STEPS, now=now)
                consensus.append(result.consensus)
            (shard,), = session._state  # the (1, 1) mesh's one shard
            states.append([x.clone() for x in shard])
        path = tmp_path / f"analytics-{analytics}.db"
        store.flush_to_sqlite(path)
        dumps.append(path.read_bytes())
    assert dumps[0] == dumps[1]
    for off, on in zip(consensus[:2], consensus[2:]):
        np.testing.assert_array_equal(off, on)
    for off, on in zip(*states):
        assert torch.equal(off, on)


@pytest.mark.parametrize("kernel", ["xla", "pallas", "auto"])
def test_every_kernel_name_takes_the_one_route(kernel):
    store, plan, outcomes = _port_session()
    with tpipe.ShardedSettlementSession(store, plan) as session:
        result, tiebreak, bands, _ = session.settle_with_analytics(
            outcomes, steps=2, now=NOW, kernel=kernel, sweep_kernel="auto",
        )
    reference_store, plan, outcomes = _port_session()
    with tpipe.ShardedSettlementSession(reference_store, plan) as session:
        want = session.settle_with_analytics(outcomes, steps=2, now=NOW)
    np.testing.assert_array_equal(result.consensus, want[0].consensus)
    for got, ref in zip(tiebreak + bands, want[1] + want[2]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_standing_gather_pins_no_budget():
    """The live session's recipe counts 0 bytes against the store's
    deferral budget; once the session lets go it counts its block."""
    store, plan, outcomes = _port_session()
    session = tpipe.ShardedSettlementSession(store, plan)
    session.settle(outcomes, steps=1, now=NOW)
    gather = session._standing_gather
    assert gather.held_nbytes == 0
    session._release_standing()
    (shard,), = session._state
    assert gather.held_nbytes == shard.reliability.numel() * 4
    session.close()
    assert store.live_row_count() == len(store.list_sources())


@pytest.mark.parametrize("field, value", [
    ("graph", object()),
    ("inference", object()),
    ("blocks", object()),
    ("tiebreak", "sorted"),
])
def test_unported_options_raise(field, value):
    """``graph``, ``inference`` and ``blocks`` are ported
    (``tests/test_torch_inference_session.py``) and refuse a value of the
    wrong type. ``tiebreak="sorted"`` is ported too
    (``tests/test_torch_tiebreak_batch.py``) and now runs: one-agent and
    empty markets take its NaN/0 convention."""
    store, plan, outcomes = _port_session()
    with tpipe.ShardedSettlementSession(store, plan) as session:
        if field == "tiebreak":
            _result, tiebreak, _bands, _ = session.settle_with_analytics(
                outcomes, now=NOW, analytics=AnalyticsOptions(**{field: value}),
            )
            empty = np.asarray(tiebreak.num_groups) == 0
            assert empty.any()
            assert np.isnan(np.asarray(tiebreak.prediction)[empty]).all()
            return
        with pytest.raises(TypeError, match=f"analytics.{field} takes"):
            session.settle_with_analytics(
                outcomes, now=NOW, analytics=AnalyticsOptions(**{field: value}),
            )


@pytest.mark.parametrize("call, match", [
    (dict(kernel="bogus"), "kernel='bogus'"),
    (dict(kernel="pallas", analytics=AnalyticsOptions(tiebreak=False)),
     "kernel='pallas' unavailable"),
    (dict(sweep_kernel="bogus"), "sweep_kernel='bogus'"),
    (dict(sweep_kernel="pallas"), "no graph sweep"),
    (dict(analytics=AnalyticsOptions(tiebreak="maybe")), "tiebreak='maybe'"),
    (dict(analytics=AnalyticsOptions(chunk_slots="auto")), "chunk_slots='auto'"),
])
def test_invalid_analytics_arguments_raise(call, match):
    store, plan, outcomes = _port_session()
    with tpipe.ShardedSettlementSession(store, plan) as session:
        with pytest.raises(ValueError, match=match):
            session.settle_with_analytics(outcomes, now=NOW, **call)


@pytest.mark.parametrize("entry", ["analytics", "tiebreak"])
def test_float64_tiebreak_raises(entry):
    store, plan, outcomes = _port_session()
    with tpipe.ShardedSettlementSession(
        store, plan, dtype=torch.float64
    ) as session:
        with pytest.raises(ValueError, match="no float64 tie-break"):
            if entry == "analytics":
                session.settle_with_analytics(outcomes, now=NOW)
            else:
                session.settle_with_tiebreak(outcomes, now=NOW)


@pytest.mark.parametrize("kwargs, error, match", [
    (dict(mesh=object()), TypeError, "mesh takes a parallel.mesh.Mesh"),
    (dict(band=(1, 10)), ValueError, "band plan covers rows"),
], ids=["kwargs0", "kwargs1"])
def test_meshes_and_bands_raise(kwargs, error, match):
    """A mesh must be a ``parallel.mesh.Mesh`` (meshes are served since
    the sources-sharded slice, ``tests/test_torch_sharded_session.py``);
    a band plan must tile this process's band of the axis, which in one
    process starts at row 0 (bands are served,
    ``tests/test_torch_band_session.py``)."""
    store, plan, _outcomes = _port_session()
    with pytest.raises(error, match=match):
        tpipe.ShardedSettlementSession(store, plan, **kwargs)
