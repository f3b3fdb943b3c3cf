"""The port's session on a (markets, sources) mesh ≡ the JAX package's.

The same payloads, outcomes, ``now`` and ``steps`` go through
``bayesian_consensus_engine_tpu.pipeline.ShardedSettlementSession`` on a
mesh of CPU devices and the port's ``ShardedSettlementSession`` on a mesh
of the same shape whose every device is the CPU, from stores holding the
same records. The meshes are (1, 2), (1, 4) and (2, 4); the JAX session
runs its sources-sharded route with ``kernel="xla"`` (the fused program
with its psums) and ``kernel="pallas"`` (the partials kernel in interpret
mode, then its merge). The plan's 9-deep slot axis is padded to a multiple
of the sources extent, so some shards hold pad slots.

Scenarios, each a chain of settles on one session: ``settle_with_analytics``
twice (the second at the first's last stamp, so no read decays), then
``settle_with_tiebreak``, ``settle`` and, backdated before the session's
epoch (the state is rebuilt), ``settle_with_analytics`` again; and the
analytics pair alone under ``kernel="pallas"``. After each scenario:

* the block state (``convert.sharded_block_to_numpy`` of the port's grid of
  shards, ``np.asarray`` of the JAX session's arrays), ``list_sources()``
  and the SQLite ``iterdump()`` of both ``flush_to_sqlite`` files are
  bit-equal;
* the consensus agrees within rtol=1e-5, atol=1e-6 (f32) or rtol=1e-12
  (f64), NaNs in the same places;
* the tie-break and bands are bit-equal where no read decays; after the
  backdated settle (reads decay: XLA's ``exp2`` differs by ulps)
  ``num_groups`` and the band count stay equal and the float fields agree
  within rtol=1e-5, atol=1e-3.

Also here: float64 with the tie-break off, the zero-step rule, a graph on a
(1, S) mesh and on a (2, 2) mesh, the JAX session's block state carried into a port session
(``convert.sharded_block_from_numpy``), the refusals, and
``pad_markets``/``init_block_state``.
Probabilities lie on a 1/8 grid, so many markets hold tied groups whose
members lie on different shards. Each scenario runs once per module.
"""

import sqlite3

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.analytics import AnalyticsOptions as JaxOptions
from bayesian_consensus_engine_tpu.analytics import MarketGraph as JaxGraph
from bayesian_consensus_engine_tpu.parallel import mesh as jmesh
from bayesian_consensus_engine_tpu.parallel import sharded as jsharded
from bayesian_consensus_engine_tpu.state.records import (
    ReliabilityRecord as JaxRecord,
)
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import convert
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.analytics import AnalyticsOptions
from bayesian_consensus_engine_tpu_torch.analytics.graph import MarketGraph
from bayesian_consensus_engine_tpu_torch.parallel import mesh as tmesh
from bayesian_consensus_engine_tpu_torch.parallel import sharded as tsharded
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
DECAYED_TOL = dict(rtol=1e-5, atol=1e-3)  # stderr/lo/hi cancel
STAMPS = (days_to_iso(NOW), "")


def make_payloads(seed, num_markets=45, universe=14, max_signals=9):
    """Dict payloads on a 1/8 probability grid, with duplicate-source
    signals and empty markets; K = 9 after packing."""
    rng = np.random.default_rng(seed)
    payloads = []
    for m in range(num_markets):
        count = int(rng.integers(0, max_signals + 1))
        if m == 1:
            count = max_signals  # pins K
        sources = [f"src-{int(s)}" for s in rng.choice(universe, count, replace=False)]
        probs = rng.integers(0, 9, count) / 8
        payloads.append((
            f"m-{m}",
            [{"sourceId": s, "probability": float(p)}
             for s, p in zip(sources, probs)],
        ))
    outcomes = (rng.random(num_markets) < 0.5).tolist()
    return payloads, outcomes


def make_store(kind, payloads, seed=9):
    """A store holding records for a third of the markets' first two
    signals, stamped ``NOW`` or never."""
    store = JaxStore() if kind == "jax" else TorchStore(device="cpu")
    record_cls = JaxRecord if kind == "jax" else TorchRecord
    rng = np.random.default_rng(seed)
    for market_id, signals in payloads[::3]:
        for signal in signals[:2]:
            store.put_record(record_cls(
                source_id=signal["sourceId"], market_id=market_id,
                reliability=float(np.round(rng.random(), 6)),
                confidence=float(np.round(rng.random(), 6)),
                updated_at=STAMPS[int(rng.integers(0, len(STAMPS)))],
            ))
    return store


def make_session(kind, store, plan, shape, dtype="f32"):
    if kind == "jax":
        mesh = jmesh.make_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])
        return jpipe.ShardedSettlementSession(store, plan, mesh)
    mesh = tmesh.make_mesh(shape, [torch.device("cpu")] * (shape[0] * shape[1]))
    return tpipe.ShardedSettlementSession(
        store, plan, mesh, dtype=TORCH_DTYPE[dtype]
    )


def block_state(kind, session):
    if kind == "jax":
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


def run_scenario(kind, shape, scenario, tmp, dtype="f32"):
    """Returns (consensus list, [(exact, analytics fields)], block state,
    records, dump)."""
    payloads, outcomes = make_payloads(1)
    store = make_store(kind, payloads)
    pipe = jpipe if kind == "jax" else tpipe
    plan = pipe.build_settlement_plan(store, payloads)
    session = make_session(kind, store, plan, shape, dtype)
    options = JaxOptions if kind == "jax" else AnalyticsOptions
    jax_kernel = {"chain_pallas": "pallas"}.get(scenario, "xla")
    tiebreak_on = dtype == "f32"
    consensus, analytics = [], []

    def analyse(now, exact):
        result, tiebreak, bands, propagated = session.settle_with_analytics(
            outcomes, steps=STEPS, now=now,
            analytics=options(tiebreak=tiebreak_on),
            kernel=jax_kernel if kind == "jax" else None,
        )
        assert propagated is None and (tiebreak is None) != tiebreak_on
        if tiebreak is not None:
            analytics.append((exact, _fields(tiebreak)))
        analytics.append((exact, _fields(bands)))
        return result

    # The second call reads the first one's stamps at elapsed time 0.
    consensus.append(analyse(NOW, True).consensus)
    consensus.append(analyse(NOW + STEPS - 1, True).consensus)
    if scenario == "chain":
        later = NOW + 2 * STEPS - 2
        result, tiebreak = session.settle_with_tiebreak(
            outcomes, steps=STEPS, now=later,
        )
        analytics.append((True, _fields(tiebreak)))
        consensus.append(result.consensus)
        consensus.append(session.settle(
            outcomes, steps=STEPS, now=later + STEPS - 1
        ).consensus)
        # Backdated before the epoch: the state is rebuilt from the store.
        consensus.append(analyse(NOW - 400.0, False).consensus)
    state = block_state(kind, session)
    session.close()
    return (consensus, analytics, state, _records(store),
            _dump(store, tmp / "s.db"))


MESHES = [(1, 2), (1, 4), (2, 4)]
CASES = (
    [(shape, "chain", "f32") for shape in MESHES]
    + [(shape, "chain_pallas", "f32") for shape in MESHES]
    + [((1, 2), "chain_f64", "f64")]
)
IDS = [f"{s[0]}x{s[1]}-{scenario}" for s, scenario, _ in CASES]


@pytest.fixture(scope="module")
def outcomes_of(tmp_path_factory):
    """Both packages' results per case, computed once and shared."""
    cache = {}

    def run(case):
        if case not in cache:
            shape, scenario, dtype = case
            results = {}
            with pytest.MonkeyPatch.context() as patch:
                patch.setenv("BCE_NO_NATIVE", "1")
                for kind in ("jax", "torch"):
                    tmp = tmp_path_factory.mktemp(f"{scenario}-{kind}")
                    if kind == "jax" and dtype == "f64":
                        with jax.enable_x64():
                            results[kind] = run_scenario(
                                kind, shape, scenario, tmp, dtype)
                    else:
                        results[kind] = run_scenario(kind, shape, scenario, tmp, dtype)
            cache[case] = results
        return cache[case]

    return run


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_block_state_matches_jax(outcomes_of, case):
    results = outcomes_of(case)
    fields = ("reliability", "confidence", "updated_days", "exists")
    for field, ours, theirs in zip(fields, results["torch"][2], results["jax"][2]):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, field
        np.testing.assert_array_equal(ours, theirs, err_msg=field)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_records_and_sqlite_match_jax(outcomes_of, case):
    results = outcomes_of(case)
    assert results["torch"][3] == results["jax"][3]
    assert results["torch"][3]
    assert results["torch"][4] == results["jax"][4]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_consensus_matches_jax(outcomes_of, case):
    results = outcomes_of(case)
    ours, theirs = results["torch"][0], results["jax"][0]
    assert len(ours) == len(theirs)
    for mine, ref in zip(ours, theirs):
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        np.testing.assert_array_equal(np.isnan(mine), np.isnan(ref))
        np.testing.assert_allclose(mine, ref, equal_nan=True, **TOL[case[2]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_analytics_match_jax(outcomes_of, case):
    results = outcomes_of(case)
    ours, theirs = results["torch"][1], results["jax"][1]
    assert len(ours) == len(theirs) > 0
    for (exact, mine), (_, ref) in zip(ours, theirs):
        assert mine.keys() == ref.keys()
        for name in ref:
            a, b = mine[name], ref[name]
            assert a.dtype == b.dtype, name
            if exact or name in ("num_groups", "count"):
                np.testing.assert_array_equal(a, b, err_msg=name)
            elif a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, equal_nan=True, err_msg=name,
                                           **DECAYED_TOL)


def test_groups_span_shards():
    """The scenario's tie-break groups really cross shard boundaries: some
    market has equal probabilities in slots of two different sources
    shards of the (1, 4) mesh (the padded K = 12 cut in threes)."""
    payloads, _ = make_payloads(1)
    plan = tpipe.build_settlement_plan(make_store("torch", payloads), payloads)
    assert plan.num_slots == 9
    probs = np.where(plan.mask, plan.probs, np.nan)
    spans = 0
    for m in range(plan.num_markets):
        for a in range(plan.num_slots):
            for b in range(a + 1, plan.num_slots):
                if a // 3 != b // 3 and probs[a, m] == probs[b, m]:
                    spans += 1
    assert spans > 0


# -- the zero-step rule --------------------------------------------------------


def _zero_step(kind, kernel):
    payloads, outcomes = make_payloads(4)
    store = make_store(kind, payloads)
    plan = (jpipe if kind == "jax" else tpipe).build_settlement_plan(store, payloads)
    session = make_session(kind, store, plan, (1, 2))
    options = (JaxOptions if kind == "jax" else AnalyticsOptions)()
    out = session.settle_with_analytics(
        outcomes, steps=0, now=NOW, analytics=options, kernel=kernel,
    )
    state = block_state(kind, session)
    session.close()
    return out, state


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_zero_steps_refused_with_pallas_kernel(kind):
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("BCE_NO_NATIVE", "1")
        with pytest.raises(ValueError, match="steps=0 on a sources-sharded"):
            _zero_step(kind, "pallas")


@pytest.mark.parametrize("kernel", ["xla", "auto"])
def test_zero_steps_match_xla_program(kernel):
    """Zero steps on a sources-sharded mesh: the zero consensus, the
    analytics of the unchanged state, and the state itself."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("BCE_NO_NATIVE", "1")
        want, want_state = _zero_step("jax", "xla")
        got, got_state = _zero_step("torch", kernel)
    np.testing.assert_array_equal(np.asarray(got[0].consensus),
                                  np.asarray(want[0].consensus))
    assert not np.any(np.asarray(got[0].consensus))
    for mine, ref in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(ref))
    for ours, theirs in zip(got_state, want_state):
        np.testing.assert_array_equal(ours, theirs)


# -- a graph on a (1, S) mesh --------------------------------------------------


@pytest.fixture(scope="module")
def graph_outcomes():
    payloads, outcomes = make_payloads(5)
    keys = [market_id for market_id, _ in payloads]
    rng = np.random.default_rng(3)
    edges = [(keys[a], keys[b], float(w)) for a, b, w in zip(
        rng.integers(0, len(keys), 90), rng.integers(0, len(keys), 90),
        rng.uniform(0.5, 1.5, 90)) if a != b]
    jgraph = JaxGraph.from_edges(edges, damping=0.4, steps=5)
    tgraph = convert.market_graph_from_fields(
        jgraph.node_ids, jgraph.offsets, jgraph.indices, jgraph.weights,
        jgraph.damping, jgraph.steps, jgraph.fingerprint,
    )
    results = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("BCE_NO_NATIVE", "1")
        for kind, graph, options in (("jax", jgraph, JaxOptions),
                                     ("torch", tgraph, AnalyticsOptions)):
            store = make_store(kind, payloads)
            plan = (jpipe if kind == "jax" else tpipe).build_settlement_plan(
                store, payloads)
            session = make_session(kind, store, plan, (1, 4))
            calls = [session.settle_with_analytics(
                outcomes, steps=STEPS, now=now, analytics=options(graph=graph),
            ) for now in (NOW, NOW + STEPS - 1)]
            results[kind] = (calls, block_state(kind, session))
            session.close()
    return results


def test_graph_sweep_on_sources_sharded_mesh(graph_outcomes):
    """The sweep runs once on the merged consensus: the propagated means
    agree with the JAX session's within the consensus tolerance, and the
    block state is bit-equal."""
    (got, got_state), (want, want_state) = (
        graph_outcomes["torch"], graph_outcomes["jax"])
    for mine, ref in zip(got, want):
        a, b = np.asarray(mine[3]), np.asarray(ref[3])
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, equal_nan=True, **TOL["f32"])
    for ours, theirs in zip(got_state, want_state):
        np.testing.assert_array_equal(ours, theirs)


# -- the JAX session's block state carried across ------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=[f"{m}x{s}" for m, s in MESHES])
def test_port_session_settles_on_from_jax_block_state(shape):
    """``convert.sharded_block_from_numpy`` cuts the JAX session's padded
    global block state into the port's grid of shards bit for bit, and a
    port session handed that grid settles on to the JAX session's state."""
    payloads, outcomes = make_payloads(7)
    sessions = {}
    for kind in ("jax", "torch"):
        store = make_store(kind, payloads)
        plan = (jpipe if kind == "jax" else tpipe).build_settlement_plan(
            store, payloads)
        sessions[kind] = make_session(kind, store, plan, shape)
        sessions[kind].settle(outcomes, steps=STEPS, now=NOW)
    jstate = block_state("jax", sessions["jax"])
    port = sessions["torch"]
    port._state = convert.sharded_block_from_numpy(jstate, port._mesh)
    assert len(port._state) == shape[0] and len(port._state[0]) == shape[1]
    for ours, theirs in zip(block_state("torch", port), jstate):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs)
    for session in sessions.values():
        session.settle(outcomes, steps=STEPS, now=NOW + STEPS - 1)
    for ours, theirs in zip(block_state("torch", port),
                            block_state("jax", sessions["jax"])):
        np.testing.assert_array_equal(ours, theirs)
    for session in sessions.values():
        session.close()


# -- refusals ------------------------------------------------------------------


def _port_session(shape):
    payloads, outcomes = make_payloads(2)
    store = make_store("torch", payloads)
    plan = tpipe.build_settlement_plan(store, payloads)
    return store, plan, outcomes


def test_graph_on_markets_sharded_mesh_raises():
    """A graph on a (2, 2) mesh: refused until the sweep could run over the
    gathered markets axis, now served and held against the JAX session on
    the same mesh. One step at the records' stamp reads nothing decayed,
    so state, consensus and propagated means are bit-equal
    (``tests/test_torch_markets_graph.py`` covers the other meshes and
    the moments lane)."""
    payloads, outcomes = make_payloads(2)
    results = {}
    for kind, graph, options in (
        ("jax", JaxGraph.from_edges([("m-0", "m-1", 1.0), ("m-40", "m-2", 0.5)]),
         JaxOptions),
        ("torch", MarketGraph.from_edges([("m-0", "m-1", 1.0), ("m-40", "m-2", 0.5)]),
         AnalyticsOptions),
    ):
        store = make_store(kind, payloads)
        plan = (jpipe if kind == "jax" else tpipe).build_settlement_plan(
            store, payloads)
        with make_session(kind, store, plan, (2, 2)) as session:
            result, _tb, _bands, propagated = session.settle_with_analytics(
                outcomes, now=NOW, analytics=options(graph=graph),
            )
            results[kind] = (np.asarray(result.consensus),
                             np.asarray(propagated), block_state(kind, session))
    (cons, mean, state), (cons_ref, mean_ref, state_ref) = (
        results["torch"], results["jax"])
    np.testing.assert_array_equal(cons, cons_ref)
    np.testing.assert_array_equal(mean, mean_ref)
    assert mean.shape == (len(payloads),)
    assert not np.array_equal(mean, cons, equal_nan=True)
    for ours, theirs in zip(state, state_ref):
        np.testing.assert_array_equal(ours, theirs)


def test_sorted_tiebreak_on_sources_sharded_mesh_raises():
    store, plan, outcomes = _port_session((1, 2))
    with make_session("torch", store, plan, (1, 2)) as session:
        with pytest.raises(ValueError, match="keep the ring tie-break"):
            session.settle_with_analytics(
                outcomes, now=NOW, analytics=AnalyticsOptions(tiebreak="sorted"),
            )


def test_process_band_raises():
    """A band plan that does not tile this process's band is refused (in
    one process the band starts at row 0), with the JAX package's
    message; bands that do are served (``tests/test_torch_band_session.py``)."""
    store, plan, _outcomes = _port_session((1, 2))
    mesh = tmesh.make_mesh((1, 2), [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="band plan covers rows"):
        tpipe.ShardedSettlementSession(store, plan, mesh,
                                       band=(3, plan.num_markets + 3))


def test_float64_tiebreak_raises_on_mesh():
    store, plan, outcomes = _port_session((1, 2))
    with make_session("torch", store, plan, (1, 2), "f64") as session:
        with pytest.raises(ValueError, match="no float64 tie-break"):
            session.settle_with_tiebreak(outcomes, now=NOW)


def test_make_mesh_checks_like_the_reference():
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        tmesh.make_mesh((2, 2), [torch.device("cpu")] * 3)
    mesh = tmesh.make_mesh(devices=[torch.device("cpu")] * 3)
    assert mesh.shape == {"markets": 3, "sources": 1}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh((1, 1))


# -- pad_markets and init_block_state ------------------------------------------


def test_pad_markets_and_init_block_state_match_jax():
    rng = np.random.default_rng(6)
    probs = rng.random((5, 13)).astype(np.float32)
    mask = rng.random((5, 13)) < 0.6
    outcome = rng.random(13) < 0.5
    jstate = jsharded.init_block_state(5, 13)
    tstate = tsharded.init_block_state(5, 13, device="cpu")
    for ours, theirs in zip(tstate, jstate):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    jstate_t = jsharded.MarketBlockState(*(x.T for x in jstate))
    tstate_t = tsharded.MarketBlockState(*(x.T.contiguous() for x in tstate))
    want = jsharded.pad_markets(jnp.asarray(probs), jnp.asarray(mask),
                                jnp.asarray(outcome), jstate_t, multiple=8)
    got = tsharded.pad_markets(torch.tensor(probs), torch.tensor(mask),
                               torch.tensor(outcome), tstate_t, multiple=8)
    assert got[4] == want[4] == 16
    for ours, theirs in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    for ours, theirs in zip(got[3], want[3]):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
