"""The port's session with graph inference ≡ the JAX package's.

The same payloads, outcomes, ``now`` and ``steps`` go through
``bayesian_consensus_engine_tpu.pipeline.ShardedSettlementSession`` on a
1×1 mesh of one CPU device and the port's session on the CPU, each with
two chained ``settle_with_analytics`` calls. One graph feeds both: the
JAX ``MarketGraph`` is carried across with
``convert.market_graph_from_fields``. Scenarios: a graph alone (the point
lane), ``inference`` at a fixed depth, ``inference`` with ``tol``, and
``blocks`` composed with correlation edges (``graph=blocks.to_graph(
extra_edges=...)`` with ``blocks=``); and no graph, for the byte parity.

* Block state, ``list_sources()`` and the SQLite ``iterdump()`` are
  bit-equal to the JAX session's, and the port's SQLite file is
  byte-equal with the graph on and off.
* The propagated mean and stderr agree within rtol=1e-5, atol=1e-6: the
  sweep is seeded with the consensus, which carries the reference's known
  ``exp2`` ulp (``tests/test_torch_session.py``), and the sweep's mixes
  are convex, so the difference does not grow. Where the seeds are
  bit-equal (the second call) every propagated field is bit-equal.
  ``iters_run`` is equal.
* A sweep depth of 0 gives ``None``, and every ``ValueError`` and
  ``TypeError`` the reference raises is raised here too.

Every stamp the settles read equals ``now``, so no read decays and the
band stderr seeding the variances is bit-equal. Each scenario runs once
per module and its cases share the result.
"""

import sqlite3

import numpy as np
import pytest
import torch

import jax

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.analytics import AnalyticsOptions as JaxOptions
from bayesian_consensus_engine_tpu.analytics.graph import MarketGraph as JaxGraph
from bayesian_consensus_engine_tpu.infer import blocks as jblocks
from bayesian_consensus_engine_tpu.infer.bp import (
    InferenceOptions as JaxInference,
)
from bayesian_consensus_engine_tpu.ops.propagate import (
    PropagatedBeliefs as JaxBeliefs,
)
from bayesian_consensus_engine_tpu.parallel.mesh import make_mesh
from bayesian_consensus_engine_tpu.state.records import (
    ReliabilityRecord as JaxRecord,
)
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import convert
from bayesian_consensus_engine_tpu_torch import infer as tinfer
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.analytics import AnalyticsOptions, MarketGraph
from bayesian_consensus_engine_tpu_torch.infer import (
    InferenceOptions,
    PropagatedBeliefs,
)
from bayesian_consensus_engine_tpu_torch.parallel import sharded
from bayesian_consensus_engine_tpu_torch.state.records import (
    ReliabilityRecord as TorchRecord,
)
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore as TorchStore,
)
from bayesian_consensus_engine_tpu_torch.utils.timeconv import days_to_iso

NOW = 20000.25  # epoch-days, 2024-10-04
STEPS = 3
MARKETS = 48
TOL = dict(rtol=1e-5, atol=1e-6)
STATE_FIELDS = ("reliability", "confidence", "updated_days", "exists")


def make_payloads(seed=1):
    """Dict payloads on a 1/8 probability grid, with empty markets."""
    rng = np.random.default_rng(seed)
    payloads = []
    for m in range(MARKETS):
        count = int(rng.integers(0, 6))
        sources = [f"src-{int(s)}" for s in rng.integers(0, 14, count)]
        probs = rng.integers(0, 9, count) / 8
        payloads.append((f"m-{m}", [
            {"sourceId": s, "probability": float(p)}
            for s, p in zip(sources, probs)
        ]))
    return payloads, (rng.random(MARKETS) < 0.5).tolist()


def correlation_edges(seed=3):
    """Random edges among the markets, some to markets absent from them."""
    rng = np.random.default_rng(seed)
    edges = []
    for m in range(MARKETS):
        for _ in range(int(rng.integers(0, 4))):
            other = int(rng.integers(0, MARKETS + 6))
            if other != m:
                name = f"m-{other}" if other < MARKETS else f"ghost-{other}"
                edges.append((f"m-{m}", name, float(rng.uniform(0.5, 1.5))))
    return edges


def block_list(module):
    """Four-way partitions over m-0 .. m-23, a parlay, an absent member."""
    blocks = [module.MarketBlock("mutually_exclusive",
                                 tuple(f"m-{4 * e + i}" for i in range(4)))
              for e in range(6)]
    blocks.append(module.MarketBlock("implies", ("m-30", "m-31", "m-32"), 2.0))
    blocks.append(module.MarketBlock("mutually_exclusive", ("m-40", "ghost-1")))
    return module.MarketBlocks(blocks)


# scenario → (graph steps, inference kwargs or None, with blocks)
SCENARIOS = {
    "graph": (3, None, False),
    "fixed": (2, dict(max_steps=5, damping=0.3), False),
    "adaptive": (2, dict(tol=4e-3, max_steps=20), False),
    "blocks": (2, dict(tol=3e-2, max_steps=12), True),
    "off": (None, None, False),
}
GRAPH_SCENARIOS = [name for name in SCENARIOS if name != "off"]


def jax_graph(name):
    steps, _, with_blocks = SCENARIOS[name]
    if with_blocks:
        return block_list(jblocks).to_graph(
            damping=0.4, steps=steps, extra_edges=correlation_edges())
    return JaxGraph.from_edges(correlation_edges(), damping=0.45, steps=steps)


def port_graph(graph):
    return convert.market_graph_from_fields(
        graph.node_ids, graph.offsets, graph.indices, graph.weights,
        graph.damping, graph.steps, graph.fingerprint,
    )


def options_for(pkg, name, **extra):
    """The scenario's AnalyticsOptions for package *pkg*."""
    steps, inference, with_blocks = SCENARIOS[name]
    fields = dict(extra)
    if steps is not None:
        graph = jax_graph(name)
        fields["graph"] = graph if pkg == "jax" else port_graph(graph)
    if inference is not None:
        fields["inference"] = (JaxInference if pkg == "jax" else InferenceOptions)(
            **inference)
    if with_blocks:
        fields["blocks"] = block_list(jblocks if pkg == "jax" else tinfer)
    return (JaxOptions if pkg == "jax" else AnalyticsOptions)(**fields)


def open_session(pkg):
    """A fresh store holding seeded records, its plan and a session."""
    payloads, outcomes = make_payloads()
    rng = np.random.default_rng(9)
    store = JaxStore() if pkg == "jax" else TorchStore(device="cpu")
    record = JaxRecord if pkg == "jax" else TorchRecord
    seen = set()
    for market_id, signals in payloads[::3]:
        for signal in signals[:2]:
            key = (signal["sourceId"], market_id)
            if key not in seen:
                seen.add(key)
                store.put_record(record(
                    source_id=key[0], market_id=market_id,
                    reliability=float(np.round(rng.random(), 6)),
                    confidence=float(np.round(rng.random(), 6)),
                    updated_at=days_to_iso(NOW),
                ))
    pipe = jpipe if pkg == "jax" else tpipe
    plan = pipe.build_settlement_plan(store, payloads)
    if pkg == "jax":
        session = jpipe.ShardedSettlementSession(
            store, plan, make_mesh((1, 1), devices=jax.devices()[:1]))
    else:
        session = tpipe.ShardedSettlementSession(store, plan)
    return store, session, outcomes


def propagated_fields(propagated):
    if propagated is None:
        return None
    if isinstance(propagated, (JaxBeliefs, PropagatedBeliefs)):
        return {name: np.asarray(value)
                for name, value in zip(propagated._fields, propagated)}
    return {"mean": np.asarray(propagated)}


def run_scenario(pkg, name, tmp):
    """Returns (per-call results, block state, records, SQLite dump)."""
    store, session, outcomes = open_session(pkg)
    calls = []
    # The second call reads the first one's stamps (now + steps - 1) at
    # elapsed time 0: no read decays.
    for now in (NOW, NOW + STEPS - 1):
        result, _tiebreak, bands, propagated = session.settle_with_analytics(
            outcomes, steps=STEPS, now=now, analytics=options_for(pkg, name),
        )
        calls.append((np.asarray(result.consensus), np.asarray(bands.stderr),
                      propagated_fields(propagated), propagated))
    state = tuple(
        np.asarray(x) for x in (session._state if pkg == "jax"
                                else convert.sharded_block_to_numpy(session._state))
    )
    session.close()
    records = [(r.source_id, r.market_id, r.reliability, r.confidence,
                r.updated_at) for r in store.list_sources()]
    path = tmp / "s.db"
    store.flush_to_sqlite(path)
    with sqlite3.connect(path) as conn:
        dump = list(conn.iterdump())
    return calls, state, records, dump, path.read_bytes()


@pytest.fixture(scope="module")
def outcome_of(tmp_path_factory):
    """Both packages' results per scenario, computed once and shared."""
    cache = {}

    def run(name):
        if name not in cache:
            with pytest.MonkeyPatch.context() as patch:
                patch.setenv("BCE_NO_NATIVE", "1")
                cache[name] = {
                    pkg: run_scenario(pkg, name, tmp_path_factory.mktemp(f"{name}-{pkg}"))
                    for pkg in ("jax", "torch")
                }
        return cache[name]

    return run


@pytest.mark.parametrize("name", GRAPH_SCENARIOS)
def test_store_and_state_match_jax(outcome_of, name):
    results = outcome_of(name)
    ours, theirs = results["torch"], results["jax"]
    for field, a, b in zip(STATE_FIELDS, ours[1], theirs[1]):
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert ours[2] == theirs[2] and ours[2]
    assert ours[3] == theirs[3]


@pytest.mark.parametrize("name", GRAPH_SCENARIOS)
def test_settlement_bytes_same_with_graph_on_and_off(outcome_of, name):
    ours, off = outcome_of(name)["torch"], outcome_of("off")["torch"]
    assert ours[4] == off[4]
    for (consensus, stderr, _, _), (consensus_off, stderr_off, _, _) in zip(
        ours[0], off[0]
    ):
        np.testing.assert_array_equal(consensus, consensus_off)
        np.testing.assert_array_equal(stderr, stderr_off)


@pytest.mark.parametrize("name", GRAPH_SCENARIOS)
def test_propagated_matches_jax(outcome_of, name):
    """Within TOL; bit-equal where the seeding consensus is (the second
    call, whose settles read no decayed weight)."""
    results = outcome_of(name)
    moments = SCENARIOS[name][1] is not None
    bit_equal_calls = 0
    for (c_ours, _, ours, ours_raw), (c_theirs, _, theirs, theirs_raw) in zip(
        results["torch"][0], results["jax"][0]
    ):
        assert isinstance(ours_raw, PropagatedBeliefs) == moments
        assert isinstance(theirs_raw, JaxBeliefs) == moments
        assert ours.keys() == theirs.keys()
        same_seeds = np.array_equal(c_ours, c_theirs, equal_nan=True)
        bit_equal_calls += same_seeds
        for field in ours:
            a, b = ours[field], theirs[field]
            assert a.dtype == b.dtype and a.shape == b.shape, field
            if same_seeds or field == "iters_run":
                np.testing.assert_array_equal(a, b, err_msg=field)
            else:
                np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
                np.testing.assert_allclose(a, b, equal_nan=True, err_msg=field,
                                           **TOL)
    assert bit_equal_calls >= 1


def test_iters_run_stops_early_with_tol(outcome_of):
    for name, bound in (("adaptive", 20), ("blocks", 12), ("fixed", 5)):
        for call in outcome_of(name)["torch"][0]:
            iters = int(call[2]["iters_run"])
            assert (iters < bound) if name != "fixed" else (iters == bound)


def test_blocks_project_the_partitions(outcome_of):
    for _, _, fields, _ in outcome_of("blocks")["torch"][0]:
        mean = fields["mean"]
        for e in range(6):
            members = mean[4 * e: 4 * e + 4]
            finite = members[np.isfinite(members)]
            if finite.size >= 2:
                assert abs(float(finite.astype(np.float64).sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("zero", ["graph", "inference"])
def test_zero_depth_gives_none(zero):
    for pkg in ("jax", "torch"):
        _store, session, outcomes = open_session(pkg)
        graph = (JaxGraph if pkg == "jax" else MarketGraph).from_edges(
            correlation_edges(), steps=0 if zero == "graph" else 2)
        inference = None
        if zero == "inference":
            inference = (JaxInference if pkg == "jax" else InferenceOptions)(
                max_steps=0)
        options = (JaxOptions if pkg == "jax" else AnalyticsOptions)(
            graph=graph, inference=inference)
        propagated = session.settle_with_analytics(
            outcomes, steps=1, now=NOW, analytics=options)[3]
        session.close()
        assert propagated is None, pkg


# (options fields, session kwargs, exception, match): what both raise.
ERRORS = [
    (dict(blocks=("not", "blocks")), {}, TypeError, "analytics.blocks takes"),
    (dict(inference="moments"), {}, TypeError, "analytics.inference takes"),
    (dict(inference="INFERENCE"), {}, ValueError, "needs a graph"),
    (dict(graph="ZERO"), dict(sweep_kernel="pallas"), ValueError,
     "no graph sweep"),
    (dict(graph="GRAPH"), dict(sweep_kernel="bogus"), ValueError,
     "sweep_kernel='bogus'"),
]


def error_options(pkg, fields):
    resolved = {}
    for key, value in fields.items():
        if value == "INFERENCE":
            value = (JaxInference if pkg == "jax" else InferenceOptions)()
        elif value in ("GRAPH", "ZERO"):
            graph = JaxGraph.from_edges(correlation_edges(),
                                        steps=0 if value == "ZERO" else 2)
            value = graph if pkg == "jax" else port_graph(graph)
        resolved[key] = value
    return (JaxOptions if pkg == "jax" else AnalyticsOptions)(**resolved)


@pytest.mark.parametrize("fields, kwargs, error, match", ERRORS,
                         ids=[e[3] for e in ERRORS])
def test_session_errors_match_jax(fields, kwargs, error, match):
    for pkg in ("jax", "torch"):
        _store, session, outcomes = open_session(pkg)
        with pytest.raises(error, match=match):
            session.settle_with_analytics(
                outcomes, now=NOW, analytics=error_options(pkg, fields), **kwargs)


LOOP_ERRORS = [
    (dict(sweep_steps=2, sweep_mode="bogus"), "sweep_mode='bogus'"),
    (dict(sweep_steps=2, sweep_tol=1e-3), "rides the moments"),
    (dict(sweep_steps=2, sweep_mode="moments", sweep_tol=0.0), "positive residual"),
    (dict(sweep_steps=2, sweep_mode="moments", with_bands=False), "band stderr"),
    (dict(sweep_steps=0, sweep_kernel="pallas"), "no graph sweep"),
]


@pytest.mark.parametrize("kwargs, match", LOOP_ERRORS, ids=[e[1] for e in LOOP_ERRORS])
def test_loop_builder_errors_match_jax(kwargs, match):
    from bayesian_consensus_engine_tpu.parallel.sharded import (
        build_cycle_analytics_loop as jax_builder,
    )

    with pytest.raises(ValueError, match=match):
        jax_builder(make_mesh((1, 1), devices=jax.devices()[:1]), **kwargs)
    with pytest.raises(ValueError, match=match):
        sharded.build_cycle_analytics_loop("cpu", **kwargs)


def test_graph_type_checked():
    """The port names a graph of the wrong type (the reference fails later,
    on an attribute)."""
    _store, session, outcomes = open_session("torch")
    with pytest.raises(TypeError, match="analytics.graph takes"):
        session.settle_with_analytics(
            outcomes, now=NOW, analytics=AnalyticsOptions(graph=object()))


def test_neighbour_blocks_cached_across_calls():
    _store, session, outcomes = open_session("torch")
    options = options_for("torch", "fixed")
    session.settle_with_analytics(outcomes, steps=1, now=NOW, analytics=options)
    blocks = session._graph_cache[2]
    session.settle_with_analytics(outcomes, steps=1, now=NOW + 1, analytics=options)
    assert session._graph_cache[2] is blocks
    session.settle_with_analytics(outcomes, steps=1, now=NOW + 2,
                                  analytics=options_for("torch", "graph"))
    assert session._graph_cache[2] is not blocks
    session.close()
    assert all(isinstance(x, torch.Tensor) for x in blocks)
