"""A graph sweep on a mesh with several markets shards ≡ the JAX session's.

The same payloads, outcomes, graph, ``now`` and ``steps`` go through
``bayesian_consensus_engine_tpu.pipeline.ShardedSettlementSession`` on a
mesh of CPU devices and the port's session on a mesh of the same shape
whose every device is the CPU: (2, 1), (4, 1) and (2, 2). 45 markets do
not divide over 2 or 4 markets shards, so the padded global axis the
aligned neighbour blocks index is longer than the live one. Each session
runs two chained one-step ``settle_with_analytics`` calls under the
moments lane with an early exit, and on one mesh the point lane.

The JAX session runs both of its sweep routes: ``sweep_kernel="xla"`` (the
``while_loop`` sweep that all-gathers the means every iteration, its
residual a ``pmax``) and ``"pallas"`` (the kernel in interpret mode over
the seeds and blocks gathered once). The port has one route for both:
the shards' consensus and variances gathered onto the mesh's first
device and one ``bp_sweep`` over the whole axis.

Every record is stamped ``now`` and each call settles one step at the
stamp the last one left, so no read decays: the seeds carry neither the
reference's ``exp2`` ulps nor those of the CPU's vector and scalar
``exp2`` (which would make a shard's consensus depend on its width), and
everything is compared bit for bit:

* block state, ``list_sources()`` and the SQLite file bytes;
* the consensus, and the propagated mean, stderr, ``iters_run`` and
  residual of both calls (as on the one-card session,
  ``tests/test_torch_inference_session.py``, where the seeds are equal);
* the port's result on each mesh against its own one-card session's.
"""

import numpy as np
import pytest
import torch

import jax

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.analytics import AnalyticsOptions as JaxOptions
from bayesian_consensus_engine_tpu.analytics.graph import MarketGraph as JaxGraph
from bayesian_consensus_engine_tpu.infer.bp import (
    InferenceOptions as JaxInference,
)
from bayesian_consensus_engine_tpu.parallel import mesh as jmesh
from bayesian_consensus_engine_tpu.state.records import (
    ReliabilityRecord as JaxRecord,
)
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import convert
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.analytics import AnalyticsOptions
from bayesian_consensus_engine_tpu_torch.infer import InferenceOptions
from bayesian_consensus_engine_tpu_torch.parallel import mesh as tmesh
from bayesian_consensus_engine_tpu_torch.state.records import (
    ReliabilityRecord as TorchRecord,
)
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore as TorchStore,
)
from bayesian_consensus_engine_tpu_torch.utils.timeconv import days_to_iso

NOW = 20000.25  # epoch-days, 2024-10-04
STEPS = 1
MARKETS = 45
STATE_FIELDS = ("reliability", "confidence", "updated_days", "exists")
MESHES = [(2, 1), (4, 1), (2, 2)]
# scenario → (graph steps, inference kwargs or None)
SCENARIOS = {
    "adaptive": (2, dict(tol=5e-2, max_steps=20, damping=0.35)),
    "point": (3, None),
}


def make_payloads(seed=4):
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


def jax_graph(steps, seed=6):
    """Random edges, many across markets shards, some to absent markets."""
    rng = np.random.default_rng(seed)
    edges = []
    for m in range(MARKETS):
        for _ in range(int(rng.integers(0, 4))):
            other = int(rng.integers(0, MARKETS + 5))
            if other != m:
                name = f"m-{other}" if other < MARKETS else f"ghost-{other}"
                edges.append((f"m-{m}", name, float(rng.uniform(0.5, 1.5))))
    return JaxGraph.from_edges(edges, damping=0.45, steps=steps)


def options_for(pkg, scenario):
    steps, inference = SCENARIOS[scenario]
    graph = jax_graph(steps)
    if pkg == "jax":
        return JaxOptions(
            graph=graph,
            inference=None if inference is None else JaxInference(**inference),
        )
    return AnalyticsOptions(
        graph=convert.market_graph_from_fields(
            graph.node_ids, graph.offsets, graph.indices, graph.weights,
            graph.damping, graph.steps, graph.fingerprint,
        ),
        inference=None if inference is None else InferenceOptions(**inference),
    )


def open_session(pkg, shape):
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
    size = shape[0] * shape[1]
    if pkg == "jax":
        plan = jpipe.build_settlement_plan(store, payloads)
        mesh = jmesh.make_mesh(shape, devices=jax.devices()[:size])
        return store, jpipe.ShardedSettlementSession(store, plan, mesh), outcomes
    plan = tpipe.build_settlement_plan(store, payloads)
    mesh = tmesh.make_mesh(shape, [torch.device("cpu")] * size)
    return store, tpipe.ShardedSettlementSession(store, plan, mesh), outcomes


def fields(propagated):
    if hasattr(propagated, "_fields"):
        return {name: np.asarray(value)
                for name, value in zip(propagated._fields, propagated)}
    return {"mean": np.asarray(propagated)}


def run(pkg, shape, scenario, tmp, sweep_kernel=None):
    """Per-call (consensus, propagated fields), block state, records and
    the SQLite file's bytes."""
    store, session, outcomes = open_session(pkg, shape)
    calls = []
    for now in (NOW, NOW + STEPS - 1):
        result, _tiebreak, _bands, propagated = session.settle_with_analytics(
            outcomes, steps=STEPS, now=now,
            analytics=options_for(pkg, scenario), sweep_kernel=sweep_kernel,
        )
        calls.append((np.asarray(result.consensus), fields(propagated)))
    state = tuple(
        np.asarray(x) for x in (session._state if pkg == "jax"
                                else convert.sharded_block_to_numpy(session._state))
    )
    session.close()
    records = [(r.source_id, r.market_id, r.reliability, r.confidence,
                r.updated_at) for r in store.list_sources()]
    path = tmp / "s.db"
    store.flush_to_sqlite(path)
    return calls, state, records, path.read_bytes()


CASES = (
    [(shape, "adaptive", kernel) for shape in MESHES for kernel in ("xla", "pallas")]
    + [((4, 1), "point", "xla")]
)
IDS = [f"{m}x{s}-{scenario}-{kernel}" for (m, s), scenario, kernel in CASES]


@pytest.fixture(scope="module")
def results_of(tmp_path_factory):
    """Each case's JAX and port results, computed once and shared; the
    port's run does not depend on ``sweep_kernel`` and is shared too."""
    cache = {}

    def get(kind, shape, scenario, kernel=None):
        key = (kind, shape, scenario, kernel if kind == "jax" else None)
        if key not in cache:
            with pytest.MonkeyPatch.context() as patch:
                patch.setenv("BCE_NO_NATIVE", "1")
                cache[key] = run(
                    kind, shape, scenario,
                    tmp_path_factory.mktemp("-".join(map(str, key[:3]))),
                    sweep_kernel=kernel,
                )
        return cache[key]

    return get


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_state_records_and_sqlite_bytes_match_jax(results_of, case):
    shape, scenario, kernel = case
    ours = results_of("torch", shape, scenario)
    theirs = results_of("jax", shape, scenario, kernel)
    for field, a, b in zip(STATE_FIELDS, ours[1], theirs[1]):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert ours[2] == theirs[2] and ours[2]
    assert ours[3] == theirs[3]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_consensus_and_propagated_beliefs_match_jax(results_of, case):
    shape, scenario, kernel = case
    ours = results_of("torch", shape, scenario)[0]
    theirs = results_of("jax", shape, scenario, kernel)[0]
    for (cons, got), (cons_ref, want) in zip(ours, theirs):
        assert cons.dtype == cons_ref.dtype and cons.shape == (MARKETS,)
        np.testing.assert_array_equal(cons, cons_ref)
        assert set(got) == set(want)
        for name in got:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        if "iters_run" in got:
            # The early exit fires before the bound on every call.
            assert 1 <= int(got["iters_run"]) < SCENARIOS[scenario][1]["max_steps"]


PAIRS = [((2, 1), (1, 1)), ((4, 1), (1, 1)), ((2, 2), (1, 2))]


@pytest.mark.parametrize("shape, alone_shape", PAIRS,
                         ids=[f"{m}x{s}" for (m, s), _ in PAIRS])
def test_markets_sharded_sweep_equals_the_one_markets_shard_sweep(
    results_of, shape, alone_shape,
):
    """Gathering the markets shards changes no bit: every mesh's
    consensus, propagated fields, records and SQLite bytes are those of
    the session with the same sources extent and one markets shard (the
    block states differ only in their padding; a sources-sharded mesh's
    band tree, which seeds the variances, is its own)."""
    ours = results_of("torch", shape, "adaptive")
    alone = results_of("torch", alone_shape, "adaptive")
    for (cons, got), (cons_ref, want) in zip(ours[0], alone[0]):
        np.testing.assert_array_equal(cons, cons_ref)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert ours[2] == alone[2]
    assert ours[3] == alone[3]
