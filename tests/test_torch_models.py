"""The port's models and namespaced store ≡ the JAX package's.

The cases of ``test_tiebreak.py``, ``test_multi_market.py`` and
``test_reliability_abstraction.py`` (and seeded random ones) are replayed
through both packages as differential cases: the same calls on each, and
their observable results — values, documents, error messages — equal.
Decay-on-read is pinned to a fixed elapsed time in both packages' stores so
that reads taken at different instants give the same bits.
"""

import dataclasses
import math
import random

import pytest
import torch

import jax

from bayesian_consensus_engine_tpu import models as jmodels
from bayesian_consensus_engine_tpu.state import namespaced as jnamespaced
from bayesian_consensus_engine_tpu.state import sqlite_store as jsqlite
from bayesian_consensus_engine_tpu_torch import models as tmodels
from bayesian_consensus_engine_tpu_torch import state as tstate
from bayesian_consensus_engine_tpu_torch.state import namespaced as tnamespaced
from bayesian_consensus_engine_tpu_torch.state import sqlite_store as tsqlite
from bayesian_consensus_engine_tpu_torch.state import tensor_store as ttensor

ELAPSED_DAYS = 2.5


@pytest.fixture
def fixed_elapsed(monkeypatch):
    """Every store reads ``ELAPSED_DAYS`` since any stamp."""
    for module in (jsqlite, tsqlite, ttensor):
        monkeypatch.setattr(module, "days_since_update",
                            lambda _stamp, _now=None: ELAPSED_DAYS)


def plain(value):
    """Dataclasses, enums and containers → comparable plain data."""
    if dataclasses.is_dataclass(value):
        return {f.name: plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {plain(k): plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if hasattr(value, "value") and type(value).__module__.startswith(
            "bayesian_consensus_engine_tpu"):
        return value.value
    return value


def outcome(fn):
    try:
        return "ok", plain(fn())
    except (ValueError, TypeError) as exc:
        return type(exc).__name__, str(exc)


# -- tie-breaker -------------------------------------------------------------

# (agents as AgentSignal arguments, precision) of test_tiebreak.py's cases.
_TIEBREAK_CASES = {
    "empty": ([], 6),
    "single": ([("a1", 0.75, 0.8)], 6),
    "unanimous": ([("a1", 0.75, 0.8, 0.9, 0.7), ("a2", 0.75, 0.75, 0.85, 0.6),
                   ("a3", 0.75, 0.70, 0.80, 0.5)], 6),
    "weight_density": ([("a1", 0.75, 0.85, 0.9, 0.82),
                        ("a2", 0.75, 0.80, 0.85, 0.78),
                        ("a3", 0.25, 0.70, 0.6, 0.65),
                        ("a4", 0.25, 0.65, 0.55, 0.70),
                        ("a5", 0.25, 0.60, 0.50, 0.60)], 6),
    "max_reliability": ([("a1", 0.75, 0.8, 1.0, 0.5),
                         ("a2", 0.25, 0.8, 1.0, 0.9)], 6),
    "smallest_prediction": ([("a1", 0.75, 0.8, 1.0, 0.9),
                             ("a2", 0.25, 0.8, 1.0, 0.9)], 6),
    "rounding": ([("a1", 0.7500000001, 0.8), ("a2", 0.7500000002, 0.7)], 6),
    "custom_precision": ([("a1", 0.74, 0.8), ("a2", 0.71, 0.9)], 1),
    "structure": ([("a1", 0.75, 0.8, 0.9, 0.7), ("a2", 0.25, 0.6, 0.5, 0.5)], 6),
    "three_way": ([("a1", 0.3, 0.5, 1.0, 0.4), ("a2", 0.6, 0.7, 1.0, 0.4),
                   ("a3", 0.9, 0.6, 1.0, 0.4)], 6),
    "bad_confidence": ([("a1", 0.5, 1.5)], 6),
    "bad_confidence_low": ([("a1", 0.5, -0.1)], 6),
    "bad_reliability": ([("a1", 0.5, 0.5, 1.0, 1.5)], 6),
}


def resolve_both(agents, precision):
    def run(models):
        return outcome(lambda: models.DeterministicTieBreaker(precision).resolve(
            [models.AgentSignal(*a) for a in agents]))
    return run(tmodels), run(jmodels)


@pytest.mark.parametrize("case", sorted(_TIEBREAK_CASES))
def test_tiebreak_cases_match_jax(case):
    ours, theirs = resolve_both(*_TIEBREAK_CASES[case])
    assert ours == theirs


def test_tiebreak_permutations_match_jax():
    import itertools

    agents = _TIEBREAK_CASES["three_way"][0]
    for perm in itertools.permutations(agents):
        ours, theirs = resolve_both(list(perm), 6)
        assert ours == theirs and ours[1][0] == 0.3


@pytest.mark.parametrize("seed", range(10))
def test_tiebreak_random_cases_match_jax(seed):
    rng = random.Random(123 + seed)
    for _ in range(30):
        agents = [
            (f"a{i}", rng.choice([0.2, 0.5, 0.8, rng.random()]), rng.random(),
             rng.choice([1.0, rng.random()]), rng.choice([0.5, rng.random()]))
            for i in range(rng.randint(1, 12))
        ]
        ours, theirs = resolve_both(agents, rng.choice([2, 6]))
        assert ours == theirs


def test_agent_signal_defaults_match_jax():
    assert plain(tmodels.AgentSignal("a1", 0.75, 0.8)) == plain(
        jmodels.AgentSignal("a1", 0.75, 0.8))


# -- markets, the market store and the aggregator ----------------------------

def market_id_probe(models):
    ids = ["crypto:btc:1", "simple-id", "crypto:btc:price", "x"]
    patterns = ["crypto:btc:1", "crypto:*:1", "crypto:*", "*", "sports:*",
                "crypto:btc:2"]
    return [
        (str(m), repr(m), m.category, m.parts, [m.matches(p) for p in patterns])
        for m in map(models.MarketId, ids)
    ] + [outcome(lambda: models.MarketId("  ")),
         {models.MarketId("a"): 1}[models.MarketId("a")]]


def market_probe(models):
    market = models.Market(id=models.MarketId("m"))
    empty = market.compute_consensus()
    market.add_signal({"sourceId": "a", "probability": 0.7})
    market.add_signal({"sourceId": "b", "probability": 0.8})
    result = market.compute_consensus()
    cached = market.consensus_result is result
    market.resolve(True)
    rejected = outcome(lambda: market.add_signal({"sourceId": "c",
                                                  "probability": 0.1}))
    return [empty, result, cached, plain(market.status), market.outcome,
            market.resolved_at is not None, rejected,
            [s.value for s in models.MarketStatus]]


def store_probe(models):
    store = models.MarketStore()
    created = store.create_market(models.MarketId("open-1"))
    duplicate = outcome(lambda: store.create_market(models.MarketId("open-1")))
    store.create_market(models.MarketId("resolved-1")).resolve(True)
    for mid in ("crypto:a", "crypto:b", "sports:a"):
        store.create_market(models.MarketId(mid))
    store.add_signal(models.MarketId("m1"), {"sourceId": "a", "probability": 0.6})
    store.add_signal(models.MarketId("m2"), {"sourceId": "b", "probability": 0.8})
    return [
        store.get_or_create(models.MarketId("open-1")) is created,
        duplicate,
        [str(m.id) for m in store.list_markets(status=models.MarketStatus.OPEN)],
        [str(m.id) for m in store.list_markets(pattern="crypto:*")],
        store.compute_all_consensus(),
        outcome(lambda: store.compute_all_consensus(backend="pyton")),
    ]


def resolved_store(models):
    store = models.MarketStore()
    for mid, a, b in (("crypto:btc", 0.8, 0.7), ("crypto:eth", 0.9, 0.2)):
        market = store.get_or_create(models.MarketId(mid))
        market.add_signal({"sourceId": "agent-a", "probability": a})
        market.add_signal({"sourceId": "agent-b", "probability": b})
        market.compute_consensus()
        market.resolve(True)
    return store


def aggregator_probe(models):
    agg = models.CrossMarketAggregator(resolved_store(models))
    edge = models.MarketStore()
    market = edge.get_or_create(models.MarketId("m"))
    market.add_signal({"sourceId": "edge", "probability": 0.5})
    market.resolve(True)
    uncached = models.MarketStore()
    uncached.create_market(models.MarketId("m"))
    return [
        agg.summarize_sources(),
        agg.summarize_sources(patterns=["crypto:btc"]),
        models.CrossMarketAggregator(edge).summarize_sources(),
        agg.summarize_category("crypto"),
        agg.summarize_category("sports"),
        *(agg.aggregate_consensus(["crypto:*"], method=method)
          for method in ("weighted_average", "median", "majority")),
        outcome(lambda: agg.aggregate_consensus(["*"], method="mode")),
        models.CrossMarketAggregator(models.MarketStore())
        .aggregate_consensus(["nothing:*"]),
        models.CrossMarketAggregator(uncached).aggregate_consensus(["*"]),
        [(p.accuracy, p.source_id) for p in (
            models.SourcePerformance("a", 10, 7, 3, 0.7),
            models.SourcePerformance("a", 0, 0, 0, 0.5))],
    ]


@pytest.mark.parametrize("probe", [market_id_probe, market_probe, store_probe,
                                   aggregator_probe],
                         ids=lambda p: p.__name__)
def test_market_layer_matches_jax(probe):
    assert plain(probe(tmodels)) == plain(probe(jmodels))


def random_markets(models, seed):
    """Random markets over a few categories: signals, cached consensus on
    some, outcomes on others (the resolved ones feed the scorecards)."""
    rng = random.Random(seed)
    store = models.MarketStore()
    for m in range(30):
        mid = models.MarketId(f"{rng.choice(['crypto', 'sports', 'misc'])}:{m}")
        market = store.get_or_create(mid)
        for _ in range(rng.randint(0, 6)):
            market.add_signal({"sourceId": f"s{rng.randint(0, 7)}",
                               "probability": round(rng.random(), 4)})
        if rng.random() < 0.7:
            market.compute_consensus()
        if rng.random() < 0.5:
            market.resolve(rng.random() < 0.5)
    return store


@pytest.mark.parametrize("seed", range(4))
def test_random_aggregations_match_jax(seed):
    def probe(models):
        agg = models.CrossMarketAggregator(random_markets(models, seed))
        return [agg.summarize_sources(), agg.summarize_sources(["crypto:*"]),
                agg.summarize_category("sports"),
                *(agg.aggregate_consensus(patterns, method=method)
                  for patterns in (["*"], ["crypto:*", "sports:*"])
                  for method in ("weighted_average", "median", "majority"))]

    assert plain(probe(tmodels)) == plain(probe(jmodels))


def sweep_stores(seed, store_factories):
    """A market store and reliability stores given the same updates."""
    rng = random.Random(seed)
    markets = {name: models.MarketStore()
               for name, models in (("port", tmodels), ("jax", jmodels))}
    stores = {name: factory() for name, factory in store_factories.items()}
    for m in range(12):
        for _ in range(rng.randint(0, 6)):
            sid = f"s{rng.randint(0, 4)}"
            signal = {"sourceId": sid, "probability": round(rng.random(), 4)}
            for name, models in (("port", tmodels), ("jax", jmodels)):
                markets[name].add_signal(models.MarketId(f"sweep-{m}"), signal)
            if rng.random() < 0.5:
                correct = rng.random() < 0.5
                for store in stores.values():
                    store.update_reliability(sid, f"sweep-{m}", correct)
        for name, models in (("port", tmodels), ("jax", jmodels)):
            markets[name].get_or_create(models.MarketId(f"sweep-{m}"))
    markets["port"].get_market(tmodels.MarketId("sweep-3")).resolve(True)
    markets["jax"].get_market(jmodels.MarketId("sweep-3")).resolve(True)
    return markets, stores


def assert_documents_close(batched, scalar, rel_tol):
    for key in ("consensus", "confidence"):
        if scalar[key] is None:
            assert batched[key] is None
        else:
            assert math.isclose(batched[key], scalar[key], rel_tol=rel_tol,
                                abs_tol=1e-12), key
    assert batched["diagnostics"] == scalar["diagnostics"]
    assert [w["sourceId"] for w in batched["sourceWeights"]] == [
        w["sourceId"] for w in scalar["sourceWeights"]]


@pytest.mark.parametrize("seed", [5, 6])
def test_market_sweeps_match_jax(seed, fixed_elapsed):
    markets, stores = sweep_stores(seed, {
        "port": lambda: tsqlite.SQLiteReliabilityStore(":memory:"),
        "jax": lambda: jsqlite.SQLiteReliabilityStore(":memory:"),
        "tensor": lambda: ttensor.TensorReliabilityStore(device="cpu"),
    })
    port, theirs = markets["port"], markets["jax"]
    scalar = port.compute_all_consensus(stores["port"])
    assert scalar == theirs.compute_all_consensus(stores["jax"])
    with jax.enable_x64():
        jax_batched = theirs.compute_all_consensus(stores["jax"], backend="jax")
    for backend in ("torch", "jax", "tpu"):
        batched = port.compute_all_consensus(
            stores["port"], backend=backend, device="cpu", dtype=torch.float64)
        assert batched == jax_batched
    over_tensor = port.compute_all_consensus(
        stores["tensor"], backend="torch", device="cpu", dtype=torch.float64)
    assert over_tensor == jax_batched
    for mid, document in scalar.items():
        if "normalization" in document:
            assert_documents_close(over_tensor[mid], document, 1e-12)
            assert over_tensor[mid]["diagnostics"]["coldStartSources"] == []
            assert port.get_market(tmodels.MarketId(mid)).consensus_result \
                is over_tensor[mid]
        else:
            assert over_tensor[mid] == document
    assert "sweep-3" not in scalar
    # Cold start (no store), float32, and the error for a typo'd backend.
    with jax.enable_x64(False):
        assert port.compute_all_consensus(backend="torch", device="cpu") == \
            theirs.compute_all_consensus(backend="tpu")
    assert outcome(lambda: port.compute_all_consensus(backend="cuda")) == \
        outcome(lambda: theirs.compute_all_consensus(backend="cuda"))
    for store in stores.values():
        store.close()


# -- namespaced reliability ---------------------------------------------------

_NAMESPACE_SCRIPTS = {
    "cold_start": [("get", "unknown-source", {})],
    "global_seeded": [("seed", "a", 0.8, 0.6), ("get", "a", {})],
    "market_miss": [("seed", "a", 0.75, 0.5),
                    ("get", "a", {"market_id": "unseen-market"})],
    "domain_beats_global": [
        ("seed", "a", 0.75, 0.5),
        ("update", "a", True, {"domain": "crypto"}),
        ("get", "a", {"market_id": "m-x", "domain": "crypto"})],
    "market_beats_domain": [
        ("update", "a", True, {"domain": "crypto"}),
        ("update", "a", True, {"market_id": "btc-1"}),
        ("get", "a", {"market_id": "btc-1", "domain": "crypto"})],
    "full_chain": [
        ("get", "a", {"market_id": "m1", "domain": "d1"}),
        ("seed", "a", 0.7, 0.5),
        ("get", "a", {"market_id": "m1", "domain": "d1"}),
        ("update", "a", True, {"domain": "d1"}),
        ("get", "a", {"market_id": "m1", "domain": "d1"}),
        ("update", "a", True, {"market_id": "m1"}),
        ("get", "a", {"market_id": "m1", "domain": "d1"}),
        ("get", "a", {"market_id": "m1", "domain": "d1", "apply_decay": False})],
    "updates": [
        ("update", "a", True, {"domain": "crypto"}),
        ("update", "b", False, {"domain": "crypto"}),
        ("update", "c", True, {}),
        ("update", "d", True, {"domain": "crypto", "update_global": True}),
        ("update", "e", False, {"market_id": "m", "update_global": True}),
        ("get", "d", {}), ("get", "e", {}), ("get", "e", {"market_id": "m"})],
    "storage_layout": [
        ("update", "a", True, {"domain": "crypto"}),
        ("seed", "a", 0.9, 0.9),
        ("raw", "a", "__domain__:crypto"), ("raw", "a", "__global__"),
        ("raw", "a", "nowhere")],
}


def run_script(store, script):
    results = []
    for step in script:
        if step[0] == "get":
            results.append(store.get_reliability(step[1], **step[2]))
        elif step[0] == "seed":
            results.append(store.set_global_reliability(*step[1:]))
        elif step[0] == "update":
            results.append(store.update_reliability(step[1], step[2], **step[3]))
        else:
            results.append(store.backing_store.get_reliability(
                step[1], step[2], apply_decay=True))
    # The stamps are the wall clock at each write; only their presence is
    # part of the contract.
    return [dict(plain(r), updated_at=bool(r.updated_at)) for r in results]


NAMESPACED_BACKINGS = {
    "sqlite": lambda: None,
    "tensor": lambda: ttensor.TensorReliabilityStore(device="cpu"),
}


def random_script(seed):
    rng = random.Random(seed)
    script = []
    for _ in range(60):
        sid = f"s{rng.randint(0, 3)}"
        scope = rng.choice([{}, {"market_id": f"m{rng.randint(0, 2)}"},
                            {"domain": f"d{rng.randint(0, 1)}"},
                            {"market_id": "m0", "domain": "d1"}])
        roll = rng.random()
        if roll < 0.45:
            script.append(("get", sid, scope))
        elif roll < 0.55:
            script.append(("seed", sid, round(rng.random(), 3),
                           round(rng.random(), 3)))
        else:
            if "market_id" in scope and "domain" in scope:
                scope = {"domain": scope["domain"]}
            script.append(("update", sid, rng.random() < 0.6,
                           dict(scope, update_global=rng.random() < 0.3)))
    return script


@pytest.mark.parametrize("backing", sorted(NAMESPACED_BACKINGS))
@pytest.mark.parametrize("script", [*sorted(_NAMESPACE_SCRIPTS), "random-1",
                                    "random-2"])
def test_namespaced_store_matches_jax(script, backing, fixed_elapsed):
    steps = (random_script(int(script.split("-")[1]))
             if script.startswith("random") else _NAMESPACE_SCRIPTS[script])
    with tnamespaced.NamespacedReliabilityStore(
            store=NAMESPACED_BACKINGS[backing]()) as ours, \
            jnamespaced.NamespacedReliabilityStore(":memory:") as theirs:
        assert run_script(ours, steps) == run_script(theirs, steps)


def test_namespaced_surface_matches_jax():
    assert tstate.NamespacedReliabilityStore is \
        tnamespaced.NamespacedReliabilityStore
    assert tnamespaced.domain_market_id("crypto") == \
        jnamespaced.domain_market_id("crypto") == "__domain__:crypto"
    assert tnamespaced.NamespacedReliabilityStore.GLOBAL_MARKET_ID == \
        jnamespaced.NamespacedReliabilityStore.GLOBAL_MARKET_ID
    assert [n.value for n in tnamespaced.ReliabilityNamespace] == \
        [n.value for n in jnamespaced.ReliabilityNamespace]
    record = tnamespaced.NamespacedReliabilityRecord(
        "a", tnamespaced.ReliabilityNamespace.GLOBAL, "global", 0.5, 0.25, "",
        True)
    with pytest.raises(dataclasses.FrozenInstanceError):
        record.reliability = 0.9
    with tnamespaced.NamespacedReliabilityStore(":memory:") as store:
        assert isinstance(store, tnamespaced.ReliabilityProvider)
        assert isinstance(store.backing_store, tsqlite.SQLiteReliabilityStore)
