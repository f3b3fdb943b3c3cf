"""The port's band sessions ≡ the JAX package's, on the CPU.

``ShardedSettlementSession(band=(lo, global_markets))``, its ``adopt(plan,
band=)``, ``settle_stream(band=)`` and ``SessionDriver.dispatch(band=)``
against ``bayesian_consensus_engine_tpu`` on the same seeded batches (the
reference's ``tests/test_cluster.py`` cases), on (1, 1) and (4, 2) meshes
(the JAX side on the conftest's CPU devices, the port on CPU devices):

* the band stream stays resident (no ``rebuild``), bit-equal to the
  per-batch-session stream, and equal to the JAX band stream: stores and
  SQLite dumps equal, journals byte-equal, consensus within rtol 1e-5,
  atol 1e-6 (XLA's ``exp2``);
* the forced multi-process path (``_process_count`` patched to 2) is
  byte-equal to the one-process session and to the JAX package's forced
  path (its host-staged relayout);
* ``rebuild:band-change`` and ``rebuild:backdated-stamps`` come where the
  JAX package returns them, and ``stream.resident_fallbacks`` reads 0;
* a band session's analytics and graph sweep are bit-equal to the
  whole-axis session's, and a multi-process runtime refuses analytics
  with ``ClusterModeUnsupported`` naming ``MeshView``.
"""

import random

import jax
import numpy as np
import pytest
import torch

from bayesian_consensus_engine_tpu import obs as jobs
from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.analytics.bands import (
    AnalyticsOptions as JaxAnalyticsOptions,
)
from bayesian_consensus_engine_tpu.analytics.graph import (
    MarketGraph as JaxMarketGraph,
)
from bayesian_consensus_engine_tpu.parallel.mesh import make_mesh as jax_mesh
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import obs
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.analytics import (
    AnalyticsOptions,
    MarketGraph,
)
from bayesian_consensus_engine_tpu_torch.cluster import ClusterModeUnsupported
from bayesian_consensus_engine_tpu_torch.parallel.mesh import make_mesh
from bayesian_consensus_engine_tpu_torch.serve.driver import SessionDriver
from test_torch_stream import (
    TOL,
    assert_same_stream,
    cpu_store,
    run_stream,
)

NOW = 21_400.0
SHAPES = ((1, 1), (4, 2))


def _payloads(rng, markets, universe, tag=""):
    out = []
    for m in range(markets):
        n = rng.randint(1, 3)
        out.append((
            f"m{tag}-{m}",
            [{"sourceId": f"s{rng.randrange(universe)}",
              "probability": round(rng.random(), 6)}
             for _ in range(n)],
        ))
    return out


def mixed_batches(markets=24, batches=5, seed=11, tag=""):
    """Stable pairs, drift, then pair growth — refresh, relayout and a
    wider K — at a fixed market count (a band plan covers its band
    exactly every batch), as the reference's cluster tests make them."""
    rng = random.Random(seed)
    stable = _payloads(rng, markets, 12, tag=tag)
    out = []
    for b in range(batches):
        if b < 2:
            pays = [(k, [dict(s, probability=round(rng.random(), 6))
                         for s in sigs]) for k, sigs in stable]
        elif b < 4:
            pays = _payloads(rng, markets, 16, tag=tag)
        else:
            pays = [(f"m{tag}-{m}",
                     [{"sourceId": f"s{rng.randrange(40)}",
                       "probability": round(rng.random(), 6)}
                      for _ in range(rng.randint(3, 6))])
                    for m in range(markets)]
        outs = [rng.random() < 0.5 for _ in pays]
        out.append((pays, outs))
    return out


def meshes(shape):
    n = shape[0] * shape[1]
    return (jax_mesh(shape, devices=jax.devices()[:n]),
            make_mesh(shape, [torch.device("cpu")] * n))


def band_stream(kind, tmp, name, shape, seed=11, **kw):
    batches = mixed_batches(seed=seed)
    jmesh, tmesh = meshes(shape)
    markets = len(batches[0][0])
    kw.setdefault("band", (0, markets))
    return run_stream(kind, batches, tmp, name, journal=True, reuse_plans=True,
                      num_slots=8, mesh=jmesh if kind == "jax" else tmesh,
                      python_route=True, **kw)


@pytest.fixture(scope="module")
def jax_bands(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_bands")
    return {shape: band_stream("jax", tmp, f"b{shape[0]}{shape[1]}", shape)
            for shape in SHAPES}


@pytest.fixture(scope="module")
def jax_forced(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_forced")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "_process_count", lambda: 2)
        return {shape: band_stream("jax", tmp, f"f{shape[0]}{shape[1]}",
                                   shape, seed=13) for shape in SHAPES}


def adopt_modes(run):
    return [s["session_adopt"] for s in run.stats]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_band_stream_stays_resident_and_equals_jax(tmp_path, jax_bands, shape):
    port = band_stream("torch", tmp_path, "port", shape)
    modes = adopt_modes(port)
    assert modes[0] == "start"
    assert set(modes[1:]) <= {"refresh", "relayout"} and "relayout" in modes
    assert modes == adopt_modes(jax_bands[shape])
    assert_same_stream(port, jax_bands[shape])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_band_stream_bit_equal_to_per_batch_sessions(tmp_path, shape):
    resident = band_stream("torch", tmp_path, "resident", shape)
    per_batch = band_stream("torch", tmp_path, "per_batch", shape,
                            resident_session=False)
    assert adopt_modes(per_batch) == [None] * len(per_batch.stats)
    assert_same_stream(resident, per_batch, bitwise=True)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forced_cluster_path_is_byte_equal(tmp_path, monkeypatch, jax_forced,
                                           shape):
    """The multi-process posture, forced through the ``_process_count``
    seam, gives the one-process session's bytes (both re-lay the block out
    on this process's rows of the mesh) and the JAX package's forced
    path's (its host-staged relayout)."""
    device = band_stream("torch", tmp_path, "device", shape, seed=13)
    monkeypatch.setattr(tpipe, "_process_count", lambda: 2)
    cluster = band_stream("torch", tmp_path, "cluster", shape, seed=13)
    modes = adopt_modes(cluster)
    assert "relayout" in modes
    assert not any(m.startswith("rebuild") for m in modes[1:])
    assert modes == adopt_modes(jax_forced[shape])
    assert_same_stream(cluster, device, bitwise=True)
    assert_same_stream(cluster, jax_forced[shape])


def _plan(pipe, store, pays, **kw):
    return pipe.build_settlement_plan(store, pays, num_slots=4, **kw)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_band_change_rebuilds_with_reason(shape):
    served = []
    for kind, mesh in zip(("jax", "torch"), meshes(shape)):
        pipe = jpipe if kind == "jax" else tpipe
        store = JaxStore() if kind == "jax" else cpu_store()
        rng = random.Random(3)
        pays = _payloads(rng, 10, 8)
        plan = _plan(pipe, store, pays, fingerprint=True)
        session = pipe.ShardedSettlementSession(store, plan, mesh,
                                                band=(0, 10))
        session.settle([True] * 10, steps=1, now=NOW)
        plan2 = _plan(pipe, store, _payloads(rng, 12, 8, tag="x"),
                      fingerprint=True)
        served.append(session.adopt(plan2, band=(0, 12)))
        session.close()
    assert served == ["rebuild:band-change"] * 2


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backdated_entering_stamps_rebuild_with_reason(shape):
    """Rows settled at an old day enter a band session whose epoch sits
    above their stamps: no positive relative stamp, so both packages stay
    in the rebuild posture (the band, ten markets, does not move)."""
    served = []
    for kind, mesh in zip(("jax", "torch"), meshes(shape)):
        pipe = jpipe if kind == "jax" else tpipe
        store = JaxStore() if kind == "jax" else cpu_store()
        rng = random.Random(4)
        old_pays = _payloads(rng, 4, 6, tag="old")
        pipe.settle(store, _plan(pipe, store, old_pays), [True] * 4, steps=1,
                    now=NOW - 500.0)
        store.sync()
        pays = _payloads(rng, 10, 6, tag="live")
        session = pipe.ShardedSettlementSession(
            store, _plan(pipe, store, pays), mesh, band=(0, 10))
        session.settle([True] * 10, steps=1, now=NOW)
        session._epoch0 = NOW - 0.5
        served.append(session.adopt(_plan(pipe, store, pays[:6] + old_pays),
                                    band=(0, 10)))
        session.close()
    assert served == ["rebuild:backdated-stamps"] * 2


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backdated_stamps_on_whole_axis_band(shape):
    served = []
    for kind, mesh in zip(("jax", "torch"), meshes(shape)):
        pipe = jpipe if kind == "jax" else tpipe
        store = JaxStore() if kind == "jax" else cpu_store()
        rng = random.Random(4)
        old_pays = _payloads(rng, 4, 6, tag="old")
        pipe.settle(store, _plan(pipe, store, old_pays), [True] * 4, steps=1,
                    now=NOW - 500.0)
        store.sync()
        pays = _payloads(rng, 6, 6, tag="live")
        session = pipe.ShardedSettlementSession(
            store, _plan(pipe, store, pays), mesh)
        session.settle([True] * 6, steps=1, now=NOW)
        session._epoch0 = NOW - 0.5
        served.append(session.adopt(_plan(pipe, store, pays + old_pays)))
        session.close()
    assert served == ["rebuild:backdated-stamps"] * 2


def test_resident_fallbacks_counter_reads_zero(tmp_path):
    readings = []
    for kind, registry_module in (("jax", jobs), ("torch", obs)):
        registry = registry_module.MetricsRegistry()
        previous = registry_module.set_metrics_registry(registry)
        try:
            band_stream(kind, tmp_path, f"{kind}-counters", (1, 1), seed=17)
        finally:
            registry_module.set_metrics_registry(previous)
        counters = registry.export()["counters"]
        assert counters.get("stream.resident_fallbacks", 0) == 0
        assert counters["stream.session_adopts"] >= 1
        readings.append((counters.get("stream.resident_fallbacks", 0),
                         counters["stream.session_adopts"]))
    assert readings[0] == readings[1]


def test_driver_band_change_counts_one_fallback():
    """``SessionDriver.dispatch(band=)`` reaches a real session; a band
    change starts a new one and counts one resident fallback."""
    registry = obs.MetricsRegistry()
    previous = obs.set_metrics_registry(registry)
    try:
        store = cpu_store()
        driver = SessionDriver(store, steps=1,
                               mesh=make_mesh((1, 1), [torch.device("cpu")]))
        rng = random.Random(21)
        served = []
        for markets, band in ((6, (0, 6)), (6, (0, 6)), (7, (0, 7))):
            plan = _plan(tpipe, store, _payloads(rng, markets, 8))
            driver.dispatch(plan, [True] * markets, now=NOW + len(served),
                            band=band)
            served.append(driver.last_adopt)
        driver.finalize()
    finally:
        obs.set_metrics_registry(previous)
    assert served == ["start", "relayout", "start"]
    assert registry.export()["counters"]["stream.resident_fallbacks"] == 1


def test_failed_band_adopt_leaves_the_session_whole():
    """An adopt whose plan does not tile its band raises before the session
    changes: the next settle and adopt run on the bound band and plan, as
    on a session that never saw the failed adopt."""
    runs = []
    for fail in (False, True):
        store = cpu_store()
        rng = random.Random(5)
        pays = _payloads(rng, 10, 8)
        session = tpipe.ShardedSettlementSession(
            store, _plan(tpipe, store, pays),
            make_mesh((1, 1), [torch.device("cpu")]), band=(0, 10))
        session.settle([True] * 10, steps=1, now=NOW)
        if fail:
            with pytest.raises(ValueError, match="band plan covers"):
                session.adopt(_plan(tpipe, store, pays), band=(0, 12))
        again = session.settle([False] * 10, steps=1, now=NOW + 1)
        served = session.adopt(
            _plan(tpipe, store, pays[:6] + _payloads(rng, 4, 8, tag="x")),
            band=(0, 10))
        last = session.settle([True] * 10, steps=1, now=NOW + 2)
        session.close()
        runs.append((served, np.asarray(again.consensus),
                     np.asarray(last.consensus), store.list_sources()))
    (served, *settled, records), (served_after, *settled_after,
                                   records_after) = runs
    assert served == served_after == "relayout"
    for mine, theirs in zip(settled, settled_after):
        np.testing.assert_array_equal(mine, theirs)
    assert records == records_after


def _analytics_session(pipe, store_cls, mesh, band=None):
    rng = random.Random(8)
    store = store_cls()
    plan = _plan(pipe, store, _payloads(rng, 12, 8), fingerprint=True)
    return pipe.ShardedSettlementSession(store, plan, mesh, band=band)


def _fields(out):
    _result, tiebreak, bands, propagated = out
    values = [np.asarray(_result.consensus)]
    values += [np.asarray(x) for x in tiebreak] + [np.asarray(x) for x in bands]
    if propagated is not None:
        values.append(np.asarray(propagated))
    return values


@pytest.mark.parametrize("with_graph", [False, True], ids=["bands", "graph"])
def test_band_session_analytics_bit_equal_to_whole_axis(with_graph):
    """One step at the records' stamp reads nothing decayed, so the port
    band session equals its whole-axis session bit for bit, and the JAX
    band session within the consensus tolerance."""
    jmesh, tmesh = meshes((4, 2))
    port_options = AnalyticsOptions(
        graph=MarketGraph.from_edges([("m-0", "m-1", 0.5)]) if with_graph
        else None)
    jax_options = JaxAnalyticsOptions(
        graph=JaxMarketGraph.from_edges([("m-0", "m-1", 0.5)]) if with_graph
        else None)
    outs = {}
    for name, band in (("band", (0, 12)), ("whole", None)):
        with _analytics_session(tpipe, cpu_store, tmesh, band) as session:
            outs[name] = _fields(session.settle_with_analytics(
                [True] * 12, steps=1, now=NOW, analytics=port_options))
    with _analytics_session(jpipe, JaxStore, jmesh, (0, 12)) as session:
        outs["jax"] = _fields(session.settle_with_analytics(
            [True] * 12, steps=1, now=NOW, analytics=jax_options))
    assert len(outs["band"]) == len(outs["whole"]) == len(outs["jax"])
    for mine, whole, theirs in zip(outs["band"], outs["whole"], outs["jax"]):
        np.testing.assert_array_equal(mine, whole)
        np.testing.assert_allclose(mine, theirs.astype(mine.dtype), **TOL)


def test_multi_process_runtime_refuses_analytics_naming_meshview(monkeypatch):
    messages = []
    for pipe, store_cls, mesh in zip((jpipe, tpipe), (JaxStore, cpu_store),
                                     meshes((4, 2))):
        monkeypatch.setattr(pipe, "_process_count", lambda: 2)
        with _analytics_session(pipe, store_cls, mesh) as session:
            with pytest.raises(Exception, match="MeshView") as info:
                session.settle_with_analytics([True] * 12, steps=1, now=NOW)
        messages.append(info)
    assert messages[1].type is ClusterModeUnsupported
    assert messages[0].type.__name__ == "ClusterModeUnsupported"
