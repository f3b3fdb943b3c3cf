"""Observability on the port's stream: on or off moves no byte, and what it
records has the JAX package's names.

A stream with a recording phase timeline, an enabled metrics registry and
a tracer gives the same results, store, journal bytes and SQLite bytes as
the same stream with obs off (bit for bit), flat and on a resident (1, 1)
CPU mesh; with obs off the stats carry no ``phases``. With obs on, the
same batches through the JAX package's stream (its timeline, registry and
tracer) and the port's, both on the Python host route
(``BCE_NO_NATIVE=1``, so the same store counters run), record:

* the same span names, each entered the same number of times
  (``PhaseTimeline.counts()``), and per-batch ``phases`` keys;
* the same metric names, counter values, gauge names and histogram
  bucket layouts and counts (timings differ, layouts may not);
* the same trace events, by scope, key and name.

Everything runs on the CPU with the wall clock pinned and the prefetch
worker gated (see ``tests/test_torch_stream.py``); no tolerance.
"""

import jax
import numpy as np
import pytest

from bayesian_consensus_engine_tpu import obs as jobs
from bayesian_consensus_engine_tpu.parallel.mesh import make_mesh as jax_mesh
from bayesian_consensus_engine_tpu_torch import obs
from bayesian_consensus_engine_tpu_torch.parallel.mesh import make_mesh
from test_torch_stream import (
    assert_same_stream,
    random_payloads,
    run_stream,
    stable_batches,
)

MESHES = {"flat": None, "resident": (1, 1)}
# Only timings may differ between two runs; every name and count may not.
TIMED_GAUGES = ("stream.ingest_wait_s", "stream.intern_wait_s")


def obs_batches():
    rng = np.random.default_rng(11)
    fresh = [(random_payloads(rng, 10, 12, tag="-o"),
              (rng.random(10) < 0.5).tolist())]
    return (stable_batches(13, num_batches=2)
            + stable_batches(14, num_batches=2, markets=11) + fresh)


def stream_kw(kind, mesh_name):
    shape = MESHES[mesh_name]
    if shape is None:
        mesh = None
    elif kind == "jax":
        mesh = jax_mesh(shape, devices=jax.devices()[:1])
    else:
        mesh = make_mesh(shape, ["cpu"])
    return dict(journal=True, checkpoint_every=2, reuse_plans=True,
                mesh=mesh)


def observed(kind, tmp, name, mesh_name, python_route=False):
    """The stream with a timeline, a registry and a tracer of *kind*'s
    obs package. Returns (run, timeline, registry, tracer)."""
    package = jobs if kind == "jax" else obs
    timeline = package.PhaseTimeline()
    registry = package.MetricsRegistry()
    tracer = package.Tracer()
    previous = package.set_metrics_registry(registry)
    previous_tracer = package.set_tracer(tracer)
    try:
        with package.recording(timeline):
            run = run_stream(kind, obs_batches(), tmp, name,
                             python_route=python_route,
                             **stream_kw(kind, mesh_name))
    finally:
        package.set_metrics_registry(previous)
        package.set_tracer(previous_tracer)
    return run, timeline, registry, tracer


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_obs_on_moves_no_byte(tmp_path, mesh_name):
    off = run_stream("torch", obs_batches(), tmp_path, "off",
                     **stream_kw("torch", mesh_name))
    on, timeline, registry, tracer = observed("torch", tmp_path, "on",
                                              mesh_name)
    assert_same_stream(on, off, bitwise=True)
    assert on.db.read_bytes() == off.db.read_bytes()
    assert all("phases" not in s for s in off.stats)
    for entry in on.stats:
        assert set(entry["phases"]) <= set(obs.PHASES)
        assert "settle_dispatch" in entry["phases"]
    totals = timeline.totals()
    assert {"pack", "upload", "settle_dispatch", "checkpoint",
            "interchange_export"} <= set(totals)
    if mesh_name == "resident":
        assert "state_adopt" in totals
    assert registry.export()["counters"]["stream.batches"] == 5
    batch_keys = {e["key"] for e in tracer.events() if e["scope"] == "batch"}
    assert batch_keys == set(range(5))


def _layout(registry):
    export = registry.export()
    return {
        "counters": export["counters"],
        "gauges": sorted(name for name in export["gauges"]),
        "gauge_values": {name: value for name, value
                         in export["gauges"].items()
                         if name not in TIMED_GAUGES},
        "histograms": {name: (h["bounds"], h["count"])
                       for name, h in export["histograms"].items()},
    }


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_span_and_metric_names_equal_jax(tmp_path, mesh_name):
    results = {}
    for kind in ("jax", "torch"):
        run, timeline, registry, tracer = observed(kind, tmp_path, kind,
                                                   mesh_name,
                                                   python_route=True)
        events = sorted((e["scope"], e["key"], e["name"])
                        for e in tracer.events())
        results[kind] = (timeline.counts(), [sorted(s["phases"])
                                             for s in run.stats],
                         _layout(registry), events)
    port, ref = results["torch"], results["jax"]
    assert port[0] == ref[0]  # span names and how often each was entered
    assert port[1] == ref[1]  # per-batch phases keys
    assert port[2] == ref[2]  # metric names, counters, bucket layouts
    assert port[3] == ref[3]  # trace chains
    counters = port[2]["counters"]
    assert counters["stream.plan_reuse_hits"] == 2
    assert counters["stream.plan_reuse_misses"] == 3
    assert counters["ingest.python_packs"] == 3
    assert counters["intern.delta_pairs"] > 0
    if mesh_name == "resident":
        assert counters["stream.session_adopts"] == 2
        assert counters["stream.resident_fallbacks"] == 0
        assert {"hbm.bytes_in_use", "hbm.peak_bytes"} <= set(port[2]["gauges"])
