"""The port's counterfactual replay lab ≡ the JAX package's.

One small service-shaped workload (three columnar batches of 16 markets,
half the keys recurring) is recorded live through both packages'
``settle_stream`` with a journal and its trace sidecar (the wall clock
pinned, both on their Python host route so SQLite files compare byte for
byte). Against the JAX package, on the CPU:

* the trace sidecars are byte-equal and load to the same batches;
* lane 0's rebuild (``replay_sweep``) has the live run's
  ``store_digest`` and SQLite bytes, the JAX package's too; so does
  ``drive_trace`` on (1, 1) and (1, 4) meshes (sharded-resident);
* every lane's ``markets_settled`` is equal, its stacked lane state
  bit-equal, and its Brier, band-width and graph-Brier sums within rtol
  1e-5 of the JAX lane's (the decayed weights go through ``exp2``, which
  differs by ulps between XLA and PyTorch, and XLA sums over markets in
  its own order);
* a sweep run twice has the same ``result_digest`` and lane-state bytes;
  ``replay_single`` equals its sweep lane; altered lanes diverge; the
  refusals (empty trace, mixed steps, a graph lane without a graph, no
  CUDA device) are the reference's;
* ``extract_cluster_trace`` merges two band journals as the reference
  does, and the merged trace replays to the same digest;
* the CLI's ``replay`` prints what the reference CLI prints, table and
  ``--json`` (numbers within rtol 1e-5), and exports the same file.

And ``settle_cycles_lanes_reference`` at the recorded rates against the
plain single-lane ``settle_cycles_reference``: at float32 the state is
bit-equal and the consensus within 2e-7 (the lane divides by its
half-life where the constant path multiplies by the reciprocal, and sums
its slots in slot order); at float64 the lanes carry their rates as
float32 values, as the JAX package's lanes do, so the state moves off
the constant path's by a few ulps of float32's 0.15 and 0.1.
"""

import contextlib
import io
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu import cli as jcli
from bayesian_consensus_engine_tpu import obs as jobs
from bayesian_consensus_engine_tpu import replay as jreplay
from bayesian_consensus_engine_tpu.analytics import MarketGraph as JaxGraph
from bayesian_consensus_engine_tpu.cluster import recover as jrecover
from bayesian_consensus_engine_tpu.parallel import mesh as jmesh
from bayesian_consensus_engine_tpu.parallel import sharded as jsharded
from bayesian_consensus_engine_tpu.pipeline import settle_stream as jstream
from bayesian_consensus_engine_tpu.serve.driver import drive_trace as jdrive
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import cli as tcli
from bayesian_consensus_engine_tpu_torch import obs as tobs
from bayesian_consensus_engine_tpu_torch import replay as treplay
from bayesian_consensus_engine_tpu_torch.analytics import MarketGraph
from bayesian_consensus_engine_tpu_torch.cluster import recover as trecover
from bayesian_consensus_engine_tpu_torch.ops import settle_kernel
from bayesian_consensus_engine_tpu_torch.parallel import mesh as tmesh
from bayesian_consensus_engine_tpu_torch.parallel import sharded as tsharded
from bayesian_consensus_engine_tpu_torch.pipeline import settle_stream as tstream
from bayesian_consensus_engine_tpu_torch.serve.driver import drive_trace as tdrive
from bayesian_consensus_engine_tpu_torch.state.journal import TornTraceError
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore as TorchStore,
)

NOW = 21_900.0
CLOCK = 9_876.5
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
PKG = {"jax": jreplay, "torch": treplay}


def altered(kind):
    """Two counterfactual lanes walking the swept knobs (no RNG)."""
    config = PKG[kind].ReplayConfig
    return (config(half_life_days=12.0, base_learning_rate=0.05),
            config(max_update_step=0.04, band_z=1.25))


def columnar_batches(n_batches=3, per_batch=16, seed=18, prefix=""):
    """Half the keys recur across batches (the refresh path), half are
    fresh (the intern path)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        counts = rng.integers(1, 5, per_batch)
        total = int(counts.sum())
        keys = [f"{prefix}m{m}" if m % 2 == 0 else f"{prefix}b{b}-m{m}"
                for m in range(per_batch)]
        sids = [f"src-{v}" for v in rng.integers(0, 12, total)]
        probs = rng.random(total)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        outcomes = (rng.random(per_batch) < 0.5).tolist()
        out.append(((keys, sids, probs, offsets), outcomes))
    return out


def record(kind, batches, path):
    """The live streamed run with journal + trace; returns its store."""
    store = JaxStore() if kind == "jax" else TorchStore(device="cpu")
    stream = jstream if kind == "jax" else tstream
    for _result in stream(store, batches, steps=2, now=NOW, journal=str(path),
                          trace=str(path) + ".trace", columnar=True):
        pass
    return store


def sweep(kind, trace, configs=None, **kw):
    configs = altered(kind) if configs is None else configs
    if kind == "torch":
        kw.setdefault("device", "cpu")
    return PKG[kind].replay_sweep(trace, configs, **kw)


def load(kind, path, **kw):
    return PKG[kind].load_trace(str(path), **kw)


@pytest.fixture(autouse=True)
def python_route_and_clock(monkeypatch):
    monkeypatch.setenv("BCE_NO_NATIVE", "1")
    monkeypatch.setattr(time, "time", lambda: CLOCK)


@pytest.fixture(scope="module")
def lab(tmp_path_factory):
    """Both packages' live runs, and results computed once and shared."""
    tmp = tmp_path_factory.mktemp("replay")
    cache = {"tmp": tmp}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BCE_NO_NATIVE", "1")
        mp.setattr(time, "time", lambda: CLOCK)
        batches = columnar_batches()
        for kind in ("jax", "torch"):
            cache[kind, "journal"] = tmp / f"{kind}.jrnl"
            cache[kind, "live"] = record(kind, batches, cache[kind, "journal"])
            cache[kind, "sweep"] = sweep(kind, load(kind, cache[kind, "journal"]))
    cache["live_digest"] = trecover.store_digest(cache["torch", "live"])
    return cache


def test_traces_match_jax(lab):
    jpath, tpath = lab["jax", "journal"], lab["torch", "journal"]
    assert (open(str(tpath) + ".trace", "rb").read()
            == open(str(jpath) + ".trace", "rb").read())
    ours, theirs = load("torch", tpath), load("jax", jpath)
    assert len(ours) == len(theirs) == 3
    for mine, ref in zip(ours, theirs):
        for field in ref._fields:
            np.testing.assert_array_equal(np.asarray(getattr(mine, field)),
                                          np.asarray(getattr(ref, field)))


def test_lane0_flat_matches_live_and_jax(lab):
    digest = lab["live_digest"]
    assert jrecover.store_digest(lab["jax", "live"]) == digest
    assert lab["torch", "sweep"].digest == lab["jax", "sweep"].digest == digest
    tmp = lab["tmp"]
    for kind in ("torch", "jax"):
        lab[kind, "live"].flush_to_sqlite(tmp / f"{kind}-live.db")
        lab[kind, "sweep"].store.flush_to_sqlite(tmp / f"{kind}-replay.db")
    files = [(tmp / name).read_bytes() for name in (
        "torch-live.db", "torch-replay.db", "jax-live.db", "jax-replay.db")]
    assert files[0] and all(f == files[0] for f in files)


@pytest.mark.parametrize("shape", [(1, 1), (1, 4)], ids=["1x1", "1x4"])
def test_sharded_resident_rebuild_matches_live_and_jax(lab, shape):
    mesh = tmesh.make_mesh(shape, [torch.device("cpu")] * (shape[0] * shape[1]))
    rebuilt = TorchStore(device="cpu")
    tdrive(rebuilt, load("torch", lab["torch", "journal"]), mesh=mesh)
    if ("jax", "resident") not in lab:
        theirs = JaxStore()
        jdrive(theirs, load("jax", lab["jax", "journal"]),
               mesh=jmesh.make_mesh((1, 1), devices=jax.devices()[:1]))
        lab["jax", "resident"] = jrecover.store_digest(theirs)
    assert (trecover.store_digest(rebuilt) == lab["jax", "resident"]
            == lab["live_digest"])


def test_lanes_match_jax(lab):
    ours, theirs = lab["torch", "sweep"], lab["jax", "sweep"]
    assert [lane.markets_settled for lane in ours.lanes] == [
        lane.markets_settled for lane in theirs.lanes] == [48, 48, 48]
    for mine, ref in zip(ours.lanes, theirs.lanes):
        assert tuple(mine.config) == tuple(ref.config)
        for field in ("brier_sum", "band_width_sum", "graph_brier_sum"):
            np.testing.assert_allclose(getattr(mine, field),
                                       getattr(ref, field), err_msg=field,
                                       **METRIC_TOL)
        assert mine.graph_brier_sum == mine.brier_sum
    for mine, ref in zip(ours.lane_state, theirs.lane_state):
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)
    assert ours.epoch0 == theirs.epoch0 and ours.batches == theirs.batches


def test_run_twice_identical(lab):
    trace = load("torch", lab["torch", "journal"])
    first = sweep("torch", trace, rebuild=False)
    second = sweep("torch", trace, rebuild=False)
    assert first.result_digest == second.result_digest
    for a, b in zip(first.lane_state, second.lane_state):
        assert a.tobytes() == b.tobytes()
    assert first.store is None and first.digest is None


def test_lane0_is_always_the_recorded_config(lab):
    result = lab["torch", "sweep"]
    assert result.lanes[0].config == treplay.RECORDED_CONFIG
    assert set(result.by_config()) == {treplay.RECORDED_CONFIG,
                                       *altered("torch")}


def test_altered_lanes_diverge(lab):
    result = lab["torch", "sweep"]
    reliability = result.lane_state[0]
    assert not np.array_equal(reliability[0], reliability[1])
    by = result.by_config()
    assert by[altered("torch")[1]].band_width_sum != pytest.approx(
        by[treplay.RECORDED_CONFIG].band_width_sum)


def test_replay_single_equals_the_sweep_lane(lab):
    trace = load("torch", lab["torch", "journal"])
    lanes = lab["torch", "sweep"].by_config()
    for config in (treplay.RECORDED_CONFIG,) + altered("torch"):
        alone = treplay.replay_single(trace, config, device="cpu")
        lane = lanes[config]
        assert alone.markets_settled == lane.markets_settled
        assert alone.brier_sum == pytest.approx(lane.brier_sum, rel=1e-6)
        assert alone.band_width_sum == pytest.approx(lane.band_width_sum,
                                                     rel=1e-6)


def test_refusals(lab, monkeypatch):
    with pytest.raises(ValueError, match="empty trace"):
        treplay.replay_sweep([], device="cpu")
    trace = load("torch", lab["torch", "journal"])
    trace[-1] = trace[-1]._replace(steps=trace[-1].steps + 1)
    with pytest.raises(ValueError, match="mixes step counts"):
        treplay.replay_sweep(trace, rebuild=False, device="cpu")
    with pytest.raises(ValueError, match="graph_steps > 0"):
        treplay.replay_sweep(load("torch", lab["torch", "journal"]),
                             (treplay.ReplayConfig(graph_steps=2),),
                             rebuild=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treplay.replay_sweep(load("torch", lab["torch", "journal"]))


GRAPH_EDGES = [("m0", "m2", 1.0), ("m2", "m0", 0.5), ("m4", "m2", 2.0),
               ("m6", "m8", 1.0), ("m8", "m10", 0.75), ("m10", "m6", 1.5)]


def test_graph_lanes_match_jax(lab):
    """Lanes with their own damping, depth and tolerance through both
    packages' relaxations."""
    configs = {
        kind: (PKG[kind].ReplayConfig(graph_steps=3, graph_damping=0.3),
               PKG[kind].ReplayConfig(graph_steps=1),
               PKG[kind].ReplayConfig(graph_steps=4, graph_tol=1e-3,
                                      half_life_days=12.0))
        for kind in PKG
    }
    ours = sweep("torch", load("torch", lab["torch", "journal"]),
                 configs["torch"], rebuild=False,
                 graph=MarketGraph.from_edges(GRAPH_EDGES))
    theirs = sweep("jax", load("jax", lab["jax", "journal"]), configs["jax"],
                   rebuild=False, graph=JaxGraph.from_edges(GRAPH_EDGES))
    for mine, ref in zip(ours.lanes, theirs.lanes):
        assert mine.markets_settled == ref.markets_settled
        for field in ("brier_sum", "band_width_sum", "graph_brier_sum"):
            np.testing.assert_allclose(getattr(mine, field),
                                       getattr(ref, field), err_msg=field,
                                       **METRIC_TOL)
    assert ours.lanes[1].graph_brier_sum != ours.lanes[1].brier_sum


def test_lane_damped_relax_matches_jax():
    rng = np.random.default_rng(8)
    values = rng.random(40).astype(np.float32)
    values[[3, 17]] = np.nan
    idx = rng.integers(-1, 40, (40, 3)).astype(np.int32)
    weights = rng.uniform(0.5, 1.5, (40, 3)).astype(np.float32)
    for damping, lane_steps, tol in ((0.3, 5, None), (0.5, 2, 0.0),
                                     (0.7, 8, 0.05)):
        want = jsharded._lane_damped_relax(
            jnp.asarray(values), jnp.asarray(idx), jnp.asarray(weights),
            jnp.float32(damping), jnp.int32(lane_steps), 6,
            None if tol is None else jnp.float32(tol))
        got = tsharded._lane_damped_relax(
            torch.from_numpy(values), torch.from_numpy(idx),
            torch.from_numpy(weights), torch.tensor(damping, dtype=torch.float32),
            torch.tensor(lane_steps, dtype=torch.int32), 6,
            None if tol is None else torch.tensor(tol, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7, equal_nan=True)


def test_cluster_trace_matches_jax(lab):
    tmp = lab["tmp"]
    paths = {}
    for kind in ("jax", "torch"):
        for band, prefix in (("a", "a-"), ("b", "b-")):
            path = tmp / f"{kind}-band-{band}.jrnl"
            record(kind, columnar_batches(seed=20 + len(prefix) + ord(band),
                                          prefix=prefix), path)
            paths[kind, band] = str(path)
    ours, tags = trecover.extract_cluster_trace(
        [paths["torch", "a"], paths["torch", "b"]])
    theirs, jtags = jrecover.extract_cluster_trace(
        [paths["jax", "a"], paths["jax", "b"]])
    assert tags == jtags and len(ours) == len(theirs) == 3
    for mine, ref in zip(ours, theirs):
        for field in ref._fields:
            np.testing.assert_array_equal(np.asarray(getattr(mine, field)),
                                          np.asarray(getattr(ref, field)))
    merged = treplay.load_cluster_trace([paths["torch", "a"],
                                         paths["torch", "b"]])
    jmerged = jreplay.load_cluster_trace([paths["jax", "a"], paths["jax", "b"]])
    assert (sweep("torch", merged, ()).digest
            == sweep("jax", jmerged, ()).digest)
    # A torn band tail: the merge stops at the shorter band; strict refuses.
    with open(paths["torch", "b"], "r+b") as f:
        f.truncate(os.path.getsize(paths["torch", "b"]) - 9)
    assert len(treplay.load_cluster_trace(
        [paths["torch", "a"], paths["torch", "b"]])) == 2
    with pytest.raises(TornTraceError):
        treplay.load_cluster_trace([paths["torch", "a"], paths["torch", "b"]],
                                   strict=True)
    with pytest.raises(ValueError, match="no journals"):
        trecover.extract_cluster_trace([])


def run_cli(module, argv):
    out, err = io.StringIO(), io.StringIO()
    code = 0
    registries = [(obs, obs.metrics_registry()) for obs in (tobs, jobs)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["bce", *argv])
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                module.main()
            except SystemExit as exc:
                code = exc.code if isinstance(exc.code, int) else 1
            finally:
                for obs, registry in registries:
                    obs.set_metrics_registry(registry)
    return code, out.getvalue(), err.getvalue()


def test_cli_replay_matches_reference(lab):
    import json

    journal = str(lab["jax", "journal"])
    tmp = lab["tmp"]
    lanes = ["--configs", "half_life_days=12,base_learning_rate=0.05",
             "--configs", "max_update_step=0.04,band_z=1.25"]
    mine = run_cli(tcli, ["--device", "cpu", "--db", str(tmp / "cli-t.db"),
                          "replay", journal, *lanes])
    theirs = run_cli(jcli, ["--db", str(tmp / "cli-j.db"), "replay", journal,
                            *lanes])
    assert mine[0] == theirs[0] == 0
    assert mine[1] == theirs[1].replace("cli-j.db", "cli-t.db")
    assert (tmp / "cli-t.db").read_bytes() == (tmp / "cli-j.db").read_bytes()
    code, out, _err = run_cli(tcli, ["--device", "cpu", "replay", journal,
                                     "--json", *lanes])
    _jcode, jout, _jerr = run_cli(jcli, ["replay", journal, "--json", *lanes])
    doc, jdoc = json.loads(out), json.loads(jout)
    assert code == 0 and doc.keys() == jdoc.keys()
    for key in ("journals", "batches", "digest", "exportedTo", "dryRun"):
        assert doc[key] == jdoc[key], key
    for lane, jlane in zip(doc["lanes"], jdoc["lanes"]):
        for key, value in jlane.items():
            if isinstance(value, float):
                np.testing.assert_allclose(lane[key], value, **METRIC_TOL)
            else:
                assert lane[key] == value, key
    # Argument errors are the reference's.
    for argv in (["replay", journal, "--configs", "bogus=1"],
                 ["replay", journal, "--configs", "graph_steps=2"]):
        assert run_cli(tcli, ["--device", "cpu", *argv]) == run_cli(jcli, argv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_lanes_reference_at_recorded_rates(dtype):
    """Each lane at the recorded rates against the single-lane path."""
    rng = np.random.default_rng(4)
    num_slots, num_markets, rows = 6, 50, 400
    mask = rng.random((num_slots, num_markets)) < 0.6
    slot_rows = np.full((num_slots, num_markets), -1, np.int32)
    slot_rows.T[mask.T] = rng.permutation(rows)[: int(mask.sum())]
    _rows, offsets = settle_kernel.touched_layout(slot_rows, mask)
    state = (
        torch.tensor(rng.random((2, rows)), dtype=dtype),
        torch.tensor(rng.random((2, rows)), dtype=dtype),
        torch.tensor(np.where(rng.random((2, rows)) < 0.3, 0,
                              rng.integers(1, 500, (2, rows))), dtype=dtype),
        torch.tensor(rng.random((2, rows)) < 0.7),
    )
    plan = (torch.from_numpy(slot_rows),
            torch.tensor(rng.random((num_slots, num_markets)), dtype=dtype),
            torch.from_numpy(mask), torch.from_numpy(rng.random(num_markets) < 0.5),
            torch.from_numpy(offsets), int(mask.sum()))
    recorded = torch.tensor(
        np.float32(settle_kernel.CycleParams()), dtype=torch.float32
    ).repeat(2, 1)
    lanes = settle_kernel.settle_cycles_lanes(*state, *plan, 520.5, 3,
                                              recorded)
    for lane in range(2):
        flat = settle_kernel.settle_cycles_reference(
            *(x[lane] for x in state), *plan, 520.5, 3)
        for got, want in zip(lanes[:4], flat[:4]):
            if dtype == torch.float32:
                assert torch.equal(got[lane], want)
            else:
                torch.testing.assert_close(got[lane], want, rtol=0, atol=1e-8)
        torch.testing.assert_close(lanes.consensus[lane], flat.consensus,
                                   rtol=0, atol=2e-7, equal_nan=True)


def test_cli_replay_needs_a_device(lab, monkeypatch):
    """Without CUDA the CLI's replay fails with the store's message unless
    ``--device cpu`` is given; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out, err = run_cli(tcli, ["replay", str(lab["torch", "journal"])])
    assert (code, out) == (1, "")
    assert err.startswith("Error: ") and "no CUDA device" in err
