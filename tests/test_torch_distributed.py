"""The port's multi-process tier (``parallel/distributed.py`` and band
sessions across ``torch.distributed`` ranks) against the JAX package, on
the CPU.

Single-process cases, as the JAX package's ``tests/test_distributed.py``
has them: ``init_distributed`` is a no-op in one process and a real
bring-up failure raises; ``_band_from_intervals`` proves a band tiles;
``make_hybrid_mesh`` reduces to the local mesh with the JAX package's
shapes; ``global_block`` / ``global_market`` / ``global_slot_block``
round-trip through ``local_view``, and the cycle through the distributed
assembly equals the JAX cycle.

Multi-process: two gloo ranks, and three ranks with an uneven tail (ten
markets over a padded axis of twelve: the last band holds two), each a
separate process that runs the port's rank routine
(``cluster/rank.py``) and imports torch and the port only. This process
makes the batches from the seed and writes each rank its band. Every rank
joins through ``init_distributed`` (port from a bind to port 0, a 60 s
rendezvous timeout), builds the hybrid mesh over its CPU devices (one
granule a rank), packs ONLY its band's markets into a band plan and runs
a ``ShardedSettlementSession(band=...)``: two chained settles, an adopt
of a drifted batch and a third settle; then the same on a local mesh
(``MeshView.degraded([rank])``), which every rank of the live group
must be able to run. The union of the ranks' consensus and stores must
equal the JAX single-process session on the same seed-made data,
computed here: bit for bit (no settle reads a decayed weight). Each run
is one module-scoped fixture whose processes are killed if they outlast
120 s.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch

from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.parallel import (
    build_cycle as jax_build_cycle,
    init_block_state as jax_init_block_state,
)
from bayesian_consensus_engine_tpu.parallel.distributed import (
    make_hybrid_mesh as jax_hybrid_mesh,
)
from bayesian_consensus_engine_tpu.parallel.mesh import make_mesh as jax_mesh
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch.cluster import MeshView
from bayesian_consensus_engine_tpu_torch.cluster.rank import (
    band_columns,
    save_batches,
)
from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
from bayesian_consensus_engine_tpu_torch.parallel import distributed
from bayesian_consensus_engine_tpu_torch.parallel.distributed import (
    _band_from_intervals,
    global_block,
    global_market,
    global_slot_block,
    init_distributed,
    local_view,
    make_hybrid_mesh,
    process_market_rows,
)
from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
    MARKETS_AXIS,
    SOURCES_AXIS,
    make_mesh,
)
from bayesian_consensus_engine_tpu_torch.parallel.sharded import (
    build_cycle_loop,
    init_block_state,
)

_ROOT = pathlib.Path(__file__).resolve().parents[1]
M, K = 32, 16
CPU = torch.device("cpu")
WORKER_TIMEOUT_S = 120


class TestInitDistributed:
    def test_single_process_noop(self):
        info = init_distributed()
        assert info["process_index"] == 0 and info["process_count"] == 1
        assert not distributed.is_initialized()

    def test_num_processes_one_noop(self):
        assert init_distributed(num_processes=1)["process_count"] == 1

    def test_runtime_probe_is_torch_distributed(self):
        assert distributed.is_initialized() is torch.distributed.is_initialized()
        assert (distributed.process_index(), distributed.process_count()) == (
            0, 1)

    def test_cluster_bringup_failure_surfaces(self):
        # A rank that cannot reach its coordinator must fail loudly, never
        # degrade to a one-process run.
        port = _free_port()
        with pytest.raises(RuntimeError):
            init_distributed(coordinator_address=f"127.0.0.1:{port}",
                             num_processes=2, process_id=1,
                             timeout=timedelta(seconds=2))
        assert not distributed.is_initialized()

    def test_partial_cluster_arguments_raise(self):
        with pytest.raises(ValueError, match="coordinator_address"):
            init_distributed(num_processes=2)


class TestBandFromIntervals:
    def test_contiguous_tiling_collapses(self):
        assert _band_from_intervals({(0, 4), (4, 8), (8, 12)}) == (0, 12)

    def test_duplicate_intervals_ok(self):
        assert _band_from_intervals({(4, 8), (4, 8)}) == (4, 8)

    def test_single_interval(self):
        assert _band_from_intervals({(16, 32)}) == (16, 32)

    def test_gap_raises(self):
        with pytest.raises(ValueError, match="not contiguous"):
            _band_from_intervals({(0, 4), (8, 12)})

    def test_overlap_raises(self):
        with pytest.raises(ValueError, match="not contiguous"):
            _band_from_intervals({(0, 6), (4, 8)})

    def test_empty_raises(self):
        with pytest.raises(ValueError, match="owns no devices"):
            _band_from_intervals(set())


def shape_of(mesh):
    return mesh.shape[MARKETS_AXIS], mesh.shape[SOURCES_AXIS]


class TestHybridMesh:
    @pytest.mark.parametrize("kwargs", [
        {}, dict(ici_shape=(4, 2)), dict(ici_shape=(2, 2), num_granules=2),
        dict(ici_shape=(1, 4), num_granules=2), dict(num_granules=4),
    ], ids=["default", "ici", "granules", "sources", "four"])
    def test_shapes_equal_jax(self, kwargs):
        ours = make_hybrid_mesh(devices=[CPU] * 8, **kwargs)
        theirs = jax_hybrid_mesh(devices=jax.devices()[:8], **kwargs)
        assert shape_of(ours) == (theirs.shape[MARKETS_AXIS],
                                  theirs.shape[SOURCES_AXIS])
        # One process: the local mesh, comparing and hashing as make_mesh's.
        assert ours.owners is None
        assert ours == make_mesh(shape_of(ours), [CPU] * 8)
        assert hash(ours) == hash(make_mesh(shape_of(ours), [CPU] * 8))

    def test_bad_ici_shape_raises(self):
        with pytest.raises(ValueError, match="devices per granule"):
            make_hybrid_mesh(ici_shape=(3, 2), devices=[CPU] * 8)

    def test_granules_must_split_the_devices(self):
        with pytest.raises(ValueError, match="do not split"):
            make_hybrid_mesh(num_granules=3, devices=[CPU] * 8)

    def test_owners_select_a_process_rows(self):
        mesh = make_mesh((4, 1), [CPU] * 4)
        owned = type(mesh)(mesh.devices, (0, 0, 1, 1))
        assert owned != mesh and owned.local(1).shape[MARKETS_AXIS] == 2
        assert owned.owner_of(3) == 1 and mesh.owner_of(3) == 0
        with pytest.raises(ValueError, match="owns no row"):
            owned.local(2)
        assert type(mesh)(mesh.devices, (0, 0, 0, 0)) == mesh


class TestGlobalArrays:
    def test_round_trip_block(self):
        mesh = make_hybrid_mesh(ici_shape=(4, 2), devices=[CPU] * 8)
        full = np.random.default_rng(0).random((M, K)).astype(np.float32)
        lo, hi = process_market_rows(M, mesh)
        assert (lo, hi) == (0, M)  # one process owns everything
        grid = global_block(full[lo:hi], mesh, M)
        assert len(grid) == 4 and len(grid[0]) == 2
        np.testing.assert_array_equal(local_view(grid), full)
        slot = global_slot_block(full.T, mesh, M)
        np.testing.assert_array_equal(local_view(slot, slot_major=True), full.T)

    def test_round_trip_market_vector(self):
        mesh = make_hybrid_mesh(devices=[CPU] * 8)
        vec = np.arange(M, dtype=np.float32)
        np.testing.assert_array_equal(local_view(global_market(vec, mesh, M)),
                                      vec)

    def test_band_width_is_checked(self):
        mesh = make_hybrid_mesh(devices=[CPU] * 8)
        with pytest.raises(ValueError, match="band"):
            global_market(np.zeros(M - 8, np.float32), mesh, M)
        with pytest.raises(ValueError, match="divide"):
            process_market_rows(M + 1, mesh)

    def test_local_view_requires_shards(self):
        with pytest.raises(ValueError, match="no shards"):
            local_view(())

    def test_cycle_through_distributed_assembly_equals_jax(self):
        """The port's loop on blocks assembled through the distributed
        helpers (one process, a (4, 1) hybrid mesh) equals the JAX cycle
        on the plain 8-device mesh: the state bit for bit, the consensus
        within the JAX package's own rtol 2e-6 (its one-cycle program adds
        the slots in another order than the loop)."""
        mesh = make_hybrid_mesh(ici_shape=(4, 1), devices=[CPU] * 4)
        rng = np.random.default_rng(1)
        probs_np = rng.random((M, K)).astype(np.float32)
        mask_np = rng.random((M, K)) < 0.8
        outcome_np = rng.random(M) < 0.5
        cold = init_block_state(M, K, device="cpu")
        state = tuple(
            tuple(MarketBlockState(*cells) for cells in zip(*rows))
            for rows in zip(*(global_slot_block(x.T.numpy(), mesh, M)
                              for x in cold))
        )
        new_state, consensus = build_cycle_loop(mesh)(
            global_slot_block(probs_np.T, mesh, M),
            global_slot_block(mask_np.T, mesh, M),
            global_market(outcome_np, mesh, M), state, 1.0, 1)
        plain = jax_build_cycle(jax_mesh((8, 1)), donate=False)(
            jax.numpy.asarray(probs_np), jax.numpy.asarray(mask_np),
            jax.numpy.asarray(outcome_np), jax_init_block_state(M, K),
            jax.numpy.float32(1.0))
        np.testing.assert_allclose(consensus.numpy(),
                                   np.asarray(plain.consensus), rtol=2e-6)
        reliability = tuple(tuple(s.reliability for s in row)
                            for row in new_state)
        np.testing.assert_array_equal(local_view(reliability, slot_major=True),
                                      np.asarray(plain.state.reliability).T)


# -- several processes ---------------------------------------------------------

NOW = 20_750.0
NUM_SLOTS = 8


def make_batches(markets, seed):
    """Two seed-made global columnar batches, the second's sources
    drifted: ``(keys, source ids, probs, offsets, outcomes)`` each."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 4, markets)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    keys = [f"mkt-{m}" for m in range(markets)]
    batches = []
    for shift in (0, 5):
        sids = [f"src-{(m * 3 + j * 7 + shift) % 12}"
                for m in range(markets) for j in range(counts[m])]
        probs = np.round(rng.random(int(counts.sum())), 6)
        outcomes = rng.random(markets) < 0.5
        batches.append((keys, sids, probs, offsets, outcomes))
    return batches


# A rank: the port's rank module, then the names of the JAX modules it
# loaded, on a line of their own.
_RANK = """
import json, sys
from bayesian_consensus_engine_tpu_torch.cluster import rank
code = rank.main()
PACKAGE = "bayesian_consensus_engine_tpu"
print(json.dumps(sorted(
    name for name in sys.modules
    if name == "jax" or name.startswith("jax.")
    or name == PACKAGE or name.startswith(PACKAGE + "."))))
sys.exit(code)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp, nproc, markets, icis, seed):
    """Each rank's report, its loaded JAX modules and its runs' arrays."""
    batches = make_batches(markets, seed)
    table = sorted({sid for batch in batches for sid in batch[1]})
    code = {sid: i for i, sid in enumerate(table)}
    coded = [(keys, SourceCodes([code[sid] for sid in sids], table), probs,
              offsets, outcomes)
             for keys, sids, probs, offsets, outcomes in batches]
    view = MeshView(epoch=0, hosts=tuple(range(nproc)))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "BCE_NO_NATIVE"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    procs = []
    try:
        for pid in range(nproc):
            rows = view.owned_markets(pid, markets)
            path = str(tmp / f"batches{pid}.npz")
            save_batches(path, rows,
                         [band_columns(batch, rows) for batch in coded])
            job = dict(port=port, rank=pid, ranks=nproc, device="cpu",
                       batches=path, markets=markets, num_slots=NUM_SLOTS,
                       steps=1, now=[NOW] * 3, icis=icis, local=[1, 1],
                       records=True, timeout_s=60,
                       out=str(tmp / f"rank{pid}-%s.npz"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK, json.dumps(job)], cwd=_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env))
        outputs = [proc.communicate(timeout=WORKER_TIMEOUT_S)[0]
                   for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    runs = []
    for pid, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"rank {pid} failed:\n{out[-4000:]}"
        *_, report, modules = out.strip().splitlines()
        report = json.loads(report)
        arrays = {name: dict(np.load(tmp / f"rank{pid}-{name}.npz"))
                  for name in report if isinstance(report[name], dict)}
        runs.append((report, json.loads(modules), arrays))
    return runs


def jax_session_run(markets, seed, shape):
    """The JAX single-process session on the whole axis: the same settles
    and adopt as the ranks, on a mesh of *shape*."""
    store = JaxStore()
    n = shape[0] * shape[1]
    mesh = jax_mesh(shape, devices=jax.devices()[:n])
    first, second = make_batches(markets, seed)
    plan = jpipe.build_settlement_plan_columnar(store, *first[:4],
                                                num_slots=NUM_SLOTS)
    session = jpipe.ShardedSettlementSession(store, plan, mesh)
    consensus = []
    for _ in range(2):
        consensus.append(np.asarray(session.settle(
            first[4], steps=1, now=NOW).consensus))
    plan2 = jpipe.build_settlement_plan_columnar(store, *second[:4],
                                                 num_slots=NUM_SLOTS)
    served = session.adopt(plan2)
    consensus.append(np.asarray(session.settle(second[4], steps=1,
                                               now=NOW).consensus))
    session.close()
    records = sorted((r.source_id, r.market_id, r.reliability, r.confidence,
                      r.updated_at) for r in store.list_sources())
    return served, consensus, records


def rank_records(arrays):
    return [(s, m, float(rel), float(conf), stamp)
            for (s, m, stamp), (rel, conf) in zip(
                arrays["record_ids"].tolist(),
                arrays["record_values"].tolist())]


CLUSTERS = {
    # name: (ranks, markets, per-rank ici shapes, seed)
    "two": (2, 13, [[1, 1], [1, 2]], 31),
    "three_uneven": (3, 10, [[1, 1]], 37),
}


@pytest.fixture(scope="module")
def cluster_runs(tmp_path_factory):
    runs = {}
    for name, (nproc, markets, icis, seed) in CLUSTERS.items():
        runs[name] = run_ranks(tmp_path_factory.mktemp(name), nproc, markets,
                               icis, seed)
    return runs


@pytest.mark.parametrize("name", list(CLUSTERS))
def test_ranks_load_nothing_of_jax(cluster_runs, name):
    assert all(modules == [] for _report, modules, _ in cluster_runs[name])


@pytest.mark.parametrize("name", list(CLUSTERS))
def test_bands_tile_the_axis_with_an_uneven_tail(cluster_runs, name):
    nproc, markets, icis, _seed = CLUSTERS[name]
    for ici in icis:
        label = "%dx%d" % tuple(ici)
        reports = [report[label] for report, _, _ in cluster_runs[name]]
        rows = [tuple(r["rows"]) for r in reports]
        assert rows[0][0] == 0 and rows[-1][1] == markets
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
        bands = [tuple(r["padded_band"]) for r in reports]
        width = bands[0][1] - bands[0][0]
        assert bands == [(p * width, (p + 1) * width) for p in range(nproc)]
        assert all(r["local_mesh_rows"] == ici[0] for r in reports)
        stored = [len(arrays[label]["record_ids"])
                  for _, _, arrays in cluster_runs[name]]
        assert all(r["store_rows_by_rank"] == stored for r in reports)
    if name == "three_uneven":
        assert [report["1x1"]["rows"] for report, _, _ in cluster_runs[name]
                ] == [[0, 4], [4, 8], [8, 10]]


def _assert_union_equals_jax(runs, label, markets, jax_run):
    served, consensus, records = jax_run
    assert served == "relayout"
    assert [report[label]["served"] for report, _, _ in runs] == [
        "relayout"] * len(runs)
    # The adopted block equals one rebuilt from the synced host in its
    # reliabilities, stamps and existence. Its confidences carry the
    # block's own float32 chain, which the host replaces with its exact
    # replay (``_replay_confidences``), so a rebuild may differ there in
    # the last place.
    for report, _, _ in runs:
        rel, _conf, days, exists = report[label]["rebuild_equal"]
        assert rel and days and exists
    keys = [k for _, _, arrays in runs for k in arrays[label]["keys"].tolist()]
    assert keys == [f"mkt-{m}" for m in range(markets)]
    for settle in range(3):
        union = np.concatenate([arrays[label][f"consensus_{settle + 1}"]
                                for _, _, arrays in runs])
        np.testing.assert_array_equal(union, consensus[settle])
    union_records = sorted(rec for _, _, arrays in runs
                           for rec in rank_records(arrays[label]))
    assert union_records == records


@pytest.mark.parametrize("name, ici", [
    (name, ici) for name, (_n, _m, icis, _s) in CLUSTERS.items()
    for ici in icis
], ids=str)
def test_band_union_bit_equal_to_jax_single_process(cluster_runs, name, ici):
    nproc, markets, _icis, seed = CLUSTERS[name]
    # The JAX single-process session on the mesh the ranks make together.
    _assert_union_equals_jax(
        cluster_runs[name], "%dx%d" % tuple(ici), markets,
        jax_session_run(markets, seed, (nproc * ici[0], ici[1])))


@pytest.mark.parametrize("name", list(CLUSTERS))
def test_local_mesh_session_on_every_rank_equals_jax(cluster_runs, name):
    """A session on a local mesh (the one-host view's, ``MeshView.degraded
    ([rank])``) runs on every rank of a live group, rank 0 or not: each
    rank's local-mesh run over its band's markets, joined, is the JAX
    single-process session."""
    nproc, markets, _icis, seed = CLUSTERS[name]
    runs = cluster_runs[name]
    assert [report["local"]["local_mesh_rows"] for report, _, _ in runs] == [
        1] * nproc
    _assert_union_equals_jax(runs, "local", markets,
                             jax_session_run(markets, seed, (1, 1)))
