"""The port stands alone: importing it (every module of the analytics,
inference and mesh slices, the native host path, the consensus surface,
the journal, every ``obs`` module, ``serve`` and ``utils.profiling``
included), building and loading its own C extensions, computing scalar and
batched consensus documents, settling on the CPU, settling through the
resident session with analytics and graph inference, settling on a
sources-sharded CPU mesh, writing, replaying and compacting a two-epoch
journal beside a background SQLite flush, streaming batches through a
resident session with a journal and a trace, streaming a process band
and recovering its journal (membership views, the cluster merge and
adoption, the distributed helpers, the rank routine and the kill soak's
module), re-driving
the trace and
replaying it under an altered config (the replay lab, its lane kernel's
plain version and the store digest), the sorted tie-break and the
standalone band program, and
rendering, serving and folding the telemetry, serving two requests
through the request front door (the coalescing service with analytics on
a (1, 1) CPU mesh and a journal, behind the socket server, to the
client), and the rest of the public surface (``build_cycle``, the cycle
loop and the tie-break loop under ``auto_trace``, a ``CycleCheckpointer``
snapshot of the loop's state and the store's ``save_checkpoint`` /
``load_checkpoint``) loads neither JAX nor any module of the JAX package (its
``_native`` extensions included); a static scan of every port source,
``chip_smoke.py`` and its rehearsal script (``replay/`` and the
``cluster/`` copy among them) finds no import of either, even inside a
function; and the port's device policy is explicit (CUDA unless the CPU
is asked for; no silent fallback)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from bayesian_consensus_engine_tpu_torch import TensorReliabilityStore
from bayesian_consensus_engine_tpu_torch.utils import device as device_policy

_ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.path.insert(0, {root!r})

import bayesian_consensus_engine_tpu_torch as port
from bayesian_consensus_engine_tpu_torch import convert
from bayesian_consensus_engine_tpu_torch import infer
from bayesian_consensus_engine_tpu_torch.analytics import bands, graph
from bayesian_consensus_engine_tpu_torch.infer import blocks as infer_blocks, bp
from bayesian_consensus_engine_tpu_torch.ops import (
    bp_kernel, collectives, cuda_build, fma, onepass_kernel, partials_kernel,
    propagate, tiebreak, uncertainty,
)
from bayesian_consensus_engine_tpu_torch.parallel import (
    compact, distributed, mesh, ring, sharded,
)
from bayesian_consensus_engine_tpu_torch.infer import partition
from bayesian_consensus_engine_tpu_torch.core import batch, engine, validate
from bayesian_consensus_engine_tpu_torch.native import build
from bayesian_consensus_engine_tpu_torch.ops import consensus
from bayesian_consensus_engine_tpu_torch import models
from bayesian_consensus_engine_tpu_torch.state import journal, namespaced
from bayesian_consensus_engine_tpu_torch.obs import metrics, timeline, trace
from bayesian_consensus_engine_tpu_torch.obs import (
    export, fleet, health, ledger, slo,
)
from bayesian_consensus_engine_tpu_torch import obs, serve
from bayesian_consensus_engine_tpu_torch.serve import driver
from bayesian_consensus_engine_tpu_torch.utils import interning, profiling
from bayesian_consensus_engine_tpu_torch import cli, net
from bayesian_consensus_engine_tpu_torch.net import client, server, wire
from bayesian_consensus_engine_tpu_torch.serve import admission, coalesce
from bayesian_consensus_engine_tpu_torch import cluster, replay
from bayesian_consensus_engine_tpu_torch.cluster import (
    membership, rank, recover, soak,
)
from bayesian_consensus_engine_tpu_torch.replay import lab
import asyncio
import os
import tempfile
import torch

signals = [{{"sourceId": "b", "probability": 0.4}},
           {{"sourceId": "a", "probability": 0.9}}]
validate.validate_input_payload(
    {{"schemaVersion": "1.0.0", "marketId": "m", "signals": signals}})
scalar = engine.compute_consensus(signals)
batched = port.compute_consensus(signals, backend="torch", device="cpu",
                                 dtype=torch.float64)
assert batched == scalar, (batched, scalar)
market_store = models.MarketStore()
market_store.add_signal(models.MarketId("m"), signals[0])
with namespaced.NamespacedReliabilityStore(":memory:") as ns_store:
    ns_store.update_reliability("b", True, market_id="m")
    swept = market_store.compute_all_consensus(
        ns_store.backing_store, backend="torch", device="cpu")
assert abs(swept["m"]["consensus"] - 0.4) < 1e-6, swept

assert build.load("fastpack") is not None and build.load("internmap") is not None
assert isinstance(interning.make_pair_interner(), interning.NativePairInterner)

store = port.TensorReliabilityStore(device="cpu")
payloads = [
    ("m1", [{{"sourceId": "a", "probability": 0.9}},
            {{"sourceId": "b", "probability": 0.2}}]),
    ("m2", []),
]
result = port.settle_payloads(store, payloads, [True, False], steps=3,
                              now=20000.0)
assert len(result.consensus) == 2 and len(store.list_sources()) == 2

plan = port.build_settlement_plan(store, payloads)
with port.ShardedSettlementSession(store, plan) as session:
    _, tb, bands_out, prop = session.settle_with_analytics(
        [True, False], steps=2, now=20003.0,
    )
assert prop is None and len(tb.prediction) == 2 and len(bands_out.lo) == 2

market_graph = graph.MarketGraph.from_edges([("m1", "m2", 1.0), ("m2", "m1", 0.5)])
options = port.AnalyticsOptions(
    graph=market_graph, inference=infer.InferenceOptions(tol=1e-6, max_steps=4),
)
with port.ShardedSettlementSession(store, plan) as session:
    prop = session.settle_with_analytics(
        [True, False], steps=2, now=20006.0, analytics=options,
    )[3]
assert isinstance(prop, infer.PropagatedBeliefs) and len(prop.mean) == 2
assert 1 <= int(prop.iters_run) <= 4

cpu_mesh = mesh.make_mesh((1, 2), ["cpu", "cpu"])
with port.ShardedSettlementSession(store, plan, cpu_mesh) as session:
    _, tb, bands_out, _ = session.settle_with_analytics(
        [True, False], steps=2, now=20009.0,
    )
assert len(tb.prediction) == 2 and len(bands_out.lo) == 2

registry = metrics.MetricsRegistry()
metrics.set_metrics_registry(registry)
phases = timeline.PhaseTimeline()
with tempfile.TemporaryDirectory() as work, timeline.recording(phases):
    path = os.path.join(work, "j.jrnl")
    with journal.JournalWriter(path) as writer:
        assert store.flush_to_journal(writer, tag=0) == len(store)
        port.settle_payloads(store, payloads, [False, True], steps=1,
                             now=20012.0)
        handle = store.flush_to_journal_async(writer, tag=1)
        flush = store.flush_to_sqlite_async(os.path.join(work, "j.db"))
        assert handle.result() == 2 and flush.result() == 2
    replayed, tag = journal.replay_journal(path, device="cpu")
    assert tag == 1 and replayed.list_sources() == store.list_sources()
    assert replayed._pairs.ids() == store._pairs.ids()
    assert journal.compact_journal(path, device="cpu") == len(store)
metrics.set_metrics_registry(None)
assert registry.export()["counters"]["journal.epochs"] == 3
assert "journal_fsync" in phases.counts()
assert not trace.active_tracer().enabled

batches = [((["s0", "s1", "s2"], ["a", "b", "a"],
             [0.25 * (1 + b), 0.5, 0.75], [0, 2, 3, 3]),
            [True, False, True]) for b in range(2)]
stats = []
with tempfile.TemporaryDirectory() as work:
    stream_store = port.TensorReliabilityStore(device="cpu")
    path = os.path.join(work, "s.jrnl")
    results = list(port.settle_stream(
        stream_store, batches, steps=2, now=20100.0, columnar=True,
        mesh=mesh.make_mesh((1, 1), ["cpu"]), journal=path,
        trace=path + ".trace", reuse_plans=True, stats=stats,
        db_path=os.path.join(work, "s.db"),
    ))
    assert [s["session_adopt"] for s in stats] == ["start", "refresh"]
    again = port.TensorReliabilityStore(device="cpu")
    port.drive_trace(again, journal.read_trace(path + ".trace"),
                     mesh=mesh.make_mesh((1, 1), ["cpu"]))
    again.sync()
    stream_store.sync()
    assert again.list_sources() == stream_store.list_sources()
    swept = replay.replay_sweep(
        replay.load_trace(path), [replay.ReplayConfig(half_life_days=12.0)],
        device="cpu")
    assert swept.digest == recover.store_digest(stream_store)
    assert [lane.markets_settled for lane in swept.lanes] == [4, 4]
    view = membership.MeshView(epoch=0, hosts=(0, 1))
    band_store = port.TensorReliabilityStore(device="cpu")
    band_results = list(port.settle_stream(
        band_store, batches, steps=2, now=20150.0, columnar=True,
        mesh=view.degraded([0]).build_mesh(devices=["cpu"]), band=(0, 3),
        num_slots=4, journal=os.path.join(work, "b.jrnl"),
    ))
    assert len(band_results) == 2
    merged = cluster.replay_cluster_journals(
        [os.path.join(work, "b.jrnl")], device="cpu")
    assert merged.tags == (1,)
    assert recover.store_digest(merged.store) == recover.store_digest(band_store)
    assert cluster.adopt_journal(
        port.TensorReliabilityStore(device="cpu"), path)[0] == 1
    assert distributed.init_distributed()["process_count"] == 1
    assert distributed.make_hybrid_mesh(devices=["cpu"] * 2).shape["markets"] == 2
    assert soak.main.__module__ == soak.__name__
    assert rank.main.__module__ == rank.__name__
with port.ShardedSettlementSession(store, plan) as session:
    _, tb, bands_out, _ = session.settle_with_analytics(
        [True, False], steps=2, now=20020.0,
        analytics=port.AnalyticsOptions(tiebreak="sorted"),
    )
    program = bands.build_band_program(session._mesh)
    again_bands = program(session._probs_g, session._mask_g, session._state,
                          session._now0(20021.0))
assert len(tb.prediction) == 2 and len(again_bands.lo) == 2
assert profiling.device_memory_stats("cpu")["bytes_in_use"] == 0
live = metrics.MetricsRegistry()
live.counter("stream.batches").inc(2)
text = export.render_prometheus(live.export())
assert "bce_stream_batches" in text, text
view = fleet.merge_fleet([fleet.snapshot_host(0, 1, live)],
                         expected_hosts=[0, 1])
assert view["hosts_absent"] == [1], view
monitor = health.HealthMonitor(objective_goodput=0.99)
monitor.record("met")
assert monitor.verdict()["verdict"] == "healthy"
tracker = slo.SloTracker(1.0)
tracker.record_latency(0.5)
assert slo.goodput_from_counts(tracker.snapshot()["counts"]) == 1.0

async def front_door(work):
    service = serve.ConsensusService(
        port.TensorReliabilityStore(device="cpu"), now=20200.0,
        journal=os.path.join(work, "f.jrnl"), max_batch=2, max_delay_s=None,
        mesh=mesh.make_mesh((1, 1), ["cpu"]), analytics=True,
    )
    srv = await net.ConsensusServer(service).start()

    def call():
        with net.ConsensusClient(port=srv.port) as conn:
            return conn.submit_pipelined(
                [("m1", [("a", 0.8)], True), ("m2", [("b", 0.4)], False)])

    try:
        got = await asyncio.get_running_loop().run_in_executor(None, call)
    finally:
        await srv.close()
        await service.close()
    return got


with tempfile.TemporaryDirectory() as work:
    served = asyncio.run(front_door(work))
assert [r.market_id for r in served] == ["m1", "m2"], served
assert served[0].band_lo is not None
assert cli.build_parser().parse_args(["--device", "cpu", "serve"]).device == "cpu"

from bayesian_consensus_engine_tpu_torch import parallel as surface
from bayesian_consensus_engine_tpu_torch.state import checkpoint

block = surface.init_block_state(4, 2, device="cpu")
cycle_args = (torch.rand(4, 2), torch.ones(4, 2, dtype=torch.bool),
              torch.zeros(4, dtype=torch.bool))
cycled = surface.build_cycle(donate=False)(*cycle_args, block, 3.0)
assert cycled.consensus.shape == (4,)
slot_args = tuple(x.T.contiguous() for x in cycle_args[:2]) + cycle_args[2:]
slot_block = surface.MarketBlockState(*(x.T.contiguous() for x in block))
with tempfile.TemporaryDirectory() as work:
    traced = profiling.auto_trace(
        surface.build_cycle_loop(donate=False), work, every_n=1)
    looped, _ = traced(*slot_args, slot_block, 3.0, 2)
    assert any(name.endswith(profiling.TRACE_SUFFIX) for name in os.listdir(work))
    tied = surface.build_cycle_tiebreak_loop(donate=False)(
        *slot_args, slot_block, 3.0, 2)
    assert len(tied[2].prediction) == 4
    with checkpoint.CycleCheckpointer(os.path.join(work, "c")) as ckpt:
        ckpt.save(2, looped, meta={{"next_now": 5.0}})
        again, meta = ckpt.restore(like=looped)
    assert meta == {{"next_now": 5.0}} and torch.equal(again[0], looped[0])
    store.save_checkpoint(os.path.join(work, "s"))
    reloaded = port.TensorReliabilityStore.load_checkpoint(
        os.path.join(work, "s"), device="cpu")
    assert reloaded.list_sources() == store.list_sources()

PACKAGE = "bayesian_consensus_engine_tpu"
loaded = sorted(
    name for name in sys.modules
    if name == "jax" or name.startswith("jax.")
    or name == PACKAGE or name.startswith(PACKAGE + ".")
)
assert not loaded, loaded
assert any(name.startswith("bayesian_consensus_engine_tpu_torch")
           for name in sys.modules)
for name in ("fastpack", "internmap"):
    assert "bayesian_consensus_engine_tpu_torch._native." + name in sys.modules
print("PORT_STANDS_ALONE")
"""


JAX_PACKAGE = "bayesian_consensus_engine_tpu"


def forbidden_imports(source: str, filename: str = "<source>"):
    """Every import in *source* — at module level or inside a function,
    ``import``/``from`` statements and ``importlib.import_module`` /
    ``__import__`` calls with a literal name — of ``jax`` or of the JAX
    package (the exact-name test: a bare ``startswith`` would also match
    the port)."""

    def bad(name):
        return (name == "jax" or name.startswith("jax.")
                or name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + "."))

    found = []
    for node in ast.walk(ast.parse(source, filename)):
        names = []
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            func = node.func
            called = (func.attr if isinstance(func, ast.Attribute)
                      else getattr(func, "id", None))
            if called in ("import_module", "__import__"):
                names = [node.args[0].value]
        found += [(filename, node.lineno, name) for name in names if bad(name)]
    return found


def port_sources():
    return sorted((_ROOT / "bayesian_consensus_engine_tpu_torch").rglob(
        "*.py")) + [_ROOT / "chip_smoke.py",
                    _ROOT / "scripts" / "rehearse_chip_smoke.py"]


def test_no_port_source_imports_jax_even_lazily():
    """A static scan sees the imports a subprocess never loads: those
    inside functions that did not run."""
    sources = port_sources()
    assert len(sources) > 60
    found = []
    for path in sources:
        found += forbidden_imports(path.read_text(encoding="utf-8"),
                                   str(path.relative_to(_ROOT)))
    assert not found, found


@pytest.mark.parametrize("source, flagged", [
    ("import jax", ["jax"]),
    ("import jax.numpy as jnp", ["jax.numpy"]),
    ("def f():\n    from jax import lax", ["jax"]),
    ("def f():\n    from bayesian_consensus_engine_tpu.state import journal",
     ["bayesian_consensus_engine_tpu.state"]),
    ("from bayesian_consensus_engine_tpu import obs",
     ["bayesian_consensus_engine_tpu"]),
    ("import importlib\nimportlib.import_module('bayesian_consensus_engine_tpu.cli')",
     ["bayesian_consensus_engine_tpu.cli"]),
    ("__import__('jax')", ["jax"]),
    ("from bayesian_consensus_engine_tpu_torch import obs", []),
    ("import bayesian_consensus_engine_tpu_torch.serve", []),
    ("from . import wire\nimport jaxlike", []),
])
def test_import_scan_flags_exactly_the_jax_package(source, flagged):
    assert [name for _f, _l, name in forbidden_imports(source)] == flagged


@pytest.mark.parametrize("package", ["replay", "cluster"])
def test_replay_and_cluster_copies_are_scanned(package):
    """The replay lab and the ``cluster/`` tier (membership, recovery, the
    rank routine and the kill soak) are in the static scan and import nothing of JAX; the
    exact-name test tells their JAX package twins from them."""
    sources = [path for path in port_sources()
               if path.parent.name == package
               and path.parent.parent.name == "bayesian_consensus_engine_tpu_torch"]
    expected = {"replay": {"__init__.py", "lab.py"},
                "cluster": {"__init__.py", "membership.py", "rank.py",
                            "recover.py", "soak.py"}}
    assert {path.name for path in sources} == expected[package]
    for path in sources:
        assert not forbidden_imports(path.read_text(encoding="utf-8"))
    twin = f"bayesian_consensus_engine_tpu.{package}"
    assert [name for _f, _l, name in forbidden_imports(
        f"def f():\n    from {twin} import x\n"
        f"from bayesian_consensus_engine_tpu_torch.{package} import y")] == [twin]


def test_port_imports_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "BCE_NO_NATIVE"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(_ROOT))],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PORT_STANDS_ALONE" in proc.stdout


_OPS_PROBE = """
import importlib
import pkgutil
import sys
import types

PORT = "bayesian_consensus_engine_tpu_torch"
root = {root!r}
sys.path.insert(0, root)
# The package without its __init__, which imports every layer: only what
# the ops modules import themselves gets loaded.
package = types.ModuleType(PORT)
package.__path__ = [root + "/" + PORT]
sys.modules[PORT] = package
names = [info.name for info in pkgutil.iter_modules([root + "/" + PORT + "/ops"])]
for name in names:
    importlib.import_module(PORT + ".ops." + name)
assert len(names) >= 14, names
LAYER = PORT + ".parallel"
loaded = sorted(name for name in sys.modules
                if name == LAYER or name.startswith(LAYER + "."))
assert not loaded, loaded
print("OPS_BELOW_PARALLEL")
"""


def test_ops_layer_imports_nothing_of_parallel():
    """No module under ``ops/`` imports ``parallel/`` (the collectives
    live in ``ops/collectives.py``): in a subprocess that loads every ops
    module and nothing the package's ``__init__`` would, no
    ``parallel`` module is loaded (the exact-name test), and a static scan
    finds no such import, lazy ones included."""
    proc = subprocess.run(
        [sys.executable, "-c", _OPS_PROBE.format(root=str(_ROOT))],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OPS_BELOW_PARALLEL" in proc.stdout
    layer = "bayesian_consensus_engine_tpu_torch.parallel"
    found = []
    for path in sorted((_ROOT / "bayesian_consensus_engine_tpu_torch" / "ops")
                       .glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [("." * node.level) + (node.module or "")]
            else:
                continue
            found += [(path.name, name) for name in names
                      if name == layer or name.startswith(layer + ".")
                      or name.lstrip(".").split(".")[0] == "parallel"
                      and name.startswith(".")]
    assert not found, found
    assert not (_ROOT / "bayesian_consensus_engine_tpu_torch" / "parallel"
                / "collectives.py").exists()


def test_store_without_cuda_raises_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorReliabilityStore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorReliabilityStore(device="cuda")
    store = TensorReliabilityStore(device="cpu")
    assert store.device == torch.device("cpu")


def test_journal_recovery_without_cuda_raises_unless_cpu_asked(
        monkeypatch, tmp_path):
    from bayesian_consensus_engine_tpu_torch.state import (
        JournalWriter,
        compact_journal,
        replay_journal,
    )

    path = tmp_path / "j.jrnl"
    store = TensorReliabilityStore(device="cpu")
    store.batch_update_reliability([("a", "m"), ("b", "m")], [True, False])
    with JournalWriter(path) as writer:
        store.flush_to_journal(writer, tag=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for recover in (replay_journal, compact_journal):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            recover(path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            recover(path, device="cuda")
    replayed, tag = replay_journal(path, device="cpu")
    assert tag == 3 and replayed.device == torch.device("cpu")
    assert replayed.list_sources() == store.list_sources()
    assert compact_journal(path, device="cpu") == 2


def test_stream_without_cuda_raises_unless_cpu_asked(monkeypatch):
    """The streamed service runs on the store's device: a CUDA default
    raises without the card, as the store does, and the device memory
    counters take the CPU only when asked for it."""
    from bayesian_consensus_engine_tpu_torch import settle_stream
    from bayesian_consensus_engine_tpu_torch.parallel.mesh import make_mesh
    from bayesian_consensus_engine_tpu_torch.utils.profiling import (
        device_memory_stats,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = ([("m", [{"sourceId": "a", "probability": 0.7}])], [True])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_memory_stats()
    store = TensorReliabilityStore(device="cpu")
    result, = settle_stream(store, [batch], now=20000.0,
                            mesh=make_mesh((1, 1), ["cpu"]))
    assert result.consensus.shape == (1,)
    assert device_memory_stats("cpu") == {
        "device": "cpu", "bytes_in_use": 0, "bytes_limit": None,
        "peak_bytes_in_use": 0, "utilisation": None,
    }


def test_array_backend_without_cuda_raises_unless_cpu_asked(monkeypatch):
    from bayesian_consensus_engine_tpu_torch import compute_consensus

    signals = [{"sourceId": "a", "probability": 0.6}]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("torch", "jax", "tpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compute_consensus(signals, backend=backend)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compute_consensus(signals, backend=backend, device="cuda")
    doc = compute_consensus(signals, backend="torch", device="cpu")
    assert doc["consensus"] == pytest.approx(0.6, rel=1e-6)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32, "float32"])
def test_unsupported_dtypes_raise(dtype):
    with pytest.raises(ValueError, match="float32 or"):
        device_policy.resolve_dtype(dtype)
    assert device_policy.resolve_dtype(None) is torch.float32
