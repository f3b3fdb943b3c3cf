"""Rehearse chip_smoke.py's host phases on the CPU, at a small size.

Usage: python scripts/rehearse_chip_smoke.py [MARKETS] [DUMP_MARKETS] [DIVISOR]

Runs chip_smoke's ``native``, ``main_path``, ``host_routes`` and
``delta_check`` phases (7 to 10), then its ``journal`` phase (16) on the
main path's store, its ``stream`` (17), ``serve`` (18) and
``analytics_rest`` (19) phases on the main path's data, its ``replay``
phase (20) on the stream's trace and its ``shards`` phase (21) on the
main path's data and graph, and its ``cluster`` phase (22: two rank
processes on the CPU, then the kill soak with ``--device cpu``) on the
main path's data, and its ``surface`` phase (23: the preempted child
is this script with ``--surface-child``), on CPU stores, from the
repository root. The
script's ``main()`` is cut to its import block and those phases,
``"cuda"`` becomes ``"cpu"``, stores are built with ``device="cpu"``, the
``serve`` phase's CLI runs with ``--device cpu``, each call of the
settle, lane, one-pass, partials and sweep kernels' wrappers is counted
where the card would launch it (in the CLI's subprocess too), the timed
windows run on the host clock, and MARKETS (default 4,096), DUMP_MARKETS
(default 1,000), the parity stores' 20,000 markets (at most MARKETS), the
ring and compact loops' shapes (512 x 400 slots, 6 steps; 1,024 x 300,
4 steps), the host routes' cut (250,000 markets, at most MARKETS),
the journal phase's delta (100,000 markets, at most half of MARKETS) and
the ``serve`` phase's request counts divided by DIVISOR (default 16)
replace the full-size constants (phase 22 holds two bands of the batch bit
for bit against the whole axis, which on the CPU needs each band's slot
block to be a whole number of ``exp2``'s vector widths: keep MARKETS a
multiple of 64, as the default is). The kernels take their plain torch
versions, so no figure printed here is a device figure: the rehearsal
finds wrong paths,
shapes and control flow before a chip call, and shows the host routes',
the journal tier's and the stream's relative cost on the machine it runs
on.
"""

from __future__ import annotations

import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SHIM = """
torch.cuda.synchronize = lambda *a, **k: None
torch.cuda.max_memory_allocated = lambda *a, **k: 0
from bayesian_consensus_engine_tpu_torch import pipeline as _pipeline
from bayesian_consensus_engine_tpu_torch.ops import settle_kernel as _settle_kernel
_plain_settle = _pipeline.settle_cycles


def _counted_settle(*args, **kwargs):
    _settle_kernel.LAUNCHES += 1
    return _plain_settle(*args, **kwargs)


_pipeline.settle_cycles = _counted_settle
from bayesian_consensus_engine_tpu_torch.ops import onepass_kernel as _onepass_kernel
from bayesian_consensus_engine_tpu_torch.parallel import sharded as _sharded
_plain_onepass = _sharded.onepass_settle


def _counted_onepass(*args, **kwargs):
    _onepass_kernel.LAUNCHES += 1
    return _plain_onepass(*args, **kwargs)


_sharded.onepass_settle = _counted_onepass
from bayesian_consensus_engine_tpu_torch.analytics import bands as _bands
from bayesian_consensus_engine_tpu_torch.ops import partials_kernel as _partials_kernel
_plain_partials = _sharded.onepass_partials


def _counted_partials(*args, **kwargs):
    _partials_kernel.LAUNCHES += 1
    return _plain_partials(*args, **kwargs)


_sharded.onepass_partials = _counted_partials
_bands.onepass_partials = _counted_partials
_plain_lanes = _sharded.settle_cycles_lanes


def _counted_lanes(*args, **kwargs):
    _settle_kernel.LANE_LAUNCHES += 1
    return _plain_lanes(*args, **kwargs)


_sharded.settle_cycles_lanes = _counted_lanes
from bayesian_consensus_engine_tpu_torch.infer import partition as _partition
from bayesian_consensus_engine_tpu_torch.ops import bp_kernel as _bp_kernel
_plain_bp = _bp_kernel.bp_sweep


def _counted_bp(*args, **kwargs):
    _bp_kernel.LAUNCHES += _bp_kernel.launches_per_call(kwargs["max_steps"])
    return _plain_bp(*args, **kwargs)


_sharded.bp_sweep = _counted_bp
_partition.bp_sweep = _counted_bp
torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
torch.cuda.memory_allocated = lambda *a, **k: 0
"""

# CUDA events and the device's sleep do not exist on the CPU: the
# rehearsal times its windows on the host clock.
HOST_TIMING = """

def time_window(fn, prepare, warmup, runs):
    for _ in range(warmup):
        fn(prepare())
    inputs = [prepare() for _ in range(runs)]
    start = time.perf_counter()
    for args in inputs:
        fn(args)
    return (time.perf_counter() - start) * 1e3 / runs, "host"


def time_cuda(fn, prepare, warmup, runs):
    return time_window(fn, prepare, warmup, runs)[0]

"""


# Phase 22's rank processes run the rank module behind this shim, which
# counts the one-pass and partials wrappers where the card would launch
# them.
RANK_SHIM = """
import runpy
from bayesian_consensus_engine_tpu_torch.ops import onepass_kernel, partials_kernel
from bayesian_consensus_engine_tpu_torch.parallel import sharded as _sharded
_plain_onepass = _sharded.onepass_settle
_plain_partials = _sharded.onepass_partials


def _counted_onepass(*args, **kwargs):
    onepass_kernel.LAUNCHES += 1
    return _plain_onepass(*args, **kwargs)


def _counted_partials(*args, **kwargs):
    partials_kernel.LAUNCHES += 1
    return _plain_partials(*args, **kwargs)


_sharded.onepass_settle = _counted_onepass
_sharded.onepass_partials = _counted_partials
runpy.run_module("bayesian_consensus_engine_tpu_torch.cluster.rank",
                 run_name="__main__")
"""


CHILD_SHIM = """
from bayesian_consensus_engine_tpu_torch.ops import settle_kernel
from bayesian_consensus_engine_tpu_torch import pipeline as _pipeline
_plain_settle = _pipeline.settle_cycles


def _counted_settle(*args, **kwargs):
    settle_kernel.LAUNCHES += 1
    return _plain_settle(*args, **kwargs)


_pipeline.settle_cycles = _counted_settle
"""


def rehearsal_source(markets: int, dump_markets: int, divisor: int = 16) -> str:
    """chip_smoke.py cut to its host phases, on the CPU."""
    source = (ROOT / "chip_smoke.py").read_text()
    head, body = source.split("def main() -> int:\n", 1)
    imports = body[: body.index("    # 1. device")]
    phases = body[body.index("    # 7. native"): body.index("    # 11. analytics_path")]
    journal = (
        '    smi = "rehearsal on the CPU"\n'
        "    journal_phase(smi, store, market_keys, codes, probs, offsets,\n"
        "                  outcomes, main_db, work.name)\n"
        "    del store\n"
        "    *_launches, trace, digest = stream_phase(\n"
        "        smi, market_keys, codes, probs, offsets, outcomes)\n"
        "    serve_phase(smi, market_keys, codes, probs, offsets, outcomes)\n"
        "    analytics_rest_phase(smi, market_keys, codes, probs, offsets,\n"
        "                         outcomes)\n"
        "    print(json.dumps(replay_phase(\n"
        "        smi, trace, digest, {'settle_cycles.cu': {}})[0]))\n"
        "    blocks, edges = inference_graph(market_keys, SEED + 1, infer)\n"
        "    shards_phase(smi, market_keys, codes, probs, offsets, outcomes,\n"
        "                 blocks.to_graph(extra_edges=edges))\n"
        "    cluster_phase(smi, market_keys, codes, probs, offsets, outcomes,\n"
        "                  counts)\n"
        "    surface_phase(smi, market_keys, codes, probs, offsets, outcomes)\n"
    )
    head = re.sub(r"MARKETS, MEAN_SIGNALS, SOURCES, SEED, STEPS = 1_000_000",
                  f"MARKETS, MEAN_SIGNALS, SOURCES, SEED, STEPS = {markets}", head)
    head = head.replace("DUMP_MARKETS, REPLACED, REDRAWN = 50_000",
                        f"DUMP_MARKETS, REPLACED, REDRAWN = {dump_markets}")
    head = head.replace(
        "JOURNAL_MARKETS, JOURNAL_SMALL_MARKETS = 100_000",
        f"JOURNAL_MARKETS, JOURNAL_SMALL_MARKETS = {min(100_000, markets // 2)}")
    head = head.replace("PARITY_MARKETS = 20_000",
                        f"PARITY_MARKETS = {min(20_000, markets)}")
    head = head.replace(
        "LARGE_K_MARKETS, LARGE_K_SLOTS, LARGE_K_STEPS = 16_384, 10_000, 50",
        "LARGE_K_MARKETS, LARGE_K_SLOTS, LARGE_K_STEPS = 512, 400, 6")
    head = head.replace(
        "NORTH_STAR_MARKETS, NORTH_STAR_SLOTS, NORTH_STAR_STEPS = "
        "125_056, 10_000, 40",
        "NORTH_STAR_MARKETS, NORTH_STAR_SLOTS, NORTH_STAR_STEPS = 1024, 300, 4")
    head = head.replace("HOST_ROUTE_MARKETS = 250_000",
                        f"HOST_ROUTE_MARKETS = {min(250_000, markets)}")
    head = head.replace(
        "SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_CHUNK = 16, 1024, 256",
        f"SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_CHUNK = 16, "
        f"{max(1024 // divisor, 16)}, 256")
    head = head.replace(
        "OVERLOAD_CLIENTS, OVERLOAD_BURST, OVERLOAD_BUDGET = 8, 8192, 64",
        f"OVERLOAD_CLIENTS, OVERLOAD_BURST, OVERLOAD_BUDGET = 8, "
        f"{max(8192 // divisor, 256)}, 64")
    head = head.replace(
        "CLI_REQUESTS, CLI_CLIENTS, CLI_DURATION = 8192, 4, 8.0",
        f"CLI_REQUESTS, CLI_CLIENTS, CLI_DURATION = "
        f"{max(8192 // divisor // 1024, 1) * 1024}, 4, 8.0")
    head = head.replace('CLI_DEVICE = None', 'CLI_DEVICE = "cpu"')
    head = head.replace(
        "SURFACE_CHILD = (os.path.abspath(__file__), SURFACE_CHILD_FLAG)",
        f"SURFACE_CHILD = ({str(ROOT / 'scripts' / 'rehearse_chip_smoke.py')!r}, "
        f"SURFACE_CHILD_FLAG, '{markets}', '{dump_markets}', '{divisor}')", 1)
    head = head.replace(
        'RANK_COMMAND = ("-m", "bayesian_consensus_engine_tpu_torch.cluster.rank")',
        f"RANK_COMMAND = ('-c', {RANK_SHIM!r})", 1)
    head = head.replace(
        "from bayesian_consensus_engine_tpu_torch.ops import settle_kernel\n"
        "atexit",
        CHILD_SHIM.strip() + "\natexit", 1)
    head = head.replace("import numpy as np\nimport torch\n",
                        "import numpy as np\nimport torch\n" + SHIM, 1)
    imports = imports.replace("if not torch.cuda.is_available():", "if False:")
    text = (head + HOST_TIMING + "def main() -> int:\n" + imports + phases
            + journal + "    return 0\n")
    return text.replace('"cuda"', '"cpu"').replace(
        "TensorReliabilityStore()", 'TensorReliabilityStore(device="cpu")'
    ).replace("load_checkpoint(snapshot)", 'load_checkpoint(snapshot, device="cpu")')


def main() -> int:
    args = sys.argv[1:]
    child = bool(args) and args[0] == "--surface-child"
    if child:  # phase 23's preempted child: the sizes, then its work directory
        args = args[1:]
    markets = int(args[0]) if len(args) > 0 else 4_096
    dump_markets = int(args[1]) if len(args) > 1 else 1_000
    divisor = int(args[2]) if len(args) > 2 else 16
    sys.path.insert(0, str(ROOT))
    namespace = {"__name__": "chip_smoke_rehearsal",
                 "__file__": str(ROOT / "chip_smoke.py")}
    exec(compile(rehearsal_source(markets, dump_markets, divisor),  # noqa: S102
                 "chip_smoke_rehearsal", "exec"), namespace)
    if child:
        return namespace["surface_child"](args[3])
    return namespace["main"]()


if __name__ == "__main__":
    sys.exit(main())
