"""Drive the PyTorch port's settlement main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``device``       the card (``nvidia-smi`` name and power limit).
2. ``build``        compile the settle kernel from the package's ``.cu``.
3. ``kernel_check`` ``settle_cycles`` against its plain torch version on
                    the card, float32 and float64, K in {1, 5, 16, 40}, a
                    ragged M, steps in {0, 1, 2, 20}, with pads, cold slots,
                    empty markets and stamps later than ``now``: state and
                    ``rel_touched`` bit-equal, consensus within tolerance.
4. ``main_path``    1,000,000 markets, Poisson(3)+1 signals each from a
                    10,000-source universe (seed 7), through
                    ``build_settlement_plan_columnar`` on a CUDA store, two
                    chained 20-step ``settle`` calls, the consensus fetch,
                    ``store.sync()`` and ``flush_to_sqlite``. The kernel
                    launch count must rise by exactly one per settle, each
                    settle's consensus must match the plain version on the
                    inputs that settle was given, the first settle's state
                    must be bit-equal to the plain version's, and the flush
                    must write every row.
5. ``kernels``      the kernel's launches, error, time (CUDA events, median
                    after warm-up), plain-version time and byte bound, on
                    the chained settle's inputs (every row exists: the
                    steady state) and, under ``cold``, on the first
                    settle's (no row exists yet).

Then the ``nvidia-smi`` line, and last ``{"ok": true, "device": ...}``.
Any failure exits non-zero without that line; so does a machine without
CUDA and a directory without the package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM device-memory rate (NVIDIA data sheet), for the byte bound.
HBM_BYTES_PER_S = 3.35e12
NOW = 20000.25  # epoch-days
MARKETS, MEAN_SIGNALS, SOURCES, SEED, STEPS = 1_000_000, 4, 10_000, 7, 20
# Consensus tolerance (exp2 and the K-sum order differ); state is bit-equal.
TOL = {np.dtype(np.float32): dict(rtol=1e-5, atol=1e-6),
       np.dtype(np.float64): dict(rtol=1e-12, atol=0.0)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.dtype != want.dtype or not np.array_equal(got, want):
        bad = int(np.sum(got != want)) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: not bit-equal ({bad} elements differ)")


def check_consensus(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{what}: NaN positions differ")
    np.testing.assert_allclose(
        got, want, equal_nan=True, err_msg=what, **TOL[got.dtype]
    )
    finite = ~np.isnan(got)
    return float(np.max(np.abs(got[finite] - want[finite]), initial=0.0))


def random_case(rng, num_slots, num_markets, np_dtype):
    """A plan block over a flat state: distinct shuffled rows per masked
    slot, pads (row -1), empty markets, cold rows, stale and future stamps."""
    shape = (num_slots, num_markets)
    mask = rng.random(shape) < 0.7
    mask[:, :: 17] = False  # empty markets
    num_touched = int(mask.sum())
    capacity = num_touched + 101
    rows = np.full(shape, -1, dtype=np.int32)
    rows[mask] = rng.permutation(capacity)[:num_touched]
    return dict(
        rel=rng.uniform(0.0, 1.0, capacity).astype(np_dtype),
        conf=rng.uniform(0.0, 1.0, capacity).astype(np_dtype),
        # 0 = never stamped; 512.5 lies after now0 (a backdated settle).
        days=rng.choice([0.0, 3.0, 35.0, 499.5, 512.5], capacity).astype(np_dtype),
        exists=rng.random(capacity) < 0.6,
        rows=rows,
        probs=rng.random(shape).astype(np_dtype),
        mask=mask,
        outcome=rng.random(num_markets) < 0.5,
        now0=500.0,
    )


def kernel_args(case, dtype, steps, settle_kernel):
    touched_rows, offsets = settle_kernel.touched_layout(case["rows"], case["mask"])
    cuda = torch.device("cuda")

    def t(x, dt=None):
        return torch.tensor(x, dtype=dt, device=cuda)

    return (
        t(case["rel"], dtype), t(case["conf"], dtype), t(case["days"], dtype),
        t(case["exists"]), t(case["rows"]), t(case["probs"], dtype),
        t(case["mask"]), t(case["outcome"]), t(offsets), len(touched_rows),
        float(np.dtype(case["rel"].dtype).type(case["now0"])), steps,
    )


def compare_kernel(args, settle_kernel, what):
    """Run the plain version and the kernel (on clones) on the same inputs."""
    want = settle_kernel.settle_cycles_reference(*args)
    clones = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    got = settle_kernel.settle_cycles(*clones)
    torch.cuda.synchronize()
    for field in ("reliability", "confidence", "updated_days", "exists",
                  "rel_touched"):
        check_equal(getattr(got, field), getattr(want, field), f"{what} {field}")
    return check_consensus(got.consensus, want.consensus, f"{what} consensus")


def time_cuda(fn, prepare, warmup: int, runs: int) -> float:
    """Median milliseconds of ``fn(prepare())`` by CUDA events; the
    preparation (fresh input clones) is outside the timed window."""
    for _ in range(warmup):
        fn(prepare())
    times = []
    for _ in range(runs):
        inputs = prepare()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(inputs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from bayesian_consensus_engine_tpu_torch import pipeline
    from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes
    from bayesian_consensus_engine_tpu_torch.ops import settle_kernel
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    start = time.perf_counter()
    library, log = settle_kernel.build()
    emit("build", seconds=time.perf_counter() - start,
         library=os.path.relpath(library),
         ptxas=[line for line in log.splitlines() if "registers" in line])

    # 3. kernel_check
    rng = np.random.default_rng(0)
    worst = {}
    cases = 0
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        for num_slots in (1, 5, 16, 40):
            case = random_case(rng, num_slots, 1037, np_dtype)
            for steps in (0, 1, 2, 20):
                err = compare_kernel(
                    kernel_args(case, dtype, steps, settle_kernel),
                    settle_kernel, f"{dtype} K={num_slots} steps={steps}",
                )
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
                cases += 1
    emit("kernel_check", cases=cases, markets=1037,
         max_abs_consensus_err=worst)

    # 4. main_path
    seconds = {}
    start = time.perf_counter()
    data_rng = np.random.default_rng(SEED)
    counts = data_rng.poisson(MEAN_SIGNALS - 1, MARKETS) + 1
    codes = data_rng.integers(0, SOURCES, counts.sum())
    probs = data_rng.random(counts.sum())
    offsets = np.concatenate([[0], np.cumsum(counts)])
    outcomes = data_rng.random(MARKETS) < 0.5
    market_keys = [f"market-{m}" for m in range(MARKETS)]
    sources = SourceCodes(codes, [f"src-{i}" for i in range(SOURCES)])
    seconds["data"] = time.perf_counter() - start

    start = time.perf_counter()
    store = TensorReliabilityStore()
    plan = pipeline.build_settlement_plan_columnar(
        store, market_keys, sources, probs, offsets
    )
    seconds["plan"] = time.perf_counter() - start
    dtype = torch.float32
    # The first settle's inputs, kept for the plain-version check: a copy
    # of the store's cold state, built outside the store's device cache so
    # that the first settle pays its own host-to-device export, as a
    # user's first settle does.
    cold, cold_epoch0 = store._build_device_export(len(store), dtype)
    torch.cuda.synchronize()

    settle_kernel.LAUNCHES = 0
    start = time.perf_counter()
    first = pipeline.settle(store, plan, outcomes, steps=STEPS, now=NOW)
    first.fence()
    seconds["settle_1"] = time.perf_counter() - start
    # The second settle's inputs: the settled state the store hands
    # forward to the chained settle, copied between the timed windows.
    pending, warm_epoch0 = store._pending
    warm = [x.clone() for x in pending]
    torch.cuda.synchronize()
    start = time.perf_counter()
    second = pipeline.settle(store, plan, outcomes, steps=STEPS, now=NOW + STEPS)
    second.fence()
    seconds["settle_2"] = time.perf_counter() - start
    start = time.perf_counter()
    consensus_2 = second.consensus
    consensus_1 = first.consensus
    seconds["fetch"] = time.perf_counter() - start
    start = time.perf_counter()
    store.sync()
    seconds["sync"] = time.perf_counter() - start
    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        flushed = store.flush_to_sqlite(os.path.join(tmp, "settled.db"))
        seconds["flush"] = time.perf_counter() - start
    launches = settle_kernel.LAUNCHES

    if launches != 2:
        raise AssertionError(f"{launches} kernel launches for 2 settles")
    if flushed != len(store):
        raise AssertionError(f"flushed {flushed} rows of {len(store)}")
    for values in (consensus_1, consensus_2):
        if values.shape != (MARKETS,) or not np.all(np.isfinite(values)):
            raise AssertionError("consensus is not finite of shape (M,)")
    if warm_epoch0 != cold_epoch0:
        raise AssertionError(f"epoch moved: {cold_epoch0} -> {warm_epoch0}")
    touched_rows, touched_offsets = settle_kernel.touched_layout(
        plan.slot_rows, plan.mask
    )
    block = (
        torch.tensor(plan.slot_rows, device="cuda"),
        torch.tensor(plan.probs, dtype=dtype, device="cuda"),
        torch.tensor(plan.mask, device="cuda"),
        torch.tensor(outcomes, device="cuda"),
        torch.tensor(touched_offsets, device="cuda"),
        len(touched_rows),
    )
    cold_args = (*cold, *block, float(np.float32(NOW - cold_epoch0)), STEPS)
    warm_args = (
        *warm, *block, float(np.float32(NOW + STEPS - warm_epoch0)), STEPS
    )
    # Each settle against the plain version on the inputs it was given; the
    # first settle's whole state (what the second one consumed) bit-equal.
    plain_1 = settle_kernel.settle_cycles_reference(*cold_args)
    used = len(store)
    for got, want, what in zip(warm, plain_1[:4], ("reliability", "confidence",
                                                  "updated_days", "exists")):
        check_equal(got[:used], want[:used], f"main path settle 1 {what}")
    main_err = check_consensus(
        torch.from_numpy(consensus_1), plain_1.consensus, "main path consensus 1"
    )
    del plain_1
    plain_2 = settle_kernel.settle_cycles_reference(*warm_args)
    main_err = max(main_err, check_consensus(
        torch.from_numpy(consensus_2), plain_2.consensus, "main path consensus 2"
    ))
    del plain_2
    emit("main_path", markets=MARKETS, pairs=len(store),
         slots=int(plan.num_slots), steps=STEPS, launches=launches,
         flushed_rows=flushed, max_abs_consensus_err=main_err,
         seconds=seconds, cut=None,
         peak_device_bytes=torch.cuda.max_memory_allocated())

    # 5. kernels: the kernel and its plain version timed on both settles'
    # inputs (fresh clones each run, so every run does the same work). The
    # chained (warm) settle, where every row exists and is read, is the
    # steady state and the headline; the first (cold) settle reads no
    # stored state and turns every row on.
    num_touched = len(touched_rows)
    touched_d = torch.tensor(touched_rows, dtype=torch.int64, device="cuda")
    timings = {}
    err = 0.0
    for name, args in (("cold", cold_args), ("warm", warm_args)):
        err = max(err, compare_kernel(args, settle_kernel, f"main-path {name}"))

        def prepare(args=args):
            return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]

        kernel_ms = time_cuda(
            lambda a: settle_kernel.settle_cycles(*a), prepare, warmup=3, runs=21
        )
        plain_ms = time_cuda(
            lambda a: settle_kernel.settle_cycles_reference(*a), prepare,
            warmup=1, runs=5,
        )
        num_existing = int(args[3][touched_d].sum())
        bound = settle_kernel.bound_bytes(
            plan.num_slots, MARKETS, num_touched, num_existing, STEPS, 4
        )
        timings[name] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, bound_bytes=bound,
            bound_ms=bound / HBM_BYTES_PER_S * 1e3, existing_rows=num_existing,
        )
    warm_t, cold_t = timings["warm"], timings["cold"]
    entry = {
        "name": "settle_cycles",
        "route": "cuda",
        "source": "bayesian_consensus_engine_tpu_torch/csrc/settle_cycles.cu",
        "replaces": "bayesian_consensus_engine_tpu/ops/pallas_cycle.py:95",
        "launches": launches,
        "max_abs_err": err,
        # "ms" is the harness's key and "kernel_ms" the same time under
        # the name the port's records use: the chained settle's.
        "ms": warm_t["kernel_ms"],
        "kernel_ms": warm_t["kernel_ms"],
        "plain_ms": warm_t["plain_ms"],
        "bound_ms": warm_t["bound_ms"],
        "bound_by": "bytes",
        "bound_bytes": warm_t["bound_bytes"],
        "library_ms": None,
        "cold": {key: cold_t[key] for key in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_bytes")},
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
