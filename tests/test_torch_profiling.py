"""Profiling hooks of the port (``utils/profiling.py``): annotation
pass-through, the decorator, capture of every N-th call by ``auto_trace``
into Chrome traces that hold the ``bce.*`` labels of the kernel wrappers
and of the eager cycle math, and results that are the unwrapped call's.
On the CPU the wrappers run their kernels' plain versions, under the same
labels."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bayesian_consensus_engine_tpu_torch import parallel as tpar
from bayesian_consensus_engine_tpu_torch.utils.profiling import (
    TRACE_SUFFIX,
    annotate,
    auto_trace,
    device_memory_stats,
    trace,
)


def cycle_args(m=8, k=4, seed=0):
    rng = np.random.default_rng(seed)
    return (
        torch.from_numpy(rng.random((m, k)).astype(np.float32)),
        torch.from_numpy(rng.random((m, k)) < 0.9),
        torch.from_numpy(rng.random(m) < 0.5),
        tpar.init_block_state(m, k, device="cpu"),
        1.0,
    )


def labels(path) -> set:
    """The names of every event in a Chrome trace file."""
    with open(path, encoding="utf-8") as handle:
        events = json.load(handle)["traceEvents"]
    return {event.get("name") for event in events}


def traces(log_dir) -> list:
    return sorted(log_dir.glob("*" + TRACE_SUFFIX)) if log_dir.exists() else []


def test_annotation_only_passthrough():
    with trace("unit-test-block"):
        out = torch.arange(4.0).sum()
    assert float(out) == 6.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace("unit-test-block"):
            torch.arange(4.0).sum()
    assert "unit-test-block" in {e.key for e in prof.key_averages()}


def test_annotate_decorator():
    @annotate("unit-test-fn")
    def double(x):
        """Doubles."""
        return x * 2

    assert float(double(torch.tensor(3.0))) == 6.0
    assert double.__name__ == "double" and double.__doc__ == "Doubles."
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        double(torch.tensor(1.0))
    assert "unit-test-fn" in {e.key for e in prof.key_averages()}


def test_trace_with_a_log_dir_writes_one_chrome_trace(tmp_path):
    with trace("block", tmp_path / "t"):
        torch.arange(4.0).sum()
    (path,) = traces(tmp_path / "t")
    assert path.name.startswith("block.")
    assert "block" in labels(path)


def test_device_memory_stats_shape_on_the_cpu():
    stats = device_memory_stats("cpu")
    assert stats == {"device": "cpu", "bytes_in_use": 0, "bytes_limit": None,
                     "peak_bytes_in_use": 0, "utilisation": None}


def test_nth_call_captures_profile_with_the_cycle_labels(tmp_path):
    log_dir = tmp_path / "bce-trace"
    cycle = auto_trace(tpar.build_cycle(donate=False), str(log_dir), every_n=3)
    plain = tpar.build_cycle(donate=False)(*cycle_args())
    results = []
    for call in range(1, 4):
        results.append(cycle(*cycle_args()))
        assert len(traces(log_dir)) == (call == 3)
    # Pass-through: every call returns the unwrapped call's result.
    for result in results:
        for got, want in zip(result[1:], plain[1:]):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        for got, want in zip(result.state, plain.state):
            assert torch.equal(got, want)
    (path,) = traces(log_dir)
    names = labels(path)
    assert {"settlement", "bce.onepass_partials", "bce.read_decay",
            "bce.consensus_local_sums", "bce.outcome_update"} <= names


def test_loop_capture_holds_the_one_pass_label(tmp_path):
    log_dir = tmp_path / "loop"
    probs, mask, outcome, state, now = cycle_args(seed=3)
    args = (probs.T.contiguous(), mask.T.contiguous(), outcome,
            tpar.MarketBlockState(*(x.T.contiguous() for x in state)), now, 4)
    loop = auto_trace(tpar.build_cycle_loop(donate=False), log_dir, every_n=2,
                      label="loop")
    outs = [loop(*args) for _ in range(4)]
    want = tpar.build_cycle_loop(donate=False)(*args)
    for got in outs:
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    paths = traces(log_dir)
    assert len(paths) == 2
    for path in paths:
        assert {"loop", "bce.onepass_settle", "bce.read_decay",
                "bce.consensus_reduce", "bce.outcome_update"} <= labels(path)


def test_untraced_calls_write_nothing(tmp_path):
    log_dir = tmp_path / "bce-trace"
    cycle = auto_trace(tpar.build_cycle(donate=False), str(log_dir), every_n=5)
    for _ in range(3):
        cycle(*cycle_args())
    assert not log_dir.exists() or not any(log_dir.rglob("*"))
    with pytest.raises(ValueError, match="every_n"):
        auto_trace(cycle, str(log_dir), every_n=0)
