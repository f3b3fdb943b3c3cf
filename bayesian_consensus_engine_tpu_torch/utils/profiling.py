"""Profiling hooks and device memory counters — the port of the JAX
package's ``utils/profiling.py``.

The reference carries its diagnostics in-band in its output documents;
these hooks are the device-side complement, thin wrappers over
``torch.profiler`` that cost nothing unless used:

* :func:`trace` labels a block with ``record_function`` and, given a
  ``log_dir``, profiles it (CPU activity, and CUDA activity on a machine
  with a card) and writes a Chrome trace into ``log_dir``;
* :func:`annotate` labels every call of a function;
* :func:`auto_trace` profiles every ``every_n``-th call of a loop.

The labels the JAX package puts on its programs with ``jax.named_scope``
are ``record_function`` labels of the same names here: ``bce.read_decay``,
``bce.consensus_reduce`` (``bce.consensus_local_sums`` for the raw sums)
and ``bce.outcome_update`` in the eager cycle math
(``ops/cycle_math.py``, ``parallel/compact.py``), and each kernel
wrapper's call under the kernel's name (``bce.settle_cycles``,
``bce.settle_cycles_lanes``, ``bce.onepass_settle``,
``bce.onepass_partials``, ``bce.bp_sweep``). A fused kernel has no phases
to split: on the card one launch does the decay, the sums and the update
of every step, so its time is one device event under its label, where
the plain versions on the CPU show the phases.

Usage::

    from bayesian_consensus_engine_tpu_torch.utils.profiling import auto_trace

    loop = auto_trace(build_cycle_loop(), "traces", every_n=500)
    for batch in feed:
        state, consensus = loop(*batch, state, now, steps)
    # → each capture is a ``*.pt.trace.json`` file under ``traces``:
    #   open it in Perfetto or chrome://tracing

:func:`device_memory_stats` is the runtime view of the card's memory that
the serve driver samples into the ``hbm.bytes_in_use`` /
``hbm.peak_bytes`` gauges.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, record_function

from bayesian_consensus_engine_tpu_torch.utils.device import resolve_device

#: Suffix of the Chrome trace files :func:`trace` writes.
TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(label: str, log_dir: "str | os.PathLike | None" = None) -> Iterator[None]:
    """Label a block; with *log_dir*, also profile it.

    Without ``log_dir`` the block only runs under a ``record_function``
    label (seen by any profiler that is recording). With it, the block
    runs under ``torch.profiler.profile`` (CPU activity, plus CUDA
    activity when this PyTorch has CUDA) and the capture is written to
    ``log_dir/<label>.<pid>.<ns>.pt.trace.json`` when the block ends.
    Work the block leaves queued on the card lands in the trace only if
    the block waits for it (:func:`auto_trace` does).
    """
    if log_dir is None:
        with record_function(label):
            yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as profile:
        with record_function(label):
            yield
    name = f"{label}.{os.getpid()}.{time.time_ns()}{TRACE_SUFFIX}"
    profile.export_chrome_trace(os.path.join(os.fspath(log_dir), name))


def annotate(label: str):
    """Decorator: run every call of the function under the ``label``
    ``record_function`` label."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def auto_trace(fn, log_dir, every_n: int = 100, label: str = "settlement"):
    """Profile every *every_n*-th call of *fn* into *log_dir*.

    Wrap a cycle loop once and call it as before: the wrapper counts the
    calls and runs the ``every_n``-th, ``2·every_n``-th, … under
    :func:`trace`, waiting for the card (``torch.cuda.synchronize``, when
    this process has used CUDA) inside the capture so that the device's
    work lands in the trace. Every other call goes straight to *fn*.

        loop = auto_trace(build_cycle_loop(), "traces", 500)
        for batch in feed:
            state, consensus = loop(*batch, state, now, steps)
    """
    if every_n < 1:
        raise ValueError(f"every_n={every_n}: capture every n-th call, n >= 1")
    counter = itertools.count(1)

    def wrapper(*args, **kwargs):
        if next(counter) % every_n:
            return fn(*args, **kwargs)
        with trace(label, log_dir):
            result = fn(*args, **kwargs)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        return result

    return functools.update_wrapper(wrapper, fn, updated=())


def device_memory_stats(device=None) -> dict:
    """Live device memory counters: ``{device, bytes_in_use, bytes_limit,
    peak_bytes_in_use, utilisation}``.

    On a CUDA device (``None`` means the current card, and raises without
    CUDA) ``bytes_in_use`` and ``peak_bytes_in_use`` are the caching
    allocator's ``allocated_bytes.all.current`` and
    ``allocated_bytes.all.peak``, and ``bytes_limit`` the card's total
    memory from ``torch.cuda.mem_get_info``.
    A CPU device exposes no allocator stats: zeros and ``None``, as the
    JAX package reports on backends without them.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type != "cuda":
        return {
            "device": str(device),
            "bytes_in_use": 0,
            "bytes_limit": None,
            "peak_bytes_in_use": 0,
            "utilisation": None,
        }
    stats = torch.cuda.memory_stats(device)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    _free, limit = torch.cuda.mem_get_info(device)
    return {
        "device": str(device),
        "bytes_in_use": in_use,
        "bytes_limit": int(limit),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "utilisation": (in_use / limit) if limit else None,
    }
