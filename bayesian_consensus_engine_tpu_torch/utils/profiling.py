"""Device memory counters for the observability surface.

The port's counterpart of ``device_memory_stats`` in the JAX package's
``utils/profiling.py``: the runtime view of the card's memory that the
serve driver samples into the ``hbm.bytes_in_use`` / ``hbm.peak_bytes``
gauges. The profiler half of that module (trace capture and
annotations) is not ported yet.
"""

from __future__ import annotations

import torch

from bayesian_consensus_engine_tpu_torch.utils.device import resolve_device


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
