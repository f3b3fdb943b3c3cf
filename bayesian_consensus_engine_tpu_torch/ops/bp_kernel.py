"""The belief-propagation sweep kernel: up to ``max_steps`` Jacobi sweeps of
the damped, precision-weighted mix over a market graph, with the early
exit decided on the card.

What it replaces. ``ops/pallas_bp.py::_bp_kernel`` of the JAX package
(made by ``build_bp_sweep``), which computes ``ops/propagate.py::
bp_sweep_math`` at ``axis_name=None`` with the moment vectors resident in
VMEM across sweeps. The source is ``csrc/bp_sweep.cu`` (CUDA C++ for
``sm_90a``), built by ``ops/cuda_build`` and called through ``ctypes``.

What bounds it. Device-memory bytes; :func:`bound_bytes` counts them per
sweep that runs: the neighbour blocks once and the moment vectors read
and written once. What the design does: one cooperative launch a call
runs every sweep, its blocks as many as the SMs hold at once, each
thread walking market rows grid-stride and looping over a row's D
neighbours; a grid-wide barrier (``grid.sync()``) between sweeps gives
Jacobi semantics. Between sweeps the moments sit in two ping-pong
buffers of the kernel's own layout, (mean, variance) interleaved, so one
neighbour's gather touches one L2 sector; the neighbour blocks stream
with an evict-first cache hint. The residual is a block max plus one
``atomicMax`` per block, and after each barrier every block reads the
finished residual and stops at the same sweep, so the host enqueues one
launch and reads nothing back. A call makes one launch
(:func:`launches_per_call`); ``max_steps == 0`` makes none.

:func:`bp_sweep` launches the kernel for CUDA tensors and raises when it
cannot; only CPU tensors take the plain version,
:func:`bp_sweep_reference`, which is the port's ``bp_sweep_math``.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bayesian_consensus_engine_tpu_torch.ops import cuda_build
from bayesian_consensus_engine_tpu_torch.ops.cuda_build import check_tensor
from bayesian_consensus_engine_tpu_torch.ops.propagate import (
    DEFAULT_DAMPING,
    DEFAULT_SWEEP_STEPS,
    bp_sweep_math,
    sweep_constants,
)
from bayesian_consensus_engine_tpu_torch.utils.profiling import annotate

#: Kernel launches made by :func:`bp_sweep` in this process.
LAUNCHES = 0

SOURCE = cuda_build.CSRC / "bp_sweep.cu"


def _load():
    signature = (
        [ctypes.c_void_p] * 10
        + [ctypes.c_double] * 5
        + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    return cuda_build.load(SOURCE, {"bp_sweep_f32": signature})


def launches_per_call(max_steps: int) -> int:
    """Kernel launches one :func:`bp_sweep` call makes on CUDA: one
    cooperative launch runs every sweep; a zero-step sweep makes none."""
    return 1 if max_steps > 0 else 0


#: The plain version: ``ops/propagate.py::bp_sweep_math`` in eager torch,
#: on any device, with the wrapper's arguments and results.
bp_sweep_reference = bp_sweep_math


def _check(means, variances, neighbor_idx, neighbor_w, tol) -> None:
    if not isinstance(means, torch.Tensor):
        raise TypeError("means must be a torch.Tensor")
    if means.dim() != 1:
        raise ValueError("means must be (M,)")
    if neighbor_idx.dim() != 2:
        raise ValueError("neighbor_idx must be (M, D)")
    device = means.device
    num_markets = means.shape[0]
    block = (num_markets, neighbor_idx.shape[1])
    check_tensor("means", means, torch.float32, (num_markets,), device)
    if variances is not None:
        check_tensor("variances", variances, torch.float32, (num_markets,), device)
    check_tensor("neighbor_idx", neighbor_idx, torch.int32, block, device)
    check_tensor("neighbor_w", neighbor_w, torch.float32, block, device)
    if tol is not None and not tol > 0:
        raise ValueError(
            f"tol={tol!r}: a positive residual tolerance, or None for the "
            "fixed-depth sweep"
        )


@annotate("bce.bp_sweep")
def bp_sweep(
    means, variances, neighbor_idx, neighbor_w, *,
    damping: float = DEFAULT_DAMPING, max_steps: int = DEFAULT_SWEEP_STEPS,
    tol: Optional[float] = None, keep_fma: "bool | None" = None,
):
    """Run up to ``max_steps`` belief sweeps; returns ``(means, variances
    | None, iters_run, residual)`` as :func:`bp_sweep_reference` does.

    ``means`` and ``variances`` (``None`` for the point lane) are float32
    (M,); ``neighbor_idx`` int32 (M, D) positions on the same axis (−1
    pads) and ``neighbor_w`` float32 (M, D); all contiguous, on one
    device. ``tol`` is ``None`` (fixed depth) or positive. ``keep_fma``
    picks which product of the blends is fused, as in
    ``bp_sweep_math`` (``None``: the reference's choice when its residual
    is read). The inputs are not modified. On CUDA tensors it launches the kernel
    (:func:`launches_per_call` launches, no host sync; ``iters_run`` and
    ``residual`` come back as 0-dim device tensors); on CPU tensors it
    runs the plain version. A zero-step sweep returns the seeds.
    """
    global LAUNCHES
    _check(means, variances, neighbor_idx, neighbor_w, tol)
    device = means.device
    if device.type == "cpu":
        return bp_sweep_reference(
            means, variances, neighbor_idx, neighbor_w,
            damping=damping, max_steps=max_steps, tol=tol, keep_fma=keep_fma,
        )
    if device.type != "cuda":
        raise ValueError(f"bp_sweep runs on cuda or cpu, not {device}")
    f32 = torch.float32
    moments = variances is not None
    if max_steps <= 0:
        return (
            means, variances,
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=f32, device=device),
        )
    num_markets, degree = neighbor_idx.shape
    if keep_fma is None:
        keep_fma = degree == 1

    def vector():
        return torch.empty(num_markets, dtype=f32, device=device)

    out_m = vector()
    out_s = vector() if moments else None
    # Two buffers of M cells for the sweeps before the last: (mean,
    # variance) pairs on the moments lane, means on the point lane.
    pingpong = None
    if max_steps > 1:
        pingpong = torch.empty(
            2 * num_markets * (2 if moments else 1), dtype=f32, device=device)
    res_bits = torch.zeros(max_steps, dtype=torch.int32, device=device)
    iters_run = torch.empty((), dtype=torch.int32, device=device)
    residual = torch.empty((), dtype=f32, device=device)

    def ptr(tensor):
        return None if tensor is None else tensor.data_ptr()

    lam, keep = sweep_constants(damping)
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.bp_sweep_f32(
            means.data_ptr(), ptr(variances), out_m.data_ptr(), ptr(out_s),
            ptr(pingpong), neighbor_idx.data_ptr(),
            neighbor_w.data_ptr(), res_bits.data_ptr(), iters_run.data_ptr(),
            residual.data_ptr(), float(lam), float(keep), float(lam * lam),
            float(keep * keep), 0.0 if tol is None else float(tol),
            int(tol is not None), int(max_steps), num_markets, degree,
            int(moments), int(keep_fma), stream,
        )
    if status != 0:
        raise RuntimeError(f"bp_sweep launch failed: CUDA error {status}")
    LAUNCHES += launches_per_call(max_steps)
    return out_m, out_s, iters_run, residual


def bound_bytes(
    num_markets: int, max_degree: int, iters_run: int, moments: bool,
) -> int:
    """Device-memory bytes a call must move when ``iters_run`` sweeps run:
    per sweep, the neighbour blocks once (``M·D·8``: the int32 positions
    and float32 weights) and the moment vectors read and written once
    (``M·16`` on the moments lane, ``M·8`` on the point lane); then the
    audit pair written (8 bytes). The gathers of neighbour moments are
    cache hits and are not counted. Beyond this the kernel moves what its
    own layout costs: the sweeps before the last write and read the
    moments interleaved in its ping-pong buffers (the same bytes as the
    separate vectors), and after an early exit it unpacks the last of
    those buffers into the separate result vectors (``M·16`` on the
    moments lane), which the bound does not count. A zero-step sweep
    moves nothing."""
    if iters_run <= 0:
        return 0
    per_market = max_degree * 8 + (16 if moments else 8)
    return iters_run * num_markets * per_market + 8
