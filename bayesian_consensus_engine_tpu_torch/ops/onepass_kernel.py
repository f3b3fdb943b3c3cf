"""The one-pass settle kernel: analytics read, ring tie-break, band moments
and N settle cycles over the resident block, in one CUDA launch.

What it replaces. ``ops/pallas_settle.py::_onepass_kernel`` of the JAX
package (made by ``build_onepass_settle``), which computes in one sweep
per tile what the one-device fused program
(``parallel/sharded.py::build_cycle_analytics_loop``) computes: from the
PRE-update state read at ``now0``, the ring tie-break and the raw band
moments; then the ``make_loop_math`` N-step loop, the state updated in
place. The source is ``csrc/onepass_settle.cu`` (CUDA C++ for
``sm_90a``), built by ``ops/cuda_build`` and called through ``ctypes``.
``band_epilogue`` (the divisions, the variance and the z scaling) runs
after the kernel in plain PyTorch, as the JAX wrapper runs it in plain
XLA.

What bounds it. Device-memory bytes; :func:`bound_bytes` counts the bytes
the function must move on the inputs at hand. The tie-break's K² key
comparisons per market are a few hundred operations at K ≈ 16, far below
the card's rate. What the design does: one thread per market walks its
slots once, settles each slot's whole step loop in registers (as
``settle_cycles`` does) and builds the band tree in registers (the kernel
is instantiated per tree depth up to K = 64; a wider K keeps the tree's
stack in local memory). Up to K = 64 the tie-break's (key, weight) pairs
go to the thread's column of the block's shared memory (8 bytes a slot;
the block shrinks from 256 threads to 128 and 64 as K grows so that they
fit the default 48 KB) and its valid slots to a register bitmask, so the
group loop reads no device memory. A wider K recomputes each pair from
the pre-update state in device memory, before the slots are settled, and
so takes any K.

:func:`onepass_settle` launches the kernel for CUDA tensors and raises
when it cannot; only CPU tensors take the plain version,
:func:`onepass_settle_reference`, which composes the port's plain
``read_phase``, ``ring_tiebreak_math``, ``band_sums`` and
``make_loop_math`` as the JAX fused program composes its own.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import partial
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.ops import cuda_build
from bayesian_consensus_engine_tpu_torch.ops.cuda_build import check_tensor
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import (
    MarketBlockState,
    _cycle_math,
    _fast_cycle_math,
    make_loop_math,
    read_phase,
)
from bayesian_consensus_engine_tpu_torch.ops.tiebreak import (
    RingTieBreakResult,
    ring_tiebreak_math,
)
from bayesian_consensus_engine_tpu_torch.ops.uncertainty import band_sums
from bayesian_consensus_engine_tpu_torch.utils.profiling import annotate

#: Kernel launches made by :func:`onepass_settle` in this process.
LAUNCHES = 0

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "onepass_settle.cu"


class OnepassOutputs(NamedTuple):
    state: MarketBlockState          # the (K, M) state after ``steps`` cycles
    consensus: torch.Tensor          # (M,) last step; NaN at zero weight
    tiebreak: Optional[RingTieBreakResult]  # None with the stage off
    band_sums: Optional[torch.Tensor]       # f32 (4, M): Σw, Σw·p, Σw·p², Σw²
    band_count: Optional[torch.Tensor]      # i32 (M,) signalling slots


def _load():
    signature = (
        [ctypes.c_void_p] * 16
        + [ctypes.c_double] * 3
        + [ctypes.c_int64] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    return cuda_build.load(SOURCE, {
        "onepass_settle_f32": signature, "onepass_settle_f64": signature,
    })


def _check_stages(dtype: torch.dtype, steps: int, with_tiebreak: bool) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported state dtype {dtype}")
    if steps < 0:
        raise ValueError(f"steps={steps} must be >= 0")
    if with_tiebreak and dtype != torch.float32:
        raise ValueError(
            "the tie-break runs on float32 state only: the JAX reference has "
            "no float64 tie-break (its program fails to trace under x64); "
            "settle float64 with the tie-break off"
        )


def onepass_settle_reference(
    probs, mask, outcome, state: MarketBlockState, now0: float, steps: int,
    *, with_tiebreak: bool = True, with_bands: bool = True,
    precision: int = 6, chunk_agents: "int | None" = None,
    chunk_slots: "int | None" = None,
) -> OnepassOutputs:
    """The plain version: the one-device fused program in eager torch.

    Both analytics stages read the state at ``now0`` before the loop
    updates it. Functional: the inputs are not modified.
    """
    dtype = state.reliability.dtype
    _check_stages(dtype, steps, with_tiebreak)
    now = torch.tensor(now0, dtype=dtype, device=probs.device)
    tiebreak = sums = count = None
    if with_tiebreak or with_bands:
        read_rel, read_conf = read_phase(state, now)
    if with_tiebreak:
        tiebreak = ring_tiebreak_math(
            probs, read_rel, read_conf, read_rel, mask,
            precision=precision, chunk_agents=chunk_agents, agents_last=False,
        )
    if with_bands:
        sums, count = band_sums(
            probs, mask, read_rel, chunk_slots=chunk_slots, agents_last=False,
        )
    loop_math = make_loop_math(
        partial(_cycle_math, slots_axis=0), steps,
        fast_cycle_fn=partial(_fast_cycle_math, slots_axis=0),
    )
    new_state, consensus = loop_math(probs, mask, outcome, state, now)
    return OnepassOutputs(new_state, consensus, tiebreak, sums, count)


@annotate("bce.onepass_settle")
def onepass_settle(
    probs, mask, outcome, state: MarketBlockState, now0: float, steps: int,
    *, with_tiebreak: bool = True, with_bands: bool = True,
    precision: int = 6, chunk_agents: "int | None" = None,
    chunk_slots: "int | None" = None,
) -> OnepassOutputs:
    """Settle a resident slot-major block ``steps`` cycles and, from its
    state at ``now0``, compute the tie-break and the raw band moments.

    ``probs`` (the state's dtype) and ``mask`` (bool) are (K, M),
    ``outcome`` (bool) is (M,), ``state`` a :class:`MarketBlockState` of
    (K, M) tensors in float32 or float64 with a bool ``exists``; ``now0``
    is the first step's day relative to the store's epoch. The tie-break
    needs float32 state. ``chunk_agents`` and ``chunk_slots`` shape the
    plain version's working set; no result depends on them, and the
    kernel ignores them.

    On CUDA tensors it launches the kernel, which updates the state IN
    PLACE: the returned state tensors are the ones passed in. On CPU
    tensors it runs :func:`onepass_settle_reference` and returns new ones.
    Either way the caller must use the returned state.
    """
    global LAUNCHES
    device = probs.device
    if device.type == "cpu":
        return onepass_settle_reference(
            probs, mask, outcome, state, now0, steps,
            with_tiebreak=with_tiebreak, with_bands=with_bands,
            precision=precision, chunk_agents=chunk_agents,
            chunk_slots=chunk_slots,
        )
    if device.type != "cuda":
        raise ValueError(f"onepass_settle runs on cuda or cpu, not {device}")
    dtype = state.reliability.dtype
    _check_stages(dtype, steps, with_tiebreak)
    if probs.dim() != 2:
        raise ValueError("probs must be (K, M)")
    num_slots, num_markets = probs.shape
    block = (num_slots, num_markets)
    check_tensor("probs", probs, dtype, block, device)
    check_tensor("mask", mask, torch.bool, block, device)
    check_tensor("outcome", outcome, torch.bool, (num_markets,), device)
    check_tensor("reliability", state.reliability, dtype, block, device)
    check_tensor("confidence", state.confidence, dtype, block, device)
    check_tensor("updated_days", state.updated_days, dtype, block, device)
    check_tensor("exists", state.exists, torch.bool, block, device)

    def empty(shape, out_dtype):
        return torch.empty(shape, dtype=out_dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    consensus = empty(num_markets, dtype)
    tiebreak = sums = count = None
    if with_tiebreak:
        tiebreak = RingTieBreakResult(
            empty(num_markets, f32), empty(num_markets, f32),
            empty(num_markets, f32), empty(num_markets, i32),
            empty(num_markets, i32), empty(num_markets, f32),
        )
    if with_bands:
        sums, count = empty((4, num_markets), f32), empty(num_markets, i32)
    if num_markets == 0:
        return OnepassOutputs(state, consensus, tiebreak, sums, count)

    def ptr(tensor):
        return None if tensor is None else tensor.data_ptr()

    lib = _load()
    fn = lib.onepass_settle_f32 if dtype == torch.float32 else lib.onepass_settle_f64
    tb = tiebreak if tiebreak is not None else (None,) * 6
    scale = np.float32(10.0**precision)
    recip = np.float32(1.0) / scale
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = fn(
            probs.data_ptr(), mask.data_ptr(), outcome.data_ptr(),
            state.reliability.data_ptr(), state.confidence.data_ptr(),
            state.updated_days.data_ptr(), state.exists.data_ptr(),
            consensus.data_ptr(), *(ptr(x) for x in tb), ptr(sums),
            ptr(count), float(now0), float(scale), float(recip), num_slots,
            num_markets, int(steps), int(with_tiebreak), int(with_bands),
            stream,
        )
    if status != 0:
        raise RuntimeError(f"onepass_settle launch failed: CUDA error {status}")
    LAUNCHES += 1
    return OnepassOutputs(state, consensus, tiebreak, sums, count)


def bound_bytes(
    num_slots: int, num_markets: int, num_valid: int, num_existing: int,
    steps: int, itemsize: int, with_tiebreak: bool = True,
    with_bands: bool = True,
) -> int:
    """Device-memory bytes one call must move on these inputs: each byte
    the function needs read once and each output written once.

    ``num_valid`` counts the masked slots and ``num_existing`` those whose
    row already exists. Per masked slot the probability and the exists
    byte are read; per existing masked slot the stored reliability, and
    the confidence (when the loop runs or the tie-break reads it) and the
    stamp (when the analytics read decays or the one-step loop does).
    With ``steps > 0`` every masked slot's reliability, confidence and
    stamp are written, and the exists byte of each cold one; the outcome
    is read and the consensus written per market. The tie-break writes
    six 4-byte values per market, the bands four sums and a count.
    """
    analytics = with_tiebreak or with_bands
    total = num_markets * itemsize  # the consensus (zeros when steps == 0)
    if not analytics and steps == 0:
        return total
    total += num_slots * num_markets  # the mask
    total += num_valid * (itemsize + 1)  # probability, exists
    state_reads = 1  # reliability
    if steps > 0 or with_tiebreak:
        state_reads += 1  # confidence
    if analytics or steps == 1:
        state_reads += 1  # stamp
    total += num_existing * state_reads * itemsize
    if steps > 0:
        total += num_markets  # the outcome
        total += num_valid * 3 * itemsize + (num_valid - num_existing)
    if with_tiebreak:
        total += num_markets * 6 * 4
    if with_bands:
        total += num_markets * 5 * 4
    return total
