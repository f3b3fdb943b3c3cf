"""The one-pass partials kernel: one sources shard's settle sweep, emitting
what the cross-shard merge needs, in one CUDA launch.

What it replaces. ``ops/pallas_settle.py::_onepass_partials_kernel`` of
the JAX package (made by ``build_onepass_partials``), which runs on each
shard of a mesh whose sources axis has more than one shard: from the
PRE-update state read at ``now0``, the decayed read views (for the
tie-break, which runs outside over every shard's views: a group can span
shards) and the shard-local band tree roots and count; then the
``make_loop_math`` N-step loop with the state updated in place, and the
last step's raw consensus sums Σw, Σw·p, Σw·conf. The source is
``csrc/onepass_partials.cu`` (CUDA C++ for ``sm_90a``), built by
``ops/cuda_build`` and called through ``ctypes``. The merge —
``consensus_merge``, ``band_merge`` + ``band_epilogue`` and the sharded
``ring_tiebreak_math`` — runs after the kernel in plain PyTorch
(``parallel/sharded.py``), as the JAX package runs it in plain XLA.

What bounds it. Device-memory bytes (a few dozen operations a slot a
step); :func:`bound_bytes` counts the bytes the function must move on the
inputs at hand. What the design does: one thread per market walks its
K_loc slots once, reads each slot's state once, writes its views, pushes
its band moments into a per-thread binary-counter tree (the adjacent-pair
tree), settles its whole step loop in registers and writes it back in
place. The kernel is instantiated per band-tree depth,
log2(pow2_at_least(K_loc)): up to K_loc = 64 the tree's levels and the
slots' mask and exists bits live in registers; a wider K_loc takes the
run-time stack in local memory. A caller that passes ``depth_out`` learns
which instantiation ran. There is no scratch block and no
tie-break inside.

Beyond the reference. The kernel takes float64 state too (the reference's
kernel is float32 only, but its XLA route settles float64 on a
sources-sharded mesh with the tie-break off, and the port has one route),
and ``steps == 0`` (a zero-step mode: views, band roots and count are
written, the state is left alone and the raw sums are zero; the caller
writes the zero consensus). ``with_views`` and ``with_bands`` drop the
outputs a call with that stage off does not read.

:func:`onepass_partials` launches the kernel for CUDA tensors and raises
when it cannot; only CPU tensors take the plain version,
:func:`onepass_partials_reference`, which composes the port's plain
``read_phase``, ``band_sums`` and ``make_loop_math`` over
``_sums_cycle_math`` as the JAX kernel body composes its own. ``LAUNCHES``
counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import partial
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from bayesian_consensus_engine_tpu_torch.ops import cuda_build
from bayesian_consensus_engine_tpu_torch.ops.cuda_build import check_tensor
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import (
    MarketBlockState,
    _sums_cycle_math,
    _sums_fast_cycle_math,
    make_loop_math,
    read_phase,
)
from bayesian_consensus_engine_tpu_torch.ops.uncertainty import band_sums
from bayesian_consensus_engine_tpu_torch.utils.profiling import annotate

#: Kernel launches made by :func:`onepass_partials` in this process.
LAUNCHES = 0

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "onepass_partials.cu"


class PartialsOutputs(NamedTuple):
    state: MarketBlockState            # the shard's (K_loc, M) state after the loop
    consensus_sums: torch.Tensor       # (3, M) last step's Σw, Σw·p, Σw·conf
    band_sums: Optional[torch.Tensor]  # f32 (4, M) shard-local tree roots
    band_count: Optional[torch.Tensor]  # i32 (M,) masked slots
    read_rel: Optional[torch.Tensor]   # (K_loc, M) views at now0
    read_conf: Optional[torch.Tensor]


def _load():
    signature = (
        [ctypes.c_void_p] * 13
        + [ctypes.c_double]
        + [ctypes.c_int64] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    return cuda_build.load(SOURCE, {
        "onepass_partials_f32": signature, "onepass_partials_f64": signature,
    })


def _check(dtype: torch.dtype, steps: int) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported state dtype {dtype}")
    if steps < 0:
        raise ValueError(f"steps={steps} must be >= 0")


def onepass_partials_reference(
    probs, mask, outcome, state: MarketBlockState, now0: float, steps: int,
    *, with_views: bool = True, with_bands: bool = True,
    chunk_slots: "int | None" = None,
) -> PartialsOutputs:
    """The plain version: the JAX partials kernel's body in eager torch.

    The views and band moments read the state at ``now0`` before the loop
    updates it. Functional: the inputs are not modified.
    """
    dtype = state.reliability.dtype
    _check(dtype, steps)
    now = torch.tensor(now0, dtype=dtype, device=probs.device)
    read_rel = read_conf = sums = count = None
    if with_views or with_bands:
        read_rel, read_conf = read_phase(state, now)
    if with_bands:
        sums, count = band_sums(
            probs, mask, read_rel, chunk_slots=chunk_slots, agents_last=False,
        )
    if steps == 0:
        new_state = state
        csums = torch.zeros((3, probs.shape[1]), dtype=dtype, device=probs.device)
    else:
        loop_math = make_loop_math(
            partial(_sums_cycle_math, slots_axis=0), steps,
            fast_cycle_fn=partial(_sums_fast_cycle_math, slots_axis=0),
        )
        new_state, csums = loop_math(probs, mask, outcome, state, now)
    if not with_views:
        read_rel = read_conf = None
    return PartialsOutputs(new_state, csums, sums, count, read_rel, read_conf)


@annotate("bce.onepass_partials")
def onepass_partials(
    probs, mask, outcome, state: MarketBlockState, now0: float, steps: int,
    *, with_views: bool = True, with_bands: bool = True,
    chunk_slots: "int | None" = None,
    depth_out: Optional[torch.Tensor] = None,
) -> PartialsOutputs:
    """Settle one sources shard's resident slot-major block ``steps``
    cycles and, from its state at ``now0``, emit the read views and band
    roots; see :class:`PartialsOutputs`.

    ``probs`` (the state's dtype) and ``mask`` (bool) are (K_loc, M),
    ``outcome`` (bool) is (M,), ``state`` a :class:`MarketBlockState` of
    (K_loc, M) tensors in float32 or float64 with a bool ``exists``;
    ``now0`` is the first step's day relative to the store's epoch.
    ``chunk_slots`` shapes the plain version's working set; no result
    depends on it, and the kernel ignores it.

    On CUDA tensors it launches the kernel, which updates the state IN
    PLACE: the returned state tensors are the ones passed in. On CPU
    tensors it runs :func:`onepass_partials_reference` and returns new
    ones. Either way the caller must use the returned state.

    ``depth_out``, an int32 (1,) tensor on the block's CUDA device, asks
    the launch which kernel instantiation it ran: the depth of its register
    band tree, or -1 for the stack tree beyond K_loc = 64. The CPU path
    leaves it as it is.
    """
    global LAUNCHES
    device = probs.device
    if device.type == "cpu":
        return onepass_partials_reference(
            probs, mask, outcome, state, now0, steps, with_views=with_views,
            with_bands=with_bands, chunk_slots=chunk_slots,
        )
    if device.type != "cuda":
        raise ValueError(f"onepass_partials runs on cuda or cpu, not {device}")
    dtype = state.reliability.dtype
    _check(dtype, steps)
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
    if depth_out is not None:
        check_tensor("depth_out", depth_out, torch.int32, (1,), device)

    def empty(shape, out_dtype):
        return torch.empty(shape, dtype=out_dtype, device=device)

    csums = empty((3, num_markets), dtype)
    sums = count = read_rel = read_conf = None
    if with_bands:
        sums, count = empty((4, num_markets), torch.float32), empty(
            num_markets, torch.int32)
    if with_views:
        read_rel, read_conf = empty(block, dtype), empty(block, dtype)
    out = PartialsOutputs(state, csums, sums, count, read_rel, read_conf)
    if num_markets == 0:
        return out

    def ptr(tensor):
        return None if tensor is None else tensor.data_ptr()

    lib = _load()
    fn = (lib.onepass_partials_f32 if dtype == torch.float32
          else lib.onepass_partials_f64)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = fn(
            probs.data_ptr(), mask.data_ptr(), outcome.data_ptr(),
            state.reliability.data_ptr(), state.confidence.data_ptr(),
            state.updated_days.data_ptr(), state.exists.data_ptr(),
            csums.data_ptr(), ptr(sums), ptr(count), ptr(read_rel),
            ptr(read_conf), ptr(depth_out), float(now0), num_slots, num_markets, int(steps),
            int(with_views), int(with_bands), stream,
        )
    if status != 0:
        raise RuntimeError(f"onepass_partials launch failed: CUDA error {status}")
    LAUNCHES += 1
    return out


def bound_bytes(
    num_slots: int, num_markets: int, num_valid: int, num_valid_existing: int,
    num_existing: int, steps: int, itemsize: int, with_views: bool = True,
    with_bands: bool = True,
) -> int:
    """Device-memory bytes one launch must move on these inputs: each byte
    the function needs read once and each output written once.

    ``num_valid`` counts the masked slots, ``num_valid_existing`` those
    whose row already exists, ``num_existing`` every slot whose row exists
    (masked or not). The mask of every slot is read and the three raw sums
    written per market. Per masked slot the probability is read. With the
    views on, every slot's exists byte and every existing slot's
    reliability, confidence and stamp are read and both views written;
    without them only the masked slots' exists bytes, and per existing
    masked slot its reliability, plus its confidence when the loop runs
    and its stamp when the bands read it or the one-step loop does. With
    ``steps > 0`` the outcome is read per market and every masked slot's
    reliability, confidence and stamp written, and the exists byte of each
    cold one. The bands write four sums and a count per market.
    """
    total = num_slots * num_markets  # the mask
    total += 3 * num_markets * itemsize  # the raw consensus sums
    total += num_valid * itemsize  # probabilities
    if with_views:
        total += num_slots * num_markets  # every exists byte
        total += num_existing * 3 * itemsize
        total += 2 * num_slots * num_markets * itemsize  # the views
    else:
        total += num_valid  # exists bytes
        state_reads = 1 + (steps > 0) + (with_bands or steps == 1)
        total += num_valid_existing * state_reads * itemsize
    if steps > 0:
        total += num_markets  # the outcome
        total += num_valid * 3 * itemsize + (num_valid - num_valid_existing)
    if with_bands:
        total += num_markets * 5 * 4
    return total
