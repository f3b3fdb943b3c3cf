"""The settle kernel: gather → N settle cycles → scatter in one CUDA launch.

What it replaces. ``ops/pallas_cycle.py::_fused_cycle_kernel`` of the JAX
package, which runs one settle cycle on a slot-major (K, TILE_M) tile, and
the gather, the N-step loop and the scatter that
``pipeline.py::_settle_math`` wraps around the cycle. The source is
``csrc/settle_cycles.cu`` (CUDA C++ for ``sm_90a``); ``ops/cuda_build``
compiles it with ``nvcc`` at first use into a shared library with a plain
C interface, called through ``ctypes``.

What bounds it. Device-memory bytes, not arithmetic (a few dozen
operations per slot per step): per plan slot, the mask is read; per real
slot, its row index, probability and its row's existence are read, its
row's reliability and confidence only if the row exists (and its stamp
when ``steps == 1``), and reliability, confidence, stamp and
``rel_touched`` written (existence only where it turns true); per market,
the outcome and a ``touched_offsets`` entry are read and the consensus
written. :func:`bound_bytes` counts exactly that for the inputs at hand,
and its quotient by the card's memory rate is the kernel's bound.

What the design does about it. Each slot runs all ``steps`` updates in
registers (only the last step's consensus is observable), so traffic does
not grow with ``steps`` and the state crosses device memory once each way,
in place. A block takes a tile of consecutive markets: it stages the
tile's masked slots in shared memory in ``rel_touched`` order, settles
them one thread a slot (every lane busy, the row gather and the
``rel_touched`` writes nearly contiguous), then sums each market's
last-step weights in slot order. The launch sizes the stage from the
plan's mean masked slots a market; a tile whose slots overflow it takes
the wide route, one thread per market over its K slots. A caller that
passes ``routes`` learns how many tiles took each route.

``touched_offsets`` and the order of ``rel_touched``. The JAX package
gathers ``new_rel[touched_rows]`` after the scatter. Here the thread that
settles a slot also writes its reliability into ``rel_touched``, so
``rel_touched`` lists the masked slots market by market, in slot order
within a market, and ``touched_offsets[m]`` (an exclusive prefix sum of
the per-market mask counts, built once per plan) is where market ``m``
starts. No second pass and no grid-wide barrier are needed.

Replay lanes. :func:`settle_cycles_lanes` settles C stacked copies of
the flat state through one plan in one launch, each lane with its own
cycle rates (a (C, 5) float32 params tensor, :data:`PARAM_FIELDS`); it
writes each lane's consensus and no ``rel_touched``. A block of its
kernel stages a tile's masked slots in shared memory and settles them for
each lane it takes, the lanes' rates in shared memory too. Where the
tile's markets lie in row order (a store that interned the plan's pairs
in order) one block takes a group of up to 16 lanes, so the lanes share
one read of the plan; where they do not (a batch that lists its markets
in another order than the store's rows), one block takes one lane, so
that each lane's scattered rows are visited close together in time.
Its route report (:data:`LANE_ROUTE_SLOTS` slots) says how many tiles
took the shared plan, and the launch's shared bytes and lane groups. Its
plain version, :func:`settle_cycles_lanes_reference`, loops
over the lanes with the cycle math given the lane's ``CycleParams``,
which sums each market's slots in slot order, as the kernel does.

:func:`settle_cycles` launches the kernel for CUDA tensors and raises when
it cannot; only CPU tensors take the plain version,
:func:`settle_cycles_reference`. ``LAUNCHES`` counts the kernel launches;
``LANE_LAUNCHES`` counts :func:`settle_cycles_lanes`' own.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.ops import cuda_build
from bayesian_consensus_engine_tpu_torch.ops.cuda_build import check_tensor
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import (
    CycleParams,
    MarketBlockState,
    _cycle_math,
    _fast_cycle_math,
    make_loop_math,
)
from bayesian_consensus_engine_tpu_torch.utils.config import (
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
)
from bayesian_consensus_engine_tpu_torch.utils.profiling import annotate

#: Kernel launches made by :func:`settle_cycles` in this process.
LAUNCHES = 0
#: Kernel launches made by :func:`settle_cycles_lanes` in this process.
LANE_LAUNCHES = 0

#: The columns of a lane params tensor, in order (``CycleParams``' fields).
PARAM_FIELDS = CycleParams._fields
#: The most lanes one launch takes.
MAX_LANES = 65535
#: The slots of the lane launch's full route report: :func:`settle_cycles`'
#: three, then the tiles settled a group of lanes a block, the shared bytes
#: a block and the most lanes a group takes.
LANE_ROUTE_SLOTS = 6

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "settle_cycles.cu"


class SettleOutputs(NamedTuple):
    reliability: torch.Tensor   # flat state after the settle
    confidence: torch.Tensor
    updated_days: torch.Tensor
    exists: torch.Tensor
    consensus: torch.Tensor     # (M,) last step; NaN at zero weight
    rel_touched: torch.Tensor   # (num_touched,) settled rel, market-major


def _load():
    flat = (
        [ctypes.c_void_p] * 11
        + [ctypes.c_double] + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 2
    )
    lanes = (
        [ctypes.c_void_p] * 11
        + [ctypes.c_double] + [ctypes.c_int64] * 7 + [ctypes.c_void_p] * 2
    )
    return cuda_build.load(SOURCE, {
        "settle_cycles_f32": flat, "settle_cycles_f64": flat,
        "settle_cycles_lanes_f32": lanes, "settle_cycles_lanes_f64": lanes,
    })


def touched_layout(slot_rows: np.ndarray, mask: np.ndarray):
    """Host helper: ``(touched_rows, touched_offsets)`` for a plan block.

    ``touched_rows`` (int32) lists the flat rows of the masked slots market
    by market, slot order within a market — the order the kernel writes
    ``rel_touched`` in — and ``touched_offsets`` (int64, M + 1) is where
    each market's run starts.
    """
    rows = np.ascontiguousarray(slot_rows.T[mask.T], dtype=np.int32)
    offsets = np.zeros(mask.shape[1] + 1, dtype=np.int64)
    np.cumsum(mask.sum(0), out=offsets[1:])
    return rows, offsets


def settle_cycles_reference(
    rel, conf, days, exists, slot_rows, probs, mask, outcome,
    touched_offsets, num_touched: int, now0: float, steps: int,
    params: Optional[CycleParams] = None, ordered: bool = False,
) -> SettleOutputs:
    """The plain version: ``pipeline.py::_settle_math`` in eager torch.

    Gather through an appended sink row (pad slots, row −1, read the
    cold-start defaults there), run ``make_loop_math(_cycle_math, steps,
    fast_cycle_fn=_fast_cycle_math)``, scatter back and slice the sink off.
    Functional: the inputs are not modified. ``touched_offsets`` is only
    checked against ``num_touched``; the touched rows come from the block.
    ``params`` (one replay lane's ``CycleParams`` of 0-d tensors) runs the
    cycle math with those rates; ``ordered`` adds each consensus over the
    slots in slot order, the lane kernel's order.
    """
    dtype = rel.dtype

    def ext(x, fill):
        return torch.cat([x, torch.full((1,), fill, dtype=x.dtype, device=x.device)])

    rel_e = ext(rel, DEFAULT_RELIABILITY)
    conf_e = ext(conf, DEFAULT_CONFIDENCE)
    days_e = ext(days, 0.0)
    exists_e = ext(exists, False)
    rows = slot_rows.long()

    block = MarketBlockState(
        reliability=rel_e[rows],
        confidence=conf_e[rows],
        updated_days=days_e[rows],
        exists=exists_e[rows],
    )

    def cycle_fn(probs, mask, outcome, state, now_days):
        return _cycle_math(probs, mask, outcome, state, now_days, slots_axis=0,
                           params=params, ordered=ordered)

    def fast_fn(probs, mask, outcome, rel, conf, now_days, prev_now):
        return _fast_cycle_math(
            probs, mask, outcome, rel, conf, now_days, prev_now, slots_axis=0,
            params=params, ordered=ordered,
        )

    loop_math = make_loop_math(cycle_fn, steps, fast_cycle_fn=fast_fn)
    now0_t = torch.tensor(now0, dtype=dtype, device=rel.device)
    new_block, consensus = loop_math(probs, mask, outcome, block, now0_t)

    # Every real slot maps to a distinct flat row, so the scatter is a
    # permutation write; pad slots all land on the sink row.
    def scatter(flat, values):
        out = flat.clone()
        out[rows] = values
        return out[:-1]

    new_rel = scatter(rel_e, new_block.reliability)
    new_conf = scatter(conf_e, new_block.confidence)
    new_days = scatter(days_e, new_block.updated_days)
    new_exists = scatter(exists_e, new_block.exists)
    touched_rows = rows.t()[mask.t()]
    if touched_rows.numel() != num_touched or int(touched_offsets[-1]) != num_touched:
        raise ValueError(
            f"num_touched={num_touched} but the block has "
            f"{touched_rows.numel()} masked slots"
        )
    rel_touched = new_rel[touched_rows]
    return SettleOutputs(
        new_rel, new_conf, new_days, new_exists, consensus, rel_touched
    )


@annotate("bce.settle_cycles")
def settle_cycles(
    rel, conf, days, exists, slot_rows, probs, mask, outcome,
    touched_offsets, num_touched: int, now0: float, steps: int,
    *, routes: Optional[torch.Tensor] = None,
) -> SettleOutputs:
    """Settle a plan block against the flat store state, ``steps`` cycles.

    ``rel``, ``conf``, ``days`` (the working dtype, float32 or float64) and
    ``exists`` (bool) are the flat state, capacity-length; ``slot_rows``
    (int32), ``probs`` (working dtype) and ``mask`` (bool) are the (K, M)
    slot-major block; ``outcome`` (bool, M); ``touched_offsets`` (int64,
    M + 1) and ``num_touched`` as :func:`touched_layout` gives them; ``now0``
    the first step's day relative to the store's epoch. Every masked slot
    must own a distinct row below the state's length.

    On CUDA tensors it launches the kernel, which updates the flat state IN
    PLACE: the returned state tensors are the ones passed in. On CPU
    tensors it runs :func:`settle_cycles_reference` and returns new ones.
    Either way the caller must use the returned state.

    ``routes``, an int32 (3,) tensor on the state's CUDA device, asks the
    launch for its route report: it adds its tiles of 256 markets that were
    staged to ``routes[0]`` and those that took the wide route to
    ``routes[1]``, and writes the stage's size in slots to ``routes[2]``.
    The CPU path has no tiles and leaves it as it is.
    """
    global LAUNCHES
    if rel.device.type == "cpu":
        return settle_cycles_reference(
            rel, conf, days, exists, slot_rows, probs, mask, outcome,
            touched_offsets, num_touched, now0, steps,
        )
    if rel.device.type != "cuda":
        raise ValueError(f"settle_cycles runs on cuda or cpu, not {rel.device}")
    dtype = rel.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported state dtype {dtype}")
    if steps < 0:
        raise ValueError(f"steps={steps} must be >= 0")
    device = rel.device
    capacity = rel.shape[0]
    if slot_rows.dim() != 2:
        raise ValueError("slot_rows must be (K, M)")
    num_slots, num_markets = slot_rows.shape
    check_tensor("rel", rel, dtype, (capacity,), device)
    check_tensor("conf", conf, dtype, (capacity,), device)
    check_tensor("days", days, dtype, (capacity,), device)
    check_tensor("exists", exists, torch.bool, (capacity,), device)
    check_tensor("slot_rows", slot_rows, torch.int32, (num_slots, num_markets), device)
    check_tensor("probs", probs, dtype, (num_slots, num_markets), device)
    check_tensor("mask", mask, torch.bool, (num_slots, num_markets), device)
    check_tensor("outcome", outcome, torch.bool, (num_markets,), device)
    check_tensor(
        "touched_offsets", touched_offsets, torch.int64, (num_markets + 1,),
        device,
    )
    if routes is not None:
        check_tensor("routes", routes, torch.int32, (3,), device)

    consensus = torch.empty(num_markets, dtype=dtype, device=device)
    rel_touched = torch.empty(num_touched, dtype=dtype, device=device)
    if num_markets == 0:
        return SettleOutputs(rel, conf, days, exists, consensus, rel_touched)

    lib = _load()
    fn = lib.settle_cycles_f32 if dtype == torch.float32 else lib.settle_cycles_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = fn(
            slot_rows.data_ptr(), probs.data_ptr(), mask.data_ptr(),
            outcome.data_ptr(), touched_offsets.data_ptr(), rel.data_ptr(),
            conf.data_ptr(), days.data_ptr(), exists.data_ptr(),
            consensus.data_ptr(), rel_touched.data_ptr(), float(now0),
            num_slots, num_markets, int(num_touched), int(steps),
            None if routes is None else routes.data_ptr(), stream,
        )
    if status != 0:
        raise RuntimeError(f"settle_cycles launch failed: CUDA error {status}")
    LAUNCHES += 1
    return SettleOutputs(rel, conf, days, exists, consensus, rel_touched)


class LaneOutputs(NamedTuple):
    reliability: torch.Tensor   # (C, R) stacked flat state after the settle
    confidence: torch.Tensor
    updated_days: torch.Tensor
    exists: torch.Tensor
    consensus: torch.Tensor     # (C, M) each lane's last step; NaN at zero weight


def lane_params(row: torch.Tensor, dtype: torch.dtype) -> CycleParams:
    """One lane's ``CycleParams`` from its (5,) float32 row of a params
    tensor: 0-d tensors of *dtype* on the row's device, each value taken
    from float32 as it is (as the JAX package's lane math widens its
    float32 lane scalars)."""
    return CycleParams(*(row[i].to(dtype) for i in range(len(PARAM_FIELDS))))


def settle_cycles_lanes_reference(
    rel, conf, days, exists, slot_rows, probs, mask, outcome,
    touched_offsets, num_touched: int, now0: float, steps: int, params,
) -> LaneOutputs:
    """The plain version of :func:`settle_cycles_lanes`: for each lane,
    :func:`settle_cycles_reference` on its state row with
    :func:`lane_params` of its params row, its consensus added in slot
    order as the lane kernel adds it. Functional."""
    outputs = [
        settle_cycles_reference(
            rel[c], conf[c], days[c], exists[c], slot_rows, probs, mask,
            outcome, touched_offsets, num_touched, now0, steps,
            params=lane_params(params[c], rel.dtype), ordered=True,
        )
        for c in range(rel.shape[0])
    ]
    return LaneOutputs(*(
        torch.stack([out[field] for out in outputs]) for field in range(5)
    ))


@annotate("bce.settle_cycles_lanes")
def settle_cycles_lanes(
    rel, conf, days, exists, slot_rows, probs, mask, outcome,
    touched_offsets, num_touched: int, now0: float, steps: int, params,
    *, routes: Optional[torch.Tensor] = None,
) -> LaneOutputs:
    """Settle a plan block against C stacked copies of the flat state, each
    lane with its own cycle rates, in one launch.

    ``rel``, ``conf``, ``days`` (the working dtype) and ``exists`` (bool)
    are (C, R) and contiguous, one lane a row; ``params`` is a (C, 5)
    float32 tensor whose columns are :data:`PARAM_FIELDS`; the plan
    arguments, ``now0`` and ``steps`` are :func:`settle_cycles`' and are
    shared by every lane. Every lane's masked slots must own distinct rows
    below R.

    On CUDA tensors it launches the kernel once for all lanes, which
    updates the stacked state IN PLACE and writes each lane's last-step
    consensus, (C, M); ``routes`` is :func:`settle_cycles`' route report,
    its tiles summed over the lanes. An int32 (:data:`LANE_ROUTE_SLOTS`,)
    tensor also receives the tiles, summed over the lanes, that a block
    settled for a group of lanes through one read of the plan (those whose
    markets lie in row order) in ``routes[3]``, the shared bytes a block was
    launched with in ``routes[4]`` and the most lanes such a group takes in
    ``routes[5]``. On CPU tensors it runs
    :func:`settle_cycles_lanes_reference` and returns new state. Either
    way the caller must use the returned state.
    """
    global LANE_LAUNCHES
    if rel.device.type == "cpu":
        return settle_cycles_lanes_reference(
            rel, conf, days, exists, slot_rows, probs, mask, outcome,
            touched_offsets, num_touched, now0, steps, params,
        )
    if rel.device.type != "cuda":
        raise ValueError(
            f"settle_cycles_lanes runs on cuda or cpu, not {rel.device}"
        )
    dtype = rel.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported state dtype {dtype}")
    if steps < 0:
        raise ValueError(f"steps={steps} must be >= 0")
    if rel.dim() != 2 or slot_rows.dim() != 2:
        raise ValueError("the state must be (C, R) and slot_rows (K, M)")
    device = rel.device
    num_lanes, capacity = rel.shape
    if num_lanes > MAX_LANES:
        raise ValueError(f"{num_lanes} lanes: one launch takes {MAX_LANES}")
    num_slots, num_markets = slot_rows.shape
    lanes = (num_lanes, capacity)
    check_tensor("rel", rel, dtype, lanes, device)
    check_tensor("conf", conf, dtype, lanes, device)
    check_tensor("days", days, dtype, lanes, device)
    check_tensor("exists", exists, torch.bool, lanes, device)
    check_tensor("params", params, torch.float32,
                 (num_lanes, len(PARAM_FIELDS)), device)
    check_tensor("slot_rows", slot_rows, torch.int32, (num_slots, num_markets), device)
    check_tensor("probs", probs, dtype, (num_slots, num_markets), device)
    check_tensor("mask", mask, torch.bool, (num_slots, num_markets), device)
    check_tensor("outcome", outcome, torch.bool, (num_markets,), device)
    check_tensor(
        "touched_offsets", touched_offsets, torch.int64, (num_markets + 1,),
        device,
    )
    if routes is not None:
        check_tensor("routes", routes, torch.int32,
                     (LANE_ROUTE_SLOTS if routes.numel() == LANE_ROUTE_SLOTS
                      else 3,), device)

    consensus = torch.empty((num_lanes, num_markets), dtype=dtype, device=device)
    if num_markets == 0 or num_lanes == 0:
        return LaneOutputs(rel, conf, days, exists, consensus)

    lib = _load()
    fn = (lib.settle_cycles_lanes_f32 if dtype == torch.float32
          else lib.settle_cycles_lanes_f64)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = fn(
            slot_rows.data_ptr(), probs.data_ptr(), mask.data_ptr(),
            outcome.data_ptr(), touched_offsets.data_ptr(), rel.data_ptr(),
            conf.data_ptr(), days.data_ptr(), exists.data_ptr(),
            params.data_ptr(), consensus.data_ptr(), float(now0),
            num_slots, num_markets, int(num_touched), num_lanes, capacity,
            int(steps), 0 if routes is None else routes.numel(),
            None if routes is None else routes.data_ptr(), stream,
        )
    if status != 0:
        raise RuntimeError(
            f"settle_cycles_lanes launch failed: CUDA error {status}"
        )
    LANE_LAUNCHES += 1
    return LaneOutputs(rel, conf, days, exists, consensus)


def bound_bytes(
    num_slots: int, num_markets: int, num_touched: int, num_existing: int,
    steps: int, itemsize: int,
) -> int:
    """Device-memory bytes one settle must move on these inputs: each byte
    the kernel needs read once and each output written once.

    ``num_touched`` counts the masked slots (each owns one row) and
    ``num_existing`` those whose row already exists: only those rows'
    reliability and confidence (and, when ``steps == 1``, stamp) are read.
    The mask is read for every plan slot, the row index and probability
    only for masked ones.
    """
    mask = num_slots * num_markets
    rel_touched = num_touched * itemsize
    if steps == 0:
        # Row index and stored reliability in, rel_touched and a zero
        # consensus out; offsets per market.
        return (
            mask + num_touched * (4 + itemsize) + rel_touched
            + num_markets * (8 + itemsize)
        )
    slots = num_touched * (4 + itemsize + 1)  # row index, probability, exists
    markets = num_markets * (1 + 8 + itemsize)  # outcome, offset, consensus
    state_reads = num_existing * itemsize * (3 if steps == 1 else 2)
    state_writes = num_touched * 3 * itemsize + (num_touched - num_existing)
    return mask + slots + markets + state_reads + state_writes + rel_touched


def lanes_bound_bytes(
    num_lanes: int, num_slots: int, num_markets: int, num_touched: int,
    lane_existing: "list[int]", steps: int, itemsize: int,
) -> int:
    """Device-memory bytes one :func:`settle_cycles_lanes` launch must move:
    each lane's state reads and writes and its consensus, as
    :func:`bound_bytes` counts them for one settle (``lane_existing[c]``
    masked slots of lane c whose row exists), without ``rel_touched``;
    the shared plan (mask, row indices, probabilities, outcomes, offsets)
    once, and the (C, 5) float32 params."""
    plan = (
        num_slots * num_markets  # the mask
        + num_touched * (4 + itemsize)  # row index, probability
        + num_markets * (1 + 8)  # outcome, offset
    )
    total = plan + num_lanes * 5 * 4
    for existing in lane_existing:
        total += num_markets * itemsize  # the lane's consensus
        if steps == 0:
            continue
        total += num_touched  # each slot's row exists byte
        total += existing * itemsize * (3 if steps == 1 else 2)
        total += num_touched * 3 * itemsize + (num_touched - existing)
    return total
