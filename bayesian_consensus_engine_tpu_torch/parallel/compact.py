"""Counter-compact settlement state — int8 and uint8 counters in place of
float tensors; the port of the JAX package's ``parallel/compact.py``.

The update math makes the stored state far more compressible than three
float32 tensors:

* the capped reliability delta is always exactly ±``MAX_UPDATE_STEP``
  (``clip(0.15·±1, ±0.10)``), and decay never touches the stored value,
  so a stored reliability that started at the 0.50 prior lives on the
  11-point lattice ``0.5 + 0.1·c``, ``c`` a ±5-saturating counter;
* confidence growth ``c' = c + (1−c)·0.10`` does not depend on the data,
  so the stored confidence is a function of the update count alone
  (``1 − 0.75·0.9ⁿ`` from the 0.25 prior), saturating in uint8 range.

So the loop state is one int8 and one uint8 a slot, plus the day stamps
(float32, or uint16 for integral days ≤ 65535: exact, 2 bytes a slot
less at rest).

Numeric contract, as in the reference: the decode computes ``0.5 + 0.1·c``
and ``1 − 0.75·2^(n·log₂0.9)`` in float32, equal to the float32 loop
within a few ulps; the counters and the stamps are exact. ``exp2`` rounds
differently on XLA, the CPU and the card, so decoded confidences agree
with the JAX package's within that bound, not bit for bit.

The JAX package compiles the loop with XLA (no Pallas kernel); the port
runs it as eager PyTorch. XLA fuses each step into one pass, where eager
operations would hold several full-block temporaries; so the port's loop
walks the markets axis in tiles of at most :data:`TILE_SLOTS` slots and
runs every step on one tile before the next, tiles a multiple of 128
markets wide. Markets are independent, so on the card no bit depends on
the tiling. (On the CPU, PyTorch's vectorised ``exp2`` and its scalar
tail loop round differently, so there a result can depend on where an
element falls in a contiguous run; whole 128-market tiles keep the runs
of a block whose width is a multiple of 128 as they are.)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from bayesian_consensus_engine_tpu_torch.ops.collectives import psum
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import (
    MarketBlockState,
    consensus_epilogue,
    consensus_local_sums,
)
from bayesian_consensus_engine_tpu_torch.ops.decay import decayed_reliability_at
from bayesian_consensus_engine_tpu_torch.parallel.mesh import MARKETS_AXIS, Mesh
from bayesian_consensus_engine_tpu_torch.utils.config import (
    BASE_LEARNING_RATE,
    CONFIDENCE_GROWTH_RATE,
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
    MAX_UPDATE_STEP,
)
from bayesian_consensus_engine_tpu_torch.utils.device import resolve_device

# The counter encoding holds only while every applied delta is exactly
# ±MAX_UPDATE_STEP and the priors sit on the step lattice: a change of the
# constants fails here, not as a distant equivalence-test difference.
_STEP = MAX_UPDATE_STEP
assert BASE_LEARNING_RATE >= MAX_UPDATE_STEP, (
    "compact counters assume the learning-rate cap always saturates: "
    "delta must be exactly ±MAX_UPDATE_STEP"
)
_STEPS_UP = round((1.0 - DEFAULT_RELIABILITY) / _STEP)      # counter → 1.0
_STEPS_DOWN = round(DEFAULT_RELIABILITY / _STEP)            # counter → 0.0
assert math.isclose(DEFAULT_RELIABILITY + _STEPS_UP * _STEP, 1.0), (
    "DEFAULT_RELIABILITY must sit on the MAX_UPDATE_STEP lattice"
)
assert math.isclose(DEFAULT_RELIABILITY - _STEPS_DOWN * _STEP, 0.0, abs_tol=1e-12)
# Confidence saturates to float32 1.0 long before the uint8 cap (~175).
_CONF_STEPS_MAX = 255
_CONF_COEFF = 1.0 - DEFAULT_CONFIDENCE
_LOG2_CONF_BASE = math.log2(1.0 - CONFIDENCE_GROWTH_RATE)
_U16_MAX = 65535

#: The most slots one tile of the eager loop covers (its temporaries are
#: a few float32 tensors of this many elements); a tile is a multiple of
#: :data:`TILE_MARKETS` markets wide, and at least that.
TILE_SLOTS = 1 << 26
TILE_MARKETS = 128


class CompactBlockState(NamedTuple):
    """Per-(slot, market) settlement state as saturating counters.

    Zero counters are the cold-start priors (0.50 / 0.25), so
    :func:`init_compact_state` is zeros, and "exists" is
    ``conf_steps > 0``: there is no separate mask.
    """

    rel_steps: torch.Tensor     # int8: net (correct − incorrect), clamped ±5
    conf_steps: torch.Tensor    # uint8: total updates, saturating at 255
    updated_days: torch.Tensor  # float32 or uint16: day of last update (0 ⇒ never)


def encode_probs_u16(probs: torch.Tensor) -> torch.Tensor:
    """Probabilities in [0, 1] → uint16 fixed point (nearest of 65,535
    steps; out-of-range inputs clip to [0, 1]).

    The loop on encoded probabilities equals the float32 loop on their
    decode bit for bit (the loop decodes inside each step); against the
    unencoded probabilities the consensus moves by at most the
    quantisation step, 0.5/65535.
    """
    scaled = torch.clamp(probs.to(torch.float32), 0.0, 1.0) * torch.tensor(
        np.float32(65535.0), device=probs.device)
    return torch.round(scaled).to(torch.int32).to(torch.uint16)


def _decode_probs(probs: torch.Tensor) -> torch.Tensor:
    """uint16 fixed point → float32 in [0, 1]; float inputs pass through."""
    if probs.dtype == torch.uint16:
        return probs.to(torch.float32) * torch.tensor(
            np.float32(1.0 / 65535.0), device=probs.device)
    return probs


def init_compact_state(
    num_markets: int,
    slots: int,
    slot_major: bool = True,
    days_dtype=torch.float32,
    device=None,
) -> CompactBlockState:
    """Zero (cold-start) counter state, ``(slots, num_markets)`` slot-major
    or ``(num_markets, slots)``, on *device* (``None``: CUDA).

    ``days_dtype=torch.uint16`` keeps the day stamps in 2 bytes a slot;
    the days must then be integral and in [0, 65535] (the conversion to
    float32 is exact there, so every read, decay and stamp is the
    float32-days state's bit for bit).
    """
    if days_dtype not in (torch.float32, torch.uint16):
        raise ValueError(
            f"days_dtype must be float32 or uint16, got {days_dtype!r}"
        )
    device = resolve_device(device)
    shape = (slots, num_markets) if slot_major else (num_markets, slots)
    return CompactBlockState(
        rel_steps=torch.zeros(shape, dtype=torch.int8, device=device),
        conf_steps=torch.zeros(shape, dtype=torch.uint8, device=device),
        updated_days=torch.zeros(shape, dtype=days_dtype, device=device),
    )


def decode_reliability(rel_steps: torch.Tensor) -> torch.Tensor:
    """Counter → stored (undecayed) float32 reliability on the lattice."""
    return torch.clamp(
        DEFAULT_RELIABILITY + _STEP * rel_steps.to(torch.float32), 0.0, 1.0
    )


def decode_confidence(conf_steps: torch.Tensor) -> torch.Tensor:
    """Update count → stored float32 confidence: ``1 − (1−prior)·
    (1−growth)ⁿ``, the closed form of ``c' = c + (1−c)·growth``."""
    n = conf_steps.to(torch.float32)
    return 1.0 - _CONF_COEFF * torch.exp2(n * _LOG2_CONF_BASE)


def compact_to_block(state: CompactBlockState) -> MarketBlockState:
    """Decode to the float32 block state (interop: absorb, tests)."""
    exists = state.conf_steps > 0
    return MarketBlockState(
        reliability=decode_reliability(state.rel_steps),
        confidence=torch.where(
            exists, decode_confidence(state.conf_steps), DEFAULT_CONFIDENCE
        ),
        updated_days=state.updated_days.to(torch.float32),
        exists=exists,
    )


def _counter_update(rel_steps, conf_steps, correct, mask):
    """The masked saturating counter bump: the whole outcome update."""
    bump = torch.where(correct, 1, -1).to(torch.int8)
    new_rel = torch.clamp(rel_steps + bump, -_STEPS_DOWN, _STEPS_UP).to(torch.int8)
    new_conf = torch.where(conf_steps < _CONF_STEPS_MAX, conf_steps + 1, conf_steps)
    return (
        torch.where(mask, new_rel, rel_steps),
        torch.where(mask, new_conf, conf_steps),
    )


def _stamp_updated_days(mask, now0, steps, updated_days):
    """The masked day stamp after N cycles, shared by the loop and the
    closed form. A uint16 stamp clips to [0, 65535] (past the horizon it
    saturates rather than wraps) and converts by truncation, exact on the
    integral domain."""
    stamp = now0 + (steps - 1)
    if updated_days.dtype == torch.uint16:
        stamp = torch.clamp(stamp, 0, _U16_MAX).to(torch.int32)
        return torch.where(mask, stamp, updated_days.to(torch.int32)).to(
            torch.uint16)
    return torch.where(mask, stamp.to(updated_days.dtype), updated_days)


def _tile_loop_math(probs, mask, outcome, state, now0, steps, slots_axis,
                    device):
    """``steps`` compact cycles on one markets tile: *probs*, *mask* and
    *state* are lists over the sources shards (one entry when nothing is
    sharded), *outcome* the tile's outcome on each shard's device. The
    consensus sums are added across the shards left to right in mesh order
    (``psum``) and normalised on *device*. Returns ``(states, consensus)``."""
    shards = range(len(probs))
    day0 = [torch.as_tensor(now0, dtype=torch.float32, device=p.device)
            for p in probs]
    decoded = [_decode_probs(p) for p in probs]
    correct = [
        (decoded[j] >= 0.5) == outcome[j].unsqueeze(slots_axis) for j in shards
    ]

    def cycle(rel_steps, conf_steps, read_rel):
        with record_function("bce.consensus_reduce"):
            sums = [
                torch.stack(consensus_local_sums(
                    decoded[j], mask[j], read_rel[j],
                    decode_confidence(conf_steps[j]), slots_axis,
                ))
                for j in shards
            ]
            total = sums[0].to(device) if len(sums) == 1 else torch.stack([
                psum([s[row] for s in sums], device) for row in range(3)
            ])
            consensus, _ = consensus_epilogue(*total)
        with record_function("bce.outcome_update"):
            bumped = [
                _counter_update(rel_steps[j], conf_steps[j], correct[j],
                                mask[j])
                for j in shards
            ]
        return [b[0] for b in bumped], [b[1] for b in bumped], consensus

    if steps == 0:
        dtype = torch.float32 if probs[0].dtype == torch.uint16 else probs[0].dtype
        return list(state), torch.zeros(
            outcome[0].shape[0], dtype=dtype, device=device)
    # Step 0 decays against the real per-slot stamps.
    with record_function("bce.read_decay"):
        read0 = [
            decayed_reliability_at(
                decode_reliability(st.rel_steps),
                st.updated_days.to(torch.float32), day0[j], st.conf_steps > 0,
            )
            for j, st in enumerate(state)
        ]
    rel, conf, consensus0 = cycle(
        [st.rel_steps for st in state], [st.conf_steps for st in state], read0)

    # Every later step decays by the scalar day: each masked slot was
    # stamped the previous step's day.
    consensus = consensus0
    for i in range(1, steps):
        with record_function("bce.read_decay"):
            read = [
                decayed_reliability_at(
                    decode_reliability(rel[j]),
                    (day0[j] + (i - 1)).expand(rel[j].shape), day0[j] + i,
                    True,
                )
                for j in shards
            ]
        rel, conf, consensus = cycle(rel, conf, read)
    return [
        CompactBlockState(rel[j], conf[j], _stamp_updated_days(
            mask[j], day0[j], steps, st.updated_days))
        for j, st in enumerate(state)
    ], consensus


def advance_counters(
    state: CompactBlockState,
    mask: torch.Tensor,
    correct: torch.Tensor,
    steps: int,
    now0,
) -> CompactBlockState:
    """N identical settlement cycles on counter state in one elementwise
    pass: the same saturating ±1 bump N times is one clamped jump of ±N,
    and the update count saturates at the cap, so it equals
    :func:`build_compact_cycle_loop` for *steps* exactly (integer state).
    ``correct`` is the per-slot outcome agreement (``(probs >= 0.5) ==
    outcome``, broadcast over slots). The consensus is a per-day read, not
    part of the state: compute it with one loop step at the day needed.
    """
    if steps <= 0:
        return state
    jump = torch.where(correct, steps, -steps).to(torch.int32)
    new_rel = torch.clamp(
        state.rel_steps.to(torch.int32) + jump, -_STEPS_DOWN, _STEPS_UP
    ).to(torch.int8)
    new_conf = torch.clamp_max(
        state.conf_steps.to(torch.int32) + steps, _CONF_STEPS_MAX
    ).to(torch.uint8)
    now0 = torch.as_tensor(now0, dtype=torch.float32, device=mask.device)
    return CompactBlockState(
        rel_steps=torch.where(mask, new_rel, state.rel_steps),
        conf_steps=torch.where(mask, new_conf, state.conf_steps),
        updated_days=_stamp_updated_days(mask, now0, steps, state.updated_days),
    )


def build_compact_cycle_loop(mesh: "Mesh | None" = None, slot_major: bool = True):
    """The N-cycle settlement loop over counter-compact state.

    ``loop(probs, mask, outcome, state, now0, steps) -> (CompactBlockState,
    consensus)``, the contract of ``parallel/sharded.build_cycle_loop`` with
    the state type swapped. ``probs`` float or uint16
    (:func:`encode_probs_u16`, decoded inside each step). Blocks are
    slot-major (K, M), or market-major (M, K) with ``slot_major=False``.

    ``mesh=None``: one block, on its own device. On a
    :class:`~.parallel.mesh.Mesh`: grids of per-shard blocks (slot-major
    as ``parallel/mesh.shard_slot_block`` cuts them, market-major as
    ``shard_block`` does), ``outcome`` a grid of per-shard vectors and
    ``state`` a grid of per-shard :class:`CompactBlockState`; the
    consensus sums are added over the sources shards left to right in mesh
    order, and the state comes back as a grid, the consensus whole on the
    mesh's first device.
    """
    slots_axis = 0 if slot_major else -1
    markets_dim = 1 if slot_major else 0

    def run_shard(probs, mask, outcome, state, now0, steps, device):
        """One markets shard's sources shards (lists), tile by tile."""
        num_markets = probs[0].shape[markets_dim]
        slots = max(1, probs[0].shape[1 - markets_dim])
        width = max(1, TILE_SLOTS // slots // TILE_MARKETS) * TILE_MARKETS
        if width >= num_markets:
            return _tile_loop_math(probs, mask, outcome, state, now0, steps,
                                   slots_axis, device)

        def cols(x, lo, hi):
            return x[:, lo:hi] if slot_major else x[lo:hi]

        out = [CompactBlockState(*(torch.empty_like(f) for f in st))
               for st in state]
        pieces = []
        for lo in range(0, num_markets, width):
            hi = min(lo + width, num_markets)
            tile_state, tile_consensus = _tile_loop_math(
                [cols(p, lo, hi) for p in probs],
                [cols(m, lo, hi) for m in mask],
                [o[lo:hi] for o in outcome],
                [CompactBlockState(*(cols(f, lo, hi) for f in st))
                 for st in state],
                now0, steps, slots_axis, device,
            )
            for whole, tile in zip(out, tile_state):
                for dst, src in zip(whole, tile):
                    cols(dst, lo, hi).copy_(src)
            pieces.append(tile_consensus)
        return out, torch.cat(pieces)

    def loop(probs, mask, outcome, state, now0, steps: int):
        steps = int(steps)
        if mesh is None:
            (new_state,), consensus = run_shard(
                [probs], [mask], [outcome], [state], now0, steps, probs.device)
            return new_state, consensus
        device = mesh.devices[0][0]
        states, consensus = [], []
        for i in range(mesh.shape[MARKETS_AXIS]):
            if probs[i][0].device != mesh.devices[i][0]:
                raise ValueError(
                    f"shard ({i}, 0) is on {probs[i][0].device}, the mesh "
                    f"places it on {mesh.devices[i][0]}"
                )
            shard_state, shard_consensus = run_shard(
                probs[i], mask[i], outcome[i], state[i], now0, steps,
                mesh.devices[i][0],
            )
            states.append(tuple(shard_state))
            consensus.append(shard_consensus.to(device))
        return tuple(states), (
            consensus[0] if len(consensus) == 1 else torch.cat(consensus))

    return loop
