"""The consensus + reliability-update cycle as plain tensor math.

The torch twin of ``ops/cycle_math.py``. One step runs, for every market in
the block at once:

  1. read-time decay of the reliability block          (elementwise)
  2. reliability-weighted consensus                    (reduce over slots)
  3. per-(source, market) outcome correctness          (elementwise)
  4. capped post-outcome update of the UNDECAYED state (elementwise)

These functions are the plain version of the settle kernel
(``ops/settle_kernel.py``): the CPU path and the tests run them, and the
kernel is held against them on the card. They follow the JAX functions
operation for operation, so the state they produce is bit-equal to the JAX
package's; only the consensus, whose weights pass through ``exp2`` and a
K-deep sum, carries a stated tolerance.

The JAX package's ``axis_name`` (a psum over a sharded sources axis)
becomes :func:`consensus_merge`: each sources shard's raw local sums
(:func:`_sums_cycle_math`, computed by the partials kernel) are summed over
the shards (``ops/collectives.psum``) and normalised once.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from bayesian_consensus_engine_tpu_torch.ops.decay import decayed_reliability_at
from bayesian_consensus_engine_tpu_torch.ops.update import outcome_update
from bayesian_consensus_engine_tpu_torch.ops.collectives import psum
from bayesian_consensus_engine_tpu_torch.utils.config import (
    BASE_LEARNING_RATE,
    CONFIDENCE_GROWTH_RATE,
    DECAY_HALF_LIFE_DAYS,
    DECAY_MINIMUM,
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
    MAX_UPDATE_STEP,
)


class CycleParams(NamedTuple):
    """The cycle's tunable scalars, defaulting to the module constants.

    Every function here takes ``params=None`` as "the constants, exactly
    as before": the main path's math, with the decay's division folded
    into a reciprocal multiplication. The counterfactual replay sweep
    (``replay/``) passes one lane's scalars instead, as 0-d tensors of the
    working dtype; then the decay divides by the half-life, as the JAX
    package's vmapped replay step does with its traced half-life (a
    ``divide`` in its compiled program), and the other rates enter the
    same operations as the constants do. ``confidence_growth`` is carried
    but not swept (the replay lab keeps the recorded rate).
    """

    half_life_days: "float | torch.Tensor" = DECAY_HALF_LIFE_DAYS
    decay_floor: "float | torch.Tensor" = DECAY_MINIMUM
    base_learning_rate: "float | torch.Tensor" = BASE_LEARNING_RATE
    max_update_step: "float | torch.Tensor" = MAX_UPDATE_STEP
    confidence_growth: "float | torch.Tensor" = CONFIDENCE_GROWTH_RATE


class MarketBlockState(NamedTuple):
    """Per-(slot, market) reliability state of one block.

    ``exists`` may be ``None`` inside the cycle loop: the mask is monotone
    (``exists | mask`` every step), so the loop tracks it outside the carry
    and promises that cold slots already hold the cold-start defaults.
    """

    reliability: torch.Tensor   # stored (undecayed) reliability
    confidence: torch.Tensor
    updated_days: torch.Tensor  # relative epoch-days of last update (0 ⇒ never)
    exists: Optional[torch.Tensor]  # bool row-exists mask


class CycleResult(NamedTuple):
    state: MarketBlockState
    consensus: torch.Tensor     # f[M] (NaN where total weight is 0)
    confidence: torch.Tensor    # f[M]
    total_weight: torch.Tensor  # f[M]


def _decay_params(params: Optional[CycleParams]) -> tuple:
    """``(half_life, floor)`` of *params*, or the constants."""
    rates = CycleParams() if params is None else params
    return rates.half_life_days, rates.decay_floor


def _update(update_base, read_conf, correct, params: Optional[CycleParams]):
    """``outcome_update`` with *params*' rates, or the constants."""
    rates = CycleParams() if params is None else params
    return outcome_update(
        update_base, read_conf, correct,
        base_lr=rates.base_learning_rate,
        max_step=rates.max_update_step,
        confidence_growth=rates.confidence_growth,
    )


def read_phase(
    state: MarketBlockState, now_days: torch.Tensor,
    params: Optional[CycleParams] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decay-on-read with cold-start defaults; returns (read_rel, read_conf)."""
    half_life, floor = _decay_params(params)
    if state.exists is None:
        read_rel = decayed_reliability_at(
            state.reliability, state.updated_days, now_days, True,
            half_life, floor,
        )
        read_conf = state.confidence
    else:
        stored = decayed_reliability_at(
            state.reliability, state.updated_days, now_days, state.exists,
            half_life, floor,
        )
        read_rel = torch.where(state.exists, stored, DEFAULT_RELIABILITY)
        read_conf = torch.where(state.exists, state.confidence, DEFAULT_CONFIDENCE)
    return read_rel, read_conf


def _slot_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over *dim* one slot at a time, in slot order from zero."""
    total = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        total = total + x.select(dim, i)
    return total


def consensus_local_sums(
    probs: torch.Tensor,
    mask: torch.Tensor,
    read_rel: torch.Tensor,
    read_conf: torch.Tensor,
    slots_axis: int,
    ordered: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three masked weighted sums over the slots axis:
    ``(total_weight, weighted_prob, weighted_conf)``. ``ordered`` adds the
    slots in slot order (the lane kernel's order) instead of
    ``torch.sum``'s."""
    reduce = (
        (lambda x: _slot_sum(x, slots_axis)) if ordered
        else (lambda x: torch.sum(x, dim=slots_axis))
    )
    w = torch.where(mask, read_rel, 0.0)
    total_weight = reduce(w)
    weighted_prob = reduce(torch.where(mask, probs, 0.0) * w)
    weighted_conf = reduce(torch.where(mask, read_conf, 0.0) * w)
    return total_weight, weighted_prob, weighted_conf


def consensus_reduce(
    probs: torch.Tensor,
    mask: torch.Tensor,
    read_rel: torch.Tensor,
    read_conf: torch.Tensor,
    slots_axis: int,
    ordered: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked weighted sums over the slots axis, normalised.
    Returns (consensus, confidence_out, total_weight)."""
    total_weight, weighted_prob, weighted_conf = consensus_local_sums(
        probs, mask, read_rel, read_conf, slots_axis, ordered
    )
    consensus, confidence_out = consensus_epilogue(
        total_weight, weighted_prob, weighted_conf
    )
    return consensus, confidence_out, total_weight


def consensus_epilogue(
    total_weight: torch.Tensor,
    weighted_prob: torch.Tensor,
    weighted_conf: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalise the weighted sums; NaN consensus when total weight is 0
    (the reference reports consensus ``None`` there)."""
    has_weight = total_weight != 0
    safe_total = torch.where(has_weight, total_weight, 1.0)
    consensus = torch.where(has_weight, weighted_prob / safe_total, math.nan)
    confidence_out = torch.where(has_weight, weighted_conf / safe_total, 0.0)
    return consensus, confidence_out


def consensus_merge(shard_sums, device) -> torch.Tensor:
    """The consensus over a sources-sharded axis: the shards' raw (3, M)
    sums (Σw, Σw·p, Σw·conf, one tensor per shard in mesh order) summed
    across the shards — three psums in that order, as the JAX package's
    ``consensus_reduce`` runs them — then :func:`consensus_epilogue`, on
    *device*."""
    total_weight, weighted_prob, weighted_conf = (
        psum([sums[row] for sums in shard_sums], device) for row in range(3)
    )
    consensus, _ = consensus_epilogue(total_weight, weighted_prob, weighted_conf)
    return consensus


def update_phase(
    probs: torch.Tensor,
    mask: torch.Tensor,
    outcome: torch.Tensor,
    state: MarketBlockState,
    read_conf: torch.Tensor,
    now_days: torch.Tensor,
    slots_axis: int = -1,
    params: Optional[CycleParams] = None,
) -> MarketBlockState:
    """Outcome correctness (predicted true iff p >= 0.5) + capped update on
    the UNDECAYED stored state. A cold slot updates from the cold-start
    prior; unmasked slots pass through bit-identical."""
    correct = (probs >= 0.5) == outcome.unsqueeze(slots_axis)
    if state.exists is None:
        update_base = state.reliability
    else:
        update_base = torch.where(
            state.exists, state.reliability, DEFAULT_RELIABILITY
        )
    updated_rel, updated_conf = _update(update_base, read_conf, correct, params)
    return MarketBlockState(
        reliability=torch.where(mask, updated_rel, state.reliability),
        confidence=torch.where(mask, updated_conf, state.confidence),
        updated_days=torch.where(mask, now_days, state.updated_days),
        exists=None if state.exists is None else state.exists | mask,
    )


def _cycle_math(
    probs: torch.Tensor,      # f[M, K] per-slot mean probability ((K, M) if slots_axis=0)
    mask: torch.Tensor,       # bool[M, K] slot has a signal
    outcome: torch.Tensor,    # bool[M] resolved market outcome
    state: MarketBlockState,
    now_days: torch.Tensor,   # 0-d, relative epoch-days
    slots_axis: int = -1,
    params: Optional[CycleParams] = None,
    ordered: bool = False,
) -> CycleResult:
    """The full cycle on one block; ``slots_axis=0`` is the slot-major
    (K, M) layout the settlement plan uses. ``params`` sets the rates;
    ``ordered`` adds the consensus slots in slot order
    (:func:`consensus_local_sums`). Each phase runs under the JAX
    package's ``bce.*`` label (``utils/profiling.py``)."""
    with record_function("bce.read_decay"):
        read_rel, read_conf = read_phase(state, now_days, params)
    with record_function("bce.consensus_reduce"):
        consensus, confidence_out, total_weight = consensus_reduce(
            probs, mask, read_rel, read_conf, slots_axis, ordered
        )
    with record_function("bce.outcome_update"):
        new_state = update_phase(
            probs, mask, outcome, state, read_conf, now_days, slots_axis,
            params,
        )
    return CycleResult(new_state, consensus, confidence_out, total_weight)


def _fast_cycle_math(
    probs: torch.Tensor,
    mask: torch.Tensor,
    outcome: torch.Tensor,
    reliability: torch.Tensor,
    confidence: torch.Tensor,
    now_days: torch.Tensor,   # 0-d: this step's day
    prev_now: torch.Tensor,   # 0-d: the previous step's day
    slots_axis: int = -1,
    params: Optional[CycleParams] = None,
    ordered: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One mid-loop cycle with the decay read driven by SCALAR time.

    Valid only inside the N-step loop after step 0: every masked slot was
    stamped ``prev_now`` by the previous step, so elapsed time and decay
    eligibility are the same scalars for the whole block. Unmasked slots
    see a wrong scalar elapsed, but their weights are zeroed before every
    reduction and their state passes through untouched.

    Returns ``(reliability', confidence', consensus)``.
    """
    with record_function("bce.read_decay"):
        stamps = prev_now.expand(reliability.shape)
        read_rel = decayed_reliability_at(
            reliability, stamps, now_days, True, *_decay_params(params)
        )
    with record_function("bce.consensus_reduce"):
        consensus, _, _ = consensus_reduce(
            probs, mask, read_rel, confidence, slots_axis, ordered
        )
    with record_function("bce.outcome_update"):
        correct = (probs >= 0.5) == outcome.unsqueeze(slots_axis)
        new_rel, new_conf = _update(reliability, confidence, correct, params)
        reliability = torch.where(mask, new_rel, reliability)
        confidence = torch.where(mask, new_conf, confidence)
    return reliability, confidence, consensus


def _sums_cycle_math(
    probs: torch.Tensor,
    mask: torch.Tensor,
    outcome: torch.Tensor,
    state: MarketBlockState,
    now_days: torch.Tensor,
    slots_axis: int = -1,
) -> CycleResult:
    """:func:`_cycle_math` with the consensus slot carrying the RAW local
    sums: the (3, M) stack Σw / Σw·p / Σw·conf of one sources shard, for
    :func:`consensus_merge` to sum across shards and normalise. Only
    ``.state`` and ``.consensus`` are meaningful."""
    with record_function("bce.read_decay"):
        read_rel, read_conf = read_phase(state, now_days)
    with record_function("bce.consensus_local_sums"):
        tw, wp, wc = consensus_local_sums(
            probs, mask, read_rel, read_conf, slots_axis
        )
    with record_function("bce.outcome_update"):
        new_state = update_phase(
            probs, mask, outcome, state, read_conf, now_days, slots_axis
        )
    return CycleResult(new_state, torch.stack([tw, wp, wc]), wc, tw)


def _sums_fast_cycle_math(
    probs: torch.Tensor,
    mask: torch.Tensor,
    outcome: torch.Tensor,
    reliability: torch.Tensor,
    confidence: torch.Tensor,
    now_days: torch.Tensor,
    prev_now: torch.Tensor,
    slots_axis: int = -1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_fast_cycle_math` returning the (3, M) raw local sums in
    place of the consensus: ``(reliability', confidence', sums)``."""
    with record_function("bce.read_decay"):
        stamps = prev_now.expand(reliability.shape)
        read_rel = decayed_reliability_at(reliability, stamps, now_days, True)
    with record_function("bce.consensus_local_sums"):
        sums = torch.stack(consensus_local_sums(
            probs, mask, read_rel, confidence, slots_axis
        ))
    with record_function("bce.outcome_update"):
        correct = (probs >= 0.5) == outcome.unsqueeze(slots_axis)
        new_rel, new_conf = outcome_update(reliability, confidence, correct)
        reliability = torch.where(mask, new_rel, reliability)
        confidence = torch.where(mask, new_conf, confidence)
    return reliability, confidence, sums


def run_fast_loop(state_carry, consensus0, fast_step, steps: int, now0):
    """The fast N-step scaffold: middle steps discard their consensus (it
    is unobservable); the last step's consensus is returned.

    ``fast_step(state_carry, now_i, prev_now) -> (state_carry, consensus)``.
    """
    if steps == 1:
        return state_carry, consensus0
    carry = state_carry
    for i in range(1, steps - 1):
        carry, _ = fast_step(carry, now0 + i, now0 + (i - 1))
    return fast_step(carry, now0 + (steps - 1), now0 + (steps - 2))


def make_loop_math(cycle_fn, steps: int, fast_cycle_fn=None):
    """The N-cycle loop scaffold.

    Returns ``loop_math(probs, mask, outcome, state, now0) ->
    (state', consensus)`` running ``steps`` cycles of
    ``cycle_fn(probs, mask, outcome, state, now_days) -> CycleResult``.

    ``exists`` is monotone under the fixed per-loop mask, so it stays out
    of the carry: cold slots are sanitised to the cold-start defaults once
    on entry, and slots that never existed and never signalled are
    restored bit-identical on exit — exactly as a chain of single cycles
    leaves them.

    ``fast_cycle_fn`` (optional, ``(probs, mask, outcome, rel, conf, now,
    prev_now) -> (rel', conf', consensus)``) additionally drops
    ``updated_days`` from the carry: step 0 runs ``cycle_fn`` against the
    real per-slot stamps, every later step decays by scalar time, and the
    stamp tensor is reconstructed once on exit as ``now0 + (steps - 1)``.
    """

    def loop_math(probs, mask, outcome, state, now0):
        if state.exists is None:
            sanitised = state
        else:
            sanitised = MarketBlockState(
                reliability=torch.where(
                    state.exists, state.reliability, DEFAULT_RELIABILITY
                ),
                confidence=torch.where(
                    state.exists, state.confidence, DEFAULT_CONFIDENCE
                ),
                updated_days=torch.where(state.exists, state.updated_days, 0.0),
                exists=None,
            )

        init_consensus = torch.zeros(
            outcome.shape[0], dtype=probs.dtype, device=probs.device
        )
        if steps == 0:
            return state, init_consensus

        if fast_cycle_fn is not None:
            first = cycle_fn(probs, mask, outcome, sanitised, now0 + 0)

            def fast_step(carry, now_i, prev_now):
                rel, conf, consensus = fast_cycle_fn(
                    probs, mask, outcome, carry[0], carry[1], now_i, prev_now
                )
                return (rel, conf), consensus

            (rel, conf), consensus = run_fast_loop(
                (first.state.reliability, first.state.confidence),
                first.consensus,
                fast_step,
                steps,
                now0,
            )
            # Chained cycles stamp masked slots with now0+i every step; the
            # final tensor is the last stamp, reconstructed in one pass.
            upd = torch.where(
                mask,
                (now0 + (steps - 1)).to(sanitised.updated_days.dtype),
                sanitised.updated_days,
            )
        else:
            rel, conf, upd = (
                sanitised.reliability,
                sanitised.confidence,
                sanitised.updated_days,
            )
            consensus = init_consensus
            for i in range(steps):
                result = cycle_fn(
                    probs, mask, outcome,
                    MarketBlockState(rel, conf, upd, None),
                    now0 + i,
                )
                st = result.state
                rel, conf, upd = st.reliability, st.confidence, st.updated_days
                consensus = result.consensus
        if state.exists is None:
            return MarketBlockState(rel, conf, upd, None), consensus
        keep = state.exists | mask
        return (
            MarketBlockState(
                reliability=torch.where(keep, rel, state.reliability),
                confidence=torch.where(keep, conf, state.confidence),
                updated_days=torch.where(keep, upd, state.updated_days),
                exists=keep,
            ),
            consensus,
        )

    return loop_math
