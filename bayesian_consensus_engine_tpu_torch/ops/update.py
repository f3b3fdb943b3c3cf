"""Vectorised post-outcome update — the torch twin of ``ops/update.py``.

Contract per element (``state.update_math``):

    delta        = clip(base_lr · direction, ±max_step)
    reliability' = clamp(reliability + delta, 0, 1)
    confidence'  = min(1, confidence + (1 - confidence)·growth)

Updates read the UNDECAYED stored values. The reliability update is one
add and a clamp in the working dtype, so it is bit-equal to the JAX
package's on any device. The confidence growth is one fused multiply-add
(``ops/fma.py``), as XLA computes it in the JAX package's fused settle
program.
"""

from __future__ import annotations

import torch

from bayesian_consensus_engine_tpu_torch.ops.fma import fma
from bayesian_consensus_engine_tpu_torch.utils.config import (
    BASE_LEARNING_RATE,
    CONFIDENCE_GROWTH_RATE,
    MAX_UPDATE_STEP,
)


def outcome_update(
    reliability: torch.Tensor,
    confidence: torch.Tensor,
    correct: torch.Tensor,       # bool[...]
    *,
    base_lr=BASE_LEARNING_RATE,
    max_step=MAX_UPDATE_STEP,
    confidence_growth=CONFIDENCE_GROWTH_RATE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Elementwise update for every entry; returns (reliability', confidence').

    The three rates are floats or 0-d tensors (a replay lane's
    ``CycleParams``), whose values the working dtype takes as they are."""
    direction = torch.where(correct, 1.0, -1.0).to(reliability.dtype)
    delta = torch.clamp(base_lr * direction, -max_step, max_step)
    new_rel = torch.clamp(reliability + delta, 0.0, 1.0)
    # c + (1 − c)·g as one fused multiply-add: XLA contracts it so in the
    # JAX package's fused settle program, and the kernels do the same.
    growth = torch.as_tensor(
        confidence_growth, dtype=confidence.dtype, device=confidence.device
    ).expand(confidence.shape)
    new_conf = torch.clamp_max(fma(confidence, 1.0 - confidence, growth), 1.0)
    return new_rel, new_conf


def masked_outcome_update(
    reliability: torch.Tensor,
    confidence: torch.Tensor,
    correct: torch.Tensor,       # bool[...] outcome direction per entry
    touched: torch.Tensor,       # bool[...] which entries get an outcome
    now_days: torch.Tensor,      # 0-d epoch-days to stamp touched rows with
    updated_days: torch.Tensor,  # f[...] existing stamps
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-tensor update applying outcomes only where ``touched``; the
    other entries pass through bit-identical.
    Returns (reliability', confidence', updated_days')."""
    new_rel, new_conf = outcome_update(reliability, confidence, correct)
    return (
        torch.where(touched, new_rel, reliability),
        torch.where(touched, new_conf, confidence),
        torch.where(touched, now_days, updated_days),
    )
