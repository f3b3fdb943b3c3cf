"""Post-outcome update math, shared by every store backend.

One scalar implementation (here) and one vectorised torch implementation
(``ops.update``) of the same contract (reference: reliability.py:142-183):

    delta          = clip(base_lr * direction, ±max_step)
    reliability'   = clamp(reliability + delta, 0, 1)
    confidence'    = min(1, confidence + (1 - confidence) * growth)

The update reads the *undecayed* stored reliability — decay is applied only
on reads that ask for it (reference quirk #9, preserved).
"""

from __future__ import annotations

from bayesian_consensus_engine_tpu_torch.utils.config import (
    BASE_LEARNING_RATE,
    CONFIDENCE_GROWTH_RATE,
    MAX_UPDATE_STEP,
)


def apply_outcome(
    reliability: float,
    confidence: float,
    outcome_correct: bool,
) -> tuple[float, float]:
    """Return ``(new_reliability, new_confidence)`` after one outcome."""
    direction = 1.0 if outcome_correct else -1.0
    raw_delta = BASE_LEARNING_RATE * direction
    delta = max(-MAX_UPDATE_STEP, min(MAX_UPDATE_STEP, raw_delta))
    new_reliability = max(0.0, min(1.0, reliability + delta))
    new_confidence = min(1.0, confidence + (1.0 - confidence) * CONFIDENCE_GROWTH_RATE)
    return new_reliability, new_confidence


def apply_outcome_batch(reliability, confidence, correct):
    """Vectorised (numpy) twin of :func:`apply_outcome` over arrays.

    Same formula, elementwise; used by the tensor store's batch update. The
    torch twin for device code is ``ops.update.outcome_update``.
    """
    import numpy as np

    delta = np.clip(
        BASE_LEARNING_RATE * np.where(np.asarray(correct, dtype=bool), 1.0, -1.0),
        -MAX_UPDATE_STEP,
        MAX_UPDATE_STEP,
    )
    new_reliability = np.clip(reliability + delta, 0.0, 1.0)
    new_confidence = np.minimum(
        1.0, confidence + (1.0 - confidence) * CONFIDENCE_GROWTH_RATE
    )
    return new_reliability, new_confidence
