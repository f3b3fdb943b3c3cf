"""Vectorised half-life decay — the torch twin of ``ops/decay.py``.

Same contract as the scalar path (``state.decay``):

    factor  = 2^(-elapsed / half_life)           (1 where elapsed <= 0)
    decayed = clamp(floor + (r - floor)·factor, floor, 1)

Decay is a pure read-time transform; the stored tensor stays undecayed.
Timestamps live on the device as float epoch-days relative to the store's
epoch, so "elapsed days" is one subtract. The operations run in the order
the JAX package writes them, each rounded in the tensor's dtype. The
division by the half-life is a multiplication by its reciprocal, rounded
to the dtype: that is what XLA compiles ``-t / h`` into, what PyTorch's
CUDA division by a scalar does, and what the kernels do, so the decay's
argument is the same bits everywhere (PyTorch's CPU division would
otherwise round differently).

A half-life given as a tensor (a replay lane's, ``ops/cycle_math.py::
CycleParams``) is divided by, correctly rounded: XLA folds a division
into a reciprocal multiplication only for a constant, and the JAX
package's replay sweep traces the half-life (its compiled step holds a
``divide`` by it).
"""

from __future__ import annotations

import torch

from bayesian_consensus_engine_tpu_torch.utils.config import (
    DECAY_HALF_LIFE_DAYS,
    DECAY_MINIMUM,
)


def _decay_exponent(elapsed_days: torch.Tensor, half_life_days) -> torch.Tensor:
    """``-t / h``: a reciprocal multiplication for a constant half-life, a
    division by a tensor one (see the module docstring)."""
    if isinstance(half_life_days, torch.Tensor):
        return -elapsed_days / half_life_days
    return -elapsed_days * (1.0 / half_life_days)


def decay_factor(
    elapsed_days: torch.Tensor,
    half_life_days: float = DECAY_HALF_LIFE_DAYS,
) -> torch.Tensor:
    """Elementwise ``2^(-t/h)``, pinned to 1 for non-positive elapsed time."""
    factor = torch.exp2(_decay_exponent(elapsed_days, half_life_days))
    return torch.where(elapsed_days > 0, factor, 1.0)


def decayed_reliability(
    reliability: torch.Tensor,
    elapsed_days: torch.Tensor,
    half_life_days: float = DECAY_HALF_LIFE_DAYS,
    floor: float = DECAY_MINIMUM,
) -> torch.Tensor:
    """Elementwise decay toward *floor*, clamped to [floor, 1].

    Entries with non-positive elapsed time pass through UNCLAMPED, matching
    the scalar path's early return.
    """
    factor = torch.exp2(_decay_exponent(elapsed_days, half_life_days))
    decayed = floor + (reliability - floor) * factor
    clamped = torch.clamp_max(torch.clamp_min(decayed, floor), 1.0)
    return torch.where(elapsed_days > 0, clamped, reliability)


def decayed_reliability_at(
    reliability: torch.Tensor,
    updated_days: torch.Tensor,  # f[...] epoch-days of last update; <=0 ⇒ never
    now_days: torch.Tensor,      # 0-d or broadcastable epoch-days "now"
    exists,                      # bool[...] row-exists mask, or True
    half_life_days: float = DECAY_HALF_LIFE_DAYS,
    floor: float = DECAY_MINIMUM,
) -> torch.Tensor:
    """Read-time decay for store rows: rows that do not exist and rows with
    no timestamp are returned untouched (cold-start / never-updated)."""
    elapsed = torch.clamp_min(now_days - updated_days, 0.0)
    eligible = (updated_days > 0) & exists
    decayed = decayed_reliability(reliability, elapsed, half_life_days, floor)
    return torch.where(eligible, decayed, reliability)
