"""Half-life decay of reliability scores — scalar reference-semantics path.

Behavioural parity with the reference decay module
(reference: src/bayesian_engine/decay.py:31-185):

    factor(t)  = 2^(-t / half_life)                      (1.0 when t <= 0)
    decayed(r) = clamp(floor + (r - floor) * factor, floor, 1)

Decay is a *read-time* transform: stored reliability stays undecayed, and
post-outcome updates apply to the undecayed value (reference:
reliability.py:161) — the store and the settle kernel both preserve this.

The vectorised torch twin of this math lives in ``ops.decay``; this module
is stdlib-only so the storage layer never pays a torch import.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Union

from bayesian_consensus_engine_tpu_torch.utils.config import (
    DECAY_HALF_LIFE_DAYS,
    DECAY_MINIMUM,
)

_SECONDS_PER_DAY = 86400.0

TimestampLike = Union[str, datetime, None]


def compute_decay_factor(
    elapsed_days: float,
    half_life_days: float = DECAY_HALF_LIFE_DAYS,
) -> float:
    """Fraction of the (reliability − floor) range preserved after *elapsed_days*.

    1.0 for non-positive elapsed time; 0.5 after one half-life; 0.25 after two.
    """
    if elapsed_days <= 0:
        return 1.0
    return 2.0 ** (-elapsed_days / half_life_days)


def apply_reliability_decay(
    current_reliability: float,
    elapsed_days: float,
    half_life_days: float = DECAY_HALF_LIFE_DAYS,
    min_reliability: float = DECAY_MINIMUM,
) -> float:
    """Decay *current_reliability* toward the floor; clamp to [floor, 1]."""
    if elapsed_days <= 0:
        return current_reliability
    factor = compute_decay_factor(elapsed_days, half_life_days)
    decayed = min_reliability + (current_reliability - min_reliability) * factor
    return max(min_reliability, min(1.0, decayed))


def days_since_update(
    last_updated_at: TimestampLike,
    now: datetime | None = None,
) -> float:
    """Elapsed days between an ISO timestamp (or datetime) and *now*.

    Returns 0.0 for None/empty/unparseable timestamps (treated as "never
    updated", reference: decay.py:122-131); naive datetimes are assumed UTC;
    negative elapsed time clamps to 0.
    """
    if not last_updated_at:
        return 0.0

    if isinstance(last_updated_at, str):
        try:
            stamp = datetime.fromisoformat(last_updated_at)
        except ValueError:
            return 0.0
    else:
        stamp = last_updated_at

    if now is None:
        now = datetime.now(timezone.utc)
    if stamp.tzinfo is None:
        stamp = stamp.replace(tzinfo=timezone.utc)

    return max(0.0, (now - stamp).total_seconds() / _SECONDS_PER_DAY)


def decay_reliability_if_needed(
    current_reliability: float,
    last_updated_at: TimestampLike,
    now: datetime | None = None,
    half_life_days: float = DECAY_HALF_LIFE_DAYS,
    min_reliability: float = DECAY_MINIMUM,
) -> tuple[float, bool]:
    """Combined elapsed-time + decay helper → ``(value, was_decayed)``."""
    elapsed = days_since_update(last_updated_at, now)
    if elapsed <= 0:
        return current_reliability, False
    decayed = apply_reliability_decay(
        current_reliability, elapsed, half_life_days, min_reliability
    )
    return decayed, decayed != current_reliability
