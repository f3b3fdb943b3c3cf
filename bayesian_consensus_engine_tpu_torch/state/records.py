"""Value types shared by every reliability store implementation."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ReliabilityRecord:
    """Immutable snapshot of one (source, market) reliability entry.

    ``updated_at`` is an ISO-8601 UTC string; empty string means the record
    was never persisted (cold-start sentinel — reference:
    reliability.py:133-140 and test_reliability.py:53).
    """

    source_id: str
    market_id: str
    reliability: float
    confidence: float
    updated_at: str
