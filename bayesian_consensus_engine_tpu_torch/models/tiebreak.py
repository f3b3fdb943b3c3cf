"""Deterministic resolution of conflicting predictions.

A copy of ``bayesian_consensus_engine_tpu/models/tiebreak.py``. Resolution
hierarchy over prediction groups (rounded to ``precision``):
  1. weight density  = total_weight / count      (higher wins)
  2. max reliability within the group            (higher wins)
  3. smallest prediction value                   (deterministic tertiary)

Kept quirks of the reference: the tertiary rule is smallest-prediction
(not lexicographic source id), and ``tie_resolved_by`` reports
"weight_density" even when the decision fell to max_reliability.

This module stays stdlib-only; tie-breaking here is diagnostics-sized, not
the hot loop (the device tie-break of a settle is ``ops.tiebreak``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class TieBreakDiagnostics:
    """How a conflict was resolved, with per-group metrics."""

    method: str
    groups: Dict[float, Dict]
    selected_group: float
    tie_resolved_by: str
    confidence_variance: float


@dataclass
class AgentSignal:
    """One agent's prediction plus resolution metadata."""

    agent_id: str
    prediction: float
    confidence: float
    weight: float = 1.0
    reliability_score: float = 0.5

    def __post_init__(self) -> None:
        if not 0 <= self.confidence <= 1:
            raise ValueError(f"confidence must be in [0,1], got {self.confidence}")
        if not 0 <= self.reliability_score <= 1:
            raise ValueError(
                f"reliability_score must be in [0,1], got {self.reliability_score}"
            )


@dataclass
class _Group:
    members: List[AgentSignal] = field(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.members)

    @property
    def total_weight(self) -> float:
        return sum(a.weight for a in self.members)

    @property
    def weight_density(self) -> float:
        return self.total_weight / self.count

    @property
    def avg_confidence(self) -> float:
        return sum(a.confidence for a in self.members) / self.count

    @property
    def max_reliability(self) -> float:
        return max(a.reliability_score for a in self.members)


class DeterministicTieBreaker:
    """Resolve conflicting agent predictions with a fixed hierarchy."""

    def __init__(self, precision: int = 6):
        self.precision = precision

    def resolve(self, agents: List[AgentSignal]) -> Tuple[float, TieBreakDiagnostics]:
        """Pick the winning prediction; raise ``ValueError`` on empty input."""
        if not agents:
            raise ValueError("Cannot resolve tie with empty agent list")

        if len(agents) == 1:
            only = agents[0]
            return only.prediction, TieBreakDiagnostics(
                method="single_agent",
                groups={only.prediction: {"count": 1}},
                selected_group=only.prediction,
                tie_resolved_by="unanimous",
                confidence_variance=0.0,
            )

        groups: Dict[float, _Group] = {}
        for agent in agents:
            groups.setdefault(round(agent.prediction, self.precision), _Group()).members.append(
                agent
            )

        mean_conf = sum(a.confidence for a in agents) / len(agents)
        variance = sum((a.confidence - mean_conf) ** 2 for a in agents) / len(agents)

        # Hierarchy as one sort key; -prediction so that, descending, the
        # SMALLEST prediction wins the tertiary tie.
        ranked = sorted(
            groups.items(),
            key=lambda item: (item[1].weight_density, item[1].max_reliability, -item[0]),
            reverse=True,
        )
        winning_pred, winning = ranked[0]

        if len(ranked) == 1:
            resolved_by = "unanimous"
        else:
            runner_up = ranked[1][1]
            density_tied = winning.weight_density == runner_up.weight_density
            reliability_tied = winning.max_reliability == runner_up.max_reliability
            if density_tied and reliability_tied:
                resolved_by = "prediction_value_smallest"
            else:
                # Any non-full tie is labelled "weight_density", even when
                # the decision actually fell to max_reliability.
                resolved_by = "weight_density"

        diagnostics = TieBreakDiagnostics(
            method="prioritized_weight_density",
            groups={
                pred: {
                    "count": g.count,
                    "weight_density": round(g.weight_density, 4),
                    "avg_confidence": round(g.avg_confidence, 4),
                    "max_reliability": round(g.max_reliability, 4),
                }
                for pred, g in groups.items()
            },
            selected_group=winning_pred,
            tie_resolved_by=resolved_by,
            confidence_variance=round(variance, 6),
        )
        return winning_pred, diagnostics
