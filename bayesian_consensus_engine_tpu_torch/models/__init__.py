"""Domain models of the port: markets, cross-market aggregation,
tie-breaking."""

from bayesian_consensus_engine_tpu_torch.models.market import (
    CrossMarketAggregator,
    Market,
    MarketId,
    MarketStatus,
    MarketStore,
    SourcePerformance,
)
from bayesian_consensus_engine_tpu_torch.models.tiebreak import (
    AgentSignal,
    DeterministicTieBreaker,
    TieBreakDiagnostics,
)

__all__ = [
    "CrossMarketAggregator",
    "Market",
    "MarketId",
    "MarketStatus",
    "MarketStore",
    "SourcePerformance",
    "AgentSignal",
    "DeterministicTieBreaker",
    "TieBreakDiagnostics",
]
