"""Reliability state layer of the port: the SQLite checkpoint backend, the
device-tensor store, the namespaced fallback wrapper, and the shared scalar
decay/update math."""

from bayesian_consensus_engine_tpu_torch.state.records import ReliabilityRecord
from bayesian_consensus_engine_tpu_torch.state.sqlite_store import (
    ReliabilityStore,
    SQLiteReliabilityStore,
)
from bayesian_consensus_engine_tpu_torch.state.namespaced import (
    GLOBAL_MARKET_ID,
    NamespacedReliabilityRecord,
    NamespacedReliabilityStore,
    ReliabilityNamespace,
    ReliabilityProvider,
    domain_market_id,
)

__all__ = [
    "GLOBAL_MARKET_ID",
    "NamespacedReliabilityRecord",
    "NamespacedReliabilityStore",
    "ReliabilityNamespace",
    "ReliabilityProvider",
    "ReliabilityRecord",
    "ReliabilityStore",
    "SQLiteReliabilityStore",
    "domain_market_id",
]
