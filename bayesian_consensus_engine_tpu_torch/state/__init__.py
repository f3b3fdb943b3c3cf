"""Reliability state layer of the port: the SQLite checkpoint backend, the
device-tensor store, the durability journal, the snapshot of the cycle
state (``state/checkpoint.py``), the namespaced fallback wrapper, and the
shared scalar decay/update math."""

from bayesian_consensus_engine_tpu_torch.state.records import ReliabilityRecord
from bayesian_consensus_engine_tpu_torch.state.sqlite_store import (
    ReliabilityStore,
    SQLiteReliabilityStore,
)
from bayesian_consensus_engine_tpu_torch.state.decay import (
    apply_reliability_decay,
    compute_decay_factor,
    days_since_update,
    decay_reliability_if_needed,
)
from bayesian_consensus_engine_tpu_torch.state.namespaced import (
    GLOBAL_MARKET_ID,
    NamespacedReliabilityRecord,
    NamespacedReliabilityStore,
    ReliabilityNamespace,
    ReliabilityProvider,
    domain_market_id,
)
from bayesian_consensus_engine_tpu_torch.state.journal import (
    JournalWriter,
    compact_journal,
    replay_journal,
)

__all__ = [
    "GLOBAL_MARKET_ID",
    "JournalWriter",
    "NamespacedReliabilityRecord",
    "NamespacedReliabilityStore",
    "ReliabilityNamespace",
    "ReliabilityProvider",
    "ReliabilityRecord",
    "ReliabilityStore",
    "SQLiteReliabilityStore",
    "apply_reliability_decay",
    "compact_journal",
    "compute_decay_factor",
    "days_since_update",
    "decay_reliability_if_needed",
    "domain_market_id",
    "replay_journal",
]
