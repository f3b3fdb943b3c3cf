"""Namespace-aware reliability with a market → domain → global fallback chain.

A copy of ``bayesian_consensus_engine_tpu/state/namespaced.py``: domain
scores live under the synthetic market id ``"__domain__:{domain}"``, global
ones under ``"__global__"``; presence is "``updated_at`` non-empty";
``update_reliability(..., update_global=True)`` writes both.

The wrapper composes over any :class:`~.sqlite_store.ReliabilityStore`
with the record API — the port's SQLite store or its device-tensor store —
and ``set_global_reliability`` goes through the store's own ``put_record``.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional, Protocol, runtime_checkable

from bayesian_consensus_engine_tpu_torch.utils.config import (
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
)
from bayesian_consensus_engine_tpu_torch.state.records import ReliabilityRecord
from bayesian_consensus_engine_tpu_torch.state.sqlite_store import (
    ReliabilityStore,
    SQLiteReliabilityStore,
)
from bayesian_consensus_engine_tpu_torch.utils.timeconv import utc_now_iso

GLOBAL_MARKET_ID = "__global__"
_DOMAIN_PREFIX = "__domain__:"


class ReliabilityNamespace(str, Enum):
    """Specificity levels, most → least: MARKET, DOMAIN, GLOBAL."""

    GLOBAL = "global"
    DOMAIN = "domain"
    MARKET = "market"


@dataclass(frozen=True)
class NamespacedReliabilityRecord:
    """A reliability value plus which namespace level produced it."""

    source_id: str
    namespace: ReliabilityNamespace
    namespace_value: str
    reliability: float
    confidence: float
    updated_at: str
    is_fallback: bool


@runtime_checkable
class ReliabilityProvider(Protocol):
    """Pluggable provider interface for namespace-level reliability data.

    Declared for API parity (the reference declares but never implements
    it); :class:`NamespacedReliabilityStore` satisfies it.
    """

    def get_reliability(
        self,
        source_id: str,
        namespace: ReliabilityNamespace,
        namespace_value: str,
    ) -> Optional[NamespacedReliabilityRecord]: ...

    def update_reliability(
        self,
        source_id: str,
        namespace: ReliabilityNamespace,
        namespace_value: str,
        outcome_correct: bool,
    ) -> NamespacedReliabilityRecord: ...


def domain_market_id(domain: str) -> str:
    """Synthetic market id a domain's scores are stored under."""
    return f"{_DOMAIN_PREFIX}{domain}"


class NamespacedReliabilityStore:
    """Fallback-chain wrapper: market → domain → global → cold-start.

    GLOBAL_MARKET_ID is exposed as a class attribute, as in the JAX package.
    """

    GLOBAL_MARKET_ID = GLOBAL_MARKET_ID

    def __init__(
        self,
        db_path: str = ":memory:",
        store: Optional[ReliabilityStore] = None,
    ):
        """Wrap an existing store, or open a SQLite store at *db_path*."""
        self._store: ReliabilityStore = store if store is not None else (
            SQLiteReliabilityStore(db_path)
        )

    @property
    def backing_store(self) -> ReliabilityStore:
        return self._store

    def _lookup(
        self,
        source_id: str,
        market_id: str,
        namespace: ReliabilityNamespace,
        namespace_value: str,
        is_fallback: bool,
        apply_decay: bool,
    ) -> Optional[NamespacedReliabilityRecord]:
        record = self._store.get_reliability(source_id, market_id, apply_decay)
        if not record.updated_at:  # cold-start sentinel → not present
            return None
        return NamespacedReliabilityRecord(
            source_id=source_id,
            namespace=namespace,
            namespace_value=namespace_value,
            reliability=record.reliability,
            confidence=record.confidence,
            updated_at=record.updated_at,
            is_fallback=is_fallback,
        )

    def get_reliability(
        self,
        source_id: str,
        market_id: Optional[str] = None,
        domain: Optional[str] = None,
        apply_decay: bool = True,
    ) -> NamespacedReliabilityRecord:
        """Walk the fallback chain; always returns a record (cold-start last)."""
        if market_id:
            found = self._lookup(
                source_id, market_id,
                ReliabilityNamespace.MARKET, market_id,
                is_fallback=False, apply_decay=apply_decay,
            )
            if found:
                return found

        if domain:
            found = self._lookup(
                source_id, domain_market_id(domain),
                ReliabilityNamespace.DOMAIN, domain,
                is_fallback=True, apply_decay=apply_decay,
            )
            if found:
                return found

        found = self._lookup(
            source_id, GLOBAL_MARKET_ID,
            ReliabilityNamespace.GLOBAL, "global",
            is_fallback=True, apply_decay=apply_decay,
        )
        if found:
            return found

        return NamespacedReliabilityRecord(
            source_id=source_id,
            namespace=ReliabilityNamespace.GLOBAL,
            namespace_value="cold-start",
            reliability=DEFAULT_RELIABILITY,
            confidence=DEFAULT_CONFIDENCE,
            updated_at="",
            is_fallback=True,
        )

    def update_reliability(
        self,
        source_id: str,
        outcome_correct: bool,
        market_id: Optional[str] = None,
        domain: Optional[str] = None,
        update_global: bool = False,
    ) -> NamespacedReliabilityRecord:
        """Update the most specific namespace given; optionally also global."""
        if market_id:
            namespace, namespace_value, target = (
                ReliabilityNamespace.MARKET, market_id, market_id
            )
        elif domain:
            namespace, namespace_value, target = (
                ReliabilityNamespace.DOMAIN, domain, domain_market_id(domain)
            )
        else:
            namespace, namespace_value, target = (
                ReliabilityNamespace.GLOBAL, "global", GLOBAL_MARKET_ID
            )

        record = self._store.update_reliability(source_id, target, outcome_correct)
        if update_global and namespace != ReliabilityNamespace.GLOBAL:
            self._store.update_reliability(source_id, GLOBAL_MARKET_ID, outcome_correct)

        return NamespacedReliabilityRecord(
            source_id=source_id,
            namespace=namespace,
            namespace_value=namespace_value,
            reliability=record.reliability,
            confidence=record.confidence,
            updated_at=record.updated_at,
            is_fallback=False,
        )

    def set_global_reliability(
        self,
        source_id: str,
        reliability: float,
        confidence: float,
    ) -> NamespacedReliabilityRecord:
        """Seed a source's global score directly (pre-outcome priors)."""
        now = utc_now_iso()
        record = ReliabilityRecord(
            source_id=source_id,
            market_id=GLOBAL_MARKET_ID,
            reliability=reliability,
            confidence=confidence,
            updated_at=now,
        )
        put = getattr(self._store, "put_record", None)
        if put is None:
            raise TypeError(
                f"{type(self._store).__name__} does not support direct seeding"
            )
        put(record)
        return NamespacedReliabilityRecord(
            source_id=source_id,
            namespace=ReliabilityNamespace.GLOBAL,
            namespace_value="global",
            reliability=reliability,
            confidence=confidence,
            updated_at=now,
            is_fallback=False,
        )

    def close(self) -> None:
        self._store.close()

    def __enter__(self) -> "NamespacedReliabilityStore":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()
