"""Multi-market orchestration and cross-market analytics.

A copy of ``bayesian_consensus_engine_tpu/models/market.py``. Consensus can
be computed through any :class:`~..state.sqlite_store.ReliabilityStore`
implementation (the SQLite store or the device-tensor store), and
``compute_all_consensus`` routes the array backends (``"torch"``, and the
JAX package's names ``"jax"`` and ``"tpu"``) to the batched sweep in
``core.batch``: one device pass instead of a per-market Python loop.

Kept quirks of the reference: empty-market consensus returns a reduced
4-key document; nothing ever transitions a market to CLOSED; a source is
"correct" iff (probability >= 0.5) == outcome.
"""

from __future__ import annotations

import fnmatch
from collections import Counter
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np

from bayesian_consensus_engine_tpu_torch.core.engine import (
    check_backend,
    compute_consensus,
)
from bayesian_consensus_engine_tpu_torch.utils.interning import IdInterner
from bayesian_consensus_engine_tpu_torch.state.sqlite_store import ReliabilityStore
from bayesian_consensus_engine_tpu_torch.utils.timeconv import utc_now_iso
from bayesian_consensus_engine_tpu_torch.utils.config import SCHEMA_VERSION


@dataclass(frozen=True)
class MarketId:
    """Identifier for a market/question; supports ``cat:subcat:...`` structure."""

    value: str

    def __post_init__(self) -> None:
        if not self.value or not self.value.strip():
            raise ValueError("Market ID cannot be empty")

    def __str__(self) -> str:
        return self.value

    def __repr__(self) -> str:
        return f"MarketId({self.value!r})"

    @property
    def category(self) -> Optional[str]:
        """Leading segment of a ``cat:...`` id, else None."""
        return self.value.split(":")[0] if ":" in self.value else None

    @property
    def parts(self) -> List[str]:
        return self.value.split(":")

    def matches(self, pattern: str) -> bool:
        """Glob match (``crypto:*``, ``*:price``, exact ids)."""
        return fnmatch.fnmatch(self.value, pattern)


class MarketStatus(str, Enum):
    OPEN = "open"          # accepting signals
    CLOSED = "closed"      # no more signals, outcome pending
    RESOLVED = "resolved"  # outcome known


@dataclass
class Market:
    """One market: status, collected signals, optional resolved outcome."""

    id: MarketId
    status: MarketStatus = MarketStatus.OPEN
    signals: List[Dict[str, Any]] = field(default_factory=list)
    consensus_result: Optional[Dict[str, Any]] = None
    outcome: Optional[bool] = None
    created_at: str = field(default_factory=utc_now_iso)
    resolved_at: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    def add_signal(self, signal: Dict[str, Any]) -> None:
        if self.status != MarketStatus.OPEN:
            raise ValueError(f"Cannot add signal to {self.status} market")
        self.signals.append(signal)

    def compute_consensus(
        self,
        source_reliability: Optional[Dict[str, Dict[str, float]]] = None,
        backend: str = "python",
        device=None,
        dtype=None,
    ) -> Dict[str, Any]:
        """Consensus for this market, stamped with ``marketId``.

        Empty market → reduced 4-key document (no sourceWeights/normalization/
        diagnostics), unlike core's empty-signals shape. *backend*, *device*
        and *dtype* are ``core.engine.compute_consensus``'s.
        """
        if not self.signals:
            return {
                "schemaVersion": SCHEMA_VERSION,
                "consensus": None,
                "confidence": 0.0,
                "marketId": str(self.id),
            }
        result = compute_consensus(
            self.signals, source_reliability, backend=backend,
            device=device, dtype=dtype,
        )
        result["marketId"] = str(self.id)
        self.consensus_result = result
        return result

    def resolve(self, outcome: bool) -> None:
        self.outcome = outcome
        self.status = MarketStatus.RESOLVED
        self.resolved_at = utc_now_iso()


class MarketStore:
    """In-memory registry of markets keyed by id string."""

    def __init__(self) -> None:
        self._markets: Dict[str, Market] = {}

    def create_market(
        self,
        market_id: MarketId,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> Market:
        key = str(market_id)
        if key in self._markets:
            raise ValueError(f"Market {market_id} already exists")
        market = Market(id=market_id, metadata=metadata or {})
        self._markets[key] = market
        return market

    def get_market(self, market_id: MarketId) -> Optional[Market]:
        return self._markets.get(str(market_id))

    def get_or_create(self, market_id: MarketId) -> Market:
        return self.get_market(market_id) or self.create_market(market_id)

    def add_signal(self, market_id: MarketId, signal: Dict[str, Any]) -> Market:
        market = self.get_or_create(market_id)
        market.add_signal(signal)
        return market

    def list_markets(
        self,
        status: Optional[MarketStatus] = None,
        pattern: Optional[str] = None,
    ) -> List[Market]:
        markets = list(self._markets.values())
        if status is not None:
            markets = [m for m in markets if m.status == status]
        if pattern is not None:
            markets = [m for m in markets if m.id.matches(pattern)]
        return markets

    def compute_all_consensus(
        self,
        reliability_store: Optional[ReliabilityStore] = None,
        backend: str = "python",
        device=None,
        dtype=None,
    ) -> Dict[str, Dict[str, Any]]:
        """Consensus for every OPEN market (decayed reliability per source).

        An array backend (``"torch"``, ``"jax"`` or ``"tpu"``) routes the
        whole sweep through the batched engine — one device pass over a
        packed signal tensor, on *device* at *dtype* (CUDA and float32 by
        default) — instead of market-by-market scalar calls; results land in
        the same ``{market_id: document}`` mapping and are cached on each
        market either way.
        """
        check_backend(backend)
        if backend != "python":
            from bayesian_consensus_engine_tpu_torch.core.batch import (
                compute_all_consensus_batched,
            )

            return compute_all_consensus_batched(
                self, reliability_store, device=device, dtype=dtype
            )

        results: Dict[str, Dict[str, Any]] = {}
        for market in self.list_markets(status=MarketStatus.OPEN):
            table = (
                None
                if reliability_store is None
                else _decayed_reliability_table(
                    reliability_store, market.signals, str(market.id)
                )
            )
            results[str(market.id)] = market.compute_consensus(table)
        return results


def _decayed_reliability_table(
    store: ReliabilityStore, signals: List[Dict[str, Any]], market_id: str
) -> Dict[str, Dict[str, float]]:
    """Per-source decayed reliability for one market's signalling sources."""
    table: Dict[str, Dict[str, float]] = {}
    for signal in signals:
        sid = signal["sourceId"]
        if sid not in table:
            record = store.get_reliability(sid, market_id, apply_decay=True)
            table[sid] = {
                "reliability": record.reliability,
                "confidence": record.confidence,
            }
    return table


@dataclass
class SourcePerformance:
    """A source's aggregate track record across resolved markets."""

    source_id: str
    total_markets: int
    correct_predictions: int
    wrong_predictions: int
    reliability: float
    markets: List[str] = field(default_factory=list)

    @property
    def accuracy(self) -> float:
        total = self.correct_predictions + self.wrong_predictions
        return self.correct_predictions / total if total else 0.0


class CrossMarketAggregator:
    """Analytics across markets: source scorecards, category summaries,
    cross-market consensus aggregation."""

    def __init__(self, market_store: MarketStore):
        self._store = market_store

    def summarize_sources(
        self,
        patterns: Optional[List[str]] = None,
    ) -> Dict[str, SourcePerformance]:
        """Per-source accuracy over RESOLVED markets (optionally filtered).

        Columnar: all signals across all resolved markets flatten into
        (source row, probability, outcome) arrays once, correctness is one
        vectorised compare (predicted-true iff p ≥ 0.5), and per-source tallies are bincounts — no
        per-signal dict churn. Scorecards come out in first-seen source
        order, exactly like the sequential walk.
        """
        markets = [
            m
            for m in self._store.list_markets(status=MarketStatus.RESOLVED)
            if m.outcome is not None
            and (not patterns or any(m.id.matches(p) for p in patterns))
        ]
        market_ids = [str(m.id) for m in markets]

        sources = IdInterner()
        columns = [
            (sources.intern(sig["sourceId"]), sig.get("probability", 0.5), mi)
            for mi, market in enumerate(markets)
            for sig in market.signals
        ]
        if not columns:
            return {}
        src, prob, market_of = (np.asarray(c) for c in zip(*columns))
        outcome_of = np.asarray([m.outcome for m in markets], dtype=bool)
        correct = (prob.astype(np.float64) >= 0.5) == outcome_of[market_of]

        n = len(sources)
        total = np.bincount(src, minlength=n)
        n_correct = np.bincount(src, weights=correct, minlength=n).astype(np.int64)
        # Group signal rows by source, preserving original signal order
        # within each group (stable sort), for the per-source market lists.
        grouped = np.argsort(src, kind="stable")
        group_end = np.cumsum(total)

        summary: Dict[str, SourcePerformance] = {}
        for row in range(n):
            rows = grouped[group_end[row] - total[row]: group_end[row]]
            summary[sources.id_of(row)] = SourcePerformance(
                source_id=sources.id_of(row),
                total_markets=int(total[row]),
                correct_predictions=int(n_correct[row]),
                wrong_predictions=int(total[row] - n_correct[row]),
                reliability=(
                    float(n_correct[row] / total[row]) if total[row] else 0.5
                ),
                markets=[market_ids[mi] for mi in market_of[rows]],
            )
        return summary

    def summarize_category(self, category: str) -> Dict[str, Any]:
        """Status census of one ``category:*`` id prefix."""
        markets = self._store.list_markets(pattern=f"{category}:*")
        by_status = Counter(m.status for m in markets)
        return {
            "category": category,
            "total_markets": len(markets),
            "resolved": by_status[MarketStatus.RESOLVED],
            "open": by_status[MarketStatus.OPEN],
            "markets": [str(m.id) for m in markets],
        }

    def consensus_columns(
        self, patterns: List[str]
    ) -> tuple[int, np.ndarray, np.ndarray]:
        """Cached consensus documents for matching markets, as columns.

        Returns ``(matched, values, confidences)`` where *matched* counts
        every pattern match (a market matching two patterns counts twice,
        as the sequential walk did) and the arrays hold the non-null cached
        consensus/confidence pairs — the columnar feed for any aggregation,
        and exactly the arrays a ``compute_all_consensus`` sweep (batched or
        scalar) just cached onto the markets.
        """
        docs = [
            m.consensus_result
            for pattern in patterns
            for m in self._store.list_markets(pattern=pattern)
        ]
        live = [
            d for d in docs if d and d.get("consensus") is not None
        ]
        values = np.asarray([d["consensus"] for d in live], dtype=np.float64)
        confs = np.asarray(
            [d.get("confidence", 0.5) for d in live], dtype=np.float64
        )
        return len(docs), values, confs

    def aggregate_consensus(
        self,
        patterns: List[str],
        method: str = "weighted_average",
    ) -> Dict[str, Any]:
        """Combine cached per-market consensus across matching markets.

        Methods: confidence-weighted average, upper median, binary majority
        — each one vectorised over the consensus columns.
        """
        matched, values, confs = self.consensus_columns(patterns)
        if values.size == 0:
            return {
                "schemaVersion": SCHEMA_VERSION,
                "consensus": None,
                "confidence": 0.0,
                "marketsIncluded": matched,
            }

        # Reductions run over Python floats via builtin sum(): CPython ≥3.12
        # compensates float sums, and the scalar reference inherits exactly
        # that — numpy pairwise/BLAS accumulation differs in the last ulp,
        # which would break parity with reference outputs. The elementwise
        # product is IEEE-exact either way, so only the sums need care.
        conf_list = confs.tolist()
        if method == "weighted_average":
            total_conf = sum(conf_list)
            aggregated = (
                sum((values * confs).tolist()) / total_conf
                if total_conf
                else sum(values.tolist()) / values.size
            )
        elif method == "median":
            # Upper median: the reference indexes the sorted list at n//2.
            aggregated = float(np.sort(values)[values.size // 2])
        elif method == "majority":
            aggregated = float((values >= 0.5).mean())
        else:
            raise ValueError(f"Unknown aggregation method: {method}")

        return {
            "schemaVersion": SCHEMA_VERSION,
            "consensus": aggregated,
            "confidence": sum(conf_list) / len(conf_list),
            "marketsIncluded": int(values.size),
            "method": method,
        }
