"""`MarketGraph` — the host-side market-dependency graph behind the
correlated-consensus sweep, the port of ``analytics/graph.py``.

An edge ``(market, depends_on, weight)`` declares that *market*'s
consensus should be pulled toward *depends_on*'s, with relative strength
*weight*. The graph is built ONCE from an edge list, interned first-seen
and CSR-compacted (``core.batch.encode_source_ids``), and then ALIGNED per
plan: :meth:`MarketGraph.align` maps node ids onto a plan's market rows
and pads the CSR rows to a dense ``(markets, max_degree)`` neighbour block,
the shape the sweep gathers from.

**Fingerprints.** :attr:`fingerprint` is the order-sensitive blake2b digest
of the graph (node table, raw edge order, weights, damping, sweep depth),
byte-equal to the JAX package's; :meth:`extended_fingerprint` folds a
plan's topology digest with it, so the session's cache of aligned
neighbour blocks reuses across probability-only refreshes and misses when
the topology or the graph changes. Edge reordering changes the digest by
contract (the neighbour accumulation order follows edge order).

**Alignment** runs in numpy rather than the reference's Python loop over
nodes and edges (which costs seconds over millions of edges); its blocks
are byte-equal to the reference's.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence, Tuple

import numpy as np

from bayesian_consensus_engine_tpu_torch.core.batch import encode_source_ids
from bayesian_consensus_engine_tpu_torch.ops.propagate import (
    DEFAULT_DAMPING,
    DEFAULT_SWEEP_STEPS,
)

Edge = Tuple[str, str, float]


class MarketGraph:
    """Immutable CSR market-dependency graph + sweep configuration.

    Build with :meth:`from_edges`. ``damping`` (λ) and ``steps`` are part
    of the graph object: they parameterise the sweep, so "one graph, one
    sweep" stays true.
    """

    __slots__ = (
        "node_ids", "offsets", "indices", "weights",
        "damping", "steps", "fingerprint",
    )

    def __init__(
        self,
        node_ids: Sequence[str],
        offsets: np.ndarray,
        indices: np.ndarray,
        weights: np.ndarray,
        damping: float,
        steps: int,
        fingerprint: bytes,
    ) -> None:
        self.node_ids = list(node_ids)
        self.offsets = offsets
        self.indices = indices
        self.weights = weights
        self.damping = float(damping)
        self.steps = int(steps)
        self.fingerprint = fingerprint
        for array in (self.offsets, self.indices, self.weights):
            array.setflags(write=False)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_edges(
        cls,
        edges: Iterable[Edge],
        damping: float = DEFAULT_DAMPING,
        steps: int = DEFAULT_SWEEP_STEPS,
    ) -> "MarketGraph":
        """Build from ``(market_id, depends_on_id, weight)`` triples.

        Node ids intern first-seen; edges group market-major in a stable
        sort, so each market's neighbour order is its submission order.
        Self-edges and non-positive weights are rejected.
        """
        edges = list(edges)
        if not 0.0 <= damping <= 1.0:
            raise ValueError(f"damping must be in [0, 1], got {damping}")
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        flat_ids: list[str] = []
        weights = np.empty(len(edges), dtype=np.float64)
        for i, (src, dst, weight) in enumerate(edges):
            if src == dst:
                raise ValueError(f"self-edge on {src!r}")
            if not weight > 0.0:
                raise ValueError(
                    f"edge ({src!r}, {dst!r}) weight must be > 0, "
                    f"got {weight}"
                )
            flat_ids.append(src)
            flat_ids.append(dst)
            weights[i] = weight
        codes = encode_source_ids(flat_ids)
        src_codes = codes.codes[0::2]
        dst_codes = codes.codes[1::2]
        num_nodes = len(codes.table)
        order = np.argsort(src_codes, kind="stable")
        indices = np.ascontiguousarray(dst_codes[order], dtype=np.int32)
        csr_weights = np.ascontiguousarray(weights[order])
        offsets = np.searchsorted(
            src_codes[order], np.arange(num_nodes + 1)
        ).astype(np.int64)

        digest = hashlib.blake2b(digest_size=16)
        digest.update(
            np.asarray([num_nodes, len(edges), steps], np.int64).tobytes()
        )
        digest.update(np.float64(damping).tobytes())
        digest.update(
            np.fromiter(map(len, codes.table), np.int64, len(codes.table)).tobytes()
        )
        digest.update("".join(codes.table).encode("utf-8"))
        # Raw (pre-sort) edge order: reordering MUST miss.
        digest.update(np.ascontiguousarray(src_codes).tobytes())
        digest.update(np.ascontiguousarray(dst_codes).tobytes())
        digest.update(weights.tobytes())
        return cls(
            codes.table, offsets, indices, csr_weights,
            damping, steps, digest.digest(),
        )

    # -- introspection -------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def extended_fingerprint(self, topology_digest: "bytes | None") -> bytes:
        """Fold a plan's topology digest with the graph's: the reuse key
        for anything cached per (signal topology, graph)."""
        digest = hashlib.blake2b(digest_size=16)
        digest.update(topology_digest or b"\x00")
        digest.update(self.fingerprint)
        return digest.digest()

    # -- per-plan alignment --------------------------------------------------

    def align(
        self,
        market_keys: Sequence[str],
        padded_total: "int | None" = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Dense neighbour blocks for one batch's market universe.

        Maps graph nodes onto *market_keys* positions and pads each
        present market's CSR row to the batch's max degree:
        ``(neighbor_idx i32[T, D], neighbor_w f32[T, D])`` with
        ``T = padded_total or len(market_keys)``, ``-1`` in unused lanes and
        ``D >= 1``. Edges touching a market absent from this batch are
        dropped; the surviving edges keep their CSR order.
        """
        total = len(market_keys) if padded_total is None else padded_total
        if total < len(market_keys):
            raise ValueError(
                f"padded_total {total} < {len(market_keys)} markets"
            )
        row_of = {key: i for i, key in enumerate(market_keys)}
        node_rows = np.fromiter(
            (row_of.get(node, -1) for node in self.node_ids),
            dtype=np.int64, count=self.num_nodes,
        )
        edge_src = np.repeat(
            np.arange(self.num_nodes, dtype=np.int64), np.diff(self.offsets)
        )
        src_rows = node_rows[edge_src]
        dst_rows = node_rows[self.indices.astype(np.int64)]
        kept = (src_rows >= 0) & (dst_rows >= 0)
        kept_src = edge_src[kept]  # ascending: CSR order is node order
        per_node = np.bincount(kept_src, minlength=self.num_nodes)
        first = np.cumsum(per_node) - per_node
        lanes = np.arange(kept_src.shape[0]) - first[kept_src]
        max_degree = max(1, int(per_node.max(initial=0)))
        neighbor_idx = np.full((total, max_degree), -1, dtype=np.int32)
        neighbor_w = np.zeros((total, max_degree), dtype=np.float32)
        rows = src_rows[kept]
        neighbor_idx[rows, lanes] = dst_rows[kept]
        neighbor_w[rows, lanes] = self.weights[kept].astype(np.float32)
        return neighbor_idx, neighbor_w
