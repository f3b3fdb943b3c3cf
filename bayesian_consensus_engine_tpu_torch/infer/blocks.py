"""Combinatorial market blocks — constraint-typed edges + projection; the
port of ``infer/blocks.py``, numpy only, as it is there.

Elections, brackets, and parlays are not bags of independent binaries:
a 4-way election is a *partition* (exactly one outcome resolves YES),
and a parlay *implies* each of its legs. This module lets callers
declare those constraints once and get both halves of their meaning:

* **Inference half** — :meth:`MarketBlocks.to_graph` compiles blocks
  to :class:`~.analytics.graph.MarketGraph` edges (a clique over a
  mutually-exclusive partition, composite↔leg edges for an
  implication chain), so constituent evidence moves the composite's
  band through the ordinary belief sweep.
* **Constraint half** — :meth:`MarketBlocks.project` is a
  deterministic host-side post-sweep projection: mutually-exclusive
  members renormalise to sum to 1 (stderr scaled alike), implication
  composites clamp to their tightest leg. Pure numpy in declaration
  order — a bit-stable function of (ids, means, stderr).

The projection touches ONLY the additive analytics outputs — the
settle's point consensus, store and SQLite bytes are untouched whether or
not blocks are configured.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from bayesian_consensus_engine_tpu_torch.analytics.graph import MarketGraph
from bayesian_consensus_engine_tpu_torch.ops.propagate import (
    DEFAULT_DAMPING,
    DEFAULT_SWEEP_STEPS,
)

_KINDS = ("mutually_exclusive", "implies")


@dataclass(frozen=True)
class MarketBlock:
    """One declared constraint over named markets.

    ``mutually_exclusive``: *members* partition an outcome space —
    exactly one resolves YES, so propagated means renormalise to sum
    to 1. ``implies``: ``members[0]`` is the composite (the parlay),
    the rest its constituent legs — the composite's probability can
    never exceed any leg's, so the projection clamps it to the
    tightest leg. *weight* is the compiled edge weight (how hard the
    constraint pulls during the sweep).
    """

    kind: str
    members: Tuple[str, ...]
    weight: float = 1.0

    def __post_init__(self) -> None:
        object.__setattr__(self, "members", tuple(self.members))
        if self.kind not in _KINDS:
            raise ValueError(
                f"kind={self.kind!r}: one of {', '.join(_KINDS)}"
            )
        if len(self.members) < 2:
            raise ValueError(
                f"a {self.kind} block needs at least 2 members; got "
                f"{len(self.members)}"
            )
        if len(set(self.members)) != len(self.members):
            raise ValueError(
                f"duplicate members in {self.kind} block: {self.members}"
            )
        if not self.weight > 0:
            raise ValueError(f"weight={self.weight!r}: must be > 0")


class MarketBlocks:
    """An ordered collection of :class:`MarketBlock` declarations.

    Order matters twice: edge compilation preserves declaration order
    (the MarketGraph fingerprint is order-sensitive by design), and
    the projection applies blocks in declaration order — both keep the
    whole path a pure function of the declarations.
    """

    __slots__ = ("blocks",)

    def __init__(self, blocks: Iterable[MarketBlock]):
        self.blocks = tuple(blocks)
        for block in self.blocks:
            if not isinstance(block, MarketBlock):
                raise TypeError(
                    f"MarketBlocks takes MarketBlock entries; got "
                    f"{type(block).__name__}"
                )

    def __len__(self) -> int:
        return len(self.blocks)

    def to_edges(self) -> list:
        """``(market_id, depends_on_id, weight)`` triples, both ways.

        Mutually-exclusive partitions compile to the full clique (every
        member's evidence bears on every other); implication chains to
        composite↔leg pairs. Edges are emitted symmetrically — the
        sweep's CSR is directional (row gathers FROM its neighbours).
        """
        edges = []
        for block in self.blocks:
            if block.kind == "mutually_exclusive":
                members = block.members
                for i, a in enumerate(members):
                    for b in members[i + 1:]:
                        edges.append((a, b, block.weight))
                        edges.append((b, a, block.weight))
            else:  # implies
                composite = block.members[0]
                for leg in block.members[1:]:
                    edges.append((composite, leg, block.weight))
                    edges.append((leg, composite, block.weight))
        return edges

    def to_graph(
        self,
        damping: float = DEFAULT_DAMPING,
        steps: int = DEFAULT_SWEEP_STEPS,
        extra_edges: Iterable = (),
    ) -> MarketGraph:
        """Compile to the MarketGraph the fused sweep runs over.

        *extra_edges* prepend ordinary correlation edges (they come
        first so an existing graph's interning order is preserved when
        blocks are added to it).
        """
        return MarketGraph.from_edges(
            list(extra_edges) + self.to_edges(),
            damping=damping,
            steps=steps,
        )

    def project(
        self,
        market_ids: Sequence[str],
        means,
        stderr=None,
    ) -> "tuple[np.ndarray, Optional[np.ndarray]]":
        """Deterministic post-sweep constraint projection.

        *market_ids* aligns vector positions to names (the batch's
        market-key order); members absent from the batch — or with
        non-finite means — are skipped, mirroring
        :meth:`~.analytics.graph.MarketGraph.align`'s absent-market
        semantics. Returns new ``(means, stderr)`` arrays (f32);
        inputs are never written.

        Mutually-exclusive: finite members clip to ``[0, ∞)`` and
        renormalise by their sum (computed in f64 for a stable
        divisor), so the block sums to 1; stderr scales by the same
        factor. Implies: the composite clamps to ``min`` of its finite
        legs (stderr untouched — clamping is a bound, not evidence).
        """
        index = {mid: pos for pos, mid in enumerate(market_ids)}
        out_mean = np.asarray(means, np.float32).copy()
        out_stderr = (
            None if stderr is None
            else np.asarray(stderr, np.float32).copy()
        )
        for block in self.blocks:
            present = [
                index[m] for m in block.members
                if m in index and np.isfinite(out_mean[index[m]])
            ]
            if block.kind == "mutually_exclusive":
                if len(present) < 2:
                    continue
                clipped = np.maximum(
                    out_mean[present].astype(np.float64), 0.0
                )
                total = float(np.add.reduce(clipped))
                if total <= 0.0:
                    continue
                out_mean[present] = (clipped / total).astype(np.float32)
                if out_stderr is not None:
                    scale = np.float32(1.0 / total)
                    for pos in present:
                        if np.isfinite(out_stderr[pos]):
                            out_stderr[pos] = out_stderr[pos] * scale
            else:  # implies
                composite = block.members[0]
                if composite not in index:
                    continue
                c = index[composite]
                if not np.isfinite(out_mean[c]):
                    continue
                legs = [
                    index[m] for m in block.members[1:]
                    if m in index and np.isfinite(out_mean[index[m]])
                ]
                if not legs:
                    continue
                cap = out_mean[legs[0]]
                for pos in legs[1:]:
                    cap = min(cap, out_mean[pos])
                if out_mean[c] > cap:
                    out_mean[c] = cap
        return out_mean, out_stderr
