"""Ring and all-to-all source parallelism — the port of the JAX package's
``parallel/ring.py``.

One market's source row can outgrow one device, so the slots axis is
sharded over the mesh's ``sources`` axis and the per-market weight sums
become cross-shard reductions. This module carries the two long-sequence
strategies the reference maps onto that axis:

* **Ring reduction**: each shard reduces its local slots in chunks of
  ``chunk_slots`` (both phases of the cycle on each chunk, so no
  full-block intermediate materialises), then the per-market partial
  ``(Σw, Σp·w, Σc·w)`` triples travel the ring (:func:`ring_allreduce`).
* **All-to-all resharding** (:func:`reshard`): a block flips between the
  reduction layout (``REDUCE_SPEC``: markets × sources shards) and the
  update layout (``UPDATE_SPEC``: markets split over every device, slots
  whole) in one exchange of pieces.
* **Ring tie-break** (:func:`build_ring_tiebreak`): the agents axis sharded
  over the sources axis, the group statistics accumulated against every
  shard's visiting block, chunk by chunk
  (``ops/tiebreak.py::ring_tiebreak_math``).

The JAX package runs all of it in XLA (``shard_map`` with ``ppermute``),
with no Pallas kernel; the port runs it as eager PyTorch on the shards'
devices, as the rest of the mesh tier does: a sharded value is a grid of
per-shard tensors, ``blocks[i][j]`` for mesh position (markets shard i,
sources shard j), cut by ``parallel/mesh.shard_block`` from a market-major
(M, K) block. Per-market outputs come back whole on the mesh's first
device.

Numerics. The update phase is elementwise, so the state is bit-equal to
the flat loop's. The consensus is not: the local slot sums run in
``torch.sum``'s order, and the ring adds the shards in its own hop order
(:func:`ring_allreduce`), not ``ops/collectives.psum``'s left-to-right
order, so it agrees with the psum cycle within the reference's own bound
(rtol 2e-6, atol 1e-6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bayesian_consensus_engine_tpu_torch.ops.cycle_math import (
    CycleResult,
    MarketBlockState,
    consensus_epilogue,
    read_phase,
    update_phase,
)
from bayesian_consensus_engine_tpu_torch.ops.tiebreak import (
    RingTieBreakResult,
    ring_tiebreak_math,
)
from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
    MARKETS_AXIS,
    SOURCES_AXIS,
    Mesh,
)
from bayesian_consensus_engine_tpu_torch.utils.config import (
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
)

#: The reduction layout of a market-major (M, K) block: market rows over
#: the markets axis, slot columns over the sources axis.
REDUCE_SPEC = (MARKETS_AXIS, SOURCES_AXIS)
#: The update layout: market rows over every device (markets-major order),
#: slots whole.
UPDATE_SPEC = ((MARKETS_AXIS, SOURCES_AXIS), None)


def ring_allreduce(pieces) -> list:
    """Sum per-shard values over a mesh axis with the reference's ring.

    *pieces* are the axis's per-shard tensors in mesh order. As the JAX
    package's ``S - 1`` ``ppermute`` hops (shard ``i`` sends to ``i + 1``)
    add them, shard ``j`` holds ``((x_j + x_{j-1}) + x_{j-2}) + …``, the
    indices taken modulo ``S``: its own value, then the values one hop,
    two hops, … behind it. So each shard's bits may differ from another's
    and from ``ops/collectives.psum``'s. Returns the list of per-shard
    sums, each on its shard's device.
    """
    size = len(pieces)
    out = []
    for j, piece in enumerate(pieces):
        acc = piece
        for hop in range(1, size):
            acc = acc + pieces[(j - hop) % size].to(piece.device)
        out.append(acc)
    return out


def _local_pass(probs, mask, outcome, state, now_days, chunk_slots):
    """Both phases of one cycle on one (M_loc, K_loc) shard, chunk by chunk
    of slots: ``(tw, wp, wc, new_state)``, the partial sums added chunk by
    chunk, a ragged tail as one narrower chunk."""
    k_loc = probs.shape[1]
    chunk = chunk_slots or k_loc
    zeros = torch.zeros(probs.shape[0], dtype=probs.dtype, device=probs.device)
    tw, wp, wc = zeros, zeros, zeros
    parts = []
    for offset in range(0, k_loc, chunk):
        cols = slice(offset, min(offset + chunk, k_loc))
        sub = MarketBlockState(*(
            None if field is None else field[:, cols] for field in state
        ))
        p, m = probs[:, cols], mask[:, cols]
        read_rel, read_conf = read_phase(sub, now_days)
        w = torch.where(m, read_rel, 0.0)
        tw = tw + torch.sum(w, dim=-1)
        wp = wp + torch.sum(torch.where(m, p, 0.0) * w, dim=-1)
        wc = wc + torch.sum(torch.where(m, read_conf, 0.0) * w, dim=-1)
        parts.append(update_phase(
            p, m, outcome, sub, read_conf, now_days, slots_axis=-1
        ))
    if len(parts) == 1:
        new_state = parts[0]
    else:
        new_state = MarketBlockState(*(
            None if parts[0][f] is None
            else torch.cat([part[f] for part in parts], dim=1)
            for f in range(4)
        ))
    return tw, wp, wc, new_state


def _ring_cycle_math(probs, mask, outcome, state, now_days, chunk_slots, device):
    """One cycle on one markets shard's row of sources shards (lists in mesh
    order): each shard's chunked local pass, then the partial triples over
    the ring. The per-market outputs are sources shard 0's, on *device*,
    which is the copy the reference's replicated output takes."""
    passes = [
        _local_pass(probs[j], mask[j], outcome[j], state[j], now_days[j],
                    chunk_slots)
        for j in range(len(probs))
    ]
    triples = ring_allreduce([torch.stack(p[:3]) for p in passes])
    total_weight, weighted_prob, weighted_conf = triples[0].to(device)
    consensus, confidence_out = consensus_epilogue(
        total_weight, weighted_prob, weighted_conf
    )
    return CycleResult(
        [p[3] for p in passes], consensus, confidence_out, total_weight
    )


def _fast_ring_cycle_math(probs, mask, outcome, reliability, confidence,
                          now_days, prev_now, chunk_slots, device):
    """A mid-loop ring cycle with the decay read driven by scalar time:
    every masked slot was stamped ``prev_now`` by the previous step, so
    the stamps are that scalar broadcast and the day stamps leave the
    carry. Returns ``(reliability', confidence', consensus)``, the first
    two as lists over the sources shards."""
    state = [
        MarketBlockState(rel, conf, prev.expand(rel.shape), None)
        for rel, conf, prev in zip(reliability, confidence, prev_now)
    ]
    result = _ring_cycle_math(
        probs, mask, outcome, state, now_days, chunk_slots, device
    )
    return (
        [s.reliability for s in result.state],
        [s.confidence for s in result.state],
        result.consensus,
    )


def _day(now, like) -> torch.Tensor:
    """*now* as a 0-d tensor of *like*'s dtype on its device."""
    return torch.as_tensor(now, dtype=like.dtype, device=like.device)


def _ring_loop_math(probs, mask, outcome, state, now0, steps, chunk_slots,
                    device):
    """``steps`` ring cycles on one markets shard, with the flat loop's
    carry (``ops/cycle_math.make_loop_math``): ``exists`` out of the carry
    (cold slots sanitised to the priors on entry, restored on exit), step
    0 on the per-slot stamps and every later step on the scalar day, the
    stamps rebuilt once at the end."""
    days = [_day(now0, st.reliability) for st in state]
    if steps == 0:
        return list(state), torch.zeros(
            outcome[0].shape[0], dtype=probs[0].dtype, device=device)
    sanitised = [
        st if st.exists is None else MarketBlockState(
            reliability=torch.where(st.exists, st.reliability,
                                    DEFAULT_RELIABILITY),
            confidence=torch.where(st.exists, st.confidence,
                                   DEFAULT_CONFIDENCE),
            updated_days=torch.where(st.exists, st.updated_days, 0.0),
            exists=None,
        )
        for st in state
    ]
    first = _ring_cycle_math(
        probs, mask, outcome, sanitised, [d + 0 for d in days], chunk_slots,
        device,
    )
    rel = [s.reliability for s in first.state]
    conf = [s.confidence for s in first.state]
    consensus = first.consensus
    for i in range(1, steps):
        rel, conf, consensus = _fast_ring_cycle_math(
            probs, mask, outcome, rel, conf, [d + i for d in days],
            [d + (i - 1) for d in days], chunk_slots, device,
        )
    out = []
    for j, st in enumerate(state):
        # Chained cycles stamp masked slots now0+i every step; the last
        # stamp, rebuilt in one pass.
        upd = torch.where(mask[j], (days[j] + (steps - 1)).to(
            sanitised[j].updated_days.dtype), sanitised[j].updated_days)
        if st.exists is None:
            out.append(MarketBlockState(rel[j], conf[j], upd, None))
            continue
        keep = st.exists | mask[j]
        out.append(MarketBlockState(
            reliability=torch.where(keep, rel[j], st.reliability),
            confidence=torch.where(keep, conf[j], st.confidence),
            updated_days=torch.where(keep, upd, st.updated_days),
            exists=keep,
        ))
    return out, consensus


def _check_grid(blocks, mesh: Mesh, name: str) -> None:
    for i, row in enumerate(mesh.devices):
        for j, device in enumerate(row):
            if blocks[i][j].device != device:
                raise ValueError(
                    f"{name} shard ({i}, {j}) is on {blocks[i][j].device}, the "
                    f"mesh places it on {device}"
                )


def _concat(pieces, device) -> torch.Tensor:
    if len(pieces) == 1:
        return pieces[0]
    return torch.cat([piece.to(device) for piece in pieces])


def build_ring_cycle(mesh: Mesh, chunk_slots: "int | None" = None):
    """Consensus + update cycle with a chunked, ring-reduced sources axis.

    ``cycle(probs, mask, outcome, state, now_days) -> CycleResult``: the
    blocks are market-major (M, K) grids (``parallel/mesh.shard_block``),
    ``outcome`` a grid of per-shard (M_loc,) vectors
    (``shard_market_vector``), ``state`` a grid of per-shard
    :class:`MarketBlockState` (``exists`` may be ``None``: the loop's
    reduced carry). The result's state is such a grid; the consensus, the
    confidence and the total weight are whole, on the mesh's first device.
    ``chunk_slots`` bounds the local pass (``None``: one full-width chunk;
    a ragged tail runs as one more, narrower chunk).
    """
    device = mesh.devices[0][0]

    def cycle(probs, mask, outcome, state, now_days):
        _check_grid(probs, mesh, "probs")
        states, per_market = [], []
        for i in range(mesh.shape[MARKETS_AXIS]):
            result = _ring_cycle_math(
                probs[i], mask[i], outcome[i], state[i],
                [_day(now_days, p) for p in probs[i]], chunk_slots,
                mesh.devices[i][0],
            )
            states.append(tuple(result.state))
            per_market.append(result[1:])
        return CycleResult(tuple(states), *(
            _concat([shard[k] for shard in per_market], device)
            for k in range(3)
        ))

    return cycle


def build_ring_cycle_loop(mesh: Mesh, chunk_slots: "int | None" = None):
    """N ring cycles in one call — the ring twin of
    ``parallel/sharded.build_cycle_loop``.

    ``loop(probs, mask, outcome, state, now0, steps) -> (state',
    consensus)``: ``steps`` cycles on days ``now0 + i``, with the flat
    loop's carry (``exists`` out of the carry, the day stamps rebuilt
    after the loop), so a resumed loop equals an uninterrupted one bit for
    bit. Arguments and results as :func:`build_ring_cycle`'s.
    """
    device = mesh.devices[0][0]

    def loop(probs, mask, outcome, state, now0, steps: int):
        _check_grid(probs, mesh, "probs")
        states, consensus = [], []
        for i in range(mesh.shape[MARKETS_AXIS]):
            shard_state, shard_consensus = _ring_loop_math(
                probs[i], mask[i], outcome[i], state[i], now0, int(steps),
                chunk_slots, mesh.devices[i][0],
            )
            states.append(tuple(shard_state))
            consensus.append(shard_consensus)
        return tuple(states), _concat(consensus, device)

    return loop


class ShardedBlock(NamedTuple):
    """A market-major (M, K) block laid out on a mesh: ``spec`` is
    :data:`REDUCE_SPEC` or :data:`UPDATE_SPEC`, ``shards`` the grid of
    per-shard tensors in mesh order (``shards[i][j]`` on
    ``mesh.devices[i][j]``)."""

    spec: tuple
    shards: tuple


def reshard(x, mesh: Mesh, spec) -> ShardedBlock:
    """Flip a block to *spec*'s layout in one exchange of pieces (the
    all-to-all DeepSpeed Ulysses uses to flip sequence and head sharding).

    * :data:`REDUCE_SPEC`: shard (i, j) holds markets shard i's rows and
      sources shard j's slot columns; the weight sums need a sources-axis
      collective.
    * :data:`UPDATE_SPEC`: the rows split over every device in
      markets-major order (shard (i, j) holds row block ``i·S + j`` of
      ``Mk·S``), slots whole; the elementwise update needs no exchange.

    *x* is a :class:`ShardedBlock` or a whole (M, K) tensor (cut onto the
    mesh). Each destination shard is assembled from the pieces the source
    shards hold of it, so the global block never materialises on one
    device. No byte changes.
    """
    if spec not in (REDUCE_SPEC, UPDATE_SPEC):
        raise ValueError(f"spec must be REDUCE_SPEC or UPDATE_SPEC, got {spec!r}")
    m_size, s_size = mesh.shape[MARKETS_AXIS], mesh.shape[SOURCES_AXIS]
    if isinstance(x, torch.Tensor):
        num_markets, num_slots = x.shape
        if num_markets % (m_size * s_size) or num_slots % s_size:
            raise ValueError(
                f"a ({num_markets}, {num_slots}) block does not divide over "
                f"a ({m_size}, {s_size}) mesh in both layouts — pad it first"
            )
        rows, cols = num_markets // m_size, num_slots // s_size
        x = ShardedBlock(REDUCE_SPEC, tuple(
            tuple(
                x[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]
                .to(mesh.devices[i][j]).contiguous()
                for j in range(s_size)
            )
            for i in range(m_size)
        ))
    if x.spec == spec:
        return x
    grid = x.shards
    if spec == UPDATE_SPEC:
        # Row block j of markets shard i, gathered over its slot shards.
        sub = grid[0][0].shape[0] // s_size
        shards = tuple(
            tuple(
                torch.cat([
                    grid[i][src][j * sub:(j + 1) * sub].to(mesh.devices[i][j])
                    for src in range(s_size)
                ], dim=1)
                for j in range(s_size)
            )
            for i in range(m_size)
        )
    else:
        # Slot columns j of markets shard i, gathered over its row blocks.
        cols = grid[0][0].shape[1] // s_size
        shards = tuple(
            tuple(
                torch.cat([
                    grid[i][src][:, j * cols:(j + 1) * cols]
                    .to(mesh.devices[i][j])
                    for src in range(s_size)
                ], dim=0)
                for j in range(s_size)
            )
            for i in range(m_size)
        )
    return ShardedBlock(spec, shards)


def build_ring_tiebreak(mesh: Mesh, precision: int = 6,
                        chunk_agents: "int | str | None" = None):
    """Batched tie-break with the agents axis sharded over the mesh's
    sources axis and chunk-accumulated.

    ``tiebreak(pred, weight, conf, rel, valid) -> RingTieBreakResult`` over
    market-major (M, A) grids cut ``P(markets, sources)``
    (``parallel/mesh.shard_block``): per markets shard,
    ``ops/tiebreak.ring_tiebreak_math`` over its sources shards' blocks
    (agents last), the results whole on the mesh's first device.
    ``chunk_agents``: ``None`` (one full-width chunk) or an int (the local
    chunk width, clamped to the shard); no output depends on it. ``"auto"``
    is the shape tuner of ROADMAP queue 1 item 10 and raises
    ``NotImplementedError``; any other string raises ``ValueError``, as in
    the JAX package.
    """
    if chunk_agents == "auto":
        raise NotImplementedError(
            "chunk_agents='auto' (the ring chunk tuner, which needs "
            "utils/autotune.py's ShapeTuner) is not ported yet: ROADMAP "
            "queue 1 item 10"
        )
    if isinstance(chunk_agents, str):
        raise ValueError(
            f"chunk_agents={chunk_agents!r}: the only supported string "
            "is 'auto'"
        )
    n_sources = mesh.shape[SOURCES_AXIS]
    device = mesh.devices[0][0]

    def tiebreak(pred, weight, conf, rel, valid):
        _check_grid(pred, mesh, "pred")
        rows = []
        for i in range(mesh.shape[MARKETS_AXIS]):
            blocks = (pred[i], weight[i], conf[i], rel[i], valid[i])
            if n_sources == 1:
                blocks = tuple(block[0] for block in blocks)
            rows.append(ring_tiebreak_math(
                *blocks, axis_size=n_sources, device=mesh.devices[i][0],
                precision=precision, chunk_agents=chunk_agents,
                agents_last=True,
            ))
        return RingTieBreakResult(*(
            _concat([row[k] for row in rows], device) for k in range(6)
        ))

    return tiebreak
