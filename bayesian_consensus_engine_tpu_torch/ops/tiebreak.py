"""The ring tie-break at one device — the torch twin of ``ops/tiebreak.py``.

For each market, every valid agent (a signalling slot) enters with a
prediction, a weight, a confidence and a reliability score. Predictions
are quantised to ``precision`` decimals (``key = round(p·10^precision)``,
round half to even); agents with the same key form a group. Groups are
ranked by the scalar hierarchy (reference: tiebreak.py:112-117): higher
weight density (group weight over group size), then higher maximum
reliability, then the smaller key. The result per market is the winning
group's rescaled key, its density and maximum reliability, how the
decision fell (``resolved_by``), the number of groups, and the population
variance of the valid agents' confidences.

``ring_tiebreak_math`` runs on one device or over a sources-sharded axis
(``axis_size > 1``, per-shard blocks): the ring's hops become copies of
every shard's (key, weight, reliability, valid) blocks, and the psums and
the cross-shard top-2 fold run in fixed mesh order. ``chunk_agents``
keeps its meaning — the local agents are processed in fixed-width chunks
whose top two groups fold into a per-market carry — and, as in the JAX
package, no result depends on it.

Summation order. Each group weight and the two confidence sums are taken
in agent order 0 … A−1, one agent at a time, which is also the order the
CUDA one-pass kernel (``csrc/onepass_settle.cu``) adds them in. XLA's CPU
reduction runs in that order for widths up to 16; beyond that its order
differs, and so do the last bits of a group density.

:func:`batched_tiebreak` is the JAX package's sort-based grouping
(``ops/tiebreak.py::batched_tiebreak``): per (M, A) row it sorts the
quantised keys, reads each group off its contiguous segment and runs the
same hierarchy as masked reductions. The JAX package computes it in XLA,
not in Pallas, so these eager ops are its port on the CPU and the card.
Its running group-weight sums and its confidence sums add left to right
(XLA CPU's order up to 16 agents; its ``cumsum`` blocks wider rows), and
its sort is stable, as ``jnp.argsort`` is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.ops.fma import fma
from bayesian_consensus_engine_tpu_torch.ops.collectives import psum

#: The recorded default chunk width (``ops/tiebreak.py`` of the JAX
#: package): the memory-diet default of the fused resident program.
DEFAULT_CHUNK_AGENTS = 1024

#: Empty top-2 slot key, and the sorted path's key of an invalid agent
#: (it sorts last and is never a candidate); a real key never reaches it
#: (|p·10^6| ≪ 2^31).
_SENTINEL = 2**31 - 1
#: Key of an invalid agent, distinct from the sentinel.
_INVALID_KEY = -(2**31)


class RingTieBreakResult(NamedTuple):
    """Tie-break outputs, one entry per market.

    ``resolved_by``: 0 unanimous (one group), 1 weight_density,
    2 prediction_value_smallest (a full tie on density and maximum
    reliability). A market with no valid agent reports
    ``prediction = inf``, ``-inf`` group metrics, 0 groups and variance 0.
    """

    prediction: torch.Tensor           # f32[M] winning key / 10^precision
    weight_density: torch.Tensor       # f32[M]
    max_reliability: torch.Tensor      # f32[M]
    resolved_by: torch.Tensor          # i32[M]
    num_groups: torch.Tensor           # i32[M]
    confidence_variance: torch.Tensor  # f32[M]


def _lex_ge(ad, ar, ak, bd, br, bk):
    """Does group a beat or tie group b under (density, max_rel,
    smallest key)? Keys are unique per group, so this is a total order."""
    return (ad > bd) | ((ad == bd) & ((ar > br) | ((ar == br) & (ak <= bk))))


def _sel(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def _mask_key(entry, key):
    """Demote *entry* to the empty slot where its key equals *key*."""
    d, r, k = entry
    hit = k == key
    return (
        torch.where(hit, -torch.inf, d),
        torch.where(hit, -torch.inf, r),
        torch.where(hit, _SENTINEL, k),
    )


def _merge_top2(a, b):
    """Merge two per-market (winner, runner-up) pairs of distinct groups.

    ``a``/``b`` are ``(d1, r1, k1, d2, r2, k2)`` tuples of (M,) tensors,
    empty slots at ``(-inf, -inf, _SENTINEL)``. The same group seen from
    both sides carries identical stats, so deduplication is key equality.
    """
    a1, a2 = (a[0], a[1], a[2]), (a[3], a[4], a[5])
    b1, b2 = (b[0], b[1], b[2]), (b[3], b[4], b[5])
    a_wins = _lex_ge(*a1, *b1)
    win = _sel(a_wins, a1, b1)
    lose = _sel(a_wins, b1, a1)
    cands = [_mask_key(lose, win[2]), _mask_key(a2, win[2]),
             _mask_key(b2, win[2])]
    best = cands[0]
    for cand in cands[1:]:
        best = _sel(_lex_ge(*best, *cand), best, cand)
    return win + best


def _agent(x: torch.Tensor, i: int, agents_last: bool) -> torch.Tensor:
    return x[:, i] if agents_last else x[i]


def ring_tiebreak_math(
    pred,
    weight,
    conf,
    rel,
    valid,
    *,
    axis_size: int = 1,
    device=None,
    precision: int = 6,
    chunk_agents: "int | None" = None,
    agents_last: bool = True,
) -> RingTieBreakResult:
    """Chunked group-metric tie-break over a market's agents.

    Blocks are ``(M, A)`` with ``agents_last=True`` or slot-major
    ``(A, M)`` with ``agents_last=False`` (the fused settle's layout).
    Everything is computed in float32, as the JAX package does.
    ``chunk_agents`` bounds the working set (``None``: one chunk of every
    agent); a ragged tail runs as one more, narrower chunk.

    ``axis_size > 1``: the agents axis is sharded over a sources axis of
    ``axis_size`` shards. Each of the five block arguments is then a
    sequence of per-shard blocks in mesh order (the same markets, each
    shard's own agents). As in the JAX package's ring, every shard's
    agents count, sum and max their group over the agents of every shard
    (origin); a group's weight is summed per origin in agent order and the
    origins' partial sums are added in origin order 0 … S−1, so every
    member of a group sees the same bits wherever it lies. Each shard
    folds its agents into a top two; the shards' top twos are merged in
    mesh order, and ``Σ 1/count``, the valid count and the two confidence
    sums are summed across shards (``ops/collectives.psum``). Every
    shard would compute the same result; it is returned on *device*
    (default: the first shard's).
    """
    if axis_size == 1:
        shards = [(pred, weight, conf, rel, valid)]
    else:
        blocks = (pred, weight, conf, rel, valid)
        if any(len(x) != axis_size for x in blocks):
            raise ValueError(
                f"axis_size={axis_size}: each block argument must be a "
                "sequence of that many per-shard blocks"
            )
        shards = list(zip(*blocks))
    device = shards[0][0].device if device is None else device
    f32 = torch.float32
    scale = 10.0**precision
    agents_axis = 1 if agents_last else 0
    markets = shards[0][0].shape[0 if agents_last else 1]

    def prepare(p, w, c, r, v):
        p, w, c, r = p.to(f32), w.to(f32), c.to(f32), r.to(f32)
        keys = torch.where(v, torch.round(p * scale).to(torch.int32), _INVALID_KEY)
        return keys, w, c, r, v

    shards = [prepare(*shard) for shard in shards]

    def expand(per_market):
        return per_market[:, None] if agents_last else per_market[None, :]

    def reduce(x, op):
        return op(x, dim=agents_axis)

    def chunk_pass(lk, lvalid, visiting, carry):
        top2, sum_inv = carry
        shard_device = lk.device
        count = torch.zeros(lk.shape, dtype=torch.int32, device=shard_device)
        mr = torch.full(lk.shape, -torch.inf, dtype=f32, device=shard_device)
        tw = None
        # Group stats against every origin's agents, visited in agent
        # order; the group weight per origin, then across origins in
        # origin order.
        for keys, weights, rels, valids in visiting:
            partial = torch.zeros(lk.shape, dtype=f32, device=shard_device)
            for i in range(keys.shape[agents_axis]):
                same = (lk == expand(_agent(keys, i, agents_last))) & expand(
                    _agent(valids, i, agents_last)
                )
                count = count + same.to(torch.int32)
                partial = partial + torch.where(
                    same, expand(_agent(weights, i, agents_last)), 0.0
                )
                mr = torch.maximum(mr, torch.where(
                    same, expand(_agent(rels, i, agents_last)), -torch.inf
                ))
            tw = partial if tw is None else tw + partial
        member = lvalid & (count > 0)
        safe_count = torch.clamp_min(count, 1).to(f32)
        density = torch.where(member, tw / safe_count, -torch.inf)
        mrm = torch.where(member, mr, -torch.inf)

        bd = reduce(density, torch.amax)
        m1 = member & (density == expand(bd))
        br = reduce(torch.where(m1, mrm, -torch.inf), torch.amax)
        m2 = m1 & (mrm == expand(br))
        bk = reduce(torch.where(m2, lk, _SENTINEL), torch.amin)
        others = member & (lk != expand(bk))
        od = reduce(torch.where(others, density, -torch.inf), torch.amax)
        o1 = others & (density == expand(od))
        orr = reduce(torch.where(o1, mrm, -torch.inf), torch.amax)
        o2 = o1 & (mrm == expand(orr))
        ok = reduce(torch.where(o2, lk, _SENTINEL), torch.amin)
        top2 = _merge_top2(top2, (bd, br, bk, od, orr, ok))
        # Σ 1/count over members counts each group once in total (count
        # is the group's size over every shard).
        inv = torch.where(member, 1.0 / safe_count, 0.0)
        return top2, sum_inv + _ordered_sum(inv, agents_axis)

    def shard_fold(keys, valid_local):
        """One shard's top two and local ``Σ 1/count`` over its agents."""
        shard_device = keys.device
        visiting = [
            tuple(x.to(shard_device) for x in (k, w, r, v))
            for k, w, _c, r, v in shards
        ]
        num_agents = keys.shape[agents_axis]
        chunk = (
            num_agents if chunk_agents is None
            else max(1, min(int(chunk_agents), num_agents))
        )
        neg = torch.full((markets,), -torch.inf, dtype=f32, device=shard_device)
        sent = torch.full((markets,), _SENTINEL, dtype=torch.int32,
                          device=shard_device)
        empty = (neg, neg, sent)
        carry = (empty + empty,
                 torch.zeros(markets, dtype=f32, device=shard_device))
        n_full, tail = divmod(num_agents, chunk) if chunk else (0, 0)
        spans = [(i * chunk, chunk) for i in range(n_full)]
        if tail:
            spans.append((n_full * chunk, tail))
        for offset, width in spans:
            local = slice(offset, offset + width)
            lk = keys[:, local] if agents_last else keys[local]
            lvalid = valid_local[:, local] if agents_last else valid_local[local]
            carry = chunk_pass(lk, lvalid, visiting, carry)
        return carry

    folds = [shard_fold(k, v) for k, _w, _c, _r, v in shards]
    top2 = tuple(x.to(device) for x in folds[0][0])
    for shard_top2, _ in folds[1:]:
        top2 = _merge_top2(top2, tuple(x.to(device) for x in shard_top2))
    sum_inv = psum([fold[1] for fold in folds], device)
    d1, r1, k1, d2, r2, k2 = top2

    any_member = k1 != _SENTINEL
    any_other = k2 != _SENTINEL
    full_tie = (d1 == d2) & (r1 == r2)
    resolved_by = torch.where(
        ~any_other, 0, torch.where(full_tie, 2, 1)
    ).to(torch.int32)
    # XLA turns the division by the constant scale into a multiplication
    # by its float32 reciprocal; the port does the same.
    recip = torch.tensor(np.float32(1.0) / np.float32(scale), device=device)
    prediction = torch.where(any_member, k1.to(f32) * recip, torch.inf)
    num_groups = torch.round(sum_inv).to(torch.int32)

    # Population confidence variance over valid agents, full width (the
    # expression must not change with the chunk knob): local sums in agent
    # order, then across shards.
    n = psum([torch.sum(v, dim=agents_axis) for _k, _w, _c, _r, v in shards],
             device)
    s1 = psum([_ordered_sum(torch.where(v, c, 0.0), agents_axis)
               for _k, _w, c, _r, v in shards], device)
    s2 = psum([_ordered_sum(torch.where(v, c * c, 0.0), agents_axis)
               for _k, _w, c, _r, v in shards], device)
    nf = torch.clamp_min(n, 1).to(f32)
    mean = s1 / nf
    # s2/n − mean², contracted into one fused multiply-add as XLA does.
    variance = torch.clamp_min(fma(s2 / nf, -mean, mean), 0.0)

    return RingTieBreakResult(
        prediction=prediction,
        weight_density=d1,
        max_reliability=r1,
        resolved_by=resolved_by,
        num_groups=num_groups,
        confidence_variance=variance,
    )


def _ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over *dim* one slice at a time, in index order."""
    shape = x.shape[:dim] + x.shape[dim + 1:]
    total = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i in range(x.shape[dim]):
        total = total + x.select(dim, i)
    return total


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum over the last dim, left to right."""
    out = torch.empty_like(x)
    total = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        total = total + x[..., i]
        out[..., i] = total
    return out


class BatchTieBreakResult(NamedTuple):
    """Per-market outputs of :func:`batched_tiebreak`; the fields of
    :class:`RingTieBreakResult`.

    ``resolved_by``: 0 unanimous, 1 weight_density, 2
    prediction_value_smallest. A row with no valid agent reports
    ``prediction = NaN`` and zeroed stats (the ring path reports ±inf).
    ``prediction`` is always the winning key rescaled, a one-agent row
    included.
    """

    prediction: torch.Tensor           # f32[M] winning (rounded) prediction
    weight_density: torch.Tensor       # f32[M]
    max_reliability: torch.Tensor      # f32[M]
    resolved_by: torch.Tensor          # i32[M]
    num_groups: torch.Tensor           # i32[M]
    confidence_variance: torch.Tensor  # f32[M] population variance


def batched_tiebreak(pred, weight, conf, rel, valid, precision: int = 6
                     ) -> BatchTieBreakResult:
    """Resolve every market row's conflict in one batched pass.

    ``pred``, ``weight``, ``conf``, ``rel`` and ``valid`` (bool) are
    (M, A) blocks, agents last. Computed in float32, as the JAX package
    computes it under ``jax.jit`` (``build_batched_tiebreak``).
    """
    f32 = torch.float32
    neg = -torch.inf
    device = pred.device
    num_agents = pred.shape[-1]
    scale = 10.0**precision
    keys = torch.round(pred.to(f32) * scale).to(torch.int32)
    keys = torch.where(valid, keys, _SENTINEL)

    # jnp.argsort is stable; the order inside a group moves the running
    # sums below, so torch's must be too.
    order = torch.argsort(keys, dim=-1, stable=True)
    sk = torch.gather(keys, -1, order)
    sw = torch.gather(weight.to(f32), -1, order)
    sr = torch.gather(rel.to(f32), -1, order)
    sv = sk != _SENTINEL

    edge = torch.ones_like(sk[..., :1], dtype=torch.bool)
    boundary = sk[..., 1:] != sk[..., :-1]
    starts = torch.cat([edge, boundary], dim=-1)
    ends = torch.cat([boundary, edge], dim=-1)
    idx = torch.arange(num_agents, dtype=torch.int64, device=device)
    start_idx = torch.cummax(torch.where(starts, idx, 0), dim=-1).values
    end_idx = torch.flip(torch.cummin(
        torch.flip(torch.where(ends, idx, num_agents - 1), [-1]), dim=-1
    ).values, [-1])

    # Group weight totals as differences of a running sum in XLA CPU's
    # cumsum order (torch.cumsum adds in another one), and the group's
    # maximum reliability as a running maximum that restarts at each group
    # (exact in any order).
    cw = _running_sum(torch.where(sv, sw, 0.0))
    run_max = torch.empty_like(sr)
    best = torch.full_like(sr[..., 0], neg)
    r_valid = torch.where(sv, sr, neg)
    for i in range(num_agents):
        best = torch.where(starts[..., i], r_valid[..., i],
                           torch.maximum(best, r_valid[..., i]))
        run_max[..., i] = best
    base = torch.where(
        start_idx > 0,
        torch.gather(cw, -1, torch.clamp_min(start_idx - 1, 0)),
        0.0,
    )
    total_w = torch.gather(cw, -1, end_idx) - base
    count = (end_idx - start_idx + 1).to(f32)
    density = total_w / count
    group_max_rel = torch.gather(run_max, -1, end_idx)

    # One candidate lane per real group; the hierarchy as masked
    # reductions: max density, then max reliability, then smallest key.
    cand = starts & sv
    d_c = torch.where(cand, density, neg)
    best_d = torch.amax(d_c, dim=-1, keepdim=True)
    tier1 = cand & (d_c == best_d)
    r_c = torch.where(tier1, group_max_rel, neg)
    best_r = torch.amax(r_c, dim=-1, keepdim=True)
    tier2 = tier1 & (r_c == best_r)
    k_c = torch.where(tier2, sk, _SENTINEL)
    best_k = torch.amin(k_c, dim=-1, keepdim=True)

    # The runner-up: the winner's group masked out, the same hierarchy.
    others = cand & (sk != best_k)
    any_other = torch.any(others, dim=-1)
    d_o = torch.where(others, density, neg)
    ru_d = torch.amax(d_o, dim=-1, keepdim=True)
    r_o = torch.where(others & (d_o == ru_d), group_max_rel, neg)
    ru_r = torch.amax(r_o, dim=-1, keepdim=True)

    full_tie = ((best_d == ru_d) & (best_r == ru_r))[..., 0]
    resolved_by = torch.where(
        ~any_other, 0, torch.where(full_tie, 2, 1)
    ).to(torch.int32)

    # Population confidence variance over the valid agents, both sums in
    # agent order.
    conff = conf.to(f32)
    agents_axis = conff.dim() - 1
    n = torch.sum(valid, dim=-1)
    nf = torch.clamp_min(n, 1).to(f32)
    mean = _ordered_sum(torch.where(valid, conff, 0.0), agents_axis) / nf
    variance = _ordered_sum(
        torch.where(valid, (conff - mean[..., None]) ** 2, 0.0), agents_axis
    ) / nf

    empty = n == 0
    # XLA turns the division by the constant scale into a multiplication
    # by its float32 reciprocal; so does the port.
    recip = torch.tensor(np.float32(1.0) / np.float32(scale), device=device)
    return BatchTieBreakResult(
        prediction=torch.where(empty, torch.nan, best_k[..., 0].to(f32) * recip),
        weight_density=torch.where(empty, 0.0, best_d[..., 0]),
        max_reliability=torch.where(empty, 0.0, best_r[..., 0]),
        resolved_by=torch.where(empty, 0, resolved_by).to(torch.int32),
        num_groups=torch.where(
            empty, 0, torch.sum(cand, dim=-1)
        ).to(torch.int32),
        confidence_variance=variance,
    )


def build_batched_tiebreak(precision: int = 6):
    """:func:`batched_tiebreak` at a fixed *precision*:
    ``fn(pred, weight, conf, rel, valid)``. The JAX package jit-compiles
    it; the port has no compile step, so this is a closure."""

    def tiebreak(pred, weight, conf, rel, valid):
        return batched_tiebreak(pred, weight, conf, rel, valid, precision)

    return tiebreak
