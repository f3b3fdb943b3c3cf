"""Batched consensus sums as ordered segment sums — the device half of the
batched engine (``core.batch.run_packed``).

The JAX package computes three things with ``jax.ops.segment_sum``:

  per (market, source) pair:  p̄  = mean of that pair's raw signals
  per market:                 Σw, Σ p̄·w, Σ c·w

XLA adds each segment's elements one after another in element order,
starting from +0.0, with each product rounded before it is added. The port
reproduces that order on both devices, so the CPU, the card and the JAX
package give the same bits. ``index_add_``, ``scatter_add_`` and
``index_put_(accumulate=True)`` cannot do it: on CUDA they add floats with
atomics, in no fixed order. Instead :func:`ordered_segment_sum`

  1. sorts the segment ids stably, so each segment's elements keep their
     original order;
  2. gives each element its rank inside its segment;
  3. for rank r = 0, 1, … up to the longest segment adds the elements of
     rank r into their segments. Within one rank the segments are unique,
     so the gather, add and write-back has no conflicting writes.

It takes as many rounds as the longest segment, and never pads to a dense
(segments × longest) block. Integer work (the sorts, the ranks) is exact,
and the only float operations are the adds in rank order, the products and
the divide of the means, each rounded once in the tensor's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def ordered_segment_sum(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    rounds: Optional[list] = None,
) -> torch.Tensor:
    """``out[s] = ((0 + v_i0) + v_i1) + …`` over the elements of segment *s*
    in their original order, for ``values`` of shape ``(N,)`` or ``(N, C)``
    (each column summed on its own) and int ``segment_ids`` in
    ``[0, num_segments)`` on the same device. Appends the number of rounds
    (the longest segment's length) to *rounds* when it is given."""
    device = values.device
    out = torch.zeros(
        (num_segments, *values.shape[1:]), dtype=values.dtype, device=device
    )
    n = int(segment_ids.shape[0])
    if n == 0:
        if rounds is not None:
            rounds.append(0)
        return out
    segment_ids = segment_ids.to(device=device, dtype=torch.int64)
    sorted_ids, order = torch.sort(segment_ids, stable=True)
    starts = torch.searchsorted(
        sorted_ids, torch.arange(num_segments, device=device)
    )
    rank = torch.arange(n, device=device) - starts[sorted_ids]
    by_rank_key, by_rank = torch.sort(rank, stable=True)
    # Every rank below the longest segment's length is present, so the run
    # lengths of the sorted ranks are the rounds' sizes (one host sync).
    sizes = torch.unique_consecutive(by_rank_key, return_counts=True)[1].tolist()
    ids = sorted_ids[by_rank]
    terms = values[order[by_rank]]
    lo = 0
    for size in sizes:
        segments = ids[lo:lo + size]
        out[segments] = out[segments] + terms[lo:lo + size]
        lo += size
    if rounds is not None:
        rounds.append(len(sizes))
    return out


def pair_mean_from_flat(
    flat_probs: torch.Tensor,   # f[N]   one entry per raw signal
    flat_pair: torch.Tensor,    # int[N] pair row for each signal
    num_pairs: int,
    rounds: Optional[list] = None,
) -> torch.Tensor:
    """Mean probability per (market, source) pair (duplicate-signal
    averaging), in the JAX package's float order: the ordered sum of the
    signals over the ordered count of them; a pair with no signals keeps
    0."""
    ones = torch.ones_like(flat_probs)
    sums, counts = ordered_segment_sum(
        torch.stack([flat_probs, ones], dim=1), flat_pair, num_pairs, rounds
    ).unbind(1)
    return torch.where(
        counts > 0, sums / torch.clamp(counts, min=1), torch.zeros_like(sums)
    )


def weighted_sums_from_pairs(
    pair_mean: torch.Tensor,         # f[P]   mean probability per pair
    pair_reliability: torch.Tensor,  # f[P]   weight per pair
    pair_confidence: torch.Tensor,   # f[P]
    pair_market: torch.Tensor,       # int[P] market row per pair
    num_markets: int,
    rounds: Optional[list] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-market ``(Σw, Σ p̄·w, Σ c·w)``, each ``f[M]``, in one ordered
    pass. The two normalising divides are left to the caller: the document
    formatter divides on the host."""
    terms = torch.stack(
        [
            pair_reliability,
            pair_mean * pair_reliability,
            pair_confidence * pair_reliability,
        ],
        dim=1,
    )
    total_weight, weighted_prob, weighted_conf = ordered_segment_sum(
        terms, pair_market, num_markets, rounds
    ).unbind(1)
    return total_weight, weighted_prob, weighted_conf
