"""Per-market uncertainty bands — the torch twin of ``ops/uncertainty.py``.

Per market, from the signalling slots' probabilities ``p`` and decayed
read reliabilities ``w`` (the weights the consensus gives them):

  Σw, Σw·p, Σw·p², Σw²  →  weighted mean, weighted population variance,
  Kish effective sample size n_eff = (Σw)²/Σw², standard error
  sqrt(var / n_eff), and the band [mean − z·se, mean + z·se] clipped to
  [0, 1].

**The accumulation order is part of the contract.** The four sums go
through one fixed balanced binary tree over the slots axis, padded with
+0.0 to the next power of two, adding ADJACENT pairs (leaf 2i with 2i+1)
level by level. ``chunk_slots`` is rounded down to a power of two that
divides the padded width, so each chunk's tree is a subtree of the global
one and the fold of the chunk roots by the same tree rebuilds its upper
levels: every chunk setting gives the same bits. ``torch.sum`` does not
add in this order, so :func:`_tree_sum` builds the tree by hand; the
one-pass kernel (``csrc/onepass_settle.cu``) reproduces it per market.

On a sources-sharded mesh each shard reduces its local slots with the same
tree, and :func:`band_merge` folds the shards' roots in fixed mesh order
with the same tree again (padded with zero roots to a power-of-two shard
count); when the local width is a power of two the shard boundaries fall
on subtree boundaries and every mesh gives the one-device bits. The sums are always float32, whatever the state's
dtype: :func:`band_sums` casts first, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from bayesian_consensus_engine_tpu_torch.ops.fma import fma
from bayesian_consensus_engine_tpu_torch.ops.collectives import (
    all_gather,
    psum,
)

#: Two-sided 95% normal quantile — the default band width.
Z_95 = 1.959964

#: Recorded default chunk width of the band accumulation (rounded down to
#: a power of two at resolve time).
DEFAULT_CHUNK_SLOTS = 1024


class UncertaintyBands(NamedTuple):
    """Per-market credible-interval outputs.

    A market with zero total weight reports NaN mean/lo/hi and zero
    dispersion, as the consensus reports NaN there.
    """

    mean: torch.Tensor    # f32[M] tree-ordered weighted mean
    lo: torch.Tensor      # f32[M] mean − z·stderr, clipped to [0, 1]
    hi: torch.Tensor      # f32[M] mean + z·stderr, clipped to [0, 1]
    stderr: torch.Tensor  # f32[M] sqrt(variance / n_eff)
    n_eff: torch.Tensor   # f32[M] (Σw)²/Σw²
    count: torch.Tensor   # i32[M] signalling slots


def _pow2_at_most(n: int) -> int:
    """Largest power of two ≤ *n* (n ≥ 1)."""
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _pow2_at_least(n: int) -> int:
    """Smallest power of two ≥ *n* (min 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def resolve_chunk_slots(chunk_slots: "int | None", width: int) -> int:
    """The chunk knob as a power of two dividing the padded width;
    ``None`` (or anything wider) is one full-width chunk."""
    padded = _pow2_at_least(max(width, 1))
    if chunk_slots is None:
        return padded
    return min(_pow2_at_most(max(int(chunk_slots), 1)), padded)


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Balanced-tree sum over a power-of-two-wide *dim*: adjacent pairs,
    log2(width) times. The pairing depends only on the width."""
    while x.shape[dim] > 1:
        pairs = x.unflatten(dim, (x.shape[dim] // 2, 2))
        x = pairs.select(dim + 1, 0) + pairs.select(dim + 1, 1)
    return x.squeeze(dim)


def _pad_pow2(x: torch.Tensor, dim: int, fill) -> torch.Tensor:
    """Pad *dim* up to the next power of two with *fill*."""
    width = x.shape[dim]
    padded = _pow2_at_least(max(width, 1))
    if padded == width:
        return x
    shape = list(x.shape)
    shape[dim] = padded - width
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=dim)


def band_sums(
    probs: torch.Tensor,
    mask: torch.Tensor,
    read_rel: torch.Tensor,
    *,
    chunk_slots: "int | None" = None,
    agents_last: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The four tree-accumulated band moments: ``(sums, count)`` with
    ``sums`` the f32 (4, M) stack Σw / Σw·p / Σw·p² / Σw² and ``count``
    the i32 per-market number of signalling slots."""
    f32 = torch.float32
    slots_axis = 1 if agents_last else 0
    local_width = probs.shape[slots_axis]

    probs = _pad_pow2(probs.to(f32), slots_axis, 0.0)
    read_rel = _pad_pow2(read_rel.to(f32), slots_axis, 0.0)
    mask = _pad_pow2(mask, slots_axis, False)
    padded_width = probs.shape[slots_axis]
    chunk = resolve_chunk_slots(chunk_slots, local_width)

    def chunk_roots(offset):
        p = probs.narrow(slots_axis, offset, chunk)
        r = read_rel.narrow(slots_axis, offset, chunk)
        m = mask.narrow(slots_axis, offset, chunk)
        w = torch.where(m, r, 0.0)
        wp = w * p
        contributions = torch.stack([w, wp, wp * p, w * w])
        return _tree_sum(contributions, slots_axis + 1)

    roots = [chunk_roots(offset) for offset in range(0, padded_width, chunk)]
    # The cross-chunk fold is the upper levels of the same tree: chunk i's
    # root is leaf i, and the chunk count is a power of two.
    sums = roots[0] if len(roots) == 1 else _tree_sum(torch.stack(roots), 0)
    count = torch.sum(mask, dim=slots_axis).to(torch.int32)
    return sums, count


def band_merge(
    shard_sums: Sequence[torch.Tensor],
    shard_counts: Sequence[torch.Tensor],
    device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold the sources shards' band-moment roots (one (4, M) tensor and
    one i32 (M,) count per shard, in mesh order) into the axis's
    ``(sums, count)`` on *device*: the roots all-gathered, zero-padded to
    a power-of-two shard count and folded by the same balanced tree, the
    counts summed. One shard is the identity."""
    if len(shard_sums) == 1:
        return shard_sums[0].to(device), shard_counts[0].to(device)
    gathered = _pad_pow2(all_gather(shard_sums, device), 0, 0.0)
    return _tree_sum(gathered, 0), psum(shard_counts, device)


def band_epilogue(
    sums: torch.Tensor, count: torch.Tensor, z: float = Z_95,
) -> UncertaintyBands:
    """Moments → credible intervals, elementwise over (M,) vectors.

    The JAX package puts an optimization barrier before ``μ²`` feeds the
    variance subtraction and before ``z·stderr`` feeds lo/hi. XLA's CPU
    backend (the reference the tests hold the port against) drops those
    barriers and contracts both sites into fused multiply-adds, so the
    port computes them with :func:`~.ops.fma.fma`.
    """
    f32 = torch.float32
    sw, swp, swp2, sw2 = sums[0], sums[1], sums[2], sums[3]
    has_weight = sw != 0
    safe_w = torch.where(has_weight, sw, 1.0)
    mean = torch.where(has_weight, swp / safe_w, torch.nan)
    ex2 = torch.where(has_weight, swp2 / safe_w, 0.0)
    mean0 = torch.where(has_weight, mean, 0.0)
    variance = torch.clamp_min(fma(ex2, -mean0, mean0), 0.0)
    positive = sw2 > 0
    n_eff = torch.where(positive, (sw * sw) / torch.where(positive, sw2, 1.0), 0.0)
    # The square root is taken in float64 and rounded once to float32,
    # which is the correctly rounded float32 root (torch's CPU float32
    # sqrt is not correctly rounded; XLA's is).
    ratio = variance / torch.clamp_min(n_eff, 1e-30)
    stderr = torch.where(n_eff > 0, torch.sqrt(ratio.double()).to(f32), 0.0)
    z32 = torch.tensor(z, dtype=f32, device=sums.device)
    lo = torch.clamp(fma(mean, -z32, stderr), 0.0, 1.0)
    hi = torch.clamp(fma(mean, z32, stderr), 0.0, 1.0)
    return UncertaintyBands(
        mean=mean, lo=lo, hi=hi, stderr=stderr, n_eff=n_eff, count=count
    )


def band_math(
    probs: torch.Tensor,
    mask: torch.Tensor,
    read_rel: torch.Tensor,
    *,
    z: float = Z_95,
    chunk_slots: "int | None" = None,
    agents_last: bool = True,
) -> UncertaintyBands:
    """Credible intervals for one device: :func:`band_sums` then
    :func:`band_epilogue`. ``read_rel`` is the decayed read reliability
    at the settle's ``now`` (``ops.cycle_math.read_phase``)."""
    sums, count = band_sums(
        probs, mask, read_rel, chunk_slots=chunk_slots, agents_last=agents_last,
    )
    return band_epilogue(sums, count, z)
