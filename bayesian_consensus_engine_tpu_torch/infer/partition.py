"""Cross-band market-graph partitioning with an explicit halo exchange — the
port of the JAX package's ``infer/partition.py``.

Band plans split the markets axis into contiguous row ranges, but the
graph sweep gathers neighbours from the whole axis. :func:`partition_csr`
splits the aligned dense neighbour blocks
(:meth:`~.analytics.graph.MarketGraph.align`) into band-local blocks whose
out-of-band references are remapped onto a per-band **halo**: the sorted
boundary positions other bands own. :func:`banded_bp_sweep` then runs the
sweep band by band, exchanging only halo moments between iterations
(:func:`exchange_halos`).

Bit parity with the whole-axis sweep follows from the sweep's shape: each
row's update reads exactly its neighbours' values and reduces over its own
lanes, so a band iterating over ``[own rows ; halo values]`` sees the same
operands in the same order (the ghost-zone argument). The residual is a
max, exactly associative, so the fold of the bands' maxima is the whole
axis's residual and every banding takes the same early exit.

A band's iteration is one sweep of ``[own ; halo]`` in which the halo rows
have no neighbours (rows of ``-1``): they do not mix, their ``|Δmean|`` is
0, and the sweep's residual is the band's. So each band step is one
``ops/bp_kernel.py::bp_sweep`` call with ``max_steps=1`` and no tolerance:
one launch of the hand-written sweep kernel on CUDA tensors, its plain
version on CPU tensors. The call reads its residual (the JAX package's
band step returns it), so it fuses the same product of the blend as the
whole-axis sweep with its residual read (``keep_fma=None``), which keeps
the banded result bit-equal to one whole-axis ``bp_sweep``.

The bands run one after another in one process, as in the reference:
the honest single-process form of the multi-host exchange.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.ops.bp_kernel import bp_sweep


class BandBlock(NamedTuple):
    """One band's local view of the dense neighbour blocks.

    ``neighbor_idx`` is remapped: position ``p < rows`` is the band's own
    row ``lo + p``; position ``p >= rows`` is halo entry ``p - rows``;
    ``-1`` stays padding. ``halo`` holds the global positions this band
    must import each iteration, sorted ascending; ``halo_owner`` and
    ``halo_local`` locate each entry in its owning band's local array (the
    exchange routing table).
    """

    lo: int
    hi: int
    neighbor_idx: np.ndarray
    neighbor_w: np.ndarray
    halo: np.ndarray
    halo_owner: np.ndarray
    halo_local: np.ndarray


class BandedGraph(NamedTuple):
    """The partitioned graph: per-band blocks and exchange metadata."""

    blocks: Tuple[BandBlock, ...]
    num_markets: int
    cross_edges: int


def partition_csr(
    neighbor_idx,
    neighbor_w,
    bands: Sequence[Tuple[int, int]],
) -> BandedGraph:
    """Split aligned ``(T, D)`` neighbour blocks into band-local blocks.

    *bands* is a sequence of ``(lo, hi)`` row ranges that must tile
    ``[0, T)`` contiguously in order (the band-plan layout). Each band's
    out-of-band neighbour references are collected into its halo and
    remapped; ``cross_edges`` counts the remapped references (the exchange
    volume the halo saves against a full gather). Host numpy throughout.
    """
    idx = np.asarray(neighbor_idx, np.int32)
    w = np.asarray(neighbor_w, np.float32)
    total = idx.shape[0]
    spans = [(int(lo), int(hi)) for lo, hi in bands]
    cursor = 0
    for lo, hi in spans:
        if lo != cursor or hi <= lo:
            raise ValueError(
                f"bands must tile [0, {total}) contiguously in order; "
                f"got span ({lo}, {hi}) at cursor {cursor}"
            )
        cursor = hi
    if cursor != total:
        raise ValueError(
            f"bands cover [0, {cursor}) but the neighbour blocks have "
            f"{total} rows"
        )

    los = np.asarray([lo for lo, _ in spans], np.int64)
    blocks = []
    cross_edges = 0
    for lo, hi in spans:
        rows = idx[lo:hi]
        valid = rows >= 0
        local = valid & (rows >= lo) & (rows < hi)
        remote = valid & ~local
        cross_edges += int(remote.sum())
        halo = np.unique(rows[remote]).astype(np.int32)
        size = hi - lo
        remapped = np.full_like(rows, -1)
        remapped[local] = rows[local] - lo
        if halo.size:
            remapped[remote] = size + np.searchsorted(
                halo, rows[remote]
            ).astype(np.int32)
        owner = np.searchsorted(los, halo, side="right").astype(np.int32) - 1
        halo_local = halo - los[owner].astype(np.int32)
        blocks.append(BandBlock(
            lo=lo,
            hi=hi,
            neighbor_idx=remapped,
            neighbor_w=w[lo:hi],
            halo=halo,
            halo_owner=owner,
            halo_local=halo_local.astype(np.int32),
        ))
    return BandedGraph(
        blocks=tuple(blocks), num_markets=total, cross_edges=cross_edges
    )


def _routes(banded: BandedGraph, device) -> list:
    """Per band, its halo's sources in halo order: ``[(owner, owner-local
    positions on *device*), ...]``. The halo is sorted and the bands tile
    the axis in order, so each owner's entries are one contiguous run."""
    routes = []
    for block in banded.blocks:
        runs = []
        owners = block.halo_owner
        start = 0
        while start < owners.size:
            stop = start + int(np.searchsorted(owners[start:], owners[start],
                                               side="right"))
            runs.append((
                int(owners[start]),
                torch.as_tensor(block.halo_local[start:stop].astype(np.int64),
                                device=device),
            ))
            start = stop
        routes.append(runs)
    return routes


def _exchange(band_values, routes, device) -> list:
    """Each band's halo vector: ``index_select`` from each owner's local
    vector, the runs joined in halo order."""
    out = []
    for runs in routes:
        if not runs:
            out.append(torch.zeros(0, dtype=torch.float32, device=device))
            continue
        pieces = [band_values[owner].to(torch.float32).index_select(0, local)
                  for owner, local in runs]
        out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces))
    return out


def exchange_halos(band_values, banded: BandedGraph):
    """One exchange round: each band's halo values, gathered from owners.

    *band_values* is the per-band list of local float32 vectors (tensors on
    one device); returns the per-band list of halo vectors on that device
    (empty where a band needs nothing). Only halo positions move: no band
    ever materialises the global axis.
    """
    device = band_values[0].device
    return _exchange(band_values, _routes(banded, device), device)


def banded_bp_sweep(
    means,
    variances,
    banded: BandedGraph,
    *,
    damping: float,
    max_steps: int,
    tol: Optional[float] = None,
):
    """The banded moment sweep, with a halo exchange between iterations.

    Same arguments and results as :func:`~.ops.propagate.bp_sweep_math`:
    ``(means, variances | None, iters_run, residual)`` over the global
    padded axis, as tensors on *means*' device (float32; the audit pair
    0-d int32 and float32), bit-equal to one whole-axis
    :func:`~.ops.bp_kernel.bp_sweep` on the same inputs. Each iteration
    makes one ``bp_sweep`` call per band (one kernel launch a band on
    CUDA), then folds the bands' residuals on the device. With ``tol`` the
    folded residual is read once an iteration, and the sweep stops once it
    is at or below ``float32(tol)``, as the whole-axis sweep's does;
    without it nothing is read back.
    """
    f32 = torch.float32
    device = means.device
    means = means.to(f32)
    moments = variances is not None
    if moments:
        variances = variances.to(f32)
    blocks = banded.blocks
    band_v = [means[b.lo:b.hi] for b in blocks]
    band_s = [variances[b.lo:b.hi] for b in blocks] if moments else None
    routes = _routes(banded, device)
    steps = []  # per band: neighbour rows [own ; -1 halo rows] on the device
    for block in blocks:
        halo_rows = block.halo.size
        degree = block.neighbor_idx.shape[1]
        steps.append((
            torch.as_tensor(np.concatenate([
                block.neighbor_idx,
                np.full((halo_rows, degree), -1, np.int32),
            ]), device=device),
            torch.as_tensor(np.concatenate([
                block.neighbor_w,
                np.zeros((halo_rows, degree), np.float32),
            ]), device=device),
        ))
    tol_f = None if tol is None else float(np.float32(tol))
    iters = 0
    residual = torch.zeros((), dtype=f32, device=device)
    for _ in range(max(0, int(max_steps))):
        if tol_f is not None and iters > 0 and not float(residual) > tol_f:
            break
        halos_v = _exchange(band_v, routes, device)
        halos_s = _exchange(band_s, routes, device) if moments else None
        deltas = []
        for j, (block, (idx, w)) in enumerate(zip(blocks, steps)):
            rows = block.hi - block.lo
            vec = torch.cat([band_v[j], halos_v[j]])
            var = torch.cat([band_s[j], halos_s[j]]) if moments else None
            new_v, new_s, _one, delta = bp_sweep(
                vec, var, idx, w, damping=damping, max_steps=1, tol=None,
            )
            band_v[j] = new_v[:rows]
            if moments:
                band_s[j] = new_s[:rows]
            deltas.append(delta)
        residual = torch.stack(deltas).amax()
        iters += 1
    out_v = torch.cat(band_v) if band_v else means
    out_s = torch.cat(band_s) if moments and band_s else variances
    return (
        out_v,
        out_s if moments else None,
        torch.tensor(iters, dtype=torch.int32, device=device),
        residual,
    )
