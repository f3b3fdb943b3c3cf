"""Fleet traces and the store digest — the part of the JAX package's
``cluster/recover.py`` the replay lab reads.

* :func:`extract_cluster_trace` merges N band journals' trace sidecars
  into one replayable workload, each bounded by its own journal's durable
  tag as :func:`~.state.journal.extract_trace` bounds one host's.
* :func:`store_digest` is the order-sensitive content digest of a store's
  replayable state, the witness of the replay lab's lane-0 byte contract.
  A port store and a JAX-package store holding the same rows in the same
  order give the same digest.

The rest of the module (``replay_cluster_journals``, ``adopt_journal``)
comes with the cluster slice, ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from bayesian_consensus_engine_tpu_torch.state.journal import (
    TornTraceError,
    TraceBatch,
    extract_trace,
)


def extract_cluster_trace(
    paths: Sequence[Union[str, Path]],
    strict: bool = False,
) -> Tuple[List[TraceBatch], Tuple[Optional[int], ...]]:
    """Merge N band journals' trace sidecars into ONE replayable workload.

    Each band's trace (``<journal>.trace``) is bounded by its own
    journal's durable tag, then batch ``i`` of the merged workload
    concatenates every band's batch ``i`` in the order *paths* are given.
    The merged length is the SHORTEST band's covered prefix;
    ``strict=True`` refuses (:class:`~.state.journal.TornTraceError`)
    when bands disagree on it. Bands must agree on each batch's
    settlement day and step count (record with an explicit ``now``
    schedule).

    Returns ``(batches, tags)`` with ``tags[i]`` journal *i*'s watermark.
    """
    if not paths:
        raise ValueError("no journals to extract a trace from")
    per_band: List[List[TraceBatch]] = []
    tags: List[Optional[int]] = []
    for path in paths:
        covered, tag = extract_trace(str(path), strict=strict)
        per_band.append(covered)
        tags.append(tag)
    length = min(len(covered) for covered in per_band)
    if strict and any(len(covered) != length for covered in per_band):
        raise TornTraceError(
            "bands disagree on the covered batch count "
            f"({[len(c) for c in per_band]}); strict replay refuses a "
            "workload some band never made durable"
        )
    merged: List[TraceBatch] = []
    for i in range(length):
        bands = [covered[i] for covered in per_band]
        first = bands[0]
        for band_batch, path in zip(bands, paths):
            if band_batch.now_days != first.now_days or (
                band_batch.steps != first.steps
            ):
                raise ValueError(
                    f"{path}: batch {i} settlement day/steps "
                    f"({band_batch.now_days}, {band_batch.steps}) disagree "
                    f"with {paths[0]} ({first.now_days}, {first.steps}); "
                    "merged replay needs an explicit now schedule"
                )
        offsets = [0]
        for band_batch in bands:
            for width in np.diff(band_batch.offsets):
                offsets.append(offsets[-1] + int(width))
        merged.append(
            TraceBatch(
                index=i,
                market_keys=tuple(k for b in bands for k in b.market_keys),
                source_ids=tuple(s for b in bands for s in b.source_ids),
                probabilities=np.concatenate([b.probabilities for b in bands]),
                offsets=np.asarray(offsets, dtype=np.int64),
                outcomes=np.concatenate([b.outcomes for b in bands]),
                now_days=first.now_days,
                steps=first.steps,
            )
        )
    return merged, tuple(tags)


def store_digest(store) -> str:
    """Order-sensitive content digest of a store's replayable state.

    Hashes the interned pair list (in row order), the four value columns
    and the ISO sidecars, length-delimited. Two stores with equal digests
    hold bit-identical state in identical row order. Deferred device
    settlements are synced first (the digest is of the durable truth).
    """
    store.sync()
    used = len(store)
    h = hashlib.blake2b(digest_size=16)

    def put(raw: bytes) -> None:
        h.update(len(raw).to_bytes(8, "little"))
        h.update(raw)

    for source_id, market_id in store._pairs.ids():
        put(source_id.encode())
        put(market_id.encode())
    put(np.ascontiguousarray(store._rel[:used]).tobytes())
    put(np.ascontiguousarray(store._conf[:used]).tobytes())
    put(np.ascontiguousarray(store._days[:used]).tobytes())
    put(np.ascontiguousarray(store._exists[:used]).tobytes())
    for value in store._iso[:used]:
        put(value.encode())
    return h.hexdigest()
