"""Journal-driven recovery onto a degraded membership view — the torch
twin of the JAX package's ``cluster/recover.py``.

Host loss costs one membership epoch and a journal replay, never the
service. The durable truth of a band is its append-only journal
(:mod:`~.state.journal`): each host's journal replays to exactly its
band's store, whatever mesh wrote it (replay is host-side row
arithmetic). Recovery is therefore composition:

* :func:`replay_cluster_journals` merges N band journals into ONE fresh
  store, deterministically: journals in the given order, each journal's
  pairs interned in its own replay order. A one-journal merge is
  bit-equal to :func:`~.state.journal.replay_journal` by construction
  (same frame walk, same intern order, same value writes).
* :func:`adopt_journal` replays a dead band's journal INTO a live
  surviving store mid-stream: the survivor interns the orphan pairs
  (disjoint from its own by the band partition — enforced), absorbs the
  replayed values, and its resident session picks the rows up on the next
  batch's adopt (entering rows, uploaded host-exact). The survivor's own
  next journal epoch then carries the adopted band.
* :func:`extract_cluster_trace` merges the bands' trace sidecars into one
  replayable workload, and :func:`store_digest` is the order-sensitive
  content digest of a store — the byte coda's witness. A port store and a
  JAX-package store holding the same rows in the same order give the same
  digest.

Split-brain is refused, not merged: a (source, market) pair appearing in
two journals means two hosts both claimed its band — recovery raises
rather than guess which history wins.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from time import perf_counter
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from bayesian_consensus_engine_tpu_torch.obs.trace import active_tracer
from bayesian_consensus_engine_tpu_torch.state.journal import (
    MAGIC,
    TornTraceError,
    TraceBatch,
    _iter_frames,
    _read_exact,
    extract_trace,
)

#: Trace scope for live-recovery spans (obs/trace.py). Recovery runs
#: between batches on a surviving host; :func:`adopt_journal` records its
#: start before the replay walk, so a dispatch failure mid-adoption leaves
#: a flight ring with an ``adopt_start`` and no ``adopt_done``.
RECOVERY_SCOPE = "recovery"


class ClusterModeUnsupported(RuntimeError):
    """A cluster deployment asked for a route that is not served on this
    topology. The message names the supported route (the shared-nothing
    band membership of :class:`~.cluster.membership.MeshView`)."""


@dataclass
class ClusterReplay:
    """The result of merging band journals onto one store.

    ``tags[i]`` is journal *i*'s last complete epoch watermark (``None``
    for a journal with no complete epoch) — with ``settle_stream``'s
    ``journal=`` mode, the last durably covered settled batch index of
    that band; the band resumes from ``tags[i] + 1``. ``rows[i]`` is how
    many interned rows journal *i* contributed.
    """

    store: object
    paths: Tuple[str, ...]
    tags: Tuple[Optional[int], ...]
    rows: Tuple[int, ...]

    def resume_index(self, which: int) -> int:
        """First un-durable batch index of band *which* (0 when the
        journal held no complete epoch)."""
        tag = self.tags[which]
        return 0 if tag is None else tag + 1


def _replay_into(store, path: str) -> Tuple[Optional[int], int]:
    """Replay *path*'s epochs into *store*, remapping journal-local rows
    onto the store's interner. Returns ``(last_tag, rows_contributed)``.

    The journal's pairs intern in replay order — for a fresh store and a
    single journal that reproduces :func:`~.state.journal.replay_journal`
    row for row; for a merge, each journal's block appends after the
    previous journals' rows, and any pair already interned (an
    overlapping band) is a split-brain refusal.
    """
    row_map: List[int] = []
    last_tag: Optional[int] = None
    with open(path, "rb") as f:
        if _read_exact(f, len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a BCE journal (bad magic)")
        for fields, decoded, _off in _iter_frames(f):
            tag = fields[6]
            pairs, idx, rel, conf, days, exists, iso_values = decoded
            if pairs:
                before = len(store)
                rows = store.rows_for_pairs(pairs, allocate=True)
                if list(rows) != list(range(before, before + len(pairs))):
                    raise ValueError(
                        f"{path}: journal pairs overlap rows already "
                        "replayed from another journal — two hosts "
                        "claimed the same band (split-brain); refusing "
                        "to merge"
                    )
                row_map.extend(int(r) for r in rows)
            mapped = np.asarray(row_map, dtype=np.int64)[idx.astype(np.int64)]
            store.absorb_replayed_rows(
                mapped, rel, conf, days, exists.astype(bool), iso_values
            )
            last_tag = int(tag)
    return last_tag, len(row_map)


def replay_cluster_journals(
    paths: Sequence[Union[str, Path]], device=None
) -> ClusterReplay:
    """Rebuild ONE store from N band journals, deterministically.

    Journals replay in the order given (every surviving host must pass
    the SAME order to agree on row assignment; the kill soak sorts by
    path). Each journal's contribution is exactly what
    :func:`~.state.journal.replay_journal` would rebuild from it alone: a
    one-journal call is bit-equal to ``replay_journal``. The store is
    built on *device* (``None``: CUDA, raising without it), as
    ``replay_journal``'s is.
    """
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    if not paths:
        raise ValueError("no journals to replay")
    store = TensorReliabilityStore(device=device)
    tags: List[Optional[int]] = []
    rows: List[int] = []
    for path in paths:
        tag, contributed = _replay_into(store, str(path))
        tags.append(tag)
        rows.append(contributed)
    return ClusterReplay(
        store=store,
        paths=tuple(str(p) for p in paths),
        tags=tuple(tags),
        rows=tuple(rows),
    )


def adopt_journal(store, path: Union[str, Path]) -> Tuple[Optional[int], int]:
    """Replay a dead band's journal INTO a live surviving *store*.

    The survivor-side half of degraded-mesh recovery, called between
    batches: it appends the orphan band's pairs to the live interner and
    absorbs its replayed values on the store's own device, so the next
    batch that covers the orphan markets finds host-exact state and the
    resident session's adopt carries it onto the device block as entering
    rows. Returns ``(last_tag, rows_adopted)`` — the orphan band's
    workload resumes from ``last_tag + 1``. The adopted rows are fresh by
    the band partition (an overlap raises — split-brain), hence disjoint
    from every pending device recipe of the live stream.

    With an active tracer the adoption records a ``recovery``-scope span
    chain (``adopt_start`` before the replay walk, ``adopt_done`` with the
    rows and tag after) on its own flight-recorder component.
    """
    tracer = active_tracer()
    if tracer.enabled:
        tracer.span_event(
            RECOVERY_SCOPE, 0, "adopt_start",
            args={"journal": str(path)}, component="recovery",
        )
    start = perf_counter()
    tag, rows_adopted = _replay_into(store, str(path))
    if tracer.enabled:
        tracer.span_event(
            RECOVERY_SCOPE, 0, "adopt_done",
            dur_s=perf_counter() - start,
            args={
                "journal": str(path),
                "rows_adopted": rows_adopted,
                "tag": tag,
            },
            component="recovery",
        )
    return tag, rows_adopted


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
