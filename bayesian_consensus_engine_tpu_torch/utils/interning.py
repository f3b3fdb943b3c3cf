"""Id interning — the host boundary between ids and device row indices.

Source/market ids (or (source, market) pair keys) are interned once at
ingest into stable rows; every device-side structure (reliability tensors,
slot blocks) is keyed by row index, and ids are rehydrated only on the host.

The port of ``bayesian_consensus_engine_tpu/utils/interning.py``: the
dict-backed :class:`IdInterner`, and :class:`NativePairInterner` over the
port's own C extension (``native/internmap.c``, built at first use by
``native/build.py``), which assigns the same rows in the same order.
:func:`make_pair_interner` prefers the C interner and falls back to the
dict only for the reasons ``native/build.py`` names (``BCE_NO_NATIVE``, no
compiler, no ``Python.h``).
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Dict, Hashable, Iterable, List, Sequence, Tuple

import numpy as np

from bayesian_consensus_engine_tpu_torch.native import build as _native_build
from bayesian_consensus_engine_tpu_torch.native.build import (  # noqa: F401
    native_disabled,  # the one parse of BCE_NO_NATIVE, re-exported here
)


def _load_internmap(force: bool = False):
    """The C ``internmap`` module, or ``None`` when the Python twins must
    run (``force``: an explicit ``native=True``, which raises instead)."""
    return _native_build.load("internmap", force=force)


class IdInterner:
    """Bidirectional key ↔ row map with first-seen row assignment."""

    __slots__ = ("_to_row", "_to_id")

    def __init__(self) -> None:
        self._to_row: Dict[Hashable, int] = {}
        self._to_id: List[Hashable] = []

    def __len__(self) -> int:
        return len(self._to_id)

    def __contains__(self, identifier: Hashable) -> bool:
        return identifier in self._to_row

    def intern(self, identifier: Hashable) -> int:
        """Return the row for *identifier*, assigning the next row if new."""
        row = self._to_row.get(identifier)
        if row is None:
            row = len(self._to_id)
            self._to_row[identifier] = row
            self._to_id.append(identifier)
        return row

    def intern_all(self, identifiers: Iterable[Hashable]) -> List[int]:
        return [self.intern(i) for i in identifiers]

    def lookup(self, identifier: Hashable) -> int:
        """Row for an already-interned id; raises KeyError if unknown."""
        return self._to_row[identifier]

    def get(self, identifier: Hashable, default: int = -1) -> int:
        return self._to_row.get(identifier, default)

    def id_of(self, row: int) -> Hashable:
        return self._to_id[row]

    def ids(self) -> List[Hashable]:
        """All interned keys in row order (a copy)."""
        return list(self._to_id)

    def items(self):
        """(key, row) pairs."""
        return self._to_row.items()

    # Batch forms (array-returning); keys here are (a, b) string pairs.
    def intern_arrays(
        self, sources: Sequence[str], markets: Sequence[str]
    ) -> np.ndarray:
        return np.asarray(
            [self.intern((s, m)) for s, m in zip(sources, markets)],
            dtype=np.int32,
        )

    def lookup_arrays(
        self, sources: Sequence[str], markets: Sequence[str]
    ) -> np.ndarray:
        return np.asarray(
            [self.get((s, m)) for s, m in zip(sources, markets)], dtype=np.int32
        )


class NativePairInterner:
    """(source, market) → row map over the C ``internmap`` extension.

    Same first-seen row contract and surface as :class:`IdInterner`
    restricted to string-pair keys, plus batch array methods whose hot loop
    runs in one C pass and returns int32 buffers ready for device upload.
    Construct via :func:`make_pair_interner`, which falls back to
    IdInterner when the extension is unavailable.
    """

    __slots__ = ("_map",)

    def __init__(self, _internmap_module=None) -> None:
        module = _internmap_module or _load_internmap(force=True)
        self._map = module.InternMap()

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, pair: Tuple[str, str]) -> bool:
        return self.get(pair) >= 0

    def intern(self, pair: Tuple[str, str]) -> int:
        return self._map.intern_pair(pair[0], pair[1])

    def intern_all(self, pairs: Iterable[Tuple[str, str]]) -> List[int]:
        return [self._map.intern_pair(a, b) for a, b in pairs]

    def lookup(self, pair: Tuple[str, str]) -> int:
        row = self.get(pair)
        if row < 0:
            raise KeyError(pair)
        return row

    def get(self, pair: Tuple[str, str], default: int = -1) -> int:
        # The C pass rejects NUL-containing halves with ValueError on reads
        # too; such a key can never have been interned, so for the read
        # surface it is simply absent, as in the IdInterner fallback.
        try:
            row = self._map.lookup_pair(pair[0], pair[1])
        except ValueError:
            return default
        return row if row >= 0 else default

    def id_of(self, row: int) -> Tuple[str, str]:
        return self._map.id_of(row)

    def ids(self) -> List[Tuple[str, str]]:
        return self._map.ids()

    def items(self):
        return [(key, row) for row, key in enumerate(self._map.ids())]

    def pair_blob(self, lo: int, hi: int) -> bytes:
        """Rows [lo, hi) in the durability journal's pair wire format — one
        C memcpy pass over the key arena."""
        return self._map.pair_blob(lo, hi)

    def intern_arrays(
        self, sources: Sequence[str], markets: Sequence[str]
    ) -> np.ndarray:
        buf = self._map.intern_pairs(sources, markets)
        return np.frombuffer(buf, dtype=np.int32)

    def intern_arrays_indexed(
        self,
        source_table: Sequence[str],
        source_codes: np.ndarray,
        market_table: Sequence[str],
        market_codes: np.ndarray,
    ) -> np.ndarray:
        """Pair interning from (unique table, code) halves — one C pass
        that resolves each table string's UTF-8 once, not once per pair."""
        buf = self._map.intern_pairs_indexed(
            source_table,
            np.ascontiguousarray(source_codes, dtype=np.int32),
            market_table,
            np.ascontiguousarray(market_codes, dtype=np.int32),
        )
        return np.frombuffer(buf, dtype=np.int32)

    def sorted_rows(self, rows: np.ndarray) -> np.ndarray:
        """Rows reordered by (source_id, market_id) — C memcmp over the key
        arena's UTF-8, which is code-point order, Python's tuple sort."""
        buf = self._map.sorted_rows(np.ascontiguousarray(rows, dtype=np.int32))
        return np.frombuffer(buf, dtype=np.int32)

    def sqlite_writer_available(self) -> bool:
        """Whether :meth:`flush_sqlite` can run (libsqlite3 dlopen()able).

        Callers choose their fallback on this, up front, so a genuine write
        error (locked file, full disk) from the C writer propagates instead
        of being mistaken for "no native path here".
        """
        module = _load_internmap()
        return bool(module and module.sqlite_writer_available())

    def flush_sqlite(self, db_path, rows, rel, conf, iso) -> int:
        """Write rows straight to a reference-format SQLite file in C.

        ``rows`` gives the write order (pre-sort with :meth:`sorted_rows`);
        ``rel``/``conf`` are full float64 store columns indexed by row;
        ``iso`` is the full timestamp sidecar list. Raises ``RuntimeError``
        when libsqlite3 cannot be dlopen()ed (check
        :meth:`sqlite_writer_available` first) or on a real write error.
        """
        return self._map.flush_sqlite(
            str(db_path),
            np.ascontiguousarray(rows, dtype=np.int32),
            np.ascontiguousarray(rel, dtype=np.float64),
            np.ascontiguousarray(conf, dtype=np.float64),
            iso,
        )

    def snapshot_rows(self, rows, rel, conf, iso) -> bytes:
        """Self-contained flush blob for *rows* (key halves + iso + values),
        which :meth:`flush_snapshot` can write with the GIL released while
        the interner keeps growing."""
        return self._map.snapshot_rows(
            np.ascontiguousarray(rows, dtype=np.int32),
            np.ascontiguousarray(rel, dtype=np.float64),
            np.ascontiguousarray(conf, dtype=np.float64),
            iso,
        )

    @staticmethod
    def flush_snapshot(db_path, blob: bytes) -> int:
        """Write a :meth:`snapshot_rows` blob to SQLite, GIL released."""
        return _load_internmap(force=True).flush_snapshot(str(db_path), blob)

    def probe_pairs_sharded(
        self,
        source_table: Sequence[str],
        source_codes: np.ndarray,
        market_table: Sequence[str],
        market_codes: np.ndarray,
        workers: "int | None" = None,
    ):
        """Parallel lookup-only pass over (table, code) pair columns.

        Returns ``(rows, hashes, slots, capacity_token)``: ``rows`` holds
        the existing store row per pair or −1, ``hashes``/``slots`` the
        per-miss hash and first-empty slot the commit resumes from, and
        the capacity token pins the table geometry the probe saw. The
        probe shards ``[0, n)`` across *workers* threads (the C loop
        releases the GIL) and only READS the map. The caller must prevent
        interleaved interning between this and :meth:`commit_probed` (the
        tensor store's host lock).
        """
        source_codes = np.ascontiguousarray(source_codes, dtype=np.int32)
        market_codes = np.ascontiguousarray(market_codes, dtype=np.int32)
        n = len(source_codes)
        rows = np.empty(n, dtype=np.int32)
        hashes = np.empty(n, dtype=np.uint64)
        slots = np.empty(n, dtype=np.int64)
        capacity = self._map.reserve_pairs(n)
        count = max(1, min(workers or intern_workers(), n or 1))
        if count == 1 or n < 2:
            self._map.probe_pairs_indexed(
                source_table, source_codes, market_table, market_codes,
                rows, hashes, slots, 0, n,
            )
            return rows, hashes, slots, capacity
        bounds = np.linspace(0, n, count + 1).astype(np.int64)
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=count, thread_name_prefix="bce-intern-probe"
        ) as pool:
            futures = [
                pool.submit(
                    self._map.probe_pairs_indexed,
                    source_table, source_codes, market_table, market_codes,
                    rows, hashes, slots, int(bounds[i]), int(bounds[i + 1]),
                )
                for i in range(count)
            ]
            for future in futures:
                future.result()
        return rows, hashes, slots, capacity

    def commit_probed(
        self,
        source_table: Sequence[str],
        source_codes: np.ndarray,
        market_table: Sequence[str],
        market_codes: np.ndarray,
        rows: np.ndarray,
        hashes: np.ndarray,
        slots: np.ndarray,
        capacity_token: int,
    ) -> int:
        """Serial commit of a probe's miss set, in batch order — the one
        place rows are assigned, so the sharded pass assigns what the
        serial pass does, key for key. Fills the probed −1 entries of
        *rows* in place; returns the miss count."""
        return self._map.commit_probed(
            source_table,
            np.ascontiguousarray(source_codes, dtype=np.int32),
            market_table,
            np.ascontiguousarray(market_codes, dtype=np.int32),
            rows, hashes, slots, int(capacity_token),
        )

    def intern_indexed_sharded(
        self,
        source_table: Sequence[str],
        source_codes: np.ndarray,
        market_table: Sequence[str],
        market_codes: np.ndarray,
        workers: "int | None" = None,
    ) -> np.ndarray:
        """Probe (parallel) + commit (serial, batch order) in one call:
        the rows of :meth:`intern_arrays_indexed` on the same columns,
        with the hash and chain walk of every pair paid on worker
        threads."""
        rows, hashes, slots, capacity = self.probe_pairs_sharded(
            source_table, source_codes, market_table, market_codes,
            workers=workers,
        )
        self.commit_probed(
            source_table, source_codes, market_table, market_codes,
            rows, hashes, slots, capacity,
        )
        return rows

    def lookup_arrays(
        self, sources: Sequence[str], markets: Sequence[str]
    ) -> np.ndarray:
        try:
            buf = self._map.lookup_pairs(sources, markets)
        except ValueError:
            # One NUL-containing id poisons the whole C pass; resolve the
            # batch per item so that key reads as absent (-1), as in the
            # IdInterner fallback, instead of raising.
            return np.asarray(
                [self.get((s, m)) for s, m in zip(sources, markets)],
                dtype=np.int32,
            )
        return np.frombuffer(buf, dtype=np.int32)


def make_pair_interner():
    """The C pair interner when the extension is available, else
    :class:`IdInterner`."""
    module = _load_internmap()
    if module is None:
        return IdInterner()
    return NativePairInterner(module)


# -- sharded intern pass ----------------------------------------------------
#
# The delta-interning miss set splits across worker threads for the PROBE
# half (hash + chain walk, GIL released in C), then commits serially in
# batch order, so row assignment stays first-occurrence-in-batch, equal to
# one serial intern pass.

#: Miss sets below this size always intern serially — thread spin-up and
#: the probe's output traffic cost more than they hide. Tests lower it to
#: force the sharded route at toy sizes.
SHARD_MIN_PAIRS = 1 << 18


def intern_workers() -> int:
    """Worker threads for the sharded probe (``BCE_INTERN_WORKERS``
    overrides; default the machine's cores capped at 4; 1 disables
    sharding). The commit stays serial regardless."""
    value = os.environ.get("BCE_INTERN_WORKERS", "")
    if value:
        try:
            return max(1, int(value))
        except ValueError:
            pass
    return max(1, min(4, os.cpu_count() or 1))


def probe_supported(interner) -> bool:
    """Whether *interner* has the probe/commit entry points (the C
    interner; the dict twin interns serially)."""
    return isinstance(interner, NativePairInterner)


def delta_match_rows(
    rank_map,
    pair_rank_new: np.ndarray,
    pair_offsets_new: np.ndarray,
    pair_rank_old: np.ndarray,
    pair_offsets_old: np.ndarray,
    prev_of,
    rows_old: np.ndarray,
    native: "bool | None" = None,
) -> np.ndarray:
    """Per-market match against an epoch-persistent pair table.

    Market ``m`` of the new batch matches old market ``prev_of[m]``
    (``None`` ⇒ identity) iff the pair counts are equal and every pair's
    source rank maps elementwise (``rank_map`` translates new ranks to
    old; ``None`` ⇒ identical source tables, raw comparison). Returns
    int32 rows: matched positions copy ``rows_old``, everything else is
    −1 — the miss set the interner then walks. The C pass and the numpy
    twin are identical output for output; ``native=None`` auto-detects,
    ``True`` forces the C pass, ``False`` the twin. Caller guarantees
    ``pair_rank_new`` values index ``rank_map`` when one is given.
    """
    pair_rank_new = np.ascontiguousarray(pair_rank_new, dtype=np.int32)
    pair_offsets_new = np.ascontiguousarray(pair_offsets_new, dtype=np.int64)
    pair_rank_old = np.ascontiguousarray(pair_rank_old, dtype=np.int32)
    pair_offsets_old = np.ascontiguousarray(pair_offsets_old, dtype=np.int64)
    rows_old = np.ascontiguousarray(rows_old, dtype=np.int32)
    if rank_map is not None:
        rank_map = np.ascontiguousarray(rank_map, dtype=np.int32)
    if prev_of is not None:
        prev_of = np.ascontiguousarray(prev_of, dtype=np.int64)

    module = None if native is False else _load_internmap(force=bool(native))
    if module is not None:
        rows_out = np.empty(len(pair_rank_new), dtype=np.int32)
        module.delta_match_rows(
            rank_map, pair_rank_new, pair_offsets_new,
            pair_rank_old, pair_offsets_old, prev_of, rows_old, rows_out,
        )
        return rows_out

    # Numpy twin — identical output. Alignment is per-market shifts: a
    # candidate market's pairs sit at new positions + (old_lo - new_lo).
    m_new = len(pair_offsets_new) - 1
    p_new = len(pair_rank_new)
    counts_new = np.diff(pair_offsets_new)
    if int(counts_new.sum()) != p_new or (
        m_new and (counts_new < 0).any()
    ):
        raise ValueError("delta_match_rows: malformed new offsets")
    prev_arr = (
        np.arange(m_new, dtype=np.int64) if prev_of is None else prev_of
    )
    m_old = len(pair_offsets_old) - 1
    if prev_of is None and m_new > m_old:
        raise ValueError("delta_match_rows: table sizes do not line up")
    if not p_new:
        return np.empty(0, dtype=np.int32)
    if not len(pair_rank_old):
        # An epoch table without pairs (no markets, or only empty ones)
        # matches no pair (the C pass's all-miss); guarded here because
        # the gathers below would index its empty arrays. The JAX
        # package's twin guards only the no-market case and raises
        # IndexError on a table of empty markets.
        return np.full(p_new, -1, dtype=np.int32)
    valid = (prev_arr >= 0) & (prev_arr < m_old)
    safe_prev = np.where(valid, prev_arr, 0)
    counts_old = (pair_offsets_old[1:] - pair_offsets_old[:-1])[safe_prev]
    cand = valid & (counts_new == counts_old)
    shift = np.where(
        cand, pair_offsets_old[:-1][safe_prev] - pair_offsets_new[:-1], 0
    )
    cand_rep = np.repeat(cand, counts_new)
    prev_idx = np.arange(p_new, dtype=np.int64) + np.repeat(
        shift, counts_new
    )
    prev_idx = np.where(cand_rep, prev_idx, 0)
    mapped = (
        rank_map[pair_rank_new] if rank_map is not None else pair_rank_new
    )
    ok = cand_rep & (mapped == pair_rank_old[prev_idx])
    # Per-market AND, reduced over the NON-EMPTY markets' segment starts
    # only: a trailing empty market's start equals p_new (out of range),
    # and clamping it would split the previous market's segment.
    # Consecutive non-empty starts delimit exactly one market's pairs, and
    # an empty market matches whenever it is a candidate, gating nothing.
    nonempty = counts_new > 0
    seg = pair_offsets_new[:-1][nonempty]
    market_ok = np.ones(m_new, dtype=bool)
    if seg.size:
        market_ok[nonempty] = np.logical_and.reduceat(ok, seg)
    matched = cand & market_ok
    matched_rep = np.repeat(matched, counts_new)
    return np.where(
        matched_rep, rows_old[prev_idx], np.int32(-1)
    ).astype(np.int32)


def pack_strings_native(values: List[str]) -> "bytes | None":
    """u32-length-prefixed UTF-8 blob via the C extension, or ``None``
    when it is unavailable (the caller then packs in Python — the same
    bytes)."""
    module = _load_internmap()
    if module is None:
        return None
    return module.pack_strings(values)
