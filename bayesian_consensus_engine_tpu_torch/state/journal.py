"""Append-only binary durability journal — the tier under the SQLite floor.

The port's copy of the JAX package's ``state/journal.py``: the same file
format byte for byte, the same replay, resume and compaction rules, and
the same admitted-trace sidecar. The SQLite file is the interchange
format, byte-compatible with the reference engine's database, and its
text-primary-key bulk insert is slow however the writer is built: a full
checkpoint of the flat main path's 4M rows takes ~13 s of host time with
the port's C writer on an H100 machine (``PERF.md`` §5). The journal is
the rolling-durability tier UNDER that floor: each epoch appends the rows
dirtied since the last epoch as raw little-endian columns plus the newly
interned pair strings, written (and fsynced) at disk bandwidth. A
service keeps SQLite for what it is — the interchange file, written once
at exit — while mid-stream durability costs ~100 bytes a row of
sequential IO.

Epochs may also be written ASYNCHRONOUSLY
(:meth:`~.tensor_store.TensorReliabilityStore.flush_to_journal_async`):
the epoch's content is snapshotted under the store lock, and the frame/
CRC/append/fsync run on a background writer thread the next flush joins
— writes still serialise, and a background failure surfaces at the join
with the torn frame truncated back (``append_epoch``'s failure path), so
the file is ALWAYS valid through the last joined epoch.

File format (all little-endian)::

    header   MAGIC = b"BCEJRNL1"
    epoch    fixed header (struct <QQQQQdQ>):
               epoch_index     u64   (0, 1, 2, ... — dense)
               used_after      u64   total interned rows after this epoch
               pair_blob_len   u64
               dirty_count     u64
               iso_blob_len    u64
               wall_unix_ts    f64
               tag             u64   caller watermark (a stream's settled
                                     batch index this epoch covers)
             pair_blob: for each row in [prev used_after, used_after):
               u32 src_len, src utf-8, u32 mkt_len, mkt utf-8
             columns: idx u64[d], rel f64[d], conf f64[d], days f64[d],
                      exists u8[d]
             iso_blob: per dirty row, u32 len + utf-8 bytes
             crc32    u32 of everything from the fixed header through the
                      iso_blob (zlib.crc32)

Recovery (:func:`replay_journal`) replays epochs in order onto a fresh
store — interning the pair blob in row order reproduces the original row
assignment exactly — and STOPS at the first truncated, CRC-failing, or
semantically malformed epoch (unparseable pair/iso blobs, out-of-bound
dirty indices — "CRC-of-garbage"): a crash mid-append leaves the journal
valid through the last complete epoch, which is exactly the durable
point the writer last reported. The resume scan
(``JournalWriter(path, resume=True)``) walks the SAME frame decoder, so
a resumed writer appends exactly where replay stops. The returned
``tag`` is that epoch's watermark; a restarted service resumes from
``batches[tag + 1:]``.

Replay and compaction build a store, so they take ``device=`` like every
entry point of the port: ``None`` means CUDA and raises without it;
``device="cpu"`` asks for the CPU.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

from bayesian_consensus_engine_tpu_torch.obs.metrics import metrics_registry
from bayesian_consensus_engine_tpu_torch.obs.timeline import active_timeline
from bayesian_consensus_engine_tpu_torch.obs.trace import active_tracer
from bayesian_consensus_engine_tpu_torch.utils.interning import (
    pack_strings_native,
)

MAGIC = b"BCEJRNL1"
_EPOCH_HDR = struct.Struct("<QQQQQdQ")

# -- admitted-trace sidecar ---------------------------------------------------
#
# The journal records settlement OUTPUT deltas — post-update rows. The
# inputs are not recoverable from them (the capped update destroys the
# probability magnitudes), so a journal alone cannot be re-DRIVEN, only
# re-LOADED. The trace sidecar (``<journal>.trace`` by convention) is the
# missing half: the admitted columnar batches themselves, CRC-framed in
# admitted order with the per-batch settlement day and step count, which
# makes the pair ``(journal, trace)`` a complete replayable workload. The
# journal's epoch tag
# remains the durability watermark: replay is bounded by the last
# complete epoch's tag, exactly as crash recovery is.
TRACE_MAGIC = b"BCETRAC1"
# batch_index u64, markets u64, signals u64, keys_blob_len u64,
# src_blob_len u64, now_days f64, steps u64
_TRACE_HDR = struct.Struct("<QQQQQdQ")


class TornTraceError(ValueError):
    """A trace sidecar ends mid-frame (or disagrees with its journal) and
    the caller demanded ``strict`` completeness instead of the default
    replay-to-the-last-complete-frame semantics."""


def _fsync_dir(path: str) -> None:
    """fsync the directory holding *path* (standard WAL practice).

    ``os.fsync`` on a file makes its BYTES durable, not its directory
    entry: a journal created (or renamed into place by compaction)
    moments before a crash can vanish — or revert to the unlinked-over
    old file — taking every epoch ``append_epoch`` already reported
    durable with it. Syncing the parent directory pins the entry itself.
    """
    try:
        fd = os.open(
            os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY
        )
    except OSError:
        return  # platform can't open directories (e.g. Windows): no-op
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _pack_pair_blob(pairs) -> bytes:
    """Python fallback packer; ``NativePairInterner.pair_blob`` is the
    C fast path producing identical bytes (the port's internmap.c)."""
    parts: List[bytes] = []
    for source_id, market_id in pairs:
        src = source_id.encode("utf-8")
        mkt = market_id.encode("utf-8")
        parts.append(struct.pack("<I", len(src)))
        parts.append(src)
        parts.append(struct.pack("<I", len(mkt)))
        parts.append(mkt)
    return b"".join(parts)


def _pack_iso_blob(iso_values: List[str]) -> bytes:
    """One C pass when the port's extension is built (a per-row Python
    ``struct.pack`` loop costs seconds per million rows); identical bytes
    either way."""
    blob = pack_strings_native(iso_values)
    if blob is not None:
        return blob
    parts: List[bytes] = []
    for value in iso_values:
        raw = value.encode("utf-8")
        parts.append(struct.pack("<I", len(raw)))
        parts.append(raw)
    return b"".join(parts)


class JournalWriter:
    """Appends epochs to one journal file.

    A fresh path starts a new journal recording ONE store lifetime from
    its attach point — on attach to a non-empty store,
    :meth:`~.tensor_store.TensorReliabilityStore.flush_to_journal` makes
    the first epoch a full snapshot, so replay never needs an external
    base. An EXISTING non-empty journal is never truncated: opening one
    raises unless ``resume=True``, which scans the valid epochs (exactly
    as replay would), drops any torn tail, and appends after them — the
    crash-recovery shape: ``store, tag = replay_journal(path)``, then
    settle ``batches[tag + 1:]`` onto ``store`` and append their epochs
    through ``JournalWriter(path, resume=True)``. ``fsync=True``
    (default) makes each epoch durable before the call returns — that is
    the point of a durability journal; pass ``False`` only for
    benchmarking the format itself.
    """

    def __init__(self, path: Union[str, Path], fsync: bool = True,
                 resume: bool = False) -> None:
        self._path = str(path)
        self._fsync = fsync
        existing = (
            os.path.exists(self._path) and os.path.getsize(self._path) > 0
        )
        if existing and not resume:
            raise ValueError(
                f"{self._path} already holds a journal; refusing to "
                "truncate durable epochs — replay it and pass "
                "resume=True, or use a fresh path"
            )
        if existing:
            valid_end, epochs, rows, _tag = _scan_valid_end(self._path)
            self._file = open(self._path, "r+b")
            try:
                # Drop a torn tail (crash mid-append) before appending:
                # the next epoch index must be dense from the valid
                # prefix replay will actually see.
                self._file.truncate(valid_end)
                self._file.seek(valid_end)
            except Exception:
                self._file.close()
                raise
            self.epoch_index = epochs
            self.rows_covered = rows
            return
        self._file = open(self._path, "wb")
        try:
            self._file.write(MAGIC)
            self._file.flush()
            if fsync:
                os.fsync(self._file.fileno())
                # The file's directory entry must survive a crash too, or
                # every epoch fsynced into it is durable bytes in an
                # unreachable inode.
                _fsync_dir(self._path)
        except Exception:
            self._file.close()
            raise
        self.epoch_index = 0
        self.rows_covered = 0  # pairs journaled so far (= used_after)

    def append_epoch(
        self,
        used_after: int,
        new_pairs,
        idx: np.ndarray,
        rel: np.ndarray,
        conf: np.ndarray,
        days: np.ndarray,
        exists: np.ndarray,
        iso_values,
        tag: int = 0,
    ) -> None:
        """Append one epoch; atomic at replay granularity (CRC + lengths).

        *new_pairs* must cover rows ``[self.rows_covered, used_after)`` in
        row order — as an iterable of ``(source, market)`` pairs, or as
        already-wire-format bytes (the C ``pair_blob`` fast path). *idx*
        rows all < *used_after*.
        """
        if used_after < self.rows_covered:
            raise ValueError(
                f"used_after={used_after} < rows already journaled "
                f"({self.rows_covered})"
            )
        pair_blob = (
            new_pairs if isinstance(new_pairs, bytes)
            else _pack_pair_blob(new_pairs)
        )
        iso_blob = _pack_iso_blob(iso_values)
        dirty = int(len(idx))
        if not (len(rel) == len(conf) == len(days) == len(exists)
                == len(iso_values) == dirty):
            raise ValueError("column length mismatch")
        header = _EPOCH_HDR.pack(
            self.epoch_index, used_after, len(pair_blob), dirty,
            len(iso_blob), time.time(), tag,
        )
        payload = b"".join(
            (
                header,
                pair_blob,
                np.ascontiguousarray(idx, dtype=np.uint64).tobytes(),
                np.ascontiguousarray(rel, dtype=np.float64).tobytes(),
                np.ascontiguousarray(conf, dtype=np.float64).tobytes(),
                np.ascontiguousarray(days, dtype=np.float64).tobytes(),
                np.ascontiguousarray(exists, dtype=np.uint8).tobytes(),
                iso_blob,
            )
        )
        # The write+flush+fsync is the durability wait a streaming service
        # actually blocks on — named "journal_fsync" in the phase timeline
        # (no-op unless this thread is recording; obs/timeline.py). With
        # the async-epoch path (tensor_store.flush_to_journal_async) this
        # runs on a background writer thread, which records nothing by
        # design: the consumer-visible share is the "journal_async_wait"
        # join span.
        tracer = active_tracer()
        write_start = time.perf_counter() if tracer.enabled else 0.0
        with active_timeline().span("journal_fsync"):
            start = self._file.tell()
            try:
                self._file.write(payload)
                self._file.write(struct.pack("<I", zlib.crc32(payload)))
                self._file.flush()
                if self._fsync:
                    os.fsync(self._file.fileno())
            except BaseException:
                # Drop the torn frame (best effort) so a continuing or
                # resumed writer appends at exactly the valid end replay
                # stops at; if even the truncate fails, replay's CRC walk
                # drops the frame at read time instead.
                try:
                    self._file.truncate(start)
                    self._file.seek(start)
                except (OSError, ValueError):
                    pass
                raise
        if tracer.enabled:
            # The journal writer's own trace chain, keyed by epoch tag —
            # deterministic whether the append ran in-loop (sync/tail) or
            # on the background writer thread: epochs serialise, and the
            # args are a pure function of the epoch content.
            tracer.span_event(
                "journal", tag, "append_epoch",
                dur_s=time.perf_counter() - write_start,
                args={"epoch": self.epoch_index, "rows": dirty,
                      "used_after": used_after},
                component="journal",
            )
        registry = metrics_registry()
        registry.counter("journal.epochs").inc()
        registry.counter("journal.bytes").inc(len(payload) + 4)
        registry.counter("journal.dirty_rows").inc(dirty)
        if self.epoch_index > 0:
            # Rows carried by DELTA epochs (every epoch after the full-
            # snapshot first): the cost-scales-with-touched-rows claim,
            # as a counter. Counted after the write+fsync landed.
            registry.counter("journal.delta_rows").inc(dirty)
        self.epoch_index += 1
        self.rows_covered = used_after

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()

    def __enter__(self) -> "JournalWriter":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()


def _read_exact(f, n: int) -> Optional[bytes]:
    data = f.read(n)
    return data if len(data) == n else None


def _unpack_pairs(blob: bytes, count: int) -> Optional[List[Tuple[str, str]]]:
    pairs: List[Tuple[str, str]] = []
    off = 0
    for _ in range(count):
        if off + 4 > len(blob):
            return None
        (n,) = struct.unpack_from("<I", blob, off)
        off += 4
        if off + n > len(blob):
            return None
        src = blob[off:off + n].decode("utf-8")
        off += n
        if off + 4 > len(blob):
            return None
        (n,) = struct.unpack_from("<I", blob, off)
        off += 4
        if off + n > len(blob):
            return None
        mkt = blob[off:off + n].decode("utf-8")
        off += n
        pairs.append((src, mkt))
    if off != len(blob):
        return None
    return pairs


def _unpack_iso(blob: bytes, count: int) -> Optional[List[str]]:
    values: List[str] = []
    off = 0
    for _ in range(count):
        if off + 4 > len(blob):
            return None
        (n,) = struct.unpack_from("<I", blob, off)
        off += 4
        if off + n > len(blob):
            return None
        values.append(blob[off:off + n].decode("utf-8"))
        off += n
    if off != len(blob):
        return None
    return values


def _decode_epoch(fields, body: bytes, expected_rows: int):
    """Parse one CRC-valid epoch body; None if semantically malformed.

    CRC protects against torn/corrupt WRITES, not against garbage a buggy
    writer checksummed correctly ("CRC-of-garbage"): pair/iso blobs that
    fail to parse, or dirty indices at or beyond ``used_after``. Both
    replay and the resume scan reject these through this one decoder, so
    the point resume appends at is exactly the point replay stops at.
    """
    (_epoch_index, used_after, pair_blob_len, dirty, _iso_blob_len,
     _wall, _tag) = fields
    pairs = _unpack_pairs(body[:pair_blob_len], used_after - expected_rows)
    off = pair_blob_len
    idx = np.frombuffer(body, np.uint64, dirty, off)
    off += dirty * 8
    rel = np.frombuffer(body, np.float64, dirty, off)
    off += dirty * 8
    conf = np.frombuffer(body, np.float64, dirty, off)
    off += dirty * 8
    days = np.frombuffer(body, np.float64, dirty, off)
    off += dirty * 8
    exists = np.frombuffer(body, np.uint8, dirty, off)
    off += dirty
    iso_values = _unpack_iso(body[off:], dirty)
    if pairs is None or iso_values is None or (
        dirty and idx.max() >= used_after
    ):
        return None
    return pairs, idx, rel, conf, days, exists, iso_values


def _iter_frames(f):
    """Yield ``(header_fields, decoded, end_offset)`` for each complete,
    CRC-valid, semantically-valid epoch in order, stopping at the first
    torn, corrupt, or malformed frame — replay and resume-scan share this
    walk (decode included), so what resume appends after is exactly what
    replay will rebuild."""
    expected_epoch = 0
    expected_rows = 0
    while True:
        header = _read_exact(f, _EPOCH_HDR.size)
        if header is None:
            return  # clean end (or torn mid-header): stop here
        fields = _EPOCH_HDR.unpack(header)
        (epoch_index, used_after, pair_blob_len, dirty, iso_blob_len,
         _wall, _tag) = fields
        if epoch_index != expected_epoch or used_after < expected_rows:
            return  # corrupt header: treat as torn tail
        columns_len = dirty * (8 + 8 + 8 + 8 + 1)
        body = _read_exact(f, pair_blob_len + columns_len + iso_blob_len)
        if body is None:
            return
        crc_raw = _read_exact(f, 4)
        if crc_raw is None:
            return
        (crc,) = struct.unpack("<I", crc_raw)
        if zlib.crc32(header + body) != crc:
            return
        decoded = _decode_epoch(fields, body, expected_rows)
        if decoded is None:
            return  # CRC-of-garbage: stop exactly where replay stops
        yield fields, decoded, f.tell()
        expected_epoch += 1
        expected_rows = used_after


def _scan_valid_end(path):
    """(valid_byte_end, epoch_count, rows_covered, last_tag) of a journal."""
    with open(path, "rb") as f:
        if _read_exact(f, len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a BCE journal (bad magic)")
        end = f.tell()
        epochs = 0
        rows = 0
        tag = None
        for fields, _decoded, off in _iter_frames(f):
            end = off
            epochs += 1
            rows = fields[1]
            tag = int(fields[6])
        return end, epochs, rows, tag


def compact_journal(path: Union[str, Path], device=None) -> int:
    """Rewrite a journal as ONE full-snapshot epoch; returns rows kept.

    A long-running service's journal grows without bound — every epoch
    appends, and a re-settled row re-appends its current values. This is
    the WAL-checkpoint answer: replay the valid epochs (torn tail
    dropped, exactly as recovery would), write a fresh journal holding
    one epoch with the SAME tag watermark, and atomically rename it over
    the original — at every instant the path holds a journal that
    replays to the same state and watermark, so a crash mid-compaction
    loses nothing. Resume afterwards exactly as before
    (``JournalWriter(path, resume=True)`` appends after the snapshot
    epoch). Run it from the service between streams, or from cron
    against a quiesced journal; do NOT run it concurrently with a live
    writer (the writer's open handle would keep appending to the
    unlinked old file). *device* is the replayed store's, as in
    :func:`replay_journal`; compaction never touches its device state.
    """
    path = str(path)
    store, tag = replay_journal(path, device=device)
    tmp_path = path + ".compact"
    if os.path.exists(tmp_path):
        # A crash between the snapshot write and the rename leaves a
        # stale .compact; the original journal is still intact and
        # authoritative, so the leftover is safe to discard.
        os.unlink(tmp_path)
    writer = JournalWriter(tmp_path)
    try:
        if tag is None:
            # No complete epoch: nothing durable to snapshot, and
            # inventing a watermark would skip batch 0 on resume — the
            # compacted journal is the empty (magic-only) journal, which
            # replays to the same (empty, None) as the original.
            rows = 0
        else:
            rows = store.flush_to_journal(writer, tag=tag)
        writer.close()
        os.replace(tmp_path, path)
        # Pin the rename: without a directory fsync a crash here can
        # revert the path to the unlinked-over OLD journal, silently
        # losing every epoch appended after this compaction that the
        # service already reported durable.
        _fsync_dir(path)
    except Exception:
        writer.close()
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
        raise
    return rows


def replay_journal(path: Union[str, Path], device=None):
    """Rebuild a store from a journal: ``(store, last_tag)``.

    Replays complete epochs in order; a truncated or CRC-failing tail
    epoch (crash mid-append) is dropped. ``last_tag`` is the last
    complete epoch's ``tag`` watermark (``None`` when the journal holds
    no complete epoch): for a stream that tags each epoch with the batch
    index it covers, that is the last durably-covered settled batch —
    resume from ``batches[last_tag + 1:]``. The store is built on
    *device* (``None``: CUDA, raising without it).
    """
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    store = TensorReliabilityStore(device=device)
    last_tag = None
    with open(path, "rb") as f:
        if _read_exact(f, len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a BCE journal (bad magic)")
        for fields, decoded, _off in _iter_frames(f):
            used_after, tag = fields[1], fields[6]
            pairs, idx, rel, conf, days, exists, iso_values = decoded
            store._apply_journal_epoch(
                used_after, pairs, idx.astype(np.int64), rel, conf, days,
                exists.astype(bool), iso_values,
            )
            last_tag = int(tag)
    return store, last_tag


class TraceBatch(NamedTuple):
    """One admitted columnar batch as the trace sidecar records it.

    ``offsets[m] : offsets[m+1]`` slices market ``m``'s signals out of
    ``source_ids``/``probabilities`` — the exact shape
    :func:`~.pipeline.stage_settlement_plan_columnar` ingests, so a trace
    batch re-drives the planner without any reshaping. ``now_days`` is
    the settlement day the live run used (absolute epoch-days) and
    ``steps`` its cycle count; both are inputs to the byte contract.
    """

    index: int
    market_keys: Tuple[str, ...]
    source_ids: Tuple[str, ...]
    probabilities: np.ndarray   # f64[signals]
    offsets: np.ndarray         # i64[markets + 1]
    outcomes: np.ndarray        # bool[markets]
    now_days: float
    steps: int


def trace_path_for(journal_path: Union[str, Path]) -> str:
    """The conventional sidecar path for a journal: ``<journal>.trace``."""
    return str(journal_path) + ".trace"


class TraceWriter:
    """Appends admitted batches to a trace sidecar.

    Same framing discipline as :class:`JournalWriter`: dense frame
    indices, CRC over header+body, a torn tail truncated on a failed
    append, and ``resume=True`` required to append to an existing file
    (the scan drops any torn tail first). ``fsync`` defaults to False —
    the trace is a replayable *workload* record, not the durability tier;
    the journal's own fsync still defines the durable point, and replay
    is bounded by the journal tag regardless of how many trace frames
    survived a crash.
    """

    def __init__(self, path: Union[str, Path], fsync: bool = False,
                 resume: bool = False) -> None:
        self._path = str(path)
        self._fsync = fsync
        existing = (
            os.path.exists(self._path) and os.path.getsize(self._path) > 0
        )
        if existing and not resume:
            raise ValueError(
                f"{self._path} already holds a trace; refusing to "
                "truncate recorded batches — pass resume=True or use a "
                "fresh path"
            )
        if existing:
            valid_end, count = _scan_trace_end(self._path)
            self._file = open(self._path, "r+b")
            try:
                self._file.truncate(valid_end)
                self._file.seek(valid_end)
            except Exception:
                self._file.close()
                raise
            self.batch_index = count
            return
        self._file = open(self._path, "wb")
        try:
            self._file.write(TRACE_MAGIC)
            self._file.flush()
            if fsync:
                os.fsync(self._file.fileno())
                _fsync_dir(self._path)
        except Exception:
            self._file.close()
            raise
        self.batch_index = 0

    def append_batch(
        self,
        market_keys: Sequence[str],
        source_ids: Sequence[str],
        probabilities: np.ndarray,
        offsets: np.ndarray,
        outcomes: Sequence[bool],
        now_days: float,
        steps: int,
    ) -> None:
        """Record one admitted batch; frame index assigned densely."""
        probs = np.ascontiguousarray(probabilities, dtype=np.float64)
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        outs = np.ascontiguousarray(
            np.asarray(outcomes, dtype=bool), dtype=np.uint8
        )
        markets = len(market_keys)
        if len(offs) != markets + 1 or len(outs) != markets:
            raise ValueError(
                f"offsets/outcomes shape mismatch: {markets} markets, "
                f"{len(offs)} offsets, {len(outs)} outcomes"
            )
        if int(offs[-1]) != len(probs) or len(source_ids) != len(probs):
            raise ValueError(
                f"signal count mismatch: offsets end at {int(offs[-1])}, "
                f"{len(probs)} probabilities, {len(source_ids)} source ids"
            )
        keys_blob = _pack_iso_blob(list(market_keys))
        src_blob = _pack_iso_blob(list(source_ids))
        header = _TRACE_HDR.pack(
            self.batch_index, markets, len(probs), len(keys_blob),
            len(src_blob), float(now_days), int(steps),
        )
        payload = b"".join(
            (header, keys_blob, src_blob, probs.tobytes(), offs.tobytes(),
             outs.tobytes())
        )
        start = self._file.tell()
        try:
            self._file.write(payload)
            self._file.write(struct.pack("<I", zlib.crc32(payload)))
            self._file.flush()
            if self._fsync:
                os.fsync(self._file.fileno())
        except BaseException:
            try:
                self._file.truncate(start)
                self._file.seek(start)
            except (OSError, ValueError):
                pass
            raise
        registry = metrics_registry()
        registry.counter("replay.trace_batches").inc()
        registry.counter("replay.trace_bytes").inc(len(payload) + 4)
        self.batch_index += 1

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()


def _iter_trace_frames(f):
    """Yield ``(TraceBatch, end_offset)`` per complete CRC-valid frame,
    stopping at the first torn/corrupt/malformed one — the same walk
    shape as the journal's ``_iter_frames``, so writer resume and reader
    agree on the valid end."""
    expected = 0
    while True:
        header = _read_exact(f, _TRACE_HDR.size)
        if header is None:
            return
        fields = _TRACE_HDR.unpack(header)
        (index, markets, signals, keys_blob_len, src_blob_len,
         now_days, steps) = fields
        if index != expected:
            return
        body_len = (
            keys_blob_len + src_blob_len + signals * 8 + (markets + 1) * 8
            + markets
        )
        body = _read_exact(f, body_len)
        if body is None:
            return
        crc_raw = _read_exact(f, 4)
        if crc_raw is None:
            return
        (crc,) = struct.unpack("<I", crc_raw)
        if zlib.crc32(header + body) != crc:
            return
        keys = _unpack_iso(body[:keys_blob_len], markets)
        off = keys_blob_len
        sources = _unpack_iso(body[off:off + src_blob_len], signals)
        off += src_blob_len
        probs = np.frombuffer(body, np.float64, signals, off).copy()
        off += signals * 8
        offsets = np.frombuffer(body, np.int64, markets + 1, off).copy()
        off += (markets + 1) * 8
        outcomes = np.frombuffer(body, np.uint8, markets, off).astype(bool)
        if keys is None or sources is None or (
            signals and (offsets[0] != 0 or offsets[-1] != signals
                         or (np.diff(offsets) < 0).any())
        ):
            return  # CRC-of-garbage: stop exactly like journal replay
        yield TraceBatch(
            index=int(index),
            market_keys=tuple(keys),
            source_ids=tuple(sources),
            probabilities=probs,
            offsets=offsets,
            outcomes=outcomes,
            now_days=float(now_days),
            steps=int(steps),
        ), f.tell()
        expected += 1


def _scan_trace_end(path: str) -> Tuple[int, int]:
    """(valid_byte_end, complete_frame_count) of a trace sidecar."""
    with open(path, "rb") as f:
        if _read_exact(f, len(TRACE_MAGIC)) != TRACE_MAGIC:
            raise ValueError(f"{path}: not a BCE trace (bad magic)")
        end = f.tell()
        count = 0
        for _batch, off in _iter_trace_frames(f):
            end = off
            count += 1
        return end, count


def read_trace(
    path: Union[str, Path], strict: bool = False
) -> List[TraceBatch]:
    """Read a trace sidecar's complete frames, in admitted order.

    A torn/CRC-failing tail frame is dropped (crash mid-append), matching
    journal replay; ``strict=True`` raises :class:`TornTraceError`
    instead of silently shortening the workload.
    """
    path = str(path)
    batches: List[TraceBatch] = []
    with open(path, "rb") as f:
        if _read_exact(f, len(TRACE_MAGIC)) != TRACE_MAGIC:
            raise ValueError(f"{path}: not a BCE trace (bad magic)")
        end = f.tell()
        for batch, off in _iter_trace_frames(f):
            batches.append(batch)
            end = off
        f.seek(0, os.SEEK_END)
        if strict and f.tell() != end:
            raise TornTraceError(
                f"{path}: trace ends mid-frame after batch "
                f"{len(batches) - 1}; strict replay refuses a shortened "
                "workload (re-record, or pass strict=False to replay the "
                "complete prefix)"
            )
    return batches


def extract_trace(
    journal_path: Union[str, Path],
    trace_path: Optional[Union[str, Path]] = None,
    strict: bool = False,
) -> Tuple[List[TraceBatch], Optional[int]]:
    """The replayable workload of a recorded run: ``(batches, tag)``.

    Reads the journal's durable watermark (the last complete epoch's
    ``tag`` — the settled batch index durability covers) and the trace
    sidecar (``<journal>.trace`` unless *trace_path* names another), and
    returns only the trace batches the journal actually covers: a crash
    mid-epoch leaves trace frames beyond the durable point, and replaying
    them would "settle" batches the live run never made durable.
    ``strict=True`` refuses — :class:`TornTraceError` — whenever the
    bounded workload is shorter than the recorded trace (torn trace tail
    OR journal watermark behind the trace), instead of silently
    shortening.
    """
    trace_path = (
        trace_path_for(journal_path) if trace_path is None else trace_path
    )
    _end, _epochs, _rows, tag = _scan_valid_end(str(journal_path))
    batches = read_trace(trace_path, strict=strict)
    covered = [] if tag is None else [b for b in batches if b.index <= tag]
    if strict and len(covered) != len(batches):
        raise TornTraceError(
            f"{journal_path}: journal covers batches through tag={tag} "
            f"but the trace records {len(batches)}; strict replay "
            "refuses a workload the live run never made durable"
        )
    return covered, tag
