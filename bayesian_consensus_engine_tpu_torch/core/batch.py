"""Host packing layer + batched array consensus engine.

This is the seam where ragged, string-keyed payloads become dense int32 and
float arrays and back: (market, source) pairs are ordered by **sorted
source id within each market** so the device sums floats in the same order
the scalar engine does, duplicate signals from one source average in
original signal order, and output documents are rehydrated on the host in
the exact reference shape.

Each packing pass runs in the port's C extension (``native/fastpack.c``,
built at first use by ``native/build.py``) when it is available, else in
its numpy/Python twin; the two are bit-identical, and both equal the JAX
package's for the same input. ``native=None`` auto-detects, ``True``
forces the C pass (raising when it is unavailable), ``False`` the twin.

The device pass (:func:`run_packed`) is ``ops.consensus``'s ordered
segment sums: the per-pair duplicate mean, then the per-market
(Σw, Σp̄w, Σcw). It runs on CUDA unless ``device="cpu"`` is passed, in
float32 unless ``dtype=torch.float64`` is, and gives the JAX package's
batched bits on either device. Unlike the JAX package it pads nothing:
its power-of-two buckets only let jit reuse compilations, and the port
compiles nothing per shape.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import numpy as np

import torch

from bayesian_consensus_engine_tpu_torch.ops.consensus import (
    pair_mean_from_flat,
    weighted_sums_from_pairs,
)
from bayesian_consensus_engine_tpu_torch.utils.config import (
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
    SCHEMA_VERSION,
)
from bayesian_consensus_engine_tpu_torch.utils.device import (
    resolve_device,
    resolve_dtype,
)
from bayesian_consensus_engine_tpu_torch.native import build as _native_build
from bayesian_consensus_engine_tpu_torch.utils.interning import (
    IdInterner,
    _load_internmap,
)

#: host lookup: (source_id, market_id) → (reliability, confidence, known)
ReliabilityLookup = Callable[[str, str], tuple[float, float, bool]]


def cold_start_lookup(_sid: str, _mid: str) -> tuple[float, float, bool]:
    return DEFAULT_RELIABILITY, DEFAULT_CONFIDENCE, False


def mapping_lookup(
    table: Mapping[str, Mapping[str, float]] | None,
) -> ReliabilityLookup:
    """Adapt a per-source dict (one market's reliability table) to a lookup.

    Presence semantics match the scalar engine: a key that exists — even
    with missing fields — is NOT cold-start.
    """
    if table is None:
        return cold_start_lookup

    def lookup(sid: str, _mid: str) -> tuple[float, float, bool]:
        entry = table.get(sid)
        if entry is None:
            return DEFAULT_RELIABILITY, DEFAULT_CONFIDENCE, False
        return (
            entry.get("reliability", DEFAULT_RELIABILITY),
            entry.get("confidence", DEFAULT_CONFIDENCE),
            True,
        )

    return lookup


@dataclass(frozen=True)
class PackedBatch:
    """Dense packing of M markets' signals, ready for the device pass.

    Pairs are ordered (market row asc, source id asc) — the float-summation
    order of the scalar engine. ``pair_slice(m)`` gives market *m*'s pairs.
    """

    market_keys: list[str]            # row → market id
    pair_market: np.ndarray           # i32[P]
    pair_source_ids: list[str]        # row → source id (sorted within market)
    pair_reliability: np.ndarray      # f[P]
    pair_confidence: np.ndarray       # f[P]
    pair_known: np.ndarray            # bool[P] — False ⇒ coldStartSources
    flat_probs: np.ndarray            # f[N] raw signal probabilities
    flat_pair: np.ndarray             # i32[N]
    signals_per_market: np.ndarray    # i32[M] raw signal counts (diagnostics)
    pair_offsets: np.ndarray          # i32[M+1] pair range per market

    @property
    def num_markets(self) -> int:
        return len(self.market_keys)

    @property
    def num_pairs(self) -> int:
        return len(self.pair_source_ids)

    def pair_slice(self, market_row: int) -> slice:
        return slice(
            int(self.pair_offsets[market_row]), int(self.pair_offsets[market_row + 1])
        )


class SourceCodes:
    """Per-signal source column as int32 codes + a code → id table.

    Accepted anywhere a per-signal ``source_ids`` sequence is
    (:func:`topology_fingerprint`,
    :func:`~.pipeline.build_settlement_plan_columnar`); equivalent string
    and coded columns produce identical plans and fingerprints. The table
    must be unique (two codes mapping to one id would alias a pair).
    """

    __slots__ = ("codes", "table")

    def __init__(self, codes, table: Sequence[str]) -> None:
        self.codes = np.ascontiguousarray(codes, dtype=np.int32)
        self.table = list(table)
        if len(set(self.table)) != len(self.table):
            raise ValueError("SourceCodes table entries must be unique")
        if len(self.codes) and len(self.table) == 0:
            raise ValueError("SourceCodes has signals but an empty table")
        if len(self.codes) and (
            int(self.codes.min()) < 0
            or int(self.codes.max()) >= len(self.table)
        ):
            # Checked HERE: the fingerprint indexes the table with these
            # codes, and a negative code would wrap into an aliased digest.
            raise ValueError("SourceCodes codes out of table range")

    def __len__(self) -> int:
        return len(self.codes)


def encode_source_ids(source_ids: Sequence[str]) -> SourceCodes:
    """Strings → :class:`SourceCodes` (one first-seen interning pass)."""
    codes, table = _intern_source_codes(source_ids)
    return SourceCodes(codes, table)


def _intern_source_codes(source_ids):
    """Strings → first-seen int32 codes + unique table, C pass when
    available."""
    module = _load_internmap()
    if module is not None:
        table = module.InternMap()
        if not isinstance(source_ids, (list, tuple)):
            source_ids = list(source_ids)
        codes = np.frombuffer(table.intern_batch(source_ids), dtype=np.int32)
        return codes, table.ids()
    interner = IdInterner()
    codes = np.asarray(interner.intern_all(source_ids), dtype=np.int32)
    return codes, interner.ids()


def topology_fingerprint(
    market_keys: Sequence[str],
    source_ids: "Sequence[str] | SourceCodes",
    offsets,
) -> bytes:
    """Order-sensitive fingerprint of a batch's SIGNAL TOPOLOGY.

    The topology is everything about a batch except the probabilities and
    outcomes: the market ids (in payload order), the raw per-signal source
    ids (markets back to back, original signal order), and the CSR
    *offsets*. Equal fingerprints mean plans identical up to the
    probability columns. The encoding is injective (ids are
    length-delimited, counts are part of the digest), and a
    :class:`SourceCodes` column digests identically to its decoded strings.
    """
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    digest = hashlib.blake2b(digest_size=16)
    digest.update(
        np.asarray([len(market_keys), len(source_ids)], np.int64).tobytes()
    )
    digest.update(
        np.fromiter(map(len, market_keys), np.int64, len(market_keys))
        .tobytes()
    )
    digest.update("".join(market_keys).encode("utf-8"))
    if isinstance(source_ids, SourceCodes):
        table_lens = np.fromiter(
            map(len, source_ids.table), np.int64, len(source_ids.table)
        )
        if len(source_ids):
            digest.update(table_lens[source_ids.codes].tobytes())
        fastpack = _load_fastpack()
        if fastpack is not None:
            digest.update(fastpack.join_codes(source_ids.codes, source_ids.table))
        else:
            table = source_ids.table
            digest.update(
                "".join([table[c] for c in source_ids.codes.tolist()])
                .encode("utf-8")
            )
    else:
        digest.update(
            np.fromiter(map(len, source_ids), np.int64, len(source_ids))
            .tobytes()
        )
        digest.update("".join(source_ids).encode("utf-8"))
    digest.update(offsets.tobytes())
    return digest.digest()


def pair_fingerprint(
    market_keys: Sequence[str],
    sid_of_rank: Sequence[str],
    pair_market,
    pair_rank,
    pair_offsets,
) -> bytes:
    """Order-sensitive fingerprint of a batch's RESOLVED PAIR SET: the
    market table in payload order, the code-point-sorted source table, and
    the grouped (market, source-rank) pair list with its CSR offsets."""
    pair_market = np.ascontiguousarray(pair_market, dtype=np.int32)
    pair_rank = np.ascontiguousarray(pair_rank, dtype=np.int32)
    pair_offsets = np.ascontiguousarray(pair_offsets, dtype=np.int64)
    digest = hashlib.blake2b(digest_size=16)
    digest.update(
        np.asarray(
            [len(market_keys), len(sid_of_rank), len(pair_market)], np.int64
        ).tobytes()
    )
    digest.update(
        np.fromiter(map(len, market_keys), np.int64, len(market_keys))
        .tobytes()
    )
    digest.update("".join(market_keys).encode("utf-8"))
    digest.update(
        np.fromiter(map(len, sid_of_rank), np.int64, len(sid_of_rank))
        .tobytes()
    )
    digest.update("".join(sid_of_rank).encode("utf-8"))
    digest.update(pair_market.tobytes())
    digest.update(pair_rank.tobytes())
    digest.update(pair_offsets.tobytes())
    return digest.digest()


def _load_fastpack(force: bool = False):
    """The C ``fastpack`` module, or ``None`` when the Python twins must
    run (``force``: an explicit ``native=True``, which raises instead)."""
    return _native_build.load("fastpack", force=force)


def _object_native_available() -> bool:
    """Auto-detection for the object packer: the extension is available
    and ``BCE_NO_NATIVE`` is unset (an explicit ``native=True`` bypasses
    this)."""
    return _load_fastpack() is not None


#: Auto-detection for the columnar passes: the port builds one extension
#: from its own source, so the object and columnar passes come together.
_columnar_native_available = _object_native_available


def _fastpack_for(native: "bool | None"):
    """The module a pass called with *native* runs on, or ``None`` for
    its twin."""
    return None if native is False else _load_fastpack(force=bool(native))


def columns_from_payloads(payloads, native: "bool | None" = None):
    """Flatten dict payloads to ``(market_keys, source_ids, probs, offsets)``:
    the raw columns in original signal order, the form
    :func:`~.pipeline.build_settlement_plan_columnar` consumes. One C pass
    when the extension is available; the Python twin gives the same
    values."""
    fastpack = _fastpack_for(native)
    if fastpack is not None:
        if not isinstance(payloads, (list, tuple)):
            payloads = list(payloads)
        keys, source_ids, probs_buf, offs_buf = (
            fastpack.columns_from_payloads(payloads)
        )
        return (
            keys,
            source_ids,
            np.frombuffer(probs_buf, dtype=np.float64),
            np.frombuffer(offs_buf, dtype=np.int64),
        )
    market_keys: list[str] = []
    source_ids: list[str] = []
    probs: list[float] = []
    offsets: list[int] = [0]
    for market_id, signals in payloads:
        market_keys.append(market_id)
        for signal in signals:
            source_ids.append(signal["sourceId"])
            probs.append(signal["probability"])
        offsets.append(len(source_ids))
    return (
        market_keys,
        source_ids,
        np.asarray(probs, dtype=np.float64),
        np.asarray(offsets, dtype=np.int64),
    )


def group_columns(
    codes: np.ndarray,
    rank_of_code: np.ndarray,
    offsets: np.ndarray,
    probabilities: np.ndarray,
    native: "bool | None" = None,
):
    """The columnar grouping pass: coded signals → ordered pair arrays.

    Given per-signal int32 source *codes*, the code → code-point-rank
    permutation, int64 CSR *offsets* and float64 *probabilities*, returns

    ``(signal_pairs i64[N], pair_market i32[P], pair_rank i32[P],
    pair_offsets i64[M+1], pair_sums f64[P], pair_counts i64[P])``

    with pairs ordered market-major, rank ascending within each market
    (the scalar engine's float-summation order) and per-pair sums
    accumulated in original signal order (the duplicate-averaging
    contract). The C pass (``fastpack.group_columns``, emitting into
    preallocated buffers) and the numpy twin give identical arrays.
    """
    num_markets = len(offsets) - 1
    fastpack = _fastpack_for(native)
    if fastpack is not None:
        n = len(codes)
        signal_pairs = np.empty(n, dtype=np.int64)
        pair_market = np.empty(n, dtype=np.int32)
        pair_rank = np.empty(n, dtype=np.int32)
        pair_offsets = np.empty(num_markets + 1, dtype=np.int64)
        sums = np.empty(n, dtype=np.float64)
        counts = np.empty(n, dtype=np.int64)
        num_pairs = fastpack.group_columns(
            np.ascontiguousarray(codes, dtype=np.int32),
            np.ascontiguousarray(rank_of_code, dtype=np.int32),
            np.ascontiguousarray(offsets, dtype=np.int64),
            np.ascontiguousarray(probabilities, dtype=np.float64),
            signal_pairs, pair_market, pair_rank, pair_offsets, sums, counts,
        )
        return (
            signal_pairs,
            pair_market[:num_pairs],
            pair_rank[:num_pairs],
            pair_offsets,
            sums[:num_pairs],
            counts[:num_pairs],
        )

    codes = np.asarray(codes)
    if len(codes) and int(codes.min()) < 0:
        # Negative-index wrapping would return a plausible but wrong
        # grouping where the C pass raises; the twins must error alike.
        raise IndexError("source codes must be non-negative")
    num_uniq = len(rank_of_code)
    market_of_signal = np.repeat(
        np.arange(num_markets, dtype=np.int64), np.diff(offsets)
    )
    # Composite (market, source-rank) key: its sorted-unique sequence IS
    # the pair list in the scalar engine's order.
    stride = max(num_uniq, 1)
    key = market_of_signal * stride + np.asarray(
        rank_of_code, dtype=np.int64
    )[codes]
    uniq_keys, signal_pairs = np.unique(key, return_inverse=True)
    pair_market = (uniq_keys // stride).astype(np.int32)
    pair_rank = (uniq_keys % stride).astype(np.int32)
    pair_offsets = np.searchsorted(
        pair_market, np.arange(num_markets + 1)
    ).astype(np.int64)
    num_pairs = len(uniq_keys)
    # np.add.at accumulates in signal order — the scalar path's
    # left-to-right duplicate sum per pair.
    sums = np.zeros(num_pairs, dtype=np.float64)
    np.add.at(sums, signal_pairs, probabilities)
    counts = np.bincount(signal_pairs, minlength=num_pairs)
    return (
        signal_pairs, pair_market, pair_rank, pair_offsets, sums, counts,
    )


def pair_accumulate(
    pair_idx: np.ndarray,
    probabilities: np.ndarray,
    num_pairs: int,
    native: "bool | None" = None,
) -> np.ndarray:
    """Ordered per-pair probability sums: ``sums[pair_idx[i]] +=
    probabilities[i]`` in signal order (the scalar engine's left-to-right
    duplicate sum). The C pass and the ``np.add.at`` twin are
    bit-identical."""
    sums = np.zeros(num_pairs, dtype=np.float64)
    fastpack = _fastpack_for(native)
    if fastpack is not None:
        fastpack.pair_accumulate(
            np.ascontiguousarray(pair_idx),
            np.ascontiguousarray(probabilities, dtype=np.float64),
            sums,
        )
        return sums
    pair_idx = np.asarray(pair_idx)
    if len(pair_idx) and int(pair_idx.min()) < 0:
        # np.add.at wraps negative indices; the C pass raises.
        raise IndexError("pair indices must be non-negative")
    np.add.at(sums, pair_idx, probabilities)
    return sums


def _pack_grouping_python(markets):
    """Python twin of ``fastpack.pack``: the grouping pass over dict
    payloads."""
    pair_market: list[int] = []
    pair_source_ids: list[str] = []
    flat_probs: list[float] = []
    flat_pair: list[int] = []
    signals_per_market: list[int] = []
    pair_offsets: list[int] = [0]

    for market_row, (_market_id, signals) in enumerate(markets):
        signals_per_market.append(len(signals))
        seen: dict[str, None] = {}
        for signal in signals:
            seen[signal["sourceId"]] = None

        base = len(pair_source_ids)
        ordered = sorted(seen)
        slot_of = {sid: base + i for i, sid in enumerate(ordered)}
        pair_market.extend([market_row] * len(ordered))
        pair_source_ids.extend(ordered)

        # Raw signals in original order → duplicate averaging keeps the
        # scalar path's left-to-right accumulation order per pair.
        for signal in signals:
            flat_probs.append(signal["probability"])
            flat_pair.append(slot_of[signal["sourceId"]])

        pair_offsets.append(len(pair_source_ids))

    return (
        pair_market, pair_source_ids, flat_probs, flat_pair,
        signals_per_market, pair_offsets,
    )


def pack_markets(
    markets: Sequence[tuple[str, Sequence[Mapping[str, Any]]]],
    lookup: ReliabilityLookup = cold_start_lookup,
    native: "bool | None" = None,
) -> PackedBatch:
    """Sort and flatten raw (market_id, signals) payloads.

    The grouping pass runs in C (``fastpack.pack``) when the extension is
    available; its Python twin gives identical outputs. The reliability
    ``lookup`` is a user callable, run in Python once per unique pair; the
    settlement planner leaves it at the cold-start default and reads state
    from the store's rows instead.
    """
    markets = list(markets)  # consumed twice (grouping pass + key/lookup pass)
    fastpack = _fastpack_for(native)
    grouping = fastpack.pack if fastpack is not None else _pack_grouping_python
    (pair_market, pair_source_ids, flat_probs, flat_pair,
     signals_per_market, pair_offsets) = grouping(markets)

    market_keys = [market_id for market_id, _signals in markets]
    num_pairs = len(pair_source_ids)
    if lookup is cold_start_lookup:
        pair_rel = np.full(num_pairs, DEFAULT_RELIABILITY)
        pair_conf = np.full(num_pairs, DEFAULT_CONFIDENCE)
        pair_known = [False] * num_pairs
    else:
        pair_rel = []
        pair_conf = []
        pair_known = []
        for sid, market_row in zip(pair_source_ids, pair_market):
            reliability, confidence, known = lookup(sid, market_keys[market_row])
            pair_rel.append(reliability)
            pair_conf.append(confidence)
            pair_known.append(known)

    dtype = np.float64  # host packing always f64; cast on device transfer
    return PackedBatch(
        market_keys=market_keys,
        pair_market=np.asarray(pair_market, dtype=np.int32),
        pair_source_ids=list(pair_source_ids),
        pair_reliability=np.asarray(pair_rel, dtype=dtype),
        pair_confidence=np.asarray(pair_conf, dtype=dtype),
        pair_known=np.asarray(pair_known, dtype=bool),
        flat_probs=np.asarray(flat_probs, dtype=dtype),
        flat_pair=np.asarray(flat_pair, dtype=np.int32),
        signals_per_market=np.asarray(signals_per_market, dtype=np.int32),
        pair_offsets=np.asarray(pair_offsets, dtype=np.int32),
    )


def run_packed(
    batch: PackedBatch,
    device=None,
    dtype=None,
    rounds: "list | None" = None,
):
    """Run the device pass over a packed batch; returns host numpy arrays
    ``(pair_mean f[P], total_weight f[M], weighted_prob f[M],
    weighted_conf f[M])``.

    ``device=None`` is CUDA (raising without it), ``dtype=None`` float32;
    the host's float64 packing is rounded to *dtype* on the way in. When
    *rounds* is a list, each ordered sum appends its number of rounds (its
    longest segment): the mean's, then the weighted sums'.
    """
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def floats(array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(device=device, dtype=dtype)

    def ints(array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(device=device, dtype=torch.int64)

    pair_mean = pair_mean_from_flat(
        floats(batch.flat_probs), ints(batch.flat_pair), batch.num_pairs, rounds
    )
    total_weight, weighted_prob, weighted_conf = weighted_sums_from_pairs(
        pair_mean,
        floats(batch.pair_reliability),
        floats(batch.pair_confidence),
        ints(batch.pair_market),
        batch.num_markets,
        rounds,
    )
    return tuple(
        x.cpu().numpy()
        for x in (pair_mean, total_weight, weighted_prob, weighted_conf)
    )


def _format_document(
    batch: PackedBatch,
    market_row: int,
    total_weight: np.ndarray,
    weighted_prob: np.ndarray,
    weighted_conf: np.ndarray,
) -> dict[str, Any]:
    """Rehydrate one market's reference-shaped output document.

    The two normalising divides happen here, on host Python floats, so the
    document matches the scalar engine bit for bit when the device sums do.
    """
    pairs = batch.pair_slice(market_row)
    tw = float(total_weight[market_row])
    has_weight = tw != 0  # scalar parity: the scalar path tests == 0

    source_weights = []
    cold_sources = []
    for p in range(pairs.start, pairs.stop):
        weight = float(batch.pair_reliability[p])
        source_weights.append(
            {
                "sourceId": batch.pair_source_ids[p],
                "weight": weight,
                "normalizedWeight": weight / tw if has_weight else 0.0,
            }
        )
        if not batch.pair_known[p]:
            cold_sources.append(batch.pair_source_ids[p])

    return {
        "schemaVersion": SCHEMA_VERSION,
        "consensus": float(weighted_prob[market_row]) / tw if has_weight else None,
        "confidence": float(weighted_conf[market_row]) / tw if has_weight else 0.0,
        "sourceWeights": source_weights,
        "normalization": {
            "totalWeight": tw,
            "sourceCount": pairs.stop - pairs.start,
        },
        "diagnostics": {
            "status": "computed",
            "sources": int(batch.signals_per_market[market_row]),
            "uniqueSources": pairs.stop - pairs.start,
            "coldStartSources": cold_sources,
        },
    }


def compute_batch_consensus(
    markets: Sequence[tuple[str, Sequence[Mapping[str, Any]]]],
    lookup: ReliabilityLookup = cold_start_lookup,
    device=None,
    dtype=None,
) -> dict[str, dict[str, Any]]:
    """Batched consensus over many markets in one device pass.

    Returns ``{market_id: output_document}`` with each document in the
    reference shape, stamped with ``marketId`` like
    ``Market.compute_consensus``. Markets with no signals get the reduced
    4-key document. *device* and *dtype* are :func:`run_packed`'s.
    """
    live = [(mid, sigs) for mid, sigs in markets if sigs]
    results: dict[str, dict[str, Any]] = {}

    if live:
        batch = pack_markets(live, lookup)
        _pair_mean, total_weight, weighted_prob, weighted_conf = run_packed(
            batch, device=device, dtype=dtype
        )
        for row, market_id in enumerate(batch.market_keys):
            document = _format_document(
                batch, row, total_weight, weighted_prob, weighted_conf
            )
            document["marketId"] = market_id
            results[market_id] = document

    for market_id, signals in markets:
        if not signals:
            results[market_id] = {
                "schemaVersion": SCHEMA_VERSION,
                "consensus": None,
                "confidence": 0.0,
                "marketId": market_id,
            }
    return results


def store_lookup(store) -> ReliabilityLookup:
    """Adapt a ``ReliabilityStore`` to a packing lookup (decay-on-read).

    ``known`` is always True, matching the scalar market sweep: it builds a
    reliability entry for every signalling source, so the sweep never
    reports coldStartSources.
    """

    def lookup(sid: str, mid: str) -> tuple[float, float, bool]:
        record = store.get_reliability(sid, mid, apply_decay=True)
        return record.reliability, record.confidence, True

    return lookup


def compute_all_consensus_batched(
    market_store,
    reliability_store=None,
    device=None,
    dtype=None,
) -> dict[str, dict[str, Any]]:
    """Batched twin of ``MarketStore.compute_all_consensus``: one device pass
    over every OPEN market instead of a market-by-market loop. Results are
    cached on each ``Market`` (``consensus_result``) like the scalar sweep.
    """
    # `MarketStatus` is a str-Enum, so the wire value "open" IS the status
    # contract; comparing against it keeps core/ below models/.
    open_markets = [
        m for m in market_store.list_markets() if m.status == "open"
    ]
    payload = [(str(m.id), m.signals) for m in open_markets]
    lookup = (
        store_lookup(reliability_store)
        if reliability_store is not None
        else cold_start_lookup
    )
    results = compute_batch_consensus(payload, lookup, device=device, dtype=dtype)
    for market in open_markets:
        if market.signals:
            market.consensus_result = results[str(market.id)]
    return results


def compute_consensus_torch(
    signals: Sequence[Mapping[str, Any]],
    source_reliability: Mapping[str, Mapping[str, float]] | None = None,
    device=None,
    dtype=None,
) -> dict[str, Any]:
    """Single-market array-path twin of ``engine.compute_consensus``.

    Same output shape and key order; the float sums come from the device
    pass (at *dtype*, float32 by default). The scalar path remains the
    byte-exact contract; at float64 this path reproduces it on the golden
    fixture.
    """
    batch = pack_markets([("_", signals)], mapping_lookup(source_reliability))
    _pair_mean, total_weight, weighted_prob, weighted_conf = run_packed(
        batch, device=device, dtype=dtype
    )
    return _format_document(batch, 0, total_weight, weighted_prob, weighted_conf)
