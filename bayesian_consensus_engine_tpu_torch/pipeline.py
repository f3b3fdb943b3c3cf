"""End-to-end settlement pipeline: payloads → device kernel → SQLite.

The one flow the subsystems exist for, as in ``pipeline.py`` of the JAX
package:

    raw (market_id, signals) payloads
      → packing                                   (core.batch)
      → interned (source, market) rows            (TensorReliabilityStore)
      → slot-major (K, M) plan block              (this module)
      → gather, N consensus+update cycles, scatter (ops.settle_kernel, one launch)
      → deferred host absorb                      (TensorReliabilityStore)
      → reference-format SQLite checkpoint        (flush_to_sqlite)

Two-phase API so the host-side packing/interning cost is paid once per
signal topology, then any number of settlements run on the device:

    plan = build_settlement_plan(store, payloads)
    result = settle(store, plan, outcomes, steps=5)
    store.flush_to_sqlite("checkpoint.db")

`settle_payloads` wraps the three steps for the one-shot case. Settlement
runs on the store's device: on CUDA every settle is one launch of the
hand-written settle kernel, on the CPU its plain torch version.

The resident one-card session keeps the plan's (K, M) block state on the
device across settles and adds the analytics entry, with graph inference
over correlated markets:

    with ShardedSettlementSession(store, plan) as session:
        result = session.settle(outcomes, steps, now)
        result, tiebreak, bands, propagated = session.settle_with_analytics(
            outcomes, steps, now, analytics=AnalyticsOptions(
                graph=graph, inference=InferenceOptions(tol=1e-5)))

The session runs on a ``(markets, sources)`` mesh; with no mesh it takes
the (1, 1) mesh of the store's device, one card. On CUDA every session
call is one launch of the one-pass kernel (``ops/onepass_kernel.py``) per
markets shard or, when the sources axis is sharded
(``ShardedSettlementSession(store, plan, make_mesh((1, 4), [cuda0] * 4))``),
one launch of the partials kernel (``ops/partials_kernel.py``) per shard
followed by the cross-shard merge; with a graph, the belief sweep's
launches (``ops/bp_kernel.py``) follow. ``settle_sharded`` is the one-shot
wrapper.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.core.batch import (
    SourceCodes,
    _columnar_native_available,
    _intern_source_codes,
    group_columns,
    pack_markets,
    pair_accumulate,
    pair_fingerprint,
    topology_fingerprint,
)
from bayesian_consensus_engine_tpu_torch.analytics.bands import AnalyticsOptions
from bayesian_consensus_engine_tpu_torch.convert import sharded_block_from_numpy
from bayesian_consensus_engine_tpu_torch.analytics.graph import MarketGraph
from bayesian_consensus_engine_tpu_torch.infer.blocks import MarketBlocks
from bayesian_consensus_engine_tpu_torch.infer.bp import InferenceOptions
from bayesian_consensus_engine_tpu_torch.ops.propagate import PropagatedBeliefs
from bayesian_consensus_engine_tpu_torch.ops.settle_kernel import (
    settle_cycles,
    touched_layout,
)
from bayesian_consensus_engine_tpu_torch.ops.tiebreak import (
    DEFAULT_CHUNK_AGENTS,
    RingTieBreakResult,
)
from bayesian_consensus_engine_tpu_torch.ops.uncertainty import (
    DEFAULT_CHUNK_SLOTS,
    UncertaintyBands,
)
from bayesian_consensus_engine_tpu_torch.parallel.distributed import (
    global_slot_block,
)
from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
    MARKETS_AXIS,
    SOURCES_AXIS,
    Mesh,
    make_mesh,
    shard_market_vector,
    unshard_slot_block,
)
from bayesian_consensus_engine_tpu_torch.parallel.sharded import (
    build_cycle_analytics_loop,
    build_cycle_loop,
)
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    DeviceReliabilityState,
)
from bayesian_consensus_engine_tpu_torch.utils.config import (
    CONFIDENCE_GROWTH_RATE,
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
)
from bayesian_consensus_engine_tpu_torch.utils.device import resolve_dtype
from bayesian_consensus_engine_tpu_torch.utils.timeconv import NEVER
from bayesian_consensus_engine_tpu_torch.utils.timeconv import now_days as _now_days

Payload = Sequence[tuple[str, Sequence[Mapping[str, Any]]]]

_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@dataclass(frozen=True)
class SettlementPlan:
    """Static device layout for one signal topology (reusable across settles).

    Block arrays are slot-major (K, M). Padding slots carry ``row = -1``
    and ``mask = False``; the kernel never reads or writes them, so the
    plan stays valid even if the store interns more pairs after it was
    built.

    The plan is **immutable after build** — every array is read-only,
    because ``settle`` caches device copies of the block (keyed by dtype
    and device) on the plan; a mutated host array would silently diverge
    from its cached device twin.
    """

    market_keys: list[str]        # row → market id (payload order)
    slot_rows: np.ndarray         # i32[K, M] flat store row per slot (−1 pad)
    probs: np.ndarray             # f64[K, M] per-pair mean probability
    mask: np.ndarray              # bool[K, M] slot carries a signal
    signals_per_market: np.ndarray  # i32[M] raw signal counts (diagnostics)
    binding: tuple[tuple[int, str, str], ...]  # (row, source, market) probes
    #: order-sensitive topology digest (core.batch.topology_fingerprint),
    #: or None when the builder was not asked for one.
    fingerprint: "bytes | None" = None

    @property
    def num_markets(self) -> int:
        return len(self.market_keys)

    @property
    def num_slots(self) -> int:
        return int(self.slot_rows.shape[0])

    def refresh(self, probabilities) -> "SettlementPlan":
        """Probability-only twin of this plan: same topology, new signals.

        *probabilities* is the flat per-signal column (original signal
        order, markets back to back). The row mapping, slot layout,
        padding, binding probes and fingerprint are SHARED with this plan;
        only the probability block is recomputed — bit-identical to a full
        rebuild on the same input. The caller must guarantee the topology
        is unchanged (compare :func:`~.core.batch.topology_fingerprint`
        digests). ``settle`` then uploads only the new probability block
        and adopts the parent's device-resident topology arrays.
        """
        meta = getattr(self, "_refresh_meta", None)
        if meta is None:
            raise ValueError("plan carries no refresh metadata")
        signal_pairs, counts, slot_of_pair, market_of_pair = meta
        probabilities = np.ascontiguousarray(probabilities, dtype=np.float64)
        if probabilities.shape != (len(signal_pairs),):
            raise ValueError(
                f"{len(probabilities)} probabilities for a topology of "
                f"{len(signal_pairs)} signals"
            )
        sums = pair_accumulate(signal_pairs, probabilities, len(counts))
        pair_mean = sums / np.maximum(counts, 1)
        probs = np.zeros_like(self.probs)
        probs[slot_of_pair, market_of_pair] = pair_mean
        probs.setflags(write=False)
        plan = SettlementPlan(
            market_keys=self.market_keys,
            slot_rows=self.slot_rows,
            probs=probs,
            mask=self.mask,
            signals_per_market=self.signals_per_market,
            binding=self.binding,
            fingerprint=self.fingerprint,
        )
        object.__setattr__(plan, "_refresh_meta", meta)
        object.__setattr__(plan, "_refreshed_from", self)
        touched = getattr(self, "_touched", None)
        if touched is not None:
            object.__setattr__(plan, "_touched", touched)
        return plan


def build_settlement_plan(
    store,
    payloads: Payload,
    native: Optional[bool] = None,
    num_slots: "int | str | None" = None,
    fingerprint: "bool | bytes" = False,
) -> SettlementPlan:
    """Pack, intern, and lay out payloads as a dense settlement block.

    One packing pass (the C ``fastpack.pack`` when available) groups,
    sorts and flattens the raw signals — duplicate signals from one source
    collapse to their mean, in scalar accumulation order — one interning
    pass maps every (source, market) pair to its flat store row, and the
    ragged per-market pair lists become a dense slot-major block. Market
    ids must be unique within one plan.

    ``native`` forces the C packer (True), its Python twin (False), or
    auto-detects (None); the plans are bit-identical. ``num_slots`` pins
    the block's slot height K (error if the data needs more); ``"bucket"``
    pads the natural K to the next multiple of 8. ``fingerprint=True``
    stamps the plan with its topology digest; a ``bytes`` value attaches a
    digest the caller already computed.
    """
    payloads = list(payloads)
    keys = [market_id for market_id, _ in payloads]
    if len(set(keys)) != len(keys):
        raise ValueError("duplicate market ids in one settlement plan")

    packed = pack_markets(payloads, native=native)
    market_of_pair = packed.pair_market
    pair_markets = [keys[row] for row in market_of_pair.tolist()]
    rows = store.rows_for_arrays(
        packed.pair_source_ids, pair_markets, allocate=True
    )
    if fingerprint is True:
        raw_sids = [
            packed.pair_source_ids[p] for p in packed.flat_pair.tolist()
        ]
        signal_offsets = np.concatenate(
            [[0], np.cumsum(packed.signals_per_market, dtype=np.int64)]
        )
        fingerprint = topology_fingerprint(keys, raw_sids, signal_offsets)
    return _assemble_plan(
        keys,
        rows,
        market_of_pair,
        packed.pair_offsets,
        _pair_means(packed),
        packed.pair_source_ids.__getitem__,
        pair_markets.__getitem__,
        packed.signals_per_market,
        num_slots=num_slots,
        signal_pairs=packed.flat_pair,
        fingerprint=fingerprint or None,
    )


@dataclass
class StagedColumnarPlan:
    """The store-free half of a columnar plan build.

    Everything :func:`build_settlement_plan_columnar` computes WITHOUT
    touching the store: validation, source-code resolution, the grouping
    pass (C when available), duplicate averaging and the fingerprints.
    :meth:`bind` completes it — one pair-interning pass plus the dense
    block fill — and is the only part that mutates shared state.
    ``stage(...).bind(store)`` ≡ the one-shot builder, bit-for-bit.
    """

    market_keys: list
    sid_of_rank: list
    pair_market: np.ndarray
    pair_rank: np.ndarray
    pair_offsets: np.ndarray
    pair_mean: np.ndarray
    signals_per_market: np.ndarray
    signal_pairs: np.ndarray
    num_slots: "int | str | None"
    fingerprint: "bytes | None"
    #: whether the grouping pass ran in C.
    used_native: bool
    #: ``"full" | "delta" | "auto"`` — how :meth:`bind` interns. ``full``
    #: walks every pair; ``delta`` and ``auto`` (the same today; ``auto``
    #: is the spelling callers should use) consult the store's epoch pair
    #: table so only the batch's pair delta walks the interner. Every mode
    #: gives the same plans, row assignment and SQLite bytes.
    intern_mode: str = "auto"
    #: pair-set digest (:func:`~.core.batch.pair_fingerprint`), the epoch
    #: table's O(1) reuse key; ``None`` skips that tier only.
    pair_fingerprint: "bytes | None" = None

    def bind(self, store) -> SettlementPlan:
        """Intern this stage's pairs into *store* and assemble the plan.

        The delta route asks the store to resolve against its epoch pair
        table (:meth:`~.TensorReliabilityStore.rows_for_pairs_delta`), the
        full route interns every pair in batch order. The plan carries
        ``plan.intern_stats``: ``{"intern_s", "mode", "pairs",
        "matched_pairs", "interned_pairs", "fingerprint_hit"}``.
        """
        intern_start = time.perf_counter()
        use_delta = self.intern_mode != "full" and hasattr(
            store, "rows_for_pairs_delta"
        )
        if use_delta:
            rows, resolve_stats = store.rows_for_pairs_delta(
                self.sid_of_rank, self.pair_rank,
                self.market_keys, self.pair_market,
                self.pair_offsets, self.pair_fingerprint,
            )
        else:
            rows = store.rows_for_indexed(
                self.sid_of_rank, self.pair_rank,
                self.market_keys, self.pair_market,
            )
            resolve_stats = {
                "pairs": len(self.pair_market),
                "matched_pairs": 0,
                "interned_pairs": len(self.pair_market),
                "fingerprint_hit": False,
            }
        intern_stats = {
            "intern_s": time.perf_counter() - intern_start,
            "mode": "delta" if use_delta else "full",
            **resolve_stats,
        }
        sid_of_rank, pair_rank = self.sid_of_rank, self.pair_rank
        market_keys, pair_market = self.market_keys, self.pair_market
        plan = _assemble_plan(
            market_keys,
            rows,
            pair_market,
            self.pair_offsets,
            self.pair_mean,
            lambda i: sid_of_rank[pair_rank[i]],
            lambda i: market_keys[pair_market[i]],
            self.signals_per_market,
            num_slots=self.num_slots,
            signal_pairs=self.signal_pairs,
            fingerprint=self.fingerprint,
        )
        object.__setattr__(plan, "intern_stats", intern_stats)
        return plan


def stage_settlement_plan_columnar(
    market_keys: Sequence[str],
    source_ids: "Sequence[str] | SourceCodes",
    probabilities,
    offsets,
    num_slots: "int | str | None" = None,
    fingerprint: "bool | bytes" = False,
    native: Optional[bool] = None,
    intern_mode: str = "auto",
) -> StagedColumnarPlan:
    """Validate + group one columnar batch without touching any store.

    *source_ids* is either one string per signal (markets back to back)
    or a :class:`~.core.batch.SourceCodes` column. ``native`` forces the C
    grouping pass (True), the numpy twin (False), or auto-detects (None);
    the outputs are bit-identical. ``intern_mode`` routes
    :meth:`StagedColumnarPlan.bind`'s interning: ``"auto"``/``"delta"``
    consult the store's epoch pair table (the pair-set digest is computed
    here, so the bind pays only the resolve), ``"full"`` walks every pair.
    """
    if intern_mode not in ("full", "delta", "auto"):
        raise ValueError(
            f'intern_mode={intern_mode!r}: expected "full", "delta" or '
            '"auto"'
        )
    market_keys = list(market_keys)
    if len(set(market_keys)) != len(market_keys):
        raise ValueError("duplicate market ids in one settlement plan")
    num_markets = len(market_keys)
    probabilities = np.ascontiguousarray(probabilities, dtype=np.float64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if offsets.shape != (num_markets + 1,):
        raise ValueError(
            f"offsets must have shape ({num_markets + 1},); got {offsets.shape}"
        )
    if num_markets and (offsets[0] != 0 or np.any(np.diff(offsets) < 0)):
        raise ValueError("offsets must start at 0 and be non-decreasing")
    num_signals = int(offsets[-1]) if num_markets else 0
    if len(source_ids) != num_signals or len(probabilities) != num_signals:
        raise ValueError(
            f"offsets cover {num_signals} signals but got "
            f"{len(source_ids)} source ids / {len(probabilities)} probabilities"
        )

    signals_per_market = np.diff(offsets).astype(np.int32)

    # Source column → dense codes, then code → rank in code-point order by
    # sorting the unique table (one entry per distinct source id).
    if isinstance(source_ids, SourceCodes):
        codes, uniq = source_ids.codes, source_ids.table
    else:
        codes, uniq = _intern_source_codes(source_ids)
    order = sorted(range(len(uniq)), key=uniq.__getitem__)
    rank_of_code = np.empty(max(len(uniq), 1), dtype=np.int64)
    rank_of_code[np.asarray(order, dtype=np.int64)] = np.arange(len(order))
    sid_of_rank = [uniq[code] for code in order]

    used_native = (
        _columnar_native_available() if native is None else bool(native)
    )
    (signal_pairs, pair_market, pair_rank, pair_offsets,
     sums, counts) = group_columns(
        codes, rank_of_code, offsets, probabilities, native=native
    )
    pair_mean = sums / np.maximum(counts, 1)

    if fingerprint is True:
        fingerprint = topology_fingerprint(market_keys, source_ids, offsets)
    pair_fp = (
        pair_fingerprint(
            market_keys, sid_of_rank, pair_market, pair_rank, pair_offsets
        )
        if intern_mode != "full"
        else None
    )
    return StagedColumnarPlan(
        market_keys=market_keys,
        sid_of_rank=sid_of_rank,
        pair_market=pair_market,
        pair_rank=pair_rank,
        pair_offsets=pair_offsets,
        pair_mean=pair_mean,
        signals_per_market=signals_per_market,
        signal_pairs=signal_pairs,
        num_slots=num_slots,
        fingerprint=fingerprint or None,
        used_native=used_native,
        intern_mode=intern_mode,
        pair_fingerprint=pair_fp,
    )


def build_settlement_plan_columnar(
    store,
    market_keys: Sequence[str],
    source_ids: "Sequence[str] | SourceCodes",
    probabilities,
    offsets,
    num_slots: "int | str | None" = None,
    fingerprint: "bool | bytes" = False,
    native: Optional[bool] = None,
    intern_mode: str = "auto",
) -> SettlementPlan:
    """Vectorised twin of :func:`build_settlement_plan` for columnar input.

    *source_ids* (one string per signal, markets back to back, or a
    :class:`~.core.batch.SourceCodes` column), *probabilities*
    (float64[N]) and CSR *offsets* (int64[M+1]; market ``m``'s signals are
    ``[offsets[m], offsets[m+1])``). Produces a plan identical (bit for
    bit, including binding probes and row assignment order) to the
    dict-payload path on equivalent input: pairs within a market are
    ordered by source id, and duplicate signals from one (source, market)
    average in original signal order.

    ``native`` forces or forbids the C grouping pass and ``intern_mode``
    routes the pair interning (see :func:`stage_settlement_plan_columnar`);
    the plans are bit-identical either way. The build is
    ``stage_settlement_plan_columnar(...).bind(store)``.
    """
    return stage_settlement_plan_columnar(
        market_keys, source_ids, probabilities, offsets,
        num_slots=num_slots, fingerprint=fingerprint, native=native,
        intern_mode=intern_mode,
    ).bind(store)


def _assemble_plan(
    keys,
    rows,
    market_of_pair,
    pair_offsets,
    pair_mean,
    source_of,
    market_of,
    signals_per_market,
    num_slots: "int | str | None" = None,
    signal_pairs=None,
    fingerprint: "bytes | None" = None,
) -> SettlementPlan:
    """Shared plan tail: dense block fill + binding probes + freeze."""
    counts = np.diff(pair_offsets)
    num_markets = len(keys)
    needed_slots = int(counts.max()) if num_markets else 0
    if num_slots == "bucket":
        num_slots = max(8, -(-needed_slots // 8) * 8)
    elif isinstance(num_slots, str):
        raise ValueError(
            f"num_slots={num_slots!r}: the only supported string is 'bucket'"
        )
    if num_slots is None:
        num_slots = needed_slots
    elif needed_slots > num_slots:
        raise ValueError(
            f"num_slots={num_slots} but a market carries {needed_slots} "
            "distinct sources"
        )

    # Ragged pair lists → dense slot-major (K, M), written in place: slot k
    # of market m is its k-th pair (source-id-sorted within the market).
    slot_rows = np.full((num_slots, num_markets), -1, dtype=np.int32)
    probs = np.zeros((num_slots, num_markets), dtype=np.float64)
    mask = np.zeros((num_slots, num_markets), dtype=bool)
    slot_of_pair = (
        np.arange(len(rows), dtype=np.int64)
        - pair_offsets[:-1][market_of_pair]
    )
    slot_rows[slot_of_pair, market_of_pair] = rows
    probs[slot_of_pair, market_of_pair] = pair_mean
    mask[slot_of_pair, market_of_pair] = True

    # Binding probes: a spread of (row, pair) samples (always including the
    # highest row) lets settle() verify the plan still matches the store's
    # interner.
    if len(rows):
        probe_idx = {0, len(rows) - 1, int(np.argmax(rows))}
        probe_idx.update(range(0, len(rows), max(1, len(rows) // 8)))
        binding = tuple(
            (int(rows[i]), source_of(i), market_of(i))
            for i in sorted(probe_idx)
        )
    else:
        binding = ()

    plan = SettlementPlan(
        market_keys=keys,
        slot_rows=slot_rows,
        probs=probs,
        mask=mask,
        signals_per_market=np.asarray(signals_per_market, dtype=np.int32),
        binding=binding,
        fingerprint=fingerprint,
    )
    for array in (plan.slot_rows, plan.probs, plan.mask, plan.signals_per_market):
        array.setflags(write=False)
    if signal_pairs is not None:
        signal_pairs = np.ascontiguousarray(signal_pairs)
        counts = np.bincount(signal_pairs, minlength=len(rows))
        object.__setattr__(
            plan, "_refresh_meta",
            (signal_pairs, counts, slot_of_pair, market_of_pair),
        )
    return plan


def _pair_means(packed) -> np.ndarray:
    """Per-pair duplicate-signal means, host-side in scalar float order."""
    num_pairs = len(packed.pair_source_ids)
    sums = pair_accumulate(packed.flat_pair, packed.flat_probs, num_pairs)
    counts = np.bincount(packed.flat_pair, minlength=num_pairs)
    return sums / np.maximum(counts, 1)


class SettlementResult:
    """Per-market outputs of the final cycle, payload order.

    ``consensus`` (f[M]; NaN means zero weight) materialises LAZILY: the
    settle path hands the device tensor straight through, and the
    device→host fetch happens on first access. :meth:`fence` waits for
    completion with a scalar-sized fetch.
    """

    __slots__ = ("market_keys", "_consensus_raw", "_consensus_np")

    def __init__(self, market_keys: list[str], consensus) -> None:
        self.market_keys = market_keys
        self._consensus_raw = consensus
        self._consensus_np: Optional[np.ndarray] = None

    @property
    def consensus(self) -> np.ndarray:
        if self._consensus_np is None:
            raw = self._consensus_raw
            self._consensus_np = (
                raw.cpu().numpy() if isinstance(raw, torch.Tensor)
                else np.asarray(raw)
            )
            self._consensus_raw = None  # free the device buffer
        return self._consensus_np

    def fence(self) -> None:
        """Block until the settlement's outputs exist on the device,
        fetching only one scalar."""
        if self._consensus_np is None and len(self._consensus_raw):
            float(self._consensus_raw[0])

    def by_market(self) -> dict[str, float]:
        return {
            key: float(value)
            for key, value in zip(self.market_keys, self.consensus)
        }


def _check_plan(store, plan: SettlementPlan, outcomes: Sequence[bool]) -> None:
    """Shared settle-entry validation: outcome count + plan↔store binding."""
    if len(outcomes) != plan.num_markets:
        raise ValueError(
            f"{len(outcomes)} outcomes for {plan.num_markets} planned markets"
        )
    if plan.mask.any() and int(plan.slot_rows.max()) >= len(store):
        # A plan built against a different (or rebuilt) store: the kernel
        # would read and write rows that are not this plan's.
        raise ValueError(
            f"plan references row {int(plan.slot_rows.max())} but the store "
            f"holds {len(store)} pairs — was the plan built for this store?"
        )
    if plan.binding:
        probe_rows = store.rows_for_pairs(
            [(source_id, market_id) for _, source_id, market_id in plan.binding],
            allocate=False,
        )
        for (row, source_id, market_id), got in zip(plan.binding, probe_rows):
            if int(got) != row:
                raise ValueError(
                    f"plan is bound to a different store: ({source_id!r}, "
                    f"{market_id!r}) does not intern to row {row} here"
                )


def _rebase_epoch(flat: DeviceReliabilityState, epoch0: float, now_abs: float):
    """Ensure the settlement time lands strictly after the stamp epoch.

    Stamps are stored relative to *epoch0* with "> 0" meaning "ever
    updated", so a settlement at ``now_abs <= epoch0`` would write
    non-positive stamps that absorb reads back as NEVER. Backdated
    settlements are legitimate, so shift the epoch below ``now_abs`` and
    re-express the live stamps (never-updated rows keep exactly 0).
    """
    if now_abs - epoch0 > 0:
        return flat, epoch0
    new_epoch0 = now_abs - 1.0
    days = flat.updated_days
    delta = torch.tensor(epoch0 - new_epoch0, dtype=days.dtype, device=days.device)
    shifted = torch.where(days > 0, days + delta, days)
    return flat._replace(updated_days=shifted), new_epoch0


def _replay_confidences(store, touched_rows, conf_exact, steps: int) -> None:
    """Overwrite settled confidences with the exact host-replayed trajectory
    (one growth step per settled cycle, data-independent), whatever
    rounding the device used."""
    for _ in range(steps):
        conf_exact = np.minimum(
            1.0, conf_exact + (1.0 - conf_exact) * CONFIDENCE_GROWTH_RATE
        )
    store.overwrite_confidences(touched_rows, conf_exact)


def _plan_touched(plan: SettlementPlan):
    """The plan's touched rows and per-market offsets (kernel order),
    computed once and cached on the plan; refreshed plans share them."""
    touched = getattr(plan, "_touched", None)
    if touched is None:
        rows, offsets = touched_layout(plan.slot_rows, plan.mask)
        rows.setflags(write=False)
        touched = (rows, offsets)
        object.__setattr__(plan, "_touched", touched)
    return touched


def _device_plan(plan: SettlementPlan, dtype: torch.dtype, device: torch.device):
    """Device copies of the plan block, cached on the plan by (dtype,
    device). A probability-only refresh adopts its parent's topology
    tensors and uploads only the new probability block."""
    key = (dtype, device)
    cached = getattr(plan, "_device_arrays", None)
    if cached is not None and cached[0] == key:
        return cached
    _rows, offsets = _plan_touched(plan)
    parent = getattr(plan, "_refreshed_from", None)
    donor = getattr(parent, "_device_arrays", None) if parent is not None else None
    probs = torch.tensor(plan.probs, dtype=dtype, device=device)
    if donor is not None and donor[0] == key:
        cached = (key, donor[1], probs, donor[3], donor[4])
        object.__setattr__(parent, "_device_arrays", None)
    else:
        cached = (
            key,
            torch.tensor(plan.slot_rows, device=device),
            probs,
            torch.tensor(plan.mask, device=device),
            torch.tensor(offsets, device=device),
        )
    object.__setattr__(plan, "_device_arrays", cached)
    if parent is not None:
        # Served its purpose; dropping it keeps a long reuse chain from
        # pinning every predecessor plan in memory.
        object.__setattr__(plan, "_refreshed_from", None)
    return cached


def settle(
    store,
    plan: SettlementPlan,
    outcomes: Sequence[bool],
    steps: int = 1,
    now: Optional[float] = None,
    dtype=None,
) -> SettlementResult:
    """Run *steps* settlement cycles for the planned markets on the store's
    device.

    Each cycle: decay-on-read → weighted consensus → outcome correctness at
    p ≥ 0.5 → capped update of the undecayed state (day ``now + i``). The
    settled state becomes the store's pending device state (merged into
    the host lazily), so a follow-up ``flush_to_sqlite`` checkpoints
    exactly what settled.

    ``now`` is absolute epoch-days (defaults to the current time); pass it
    explicitly for reproducible parity runs. ``dtype`` is torch.float32
    (the default) or torch.float64.
    """
    _check_plan(store, plan, outcomes)
    dtype = resolve_dtype(dtype)
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"steps={steps} must be >= 0")

    # Pre-settle confidences: the post-settle values are replayed host-side
    # in exact scalar arithmetic (see overwrite_confidences).
    touched_rows, _offsets = _plan_touched(plan)
    conf_exact = store.host_confidences(touched_rows)

    # take_device_state hands forward a pending (unsynced) predecessor
    # settlement if one exists — the chained-settle fast path: no host→
    # device re-upload and no per-settle absorb.
    flat, epoch0 = store.take_device_state(dtype)
    now_abs = _now_days() if now is None else now
    flat, epoch0 = _rebase_epoch(flat, epoch0, now_abs)

    _, slot_rows_d, probs_d, mask_d, offsets_d = _device_plan(
        plan, dtype, store.device
    )
    outcome_d = torch.as_tensor(
        np.asarray(outcomes, dtype=bool), device=store.device
    )
    np_dtype = _NUMPY_DTYPE[dtype]
    now0 = float(np_dtype(now_abs - epoch0))
    rel, conf, days, exists, consensus, rel_touched = settle_cycles(
        flat.reliability,
        flat.confidence,
        flat.updated_days,
        flat.exists,
        slot_rows_d,
        probs_d,
        mask_d,
        outcome_d,
        offsets_d,
        len(touched_rows),
        now0,
        steps,
    )
    # Deferred absorb: the settled state becomes the store's pending device
    # truth; the exact confidence trajectory is maintained host-side NOW.
    # The sync recipe lets that merge fetch only the touched reliabilities:
    # the final stamp is the closed form the loop uses (now0 + steps − 1 in
    # device precision), and existence is monotone. steps == 0 settles
    # nothing: an empty recipe keeps the sync a no-op.
    stamp_rel = np_dtype(np_dtype(now0) + np_dtype(steps - 1))
    recipe = (
        (touched_rows, rel_touched, stamp_rel)
        if steps > 0
        else (touched_rows[:0], rel_touched[:0], stamp_rel)
    )
    store.defer_absorb(
        DeviceReliabilityState(rel, conf, days, exists), epoch0,
        sync_recipe=recipe,
    )
    _replay_confidences(store, touched_rows, conf_exact, steps)
    return SettlementResult(market_keys=plan.market_keys, consensus=consensus)


def settle_payloads(
    store,
    payloads: Payload,
    outcomes: Sequence[bool],
    steps: int = 1,
    now: Optional[float] = None,
    db_path=None,
    dtype=None,
) -> SettlementResult:
    """One-shot pipeline: plan, settle, and optionally checkpoint to SQLite."""
    plan = build_settlement_plan(store, payloads)
    result = settle(store, plan, outcomes, steps=steps, now=now, dtype=dtype)
    if db_path is not None:
        store.flush_to_sqlite(db_path)
    return result


# -- the resident session ------------------------------------------------------

_NO_PROCESS_BANDS = (
    "process bands (a mesh spread over several processes through "
    "torch.distributed) are not ported yet: ROADMAP queue 1 item 11"
)


def _pad_plan(array: np.ndarray, widths, fill) -> np.ndarray:
    """*array* padded by *widths* with *fill*; the array itself (the plan's
    read-only copy) when nothing is padded."""
    if not any(after for _before, after in widths):
        return array
    return np.pad(array, widths, constant_values=fill)


def _sharded_plan_cache(plan: SettlementPlan, mesh: Mesh, dtype):
    """The session's device copies of the plan block, cached on the plan
    per (mesh, dtype): ``(padded_total, band_rows, band_mask, probs_g,
    mask_g)``.

    As in the JAX session, the markets axis is padded up to a multiple of
    the markets extent and the slots axis up to a multiple of the sources
    extent (pad slots: row -1, mask False, probability 0; the state build
    gives them the cold prior). ``band_rows``/``band_mask`` are the padded
    host arrays (in one process the band is every market) and
    ``probs_g``/``mask_g`` grids of per-shard blocks.
    """
    key = (mesh, dtype)
    cache = getattr(plan, "_sharded_cache", None)
    if cache is None or cache[0] != key:
        markets_extent = mesh.shape[MARKETS_AXIS]
        sources_extent = mesh.shape[SOURCES_AXIS]
        padded_total = (
            -(-max(plan.num_markets, 1) // markets_extent) * markets_extent
        )
        num_slots = plan.num_slots
        pad_k = (
            -(-max(num_slots, 1) // sources_extent) * sources_extent - num_slots
        )
        widths = ((0, pad_k), (0, padded_total - plan.num_markets))
        band_rows = _pad_plan(plan.slot_rows, widths, -1)
        band_mask = _pad_plan(plan.mask, widths, False)
        band_probs = _pad_plan(plan.probs, widths, 0.0)
        cache = (
            key,
            padded_total,
            band_rows,
            band_mask,
            global_slot_block(band_probs, mesh, padded_total, dtype=dtype),
            global_slot_block(band_mask, mesh, padded_total),
        )
        object.__setattr__(plan, "_sharded_cache", cache)
    return cache[1:]


class _BandGather:
    """Lazy ``np.asarray``-able view of a resident block's masked slots.

    Resolves to ``block[mask]`` — the session's touched values, in
    ``band_rows[band_mask]`` (slot-major) order — only when the store's
    sync needs the bytes, so chained settles move nothing to the host. The
    block is a grid of per-shard blocks, reassembled in (sources, markets)
    order first; *mask* is the padded global mask on the first shard's
    device.

    ``held_nbytes`` is every shard's block the deferral pins in device
    memory, which the store's recipe chain counts against its budget. A
    gather whose block is the live state of a standing session reports 0:
    the session pins that block with or without the recipe. The session
    is held by weak reference and consulted live, so the bytes count
    again once the session moves on, closes or is dropped.
    """

    __slots__ = ("_block", "_mask", "_session")

    def __init__(self, block: tuple, mask: torch.Tensor, session=None):
        self._block = block
        self._mask = mask
        self._session = weakref.ref(session) if session is not None else None

    @property
    def held_nbytes(self) -> int:
        if self._session is not None:
            session = self._session()
            if session is not None and session._standing_gather is self:
                return 0
        return sum(
            piece.numel() * piece.element_size()
            for row in self._block for piece in row
        )

    def __array__(self, dtype=None, copy=None):
        block = unshard_slot_block(self._block, self._mask.device)
        values = block[self._mask].cpu().numpy()
        return values.astype(dtype) if dtype is not None else values


class _BandView:
    """Lazy host view of a per-market device vector: ``np.asarray`` fetches
    it, and a scalar ``[i]`` fetches one element, so
    ``SettlementResult.fence`` stays a one-scalar fetch."""

    __slots__ = ("_vector",)

    def __init__(self, vector: torch.Tensor) -> None:
        self._vector = vector

    def __len__(self) -> int:
        return self._vector.numel()

    def __getitem__(self, index: int):
        return self._vector[index]

    def __array__(self, dtype=None, copy=None):
        values = self._vector.cpu().numpy()
        return values.astype(dtype) if dtype is not None else values


class ShardedSettlementSession:
    """Chained, device-resident settlements of one plan, on one card or a
    ``(markets, sources)`` mesh.

    The slot-major (K, M) block state is built from the store ONCE; every
    settle runs on the retained block (on CUDA one launch of the one-pass
    kernel per markets shard, or of the partials kernel per shard of a
    sources-sharded mesh, in place), so the only per-settle host→device
    traffic is the outcomes vector. The store merge is a registered sync recipe
    (closed-form stamps and existence, plus a lazy gather of the block's
    reliabilities) that any host read resolves; host confidences stay
    exact through the eager replay. The session's touched rows are
    ``band_rows[band_mask]``, slot-major — unlike the flat ``settle``'s
    market-major order.

    Contract: one live session per store for any given set of rows — a
    flat :func:`settle` or direct host write to rows this session covers,
    while it is open, is not seen by the retained block. Use as a context
    manager, or call :meth:`close`.

    *mesh* is a :class:`~.parallel.mesh.Mesh` (``parallel.mesh.make_mesh``)
    that the block is spread over, padded as the JAX session pads it
    (markets up to a multiple of the markets extent, slots up to a
    multiple of the sources extent); ``None`` means the (1, 1) mesh of
    the store's device, one card. Results cover the plan's markets. A
    process ``band`` raises; ``refresh``, ``adopt``, the stream and the
    serving layer are not ported yet.
    """

    def __init__(
        self, store, plan: SettlementPlan, mesh=None, dtype=None, band=None
    ):
        if mesh is None:
            mesh = make_mesh((1, 1), [store.device])
        elif not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh takes a parallel.mesh.Mesh (make_mesh) or None (one "
                f"card); got {type(mesh).__name__}"
            )
        if band is not None:
            raise ValueError(f"band={band!r}: {_NO_PROCESS_BANDS}")
        self._store = store
        self._plan = plan
        self._mesh = mesh
        # Where per-market outputs and graph blocks live: the mesh's first
        # device.
        self._device = mesh.devices[0][0]
        self._cdtype = resolve_dtype(dtype)
        (self._padded_total, self._band_rows, self._band_mask, self._probs_g,
         self._mask_g) = _sharded_plan_cache(plan, mesh, self._cdtype)
        # The padded global mask _BandGather selects the touched slots with.
        self._gather_mask = unshard_slot_block(self._mask_g)
        self._touched = self._band_rows[self._band_mask]
        self._state = None  # built lazily: the epoch depends on the first now
        self._epoch0 = None
        self._loop = None
        # The last settle's registered gather: while the session is live
        # its block is session-pinned (the recipe chain must not count
        # its bytes); close flips it back to counted.
        self._standing_gather = None
        # (key, market keys or None, (neighbor_idx, neighbor_w)) of the
        # last graph aligned to this plan.
        self._graph_cache = None

    # -- state lifecycle -----------------------------------------------------

    def _build_state(self, epoch0: float) -> None:
        store = self._store
        np_dtype = _NUMPY_DTYPE[self._cdtype]
        band_mask = self._band_mask
        safe = np.where(self._band_rows >= 0, self._band_rows, 0)
        # sync=False: the preamble already resolved any deferral touching
        # this session's rows; padding reads row 0 but is masked.
        host_rel, host_conf, host_days, host_exists = store.host_rows(
            safe, sync=False
        )

        fields = (
            np.where(band_mask, host_rel, DEFAULT_RELIABILITY).astype(np_dtype),
            np.where(band_mask, host_conf, DEFAULT_CONFIDENCE).astype(np_dtype),
            np.where(
                band_mask & (host_days > NEVER), host_days - epoch0, 0.0
            ).astype(np_dtype),
            band_mask & host_exists,
        )
        self._state = sharded_block_from_numpy(fields, self._mesh)
        self._epoch0 = epoch0
        if self._loop is None:
            self._loop = build_cycle_loop(self._mesh)

    def _settle_preamble(self, outcomes: Sequence[bool], now: Optional[float]):
        """The shared pre-launch path of every settle entry: plan/outcome
        validation, (re)build of the resident state, exact host
        confidences, and the device outcome vector. Returns ``(now_abs,
        conf_exact, outcome_g)``."""
        store, plan = self._store, self._plan
        _check_plan(store, plan, outcomes)
        now_abs = _now_days() if now is None else now
        if self._state is None or now_abs <= self._epoch0:
            # First settle, or time ran back past the epoch (stamps would
            # go non-positive): (re)build from the host at an epoch below
            # now. Deferred settlements merge first only if one touches
            # this plan's rows.
            if store.pending_overlaps(self._touched):
                store.sync()
            self._build_state(min(store.epoch_origin(sync=False), now_abs - 1.0))
        conf_exact = store.host_confidences(self._touched)
        outcome_g = shard_market_vector(np.pad(
            np.asarray(outcomes, dtype=bool),
            (0, self._padded_total - len(outcomes)), constant_values=False,
        ), self._mesh)
        return now_abs, conf_exact, outcome_g

    def _now0(self, now_abs: float) -> float:
        """The first step's day relative to the epoch, in the state's dtype."""
        return float(_NUMPY_DTYPE[self._cdtype](now_abs - self._epoch0))

    def _settle_commit(
        self, new_state, steps: int, now_abs: float, conf_exact
    ) -> None:
        """The shared post-launch path: retain the new block, register the
        merge recipe, and replay the exact host confidences."""
        self._state = new_state
        np_dtype = _NUMPY_DTYPE[self._cdtype]
        stamp_rel = np_dtype(
            np_dtype(now_abs - self._epoch0) + np_dtype(steps - 1)
        )
        reliability = tuple(
            tuple(shard.reliability for shard in row) for row in new_state
        )
        gather = _BandGather(reliability, self._gather_mask, session=self)
        self._store.defer_settle_recipe(
            self._touched, gather, self._epoch0, stamp_rel,
        )
        self._standing_gather = gather
        _replay_confidences(self._store, self._touched, conf_exact, steps)

    def _band_live(self) -> tuple:
        """(live, keys): in one process the band is every market of the
        plan."""
        return self._plan.num_markets, self._plan.market_keys

    def _per_market(self, vector: torch.Tensor) -> "_BandView":
        """The lazy host view of a per-market output's live markets (a
        mesh pads the markets axis)."""
        return _BandView(vector[: self._plan.num_markets])

    def settle(
        self,
        outcomes: Sequence[bool],
        steps: int = 1,
        now: Optional[float] = None,
    ) -> SettlementResult:
        """Run *steps* cycles on the retained state."""
        now_abs, conf_exact, outcome_g = self._settle_preamble(outcomes, now)
        new_state, consensus = self._loop(
            self._probs_g, self._mask_g, outcome_g, self._state,
            self._now0(now_abs), steps,
        )
        self._settle_commit(new_state, steps, now_abs, conf_exact)
        _live, keys = self._band_live()
        return SettlementResult(
            market_keys=keys, consensus=self._per_market(consensus)
        )

    def settle_with_tiebreak(
        self,
        outcomes: Sequence[bool],
        steps: int = 1,
        now: Optional[float] = None,
        chunk_agents: "int | str | None" = "default",
        precision: int = 6,
    ) -> tuple:
        """Settle AND tie-break the batch in one pass over the resident
        block. Returns ``(SettlementResult, RingTieBreakResult)``; each
        signalling slot enters the tie-break as one agent with its
        probability as the prediction and its decayed read reliability
        at *now* (the pre-update view) as weight and reliability.
        Settlement semantics are exactly :meth:`settle`'s.
        ``chunk_agents="default"`` takes :data:`DEFAULT_CHUNK_AGENTS`."""
        if chunk_agents == "default":
            chunk_agents = DEFAULT_CHUNK_AGENTS
        elif isinstance(chunk_agents, str):
            raise ValueError(
                f"chunk_agents={chunk_agents!r}: the session entry takes an "
                "int, None (unchunked), or 'default' (the recorded "
                "DEFAULT_CHUNK_AGENTS)"
            )
        loop = build_cycle_analytics_loop(
            self._mesh, chunk_agents=chunk_agents, precision=precision,
            with_bands=False,
        )
        now_abs, conf_exact, outcome_g = self._settle_preamble(outcomes, now)
        new_state, consensus, tiebreak, _bands, _prop = loop(
            self._probs_g, self._mask_g, outcome_g, self._state,
            self._now0(now_abs), steps,
        )
        self._settle_commit(new_state, steps, now_abs, conf_exact)
        _live, keys = self._band_live()
        return (
            SettlementResult(market_keys=keys,
                             consensus=self._per_market(consensus)),
            RingTieBreakResult(*(self._per_market(x) for x in tiebreak)),
        )

    def _graph_blocks(self, graph) -> tuple:
        """Device neighbour blocks for *graph* aligned to the plan's market
        rows, cached on the session per (graph, topology).

        Keyed by :meth:`~.analytics.graph.MarketGraph.extended_fingerprint`
        over the plan's topology digest when the plan carries one, else by
        the graph's fingerprint and market-key equality, as in the JAX
        package. The blocks cover the padded markets axis and live on the
        mesh's first device, where the sweep runs.
        """
        plan = self._plan
        total = self._padded_total
        if plan.fingerprint is not None:
            key = (graph.extended_fingerprint(plan.fingerprint), total)
            keys_sig = None
        else:
            key = (graph.fingerprint, total)
            keys_sig = plan.market_keys
        cached = self._graph_cache
        if (
            cached is not None
            and cached[0] == key
            and (keys_sig is None or cached[1] == keys_sig)
        ):
            return cached[2]
        neighbor_idx, neighbor_w = graph.align(plan.market_keys, total)
        blocks = (
            torch.from_numpy(neighbor_idx).to(self._device),
            torch.from_numpy(neighbor_w).to(self._device),
        )
        self._graph_cache = (
            key, list(keys_sig) if keys_sig is not None else None, blocks
        )
        return blocks

    def settle_with_analytics(
        self,
        outcomes: Sequence[bool],
        steps: int = 1,
        now: Optional[float] = None,
        analytics: Optional[AnalyticsOptions] = None,
        kernel: Optional[str] = None,
        sweep_kernel: Optional[str] = None,
    ) -> tuple:
        """Settle AND analyse the batch over the resident block: the N-cycle
        loop, the ring tie-break and the uncertainty bands, all read from
        the same pre-update state at *now*, and, when *analytics* carries a
        graph, the belief sweep over the last step's consensus. Returns
        ``(SettlementResult, RingTieBreakResult | None, UncertaintyBands,
        propagated)``: ``propagated`` is a :class:`PropagatedBeliefs` on
        the moments lane (``inference=InferenceOptions()``), the relaxed
        mean vector on the point lane (a graph with no ``inference``), and
        ``None`` with no graph or a sweep depth of 0.

        Settlement semantics — merge recipe, confidence replay, SQLite
        bytes — and the consensus are exactly :meth:`settle`'s: analytics
        only reads. *analytics* defaults to ``AnalyticsOptions()``;
        ``tiebreak=False`` drops the tie-break (``None`` in its slot);
        ``tiebreak="sorted"`` raises ``NotImplementedError``. ``graph`` is
        an :class:`~.analytics.graph.MarketGraph`; ``blocks`` (an
        :class:`~.infer.blocks.MarketBlocks`) alone become the graph, and
        with or without a graph project the propagated output on the
        host; ``inference`` (an :class:`~.infer.bp.InferenceOptions`)
        needs a graph. *kernel* and *sweep_kernel* (``None`` defers to the
        options) take the JAX package's route names and are validated as
        there; on CUDA every accepted value runs the port's kernels.
        """
        options = analytics if analytics is not None else AnalyticsOptions()

        def resolve(value, recorded, knob):
            if value == "default":
                return recorded
            if isinstance(value, str):
                raise ValueError(
                    f"{knob}={value!r}: the session entry takes an int, "
                    "None (unchunked), or 'default' (the recorded default)"
                )
            return value

        chunk_agents = resolve(
            options.chunk_agents, DEFAULT_CHUNK_AGENTS, "chunk_agents"
        )
        chunk_slots = resolve(
            options.chunk_slots, DEFAULT_CHUNK_SLOTS, "chunk_slots"
        )
        tiebreak_opt = options.tiebreak
        if tiebreak_opt not in (True, False, "sorted"):
            raise ValueError(
                f"tiebreak={tiebreak_opt!r}: True (ring), False (off), "
                "or 'sorted' (the sort-based grouping kernel)"
            )
        graph, inference, blocks = options.graph, options.inference, options.blocks
        if graph is not None and not isinstance(graph, MarketGraph):
            raise TypeError(
                "analytics.graph takes an analytics.MarketGraph; got "
                f"{type(graph).__name__}"
            )
        if blocks is not None:
            if not isinstance(blocks, MarketBlocks):
                raise TypeError(
                    "analytics.blocks takes an infer.MarketBlocks; got "
                    f"{type(blocks).__name__}"
                )
            if graph is None:
                # Blocks alone ARE the graph; a caller composing blocks
                # with correlation edges passes blocks.to_graph(
                # extra_edges=...) as graph= (the projection still applies).
                graph = blocks.to_graph()
        sweep_mode, sweep_tol = "point", None
        sweep_steps = graph.steps if graph is not None else 0
        damping = graph.damping if graph is not None else 0.0
        if inference is not None:
            if not isinstance(inference, InferenceOptions):
                raise TypeError(
                    "analytics.inference takes an infer.InferenceOptions; "
                    f"got {type(inference).__name__}"
                )
            if graph is None:
                raise ValueError(
                    "analytics.inference needs a graph to sweep over — "
                    "set graph= (correlation edges) or blocks= "
                    "(combinatorial constraints)"
                )
            damping, sweep_steps, sweep_tol = inference.resolve(graph)
            sweep_mode = "moments" if inference.moments else "point"
        loop = build_cycle_analytics_loop(
            self._mesh,
            chunk_agents=chunk_agents,
            chunk_slots=chunk_slots,
            precision=options.precision,
            z=options.z,
            damping=damping,
            sweep_steps=sweep_steps,
            sweep_mode=sweep_mode,
            sweep_tol=sweep_tol,
            with_tiebreak=bool(tiebreak_opt),
            tiebreak_kind="sorted" if tiebreak_opt == "sorted" else "ring",
            kernel=kernel if kernel is not None else options.kernel,
            sweep_kernel=(
                sweep_kernel if sweep_kernel is not None
                else options.sweep_kernel
            ),
        )
        now_abs, conf_exact, outcome_g = self._settle_preamble(outcomes, now)
        graph_args = self._graph_blocks(graph) if sweep_steps > 0 else ()
        new_state, consensus, tiebreak, bands, propagated = loop(
            self._probs_g, self._mask_g, outcome_g, self._state,
            self._now0(now_abs), steps, *graph_args,
        )
        self._settle_commit(new_state, steps, now_abs, conf_exact)
        _live, keys = self._band_live()
        if propagated is not None and blocks is not None:
            propagated = self._project_blocks(propagated, blocks, keys)
        if isinstance(propagated, PropagatedBeliefs):
            propagated = propagated._replace(
                mean=self._per_market(propagated.mean),
                stderr=self._per_market(propagated.stderr),
            )
        elif propagated is not None:
            propagated = self._per_market(propagated)
        return (
            SettlementResult(market_keys=keys,
                             consensus=self._per_market(consensus)),
            (
                RingTieBreakResult(*(self._per_market(x) for x in tiebreak))
                if tiebreak is not None else None
            ),
            UncertaintyBands(*(self._per_market(x) for x in bands)),
            propagated,
        )

    def _project_blocks(self, propagated, blocks, keys):
        """The combinatorial blocks' projection of the propagated output,
        on the host (``infer/blocks.py``), over the live rows. Only the
        additive propagated vectors change; the audit pair is kept."""
        is_moments = isinstance(propagated, PropagatedBeliefs)
        live = self._plan.num_markets
        mean = (propagated.mean if is_moments else propagated)[:live]
        stderr = propagated.stderr[:live].cpu().numpy() if is_moments else None
        proj_mean, proj_stderr = blocks.project(keys, mean.cpu().numpy(), stderr)

        def upload(values):
            return torch.from_numpy(values).to(self._device)

        if not is_moments:
            return upload(proj_mean)
        return propagated._replace(
            mean=upload(proj_mean), stderr=upload(proj_stderr)
        )

    def _release_standing(self) -> None:
        """The session is leaving its block: the standing recipe (if any)
        becomes the only thing pinning it, so its bytes count against the
        store's deferral budget again."""
        self._standing_gather = None

    def sync(self) -> None:
        """Merge every deferred settlement into the host store now."""
        self._store.sync()

    def close(self) -> None:
        self.sync()
        self._release_standing()
        self._state = None

    def __enter__(self) -> "ShardedSettlementSession":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()


def settle_sharded(
    store,
    plan: SettlementPlan,
    outcomes: Sequence[bool],
    mesh=None,
    steps: int = 1,
    now: Optional[float] = None,
    dtype=None,
) -> SettlementResult:
    """One-shot session settle: build the resident state, settle once, and
    sync into the store before returning. Chain settlements through a
    :class:`ShardedSettlementSession` to keep the block on the device.
    The stored state equals :func:`settle`'s; the touched rows are merged
    in the session's slot-major order."""
    session = ShardedSettlementSession(store, plan, mesh, dtype=dtype)
    result = session.settle(outcomes, steps=steps, now=now)
    session.close()
    return result
