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

The streamed service settles a sequence of batches:
:class:`PlanPrefetcher` builds plan N+1 on a worker thread while plan N
settles, and :func:`settle_stream` drives each batch through the serve
driver (``serve/driver.py``) — the flat ``settle``, or ONE resident
session that refreshes its probability block on a topology hit and
adopts the next plan (re-laying its block out on the device) on a miss —
with journal epochs or background SQLite checkpoints. The phase spans
(``upload``, ``state_adopt``, ``settle_dispatch``, ``analytics``,
``pack``, ``replay``) and the ``ingest.*``, ``intern.*`` and ``stream.*``
metrics are the JAX package's.
"""

from __future__ import annotations

import collections
import queue
import threading
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
    _object_native_available,
    columns_from_payloads,
    group_columns,
    pack_markets,
    pair_accumulate,
    pair_fingerprint,
    topology_fingerprint,
)
from bayesian_consensus_engine_tpu_torch.analytics.bands import AnalyticsOptions
from bayesian_consensus_engine_tpu_torch.convert import (
    sharded_block_from_numpy,
)
from bayesian_consensus_engine_tpu_torch.analytics.graph import MarketGraph
from bayesian_consensus_engine_tpu_torch.infer.blocks import MarketBlocks
from bayesian_consensus_engine_tpu_torch.infer.bp import InferenceOptions
from bayesian_consensus_engine_tpu_torch.obs.metrics import metrics_registry
from bayesian_consensus_engine_tpu_torch.obs.timeline import (
    PhaseTimeline,
    active_timeline,
)
from bayesian_consensus_engine_tpu_torch.obs.trace import active_tracer
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
from bayesian_consensus_engine_tpu_torch.parallel import distributed
from bayesian_consensus_engine_tpu_torch.parallel.distributed import (
    global_slot_block,
    process_market_rows,
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
    relayout_slot_state,
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
    _count_pack(_object_native_available() if native is None else bool(native))
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
        _count_intern(intern_stats)
        _count_pack(self.used_native)
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


def _count_pack(used_native: bool) -> None:
    """``ingest.native_packs`` / ``ingest.python_packs``: which packer built
    the plan (no-ops unless obs enabled a registry)."""
    name = "ingest.native_packs" if used_native else "ingest.python_packs"
    metrics_registry().counter(name).inc()


def _count_intern(stats: dict) -> None:
    """``intern.delta_pairs`` / ``intern.full_pairs``: how many pairs this
    bind walked through the interner, by route (the delta route's count IS
    the pair delta; matched pairs never reach the interner). No-ops unless
    obs enabled a registry."""
    name = (
        "intern.delta_pairs" if stats["mode"] == "delta"
        else "intern.full_pairs"
    )
    metrics_registry().counter(name).inc(int(stats["interned_pairs"]))


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

    @property
    def vector(self) -> torch.Tensor:
        """The consensus column as a tensor, fetching nothing: the device
        vector until :attr:`consensus` was read, its host copy after."""
        if self._consensus_np is not None:
            return torch.from_numpy(self._consensus_np)
        raw = self._consensus_raw
        return raw.vector if isinstance(raw, _BandView) else torch.as_tensor(raw)

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
    with active_timeline().span("upload"):
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
    # device re-upload and no per-settle absorb. The phase spans (no-ops
    # unless this thread records a timeline) time the host-side call
    # windows only: the launch is not fenced.
    timeline = active_timeline()
    with timeline.span("upload"):
        flat, epoch0 = store.take_device_state(dtype)
    now_abs = _now_days() if now is None else now
    flat, epoch0 = _rebase_epoch(flat, epoch0, now_abs)

    _, slot_rows_d, probs_d, mask_d, offsets_d = _device_plan(
        plan, dtype, store.device
    )
    np_dtype = _NUMPY_DTYPE[dtype]
    now0 = float(np_dtype(now_abs - epoch0))
    with timeline.span("settle_dispatch"):
        outcome_d = torch.as_tensor(
            np.asarray(outcomes, dtype=bool), device=store.device
        )
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

def _pad_plan(array: np.ndarray, widths, fill) -> np.ndarray:
    """*array* padded by *widths* with *fill*; the array itself (the plan's
    read-only copy) when nothing is padded."""
    if not any(after for _before, after in widths):
        return array
    return np.pad(array, widths, constant_values=fill)


def _sharded_plan_cache(plan: SettlementPlan, mesh: Mesh, dtype, band=None):
    """The session's device copies of the plan block for THIS process's
    band, cached on the plan per (mesh, dtype, band): ``(padded_total, lo,
    hi, band_rows, band_mask, probs_g, mask_g)``.

    As in the JAX session, the markets axis is padded up to a multiple of
    the markets extent and the slots axis up to a multiple of the sources
    extent (pad slots: row -1, mask False, probability 0; the state build
    gives them the cold prior). ``[lo, hi)`` is this process's band of the
    padded axis (``process_market_rows``: all of it in one process);
    ``band_rows``/``band_mask`` are its padded host columns and
    ``probs_g``/``mask_g`` grids of this process's per-shard blocks.

    ``band=None``: the plan is GLOBAL (every market on every process) and
    this process's columns are sliced out of it. ``band=(lo,
    global_markets)``: the plan covers ONLY this process's markets (rows
    ``[lo, lo + plan.num_markets)`` of a ``global_markets``-wide axis) —
    the multi-process ingest shape in which no process packs another's
    payloads; it must tile the process's band exactly, and be built with
    the globally agreed ``num_slots``.

    A plan made by :meth:`SettlementPlan.refresh` whose parent holds this
    cache pays only the probability leg: ``band_rows``, ``band_mask`` and
    the device ``mask_g`` are the parent's (identical by construction),
    one new ``probs_g`` is uploaded, and the parent's cache is dropped so
    its stale probabilities are freed.
    """
    key = (mesh, dtype, band)
    cache = getattr(plan, "_sharded_cache", None)
    if cache is None or cache[0] != key:
        num_markets_global = plan.num_markets if band is None else band[1]
        markets_extent = mesh.shape[MARKETS_AXIS]
        sources_extent = mesh.shape[SOURCES_AXIS]
        padded_total = (
            -(-max(num_markets_global, 1) // markets_extent) * markets_extent
        )
        num_slots = plan.num_slots
        pad_k = (
            -(-max(num_slots, 1) // sources_extent) * sources_extent - num_slots
        )
        lo, hi = process_market_rows(padded_total, mesh)
        if band is None:
            # A global plan: pad its columns to the whole axis, then take
            # this process's band of them.
            col_pad = padded_total - plan.num_markets
            cols = None if (lo, hi) == (0, padded_total) else slice(lo, hi)
        else:
            live = max(0, min(hi, num_markets_global) - lo)
            if band[0] != lo or plan.num_markets != live:
                raise ValueError(
                    f"band plan covers rows [{band[0]}, "
                    f"{band[0] + plan.num_markets}) but this process owns "
                    f"[{lo}, {min(hi, num_markets_global)}) of the "
                    f"{num_markets_global}-market axis"
                )
            # A band plan: its columns ARE the band, padded to its width.
            col_pad = (hi - lo) - plan.num_markets
            cols = None
        widths = ((0, pad_k), (0, col_pad))

        def pad_cols(array, fill):
            padded = _pad_plan(array, widths, fill)
            return padded if cols is None else padded[:, cols]

        parent = getattr(plan, "_refreshed_from", None)
        donor = (
            getattr(parent, "_sharded_cache", None)
            if parent is not None else None
        )
        if donor is not None and donor[0] == key:
            band_rows, band_mask, mask_g = donor[4], donor[5], donor[7]
            object.__setattr__(parent, "_sharded_cache", None)
        else:
            band_rows = pad_cols(plan.slot_rows, -1)
            band_mask = pad_cols(plan.mask, False)
            mask_g = global_slot_block(band_mask, mesh, padded_total)
        band_probs = pad_cols(plan.probs, 0.0)
        cache = (
            key,
            padded_total,
            lo,
            hi,
            band_rows,
            band_mask,
            global_slot_block(band_probs, mesh, padded_total, dtype=dtype),
            mask_g,
        )
        object.__setattr__(plan, "_sharded_cache", cache)
        if parent is not None:
            # Served its purpose; dropping it keeps a long reuse chain from
            # pinning every predecessor plan in memory.
            object.__setattr__(plan, "_refreshed_from", None)
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
    """Lazy host view of a per-market device vector — this process's live
    band rows: ``np.asarray`` fetches it, and a scalar ``[i]`` fetches one
    element, so ``SettlementResult.fence`` stays a one-scalar fetch."""

    __slots__ = ("_vector",)

    def __init__(self, vector: torch.Tensor) -> None:
        self._vector = vector

    def __len__(self) -> int:
        return self._vector.numel()

    @property
    def vector(self) -> torch.Tensor:
        """The device vector itself, fetching nothing."""
        return self._vector

    def __getitem__(self, index: int):
        return self._vector[index]

    def __array__(self, dtype=None, copy=None):
        values = self._vector.cpu().numpy()
        return values.astype(dtype) if dtype is not None else values


def _process_count() -> int:
    """The runtime's process count, as a patchable indirection.

    ``settle_with_analytics`` refuses a multi-process runtime on it, and
    tests force that posture in one process by patching this function.
    ``torch.distributed``'s world size when a group is initialised, else 1.
    """
    return distributed.process_count()


class ShardedSettlementSession:
    """Chained, device-resident settlements of one plan — or, through
    :meth:`refresh` and :meth:`adopt`, a long-lived succession of plans —
    on one card or a ``(markets, sources)`` mesh.

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

    *mesh* is a :class:`~.parallel.mesh.Mesh` (``parallel.mesh.make_mesh``,
    or ``parallel.distributed.make_hybrid_mesh`` across processes) that
    the block is spread over, padded as the JAX session pads it (markets
    up to a multiple of the markets extent, slots up to a multiple of the
    sources extent); ``None`` means the (1, 1) mesh of the store's device,
    one card. On a mesh of several processes the session holds and runs
    only this process's rows of the grid: its band of the markets axis.
    With ``band=None`` the plan and outcomes are indexed globally on every
    process; with ``band=(lo, global_markets)`` they cover ONLY this
    process's markets (the multi-process ingest shape: each process packs
    its own payloads, with a globally agreed ``num_slots``). Results cover
    this process's band either way. :meth:`refresh` swaps in a
    probability-only twin of the plan (only the probability block is
    uploaded); :meth:`adopt` swaps in any plan bound to the same store and
    carries the resident block across — the two moves
    :func:`settle_stream` and :class:`~.serve.driver.SessionDriver` make
    every batch.
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
        self._store = store
        self._mesh = mesh
        # This process's rows of the grid: the whole of a local mesh.
        self._local_mesh = mesh.local(distributed.process_index())
        # Where per-market outputs and graph blocks live: the first device
        # of this process's rows.
        self._device = self._local_mesh.devices[0][0]
        self._cdtype = resolve_dtype(dtype)
        self._bind_plan(plan, band)
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

    def _bind_plan(self, plan: SettlementPlan, band) -> None:
        """Take *plan*'s padded block and device copies (an ``upload``
        phase), its touched rows and *band*. A plan that does not fit
        *band* raises before anything of the session changes."""
        with active_timeline().span("upload"):
            (self._padded_total, self._lo, self._hi, self._band_rows,
             self._band_mask, self._probs_g, self._mask_g) = _sharded_plan_cache(
                plan, self._mesh, self._cdtype, band
            )
            self._band = band
            # The padded global mask _BandGather selects touched slots with.
            self._gather_mask = unshard_slot_block(self._mask_g)
        self._plan = plan
        self._touched = self._band_rows[self._band_mask]

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
        self._state = sharded_block_from_numpy(fields, self._local_mesh)
        self._epoch0 = epoch0
        if self._loop is None:
            self._loop = build_cycle_loop(self._local_mesh)

    def _settle_preamble(self, outcomes: Sequence[bool], now: Optional[float]):
        """The shared pre-launch path of every settle entry: plan/outcome
        validation, (re)build of the resident state (an ``upload`` phase),
        exact host confidences, and this process's band of outcome
        columns, padded to the band's width. Returns ``(now_abs,
        conf_exact, outcome_band)``."""
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
            with active_timeline().span("upload"):
                self._build_state(
                    min(store.epoch_origin(sync=False), now_abs - 1.0)
                )
        conf_exact = store.host_confidences(self._touched)
        outcome_arr = np.asarray(outcomes, dtype=bool)
        if self._band is None:
            # Global outcomes: pad to the whole axis, take this band.
            outcome_band = np.pad(
                outcome_arr, (0, self._padded_total - len(outcome_arr)),
                constant_values=False,
            )[self._lo:self._hi]
        else:
            # Band-local outcomes: pad to the band's width.
            outcome_band = np.pad(
                outcome_arr, (0, self._hi - self._lo - len(outcome_arr)),
                constant_values=False,
            )
        return now_abs, conf_exact, outcome_band

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

    def _live(self) -> int:
        """How many of this process's band rows are live markets of the
        current plan. A band can lie wholly in padding (more band capacity
        than markets), so this may be 0."""
        if self._band is not None:
            return self._plan.num_markets  # the plan IS the band
        return max(0, min(self._hi, self._plan.num_markets) - self._lo)

    def _band_live(self) -> tuple:
        """(live, keys) of this process's band of the current plan."""
        live = self._live()
        keys = self._plan.market_keys
        if self._band is None and (self._lo, live) != (0, len(keys)):
            keys = keys[self._lo:self._lo + live]
        return live, keys

    def _per_market(self, vector: torch.Tensor) -> "_BandView":
        """The lazy host view of a per-market output's live band rows (a
        mesh pads the markets axis)."""
        return _BandView(vector[: self._live()])

    def settle(
        self,
        outcomes: Sequence[bool],
        steps: int = 1,
        now: Optional[float] = None,
    ) -> SettlementResult:
        """Run *steps* cycles on the retained state."""
        now_abs, conf_exact, outcome = self._settle_preamble(outcomes, now)
        with active_timeline().span("settle_dispatch"):
            new_state, consensus = self._loop(
                self._probs_g, self._mask_g,
                shard_market_vector(outcome, self._local_mesh), self._state,
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
            self._local_mesh, chunk_agents=chunk_agents, precision=precision,
            with_bands=False,
        )
        now_abs, conf_exact, outcome = self._settle_preamble(outcomes, now)
        with active_timeline().span("settle_dispatch"):
            new_state, consensus, tiebreak, _bands, _prop = loop(
                self._probs_g, self._mask_g,
                shard_market_vector(outcome, self._local_mesh), self._state,
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
        ``tiebreak="sorted"`` runs the sort-based grouping
        (``ops/tiebreak.py::batched_tiebreak``: NaN/0 on an empty row)
        over the partials kernel's read views, on a mesh with one sources
        shard (a sources-sharded mesh refuses it). ``graph`` is
        an :class:`~.analytics.graph.MarketGraph`; ``blocks`` (an
        :class:`~.infer.blocks.MarketBlocks`) alone become the graph, and
        with or without a graph project the propagated output on the
        host; ``inference`` (an :class:`~.infer.bp.InferenceOptions`)
        needs a graph. *kernel* and *sweep_kernel* (``None`` defers to the
        options) take the JAX package's route names and are validated as
        there; on CUDA every accepted value runs the port's kernels.
        """
        options = analytics if analytics is not None else AnalyticsOptions()
        if _process_count() > 1:
            # Bands and the tie-break are per-market reductions and would
            # serve a band unchanged, but the graph sweep reads every
            # market: named here rather than failing deep in alignment.
            from bayesian_consensus_engine_tpu_torch.cluster.recover import (
                ClusterModeUnsupported,
            )

            raise ClusterModeUnsupported(
                "settle_with_analytics on a multi-process runtime is not "
                "served: route cluster deployments through the "
                "shared-nothing band membership (cluster.membership."
                "MeshView — each host serves its band on its local mesh, "
                "where the full analytics tier runs unchanged)"
            )

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
        loop_options = dict(
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
        now_abs, conf_exact, outcome = self._settle_preamble(outcomes, now)
        timeline = active_timeline()
        with timeline.span("analytics"):
            # The analytics tier's own overhead only (graph alignment and
            # upload, the loop's build); the launch stays on
            # settle_dispatch, as in the JAX session.
            graph_args = self._graph_blocks(graph) if sweep_steps > 0 else ()
            loop = build_cycle_analytics_loop(self._local_mesh, **loop_options)
        with timeline.span("settle_dispatch"):
            new_state, consensus, tiebreak, bands, propagated = loop(
                self._probs_g, self._mask_g,
                shard_market_vector(outcome, self._local_mesh), self._state,
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

    def refresh(self, plan: SettlementPlan) -> None:
        """Adopt a probability-only twin of the session's plan in place.

        *plan* must come from :meth:`SettlementPlan.refresh` on this
        session's current plan (same topology: the slot layout, row
        mapping and mask are shared array objects). Only the new
        probability block is uploaded; ``mask_g`` and the resident block
        state stay on the device, and the old probability block is freed.
        The steady daily re-settlement of a long-lived session: refresh
        with the day's probabilities, then :meth:`settle` with the day's
        outcomes.
        """
        if plan is self._plan:
            return
        if (
            plan.slot_rows is not self._plan.slot_rows
            or plan.mask is not self._plan.mask
        ):
            raise ValueError(
                "session refresh needs a probability-only twin of the "
                "current plan (SettlementPlan.refresh on the same "
                "topology); this plan has its own slot layout"
            )
        self._bind_plan(plan, self._band)

    def _release_standing(self) -> None:
        """The session is leaving its block: the standing recipe (if any)
        becomes the only thing pinning it, so its bytes count against the
        store's deferral budget again (``held_nbytes`` checks
        ``_standing_gather is self`` through a weak reference, so clearing
        the attribute, or the session dying, is the release)."""
        self._standing_gather = None

    def adopt(self, plan: SettlementPlan, band=None) -> str:
        """Swap the session onto a new-topology *plan* without teardown.

        The topology-miss half of the resident streamed service: where
        :meth:`refresh` takes the probability-only twin, ``adopt`` takes
        any plan bound to the same store and carries the resident block
        across the swap. Returns how the swap was served:

        * ``"refresh"`` — *plan* shares the current plan's topology arrays
          (the fingerprint hit): probability upload only.
        * ``"relayout"`` — the resident block was carried across: rows
          staying in the active set move with it, rows entering upload
          their host values (fresh pairs enter as cold defaults), and rows
          leaving stay covered by the standing sync recipe and reach the
          host store at the next checkpoint or sync, as any deferred
          gather does. The block is re-laid out on this process's rows of
          the mesh (:func:`~.parallel.sharded.relayout_slot_state`: no host
          traffic for staying rows, nothing collective): band drift is a
          process-local event, and the positions are band-local, so one
          route serves one process and each process of a group alike.
          Growth of the padded extents re-pads the block. The result is
          bit-equal to tearing the session down and rebuilding.
        * ``"rebuild:<reason>"`` — the resident state was dropped and the
          next :meth:`settle` rebuilds from the host: ``no-resident-state``
          (nothing to carry yet), ``band-change`` (the global axis was
          re-partitioned, a membership-epoch event: state crossing bands
          travels through journal replay, ``cluster/recover.py``) or
          ``backdated-stamps`` (an entering row's host stamp has no
          positive expression against the session epoch).
        """
        if band == self._band:
            # The hit shortcut holds within the same band only: a band
            # change under a shared topology still re-slices rows.
            if plan is self._plan:
                return "refresh"
            if (
                plan.slot_rows is self._plan.slot_rows
                and plan.mask is self._plan.mask
            ):
                self.refresh(plan)
                return "refresh"
        # A topology miss: the swap (row-set delta, host reads of entering
        # rows, relayout) is the state_adopt phase; the plan upload inside
        # stays on upload (exclusive nesting).
        with active_timeline().span("state_adopt"):
            return self._adopt_miss(plan, band)

    def _adopt_miss(self, plan: SettlementPlan, band) -> str:
        store = self._store
        old_state = self._state
        old_band_rows, old_band_mask = self._band_rows, self._band_mask
        band_changed = band != self._band
        self._bind_plan(plan, band)
        # Mid-swap from here: drop the resident binding FIRST, so that an
        # exception below (a sync failure, a device error in the relayout)
        # leaves a clean rebuild posture — never the old layout's block
        # bound to the new plan, which a retrying caller would settle
        # against the wrong rows. The old block stays reachable through
        # the standing recipe and the local reference.
        self._release_standing()
        self._state = None
        if old_state is None:
            return "rebuild:no-resident-state"
        if band_changed:
            return "rebuild:band-change"

        # The row-set delta between the outgoing and incoming layouts, as
        # flat band-local slot-major positions (each plan maps a row to one
        # slot; a whole-axis band's local positions are global).
        old_pos = np.flatnonzero(old_band_mask.ravel())
        old_rows = old_band_rows.ravel()[old_pos]
        new_pos = np.flatnonzero(self._band_mask.ravel())
        new_rows = self._band_rows.ravel()[new_pos]
        if old_rows.size:
            order = np.argsort(old_rows, kind="stable")
            sorted_rows = old_rows[order]
            sorted_pos = old_pos[order]
            idx = np.minimum(
                np.searchsorted(sorted_rows, new_rows), old_rows.size - 1
            )
            staying = sorted_rows[idx] == new_rows
        else:
            sorted_pos = old_pos
            idx = np.zeros(new_rows.size, dtype=np.int64)
            staying = np.zeros(new_rows.size, dtype=bool)
        entering_rows = new_rows[~staying]
        entering_pos = new_pos[~staying]

        # Entering rows may sit behind an older deferred recipe (a previous
        # adopt's leaving rows re-entering): resolve it before reading
        # their host values. The standing recipe covers only the outgoing
        # set, disjoint from the entering rows, so steady drift never
        # syncs here.
        if entering_rows.size and store.pending_overlaps(entering_rows):
            store.sync()
        host_rel, host_conf, host_days, host_exists = store.host_rows(
            entering_rows, sync=False
        )
        live = host_days > NEVER
        rel_days = np.where(live, host_days - self._epoch0, 0.0)
        if bool((live & (rel_days <= 0)).any()):
            # A host stamp at or below the session epoch has no positive
            # relative expression: the next settle rebuilds at a new epoch.
            return "rebuild:backdated-stamps"

        # Cast exactly as _build_state casts, so the relaid block is
        # bit-equal to a rebuild.
        np_dtype = _NUMPY_DTYPE[self._cdtype]
        entering = (host_rel.astype(np_dtype), host_conf.astype(np_dtype),
                    rel_days.astype(np_dtype), host_exists.astype(bool))
        src = np.full(self._band_mask.size, -1, dtype=np.int64)
        src[new_pos[staying]] = sorted_pos[idx[staying]]
        self._state = relayout_slot_state(
            old_state, src, entering_pos, *entering,
            self._band_mask.shape, self._local_mesh,
        )
        return "relayout"

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


# -- the streamed service ------------------------------------------------------


class PlanPrefetcher:
    """Build settlement plans one batch ahead on a worker thread.

    Ingest (pack → intern → block fill) is host CPU work, while the settle
    it feeds is device work the host only launches; settled serially, a
    stream of batches leaves the card idle during every ingest and the
    host idle during every settle. This iterator overlaps them: ONE worker
    thread builds plan N+1 (and, with ``depth`` > 1, N+1+k) while the
    caller settles plan N.

        with PlanPrefetcher(store, batches, num_slots=K) as plans:
            for plan, outcomes in zip(plans, outcome_batches):
                settle(store, plan, outcomes, steps=steps)

    Builds run in batch order on the single worker, so interning order —
    and therefore row assignment, block content and results — equals the
    serial loop's. The store's host tier is thread-safe (its lock), which
    makes the worker's interning safe against the caller's settle-side
    host reads.

    ``columnar=False``: *batches* yields dict payloads
    (:func:`build_settlement_plan`). ``columnar=True``: *batches* yields
    ``(market_keys, source_ids, probabilities, offsets)`` tuples
    (:func:`build_settlement_plan_columnar`). A build error (or an error
    of the batch iterator itself) surfaces on the ``next()`` that would
    have yielded that plan; later batches are not attempted.

    ``reuse_plans=True`` fingerprints each batch's topology
    (:func:`~.core.batch.topology_fingerprint`) and, when it matches the
    previous batch's, refreshes the previous plan with the new
    probabilities (:meth:`SettlementPlan.refresh`) instead of rebuilding —
    no pack, intern or block fill. Dict payloads are flattened once to
    columns (:func:`~.core.batch.columns_from_payloads`) and built through
    the columnar path, bit-identical to the dict path. ``intern_mode``
    (``"auto"`` default) routes every columnar build's interning through
    the store's epoch pair table; ``"full"`` walks every pair. Each build's
    seconds feed the ``stream.plan_build_s`` histogram.
    """

    def __init__(
        self,
        store,
        batches,
        columnar: bool = False,
        num_slots: "int | str | None" = None,
        native: Optional[bool] = None,
        depth: int = 1,
        reuse_plans: bool = False,
        intern_mode: str = "auto",
    ) -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._cancelled = threading.Event()
        self._sentinel = object()
        last_plan: "list[Optional[SettlementPlan]]" = [None]

        def build(batch):
            if not reuse_plans:
                if columnar:
                    keys, source_ids, probabilities, offsets = batch
                    return build_settlement_plan_columnar(
                        store, keys, source_ids, probabilities, offsets,
                        num_slots=num_slots, native=native,
                        intern_mode=intern_mode,
                    )
                return build_settlement_plan(
                    store, batch, native=native, num_slots=num_slots
                )
            if columnar:
                keys, source_ids, probabilities, offsets = batch
                probabilities = np.ascontiguousarray(
                    probabilities, dtype=np.float64
                )
            else:
                # Dict payloads flatten to columns here, on the worker, so
                # the consumer thread never walks the signals.
                keys, source_ids, probabilities, offsets = (
                    columns_from_payloads(batch, native=native)
                )
            digest = topology_fingerprint(keys, source_ids, offsets)
            prev = last_plan[0]
            if prev is not None and prev.fingerprint == digest:
                plan = prev.refresh(probabilities)
            else:
                plan = build_settlement_plan_columnar(
                    store, keys, source_ids, probabilities, offsets,
                    num_slots=num_slots, fingerprint=digest, native=native,
                    intern_mode=intern_mode,
                )
            last_plan[0] = plan
            return plan

        # Build times feed the registry, not the timeline: the worker
        # overlaps the consumer's wall clock, so its seconds must not enter
        # the additive phase breakdown (the consumer's share is
        # settle_stream's "pack" wait span).
        build_hist = metrics_registry().histogram("stream.plan_build_s")

        def work():
            try:
                iterator = iter(batches)
                while not self._cancelled.is_set():
                    try:
                        batch = next(iterator)
                    except StopIteration:
                        break
                    build_start = time.perf_counter()
                    plan = build(batch)
                    build_hist.observe(time.perf_counter() - build_start)
                    self._put(("ok", plan))
            except BaseException as exc:  # noqa: BLE001 — re-raised on next()
                self._put(("err", exc))
            finally:
                self._put((self._sentinel, None))

        self._worker = threading.Thread(
            target=work, name="bce-plan-prefetch", daemon=True
        )
        self._worker.start()

    def _put(self, item) -> None:
        # A bounded put would deadlock against a consumer that stopped
        # consuming (close() mid-stream): poll with the cancel flag.
        while True:
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                if self._cancelled.is_set():
                    return

    def __iter__(self) -> "PlanPrefetcher":
        return self

    def __next__(self) -> SettlementPlan:
        kind, value = self._queue.get()
        if kind is self._sentinel:
            self._queue.put((self._sentinel, None))  # stay terminated
            raise StopIteration
        if kind == "err":
            raise value
        return value

    def close(self) -> None:
        """Stop building; pending batches are dropped, the worker joined."""
        self._cancelled.set()
        while True:  # drain so a blocked worker put() can finish
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item[0] is self._sentinel:
                break
        self._worker.join(timeout=60)

    def __enter__(self) -> "PlanPrefetcher":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()


def settle_stream(
    store,
    batches,
    steps: int = 1,
    now: Optional[float] = None,
    db_path=None,
    checkpoint_every: int = 1,
    num_slots: "int | str | None" = "bucket",
    columnar: bool = False,
    native: Optional[bool] = None,
    stats: Optional[list] = None,
    mesh=None,
    band=None,
    dtype=None,
    lazy_checkpoints: bool = False,
    journal=None,
    reuse_plans: bool = False,
    sync_checkpoints: bool = False,
    resident_session: bool = True,
    intern_mode: str = "auto",
    trace=None,
):
    """The streamed settle-and-checkpoint service loop, overlapped.

    One generator wires the service together:

    * plan N+1 builds on a prefetch thread while plan N settles
      (:class:`PlanPrefetcher`; ``num_slots`` defaults to ``"bucket"``);
    * settles chain device-resident (deferred absorb);
    * every *checkpoint_every* batches the store checkpoints — a journal
      epoch with *journal*, else a SQLite flush to *db_path* written on a
      background thread — and a tail flush on exit makes the final file
      complete. A failed background write surfaces at the next flush; the
      final join re-raises a last-write failure.

    *batches* yields ``(payloads, outcomes)`` pairs — with
    ``columnar=True``, ``((market_keys, source_ids, probabilities,
    offsets), outcomes)``. ``now=None`` stamps the wall clock per settle;
    a float is the first batch's settlement day, advancing one day a
    batch. Yields one :class:`SettlementResult` per batch, in order.
    Results, store state and checkpoint files equal the serial build →
    settle → flush loop.

    *reuse_plans* refreshes the previous plan on a topology-fingerprint
    hit (probabilities only: no pack, intern or block fill, and on the
    mesh path only the probability block is uploaded); a miss rebuilds.
    Bit-exact with ``reuse_plans=False``.

    *stats*, if given, is a list the service appends one dict per batch
    to: ``{"batch", "markets", "plan_wait_s", "settle_dispatch_s",
    "checkpoint_s", "plan_reused", "session_adopt", "intern_s",
    "interned_pairs"}``. ``plan_wait_s`` is how long the consumer waited
    on the prefetch thread; ``settle_dispatch_s`` is the host cost of
    launching the settle (not fenced: device time is not in it, and
    device backpressure shows in ``checkpoint_s``, whose flush drains the
    pending results — ``None`` on batches that did not checkpoint). The
    dict of a batch is appended BEFORE its checkpoint and its yield, so
    ``len(stats)`` is the settled count even when a checkpoint raises:
    resume with ``batches[len(stats):]``. ``session_adopt`` is how the
    resident session served the batch under ``mesh=`` (``"start"``,
    ``"refresh"``, ``"relayout"`` or ``"rebuild:<reason>"``, see
    :meth:`ShardedSettlementSession.adopt`), ``None`` on the flat path
    and with *resident_session* off.

    When this thread records a phase timeline
    (:func:`~.obs.timeline.recording`), each stats dict also carries
    ``"phases"``: the batch's additive breakdown into the canonical
    :data:`~.obs.timeline.PHASES` names (exclusive seconds). The stream
    feeds the metrics registry (``stream.batches``,
    ``stream.plan_reuse_hits``/``misses``, ``stream.settle_dispatch_s``,
    ``stream.plan_build_s``, the ``stream.ingest_wait_s`` and
    ``stream.intern_wait_s`` gauges, and the driver's resident-session
    counters and ``hbm.*`` gauges) — no-ops unless
    :func:`~.obs.metrics.set_metrics_registry` enabled one. With a tracer
    (:func:`~.obs.trace.set_tracer`) each batch records a span chain keyed
    by its index. Observability on or off moves no settlement byte.

    *mesh*, if given, settles every batch through ONE long-lived
    :class:`ShardedSettlementSession` on that mesh: a topology hit
    refreshes the probability block, a miss adopts the new plan with the
    block re-laid out on the device (rows entering upload their host
    values, rows leaving reach the host through the standing recipe).
    ``resident_session=False`` builds one session per batch instead.
    Results, store state and checkpoint files equal the flat stream's;
    a sources-sharded mesh re-associates each market's slot sum (within
    an ulp on the consensus). *dtype* is the compute dtype.

    *band*: ``(lo, global_markets)`` marks each batch's plan as covering
    ONLY this process's markets — rows ``[lo, lo + M_plan)`` of a
    ``global_markets``-wide axis — or a callable ``band(batch_index) ->
    (lo, global_markets)`` when the global width moves per batch. Band
    mode needs ``mesh=`` and a globally agreed integer *num_slots*
    (``"bucket"`` pads per-process maxima, which processes disagree on).
    A band change mid-stream starts a new session (one
    ``stream.resident_fallbacks``).

    *lazy_checkpoints* makes the periodic SQLite flushes snapshot the
    applied host state without resolving deferred device results, so they
    never wait on the device; the tail flush resolves, so the final file
    is the eager mode's. It cannot combine with a journal.

    *journal*, a :class:`~.state.journal.JournalWriter` (or a path, which
    opens one), appends a journal epoch (tag = the settled batch index)
    every *checkpoint_every* batches instead of a SQLite flush; SQLite is
    written once by the tail flush when *db_path* is also given. Recovery:
    :func:`~.state.journal.replay_journal` rebuilds the store through the
    last complete epoch and returns its tag — resume from
    ``batches[tag + 1:]`` with ``journal=JournalWriter(path,
    resume=True)``. Epochs are written on a background thread that the
    next epoch joins (*sync_checkpoints* = False: at a yield, epoch N-1 is
    fsynced and epoch N in flight); ``sync_checkpoints=True`` writes and
    fsyncs each epoch in the loop. Every exit joins the in-flight epoch.

    *trace*, a :class:`~.state.journal.TraceWriter` (or a path), records
    each batch's inputs — the columnar columns, outcomes, the resolved
    settlement day and ``steps`` — for :func:`~.serve.driver.drive_trace`.
    It needs ``columnar=True``. With ``now=None`` the wall-clock day is
    resolved once per batch and drives both the settle and the frame.
    """
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    if band is not None and mesh is None:
        raise ValueError("band= requires mesh=")
    if journal is not None and lazy_checkpoints:
        raise ValueError(
            "journal= epochs are drained truth by contract; "
            "lazy_checkpoints cannot combine with a journal"
        )
    if band is not None and (
        isinstance(num_slots, bool)
        or not isinstance(num_slots, (int, np.integer))
    ):
        raise ValueError(
            "band mode needs a globally-agreed integer num_slots; "
            f"{num_slots!r} derives K from per-process maxima, which "
            "processes disagree on"
        )
    # Opened only after every validation above: a journal path is never
    # touched by a call that then refuses to run.
    from bayesian_consensus_engine_tpu_torch.state.journal import (
        JournalWriter,
        TraceWriter,
    )

    owns_journal = False
    if journal is not None and not hasattr(journal, "append_epoch"):
        journal = JournalWriter(journal)
        owns_journal = True
    if trace is not None and not columnar:
        raise ValueError(
            "trace= records the columnar payload columns verbatim; "
            "pass columnar=True (the replay workload format)"
        )
    owns_trace = False
    if trace is not None and not hasattr(trace, "append_batch"):
        trace = TraceWriter(trace)
        owns_trace = True
    # The loop body — session lifecycle, checkpoint cadence, exit contract
    # — is the serve driver's; imported here because serve imports this
    # module.
    from bayesian_consensus_engine_tpu_torch.serve.driver import SessionDriver

    outcome_queue: collections.deque = collections.deque()
    trace_queue: collections.deque = collections.deque()

    def payload_stream():
        for payloads, outcomes in batches:
            outcome_queue.append(outcomes)
            if trace is not None:
                trace_queue.append(payloads)
            yield payloads

    timeline = active_timeline()
    registry = metrics_registry()
    tracer = active_tracer()
    batches_counter = registry.counter("stream.batches")
    reuse_hit_counter = registry.counter("stream.plan_reuse_hits")
    reuse_miss_counter = registry.counter("stream.plan_reuse_misses")
    dispatch_hist = registry.histogram("stream.settle_dispatch_s")
    # Cumulative consumer seconds blocked on the prefetch thread, and
    # cumulative seconds the builds spent interning.
    ingest_wait_gauge = registry.gauge("stream.ingest_wait_s")
    total_plan_wait = 0.0
    intern_wait_gauge = registry.gauge("stream.intern_wait_s")
    total_intern_wait = 0.0

    driver = SessionDriver(
        store,
        steps=steps,
        mesh=mesh,
        dtype=dtype,
        resident_session=resident_session,
        journal=journal,
        owns_journal=owns_journal,
        db_path=db_path,
        checkpoint_every=checkpoint_every,
        sync_checkpoints=sync_checkpoints,
        lazy_checkpoints=lazy_checkpoints,
    )
    index = -1
    try:
        with PlanPrefetcher(
            store,
            payload_stream(),
            columnar=columnar,
            num_slots=num_slots,
            native=native,
            reuse_plans=reuse_plans,
            intern_mode=intern_mode,
        ) as plans:
            plan_iter = iter(plans)
            while True:
                phase_mark = timeline.totals() if timeline.enabled else None
                wait_start = time.perf_counter()
                try:
                    with timeline.span("pack"):
                        plan = next(plan_iter)
                except StopIteration:
                    break
                plan_wait_s = time.perf_counter() - wait_start
                total_plan_wait += plan_wait_s
                ingest_wait_gauge.set(total_plan_wait)
                intern_stats = getattr(plan, "intern_stats", None)
                intern_s = intern_stats["intern_s"] if intern_stats else 0.0
                total_intern_wait += intern_s
                intern_wait_gauge.set(total_intern_wait)
                index += 1
                outcomes = outcome_queue.popleft()
                batch_now = None if now is None else now + index
                if trace is not None:
                    # The frame and the settle stamp the SAME day.
                    if batch_now is None:
                        batch_now = _now_days()
                    t_keys, t_sids, t_probs, t_offsets = trace_queue.popleft()
                    with timeline.span("replay"):
                        trace.append_batch(
                            t_keys, t_sids, t_probs, t_offsets, outcomes,
                            now_days=float(batch_now), steps=steps,
                        )
                # Read BEFORE the settle: the delta upload drops the
                # refresh back-reference.
                plan_reused = (
                    getattr(plan, "_refreshed_from", None) is not None
                )
                batch_band = band(index) if callable(band) else band
                # Phase spans taken inside land on batch `index`'s trace
                # chain; closed before the yield.
                with tracer.batch(index):
                    if tracer.enabled:
                        tracer.batch_event(
                            index, "pack", dur_s=plan_wait_s,
                            args={"markets": plan.num_markets,
                                  "plan_reused": plan_reused},
                        )
                    settle_start = time.perf_counter()
                    result = driver.dispatch(
                        plan, outcomes, now=batch_now, band=batch_band
                    )
                    session_adopt = driver.last_adopt
                    settle_dispatch_s = time.perf_counter() - settle_start
                    batches_counter.inc()
                    (reuse_hit_counter if plan_reused
                     else reuse_miss_counter).inc()
                    dispatch_hist.observe(settle_dispatch_s)
                    # Appended BEFORE the checkpoint: len(stats) is the
                    # settled count even when the checkpoint raises.
                    if stats is not None:
                        stats.append(
                            {
                                "batch": index,
                                "markets": plan.num_markets,
                                "plan_wait_s": plan_wait_s,
                                "settle_dispatch_s": settle_dispatch_s,
                                "checkpoint_s": None,
                                "plan_reused": plan_reused,
                                "session_adopt": session_adopt,
                                "intern_s": intern_s,
                                "interned_pairs": (
                                    intern_stats["interned_pairs"]
                                    if intern_stats else 0
                                ),
                            }
                        )
                    checkpoint_s = driver.checkpoint(index)
                if checkpoint_s is not None and stats is not None:
                    stats[-1]["checkpoint_s"] = checkpoint_s
                if phase_mark is not None and stats is not None:
                    stats[-1]["phases"] = PhaseTimeline.delta(
                        phase_mark, timeline.totals()
                    )
                yield result
    finally:
        # Every exit — exhaustion, a consumer break or close, a batch
        # error — runs the driver's exit contract (join the in-flight
        # write, a tail epoch or flush covering every settled batch,
        # skipped after a failed journal write), then closes an owned
        # trace.
        try:
            driver.finalize()
        finally:
            if owns_trace:
                trace.close()
