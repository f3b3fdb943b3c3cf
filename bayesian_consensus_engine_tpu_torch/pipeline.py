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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.core.batch import (
    SourceCodes,
    _intern_source_codes,
    group_columns,
    pack_markets,
    pair_accumulate,
    topology_fingerprint,
)
from bayesian_consensus_engine_tpu_torch.ops.settle_kernel import (
    settle_cycles,
    touched_layout,
)
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    DeviceReliabilityState,
)
from bayesian_consensus_engine_tpu_torch.utils.config import CONFIDENCE_GROWTH_RATE
from bayesian_consensus_engine_tpu_torch.utils.device import resolve_dtype
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
    num_slots: "int | str | None" = None,
    fingerprint: "bool | bytes" = False,
) -> SettlementPlan:
    """Pack, intern, and lay out payloads as a dense settlement block.

    Duplicate signals from one source collapse to their mean (in scalar
    accumulation order), one interning pass maps every (source, market)
    pair to its flat store row, and the ragged per-market pair lists
    become a dense slot-major block. Market ids must be unique within one
    plan.

    ``num_slots`` pins the block's slot height K (error if the data needs
    more); ``"bucket"`` pads the natural K to the next multiple of 8.
    ``fingerprint=True`` stamps the plan with its topology digest; a
    ``bytes`` value attaches a digest the caller already computed.
    """
    payloads = list(payloads)
    keys = [market_id for market_id, _ in payloads]
    if len(set(keys)) != len(keys):
        raise ValueError("duplicate market ids in one settlement plan")

    packed = pack_markets(payloads)
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
    pass, duplicate averaging and the topology fingerprint. :meth:`bind`
    completes it — one pair-interning pass plus the dense block fill — and
    is the only part that mutates shared state. ``stage(...).bind(store)``
    ≡ the one-shot builder, bit-for-bit.
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

    def bind(self, store) -> SettlementPlan:
        """Intern this stage's pairs into *store* (every pair, in batch
        order — the port has no delta pair table yet) and assemble the
        plan."""
        rows = store.rows_for_indexed(
            self.sid_of_rank, self.pair_rank,
            self.market_keys, self.pair_market,
        )
        sid_of_rank, pair_rank = self.sid_of_rank, self.pair_rank
        market_keys, pair_market = self.market_keys, self.pair_market
        return _assemble_plan(
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


def stage_settlement_plan_columnar(
    market_keys: Sequence[str],
    source_ids: "Sequence[str] | SourceCodes",
    probabilities,
    offsets,
    num_slots: "int | str | None" = None,
    fingerprint: "bool | bytes" = False,
) -> StagedColumnarPlan:
    """Validate + group one columnar batch without touching any store.

    *source_ids* is either one string per signal (markets back to back)
    or a :class:`~.core.batch.SourceCodes` column.
    """
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

    (signal_pairs, pair_market, pair_rank, pair_offsets,
     sums, counts) = group_columns(codes, rank_of_code, offsets, probabilities)
    pair_mean = sums / np.maximum(counts, 1)

    if fingerprint is True:
        fingerprint = topology_fingerprint(market_keys, source_ids, offsets)
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
    )


def build_settlement_plan_columnar(
    store,
    market_keys: Sequence[str],
    source_ids: "Sequence[str] | SourceCodes",
    probabilities,
    offsets,
    num_slots: "int | str | None" = None,
    fingerprint: "bool | bytes" = False,
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
    """
    return stage_settlement_plan_columnar(
        market_keys, source_ids, probabilities, offsets,
        num_slots=num_slots, fingerprint=fingerprint,
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
            self._consensus_np = self._consensus_raw.cpu().numpy()
            self._consensus_raw = None  # free the device buffer
        return self._consensus_np

    def fence(self) -> None:
        """Block until the settlement's outputs exist on the device,
        fetching only one scalar."""
        if self._consensus_np is None and self._consensus_raw.numel():
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
