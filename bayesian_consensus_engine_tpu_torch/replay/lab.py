"""The counterfactual replay lab — the port of the JAX package's
``replay/lab.py``.

A recorded run leaves its journal (the outputs) and the journal's trace
sidecar (the inputs: each admitted batch's columnar payload columns,
outcomes, settlement day and step count). This module re-drives that
workload under K altered parameter configs on the card:

* **Lane 0 is authoritative.** The recorded config re-drives through the
  live settle machinery (:func:`~.serve.driver.drive_trace`'s loop body:
  :class:`~.serve.driver.PlanCache` stage/bind in admission order, one
  :class:`~.serve.driver.SessionDriver` on the flat path), so its store
  digest and SQLite bytes are the live run's by construction.
* **Lanes ride one launch.** Every config advances through
  :func:`~.parallel.sharded.build_replay_sweep_step` per batch: one
  ``settle_cycles_lanes`` launch moves all C lanes' stacked flat state
  through the batch's plan, each lane with its own cycle rates, with the
  band-width read before it and the Brier and graph metrics after it.
  Plan build, interning and the plan's upload are paid once for all
  lanes and shared with lane 0's dispatch (the plan's device cache).

Determinism: a :class:`SweepResult` carries no timing and is a pure
function of (trace, config set): run twice, its ``result_digest`` is the
same. ``confidence_growth`` is not a sweep dimension: the settled
confidence trajectory is data-independent and replayed on the host in
exact arithmetic.

Like the port's other entry points, the sweep takes ``device=``: ``None``
is CUDA, and without CUDA it raises.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.obs.metrics import metrics_registry
from bayesian_consensus_engine_tpu_torch.obs.timeline import active_timeline
from bayesian_consensus_engine_tpu_torch.ops.propagate import DEFAULT_DAMPING
from bayesian_consensus_engine_tpu_torch.ops.uncertainty import Z_95
from bayesian_consensus_engine_tpu_torch.state.journal import TraceBatch
from bayesian_consensus_engine_tpu_torch.utils.config import (
    BASE_LEARNING_RATE,
    CONFIDENCE_GROWTH_RATE,
    DECAY_HALF_LIFE_DAYS,
    DECAY_MINIMUM,
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
    MAX_UPDATE_STEP,
)


class ReplayConfig(NamedTuple):
    """One counterfactual parameter point — a lane of the sweep.

    Defaults are the recorded constants, so ``ReplayConfig()`` is the live
    run's config (:data:`RECORDED_CONFIG`). ``graph_steps=0`` disables the
    lane's graph relaxation (its ``graph_brier`` then equals its
    ``brier``); a lane with ``graph_steps > 0`` needs a
    :class:`~.analytics.graph.MarketGraph`. ``graph_tol > 0`` freezes the
    lane's relaxation once its ``max |Δvalue|`` residual drops to the
    tolerance.
    """

    half_life_days: float = DECAY_HALF_LIFE_DAYS
    decay_floor: float = DECAY_MINIMUM
    base_learning_rate: float = BASE_LEARNING_RATE
    max_update_step: float = MAX_UPDATE_STEP
    band_z: float = Z_95
    graph_damping: float = DEFAULT_DAMPING
    graph_steps: int = 0
    graph_tol: float = 0.0


#: The live run's parameter point — always lane 0 of a sweep.
RECORDED_CONFIG = ReplayConfig()


class LaneReport(NamedTuple):
    """One lane's accumulated sweep metrics (sums over all batches).

    ``markets_settled`` counts market-settlements with nonzero consensus
    weight (a market settling in several batches counts each time);
    ``brier_sum`` is Σ(consensus − outcome)² over those,
    ``band_width_sum`` the Σ of two-sided ``2·z·stderr`` credible widths
    over the pre-update read, and ``graph_brier_sum`` the Brier after the
    lane's graph relaxation (``brier_sum`` for ``graph_steps=0`` lanes).
    Means divide by ``markets_settled`` (``nan`` when nothing settled).
    """

    config: ReplayConfig
    markets_settled: int
    brier_sum: float
    band_width_sum: float
    graph_brier_sum: float

    @property
    def brier_mean(self) -> float:
        return (
            self.brier_sum / self.markets_settled
            if self.markets_settled else float("nan")
        )

    @property
    def band_width_mean(self) -> float:
        return (
            self.band_width_sum / self.markets_settled
            if self.markets_settled else float("nan")
        )

    @property
    def graph_brier_mean(self) -> float:
        return (
            self.graph_brier_sum / self.markets_settled
            if self.markets_settled else float("nan")
        )


@dataclass(frozen=True)
class SweepResult:
    """A finished sweep: per-lane reports + the authoritative rebuild.

    ``lanes[0]`` is always :data:`RECORDED_CONFIG`. ``store`` and
    ``digest`` are the lane-0 rebuild (``None`` with ``rebuild=False``).
    ``lane_state`` holds the final stacked flat columns ``(reliability,
    confidence, updated_days, exists)`` as numpy arrays, each ``(K,
    rows)``, stamps relative to ``epoch0``. ``result_digest`` hashes
    (configs, raw metric bytes, lane-0 digest).
    """

    lanes: Tuple[LaneReport, ...]
    batches: int
    epoch0: float
    lane_state: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
    result_digest: str
    store: object = None
    digest: Optional[str] = None

    def by_config(self) -> "dict[ReplayConfig, LaneReport]":
        return {lane.config: lane for lane in self.lanes}


def load_trace(journal_path, strict: bool = False) -> List[TraceBatch]:
    """The replayable workload of one recorded journal:
    :func:`~.state.journal.extract_trace` bounded by the journal's durable
    tag (``strict=True`` refuses a torn tail instead of shortening)."""
    from bayesian_consensus_engine_tpu_torch.state.journal import extract_trace

    batches, _tag = extract_trace(str(journal_path), strict=strict)
    return batches


def load_cluster_trace(paths, strict: bool = False) -> List[TraceBatch]:
    """The merged replayable workload of N fleet band journals
    (:func:`~.cluster.recover.extract_cluster_trace`)."""
    from bayesian_consensus_engine_tpu_torch.cluster.recover import (
        extract_cluster_trace,
    )

    batches, _tags = extract_cluster_trace(paths, strict=strict)
    return batches


def trace_from_batches(
    batch_log: Sequence,
    now: float,
    steps: int = 1,
) -> List[TraceBatch]:
    """A serving front end's ``record_batches`` log as a trace: entries
    ``((market_keys, source_ids, probabilities, offsets), outcomes)``,
    the first at day *now*, one day per batch."""
    batches: List[TraceBatch] = []
    for index, (payload, outcomes) in enumerate(batch_log):
        market_keys, source_ids, probabilities, offsets = payload
        batches.append(TraceBatch(
            index=index,
            market_keys=tuple(market_keys),
            source_ids=tuple(source_ids),
            probabilities=np.ascontiguousarray(probabilities, dtype=np.float64),
            offsets=np.ascontiguousarray(offsets, dtype=np.int64),
            outcomes=np.asarray(outcomes, dtype=bool),
            now_days=float(now) + index,
            steps=int(steps),
        ))
    return batches


def _uniform_steps(batches: Sequence[TraceBatch]) -> int:
    steps_seen = {int(batch.steps) for batch in batches}
    if len(steps_seen) != 1:
        raise ValueError(
            f"trace mixes step counts {sorted(steps_seen)}; one sweep "
            "runs one compiled step shape — split the trace"
        )
    return steps_seen.pop()


def _result_digest(
    lanes: Sequence[ReplayConfig],
    metrics: np.ndarray,
    lane0_digest: Optional[str],
) -> str:
    h = hashlib.blake2b(digest_size=16)

    def put(raw: bytes) -> None:
        h.update(len(raw).to_bytes(8, "little"))
        h.update(raw)

    for config in lanes:
        put(np.asarray(config, dtype=np.float64).tobytes())
    put(np.ascontiguousarray(metrics, dtype=np.float32).tobytes())
    put((lane0_digest or "").encode())
    return h.hexdigest()


def replay_sweep(
    trace: Sequence[TraceBatch],
    configs: Sequence[ReplayConfig] = (),
    *,
    graph=None,
    dtype=None,
    rebuild: bool = True,
    journal=None,
    db_path=None,
    checkpoint_every: int = 1,
    num_slots: "int | str | None" = "bucket",
    intern_mode: str = "auto",
    device=None,
) -> SweepResult:
    """Re-drive *trace* under the recorded config + every *configs* lane.

    One pass over the trace: each batch's plan stages and binds ONCE (in
    recorded admission order, against the lane-0 store), lane 0
    dispatches through the real :class:`~.serve.driver.SessionDriver`
    (``rebuild=True``; *journal* / *db_path* / *checkpoint_every* run the
    recorded durability cadence against fresh files), and ALL lanes
    advance through one ``settle_cycles_lanes`` launch per batch.
    ``rebuild=False`` skips the authoritative lane: the same lane
    metrics, no store or digest.

    *graph*, a :class:`~.analytics.graph.MarketGraph`, is required when
    any lane sets ``graph_steps > 0``. *dtype* is the lanes' working
    dtype (``None``: float32; ``torch.float64``). *device* places the
    store and the lanes (``None``: CUDA, raising without it).
    """
    from bayesian_consensus_engine_tpu_torch.parallel.sharded import (
        CycleParams,
        build_replay_sweep_step,
    )
    from bayesian_consensus_engine_tpu_torch.pipeline import (
        _device_plan,
        _plan_touched,
    )
    from bayesian_consensus_engine_tpu_torch.serve.driver import (
        PlanCache,
        SessionDriver,
    )
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )
    from bayesian_consensus_engine_tpu_torch.utils.device import resolve_dtype

    batches = list(trace)
    if not batches:
        raise ValueError("empty trace: nothing to replay")
    steps = _uniform_steps(batches)
    lanes: Tuple[ReplayConfig, ...] = tuple(configs)
    if not lanes or lanes[0] != RECORDED_CONFIG:
        lanes = (RECORDED_CONFIG,) + lanes
    num_lanes = len(lanes)
    max_graph_steps = max(int(config.graph_steps) for config in lanes)
    if max_graph_steps > 0 and graph is None:
        raise ValueError(
            "a lane sets graph_steps > 0 but no graph= was given — the "
            "relaxation sweep needs the MarketGraph the lanes vary over"
        )

    timeline = active_timeline()
    registry = metrics_registry()
    batch_counter = registry.counter("replay.sweep_batches")
    registry.gauge("replay.sweep_lanes").set(float(num_lanes))

    # Plan build (stage + bind, admission order) — paid once for every
    # lane. The store doubles as lane 0's authoritative store.
    store = TensorReliabilityStore(device=device)
    device = store.device
    plans = PlanCache(store, num_slots=num_slots, intern_mode=intern_mode)
    with timeline.span("replay"):
        plan_list = [
            plans.plan_for(
                list(batch.market_keys),
                list(batch.source_ids),
                batch.probabilities,
                batch.offsets,
            )
            for batch in batches
        ]
    rows = len(store)

    cdtype = resolve_dtype(dtype)
    np_dtype = np.float32 if cdtype == torch.float32 else np.float64
    # Stamps are relative; one epoch strictly before the first batch's
    # day keeps every stamp positive ("> 0" means "ever updated").
    epoch0 = float(batches[0].now_days) - 1.0

    def stacked(fill, dt):
        return torch.full((num_lanes, rows), fill, dtype=dt, device=device)

    state = (
        stacked(DEFAULT_RELIABILITY, cdtype),
        stacked(DEFAULT_CONFIDENCE, cdtype),
        stacked(0.0, cdtype),
        stacked(False, torch.bool),
    )
    metrics = torch.zeros((num_lanes, 4), dtype=torch.float32, device=device)

    def lane_f32(field):
        return torch.tensor(
            np.asarray([float(getattr(config, field)) for config in lanes],
                       dtype=np.float32),
            device=device,
        )

    params = CycleParams(
        half_life_days=lane_f32("half_life_days"),
        decay_floor=lane_f32("decay_floor"),
        base_learning_rate=lane_f32("base_learning_rate"),
        max_update_step=lane_f32("max_update_step"),
        confidence_growth=torch.full(
            (num_lanes,), float(np.float32(CONFIDENCE_GROWTH_RATE)),
            dtype=torch.float32, device=device,
        ),
    )
    band_z = lane_f32("band_z")
    graph_lanes = (
        (
            lane_f32("graph_damping"),
            torch.tensor([int(config.graph_steps) for config in lanes],
                         dtype=torch.int32, device=device),
            lane_f32("graph_tol"),
        )
        if max_graph_steps > 0 else ()
    )
    step = build_replay_sweep_step(steps, max_graph_steps)

    driver = None
    if rebuild:
        owns_journal = False
        if journal is not None and not hasattr(journal, "append_epoch"):
            from bayesian_consensus_engine_tpu_torch.state.journal import (
                JournalWriter,
            )

            journal = JournalWriter(journal)
            owns_journal = True
        driver = SessionDriver(
            store,
            steps=steps,
            journal=journal,
            owns_journal=owns_journal,
            db_path=db_path,
            checkpoint_every=checkpoint_every,
        )
    try:
        for index, (batch, plan) in enumerate(zip(batches, plan_list)):
            if driver is not None:
                driver.dispatch(plan, batch.outcomes, now=float(batch.now_days))
                driver.checkpoint(index)
            with timeline.span("replay"):
                _, slot_rows_d, probs_d, mask_d, offsets_d = _device_plan(
                    plan, cdtype, device
                )
                touched_rows, _offsets = _plan_touched(plan)
                neighbors = ()
                if max_graph_steps > 0:
                    neighbor_idx, neighbor_w = graph.align(
                        list(batch.market_keys)
                    )
                    neighbors = (
                        torch.from_numpy(neighbor_idx).to(device),
                        torch.from_numpy(neighbor_w).to(device),
                    )
                state, metrics = step(
                    state, metrics, params, band_z, graph_lanes,
                    slot_rows_d, probs_d, mask_d,
                    torch.as_tensor(np.asarray(batch.outcomes, dtype=bool),
                                    device=device),
                    float(np_dtype(float(batch.now_days) - epoch0)),
                    neighbors,
                    touched=(offsets_d, len(touched_rows)),
                )
            batch_counter.inc()
    finally:
        if driver is not None:
            driver.finalize()

    metrics_np = metrics.cpu().numpy()
    lane_state = tuple(column.cpu().numpy() for column in state)
    digest = None
    if rebuild:
        from bayesian_consensus_engine_tpu_torch.cluster.recover import (
            store_digest,
        )

        digest = store_digest(store)
    reports = tuple(
        LaneReport(
            config=config,
            markets_settled=int(metrics_np[lane, 0]),
            brier_sum=float(metrics_np[lane, 1]),
            band_width_sum=float(metrics_np[lane, 2]),
            graph_brier_sum=float(metrics_np[lane, 3]),
        )
        for lane, config in enumerate(lanes)
    )
    return SweepResult(
        lanes=reports,
        batches=len(batches),
        epoch0=epoch0,
        lane_state=lane_state,
        result_digest=_result_digest(lanes, metrics_np, digest),
        store=store if rebuild else None,
        digest=digest,
    )


def replay_single(
    trace: Sequence[TraceBatch],
    config: ReplayConfig = RECORDED_CONFIG,
    *,
    graph=None,
    dtype=None,
    device=None,
) -> LaneReport:
    """One config's replay, paying the full staging cost itself: a fresh
    store, every plan re-staged and re-interned, and a launch of one or
    two lanes (the sweep always carries the recorded lane)."""
    result = replay_sweep(
        trace,
        () if config == RECORDED_CONFIG else (config,),
        graph=graph,
        dtype=dtype,
        rebuild=False,
        device=device,
    )
    return result.by_config()[config]
