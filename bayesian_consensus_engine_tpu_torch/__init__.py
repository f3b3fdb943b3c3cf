"""PyTorch/CUDA port of the Bayesian consensus engine.

The JAX package ``bayesian_consensus_engine_tpu`` is the reference this
package is held against; nothing here imports it (or JAX). Layer map,
bottom → top, each module named after its JAX counterpart:

  utils/        constants (``config``), time conversion, interning, the
                device/dtype policy (``device``) and the card's memory
                counters (``profiling``)
  ops/          the cycle as plain tensor math (``decay``, ``update``,
                ``cycle_math``), the tie-break, band and belief-sweep math
                (``tiebreak``, ``uncertainty``, ``propagate``), and the
                hand-written CUDA kernels (``settle_kernel`` +
                ``csrc/settle_cycles.cu``, ``onepass_kernel`` +
                ``csrc/onepass_settle.cu``, ``bp_kernel`` +
                ``csrc/bp_sweep.cu``, ``partials_kernel`` +
                ``csrc/onepass_partials.cu``, all built by ``cuda_build``),
                the batched consensus sums as ordered segment sums
                (``consensus``), and the in-process collectives over a
                mesh axis (``collectives``)
  core/         input validation (``validate``), the scalar consensus
                engine (``engine``), and host packing plus the batched
                array engine (``batch``: payloads → ordered pair arrays →
                one device pass → reference-shaped documents)
  obs/          host observability the store, journal, pipeline and
                serve driver record into: counters and histograms
                (``metrics``), phase spans (``timeline``), span chains
                (``trace``), SLO goodput (``slo``), burn-rate health
                (``health``), the run ledger (``ledger``), the
                Prometheus/HTTP exporter (``export``) and the fleet merge
                (``fleet``)
  state/        scalar decay/update math, the SQLite checkpoint backend,
                the device-tensor store (``tensor_store``: synchronous
                and background SQLite flushes, journal epochs), the
                durability journal with replay, compaction and the
                admitted-trace sidecar (``journal``), and the
                market → domain → global fallback wrapper (``namespaced``)
  models/       markets, the market store and cross-market aggregator
                (``market``), and the deterministic tie-breaker
                (``tiebreak``)
  parallel/     the (markets, sources) mesh (``mesh``), this process's
                band (``distributed``), the fused settle + analytics loop
                over a resident block on one card or a mesh (``sharded``),
                the ring-reduced loop, ``reshard`` and the standalone ring
                tie-break (``ring``), and the counter-compact loop
                (``compact``)
  analytics/    the options bag of the analytics entry (``bands``) and
                the market graph (``graph``)
  infer/        graph inference: ``InferenceOptions``,
                ``propagate_beliefs``, the banded halo sweep
                (``partition``) and combinatorial ``MarketBlocks``
  pipeline      plan → settle → deferred absorb → SQLite checkpoint, the
                resident session on one card or a mesh
                (``ShardedSettlementSession``, with ``refresh`` and
                ``adopt``), and the streamed service (``PlanPrefetcher``,
                ``settle_stream``)
  serve/        the stream's loop body as an API: ``SessionDriver``,
                ``PlanCache`` and ``drive_trace`` (``driver``); the
                request front door ``ConsensusService`` (``coalesce``:
                micro-batch coalescing, the adaptive window, per-request
                latency and SLO accounting) with bounded admission,
                tenant classes and variance-aware shedding
                (``admission``)
  net/          the socket front door over the service: the framed wire
                codec (``wire``), ``ConsensusServer`` (``server``) and
                ``ConsensusClient`` (``client``)
  cli           the command line (``python -m
                bayesian_consensus_engine_tpu_torch.cli``, ``bce-torch``):
                ``consensus``, ``report-outcome``, ``list-sources``,
                ``journal-export``, ``serve``, ``stats``, ``trace``, with a
                ``--device`` seam (``cuda`` unless ``cpu`` is asked for)
  convert       build a store from either package's records, a graph
                from a JAX ``MarketGraph``'s fields, and a mesh session's
                block state from global numpy arrays and back

The device is explicit: a store is on CUDA unless ``device="cpu"`` is
passed, and without CUDA it raises. On CUDA every flat settle is one launch
of the settle kernel, every session settle one launch of the one-pass
kernel (on a sources-sharded mesh, one launch of the partials kernel a
shard and the cross-shard merge), and every graph sweep one cooperative
launch of the belief sweep kernel (none at a depth of 0); on the CPU each
kernel's plain torch version runs. The batched consensus pass
(``compute_consensus(..., backend="torch")``, ``compute_batch_consensus``)
is plain PyTorch in a fixed order, the same code and bits on both devices.
"""

from bayesian_consensus_engine_tpu_torch.analytics import AnalyticsOptions
from bayesian_consensus_engine_tpu_torch.core import (
    ValidationError,
    compute_consensus,
    validate_input_payload,
)
from bayesian_consensus_engine_tpu_torch.core.batch import compute_batch_consensus
from bayesian_consensus_engine_tpu_torch.pipeline import (
    PlanPrefetcher,
    SettlementPlan,
    SettlementResult,
    ShardedSettlementSession,
    build_settlement_plan,
    build_settlement_plan_columnar,
    settle,
    settle_payloads,
    settle_sharded,
    settle_stream,
)
from bayesian_consensus_engine_tpu_torch.serve.driver import (
    PlanCache,
    SessionDriver,
    drive_trace,
)
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)

__all__ = [
    "AnalyticsOptions",
    "PlanCache",
    "PlanPrefetcher",
    "SessionDriver",
    "SettlementPlan",
    "SettlementResult",
    "ShardedSettlementSession",
    "TensorReliabilityStore",
    "ValidationError",
    "build_settlement_plan",
    "build_settlement_plan_columnar",
    "compute_batch_consensus",
    "compute_consensus",
    "settle",
    "settle_payloads",
    "settle_sharded",
    "settle_stream",
    "drive_trace",
    "validate_input_payload",
]
