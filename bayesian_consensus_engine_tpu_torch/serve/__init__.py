"""serve/ — the request-facing layer over the resident settlement session.

The port's copy of the JAX package's ``serve`` package:

* :mod:`~.serve.driver` — :class:`SessionDriver`, the ``settle_stream``
  loop body as a reusable drive-one-batch-over-a-resident-session API
  (dispatch + durability cadence + exit contract), :class:`PlanCache`,
  the topology-fingerprint plan-reuse step for caller-scheduled builds,
  and :func:`drive_trace`, which re-drives a recorded trace through them.
  ``settle_stream`` itself runs on the driver.
* :mod:`~.serve.coalesce` — :class:`ConsensusService`, an asyncio request
  layer that accepts per-market signal updates and outcome reports,
  coalesces them into topology-stable micro-batches under a
  max-delay/max-size window (fixed, or aimed at a p99 by
  :class:`AdaptiveWindow`), and drives the session on the store's device
  from one dispatch worker, with per-request latency accounting.
* :mod:`~.serve.admission` — bounded admission with an explicit overload
  policy (reject with a retry hint, or shed), per-tenant
  :class:`QosClass` budgets, objectives and burn-rate monitors, and the
  variance-aware shed ranking :func:`shed_rank_key`.

The network front door over the service is :mod:`~.net`; the command
line's ``serve`` runs both. The served path gives ``settle_stream``'s
bytes over the same coalesced batch sequence (results, store state,
journal epochs, SQLite) because both drive the same ``SessionDriver``.
"""

from bayesian_consensus_engine_tpu_torch.serve.admission import (
    AdmissionConfig,
    Overloaded,
    QosClass,
    ServiceClosed,
    ShedError,
    shed_rank_key,
)
from bayesian_consensus_engine_tpu_torch.serve.coalesce import (
    AdaptiveWindow,
    ConsensusService,
    ServeResult,
)
from bayesian_consensus_engine_tpu_torch.serve.driver import (
    PlanCache,
    SessionDriver,
    drive_trace,
)

__all__ = [
    "AdaptiveWindow",
    "AdmissionConfig",
    "ConsensusService",
    "Overloaded",
    "PlanCache",
    "QosClass",
    "ServeResult",
    "ServiceClosed",
    "SessionDriver",
    "ShedError",
    "drive_trace",
    "shed_rank_key",
]
