"""Counterfactual replay lab: a recorded trace re-driven under K configs
on the card.

See :mod:`~.replay.lab`. Surface:

* :func:`replay_sweep` — K altered configs through one lane-batched
  settle launch per recorded batch; lane 0 is the recorded config,
  re-driven through the live settle machinery (byte contract witness).
* :func:`replay_single` — one config, full staging paid per call.
* :func:`load_trace` / :func:`load_cluster_trace` /
  :func:`trace_from_batches` — workload sources: a journal's trace
  sidecar, a fleet's band journals, a serving front end's
  ``record_batches`` log.
* :class:`ReplayConfig` / :data:`RECORDED_CONFIG`, :class:`LaneReport`,
  :class:`SweepResult`.
"""

from bayesian_consensus_engine_tpu_torch.replay.lab import (
    RECORDED_CONFIG,
    LaneReport,
    ReplayConfig,
    SweepResult,
    load_cluster_trace,
    load_trace,
    replay_single,
    replay_sweep,
    trace_from_batches,
)

__all__ = [
    "RECORDED_CONFIG",
    "LaneReport",
    "ReplayConfig",
    "SweepResult",
    "load_cluster_trace",
    "load_trace",
    "replay_single",
    "replay_sweep",
    "trace_from_batches",
]
