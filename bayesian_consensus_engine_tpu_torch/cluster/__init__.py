"""cluster/ — multi-host membership, degraded-mesh views and recovery: the
torch twin of the JAX package's ``cluster/``.

* :mod:`~.cluster.membership` — deterministic, epoch-tagged
  :class:`MeshView` layouts over a host set, with no coordinator (the view
  is a pure function of the sorted host set), and the *degraded* view of
  any surviving subset.
* :mod:`~.cluster.recover` — journal-driven recovery: merge the surviving
  band journals into one store, adopt a dead band's journal into a live
  surviving stream, merge the bands' trace sidecars for the replay lab.
* :mod:`~.cluster.rank` — one rank of a multi-process band settlement
  (the gloo rendezvous, the band plan and session, the adopt of a
  drifted batch); run it as ``python -m
  bayesian_consensus_engine_tpu_torch.cluster.rank JOB``.
* :mod:`~.cluster.soak` — the kill soak: a shared-nothing banded cluster
  of worker processes, one of which is killed mid-stream; run it as
  ``python -m bayesian_consensus_engine_tpu_torch.cluster.soak``.

The session side lives where the session lives:
``ShardedSettlementSession(band=...)`` and its ``adopt`` (``pipeline.py``)
keep a band's block resident across topology drift.
"""

from bayesian_consensus_engine_tpu_torch.cluster.membership import (
    MeshView,
    runtime_view,
)
from bayesian_consensus_engine_tpu_torch.cluster.recover import (
    ClusterModeUnsupported,
    ClusterReplay,
    adopt_journal,
    extract_cluster_trace,
    replay_cluster_journals,
    store_digest,
)

__all__ = [
    "ClusterModeUnsupported",
    "ClusterReplay",
    "MeshView",
    "adopt_journal",
    "extract_cluster_trace",
    "replay_cluster_journals",
    "runtime_view",
    "store_digest",
]
