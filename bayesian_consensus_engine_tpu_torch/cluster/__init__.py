"""cluster/ — the part of the JAX package's ``cluster/`` the replay lab
reads.

Only :mod:`~.cluster.recover`'s :func:`store_digest` and
:func:`extract_cluster_trace` are ported so far. Membership views, the
cluster journal merge and live adoption (``membership.py``,
``replay_cluster_journals``, ``adopt_journal``) come with ROADMAP queue 1
item 9.
"""

from bayesian_consensus_engine_tpu_torch.cluster.recover import (
    extract_cluster_trace,
    store_digest,
)

__all__ = ["extract_cluster_trace", "store_digest"]
