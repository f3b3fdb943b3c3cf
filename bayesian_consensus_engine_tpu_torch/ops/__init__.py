"""Device math of the port: the cycle's tensor twins and the kernels'
wrappers.

As in the JAX package's ``ops/__init__.py``: the flat-pair consensus
sums, the decay and the outcome update, and the batched tie-break.
"""

from bayesian_consensus_engine_tpu_torch.ops.consensus import (
    pair_mean_from_flat,
    weighted_sums_from_pairs,
)
from bayesian_consensus_engine_tpu_torch.ops.decay import (
    decay_factor,
    decayed_reliability,
    decayed_reliability_at,
)
from bayesian_consensus_engine_tpu_torch.ops.tiebreak import (
    BatchTieBreakResult,
    batched_tiebreak,
    build_batched_tiebreak,
)
from bayesian_consensus_engine_tpu_torch.ops.update import (
    masked_outcome_update,
    outcome_update,
)

__all__ = [
    "pair_mean_from_flat",
    "weighted_sums_from_pairs",
    "decay_factor",
    "decayed_reliability",
    "decayed_reliability_at",
    "masked_outcome_update",
    "outcome_update",
    "BatchTieBreakResult",
    "batched_tiebreak",
    "build_batched_tiebreak",
]
