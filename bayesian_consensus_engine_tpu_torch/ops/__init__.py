"""Device math of the port: the cycle's tensor twins and the settle kernel.

As in the JAX package's ``ops/__init__.py``, the batched tie-break is
exported here.
"""

from bayesian_consensus_engine_tpu_torch.ops.tiebreak import (
    BatchTieBreakResult,
    batched_tiebreak,
    build_batched_tiebreak,
)

__all__ = [
    "BatchTieBreakResult",
    "batched_tiebreak",
    "build_batched_tiebreak",
]
