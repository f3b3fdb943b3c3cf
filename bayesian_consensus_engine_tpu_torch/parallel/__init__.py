"""Device programs over resident slot-major blocks, on one card or a mesh.

As the JAX package's ``parallel/__init__.py`` does, the ring tier
(``ring``) and the counter-compact loop (``compact``) are exported here.
"""

from bayesian_consensus_engine_tpu_torch.parallel.compact import (
    CompactBlockState,
    advance_counters,
    build_compact_cycle_loop,
    compact_to_block,
    encode_probs_u16,
    init_compact_state,
)
from bayesian_consensus_engine_tpu_torch.parallel.ring import (
    REDUCE_SPEC,
    UPDATE_SPEC,
    RingTieBreakResult,
    build_ring_cycle,
    build_ring_cycle_loop,
    build_ring_tiebreak,
    reshard,
    ring_allreduce,
)

__all__ = [
    "CompactBlockState",
    "advance_counters",
    "build_compact_cycle_loop",
    "compact_to_block",
    "encode_probs_u16",
    "init_compact_state",
    "REDUCE_SPEC",
    "UPDATE_SPEC",
    "RingTieBreakResult",
    "build_ring_cycle",
    "build_ring_cycle_loop",
    "build_ring_tiebreak",
    "reshard",
    "ring_allreduce",
]
