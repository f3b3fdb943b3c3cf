"""Device programs over resident slot-major blocks, on one card or a mesh.

The JAX package's ``parallel/__init__.py`` surface: the mesh
(``parallel/mesh.py``: a grid of torch devices; ``shard_market`` is the
port's ``shard_market_vector``), the multi-process helpers
(``parallel/distributed.py``), the cycle builders and block helpers
(``parallel/sharded.py``: ``build_cycle``, ``build_cycle_loop``,
``build_cycle_tiebreak_loop``), the ring tier (``ring``) and the
counter-compact loop (``compact``). The JAX package's ``NamedSharding``
helpers (``block_sharding``, ``market_sharding``) have no counterpart: a
sharded block here is a grid of per-shard tensors.
"""

from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
    MARKETS_AXIS,
    SOURCES_AXIS,
    make_mesh,
    shard_block,
    shard_market_vector as shard_market,
)
from bayesian_consensus_engine_tpu_torch.parallel.distributed import (
    global_block,
    global_market,
    init_distributed,
    local_view,
    make_hybrid_mesh,
    process_market_rows,
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
from bayesian_consensus_engine_tpu_torch.parallel.compact import (
    CompactBlockState,
    advance_counters,
    build_compact_cycle_loop,
    compact_to_block,
    encode_probs_u16,
    init_compact_state,
)
from bayesian_consensus_engine_tpu_torch.parallel.sharded import (
    CycleResult,
    MarketBlockState,
    build_cycle,
    build_cycle_loop,
    build_cycle_tiebreak_loop,
    init_block_state,
    pad_markets,
)

__all__ = [
    "MARKETS_AXIS",
    "SOURCES_AXIS",
    "make_mesh",
    "shard_block",
    "shard_market",
    "CycleResult",
    "MarketBlockState",
    "build_cycle",
    "build_cycle_loop",
    "build_cycle_tiebreak_loop",
    "init_block_state",
    "pad_markets",
    "CompactBlockState",
    "advance_counters",
    "build_compact_cycle_loop",
    "compact_to_block",
    "encode_probs_u16",
    "init_compact_state",
    "global_block",
    "global_market",
    "init_distributed",
    "local_view",
    "make_hybrid_mesh",
    "process_market_rows",
    "REDUCE_SPEC",
    "UPDATE_SPEC",
    "RingTieBreakResult",
    "build_ring_cycle",
    "build_ring_cycle_loop",
    "build_ring_tiebreak",
    "reshard",
    "ring_allreduce",
]
