"""infer/ — graph inference over correlated markets, the port of the JAX
package's ``infer/``.

* :mod:`~.infer.bp` — :class:`InferenceOptions` (the moments, early-exit
  and depth knobs that ride ``AnalyticsOptions(inference=...)``) and
  :func:`propagate_beliefs`, the one-call host form of the sweep;
* :mod:`~.infer.partition` — cross-band graph partitioning: band-local
  neighbour blocks with an explicit halo exchange of boundary market
  moments, the banded sweep bit-equal to the whole-axis one;
* :mod:`~.infer.blocks` — combinatorial market blocks: constraint-typed
  edges (``mutually_exclusive`` partitions, ``implies`` chains) compiled
  to :class:`~.analytics.graph.MarketGraph` edges, and a deterministic
  post-sweep projection.

The sweep itself is ``ops/propagate.py`` (the plain version) and
``ops/bp_kernel.py`` (the CUDA kernel). Everything here is additive
analytics: consensus, store and SQLite bytes are untouched.
"""

from bayesian_consensus_engine_tpu_torch.infer.blocks import MarketBlock, MarketBlocks
from bayesian_consensus_engine_tpu_torch.infer.bp import (
    InferenceOptions,
    propagate_beliefs,
)
from bayesian_consensus_engine_tpu_torch.infer.partition import (
    BandedGraph,
    banded_bp_sweep,
    exchange_halos,
    partition_csr,
)
from bayesian_consensus_engine_tpu_torch.ops.propagate import PropagatedBeliefs

__all__ = [
    "BandedGraph",
    "InferenceOptions",
    "MarketBlock",
    "MarketBlocks",
    "PropagatedBeliefs",
    "banded_bp_sweep",
    "exchange_halos",
    "partition_csr",
    "propagate_beliefs",
]
