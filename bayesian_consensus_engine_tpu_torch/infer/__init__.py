"""infer/ — graph inference over correlated markets, the port of the JAX
package's ``infer/``.

* :mod:`~.infer.bp` — :class:`InferenceOptions` (the moments, early-exit
  and depth knobs that ride ``AnalyticsOptions(inference=...)``) and
  :func:`propagate_beliefs`, the one-call host form of the sweep;
* :mod:`~.infer.blocks` — combinatorial market blocks: constraint-typed
  edges (``mutually_exclusive`` partitions, ``implies`` chains) compiled
  to :class:`~.analytics.graph.MarketGraph` edges, and a deterministic
  post-sweep projection.

The sweep itself is ``ops/propagate.py`` (the plain version) and
``ops/bp_kernel.py`` (the CUDA kernel). Everything here is additive
analytics: consensus, store and SQLite bytes are untouched. The banded
halo sweep (the JAX package's ``infer/partition.py``), which a graph on
a mesh with several markets shards needs, is not ported yet.
"""

from bayesian_consensus_engine_tpu_torch.infer.blocks import MarketBlock, MarketBlocks
from bayesian_consensus_engine_tpu_torch.infer.bp import (
    InferenceOptions,
    propagate_beliefs,
)
from bayesian_consensus_engine_tpu_torch.ops.propagate import PropagatedBeliefs

__all__ = [
    "InferenceOptions",
    "MarketBlock",
    "MarketBlocks",
    "PropagatedBeliefs",
    "propagate_beliefs",
]
