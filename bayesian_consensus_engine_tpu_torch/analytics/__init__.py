"""Analytics tier of the port: the options bag of the fused session entry,
the standalone band program and the market graph the sweep runs over.

``ShardedSettlementSession.settle_with_analytics`` runs the settle cycles,
the ring tie-break and the uncertainty bands in one pass over the resident
block (on CUDA, one launch of the one-pass kernel) and, with a
:class:`MarketGraph` (``graph=`` or ``blocks=``), the belief sweep after it
(on CUDA, the ``bp_sweep`` kernel). Like the JAX package's tier, it is
pure-additive: settle results, store state and SQLite bytes are the same
with analytics on or off. :func:`build_band_program` computes the bands
alone over a resident block, leaving its state as it was. The
``chunk_slots="auto"`` tuner waits for ``utils/autotune.py`` (ROADMAP
queue 1 item 10).
"""

from bayesian_consensus_engine_tpu_torch.analytics.bands import (
    AnalyticsOptions,
    build_band_program,
)
from bayesian_consensus_engine_tpu_torch.analytics.graph import MarketGraph
from bayesian_consensus_engine_tpu_torch.ops.propagate import (
    DEFAULT_DAMPING,
    DEFAULT_SWEEP_STEPS,
)
from bayesian_consensus_engine_tpu_torch.ops.uncertainty import (
    DEFAULT_CHUNK_SLOTS,
    UncertaintyBands,
    Z_95,
)

__all__ = [
    "AnalyticsOptions",
    "DEFAULT_CHUNK_SLOTS",
    "DEFAULT_DAMPING",
    "DEFAULT_SWEEP_STEPS",
    "MarketGraph",
    "UncertaintyBands",
    "Z_95",
    "build_band_program",
]
