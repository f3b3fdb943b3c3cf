"""Process bands of the mesh — the single-process part of the JAX
package's ``parallel/distributed.py``.

In one process every shard of the mesh is local, so this process's band of
the markets axis is every market, and its local columns of a slot-major
block are the whole block. :func:`process_market_rows` and
:func:`global_slot_block` keep the reference's names and checks so that the
session reads as the JAX session does; ``init_distributed``,
``make_hybrid_mesh``, ``global_block`` and bands spread over several
processes (``torch.distributed``) are not ported yet (ROADMAP queue 1
item 9).
"""

from __future__ import annotations

import numpy as np

from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
    MARKETS_AXIS,
    Mesh,
    shard_slot_block,
)


def process_market_rows(num_markets: int, mesh: Mesh) -> tuple:
    """[start, stop) of the global markets axis owned by this process: all
    of it, in one process. ``num_markets`` must divide evenly over the
    markets axis."""
    if num_markets % mesh.shape[MARKETS_AXIS]:
        raise ValueError(
            f"{num_markets} markets do not divide over "
            f"{mesh.shape[MARKETS_AXIS]} markets shards — pad the axis first"
        )
    return 0, num_markets


def global_slot_block(local_cols, mesh: Mesh, num_markets: int, dtype=None):
    """The mesh's per-shard blocks (``mesh.shard_slot_block``) of a
    slot-major (K, M) block given as this process's band of market columns
    at full K height — in one process, the whole block."""
    local_cols = np.asarray(local_cols)
    lo, hi = process_market_rows(num_markets, mesh)
    if local_cols.shape[1] != hi - lo:
        raise ValueError(
            f"local columns {local_cols.shape[1]} != this process's band "
            f"[{lo}, {hi})"
        )
    return shard_slot_block(local_cols, mesh, dtype=dtype)
