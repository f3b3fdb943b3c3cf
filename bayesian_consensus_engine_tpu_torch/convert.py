"""State carried across from the JAX package (or any record source).

:func:`store_from_records` builds a port store from reliability records:
either the record list that ``list_sources()`` of either package returns,
or the same five columns given directly — source ids, market ids,
reliabilities, confidences and ISO ``updated_at`` strings, as lists or
numpy arrays. ``TensorReliabilityStore.from_sqlite`` is the file route.
:func:`block_state_from_numpy` builds a slot-major block state from numpy
arrays, so that one block can be fed to both packages;
:func:`sharded_block_from_numpy` and :func:`sharded_block_to_numpy` carry
a mesh session's block state (global numpy arrays, as ``np.asarray`` of the
JAX session's sharded state gives them) to the port's grid of per-shard
blocks and back; and
:func:`market_graph_from_fields` builds the port's ``MarketGraph`` from a
JAX ``MarketGraph``'s fields, so that one graph can.
"""

from __future__ import annotations

import numpy as np

import torch

from bayesian_consensus_engine_tpu_torch.analytics.graph import MarketGraph
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
    Mesh,
    shard_slot_block,
    unshard_slot_block,
)
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)
from bayesian_consensus_engine_tpu_torch.utils.device import resolve_device
from bayesian_consensus_engine_tpu_torch.utils.timeconv import iso_to_days


def _columns(records):
    if isinstance(records, tuple) and len(records) == 5 and not hasattr(
        records[0], "source_id"
    ):
        return records
    records = list(records)
    return (
        [r.source_id for r in records],
        [r.market_id for r in records],
        [r.reliability for r in records],
        [r.confidence for r in records],
        [r.updated_at for r in records],
    )


def store_from_records(records, device=None) -> TensorReliabilityStore:
    """A store holding exactly *records*, every row existing and dirty.

    Values land as given (float64 host truth, ISO strings verbatim), as
    ``put_record`` would write them one by one. Rows are interned in
    record order; (source_id, market_id) keys must be unique.
    """
    sources, markets, rel, conf, iso = _columns(records)
    sources = [str(s) for s in sources]
    markets = [str(m) for m in markets]
    iso = [str(s) for s in iso]
    rel = np.asarray(rel, dtype=np.float64)
    conf = np.asarray(conf, dtype=np.float64)
    count = len(sources)
    if not (len(markets) == len(iso) == rel.shape[0] == conf.shape[0] == count):
        raise ValueError("record columns differ in length")
    if len(set(zip(sources, markets))) != count:
        raise ValueError("duplicate (source_id, market_id) records")
    store = TensorReliabilityStore(capacity=count, device=device)
    rows = store.rows_for_arrays(sources, markets).astype(np.int64)
    store._rel[rows] = rel
    store._conf[rows] = conf
    store._days[rows] = [iso_to_days(s) for s in iso]
    store._exists[rows] = True
    store._dirty[rows] = True
    store._journal_dirty[rows] = True
    for row, value in zip(rows.tolist(), iso):
        store._iso[row] = value
    return store


def _checked_state_arrays(reliability, confidence, updated_days, exists):
    """The four fields of a block state as numpy arrays: three float
    arrays of one dtype and a bool ``exists``, all of one shape."""
    floats = [np.asarray(x) for x in (reliability, confidence, updated_days)]
    exists = np.asarray(exists)
    if len({x.dtype for x in floats}) != 1 or floats[0].dtype.kind != "f":
        raise ValueError("reliability, confidence and updated_days must share "
                         "one float dtype")
    if exists.dtype != np.bool_:
        raise ValueError(f"exists must be bool, not {exists.dtype}")
    if len({x.shape for x in floats} | {exists.shape}) != 1:
        raise ValueError("the block state's arrays differ in shape")
    return (*floats, exists)


def block_state_from_numpy(
    reliability, confidence, updated_days, exists, device=None,
) -> MarketBlockState:
    """The port's :class:`MarketBlockState` from a block state given as
    numpy arrays (as ``np.asarray`` of the JAX package's fields gives
    them): three float arrays of one dtype and a bool ``exists``, all of
    one shape. The tensors are copies on *device* (``None`` means CUDA)."""
    device = resolve_device(device)
    arrays = _checked_state_arrays(reliability, confidence, updated_days, exists)
    return MarketBlockState(*(torch.tensor(x, device=device) for x in arrays))


def sharded_block_from_numpy(state_np, mesh: Mesh) -> tuple:
    """A mesh session's block state — a grid ``state[i][j]`` of per-shard
    :class:`MarketBlockState` on the mesh's devices — from the global
    slot-major state given as numpy arrays (the four fields of a
    ``MarketBlockState``, padded as the session pads the plan). The
    arrays are checked as :func:`block_state_from_numpy` checks them and
    cut as ``parallel.mesh.shard_slot_block`` cuts a block."""
    grids = [shard_slot_block(x, mesh) for x in _checked_state_arrays(*state_np)]
    return tuple(
        tuple(
            MarketBlockState(*(grid[i][j] for grid in grids))
            for j in range(len(row))
        )
        for i, row in enumerate(mesh.devices)
    )


def sharded_block_to_numpy(state) -> MarketBlockState:
    """The global slot-major block state of a grid of per-shard
    :class:`MarketBlockState`, as numpy arrays (the reverse of
    :func:`sharded_block_from_numpy`)."""
    return MarketBlockState(*(
        unshard_slot_block(
            [[getattr(shard, field) for shard in row] for row in state]
        ).cpu().numpy()
        for field in MarketBlockState._fields
    ))


def market_graph_from_fields(
    node_ids, offsets, indices, weights, damping, steps, fingerprint,
) -> MarketGraph:
    """The port's :class:`MarketGraph` from a graph's fields, as a JAX
    package ``MarketGraph`` holds them (``node_ids``, the CSR ``offsets``,
    ``indices`` and ``weights``, ``damping``, ``steps`` and the
    ``fingerprint`` bytes). The arrays are copied with the reference's
    dtypes (int64 offsets, int32 indices, float64 weights); the CSR must
    be consistent: one offset per node plus one, non-decreasing, ending at
    the edge count, with every index naming a node."""
    offsets = np.array(offsets, dtype=np.int64)
    indices = np.array(indices, dtype=np.int32)
    weights = np.array(weights, dtype=np.float64)
    node_ids = [str(node) for node in node_ids]
    if offsets.shape != (len(node_ids) + 1,) or offsets[0] != 0:
        raise ValueError("offsets must hold one entry per node plus one, from 0")
    if np.any(np.diff(offsets) < 0) or offsets[-1] != indices.shape[0]:
        raise ValueError("offsets must be non-decreasing and end at the edge count")
    if weights.shape != indices.shape:
        raise ValueError("indices and weights differ in length")
    if indices.size and not (0 <= indices.min() and indices.max() < len(node_ids)):
        raise ValueError("an edge names a node outside node_ids")
    return MarketGraph(
        node_ids, offsets, indices, weights, float(damping), int(steps),
        bytes(fingerprint),
    )
