"""State carried across from the JAX package (or any record source).

:func:`store_from_records` builds a port store from reliability records:
either the record list that ``list_sources()`` of either package returns,
or the same five columns given directly — source ids, market ids,
reliabilities, confidences and ISO ``updated_at`` strings, as lists or
numpy arrays. ``TensorReliabilityStore.from_sqlite`` is the file route.
"""

from __future__ import annotations

import numpy as np

from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)
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
    for row, value in zip(rows.tolist(), iso):
        store._iso[row] = value
    return store
