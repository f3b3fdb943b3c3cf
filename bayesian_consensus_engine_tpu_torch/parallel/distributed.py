"""Process bands of a mesh spread over several processes — the torch twin
of the JAX package's ``parallel/distributed.py``.

The JAX package lays the work out so that the settle cycle's one
collective, the sources-axis sum, never leaves a granule: the markets
axis is DCN-outer (markets are pure data parallelism, the cycle needs no
cross-market communication) and the sources axis stays inside a granule.
The port keeps that layout and draws its consequence: no tensor crosses a
process on the settle path. Each process owns one contiguous band of the
markets axis, settles it on its own rows of the mesh, and runs its
sources sums in process (``ops/collectives.py``). ``torch.distributed``
carries only the control plane — the rendezvous, the exchange of each
process's devices (``all_gather_object``) and barriers — over gloo, on
host objects; two processes may therefore share one card, each with its
own CUDA context.

Bring-up is :func:`init_distributed` (an idempotent wrapper over
``torch.distributed.init_process_group``), then :func:`make_hybrid_mesh`
for the (markets, sources) mesh with one granule per process in rank
order, then :func:`global_slot_block` / :func:`global_block` /
:func:`global_market`, which build only THIS process's shards from its
own rows (no process materialises another's columns), and
:func:`local_view`, which reads them back in global row order. In one
process every shard is local and everything degrades to the plain local
mesh.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Optional, Sequence

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
    MARKETS_AXIS,
    Mesh,
    is_initialized,
    make_mesh,
    process_count,
    process_index,
    shard_block,
    shard_market_vector,
    shard_slot_block,
    unshard_block,
    unshard_slot_block,
)

#: How long a rendezvous or a control-plane collective may wait for the
#: other processes before it raises, unless the caller passes ``timeout=``.
DEFAULT_TIMEOUT_S = 120.0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs: Any,
) -> dict:
    """Join (or no-op into) the multi-process runtime; return a summary.

    Nothing on a machine tells a process of its cluster, so a cluster
    call names all three: ``coordinator_address="host:port"`` (rank 0
    listens there), ``num_processes`` and ``process_id``. The group runs
    gloo over TCP; ``kwargs`` go to ``init_process_group`` (``timeout``
    defaults to :data:`DEFAULT_TIMEOUT_S`). A single-process call, and any
    call once this process has joined, is a no-op; a real bring-up
    failure (an unreachable coordinator, a rendezvous that times out)
    raises. ``global_devices`` counts each process's devices as this
    one's (``make_hybrid_mesh`` checks that they agree).
    """
    wants_cluster = coordinator_address is not None or (
        num_processes is not None and num_processes > 1
    )
    if wants_cluster and not is_initialized():
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "a multi-process bring-up needs coordinator_address, "
                "num_processes and process_id: nothing on the machine "
                "names them"
            )
        kwargs.setdefault("timeout", timedelta(seconds=DEFAULT_TIMEOUT_S))
        torch.distributed.init_process_group(
            backend="gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes),
            rank=int(process_id),
            **kwargs,
        )
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": local,
        "global_devices": local * process_count(),
    }


def make_hybrid_mesh(
    ici_shape: Optional[tuple] = None,
    num_granules: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build the (markets, sources) mesh with the granule dimension
    outermost on the markets axis.

    *devices* are THIS process's devices (default: every CUDA card,
    raising without CUDA); *ici_shape* lays each granule out as
    (markets, sources), by default every granule device on markets. In a
    group of several processes every process is one granule, in rank
    order: the devices of all of them are exchanged with
    ``all_gather_object`` (every process must pass the same count), and
    the mesh records which process owns each markets row, so each
    process runs only its own rows. In one process *num_granules*
    (default 1) splits *devices* into that many granules, all local.
    """
    # make_mesh resolves and checks the devices (and names every card).
    local = make_mesh() if devices is None else make_mesh(
        (len(devices), 1), devices)
    local = [row[0] for row in local.devices]
    count = process_count()
    if count > 1:
        if num_granules not in (None, count):
            raise ValueError(
                f"num_granules={num_granules}: a group of {count} processes "
                "is one granule per process"
            )
        gathered = [None] * count
        torch.distributed.all_gather_object(gathered, [str(d) for d in local])
        sizes = {len(names) for names in gathered}
        if len(sizes) != 1:
            raise ValueError(
                f"processes hold different device counts: {gathered}"
            )
        granules = [[torch.device(name) for name in names]
                    for names in gathered]
    else:
        num_granules = 1 if num_granules is None else int(num_granules)
        if len(local) % num_granules:
            raise ValueError(
                f"{len(local)} devices do not split over {num_granules} "
                "granules"
            )
        width = len(local) // num_granules
        granules = [local[g * width:(g + 1) * width]
                    for g in range(num_granules)]
    per_granule = len(granules[0])
    if ici_shape is None:
        ici_shape = (per_granule, 1)
    m_ici, s_ici = ici_shape
    if m_ici * s_ici != per_granule:
        raise ValueError(
            f"ici_shape {ici_shape} needs {m_ici * s_ici} devices per granule, "
            f"have {per_granule} ({per_granule * len(granules)} over "
            f"{len(granules)} granules)"
        )
    rows, owners = [], []
    for granule, members in enumerate(granules):
        grid = tuple(
            tuple(members[i * s_ici + j] for j in range(s_ici))
            for i in range(m_ici)
        )
        rows.extend(grid)
        owners.extend([granule if count > 1 else 0] * m_ici)
    return Mesh(tuple(rows), tuple(owners))


def process_market_rows(num_markets: int, mesh: Mesh) -> tuple:
    """[start, stop) of the global markets axis owned by this process.

    With the granule-outer layout each process owns one contiguous band of
    market rows: the slice its ingest should produce. ``num_markets`` must
    divide evenly over the markets axis.
    """
    m_size = mesh.shape[MARKETS_AXIS]
    if num_markets % m_size:
        raise ValueError(
            f"{num_markets} markets do not divide over {m_size} markets "
            "shards — pad the axis first"
        )
    width = num_markets // m_size
    me = process_index()
    return _band_from_intervals({
        (row * width, (row + 1) * width)
        for row in range(m_size) if mesh.owner_of(row) == me
    })


def _band_from_intervals(intervals: set) -> tuple:
    """Collapse a process's row intervals to [lo, hi), proving they tile it.

    The band is only meaningful if the intervals exactly tile it: a
    min/max hull over interleaved rows would claim rows another process
    owns, and the blocks would be fed the wrong data.
    """
    if not intervals:
        raise ValueError("this process owns no devices in the mesh")
    ordered = sorted(intervals)
    for (_, prev_stop), (start, _) in zip(ordered, ordered[1:]):
        if start != prev_stop:
            raise ValueError(
                f"this process's market rows are not contiguous (intervals "
                f"{ordered}); rebuild the mesh with make_hybrid_mesh so "
                "each process owns one band"
            )
    return ordered[0][0], ordered[-1][1]


def _local_band(width: int, mesh: Mesh, num_markets: int, what: str) -> Mesh:
    """This process's rows of *mesh*, after checking that *width* local
    markets are exactly its band."""
    lo, hi = process_market_rows(num_markets, mesh)
    if width != hi - lo:
        raise ValueError(
            f"local {what} {width} != this process's band [{lo}, {hi})"
        )
    return mesh.local(process_index())


def global_slot_block(local_cols, mesh: Mesh, num_markets: int, dtype=None):
    """This process's shards (``shard_slot_block`` of its rows of the mesh)
    of a slot-major (K, num_markets) block, given as its band of market
    COLUMNS at full K height, as a grid of tensors (of *dtype*, if given).
    In one process, the whole block."""
    local_cols = np.asarray(local_cols)
    local = _local_band(local_cols.shape[1], mesh, num_markets, "columns")
    return shard_slot_block(local_cols, local, dtype=dtype)


def global_block(local_rows, mesh: Mesh, num_markets: int, dtype=None):
    """This process's shards of a market-major (num_markets, K) block, given
    as its band of market ROWS at full K width (``P(markets, sources)``)."""
    local_rows = np.asarray(local_rows)
    local = _local_band(local_rows.shape[0], mesh, num_markets, "rows")
    return shard_block(local_rows, local, dtype=dtype)


def global_market(local_rows, mesh: Mesh, num_markets: int):
    """This process's pieces of a per-market (num_markets,) vector, given
    as its band, on its rows of the mesh (replicated over sources)."""
    local_rows = np.asarray(local_rows)
    local = _local_band(local_rows.shape[0], mesh, num_markets, "markets")
    return shard_market_vector(local_rows, local)


def local_view(grid, slot_major: bool = False) -> np.ndarray:
    """This process's rows of a markets-sharded grid, in global row order,
    as a host array: the inverse of :func:`global_market` (a grid of 1-D
    pieces), :func:`global_block` (market-major blocks) or, with
    ``slot_major=True``, :func:`global_slot_block`."""
    if not grid or not grid[0]:
        raise ValueError("this process holds no shards of the array")
    if grid[0][0].dim() == 1:
        return torch.cat([row[0].cpu() for row in grid]).numpy()
    join = unshard_slot_block if slot_major else unshard_block
    return join(grid, torch.device("cpu")).numpy()
