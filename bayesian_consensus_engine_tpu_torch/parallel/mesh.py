"""Device mesh for the (markets × sources) workload — the torch twin of
``parallel/mesh.py``.

The mesh has two logical axes:

  * ``markets`` — data parallelism: each markets shard settles its own
    columns of the slot-major (K, M) block, with no communication;
  * ``sources`` — splits each market's K slots: the per-market sums
    (consensus, band moments, tie-break groups) are merged across the
    shards of this axis (``ops/collectives.py``).

A :class:`Mesh` is a (markets, sources) grid of ``torch.device``. A device
may appear more than once, so one card can hold a (1, 4) mesh: each shard
is then its own block on that card, and every per-shard kernel launch and
every merge runs as it would across cards. Where a host has several cards
the same code puts one shard on each.

The JAX package places a global array on the mesh through a
``NamedSharding``; here a sharded block is a grid of per-shard tensors,
``blocks[i][j]`` for mesh position (markets shard i, sources shard j):
:func:`shard_slot_block` cuts a (K, M) array into contiguous slot rows
(over sources) and market columns (over markets), ``P(sources,
markets)``, and :func:`unshard_slot_block` puts the pieces back together
in that fixed order.

A mesh spread over several processes (``parallel/distributed.py::
make_hybrid_mesh``) also records which process owns each markets row of
the grid, its ``owners``: each process holds and runs only its own rows
(:meth:`Mesh.local`), as a JAX process holds only its addressable shards.
A mesh that :func:`make_mesh` builds is all the building process's, on
every rank of a group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.utils.device import resolve_device

MARKETS_AXIS = "markets"
SOURCES_AXIS = "sources"


def is_initialized() -> bool:
    """True when this process has joined a ``torch.distributed`` group."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return torch.distributed.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The group's process count (1 outside a group)."""
    return torch.distributed.get_world_size() if is_initialized() else 1


@dataclass(frozen=True)
class Mesh:
    """A (markets, sources) grid of devices, one device type throughout.

    ``owners`` names the process that owns each markets row (the granule
    of a hybrid mesh, in rank order); ``None`` means every row is the
    process's that uses the mesh, as on a mesh :func:`make_mesh` builds,
    whatever that process's rank."""

    devices: tuple  # tuple of rows (one per markets shard) of torch.device
    owners: Optional[tuple] = None  # process index per markets row

    def __post_init__(self) -> None:
        if self.owners is not None:
            owners = tuple(int(o) for o in self.owners)
            if len(owners) != len(self.devices):
                raise ValueError(
                    f"{len(owners)} owners for {len(self.devices)} markets rows"
                )
            # A mesh whose every row is this process's is a local mesh,
            # and compares and hashes as make_mesh's does.
            object.__setattr__(
                self, "owners",
                None if set(owners) == {process_index()} else owners,
            )

    def owner_of(self, row: int) -> int:
        """The process that owns markets row *row* (this process, on a
        local mesh)."""
        return process_index() if self.owners is None else self.owners[row]

    def local(self, process: int) -> "Mesh":
        """The rows of the grid that *process* owns, as a mesh of its own
        (the whole mesh when it is a local mesh: every row is the
        caller's)."""
        if self.owners is None:
            return self
        rows = tuple(
            row for row, owner in zip(self.devices, self.owners)
            if owner == process
        )
        if not rows:
            raise ValueError(f"process {process} owns no row of {self!r}")
        return Mesh(rows)

    @property
    def shape(self) -> dict:
        """Axis sizes keyed by axis name, as ``jax.sharding.Mesh.shape``."""
        return {
            MARKETS_AXIS: len(self.devices),
            SOURCES_AXIS: len(self.devices[0]),
        }

    def __repr__(self) -> str:
        names = [[str(d) for d in row] for row in self.devices]
        owners = "" if self.owners is None else f", owners={list(self.owners)}"
        return (f"Mesh({self.shape[MARKETS_AXIS]}x{self.shape[SOURCES_AXIS]}, "
                f"{names}{owners})")


def make_mesh(
    shape: Optional[tuple] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(markets, sources)`` mesh over *devices*.

    ``devices=None`` means every visible CUDA card (and raises without
    CUDA; nothing falls back to the CPU). ``shape=None`` puts every device
    on the markets axis, ``(n, 1)``. A device may be listed more than
    once: ``make_mesh((1, 4), [torch.device("cuda:0")] * 4)`` is a
    sources-sharded mesh on one card, ``[torch.device("cpu")] * 4`` one on
    the CPU.
    """
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(resolve_device(d)) for d in devices]
    if shape is None:
        shape = (len(devices), 1)
    m_size, s_size = shape
    if m_size * s_size != len(devices):
        raise ValueError(
            f"mesh shape {shape} needs {m_size * s_size} devices, have {len(devices)}"
        )
    if len({d.type for d in devices}) != 1:
        raise ValueError(
            f"a mesh holds devices of one type; got {[str(d) for d in devices]}"
        )
    grid = tuple(
        tuple(devices[i * s_size + j] for j in range(s_size)) for i in range(m_size)
    )
    return Mesh(grid)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the card it stands for (``cuda:<current>``), so that a
    mesh device compares equal to the device of a tensor made on it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_slot_block(array, mesh: Mesh, dtype=None) -> tuple:
    """Cut a global slot-major (K, M) array into the mesh's per-shard
    tensors: ``blocks[i][j]`` holds slot rows ``j·K/S … (j+1)·K/S`` and
    market columns ``i·M/Mk … (i+1)·M/Mk`` on ``mesh.devices[i][j]``, as a
    contiguous copy (of *dtype*, if given). K and M must divide evenly."""
    array = np.asarray(array)
    num_slots, num_markets = array.shape
    m_size, s_size = mesh.shape[MARKETS_AXIS], mesh.shape[SOURCES_AXIS]
    if num_slots % s_size or num_markets % m_size:
        raise ValueError(
            f"a ({num_slots}, {num_markets}) block does not divide over a "
            f"({m_size}, {s_size}) mesh — pad it first"
        )
    k_loc, m_loc = num_slots // s_size, num_markets // m_size
    return tuple(
        tuple(
            torch.tensor(
                array[j * k_loc:(j + 1) * k_loc, i * m_loc:(i + 1) * m_loc],
                dtype=dtype, device=mesh.devices[i][j],
            )
            for j in range(s_size)
        )
        for i in range(m_size)
    )


def unshard_slot_block(blocks, device=None) -> torch.Tensor:
    """The global (K, M) tensor of a grid of per-shard blocks, on *device*
    (default: shard (0, 0)'s): slot rows in sources order within each
    markets shard, market columns in markets order. A (1, 1) grid's one
    block is returned as it is, not copied."""
    device = blocks[0][0].device if device is None else device
    if len(blocks) == 1 and len(blocks[0]) == 1:
        return blocks[0][0].to(device)
    columns = [
        torch.cat([piece.to(device) for piece in row], dim=0) for row in blocks
    ]
    return torch.cat(columns, dim=1)


def shard_market_vector(vector, mesh: Mesh) -> tuple:
    """A per-market (M,) vector on every shard: ``pieces[i][j]`` is markets
    shard i's columns on ``mesh.devices[i][j]`` (replicated over sources)."""
    vector = np.asarray(vector)
    m_size = mesh.shape[MARKETS_AXIS]
    if vector.shape[0] % m_size:
        raise ValueError(
            f"{vector.shape[0]} markets do not divide over {m_size} markets shards"
        )
    m_loc = vector.shape[0] // m_size
    return tuple(
        tuple(
            torch.tensor(vector[i * m_loc:(i + 1) * m_loc], device=d)
            for d in row
        )
        for i, row in enumerate(mesh.devices)
    )


def shard_block(array, mesh: Mesh, dtype=None) -> tuple:
    """Cut a global market-major (M, K) array (numpy, or a tensor on any
    device) into the mesh's per-shard tensors, ``P(markets, sources)`` as
    the JAX package's ``shard_block`` places it: ``blocks[i][j]`` holds
    market rows ``i·M/Mk … (i+1)·M/Mk`` and slot columns ``j·K/S …
    (j+1)·K/S`` on ``mesh.devices[i][j]``, as a contiguous copy (of
    *dtype*, if given). M and K must divide evenly."""
    if not isinstance(array, torch.Tensor):
        array = torch.as_tensor(np.asarray(array))
    num_markets, num_slots = array.shape
    m_size, s_size = mesh.shape[MARKETS_AXIS], mesh.shape[SOURCES_AXIS]
    if num_markets % m_size or num_slots % s_size:
        raise ValueError(
            f"a ({num_markets}, {num_slots}) block does not divide over a "
            f"({m_size}, {s_size}) mesh — pad it first"
        )
    m_loc, k_loc = num_markets // m_size, num_slots // s_size
    return tuple(
        tuple(
            array[i * m_loc:(i + 1) * m_loc, j * k_loc:(j + 1) * k_loc]
            .to(device=mesh.devices[i][j], dtype=dtype)
            .clone(memory_format=torch.contiguous_format)
            for j in range(s_size)
        )
        for i in range(m_size)
    )


def unshard_block(blocks, device=None) -> torch.Tensor:
    """The global market-major (M, K) tensor of a grid of per-shard blocks
    cut by :func:`shard_block`, on *device* (default: shard (0, 0)'s)."""
    return unshard_slot_block(
        tuple(tuple(block.T for block in row) for row in blocks), device
    ).T.contiguous()
