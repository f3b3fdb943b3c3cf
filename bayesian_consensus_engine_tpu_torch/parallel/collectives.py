"""Collectives over the shards of one mesh axis, in one process.

The JAX package takes these from ``jax.lax`` inside ``shard_map``; here a
sharded value is a list of per-shard tensors in mesh order along the axis,
and a collective returns its result on one device (the merge runs once per
markets shard, on its sources shard 0; every sources shard would compute
the same bits). Copies between devices move bytes as they are: no cast, no
bit changes.

The sum order is part of the contract: :func:`psum` adds the shards left
to right in mesh order, ``((x0 + x1) + x2) + …``, which is the order XLA's
CPU all-reduce uses (pinned against ``jax.lax.psum`` under ``shard_map`` on
4 and 8 devices by ``tests/test_torch_partials.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch


def all_gather(pieces: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards stacked in mesh order on *device*: ``(S, *shape)``."""
    return torch.stack([piece.to(device) for piece in pieces])


def psum(pieces: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The elementwise sum of the shards on *device*, added left to right
    in mesh order."""
    total = pieces[0].to(device)
    for piece in pieces[1:]:
        total = total + piece.to(device)
    return total
