"""Deterministic epoch-tagged mesh views over the market-sharded cluster —
the torch twin of the JAX package's ``cluster/membership.py``.

The cluster's one invariant is *agreement without a coordinator*: every
host must lay the global markets axis out identically — which host owns
which band, at which mesh factorisation — or the per-band plans, journals
and stores stop composing. Rather than electing anything, the layout is a
**pure function of the membership epoch's host set**: :class:`MeshView`
derives the canonical factorisation from the sorted host ids alone, so N
hosts that agree on "epoch 7 = hosts {0, 2, 3}" agree on everything else
by construction. A membership change (host loss, host return) is an epoch
bump producing a new view — the *degraded* view is just
:meth:`MeshView.degraded` over the surviving subset, computed identically
by every survivor.

Two deployment shapes read the same view:

* **hybrid multi-process** — one ``torch.distributed`` group over all
  hosts (:func:`~.parallel.distributed.make_hybrid_mesh`, granule-outer
  markets): :meth:`MeshView.build_mesh` reproduces exactly that mesh, and
  :meth:`MeshView.band` reproduces :func:`~.parallel.distributed.
  process_market_rows`'s contiguous per-host band, because both order
  granules by sorted host id (rank).
* **shared-nothing banded** — each host runs its OWN local mesh over its
  own devices and settles only its band's markets (the view is the
  agreement on *which* markets those are). The cycle needs no
  cross-market communication, so the two shapes compute the same
  numbers; shared-nothing is the posture the kill soak
  (``cluster/soak.py``) proves recovery under.

Epochs are small integers, strictly increasing across membership changes
within one service lifetime; journals and soak logs carry
:attr:`MeshView.fingerprint` so a replayed artifact names the membership
it was written under. The fingerprint bytes are the JAX package's.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class MeshView:
    """One membership epoch's canonical layout over *hosts*.

    ``hosts`` is the set of member host ids (any hashable ints — process
    ranks of a multi-process group, worker ranks in the shared-nothing
    shape), stored sorted so equal sets compare equal. ``devices_per_host`` and
    ``ici_shape`` describe the per-host (per-granule) device layout;
    ``ici_shape=None`` defaults to all in-host devices on the markets
    axis (mesh.py's default policy — reductions stay device-local).

    The view is immutable and hashable: two hosts holding equal views
    ARE in agreement, and a view is safe to use as a cache/compile key.
    """

    epoch: int
    hosts: Tuple[int, ...]
    devices_per_host: int = 1
    ici_shape: Optional[Tuple[int, int]] = None

    def __post_init__(self) -> None:
        if self.epoch < 0:
            raise ValueError(f"epoch must be >= 0; got {self.epoch}")
        hosts = tuple(sorted(int(h) for h in self.hosts))
        if not hosts:
            raise ValueError("a membership view needs at least one host")
        if len(set(hosts)) != len(hosts):
            raise ValueError(f"duplicate host ids in {self.hosts!r}")
        object.__setattr__(self, "hosts", hosts)
        if self.devices_per_host < 1:
            raise ValueError("devices_per_host must be >= 1")
        ici = self.ici_shape
        if ici is None:
            ici = (self.devices_per_host, 1)
        else:
            ici = (int(ici[0]), int(ici[1]))
        if ici[0] * ici[1] != self.devices_per_host:
            raise ValueError(
                f"ici_shape {ici} needs {ici[0] * ici[1]} devices per "
                f"host, declared {self.devices_per_host}"
            )
        object.__setattr__(self, "ici_shape", ici)

    # -- derived layout ------------------------------------------------------

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    @property
    def markets_extent(self) -> int:
        """Global markets-axis device extent (granules × ICI markets)."""
        return self.num_hosts * self.ici_shape[0]

    @property
    def sources_extent(self) -> int:
        return self.ici_shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        """The (markets, sources) mesh shape this view factorises to."""
        return (self.markets_extent, self.sources_extent)

    def rank_of(self, host: int) -> int:
        """This host's position in the sorted member list (= its granule
        index in the hybrid mesh's granule-major device order)."""
        try:
            return self.hosts.index(int(host))
        except ValueError:
            raise ValueError(
                f"host {host} is not a member of epoch {self.epoch} "
                f"(hosts {self.hosts})"
            ) from None

    def padded_markets(self, global_markets: int) -> int:
        """*global_markets* padded up to the markets-axis extent."""
        extent = self.markets_extent
        return -(-max(int(global_markets), 1) // extent) * extent

    def band(self, host: int, global_markets: int) -> Tuple[int, int]:
        """*host*'s ``(lo, global_markets)`` band of the markets axis.

        The contiguous padded-row band the host feeds and absorbs —
        the exact tuple :func:`~.pipeline.settle_stream`'s ``band=``
        takes, and (on the hybrid mesh) the same rows
        :func:`~.parallel.distributed.process_market_rows` assigns,
        because both lay granules out in sorted-host order.
        """
        padded = self.padded_markets(global_markets)
        width = padded // self.num_hosts
        return (self.rank_of(host) * width, int(global_markets))

    def owned_markets(self, host: int, global_markets: int) -> range:
        """The LIVE (unpadded) market rows *host* owns — its ingest shard."""
        lo, _ = self.band(host, global_markets)
        padded = self.padded_markets(global_markets)
        hi = lo + padded // self.num_hosts
        return range(min(lo, int(global_markets)), min(hi, int(global_markets)))

    # -- membership changes --------------------------------------------------

    def degraded(self, surviving: Sequence[int]) -> "MeshView":
        """The next epoch's view over a surviving subset of this one.

        Every survivor computes the same degraded view from the same
        (epoch, survivor-set) observation — the coordinator-free
        agreement this module exists for. The failed hosts' market rows
        re-band across the survivors; their state re-enters through
        journal replay (:mod:`~.cluster.recover`), never through the
        dead hosts.
        """
        survivors = tuple(sorted(int(h) for h in surviving))
        if not survivors:
            raise ValueError("cannot degrade to an empty host set")
        missing = set(survivors) - set(self.hosts)
        if missing:
            raise ValueError(
                f"surviving hosts {sorted(missing)} are not members of "
                f"epoch {self.epoch} (hosts {self.hosts})"
            )
        return MeshView(
            epoch=self.epoch + 1,
            hosts=survivors,
            devices_per_host=self.devices_per_host,
            ici_shape=self.ici_shape,
        )

    @property
    def fingerprint(self) -> bytes:
        """Order-sensitive digest of the view — the membership identity a
        journal, ledger record, or soak log carries. Length-delimited
        (the topology_fingerprint discipline): distinct views can never
        collide by concatenation."""
        h = hashlib.blake2b(digest_size=16)
        for value in (
            self.epoch, self.num_hosts, self.devices_per_host,
            *self.ici_shape, *self.hosts,
        ):
            raw = str(int(value)).encode()
            h.update(len(raw).to_bytes(4, "little"))
            h.update(raw)
        return h.digest()

    # -- mesh construction ---------------------------------------------------

    def build_mesh(self, devices=None):
        """The :class:`~.parallel.mesh.Mesh` this view factorises to, for
        THIS process.

        A multi-host view on a multi-process runtime gets the hybrid
        granule-outer mesh (:func:`~.parallel.distributed.make_hybrid_mesh`
        with one granule per member, rank order — the order :meth:`band`
        assumes). A one-host view (including every shared-nothing worker,
        whose cluster identity lives in the view rather than in a shared
        runtime) gets the plain local mesh over its own devices: its
        ``devices_per_host`` CUDA cards, or the caller's *devices* (such
        as ``[torch.device("cpu")] * n``; a device may repeat).
        """
        if self.num_hosts == 1:
            import torch

            from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
                make_mesh,
            )
            from bayesian_consensus_engine_tpu_torch.utils.device import (
                resolve_device,
            )

            if devices is None:
                resolve_device(None)  # raises without CUDA
                devices = [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
                devices = devices[: self.devices_per_host]
            return make_mesh(self.ici_shape, devices)
        from bayesian_consensus_engine_tpu_torch.parallel.distributed import (
            make_hybrid_mesh,
        )

        return make_hybrid_mesh(
            ici_shape=self.ici_shape,
            num_granules=self.num_hosts,
            devices=devices,
        )


def runtime_view(epoch: int = 0) -> MeshView:
    """The view of the CURRENT multi-process runtime, epoch-tagged.

    Reads the group's size from ``torch.distributed`` when a group is
    initialised (one host otherwise; call after :func:`~.parallel.
    distributed.init_distributed`) and this process's CUDA card count for
    ``devices_per_host`` (at least 1: a CPU process is one device), and
    returns the view every process derives identically: hosts = the
    ranks, one granule each.
    """
    import torch

    from bayesian_consensus_engine_tpu_torch.parallel.distributed import (
        process_count,
    )

    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return MeshView(
        epoch=epoch,
        hosts=tuple(range(process_count())),
        devices_per_host=max(local, 1),
    )
