"""Analytics surfaces one level above the band math — the port of
``analytics/bands.py``.

* :func:`build_band_program` — the STANDALONE band program: credible
  intervals from a session-layout grid of slot-major (K, M) blocks and a
  resident ``MarketBlockState``, read at a given ``now`` with the same
  decayed reliabilities the consensus weighs with, without touching the
  state. It is the two-program shape the fused resident session
  (``ShardedSettlementSession.settle_with_analytics``) exists to beat.
* :class:`AnalyticsOptions` — the one bag of analytics knobs the session
  entry, the serve driver and ``ConsensusService(analytics=...)`` accept.

The ``chunk_slots="auto"`` tuner needs ``utils/autotune.py``'s
``ShapeTuner``, which ROADMAP queue 1 item 10 ports; until then
``build_band_program`` refuses ``"auto"`` and the session entry refuses
it as any string but ``"default"``. ``graph`` (an
``analytics.MarketGraph``), ``inference`` (an ``infer.InferenceOptions``)
and ``blocks`` (an ``infer.MarketBlocks``) run the belief sweep after the
settle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
from bayesian_consensus_engine_tpu_torch.ops.partials_kernel import onepass_partials
from bayesian_consensus_engine_tpu_torch.ops.uncertainty import (
    UncertaintyBands,
    Z_95,
    band_epilogue,
    band_merge,
)
from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
    MARKETS_AXIS,
    SOURCES_AXIS,
    Mesh,
    make_mesh,
)


@dataclass(frozen=True)
class AnalyticsOptions:
    """Per-call analytics configuration of the session entry.

    ``chunk_slots``/``chunk_agents`` take an int, ``None`` (unchunked) or
    ``"default"`` (the recorded defaults); no result depends on them.
    ``tiebreak=False`` drops the tie-break stage (its slot returns
    ``None``), ``tiebreak="sorted"`` swaps the ring fold for the
    sort-based grouping; ``z`` scales the credible interval (default
    two-sided 95%); ``precision`` is the tie-break's quantisation in
    decimals. ``kernel`` and ``sweep_kernel`` take the JAX package's route
    names (``"xla"``, ``"pallas"``, ``"auto"``); on CUDA every accepted
    value runs the port's one-pass kernel, and every accepted
    ``sweep_kernel`` the ``bp_sweep`` kernel. ``graph``, ``inference`` and
    ``blocks`` are typed loosely, as in the JAX package; the session
    checks them.
    """

    z: float = Z_95
    chunk_slots: "int | str | None" = "default"
    chunk_agents: "int | str | None" = "default"
    graph: Optional[object] = None
    precision: int = 6
    tiebreak: "bool | str" = True
    kernel: str = "xla"
    sweep_kernel: str = "xla"
    inference: Optional[object] = None
    blocks: Optional[object] = None


def build_band_program(mesh=None, z: float = Z_95,
                       chunk_slots: "int | str | None" = None):
    """Standalone band program over a resident state block.

    ``bands(probs, mask, state, now) -> UncertaintyBands`` on a *mesh*
    (a port ``Mesh``; a device, or ``None`` for CUDA, names its (1, 1)
    mesh) takes the session layout: grids ``probs[i][j]``, ``mask[i][j]``
    and ``state[i][j]`` of slot-major (K_loc, M_loc) blocks, as
    ``parallel.mesh.shard_slot_block`` cuts them, and returns every
    per-market output whole on the mesh's first device. ``now`` is the
    read day relative to the state's epoch: the weights are the decayed
    reliabilities the consensus would weigh with at that instant (cold
    slots read the cold-start prior; a state whose ``exists`` is ``None``
    promises cold slots already hold it).

    Each sources shard runs one zero-step launch of the partials kernel
    (``ops/partials_kernel.py``: its band-tree roots and count, the views
    off, the state left alone), and each markets shard folds its sources
    shards' roots with ``band_merge`` before ``band_epilogue``; on the CPU
    the kernel's plain version runs. ``chunk_slots`` takes ``None``
    (unchunked) or an int, clamped to a power of two; no output depends
    on it. ``"auto"`` needs the shape tuner of ROADMAP queue 1 item 10 and
    raises ``NotImplementedError``; any other string raises
    ``ValueError``, as in the JAX package. The JAX package's program also
    exposes ``.lower`` for ahead-of-time memory captures; the port has no
    ahead-of-time compile, so it has none.
    """
    if not isinstance(mesh, Mesh):
        mesh = make_mesh((1, 1), [mesh])
    first = mesh.devices[0][0]
    n_sources = mesh.shape[SOURCES_AXIS]

    def resolve():
        if chunk_slots == "auto":
            raise NotImplementedError(
                "chunk_slots='auto' (the band chunk tuner, which needs "
                "utils/autotune.py's ShapeTuner) is not ported yet: ROADMAP "
                "queue 1 item 10"
            )
        if isinstance(chunk_slots, str):
            raise ValueError(
                f"chunk_slots={chunk_slots!r}: the only supported string "
                "is 'auto'"
            )
        return chunk_slots

    def shard_roots(probs, mask, state, now):
        exists = state.exists
        if exists is None:
            # Cold slots already hold the prior: every slot reads as one
            # that exists, which is read_phase's exists=None branch.
            exists = torch.ones_like(mask)
        shard_state = MarketBlockState(
            state.reliability, state.confidence, state.updated_days, exists
        )
        idle = torch.zeros(probs.shape[1], dtype=torch.bool, device=probs.device)
        part = onepass_partials(
            probs, mask, idle, shard_state, now, 0, with_views=False,
            with_bands=True, chunk_slots=resolve(),
        )
        return part.band_sums, part.band_count

    def bands(probs, mask, state, now) -> UncertaintyBands:
        now = float(now)
        sums, counts = [], []
        for i in range(mesh.shape[MARKETS_AXIS]):
            roots = [
                shard_roots(probs[i][j], mask[i][j], state[i][j], now)
                for j in range(n_sources)
            ]
            shard_sums, shard_count = band_merge(
                [r[0] for r in roots], [r[1] for r in roots],
                mesh.devices[i][0],
            )
            sums.append(shard_sums.to(first))
            counts.append(shard_count.to(first))
        return band_epilogue(torch.cat(sums, dim=-1), torch.cat(counts), z)

    return bands
