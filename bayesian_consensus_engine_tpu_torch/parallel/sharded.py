"""The fused settle loop over a resident slot-major block, on one card or
on a ``(markets, sources)`` mesh — the torch twin of ``parallel/sharded.py``.

:func:`build_cycle_analytics_loop` returns ``loop(probs, mask, outcome,
state, now0, steps[, neighbor_idx, neighbor_w]) -> (state', consensus,
tiebreak | None, bands | None, propagated | None)``: ``steps`` settle
cycles plus, read from the state at ``now0`` before the cycles update it,
the ring tie-break and the uncertainty bands, and then, with
``sweep_steps > 0``, the belief sweep over the market graph seeded with
the last step's consensus (and the band variance on the moments lane). A
disabled stage returns ``None``.

The loop runs on a :class:`~.parallel.mesh.Mesh`; a device (or ``None``,
CUDA) names the (1, 1) mesh of that device, the one-card session. It
takes grids of per-shard blocks (``blocks[i][j]``, as
``parallel/mesh.shard_slot_block`` cuts them) and a grid of per-shard
outcome vectors, and returns the state as such a grid and every
per-market output whole, on the mesh's first device. Per markets shard:

* one sources shard: one launch of the one-pass kernel
  (``ops/onepass_kernel.py``); with the sorted tie-break, one launch of
  the partials kernel instead, whose read views feed
  ``ops/tiebreak.py::batched_tiebreak`` (eager, as the JAX package runs
  it in XLA), its consensus sums and band roots the one-shard merge;
* more: one launch of the partials kernel (``ops/partials_kernel.py``) per
  sources shard, then the merge in eager PyTorch on the markets shard's
  first device, as the JAX package's ``onepass_partials_math`` runs it:
  the sharded ring tie-break over every shard's read views, ``band_merge``
  + ``band_epilogue``, and the consensus psums + epilogue
  (``consensus_merge``). A disabled stage skips its merge. The state needs
  no merge: the update never reads the consensus.

Zero steps on a sources-sharded mesh: the reference refuses
``kernel="pallas"`` there (its kernel cannot emit a zero-step consensus as
raw sums) and serves ``"xla"`` and ``"auto"`` through its XLA program,
which returns a zero consensus. The port keeps the refusal and serves the
others with the partials kernel's zero-step mode (views, band roots and
count written, the state left alone); the loop writes the zero consensus.

With a graph, the sweep runs ``bp_sweep`` (``ops/bp_kernel.py``) once on
the merged consensus. With several markets shards that is the JAX
package's kernel route (``kernel_sweep``): the shards' consensus, band
variances and aligned neighbour blocks are gathered in mesh order onto
the mesh's first device (the consensus as every per-market output is;
the blocks already live there, over the padded global markets axis they
index), one sweep runs over the whole axis, and its means and stderrs are
returned whole beside the other per-market outputs. The reference runs
that sweep redundantly on every shard and slices each shard's rows back
out; every copy computes the same bits, so one launch a call is enough,
and ``iters_run`` and ``residual`` are the whole axis's, as its replicated
audit pair is (the XLA route's residual is a ``pmax`` over the shards). On
the CPU every kernel's plain version runs.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.ops.bp_kernel import bp_sweep
from bayesian_consensus_engine_tpu_torch.ops.collectives import psum
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import (
    CycleParams,
    CycleResult,
    MarketBlockState,
    consensus_epilogue,
    consensus_merge,
    consensus_reduce,
    make_loop_math,
    read_phase,
    run_fast_loop,
    update_phase,
)
from bayesian_consensus_engine_tpu_torch.ops.fma import fma
from bayesian_consensus_engine_tpu_torch.ops.onepass_kernel import onepass_settle
from bayesian_consensus_engine_tpu_torch.ops.partials_kernel import onepass_partials
from bayesian_consensus_engine_tpu_torch.ops.propagate import (
    PropagatedBeliefs,
    propagated_stderr,
)
from bayesian_consensus_engine_tpu_torch.ops.settle_kernel import (
    lane_params,
    settle_cycles_lanes,
)
from bayesian_consensus_engine_tpu_torch.ops.tiebreak import (
    RingTieBreakResult,
    batched_tiebreak,
    ring_tiebreak_math,
)
from bayesian_consensus_engine_tpu_torch.ops.uncertainty import (
    Z_95,
    band_epilogue,
    band_merge,
    band_sums,
)
from bayesian_consensus_engine_tpu_torch.parallel.mesh import (
    MARKETS_AXIS,
    SOURCES_AXIS,
    Mesh,
    make_mesh,
    unshard_slot_block,
)
from bayesian_consensus_engine_tpu_torch.utils.config import (
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
)
from bayesian_consensus_engine_tpu_torch.utils.device import resolve_device

__all__ = [
    # re-exports from ops/cycle_math.py, as the JAX package's module has
    "CycleParams",
    "CycleResult",
    "MarketBlockState",
    "consensus_epilogue",
    "consensus_reduce",
    "make_loop_math",
    "read_phase",
    "run_fast_loop",
    "update_phase",
    # mesh-level builders
    "build_cycle",
    "build_cycle_loop",
    "build_cycle_tiebreak_loop",
    "build_cycle_analytics_loop",
    "build_replay_sweep_step",
    "relayout_slot_state",
    "pad_markets",
    "init_block_state",
]


def build_cycle_analytics_loop(
    mesh=None,
    chunk_agents: "int | None" = None,
    chunk_slots: "int | None" = None,
    precision: int = 6,
    z: float = Z_95,
    damping: float = 0.5,
    sweep_steps: int = 0,
    sweep_mode: str = "point",
    sweep_tol: "float | None" = None,
    with_tiebreak: bool = True,
    with_bands: bool = True,
    tiebreak_kind: str = "ring",
    kernel: str = "xla",
    sweep_kernel: str = "xla",
):
    """The fused loop: N cycles + optional tie-break + optional bands +
    optional graph sweep, over a :class:`~.parallel.mesh.Mesh` (a device,
    or ``None`` for CUDA, names the (1, 1) mesh of that device).

    The arguments are validated as the JAX package validates them.
    ``sweep_steps > 0`` adds the sweep (damping ``damping``, at most
    ``sweep_steps`` sweeps); the loop then takes the two aligned
    neighbour blocks (``MarketGraph.align``: int32 and float32 (M, D) on
    the mesh's first device).
    ``sweep_mode="point"`` returns the relaxed mean vector; ``"moments"``
    seeds the variance with the band stderr squared (it needs the bands)
    and returns a :class:`PropagatedBeliefs`; ``sweep_tol`` (moments only)
    arms the early exit. ``kernel`` and ``sweep_kernel`` take the route
    names ``"xla"``, ``"pallas"`` and ``"auto"``; ``"pallas"`` with a
    stage off, ``sweep_kernel="pallas"`` with no sweep, and
    ``kernel="pallas"`` with ``steps=0`` on a sources-sharded mesh are
    refused, as there. The port has one route per stage: on CUDA every
    accepted ``kernel`` runs the one-pass kernel (the partials kernel on a
    sources-sharded mesh) and every accepted ``sweep_kernel`` the
    ``bp_sweep`` kernel. ``tiebreak_kind="sorted"`` (refused on a
    sources-sharded mesh, as there) runs the partials kernel on the one
    sources shard and :func:`~.ops.tiebreak.batched_tiebreak` over its
    read views; empty rows take its NaN/0 convention. On a mesh with
    several markets shards the sweep runs once over the gathered axis
    (module docstring).
    """
    mesh = _grid_mesh(mesh)
    device = mesh.devices[0][0]
    n_sources = mesh.shape[SOURCES_AXIS]
    n_market_shards = mesh.shape[MARKETS_AXIS]
    with_graph = sweep_steps > 0
    if sweep_mode not in ("point", "moments"):
        raise ValueError(
            f"sweep_mode={sweep_mode!r}: 'point' (the legacy damped "
            "relaxation) or 'moments' (precision-weighted belief "
            "propagation over (mean, variance) pairs)"
        )
    if sweep_tol is not None and sweep_mode != "moments":
        raise ValueError(
            "sweep_tol (the adaptive early-exit) rides the moments "
            "sweep — build with sweep_mode='moments'"
        )
    if sweep_tol is not None and not sweep_tol > 0:
        raise ValueError(
            f"sweep_tol={sweep_tol!r}: a positive residual tolerance, "
            "or None for the fixed-depth sweep"
        )
    moments_sweep = with_graph and sweep_mode == "moments"
    if moments_sweep and not with_bands:
        raise ValueError(
            "sweep_mode='moments' seeds each market's variance from "
            "the band stderr — build with with_bands=True"
        )
    if tiebreak_kind not in ("ring", "sorted"):
        raise ValueError(
            f"tiebreak_kind={tiebreak_kind!r}: 'ring' (the chunked top-2 "
            "fold) or 'sorted' (the sort-based grouping kernel)"
        )
    if kernel not in ("xla", "pallas", "auto"):
        raise ValueError(
            f"kernel={kernel!r}: 'xla' (the multi-pass fused program, the "
            "default), 'pallas' (the one-pass settlement kernel), or "
            "'auto' (the honesty-guarded shape tuner)"
        )
    if sweep_kernel not in ("xla", "pallas", "auto"):
        raise ValueError(
            f"sweep_kernel={sweep_kernel!r}: 'xla' (the while_loop sweep, "
            "the default), 'pallas' (the VMEM-resident BP kernel), or "
            "'auto' (the honesty-guarded shape tuner)"
        )
    if not with_graph and sweep_kernel == "pallas":
        raise ValueError(
            "sweep_kernel='pallas' with sweep_steps=0: there is no graph "
            "sweep to offload — build with sweep_steps > 0"
        )
    if tiebreak_kind == "sorted" and with_tiebreak and n_sources > 1:
        raise ValueError(
            "tiebreak_kind='sorted' needs the full agent row on one "
            "device (row-local sort), but this mesh shards the sources "
            f"axis {n_sources} ways — keep the ring tie-break for "
            "sources-sharded meshes"
        )
    if kernel == "pallas" and (
        not (with_tiebreak and with_bands) or tiebreak_kind != "ring"
    ):
        raise ValueError(
            "kernel='pallas' unavailable: the one-pass kernel IS cycles + "
            "ring tie-break + bands in one sweep; disabling a stage (or "
            "tiebreak_kind='sorted') needs the stage-selective XLA program"
        )
    sorted_tiebreak = with_tiebreak and tiebreak_kind == "sorted"

    def sweep(consensus, bands, neighbor_idx, neighbor_w):
        # The point lane is the reference's damped_sweep_math, which reads
        # no residual: its blend fuses keep·v (ops/propagate.py).
        variances = bands.stderr * bands.stderr if moments_sweep else None
        mean, var, iters, residual = bp_sweep(
            consensus.to(torch.float32), variances, neighbor_idx, neighbor_w,
            damping=damping, max_steps=sweep_steps, tol=sweep_tol,
            keep_fma=True if not moments_sweep else None,
        )
        if not moments_sweep:
            return mean
        return PropagatedBeliefs(mean, propagated_stderr(var), iters, residual)

    def check_graph_args(graph_args):
        if len(graph_args) != (2 if with_graph else 0):
            raise ValueError(
                "the loop takes neighbor_idx and neighbor_w exactly when it "
                f"was built with sweep_steps > 0 (sweep_steps={sweep_steps})"
            )

    def onepass(probs, mask, outcome, state, now0, steps):
        """One shard's one-pass launch: ``(state', consensus, tiebreak,
        band sums, band count)``."""
        out = onepass_settle(
            probs, mask, outcome, state, now0, steps,
            with_tiebreak=with_tiebreak, with_bands=with_bands,
            precision=precision, chunk_agents=chunk_agents,
            chunk_slots=chunk_slots,
        )
        return out.state, out.consensus, out.tiebreak, out.band_sums, out.band_count

    def sorted_settle(probs, mask, outcome, state, now0, steps):
        """The sorted tie-break's route on one sources shard: one partials
        launch (the pre-update views, the band roots and the consensus
        sums), the one-shard merge, and :func:`batched_tiebreak` over the
        views, agents last. Same tuple as :func:`onepass`."""
        part = onepass_partials(
            probs, mask, outcome, state, now0, steps, with_views=True,
            with_bands=with_bands, chunk_slots=chunk_slots,
        )
        device = probs.device
        if steps == 0:
            consensus = torch.zeros(
                probs.shape[1], dtype=probs.dtype, device=device
            )
        else:
            consensus = consensus_merge([part.consensus_sums], device)
        tiebreak = RingTieBreakResult(*batched_tiebreak(
            probs.T, part.read_rel.T, part.read_conf.T, part.read_rel.T,
            mask.T, precision,
        ))
        return (part.state, consensus, tiebreak, part.band_sums,
                part.band_count)

    def partials_merge(probs, mask, outcome, state, now0, steps, merge_device):
        """A markets shard's sources shards: one partials launch each, then
        the merge on *merge_device*. Same tuple as :func:`onepass`, the
        state a list of per-shard states."""
        if with_tiebreak and state[0].reliability.dtype != torch.float32:
            raise ValueError(
                "the tie-break runs on float32 state only: the JAX reference "
                "has no float64 tie-break (its program fails to trace under "
                "x64); settle float64 with the tie-break off"
            )
        parts = [
            onepass_partials(
                probs[j], mask[j], outcome[j], state[j], now0, steps,
                with_views=with_tiebreak, with_bands=with_bands,
                chunk_slots=chunk_slots,
            )
            for j in range(n_sources)
        ]
        tiebreak = sums = count = None
        if with_tiebreak:
            tiebreak = ring_tiebreak_math(
                probs, [p.read_rel for p in parts], [p.read_conf for p in parts],
                [p.read_rel for p in parts], mask, axis_size=n_sources,
                device=merge_device, precision=precision,
                chunk_agents=chunk_agents, agents_last=False,
            )
        if with_bands:
            sums, count = band_merge(
                [p.band_sums for p in parts], [p.band_count for p in parts],
                merge_device,
            )
        if steps == 0:
            consensus = torch.zeros(
                probs[0].shape[1], dtype=probs[0].dtype, device=merge_device
            )
        else:
            consensus = consensus_merge(
                [p.consensus_sums for p in parts], merge_device
            )
        return [p.state for p in parts], consensus, tiebreak, sums, count

    def finish(consensus, tiebreak, sums, count, graph_args):
        bands = band_epilogue(sums, count, z) if with_bands else None
        propagated = (
            sweep(consensus, bands, *graph_args) if with_graph else None
        )
        return consensus, tiebreak, bands, propagated

    def loop(probs, mask, outcome, state, now0: float, steps: int, *graph_args):
        steps = int(steps)
        check_graph_args(graph_args)
        if n_sources > 1 and steps == 0 and kernel == "pallas":
            raise ValueError(
                "kernel='pallas' unavailable: steps=0 on a sources-sharded "
                f"mesh ({n_sources} source shards) — the partials kernel "
                "cannot emit a zero-step consensus as raw sums; use "
                "kernel='xla' for zero-step settles"
            )
        _check_shard_devices(mesh, probs)
        new_state, per_market = [], []
        for i in range(n_market_shards):
            if n_sources == 1:
                shard_state, *outputs = (sorted_settle if sorted_tiebreak
                                         else onepass)(
                    probs[i][0], mask[i][0], outcome[i][0], state[i][0],
                    now0, steps,
                )
                new_state.append((shard_state,))
            else:
                shard_states, *outputs = partials_merge(
                    probs[i], mask[i], outcome[i], state[i], now0, steps,
                    mesh.devices[i][0],
                )
                new_state.append(tuple(shard_states))
            per_market.append(outputs)
        consensus, tiebreak, sums, count = (
            _concat([shard[k] for shard in per_market], device)
            for k in range(4)
        )
        return (tuple(new_state),
                *finish(consensus, tiebreak, sums, count, graph_args))

    return loop


def _concat(pieces, device):
    """Per-market outputs of the markets shards joined along the markets
    axis on *device*: tensors, tuples of them (the tie-break), or None."""
    if pieces[0] is None:
        return None
    if len(pieces) == 1:
        return pieces[0]
    if isinstance(pieces[0], tuple):
        return type(pieces[0])(*(
            _concat([piece[k] for piece in pieces], device)
            for k in range(len(pieces[0]))
        ))
    return torch.cat([piece.to(device) for piece in pieces], dim=-1)


def _grid_mesh(mesh) -> Mesh:
    """*mesh* as a :class:`Mesh`: a device names its (1, 1) mesh."""
    return mesh if isinstance(mesh, Mesh) else make_mesh((1, 1), [mesh])


def _whole_or_grid(mesh, build):
    """The public loops' call convention. ``build(mesh)`` makes a function
    over grids of per-shard blocks on *mesh*, ``(probs, mask, outcome,
    state, ...) -> (state', *outputs)``, the state a grid like the one
    given and every other output whole on the mesh's first device.

    With a :class:`Mesh` or a device (its (1, 1) mesh) that function is
    returned as it is. With ``mesh=None`` the returned function takes
    whole tensors, as the JAX package's ``mesh=None`` programs do, and
    runs on their own device's (1, 1) mesh (CUDA, or the CPU; any other
    device raises), its state whole too."""
    if mesh is not None:
        return build(_grid_mesh(mesh))
    built = {}

    def whole(probs, mask, outcome, state, *rest):
        device = probs.device
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"the cycle runs on cuda or cpu tensors, not {device}")
        run = built.get(device)
        if run is None:
            run = built[device] = build(make_mesh((1, 1), [device]))
        result = run(((probs,),), ((mask,),), ((outcome,),), ((state,),),
                     *rest)
        if isinstance(result, CycleResult):
            return result._replace(state=result.state[0][0])
        return (result[0][0][0], *result[1:])

    return whole


def _kernel_block(x, slot_major: bool):
    """A blocked input in the kernels' slot-major (K, M) layout: a
    market-major (M, K) block is copied transposed, a slot-major one is
    passed as it is."""
    return x if slot_major else x.T.contiguous()


def _kernel_state(state: MarketBlockState, slot_major: bool, donate: bool):
    """The (K, M) state block a kernel may update in place, from a shard's
    state in the caller's layout.

    A market-major block is always copied transposed (even where its
    transpose is a contiguous view of the caller's storage); a slot-major
    one is handed over as it is when donated, else cloned, so that the
    caller's tensors come back unchanged. A state without ``exists`` (the
    loop's reduced carry) takes an all-true block: every slot is read as
    stored and updated from its stored value, the bits the JAX package's
    ``exists=None`` programs compute."""

    def block(x):
        if not slot_major:
            return x.T.clone(memory_format=torch.contiguous_format)
        return x if donate else x.clone()

    fields = [block(x) for x in state[:3]]
    exists = (
        torch.ones(fields[0].shape, dtype=torch.bool, device=fields[0].device)
        if state.exists is None else block(state.exists)
    )
    return MarketBlockState(*fields, exists)


def _caller_state(new: MarketBlockState, like: MarketBlockState,
                  slot_major: bool) -> MarketBlockState:
    """A kernel's (K, M) state back in the layout and form of *like*, the
    state the caller gave: transposed back for market-major blocks, and
    ``exists`` dropped for the reduced carry."""

    def back(x):
        return x if slot_major else x.T.contiguous()

    return MarketBlockState(
        back(new.reliability), back(new.confidence), back(new.updated_days),
        None if like.exists is None else back(new.exists),
    )


def _grid_map(fn, *grids):
    """``fn`` applied shard by shard over grids of the same shape."""
    return tuple(
        tuple(fn(*shards) for shards in zip(*rows)) for rows in zip(*grids)
    )


def build_cycle(mesh=None, donate: bool = True, slot_major: bool = False):
    """One consensus + update cycle, on one card or over a mesh.

    Returns ``cycle(probs, mask, outcome, state, now_days) ->
    CycleResult(state', consensus, confidence, total_weight)``, as the JAX
    package's ``build_cycle`` does: the state read at ``now_days`` (decay
    on read), the weighted consensus, its confidence and total weight per
    market (NaN consensus where the weight is 0), and the update of the
    undecayed state; ``exists=None`` states (the reduced carry) are
    accepted and come back without ``exists``.

    Blocks are market-major (M, K) by default, slot-major (K, M) with
    ``slot_major=True``. ``mesh=None`` takes whole tensors on their own
    device; a :class:`~.parallel.mesh.Mesh` (or a device, its (1, 1)
    mesh) takes grids of per-shard blocks (``parallel/mesh.shard_block``,
    or ``shard_slot_block`` when slot-major) and outcome vectors
    (``shard_market_vector``), and returns the state as such a grid and
    the per-market outputs whole on the mesh's first device.

    On each sources shard one launch of the partials kernel
    (``ops/partials_kernel.py``, one step, views and bands off) updates
    the shard's (K, M) block in place and gives the step's raw sums Σw,
    Σw·p and Σw·conf; the sums are added over the sources shards in mesh
    order (``ops/collectives.psum``) and normalised
    (``consensus_epilogue``), as the JAX package's psum and epilogue do.
    A market-major block is settled in a transposed copy.

    ``donate``: the JAX package lets XLA reuse the donated state's buffer;
    here the kernel writes the (K, M) block in place. With
    ``donate=True`` a slot-major state's tensors are that block, so the
    caller must use the returned state; with ``donate=False`` they are
    cloned first and come back unchanged. A market-major state is never
    written (its transposed copy is).
    """

    def build(grid_mesh):
        def cycle(probs, mask, outcome, state, now_days):
            _check_shard_devices(grid_mesh, probs)
            now0 = float(now_days)
            new_state, per_market = [], []
            for i, row in enumerate(grid_mesh.devices):
                shard_states, sums = [], []
                for j in range(len(row)):
                    part = onepass_partials(
                        _kernel_block(probs[i][j], slot_major),
                        _kernel_block(mask[i][j], slot_major), outcome[i][j],
                        _kernel_state(state[i][j], slot_major, donate), now0, 1,
                        with_views=False, with_bands=False,
                    )
                    shard_states.append(
                        _caller_state(part.state, state[i][j], slot_major))
                    sums.append(part.consensus_sums)
                total_weight, weighted_prob, weighted_conf = (
                    psum([shard_sums[k] for shard_sums in sums], row[0])
                    for k in range(3)
                )
                consensus, confidence = consensus_epilogue(
                    total_weight, weighted_prob, weighted_conf)
                new_state.append(tuple(shard_states))
                per_market.append((consensus, confidence, total_weight))
            return CycleResult(tuple(new_state), *(
                _concat([shard[k] for shard in per_market],
                        grid_mesh.devices[0][0])
                for k in range(3)
            ))

        return cycle

    return _whole_or_grid(mesh, build)


def _check_shard_devices(mesh: Mesh, probs) -> None:
    for i, row in enumerate(mesh.devices):
        for j, shard_device in enumerate(row):
            if probs[i][j].device != shard_device:
                raise ValueError(
                    f"shard ({i}, {j}) is on {probs[i][j].device}, the mesh "
                    f"places it on {shard_device}"
                )


def build_cycle_loop(mesh=None, slot_major: bool = True, donate: bool = True):
    """The N-cycle loop: ``loop(probs, mask, outcome, state, now0, steps)
    -> (state', consensus)``, ``steps`` consecutive cycles (day ``now0 +
    i`` each) with the last step's consensus, as the JAX package's
    ``build_cycle_loop``.

    :func:`build_cycle_analytics_loop` with both analytics stages off: on
    each markets shard one launch of the one-pass kernel
    (``ops/onepass_kernel.py``) with one sources shard, one partials
    launch a sources shard and the consensus merge with several. Blocks
    are slot-major (K, M) by default, market-major (M, K) with
    ``slot_major=False`` (settled in a transposed copy). ``mesh=None``
    takes whole tensors on their own device; a mesh (or a device) takes
    grids and returns the state as a grid, as :func:`build_cycle` says.
    ``donate`` and ``exists=None`` states as in :func:`build_cycle`.
    """

    def build(grid_mesh):
        inner = build_cycle_analytics_loop(
            grid_mesh, with_tiebreak=False, with_bands=False,
        )

        def loop(probs, mask, outcome, state, now0: float, steps: int):
            new_state, consensus, _tb, _bands, _prop = inner(
                _grid_map(lambda x: _kernel_block(x, slot_major), probs),
                _grid_map(lambda x: _kernel_block(x, slot_major), mask),
                outcome,
                _grid_map(lambda x: _kernel_state(x, slot_major, donate), state),
                now0, steps,
            )
            return _grid_map(
                lambda new, like: _caller_state(new, like, slot_major),
                new_state, state,
            ), consensus

        return loop

    return _whole_or_grid(mesh, build)


def build_cycle_tiebreak_loop(
    mesh=None,
    chunk_agents: "int | None" = None,
    donate: bool = True,
    precision: int = 6,
):
    """N cycles plus the ring tie-break on the one resident block:
    ``loop(probs, mask, outcome, state, now0, steps) -> (state',
    consensus, RingTieBreakResult)``, as the JAX package's
    ``build_cycle_tiebreak_loop``.

    A view of :func:`build_cycle_analytics_loop` with the bands off: the
    tie-break reads the state at ``now0``, before the cycles update it
    (each signalling slot one agent, weighted by its decayed read
    reliability). One sources shard: one launch of the one-pass kernel
    with the tie-break on; several: one partials launch a sources shard
    and the sharded ring tie-break over their read views. Blocks are
    slot-major (K, M), float32. ``mesh=None`` takes whole tensors on their
    own device; a mesh (or a device) takes grids. ``donate`` and
    ``exists=None`` states as in :func:`build_cycle`. ``chunk_agents``
    bounds the ring's working set and changes no output; ``"auto"`` (the
    shape tuner) is not ported yet and raises ``NotImplementedError``.
    """
    if chunk_agents == "auto":
        raise NotImplementedError(
            "chunk_agents='auto' (the ring chunk tuner, which needs "
            "utils/autotune.py's ShapeTuner) is not ported yet: ROADMAP "
            "queue 1 item 10"
        )

    def build(grid_mesh):
        inner = build_cycle_analytics_loop(
            grid_mesh, chunk_agents=chunk_agents, precision=precision,
            with_bands=False,
        )

        def loop(probs, mask, outcome, state, now0: float, steps: int):
            new_state, consensus, tiebreak, _bands, _prop = inner(
                probs, mask, outcome,
                _grid_map(lambda x: _kernel_state(x, True, donate), state),
                now0, steps,
            )
            return _grid_map(
                lambda new, like: _caller_state(new, like, True),
                new_state, state,
            ), consensus, tiebreak

        return loop

    return _whole_or_grid(mesh, build)


def pad_markets(probs, mask, outcome, state=None, multiple: int = 128,
                slot_major: bool = True):
    """Pad the markets axis up to a multiple of *multiple*.

    Padded markets carry ``mask=False``, so they add no weight, report a
    NaN consensus and their state stays cold; callers slice outputs back
    to the first ``num_markets``. Returns ``(probs, mask, outcome, state,
    padded_total)``; ``state=None`` passes through.
    """
    markets_axis = 1 if slot_major else 0
    num_markets = probs.shape[markets_axis]
    padded_total = -(-num_markets // multiple) * multiple
    extra = padded_total - num_markets
    if extra == 0:
        return probs, mask, outcome, state, padded_total

    def pad_block(x, fill):
        shape = list(x.shape)
        shape[markets_axis] = extra
        pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, pad], dim=markets_axis)

    padded_state = state
    if state is not None:
        padded_state = MarketBlockState(
            reliability=pad_block(state.reliability, DEFAULT_RELIABILITY),
            confidence=pad_block(state.confidence, DEFAULT_CONFIDENCE),
            updated_days=pad_block(state.updated_days, 0.0),
            exists=None if state.exists is None else pad_block(state.exists, False),
        )
    return (
        pad_block(probs, 0),
        pad_block(mask, False),
        torch.cat([outcome, torch.zeros(extra, dtype=outcome.dtype,
                                        device=outcome.device)]),
        padded_state,
        padded_total,
    )


def init_block_state(num_markets: int, num_slots: int, dtype=torch.float32,
                     device=None) -> MarketBlockState:
    """A fresh all-cold state block, every slot at the cold-start prior,
    of shape ``(num_markets, num_slots)`` as in the JAX package (transpose
    it for the slot-major loop), on *device* (``None``: CUDA)."""
    device = resolve_device(device)
    shape = (num_markets, num_slots)
    return MarketBlockState(
        reliability=torch.full(shape, DEFAULT_RELIABILITY, dtype=dtype, device=device),
        confidence=torch.full(shape, DEFAULT_CONFIDENCE, dtype=dtype, device=device),
        updated_days=torch.zeros(shape, dtype=dtype, device=device),
        exists=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def _lane_damped_relax(
    values, neighbor_idx, neighbor_w, damping, lane_steps, max_steps: int,
    lane_tol=None,
):
    """One replay lane's damped graph relaxation with its own λ, depth and
    residual tolerance (0-d tensors; ``lane_tol`` may be ``None``).

    The JAX package's traced twin of the damped sweep, in eager torch (it
    is XLA there, not Pallas): ``max_steps`` iterations of gather → masked
    neighbour mean (NaN neighbours and ``-1`` padding excluded) → damped
    blend, rows without an edge and non-finite rows untouched; iterations
    past ``lane_steps`` are frozen, and with ``lane_tol > 0`` so is every
    iteration after the previous one's ``max |Δvalue|`` fell to the
    tolerance (a frozen iteration's residual reads 0, so a converged lane
    stays converged). Every lane runs ``max_steps`` iterations.
    """
    f32 = torch.float32
    values = values.to(f32)
    if max_steps <= 0:
        return values
    weights = torch.where(neighbor_idx >= 0, neighbor_w.to(f32), 0.0)
    lam = damping.to(f32)
    keep = 1.0 - lam
    tol = None if lane_tol is None else lane_tol.to(f32)
    gather_idx = torch.clamp_min(neighbor_idx, 0).long()
    v = values
    residual = torch.tensor(torch.inf, dtype=f32, device=values.device)
    for i in range(max_steps):
        nb = v[gather_idx]
        ok = (neighbor_idx >= 0) & torch.isfinite(nb)
        w = torch.where(ok, weights, 0.0)
        wsum = torch.sum(w, dim=-1)
        wval = torch.sum(w * torch.where(ok, nb, 0.0), dim=-1)
        mixes = (wsum > 0) & torch.isfinite(v) & (i < lane_steps)
        if tol is not None:
            mixes = mixes & ((tol <= 0) | (residual > tol))
        blended = keep * v + lam * (wval / torch.where(wsum > 0, wsum, 1.0))
        new_v = torch.where(mixes, blended, v)
        residual = torch.amax(torch.where(mixes, torch.abs(new_v - v), 0.0))
        v = new_v
    return v


#: Replay-sweep steps, keyed ``(steps, max_graph_steps)``, shared by every
#: sweep of the process (the JAX package caches its compiled programs so).
_REPLAY_SWEEP_CACHE: dict = {}


def build_replay_sweep_step(steps: int, max_graph_steps: int = 0):
    """The C-lane counterfactual settlement step of ``replay/``.

    ``step(state, metrics, params, band_z, graph, slot_rows, probs, mask,
    outcome, now0, neighbors, *, touched=None) -> (state', metrics')``
    advances C alternate-history copies of the flat store state through
    one recorded batch:

    * ``state`` is a ``(rel, conf, days, exists)`` tuple of (C, R)
      stacked flat columns, advanced IN PLACE on the card (the returned
      tuple must be used: on the CPU it holds new tensors);
    * ``metrics`` is the (C, 4) float32 running accumulator
      ``[n_settled, brier_sum, band_width_sum, graph_brier_sum]``;
    * ``params`` is a ``CycleParams`` of (C,) lane tensors, ``band_z`` a
      (C,) tensor, ``graph`` either ``()`` (built with
      ``max_graph_steps=0``) or a ``(damping, steps, tol)`` triple of (C,)
      lane tensors, ``neighbors`` either ``()`` or the aligned
      ``(neighbor_idx, neighbor_w)`` blocks;
    * ``slot_rows``, ``probs``, ``mask`` (the plan's (K, M) block),
      ``outcome`` (M,) and ``now0`` (the batch's day relative to the
      lanes' epoch, already rounded to the state's dtype) are shared by
      every lane; ``touched`` optionally passes the plan's
      ``(touched_offsets, num_touched)``, else they come from the mask.

    Per batch: each lane's band-width metric from the pre-update decayed
    read at ``now0`` with the lane's rates (``read_phase``, the band
    tree's ``band_sums``, then the stderr as XLA CPU computes the JAX
    package's: the variance's ``E[p²] − μ²`` one fused multiply-add, the
    root correctly rounded; scaled by the lane's ``2·z``), read before the
    state moves; then ONE ``settle_cycles_lanes`` launch for every lane
    (on the CPU its plain version); then, on the lanes' consensus, the
    Brier sum over the markets that settled with weight and, with a
    graph, the lane's damped relaxation and its Brier (else the plain
    Brier again). Every sum over markets is one ``torch.sum`` per lane
    row, whose order on the card is fixed by the shape, and the kernel
    adds no float atomically, so a sweep is a pure function of (trace,
    configs).
    """
    key = (int(steps), int(max_graph_steps))
    cached = _REPLAY_SWEEP_CACHE.get(key)
    if cached is not None:
        return cached
    steps, max_graph_steps = key
    has_graph = max_graph_steps > 0
    f32 = torch.float32

    def band_width(rel, conf, days, exists, params_row, z, slot_rows, probs,
                   mask, now):
        """One lane's Σ 2·z·stderr over the markets, read at ``now``."""
        rows = slot_rows.long()

        def gather(flat, fill):
            sink = torch.full((1,), fill, dtype=flat.dtype, device=flat.device)
            return torch.cat([flat, sink])[rows]

        block = MarketBlockState(
            reliability=gather(rel, DEFAULT_RELIABILITY),
            confidence=gather(conf, DEFAULT_CONFIDENCE),
            updated_days=gather(days, 0.0),
            exists=gather(exists, False),
        )
        read_rel, _ = read_phase(block, now, lane_params(params_row, rel.dtype))
        sums, _count = band_sums(probs, mask, read_rel, agents_last=False)
        sw, swp, swp2, sw2 = sums[0], sums[1], sums[2], sums[3]
        has_weight = sw != 0
        safe_w = torch.where(has_weight, sw, 1.0)
        mean = torch.where(has_weight, swp / safe_w, 0.0)
        ex2 = torch.where(has_weight, swp2 / safe_w, 0.0)
        variance = torch.clamp_min(fma(ex2, -mean, mean), 0.0)
        positive = sw2 > 0
        n_eff = torch.where(
            positive, (sw * sw) / torch.where(positive, sw2, 1.0), 0.0
        )
        ratio = variance / torch.clamp_min(n_eff, 1e-30)
        stderr = torch.where(n_eff > 0, torch.sqrt(ratio.double()).to(f32), 0.0)
        return torch.sum(2.0 * z.to(f32) * stderr)

    def step(state, metrics, params, band_z, graph, slot_rows, probs, mask,
             outcome, now0, neighbors, *, touched=None):
        rel, conf, days, exists = state
        num_lanes = rel.shape[0]
        device = rel.device
        if not isinstance(params, CycleParams):
            params = CycleParams(*params)
        params_t = torch.stack(
            [torch.as_tensor(field, device=device).to(f32) for field in params],
            dim=1,
        ).contiguous()
        now0 = float(now0)
        now = torch.tensor(now0, dtype=rel.dtype, device=device)
        widths = torch.stack([
            band_width(rel[c], conf[c], days[c], exists[c], params_t[c],
                       band_z[c], slot_rows, probs, mask, now)
            for c in range(num_lanes)
        ])
        if touched is None:
            offsets = torch.zeros(mask.shape[1] + 1, dtype=torch.int64,
                                  device=device)
            offsets[1:] = torch.cumsum(mask.sum(0), 0)
            touched = (offsets, int(offsets[-1]))
        rel, conf, days, exists, consensus = settle_cycles_lanes(
            rel, conf, days, exists, slot_rows, probs, mask, outcome,
            touched[0], touched[1], now0, steps, params_t,
        )
        settled = torch.isfinite(consensus)
        outcome_f = outcome.to(f32)
        cons = torch.where(settled, consensus.to(f32), 0.0)
        brier = torch.sum(
            torch.where(settled, (cons - outcome_f) ** 2, 0.0), dim=1
        )
        if has_graph:
            damping, lane_steps, lane_tol = graph
            neighbor_idx, neighbor_w = neighbors
            graph_brier = torch.stack([
                torch.sum(torch.where(
                    settled[c],
                    (torch.where(settled[c], _lane_damped_relax(
                        consensus[c], neighbor_idx, neighbor_w, damping[c],
                        lane_steps[c], max_graph_steps, lane_tol[c],
                    ), 0.0) - outcome_f) ** 2,
                    0.0,
                ))
                for c in range(num_lanes)
            ])
        else:
            # No relaxation: the graph Brier is the plain Brier.
            graph_brier = brier
        delta = torch.stack([
            torch.sum(settled, dim=1).to(f32), brier, widths, graph_brier,
        ], dim=1)
        return (rel, conf, days, exists), metrics + delta.to(metrics.dtype)

    _REPLAY_SWEEP_CACHE[key] = step
    return step


def relayout_slot_state(
    state,
    src,
    enter_pos,
    enter_rel,
    enter_conf,
    enter_days,
    enter_exists,
    new_shape: tuple,
    mesh: Mesh,
):
    """Carry a resident slot-major block onto a new plan's (K, M) layout.

    The device half of ``ShardedSettlementSession.adopt``: after a
    topology miss the session's block is re-laid out for the incoming plan
    (slots move, markets reorder, the padded extents may grow) without a
    round trip through the host. ``src`` (int64, length ``K_new * M_new``)
    maps each new flat slot-major position to the old block's flat
    position it carries forward, or -1 for positions not carried (padding
    and rows entering the active set); ``enter_pos`` and ``enter_*``
    scatter the entering rows' host values (already cast to the block's
    dtype, stamps relative to the session epoch) into their new positions.
    Every other position takes the cold-start defaults, as a fresh state
    build leaves unmasked padding.

    Rows leaving the active set are not gathered: the session's standing
    sync recipe (a lazy gather over the old block) still covers them.
    The old ``reliability`` tensors are therefore left as they are (that
    recipe may still read them); the other three fields are replaced.

    *state* is the session's grid of per-shard blocks on *mesh*
    (``state[i][j]``, as ``parallel/mesh.shard_slot_block`` cuts them):
    each field is put together on the mesh's first device, so the gather
    crosses the shards of a sources-sharded mesh, and the relaid block is
    cut back onto the mesh as such a grid.
    """
    new_shape = tuple(int(x) for x in new_shape)
    device = mesh.devices[0][0]
    fields = tuple(
        unshard_slot_block(
            tuple(tuple(shard[f] for shard in row) for row in state), device
        )
        for f in range(4)
    )
    src_t = torch.as_tensor(np.asarray(src, dtype=np.int64), device=device)
    carried = src_t >= 0
    src_carried = src_t[carried]
    pos_t = torch.as_tensor(np.asarray(enter_pos, dtype=np.int64), device=device)
    size = new_shape[0] * new_shape[1]

    def onto(old, fill, entered):
        out = torch.full((size,), fill, dtype=old.dtype, device=device)
        out[carried] = old.reshape(-1)[src_carried]
        if pos_t.numel():
            out[pos_t] = torch.as_tensor(entered, device=device)
        return out.reshape(new_shape)

    relaid = MarketBlockState(
        reliability=onto(fields[0], DEFAULT_RELIABILITY, enter_rel),
        confidence=onto(fields[1], DEFAULT_CONFIDENCE, enter_conf),
        updated_days=onto(fields[2], 0.0, enter_days),
        exists=onto(fields[3], False, enter_exists),
    )
    return _shard_block_state(relaid, mesh)


def _shard_block_state(state, mesh: Mesh) -> tuple:
    """A global slot-major :class:`MarketBlockState` cut into the mesh's
    grid of per-shard states, each piece a contiguous copy on its shard's
    device (the layout ``shard_slot_block`` gives)."""
    num_slots, num_markets = state.reliability.shape
    m_size, s_size = mesh.shape[MARKETS_AXIS], mesh.shape[SOURCES_AXIS]
    k_loc, m_loc = num_slots // s_size, num_markets // m_size
    return tuple(
        tuple(
            MarketBlockState(*(
                field[j * k_loc:(j + 1) * k_loc, i * m_loc:(i + 1) * m_loc]
                .to(mesh.devices[i][j]).contiguous()
                for field in state
            ))
            for j in range(s_size)
        )
        for i in range(m_size)
    )
