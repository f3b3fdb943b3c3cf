"""The fused settle loop over a resident slot-major block, on one card —
the one-device part of ``parallel/sharded.py``.

:func:`build_cycle_analytics_loop` returns ``loop(probs, mask, outcome,
state, now0, steps[, neighbor_idx, neighbor_w]) -> (state', consensus,
tiebreak | None, bands | None, propagated | None)``: ``steps`` settle
cycles plus, read from the state at ``now0`` before the cycles update it,
the ring tie-break and the uncertainty bands, and then, with
``sweep_steps > 0``, the belief sweep over the market graph seeded with
the last step's consensus (and the band variance on the moments lane). A
disabled stage returns ``None``. On CUDA every call is one launch of the
one-pass kernel (``ops/onepass_kernel.py``) and, with a graph, the
``bp_sweep`` kernel's launches (``ops/bp_kernel.py``); on the CPU their
plain versions run.

The JAX package's mesh, its ``shard_map`` and the sources-sharded
partials route wait for the multi-GPU slice: here the device takes the
mesh's place.
"""

from __future__ import annotations

import torch

from bayesian_consensus_engine_tpu_torch.ops.bp_kernel import bp_sweep
from bayesian_consensus_engine_tpu_torch.ops.onepass_kernel import onepass_settle
from bayesian_consensus_engine_tpu_torch.ops.propagate import (
    PropagatedBeliefs,
    propagated_stderr,
)
from bayesian_consensus_engine_tpu_torch.ops.uncertainty import (
    Z_95,
    band_epilogue,
)
from bayesian_consensus_engine_tpu_torch.utils.device import resolve_device


def build_cycle_analytics_loop(
    device=None,
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
    optional graph sweep.

    The arguments are validated as the JAX package validates them.
    ``sweep_steps > 0`` adds the sweep (damping ``damping``, at most
    ``sweep_steps`` sweeps); the loop then takes the two aligned
    neighbour blocks (``MarketGraph.align``: int32 and float32 (M, D) on
    the block's device). ``sweep_mode="point"`` returns the relaxed mean
    vector; ``"moments"`` seeds the variance with the band stderr squared
    (it needs the bands) and returns a :class:`PropagatedBeliefs`;
    ``sweep_tol`` (moments only) arms the early exit. ``kernel`` and
    ``sweep_kernel`` take the route names ``"xla"``, ``"pallas"`` and
    ``"auto"``; ``"pallas"`` with a stage off, and ``sweep_kernel=
    "pallas"`` with no sweep, are refused, as there. The port has one
    route per stage: on CUDA every accepted ``kernel`` runs the one-pass
    kernel and every accepted ``sweep_kernel`` the ``bp_sweep`` kernel.
    ``tiebreak_kind="sorted"`` (the sort-based grouping kernel) is not
    ported yet.
    """
    device = resolve_device(device)
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
    if kernel == "pallas" and (
        not (with_tiebreak and with_bands) or tiebreak_kind != "ring"
    ):
        raise ValueError(
            "kernel='pallas' unavailable: the one-pass kernel IS cycles + "
            "ring tie-break + bands in one sweep; disabling a stage (or "
            "tiebreak_kind='sorted') needs the stage-selective XLA program"
        )
    if with_tiebreak and tiebreak_kind == "sorted":
        raise NotImplementedError(
            "tiebreak_kind='sorted' (the sort-based grouping kernel, "
            "ops/tiebreak.py::batched_tiebreak) is not ported yet: "
            "ROADMAP queue 1 item 8"
        )

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

    def loop(probs, mask, outcome, state, now0: float, steps: int, *graph_args):
        steps = int(steps)
        if probs.device.type != device.type:
            raise ValueError(
                f"the loop was built for {device}, the block is on {probs.device}"
            )
        if len(graph_args) != (2 if with_graph else 0):
            raise ValueError(
                "the loop takes neighbor_idx and neighbor_w exactly when it "
                f"was built with sweep_steps > 0 (sweep_steps={sweep_steps})"
            )
        out = onepass_settle(
            probs, mask, outcome, state, now0, steps,
            with_tiebreak=with_tiebreak, with_bands=with_bands,
            precision=precision, chunk_agents=chunk_agents,
            chunk_slots=chunk_slots,
        )
        bands = (
            band_epilogue(out.band_sums, out.band_count, z)
            if with_bands else None
        )
        propagated = (
            sweep(out.consensus, bands, *graph_args) if with_graph else None
        )
        return out.state, out.consensus, out.tiebreak, bands, propagated

    return loop


def build_cycle_loop(device=None):
    """The N-cycle loop alone: :func:`build_cycle_analytics_loop` with both
    analytics stages off. ``loop(probs, mask, outcome, state, now0, steps)
    -> (state', consensus)``."""
    inner = build_cycle_analytics_loop(
        device, with_tiebreak=False, with_bands=False,
    )

    def loop(probs, mask, outcome, state, now0: float, steps: int):
        new_state, consensus, _tb, _bands, _prop = inner(
            probs, mask, outcome, state, now0, steps
        )
        return new_state, consensus

    return loop
