"""The fused settle loop over a resident slot-major block, on one card —
the one-device part of ``parallel/sharded.py``.

:func:`build_cycle_analytics_loop` returns ``loop(probs, mask, outcome,
state, now0, steps) -> (state', consensus, tiebreak | None, bands | None,
None)``: ``steps`` settle cycles plus, read from the state at ``now0``
before the cycles update it, the ring tie-break and the uncertainty bands.
A disabled stage returns ``None``; the last slot (the JAX package's graph
sweep output) is always ``None`` until the inference slice lands. On CUDA
every call is one launch of the one-pass kernel
(``ops/onepass_kernel.py``); on the CPU its plain version runs.

The JAX package's mesh, its ``shard_map`` and the sources-sharded
partials route wait for the multi-GPU slice: here the device takes the
mesh's place.
"""

from __future__ import annotations

from bayesian_consensus_engine_tpu_torch.ops.onepass_kernel import onepass_settle
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
    with_tiebreak: bool = True,
    with_bands: bool = True,
    tiebreak_kind: str = "ring",
    kernel: str = "xla",
    sweep_kernel: str = "xla",
):
    """The fused loop: N cycles + optional tie-break + optional bands.

    The arguments are validated as the JAX package validates them.
    ``kernel`` and ``sweep_kernel`` take its route names: ``"xla"``,
    ``"pallas"`` and ``"auto"``. ``"pallas"`` with a stage off is refused,
    as there (the one-pass kernel IS cycles + tie-break + bands), and
    ``sweep_kernel="pallas"`` is refused because there is no graph sweep
    to offload. The port has one route: on CUDA every accepted value runs
    the one-pass kernel. ``tiebreak_kind="sorted"`` (the sort-based
    grouping kernel) is not ported yet.
    """
    device = resolve_device(device)
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
    if sweep_kernel == "pallas":
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

    def loop(probs, mask, outcome, state, now0: float, steps: int):
        steps = int(steps)
        if probs.device.type != device.type:
            raise ValueError(
                f"the loop was built for {device}, the block is on {probs.device}"
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
        return out.state, out.consensus, out.tiebreak, bands, None

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
