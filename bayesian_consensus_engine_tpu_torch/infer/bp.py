"""Belief-propagation options and the host-facing sweep entry — the port of
``infer/bp.py``.

:class:`InferenceOptions` rides ``AnalyticsOptions(inference=...)`` into
:meth:`~.pipeline.ShardedSettlementSession.settle_with_analytics`: it
upgrades the graph sweep from the point relaxation to the moment-pair form
and optionally arms the early exit. :func:`propagate_beliefs` is the
one-call form: align a graph to a market universe and sweep.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from bayesian_consensus_engine_tpu_torch.ops.bp_kernel import bp_sweep
from bayesian_consensus_engine_tpu_torch.ops.propagate import (
    PropagatedBeliefs,
    propagated_stderr,
)
from bayesian_consensus_engine_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class InferenceOptions:
    """How the correlated-market sweep runs.

    ``moments=True`` (the default) propagates ``(mean, variance)`` pairs:
    neighbour mixing is precision-weighted, the variance seed is the band
    stderr squared, and the output is a :class:`PropagatedBeliefs`.
    ``tol`` arms the early exit: the sweep stops once ``max |Δmean|``
    drops to it, within ``max_steps`` (``None`` → the graph's ``steps``).
    ``damping=None`` defers to the graph's λ.
    """

    moments: bool = True
    tol: Optional[float] = None
    max_steps: Optional[int] = None
    damping: Optional[float] = None

    def __post_init__(self) -> None:
        if self.tol is not None and not self.tol > 0:
            raise ValueError(
                f"tol={self.tol!r}: a positive residual tolerance, or "
                "None for the fixed-depth sweep"
            )
        if self.max_steps is not None and self.max_steps < 0:
            raise ValueError(f"max_steps={self.max_steps!r}: must be >= 0")
        if self.damping is not None and not 0.0 <= self.damping <= 1.0:
            raise ValueError(
                f"damping={self.damping!r}: must lie in [0, 1]"
            )
        if not self.moments and self.tol is not None:
            raise ValueError(
                "tol (the adaptive early-exit) rides the moments sweep "
                "— set moments=True"
            )

    def resolve(self, graph) -> "tuple[float, int, Optional[float]]":
        """``(damping, max_steps, tol)`` with graph defaults filled in."""
        damping = self.damping if self.damping is not None else graph.damping
        max_steps = (
            self.max_steps if self.max_steps is not None else graph.steps
        )
        return float(damping), int(max_steps), self.tol


def propagate_beliefs(
    means,
    variances,
    graph,
    market_keys,
    padded_total: int,
    *,
    options: InferenceOptions | None = None,
    kernel: str = "xla",
    device=None,
) -> PropagatedBeliefs:
    """One-call host form: align the graph, run the sweep.

    ``means``/``variances`` are per-market vectors over *market_keys*
    padded to *padded_total* (NaN for markets without evidence), as
    tensors or arrays. The sweep runs on *device*: by default the device
    of a tensor ``means``, else CUDA. ``kernel`` takes the JAX package's
    names, ``"xla"`` or ``"pallas"``; on CUDA both run the ``bp_sweep``
    kernel, on the CPU its plain version. A zero-step sweep is the
    identity and launches nothing. Returns a :class:`PropagatedBeliefs`
    over the padded axis (``stderr`` NaN on the point lane).
    """
    if kernel not in ("xla", "pallas"):
        raise ValueError(
            f"kernel={kernel!r}: 'xla' (the while_loop sweep, the "
            "default) or 'pallas' (the VMEM-resident BP kernel); the "
            "honesty-guarded 'auto' route lives on the fused session "
            "program (AnalyticsOptions.sweep_kernel)"
        )
    options = options or InferenceOptions()
    damping, max_steps, tol = options.resolve(graph)
    if device is None and isinstance(means, torch.Tensor):
        device = means.device
    device = resolve_device(device)
    neighbor_idx, neighbor_w = graph.align(market_keys, padded_total)

    def upload(values):
        return torch.as_tensor(values, dtype=torch.float32, device=device).contiguous()

    mean, var, iters, residual = bp_sweep(
        upload(means),
        upload(variances) if options.moments else None,
        torch.from_numpy(neighbor_idx).to(device),
        torch.from_numpy(neighbor_w).to(device),
        damping=damping, max_steps=max_steps, tol=tol,
    )
    stderr = (
        propagated_stderr(var) if var is not None
        else torch.full_like(mean, float("nan"))
    )
    return PropagatedBeliefs(mean, stderr, iters, residual)
