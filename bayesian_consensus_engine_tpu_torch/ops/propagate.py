"""Correlated-market consensus propagation — the plain version of the damped
belief sweep, the port of ``ops/propagate.py``.

Markets are not independent: a constituent market's consensus carries
information about the composites that depend on it. The sweep is a damped
relaxation over a dense per-row neighbour block,

    c'_i = (1 − λ)·c_i + λ · (Σ_j w_ij·c_j) / (Σ_j w_ij),

iterated synchronously (Jacobi: every row of a sweep reads the previous
sweep's whole vector). With a variance vector beside the means
(``moments``), each edge weight is multiplied by the neighbour's precision
``1/(var_j + VAR_EPS)`` and the variance blends as
``keep²·var_i + λ²·Σq²var_j/(Σq)²``. An optional residual tolerance stops
the sweep once ``max |Δmean|`` over the mixing rows drops to it, within
the ``max_steps`` bound.

Semantics at the edges, as in the JAX package: ``neighbor_idx < 0`` lanes
are padding; a neighbour whose mean (or variance) is not finite is left
out of the mix; a row with no usable neighbour, or a non-finite mean of
its own, keeps its values. The sweep runs in float32 whatever the caller's
dtype.

**The arithmetic is the reference's XLA CPU program's, bit for bit.** XLA
sums the D neighbour lanes of a row left to right from 0, and contracts
some multiply-adds into fused multiply-adds: ``Σ w·nb`` takes each
rounded product and adds it (no FMA); ``Σ (w·w)·nb_var`` accumulates with
an FMA; the mean blend is ``fma(λ, wval/denom, keep·v)`` and the variance
blend ``fma(λ², wvar/(denom·denom), keep²·s)``. XLA contracts the OTHER
product of each blend, ``fma(keep, v, λ·q)`` and ``fma(keep², s, λ²·q_s)``
(``keep_fma``), when a row has one lane (D = 1: the reduction is dropped)
and when nothing reads the residual (``damped_sweep_math``, the session's
point lane: the loop carry is dropped). :func:`bp_row_mix` writes
that order out: an explicit loop over the D lanes, the FMAs through
``ops/fma.py``. The CUDA kernel (``csrc/bp_sweep.cu``) does the same with
``_rn`` intrinsics, so kernel and plain version agree bit for bit.

This module is the plain version only. The sweep the session runs is
``ops/bp_kernel.py::bp_sweep``: on CUDA tensors the kernel, on CPU
tensors :func:`bp_sweep_math`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from bayesian_consensus_engine_tpu_torch.ops.fma import fma

#: Recorded default damping: hold 50% of a market's own consensus per sweep.
DEFAULT_DAMPING = 0.5

#: Recorded default sweep depth: two synchronous iterations carry a
#: neighbour-of-neighbour influence without letting long cycles ring.
DEFAULT_SWEEP_STEPS = 2

#: Precision floor: a zero-variance neighbour would otherwise divide by zero.
VAR_EPS = 1e-12


class PropagatedBeliefs(NamedTuple):
    """The moment-pair sweep's additive analytics output.

    ``mean``/``stderr`` are per-market vectors; ``iters_run`` (int32
    scalar) and ``residual`` (float32 scalar, the last measured
    ``max |Δmean|``) are the early exit's audit pair. ``stderr`` is the
    square root of the propagated variance.
    """

    mean: torch.Tensor
    stderr: torch.Tensor
    iters_run: torch.Tensor
    residual: torch.Tensor


def propagated_stderr(variances: torch.Tensor) -> torch.Tensor:
    """``sqrt(variances)`` correctly rounded to float32, as XLA's is (torch's
    CPU float32 sqrt is not; the square root through float64 is)."""
    return torch.sqrt(variances.double()).to(torch.float32)


def sweep_constants(damping: float) -> "tuple[np.float32, np.float32]":
    """``(λ, keep = 1 − λ)`` rounded to float32, as the reference forms them."""
    lam = np.float32(damping)
    return lam, np.float32(1.0) - lam


def bp_row_mix(
    v: torch.Tensor,                  # f32[R] this row block's means
    s: "torch.Tensor | None",         # f32[R] variances (moments)
    full: torch.Tensor,               # f32[M] the whole mean vector
    full_s: "torch.Tensor | None",    # f32[M] the whole variance vector
    neighbor_idx: torch.Tensor,       # i32[R, D] positions in full; -1 pad
    weights: torch.Tensor,            # f32[R, D] edge weights, padding zeroed
    *,
    lam: float,
    keep: float,
    moments: bool,
    keep_fma: bool = False,
) -> "tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]":
    """One row block of the precision-weighted damped mix.

    Returns ``(new_v, new_s, delta_rows)``: ``delta_rows`` is each row's
    ``|Δmean|`` on mixing rows and 0 elsewhere, for the caller's max.
    ``keep_fma`` fuses the blends' ``keep`` products instead of their
    ``λ`` products (see the module docstring).
    """
    f32 = torch.float32
    device = v.device

    def scalar(x):
        return torch.tensor(x, dtype=f32, device=device)

    zero = scalar(0.0)
    eps = scalar(np.float32(VAR_EPS))
    lam_t, keep_t = scalar(lam), scalar(keep)
    # Out-of-range positions clamp into [0, M), as the reference's gather.
    safe = neighbor_idx.clamp(0, max(full.shape[0] - 1, 0)).long()
    wsum = torch.zeros_like(v)
    wval = torch.zeros_like(v)
    wvar = torch.zeros_like(v) if moments else None
    for lane in range(neighbor_idx.shape[1]):  # left to right, as XLA sums
        col = safe[:, lane]
        nb = full[col]
        ok = (neighbor_idx[:, lane] >= 0) & torch.isfinite(nb)
        if moments:
            nb_var = full_s[col]
            ok = ok & torch.isfinite(nb_var)
            prec = torch.reciprocal(nb_var + eps)
            w = torch.where(ok, weights[:, lane] * prec, zero)
        else:
            w = torch.where(ok, weights[:, lane], zero)
        wsum = wsum + w
        wval = wval + w * torch.where(ok, nb, zero)
        if moments:
            wvar = fma(wvar, w * w, torch.where(ok, nb_var, zero))
    mixes = (wsum > 0) & torch.isfinite(v)
    denom = torch.where(wsum > 0, wsum, scalar(1.0))
    q = wval / denom
    blended = (
        fma(lam_t * q, keep_t, v) if keep_fma else fma(keep_t * v, lam_t, q)
    )
    new_v = torch.where(mixes, blended, v)
    if moments:
        keep2, lam2 = keep_t * keep_t, lam_t * lam_t
        q_s = wvar / (denom * denom)
        blended_s = (
            fma(lam2 * q_s, keep2, s) if keep_fma
            else fma(keep2 * s, lam2, q_s)
        )
        new_s = torch.where(mixes, blended_s, s)
    else:
        new_s = s
    delta_rows = torch.where(mixes, (new_v - v).abs(), zero)
    return new_v, new_s, delta_rows


def bp_sweep_math(
    means: torch.Tensor,                 # [M] per-market means
    variances: "torch.Tensor | None",    # [M] or None → the point sweep
    neighbor_idx: torch.Tensor,          # i32[M, D] positions; -1 pad
    neighbor_w: torch.Tensor,            # [M, D] edge weights
    *,
    damping: float = DEFAULT_DAMPING,
    max_steps: int = DEFAULT_SWEEP_STEPS,
    tol: Optional[float] = None,
    keep_fma: "bool | None" = None,
) -> "tuple[torch.Tensor, torch.Tensor | None, torch.Tensor, torch.Tensor]":
    """Moment-propagating, convergence-aware belief sweep, in eager torch.

    Returns ``(means, variances, iters_run, residual)``: the relaxed
    moments (float32), the sweeps run (int32 scalar) and the last sweep's
    ``max |Δmean|`` (float32 scalar). ``variances=None`` runs the point
    form and returns ``None`` for the variances. ``tol=None`` runs exactly
    ``max_steps`` sweeps; a positive ``tol`` stops once the residual is at
    or below it (or not a number). ``max_steps <= 0`` returns the seeds
    with ``iters_run`` 0 and ``residual`` 0.0. The whole markets axis is
    one block: this is the reference at ``axis_name=None``. ``keep_fma``
    picks the blends' contraction; ``None`` takes the reference's when its
    residual is read (``keep`` for one lane, else ``λ``).
    """
    f32 = torch.float32
    device = means.device
    means = means.to(f32)
    moments = variances is not None
    if moments:
        variances = variances.to(f32)
    weights = torch.where(
        neighbor_idx >= 0, neighbor_w.to(f32),
        torch.zeros((), dtype=f32, device=device),
    )
    lam, keep = sweep_constants(damping)
    if keep_fma is None:
        keep_fma = neighbor_idx.shape[1] == 1
    iters = 0
    residual = torch.zeros((), dtype=f32, device=device)
    if max_steps > 0:
        tol_f = None if tol is None else torch.tensor(
            np.float32(tol), dtype=f32, device=device
        )
        v, s = means, variances
        for _ in range(max_steps):
            if tol_f is not None and iters > 0 and not bool(residual > tol_f):
                break
            v, s, delta_rows = bp_row_mix(
                v, s, v, s, neighbor_idx, weights,
                lam=lam, keep=keep, moments=moments, keep_fma=keep_fma,
            )
            residual = (
                delta_rows.max() if delta_rows.numel() else residual
            )
            iters += 1
        means, variances = v, s
    return (
        means,
        variances if moments else None,
        torch.tensor(iters, dtype=torch.int32, device=device),
        residual,
    )


def damped_sweep_math(
    values: torch.Tensor,        # [M] per-market values
    neighbor_idx: torch.Tensor,  # i32[M, D] positions; -1 pad
    neighbor_w: torch.Tensor,    # [M, D] edge weights
    *,
    damping: float = DEFAULT_DAMPING,
    steps: int = DEFAULT_SWEEP_STEPS,
) -> torch.Tensor:
    """*steps* fixed-depth point sweeps; returns the relaxed values (the
    legacy point entry, :func:`bp_sweep_math` with no variances). Nothing
    reads the residual, so the blend fuses ``keep·v`` as the reference's
    program does."""
    relaxed, _, _, _ = bp_sweep_math(
        values, None, neighbor_idx, neighbor_w,
        damping=damping, max_steps=steps, tol=None, keep_fma=True,
    )
    return relaxed
