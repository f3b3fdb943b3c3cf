"""Reliability-weighted consensus — the scalar path, and the ``backend=``
seam to the batched array path.

A copy of ``bayesian_consensus_engine_tpu/core/engine.py``'s scalar path,
float summation order included, so the golden fixture
(``tests/fixtures/golden_regression.json``, consensus 0.6966666666666667)
reproduces byte for byte:

  * duplicate signals from one source are averaged in signal order
  * sources are processed in sorted-id order
  * consensus = Σ(p̄·w)/Σw and confidence = Σ(c·w)/Σw accumulate
    left-to-right over the sorted sources

``backend="python"`` (the default) is this path. ``"torch"`` is the
batched array path (``core.batch``): its device pass runs on CUDA unless
``device="cpu"`` is passed, in float32 unless ``dtype=torch.float64`` is;
the JAX package's backend names ``"jax"`` and ``"tpu"`` select the same
array path, so code written against it runs unchanged. The batched module
is imported only when asked for, so the scalar path loads no device code.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from bayesian_consensus_engine_tpu_torch.utils.config import (
    DEFAULT_CONFIDENCE,
    DEFAULT_RELIABILITY,
    SCHEMA_VERSION,
)

# Re-exported for the same module surface as the JAX package's engine.
from bayesian_consensus_engine_tpu_torch.core.validate import (  # noqa: F401
    ValidationError,
    validate_input_payload,
)

#: Backend names that select the batched array path.
ARRAY_BACKENDS = ("torch", "jax", "tpu")


def check_backend(backend: str) -> None:
    """Raise the JAX package's ``ValueError`` for an unknown backend."""
    if backend != "python" and backend not in ARRAY_BACKENDS:
        raise ValueError(f"unknown backend: {backend!r}")


def compute_consensus(
    signals: Sequence[Mapping[str, Any]],
    source_reliability: Mapping[str, Mapping[str, float]] | None = None,
    backend: str = "python",
    device=None,
    dtype=None,
) -> dict[str, Any]:
    """Weighted-average consensus over per-source probability signals.

    Args:
        signals: sequence of ``{"sourceId": str, "probability": float}``.
        source_reliability: optional per-source ``{"reliability", "confidence"}``
            mapping; absent sources use cold-start defaults and are listed in
            ``diagnostics.coldStartSources``.
        backend: ``"python"`` (default, bit-exact scalar path) or ``"torch"``
            (batched array path, see ``core.batch``; ``"jax"`` and ``"tpu"``
            are the same path).
        device, dtype: the array path's device (``None``: CUDA, raising
            without it) and float dtype (``None``: float32); the scalar
            path ignores them.

    Returns the full v1.0.0 output document (consensus, confidence,
    sourceWeights, normalization, diagnostics).
    """
    check_backend(backend)
    if backend != "python" and signals:
        try:
            from bayesian_consensus_engine_tpu_torch.core.batch import (
                compute_consensus_torch,
            )
        except ImportError as exc:
            raise NotImplementedError(
                f"backend {backend!r} requires the batched array path "
                "(core.batch), which is not available in this build"
            ) from exc
        return compute_consensus_torch(
            signals, source_reliability, device=device, dtype=dtype
        )

    if not signals:
        # Fresh document per call — callers mutate results (CLI dryRun stamp).
        return {
            "schemaVersion": SCHEMA_VERSION,
            "consensus": None,
            "confidence": 0.0,
            "sourceWeights": [],
            "normalization": {"totalWeight": 0.0, "sourceCount": 0},
            "diagnostics": {"status": "no_signals", "sources": 0},
        }

    reliability_map: Mapping[str, Mapping[str, float]] = source_reliability or {}

    # Single pass: bucket probabilities per source in signal order (the
    # duplicate-averaging float order).
    by_source: dict[str, list[float]] = {}
    for signal in signals:
        by_source.setdefault(signal["sourceId"], []).append(signal["probability"])

    ordered_ids = sorted(by_source)

    # Float-semantics note: builtin sum() (Neumaier-compensated for floats on
    # CPython ≥3.12) is used for the per-source means and the two weighted
    # reductions, while totalWeight accumulates naively with `+=`. Mixing
    # these up costs 1 ulp on random inputs.
    per_source: list[tuple[str, float, float, float]] = []
    total_weight = 0.0
    for sid in ordered_ids:
        entry = reliability_map.get(sid, {})
        reliability = entry.get("reliability", DEFAULT_RELIABILITY)
        confidence = entry.get("confidence", DEFAULT_CONFIDENCE)
        probs = by_source[sid]
        mean_prob = sum(probs) / len(probs)
        total_weight += reliability
        per_source.append((sid, mean_prob, reliability, confidence))

    if total_weight == 0:
        consensus: float | None = None
        overall_confidence = 0.0
    else:
        weighted_prob = sum(
            mean_prob * weight for _sid, mean_prob, weight, _conf in per_source
        )
        weighted_conf = sum(
            confidence * weight for _sid, _mean_prob, weight, confidence in per_source
        )
        consensus = weighted_prob / total_weight
        overall_confidence = weighted_conf / total_weight

    source_weights = [
        {
            "sourceId": sid,
            "weight": weight,
            "normalizedWeight": weight / total_weight if total_weight > 0 else 0.0,
        }
        for sid, _mean_prob, weight, _confidence in per_source
    ]

    return {
        "schemaVersion": SCHEMA_VERSION,
        "consensus": consensus,
        "confidence": overall_confidence,
        "sourceWeights": source_weights,
        "normalization": {
            "totalWeight": total_weight,
            "sourceCount": len(ordered_ids),
        },
        "diagnostics": {
            "status": "computed",
            "sources": len(signals),
            "uniqueSources": len(ordered_ids),
            "coldStartSources": [
                sid
                for sid, _mean_prob, _weight, _confidence in per_source
                if sid not in reliability_map
            ],
        },
    }
