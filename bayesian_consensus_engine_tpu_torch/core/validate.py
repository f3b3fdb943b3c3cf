"""Input-contract validation for the v1.0.0 payload schema.

A copy of ``bayesian_consensus_engine_tpu/core/validate.py``: the same
checks in the same order with the same messages, which downstream callers
and tests match on exactly.

Deliberately NOT enforced, as in the JAX package: ``additionalProperties``
(schema-input-v1.0.0.json declares false), ``weightHint``, source-id length
limits and MAX_SIGNALS_PER_REQUEST (declared in config, unenforced). NaN
and ``bool`` probabilities pass: NaN fails neither range comparison, and a
``bool`` is an ``int``.
"""

from __future__ import annotations

from typing import Any, Mapping

from bayesian_consensus_engine_tpu_torch.utils.config import SCHEMA_VERSION


class ValidationError(ValueError):
    """Input payload violates the v1.0.0 contract."""


def _field(payload: Mapping[str, Any], key: str) -> Any:
    try:
        return payload[key]
    except KeyError:
        raise ValidationError(f"{key} is required") from None


def validate_input_payload(payload: Mapping[str, Any]) -> None:
    """Reject payloads that violate the strict v1.0.0 input contract.

    Checks, in order:
      1. ``schemaVersion`` present and exactly "1.0.0"
      2. ``marketId`` present, a non-empty (non-whitespace) string
      3. ``signals`` present and a list
      4. each signal is an object with a non-empty ``sourceId`` string and a
         numeric ``probability`` in [0, 1]
    """
    version = _field(payload, "schemaVersion")
    if version != SCHEMA_VERSION:
        raise ValidationError(
            f"schemaVersion must be '{SCHEMA_VERSION}' (got '{version}')"
        )

    market_id = _field(payload, "marketId")
    if not isinstance(market_id, str) or not market_id.strip():
        raise ValidationError("marketId must be a non-empty string")

    signals = _field(payload, "signals")
    if not isinstance(signals, list):
        raise ValidationError("signals must be an array")

    for idx, signal in enumerate(signals):
        if not isinstance(signal, dict):
            raise ValidationError(f"signals[{idx}] must be an object")

        source_id = _field(signal, "sourceId")
        if not isinstance(source_id, str) or not source_id.strip():
            raise ValidationError(f"signals[{idx}].sourceId must be a non-empty string")

        probability = _field(signal, "probability")
        if not isinstance(probability, (int, float)):
            raise ValidationError(f"signals[{idx}].probability must be a number")
        if probability < 0 or probability > 1:
            raise ValidationError(f"signals[{idx}].probability must be between 0 and 1")
