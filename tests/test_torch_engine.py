"""The port's validation and scalar engine ≡ the JAX package's.

Every payload goes through both validators (same pass, or same exception
type and message) and every signal set through both scalar engines, whose
documents must serialise to the same ``json.dumps`` bytes: seeded random
cases (``test_batch_parity.random_case``'s generator) and the four
fixtures, the golden one byte for byte against its stored output.
"""

import copy
import json
import math
import pathlib
import random

import pytest

from bayesian_consensus_engine_tpu.core import (
    ValidationError as JaxValidationError,
    compute_consensus as jax_compute_consensus,
    validate_input_payload as jax_validate,
)
from bayesian_consensus_engine_tpu_torch import core as tcore
from bayesian_consensus_engine_tpu_torch.core import (
    SCHEMA_VERSION,
    ValidationError,
    compute_consensus,
    validate_input_payload,
)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
FIXTURE_NAMES = [
    "golden_regression.json",
    "sim_uniform_agreement.json",
    "sim_polarized_split.json",
    "sim_single_outlier.json",
]


def random_case(rng: random.Random, max_sources: int = 9):
    """Random signals and a reliability table with absent, partial and full
    entries (the generator of ``test_batch_parity.random_case``)."""
    n = rng.randint(1, 25)
    signals = [
        {
            "sourceId": f"s-{rng.randint(0, max_sources)}",
            "probability": round(rng.random(), 6),
        }
        for _ in range(n)
    ]
    reliability = {}
    for sid in {s["sourceId"] for s in signals}:
        roll = rng.random()
        if roll < 0.4:
            reliability[sid] = {
                "reliability": round(rng.random(), 6),
                "confidence": round(rng.random(), 6),
            }
        elif roll < 0.5:
            reliability[sid] = {}  # present-but-partial: not cold-start
    return signals, (reliability or None)


def _load(name: str) -> dict:
    return json.loads((FIXTURES / name).read_text(encoding="utf-8"))


def _payload() -> dict:
    return {
        "schemaVersion": SCHEMA_VERSION,
        "marketId": "market-1",
        "signals": [
            {"sourceId": "agent-a", "probability": 0.6},
            {"sourceId": "agent-b", "probability": 0.4},
        ],
    }


def _drop(key):
    return lambda p: p.pop(key)


def _set(key, value):
    return lambda p: p.__setitem__(key, value)


def _signal(index, key, value=None, drop=False):
    def edit(p):
        if drop:
            del p["signals"][index][key]
        else:
            p["signals"][index][key] = value
    return edit


# Each edit of the valid payload, the reference's test_core cases first.
_PAYLOAD_EDITS = {
    "valid": lambda p: None,
    "no_schema_version": _drop("schemaVersion"),
    "schema_mismatch": _set("schemaVersion", "2.0.0"),
    "schema_not_string": _set("schemaVersion", 1),
    "market_blank": _set("marketId", "   "),
    "no_market": _drop("marketId"),
    "market_not_string": _set("marketId", 7),
    "signals_dict": _set("signals", {"sourceId": "a"}),
    "signals_tuple": _set("signals", ({"sourceId": "a", "probability": 0.5},)),
    "no_signals": _drop("signals"),
    "signals_empty": _set("signals", []),
    "signal_not_object": _set("signals", ["not-a-dict"]),
    "source_empty": _signal(1, "sourceId", ""),
    "source_blank": _signal(0, "sourceId", "  "),
    "source_not_string": _signal(0, "sourceId", 3),
    "no_source": _signal(1, "sourceId", drop=True),
    "prob_above": _signal(0, "probability", 1.2),
    "prob_below": _signal(1, "probability", -0.1),
    "prob_string": _signal(0, "probability", "0.5"),
    "prob_none": _signal(0, "probability", None),
    "no_prob": _signal(0, "probability", drop=True),
    # NaN fails neither range comparison and a bool is an int: both pass.
    "prob_nan": _signal(0, "probability", float("nan")),
    "prob_true": _signal(0, "probability", True),
    "prob_int": _signal(1, "probability", 0),
    "prob_edges": lambda p: (_signal(0, "probability", 0.0)(p),
                             _signal(1, "probability", 1.0)(p)),
}


def _outcome(validate, error_type, payload):
    try:
        validate(payload)
    except error_type as exc:
        return "raised", str(exc)
    return "passed", None


@pytest.mark.parametrize("edit", sorted(_PAYLOAD_EDITS))
def test_validation_matches_jax(edit):
    payload = _payload()
    _PAYLOAD_EDITS[edit](payload)
    ours = _outcome(validate_input_payload, ValidationError, copy.deepcopy(payload))
    theirs = _outcome(jax_validate, JaxValidationError, copy.deepcopy(payload))
    assert ours == theirs


def test_validation_error_is_value_error_and_reexported():
    assert issubclass(ValidationError, ValueError)
    assert tcore.engine.ValidationError is ValidationError
    assert tcore.engine.validate_input_payload is validate_input_payload
    with pytest.raises(ValidationError, match="^schemaVersion is required$"):
        validate_input_payload({})


@pytest.mark.parametrize("seed", range(150))
def test_scalar_engine_matches_jax_on_random_cases(seed):
    signals, reliability = random_case(random.Random(seed))
    ours = compute_consensus(signals, reliability)
    theirs = jax_compute_consensus(signals, reliability)
    assert json.dumps(ours) == json.dumps(theirs)


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_scalar_engine_matches_jax_on_fixtures(name):
    fixture = _load(name)
    validate_input_payload(fixture["input"])
    signals = fixture["input"]["signals"]
    ours = compute_consensus(signals)
    assert json.dumps(ours, indent=2) == json.dumps(
        jax_compute_consensus(signals), indent=2
    )
    assert json.loads(json.dumps(ours)) == ours
    if "expectedOutput" in fixture:
        assert json.dumps(ours, indent=2) == json.dumps(
            fixture["expectedOutput"], indent=2
        )


def test_golden_consensus_value():
    result = compute_consensus(_load("golden_regression.json")["input"]["signals"])
    assert result["consensus"] == 0.6966666666666667


# Edge cases beyond the random generator: empty, zero and negative total
# weight, duplicates, partial entries, NaN, -0.0, bool and int probabilities.
_EDGE_CASES = {
    "empty": ([], None),
    "zero_weight": ([{"sourceId": "a", "probability": 0.7}],
                    {"a": {"reliability": 0.0, "confidence": 0.5}}),
    "negative_weight": ([{"sourceId": "a", "probability": 0.7}],
                        {"a": {"reliability": -1.0, "confidence": 0.5}}),
    "duplicates": ([{"sourceId": "a", "probability": 0.2},
                    {"sourceId": "a", "probability": 0.4},
                    {"sourceId": "b", "probability": 0.9}], None),
    "partial_entry": ([{"sourceId": "a", "probability": 0.5}], {"a": {}}),
    "sorted_ids": ([{"sourceId": s, "probability": 0.5}
                    for s in ("zeta", "alpha", "mid")], None),
    "nan": ([{"sourceId": "a", "probability": float("nan")},
             {"sourceId": "b", "probability": 0.3}], None),
    "negative_zero": ([{"sourceId": "a", "probability": -0.0}],
                      {"a": {"reliability": 0.4, "confidence": -0.0}}),
    "bool_int": ([{"sourceId": "a", "probability": True},
                  {"sourceId": "b", "probability": 0},
                  {"sourceId": "a", "probability": 1}], None),
}


@pytest.mark.parametrize("case", sorted(_EDGE_CASES))
def test_scalar_engine_matches_jax_on_edge_cases(case):
    signals, reliability = _EDGE_CASES[case]
    ours = compute_consensus(signals, reliability)
    theirs = jax_compute_consensus(signals, reliability)
    assert json.dumps(ours) == json.dumps(theirs)
    if case == "nan":
        assert math.isnan(ours["consensus"])


def test_empty_document_is_fresh_per_call():
    first = compute_consensus([])
    first["diagnostics"]["dryRun"] = True
    first["sourceWeights"].append({"x": 1})
    second = compute_consensus([])
    assert "dryRun" not in second["diagnostics"]
    assert second["sourceWeights"] == []


@pytest.mark.parametrize("backend", ["cuda", "pyton", "JAX", ""])
def test_unknown_backend_message_matches_jax(backend):
    signals = [{"sourceId": "a", "probability": 0.5}]
    with pytest.raises(ValueError) as ours:
        compute_consensus(signals, backend=backend)
    with pytest.raises(ValueError) as theirs:
        jax_compute_consensus(signals, backend=backend)
    assert str(ours.value) == str(theirs.value) == f"unknown backend: {backend!r}"
