"""Operational constants — single source of truth for every tunable.

Values are a public contract: the reference pins each literal in its config
test suite (reference: tests/test_config.py:20-103) and centralises them in
src/bayesian_engine/config.py:17-39. Any change here is a behavioural change
for golden-fixture parity.

A copy of ``bayesian_consensus_engine_tpu/utils/config.py``: the port keeps
the same constants and parameter structs (``as_update_params`` /
``as_decay_params``) so both packages settle under one contract.
"""

from __future__ import annotations

from typing import NamedTuple

# --- Cold-start priors (reference: config.py:17-18) -------------------------
# A source with no recorded history enters the pool at these values.  Note the
# asymmetry: reliability 0.50 but confidence 0.25 — the reference's docstrings
# claim 0.50 confidence in places, but the code path (and test_config.py:24-26)
# always uses 0.25; we follow the code.
DEFAULT_RELIABILITY: float = 0.50
DEFAULT_CONFIDENCE: float = 0.25

# --- Post-outcome update (reference: config.py:22, reliability.py:34) -------
# A single outcome may move reliability by at most MAX_UPDATE_STEP.  The raw
# step before capping is BASE_LEARNING_RATE (the reference buries this one in
# its store module against its own centralisation policy; we centralise it).
MAX_UPDATE_STEP: float = 0.10
BASE_LEARNING_RATE: float = 0.15
# Each observed outcome closes this fraction of the gap between confidence
# and 1.0 (reference: reliability.py:172).
CONFIDENCE_GROWTH_RATE: float = 0.10

# --- Tie-breaking (reference: config.py:26) ---------------------------------
TIE_TOLERANCE: float = 1e-9

# --- Time decay (reference: config.py:30-31) --------------------------------
# Half-life model: after DECAY_HALF_LIFE_DAYS with no update, reliability is
# halfway from its stored value to DECAY_MINIMUM; it never crosses the floor.
DECAY_HALF_LIFE_DAYS: float = 30
DECAY_MINIMUM: float = 0.10

# --- I/O contract (reference: config.py:34) ---------------------------------
SCHEMA_VERSION: str = "1.0.0"

# --- Validation limits (reference: config.py:37-39) -------------------------
# Defined and pinned by tests but not enforced by the reference's validator;
# we keep the same (non-)enforcement for parity.
MIN_SOURCE_ID_LENGTH: int = 1
MAX_SOURCE_ID_LENGTH: int = 256
MAX_SIGNALS_PER_REQUEST: int = 1000


class UpdateParams(NamedTuple):
    """Scalar parameters of the post-outcome reliability update kernel."""

    base_learning_rate: float = BASE_LEARNING_RATE
    max_step: float = MAX_UPDATE_STEP
    confidence_growth: float = CONFIDENCE_GROWTH_RATE


class DecayParams(NamedTuple):
    """Scalar parameters of the exponential decay kernel."""

    half_life_days: float = DECAY_HALF_LIFE_DAYS
    floor: float = DECAY_MINIMUM


def as_update_params() -> UpdateParams:
    return UpdateParams()


def as_decay_params() -> DecayParams:
    return DecayParams()
