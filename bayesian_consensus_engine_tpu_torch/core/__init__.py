"""Core consensus layer of the port: validation, the scalar engine, and the
host packing and batched array engine (``core/batch.py``)."""

from bayesian_consensus_engine_tpu_torch.utils.config import SCHEMA_VERSION
from bayesian_consensus_engine_tpu_torch.core.validate import (
    ValidationError,
    validate_input_payload,
)
from bayesian_consensus_engine_tpu_torch.core.engine import compute_consensus

__all__ = [
    "SCHEMA_VERSION",
    "ValidationError",
    "validate_input_payload",
    "compute_consensus",
]
