"""PyTorch/CUDA port of the Bayesian consensus engine.

The JAX package ``bayesian_consensus_engine_tpu`` is the reference this
package is held against; nothing here imports it (or JAX). Layer map,
bottom → top, each module named after its JAX counterpart:

  utils/        constants (``config``), time conversion, interning, and
                the device/dtype policy (``device``)
  ops/          the cycle as plain tensor math (``decay``, ``update``,
                ``cycle_math``) and the hand-written CUDA settle kernel
                (``settle_kernel`` + ``csrc/settle_cycles.cu``)
  core/         host packing: payloads → ordered pair arrays (``batch``)
  state/        scalar decay/update math, the SQLite checkpoint backend,
                and the device-tensor store (``tensor_store``)
  pipeline      plan → settle → deferred absorb → SQLite checkpoint
  convert       build a store from either package's records

The device is explicit: a store is on CUDA unless ``device="cpu"`` is
passed, and without CUDA it raises. On CUDA every settle is one launch of
the settle kernel; on the CPU the kernel's plain torch version runs.
"""

from bayesian_consensus_engine_tpu_torch.pipeline import (
    SettlementPlan,
    SettlementResult,
    build_settlement_plan,
    build_settlement_plan_columnar,
    settle,
    settle_payloads,
)
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)

__all__ = [
    "SettlementPlan",
    "SettlementResult",
    "TensorReliabilityStore",
    "build_settlement_plan",
    "build_settlement_plan_columnar",
    "settle",
    "settle_payloads",
]
