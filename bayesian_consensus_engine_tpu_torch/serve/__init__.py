"""serve/ — drive settlement batches over a resident session.

The port's part of the JAX package's ``serve`` package so far:

* :mod:`~.serve.driver` — :class:`SessionDriver`, the ``settle_stream``
  loop body as a reusable drive-one-batch-over-a-resident-session API
  (dispatch + durability cadence + exit contract), :class:`PlanCache`,
  the topology-fingerprint plan-reuse step for caller-scheduled builds,
  and :func:`drive_trace`, which re-drives a recorded trace through them.
  ``settle_stream`` itself runs on the driver.

The coalescing front end (``serve/coalesce.py``) and admission control
(``serve/admission.py``) are not ported yet (ROADMAP queue 1 item 6).
"""

from bayesian_consensus_engine_tpu_torch.serve.driver import (
    PlanCache,
    SessionDriver,
    drive_trace,
)

__all__ = ["PlanCache", "SessionDriver", "drive_trace"]
