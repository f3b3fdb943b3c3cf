"""Bounded admission for the serving front end: overload is a policy,
not an accident.

The port's copy of the JAX package's ``serve/admission.py`` (the code,
the counter names and the exception messages are the same; nothing here
touches the device). A service without an admission bound has one
overload behaviour, a queue whose p99 grows without limit. This module
makes the bound and the policy explicit:

* :class:`AdmissionConfig` — how many requests may be resident in the
  service at once (``max_pending``), what happens to the request that
  would exceed it (``policy``), and the retry hint a rejection carries
  (``retry_after_s``).
* ``policy="reject"`` — the arrival is refused with :class:`Overloaded`
  (carrying ``retry_after_s``): the client sees backpressure at once,
  and everything already admitted keeps its latency.
* ``policy="shed_oldest"`` — a pending (not yet flushed) request is
  dropped (its future fails with :class:`ShedError`) and the arrival is
  admitted: the newest data wins.

The controller only decides and counts (``serve.admitted`` /
``serve.rejected`` / ``serve.shed``); the coalescer owns the queue it
bounds. Deciding is O(1) and lock-free.

**Tenant classes.** :class:`QosClass` gives each class of tenant its
own latency objective (``slo_s``), admission budget (``max_pending``),
overload policy and burn-rate windows, so one
:class:`~.serve.coalesce.ConsensusService` can hold one class to a tight
objective while another absorbs the shedding:

* each class with ``shed_when_burning=True`` reads its OWN
  :class:`~.obs.health.HealthMonitor` (fed only that class's outcomes,
  written under ``serve.qos.<name>.health.*``), so one class burning its
  budget never makes another refuse;
* shedding is variance-aware (:func:`shed_rank_key`): the victim within
  a class is the pending request whose market the analytics tier reports
  widest (highest ``band_stderr``); unknown-band markets and ties fall
  back to arrival order, oldest first, so without analytics the policy
  is exactly shed-oldest. The ranking is a pure function of
  ``(stderr, arrival order)``, so the shed order is deterministic given
  the trace and the stderr map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from bayesian_consensus_engine_tpu_torch.obs.metrics import metrics_registry

_POLICIES = ("reject", "shed_oldest")


class ServeError(RuntimeError):
    """Base class for serving-layer request failures."""


class Overloaded(ServeError):
    """The service is at ``max_pending`` and the policy is ``reject``.

    ``retry_after_s`` is the client hint (the coalescer's flush cadence
    is the natural scale: one window's worth of capacity frees up per
    ``max_delay_s``); ``pending`` is the queue depth at rejection time.
    """

    def __init__(self, retry_after_s: float, pending: int) -> None:
        super().__init__(
            f"service overloaded ({pending} requests pending); "
            f"retry after {retry_after_s:.3f}s"
        )
        self.retry_after_s = retry_after_s
        self.pending = pending


class ShedError(ServeError):
    """This request was shed (dropped unsettled) under ``shed_oldest``."""


class ServiceClosed(ServeError):
    """Submitted after :meth:`ConsensusService.close` began draining."""


@dataclass(frozen=True)
class AdmissionConfig:
    """Overload knobs for :class:`~.serve.coalesce.ConsensusService`.

    ``max_pending`` bounds the requests resident in the SERVICE —
    submitted and not yet settled, so it covers both the coalescer's open
    windows and batches waiting on (or inside) the dispatch worker: when
    settlement is the bottleneck the bound still holds and overload
    surfaces as policy, not as an ever-deeper dispatch queue. ``policy``
    is one of ``"reject"`` / ``"shed_oldest"``.
    """

    max_pending: int = 4096
    policy: str = "reject"
    retry_after_s: float = 0.05
    #: The health signal: when True AND the service carries a
    #: burn-rate monitor (``ConsensusService(health=...)``) that reports
    #: :attr:`~.obs.health.HealthMonitor.burning`, arrivals follow the
    #: overload policy even BELOW ``max_pending`` — the error budget
    #: burning is overload by objective, not by queue depth. Off by
    #: default: the flag is an explicit policy opt-in, and with it off
    #: the admission sequence (and every settled byte) is unchanged.
    shed_when_burning: bool = False
    #: Probe admission under burn-driven overload: every Nth
    #: burn-refused arrival is admitted anyway, so fresh outcomes keep
    #: flowing into the monitor and a recovered service can CLEAR its
    #: burning verdict — without a probe, ``policy="reject"`` + burning
    #: would refuse everything forever (count-based windows never decay
    #: with time; only new outcomes move them). Deterministic: the
    #: probe is a pure function of the burn-refusal sequence. ``1``
    #: probes every burn arrival (burning never refuses).
    burn_probe_every: int = 8

    def __post_init__(self) -> None:
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if self.policy not in _POLICIES:
            raise ValueError(
                f"policy must be one of {_POLICIES}; got {self.policy!r}"
            )
        if self.retry_after_s < 0:
            raise ValueError("retry_after_s must be >= 0")
        if self.burn_probe_every < 1:
            raise ValueError("burn_probe_every must be >= 1")


@dataclass(frozen=True)
class QosClass:
    """One tenant class: its own SLO, admission budget, and burn policy.

    ``name`` keys the class on the wire (request frames carry it), in
    metric names (``serve.qos.<name>.*``), in snapshots, and in the
    fleet merge — restricted to ``[a-z0-9_-]`` so every surface renders
    it verbatim. ``slo_s`` is the class's latency objective (its OWN
    :class:`~.obs.slo.SloTracker`); ``max_pending`` bounds the class's
    resident requests; ``policy`` is the class overload policy
    (``shed_oldest`` sheds variance-aware WITHIN the class).
    ``burn_windows`` (a :class:`~.obs.health.BurnWindow` sequence, or
    None for the defaults) shapes the class's burn-rate monitor when
    ``shed_when_burning`` consumes it — per class, not global: one
    tenant's burning budget never refuses another tenant's traffic.
    """

    name: str
    slo_s: float
    max_pending: int
    policy: str = "reject"
    retry_after_s: float = 0.05
    burn_windows: Optional[Tuple] = None
    shed_when_burning: bool = False
    burn_probe_every: int = 8
    objective_goodput: float = 0.99

    def __post_init__(self) -> None:
        if not self.name or not all(
            c.isascii() and (c.isalnum() or c in "_-") for c in self.name
        ):
            raise ValueError(
                "QosClass name must be non-empty [a-zA-Z0-9_-]; got "
                f"{self.name!r}"
            )
        if not self.slo_s > 0:
            raise ValueError(f"slo_s must be > 0; got {self.slo_s}")
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if self.policy not in _POLICIES:
            raise ValueError(
                f"policy must be one of {_POLICIES}; got {self.policy!r}"
            )
        if self.burn_windows is not None:
            object.__setattr__(
                self, "burn_windows", tuple(self.burn_windows)
            )
        if not 0.0 < self.objective_goodput < 1.0:
            raise ValueError(
                "objective_goodput must be in (0, 1); got "
                f"{self.objective_goodput}"
            )


def shed_rank_key(
    band_stderr: Optional[float], arrival_seq: int
) -> Tuple[int, float, int]:
    """The variance-aware shed ordering, as a sortable key (min = victim).

    Widest band first: a market with high ``band_stderr`` is the market
    whose pending update the posterior will miss least (the analytics
    tier's per-market standard error). Markets with NO known band rank after every
    known one, and ties (including the all-unknown case) break by
    arrival order, oldest first — so without analytics the policy IS
    plain shed-oldest. Pure: three comparisons on two inputs,
    nothing read from clocks or identity.
    """
    known = band_stderr is not None
    return (
        0 if known else 1,
        -float(band_stderr) if known else 0.0,
        int(arrival_seq),
    )


class AdmissionController:
    """Decide accept/reject/shed for one arriving request.

    :meth:`decide` returns ``"accept"`` (room below the bound),
    ``"shed_oldest"`` (at the bound, shedding policy — the caller drops
    its oldest pending request, fails that request's future with
    :class:`ShedError`, and admits the arrival), or raises
    :class:`Overloaded` (at the bound, reject policy). Counters land in
    the process metrics registry; like all obs they are no-ops unless a
    registry is enabled.
    """

    def __init__(self, config: AdmissionConfig) -> None:
        self.config = config
        self._burn_seq = 0
        registry = metrics_registry()
        self._admitted = registry.counter("serve.admitted")
        self._rejected = registry.counter("serve.rejected")
        self._shed = registry.counter("serve.shed")

    def decide(self, pending: int, burning: bool = False) -> str:
        over = pending >= self.config.max_pending
        if not over and burning and self.config.shed_when_burning:
            # Burn-rate overload: the SLO budget is being spent too
            # fast, so the overload policy applies below the bound too
            # (an admission input, never a settlement input). Every Nth
            # burn arrival is admitted as a PROBE so the monitor keeps
            # seeing real outcomes and the verdict can clear.
            self._burn_seq += 1
            over = self._burn_seq % self.config.burn_probe_every != 0
        if not over:
            self._admitted.inc()
            return "accept"
        if self.config.policy == "reject":
            self._rejected.inc()
            raise Overloaded(self.config.retry_after_s, pending)
        # The shed outcome is not counted here: the caller may find
        # nothing left to shed (everything resident already dispatched)
        # and degrade to rejection — it reports which actually happened
        # via count_shed / count_degraded_reject, so the overload
        # counters never claim a shed that did not occur.
        return "shed_oldest"

    def count_shed(self) -> None:
        """A shed succeeded: the victim counts shed, the arrival admitted."""
        self._shed.inc()
        self._admitted.inc()

    def count_degraded_reject(self) -> None:
        """Nothing was sheddable: the arrival was rejected after all."""
        self._rejected.inc()
