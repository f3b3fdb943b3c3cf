"""Multi-window SLO burn-rate health: "is the error budget on fire?"

The port's copy of the JAX package's ``obs/health.py``: the same windows,
thresholds, gauges and burn-rate bucket layout, so two monitors fed the
same outcome sequence (one per package) agree on every verdict.

A goodput fraction (obs/slo.py) says how much offered traffic completed
inside the objective; it cannot say whether the service is CURRENTLY
eating its error budget fast enough to matter. Multi-window burn rates
answer that over the outcome vocabulary :class:`~.obs.slo.SloTracker`
classifies into:

* the **error budget** is ``1 - objective_goodput`` (an objective of
  0.99 tolerates 1% of offered requests outside the SLO);
* a window's **burn rate** is its error fraction divided by the budget —
  burn 1.0 consumes the budget exactly at the tolerated pace, burn 10
  consumes it ten times too fast;
* the verdict is **burning** only when a FAST window and its paired
  SLOW window BOTH exceed the pair's threshold: the fast window gives
  detection latency, the slow window keeps one bad batch from paging.

Windows are measured in OUTCOMES, not seconds, which makes the verdict a
**pure function of the classified outcome sequence** (fixed windows,
fixed thresholds, no clock reads).

A second, orthogonal input is the **degraded flag**: a recovery in
progress (hosts absent, a re-band) is a health state burn rates cannot
see, so ``/healthz`` reports ``degraded`` through it. Precedence:
``degraded`` > ``burning`` > ``healthy``.

Stdlib-only, thread-safe, write-only with respect to settlement.
:attr:`HealthMonitor.burning` is a policy input for request admission,
never a settlement input.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from bayesian_consensus_engine_tpu_torch.obs.metrics import (
    log_spaced_bounds,
    metrics_registry,
)
from bayesian_consensus_engine_tpu_torch.obs.slo import OUTCOMES

#: Burn-rate observation layout: 0.01× → 1000× budget pace, 2 per decade
#: (11 edges). Pinned — bucket edges are schema.
BURN_RATE_BOUNDS = log_spaced_bounds(0.01, 1000.0, 2)


@dataclass(frozen=True)
class BurnWindow:
    """One fast/slow window pair with its paging threshold.

    ``fast``/``slow`` are outcome counts (the windows the burn rates are
    computed over); ``threshold`` is the burn-rate multiple BOTH windows
    must reach before the pair reports burning. Deterministic by
    construction — three numbers, no clocks.
    """

    fast: int
    slow: int
    threshold: float

    def __post_init__(self) -> None:
        if self.fast < 1:
            raise ValueError(f"fast window must be >= 1; got {self.fast}")
        if self.slow <= self.fast:
            raise ValueError(
                f"slow window must exceed fast ({self.fast}); got {self.slow}"
            )
        if not self.threshold > 0:
            raise ValueError(
                f"threshold must be > 0; got {self.threshold}"
            )


#: Default pairs: a tight pair that notices a hard regression within ~one
#: coalesced batch of traffic, and a wide pair that catches a slow leak.
#: (The classic 5%/1h + 10%/5m shape, re-expressed in outcome counts.)
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow(fast=64, slow=512, threshold=2.0),
    BurnWindow(fast=256, slow=2048, threshold=1.0),
)


class _OutcomeWindow:
    """Last-N outcome ring with an incremental error count (O(1) per
    record; no per-verdict rescan)."""

    __slots__ = ("_ring", "errors", "length")

    def __init__(self, length: int) -> None:
        self.length = length
        self._ring: deque = deque()
        self.errors = 0

    def push(self, is_error: bool) -> None:
        if len(self._ring) == self.length:
            if self._ring.popleft():
                self.errors -= 1
        self._ring.append(is_error)
        if is_error:
            self.errors += 1

    @property
    def n(self) -> int:
        return len(self._ring)

    def error_rate(self) -> Optional[float]:
        if not self._ring:
            return None
        return self.errors / len(self._ring)


class HealthMonitor:
    """Classified-outcome burn-rate evaluation against one objective.

    ``objective_goodput`` is the target fraction of offered traffic
    completing within the SLO (the error budget is its complement);
    ``windows`` are the fast/slow pairs. Feed every outcome the SLO
    tracker classifies through :meth:`record` (the serving layer wires
    this; the kill soak's workers feed it directly) and read
    :meth:`verdict` / :attr:`burning` back on the health surface.

    Metrics written per record (no-ops while obs is disabled):
    ``health.burn_rate_fast`` / ``health.burn_rate_slow`` gauges (the
    first pair — the paging pair), a ``health.burn_rate`` histogram of
    the fast rate on the pinned :data:`BURN_RATE_BOUNDS` layout, and the
    ``health.burning`` 0/1 gauge.
    """

    def __init__(
        self,
        objective_goodput: float = 0.99,
        windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
        metric_prefix: str = "health",
    ) -> None:
        if not 0.0 < objective_goodput < 1.0:
            raise ValueError(
                "objective_goodput must be in (0, 1) — 1.0 leaves no "
                f"error budget to burn; got {objective_goodput}"
            )
        if not windows:
            raise ValueError("need at least one BurnWindow pair")
        self.objective_goodput = float(objective_goodput)
        self.budget = 1.0 - self.objective_goodput
        self.windows: Tuple[BurnWindow, ...] = tuple(windows)
        self._lock = threading.Lock()
        # One ring per distinct window length, shared across pairs.
        lengths = sorted(
            {w.fast for w in self.windows} | {w.slow for w in self.windows}
        )
        self._rings: Dict[int, _OutcomeWindow] = {
            n: _OutcomeWindow(n) for n in lengths
        }
        self._recorded = 0
        self._degraded: Optional[str] = None
        #: Cached burning verdict, updated on every record() — window
        #: contents only change there, so the cache is exact and the
        #: hot-path :attr:`burning` read is one attribute fetch, never a
        #: per-arrival window rescan under the lock.
        self._last_burning = False
        registry = metrics_registry()
        # ``metric_prefix`` namespaces the written series so several
        # monitors can coexist in one process — the per-class
        # QoS monitors write ``serve.qos.<class>.health.*`` while the
        # service-wide monitor keeps the bare ``health.*`` vocabulary
        # (two monitors on ONE prefix would silently overwrite each
        # other's gauges).
        self.metric_prefix = str(metric_prefix)
        prefix = self.metric_prefix
        self._fast_gauge = registry.gauge(f"{prefix}.burn_rate_fast")
        self._slow_gauge = registry.gauge(f"{prefix}.burn_rate_slow")
        self._burning_gauge = registry.gauge(f"{prefix}.burning")
        self._burn_hist = registry.histogram(
            f"{prefix}.burn_rate", bounds=BURN_RATE_BOUNDS
        )

    # -- feeding -------------------------------------------------------------

    def record(self, outcome: str) -> None:
        """Feed one classified outcome (an :data:`~.obs.slo.OUTCOMES`
        member). ``met`` spends nothing; everything else — violated,
        shed, rejected, failed — burns budget, the same accounting rule
        goodput uses (refused and crash-eaten traffic count against)."""
        if outcome not in OUTCOMES:
            raise ValueError(
                f"outcome must be one of {OUTCOMES}; got {outcome!r}"
            )
        is_error = outcome != "met"
        with self._lock:
            for ring in self._rings.values():
                ring.push(is_error)
            self._recorded += 1
            first = self.windows[0]
            fast_rate = self._burn_rate_locked(first.fast)
            slow_rate = self._burn_rate_locked(first.slow)
            burning = self._last_burning = self._burning_locked()
        if fast_rate is not None:
            self._fast_gauge.set(fast_rate)
            self._burn_hist.observe(fast_rate)
        if slow_rate is not None:
            self._slow_gauge.set(slow_rate)
        self._burning_gauge.set(1.0 if burning else 0.0)

    # -- degraded flag (cluster recovery wiring) -----------------------------

    def set_degraded(self, reason: str) -> None:
        """Declare a non-burn health impairment (membership epoch bump,
        hosts absent) — ``/healthz`` reports ``degraded`` until cleared."""
        with self._lock:
            self._degraded = str(reason)

    def clear_degraded(self) -> None:
        with self._lock:
            self._degraded = None

    @property
    def degraded_reason(self) -> Optional[str]:
        with self._lock:
            return self._degraded

    # -- reading -------------------------------------------------------------

    def _burn_rate_locked(self, length: int) -> Optional[float]:
        rate = self._rings[length].error_rate()
        if rate is None:
            return None
        return rate / self.budget

    def _pair_states_locked(self) -> List[Dict[str, object]]:
        out = []
        for window in self.windows:
            fast_burn = self._burn_rate_locked(window.fast)
            slow_burn = self._burn_rate_locked(window.slow)
            burning = (
                fast_burn is not None
                and slow_burn is not None
                and fast_burn >= window.threshold
                and slow_burn >= window.threshold
            )
            out.append(
                {
                    "fast_n": window.fast,
                    "slow_n": window.slow,
                    "threshold": window.threshold,
                    "fast_burn": fast_burn,
                    "slow_burn": slow_burn,
                    "burning": burning,
                }
            )
        return out

    def _burning_locked(self) -> bool:
        return any(
            state["burning"] for state in self._pair_states_locked()
        )

    @property
    def burning(self) -> bool:
        """True while any pair's fast AND slow windows exceed its
        threshold — the serve admission signal. Reads the cache
        :meth:`record` maintains (window contents only change there),
        so the per-arrival admission check costs one attribute read."""
        return self._last_burning

    def verdict(self) -> Dict[str, object]:
        """The health verdict as data — what ``/healthz`` serves.

        ``verdict`` is ``degraded`` (flag set) > ``burning`` (any pair
        over threshold in both windows) > ``healthy``; the per-pair burn
        rates ride along so a dashboard can show how close to the line
        a healthy service is running.
        """
        with self._lock:
            pairs = self._pair_states_locked()
            burning = any(state["burning"] for state in pairs)
            degraded = self._degraded
            recorded = self._recorded
        if degraded is not None:
            verdict = "degraded"
        elif burning:
            verdict = "burning"
        else:
            verdict = "healthy"
        return {
            "verdict": verdict,
            "burning": burning,
            "degraded": degraded,
            "objective_goodput": self.objective_goodput,
            "budget": self.budget,
            "recorded": recorded,
            "windows": pairs,
        }
