"""Append-only JSONL run ledger: every capture attributable, every
headline a band.

The port's copy of the JAX package's ``obs/ledger.py``: the same record
schema, field names and summaries, so a ledger either package writes
reads the same through either. A capture on a shared host is a single
draw from a noisy distribution; this module keeps the discipline of
min-of-N repeats with the host load recorded per trial:

* :class:`RunLedger` appends one JSON line per measurement, carrying the
  leg name, repeat index, value/unit, phase breakdown, host conditions
  (loadavg, cpu count, pid), backend identity, and a wall timestamp.
  Lines are written with sorted keys (deterministic bytes for identical
  records) and flushed per record, so a killed run keeps every completed
  measurement; a torn final line is dropped on read, like a journal's
  torn tail epoch.
* :func:`min_of_repeats` is the min-of-N policy helper: the published
  number is the minimum over repeats (host-load noise only ever ADDS
  time), and the min–max band rides along.
* :func:`summarize` folds a ledger into per-leg bands,
  :func:`diff_bands` compares two, and :func:`render` /
  :func:`render_diff` print them.

The ``hbm_*`` fields keep the record's names; in the port they carry the
card's allocator figures (``utils.profiling.device_memory_stats``).

The ledger never feeds back into measurement or settlement — it is an
output-only record, which is why writing one cannot perturb the numbers
it records. Stdlib-only.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

#: Bump when a record field changes meaning; readers key off this.
SCHEMA_VERSION = 1


def host_snapshot() -> Dict[str, object]:
    """Host conditions at record time: the attribution context.

    ``loadavg_1m`` is the number that adjudicates a slow capture (a
    host-bound leg under load 3 on a 1-core box is not a regression);
    platforms without ``getloadavg`` record ``None`` rather than lying.
    """
    try:
        load1, load5, load15 = os.getloadavg()
        loadavg = {
            "loadavg_1m": round(load1, 3),
            "loadavg_5m": round(load5, 3),
            "loadavg_15m": round(load15, 3),
        }
    except (AttributeError, OSError):
        loadavg = {"loadavg_1m": None, "loadavg_5m": None, "loadavg_15m": None}
    return {
        "cpu_count": os.cpu_count(),
        "pid": os.getpid(),
        **loadavg,
    }


class RunLedger:
    """Appends measurement records to one JSONL file.

    Append-only by construction: an existing file is extended, never
    truncated, so one ledger accumulates a round's captures across
    processes (each record carries its pid + run id). Each record is
    flushed before :meth:`record` returns.
    """

    def __init__(
        self,
        path: Union[str, Path],
        run_id: Optional[str] = None,
        backend: Optional[str] = None,
    ) -> None:
        self._path = str(path)
        self._run_id = run_id or f"{int(time.time())}-{os.getpid()}"
        self._backend = backend
        self._seq = 0
        self._file = open(self._path, "a", encoding="utf-8")

    @property
    def path(self) -> str:
        return self._path

    @property
    def run_id(self) -> str:
        return self._run_id

    def record(
        self,
        leg: str,
        value: Optional[float] = None,
        unit: Optional[str] = None,
        repeat: int = 0,
        phases: Optional[Dict[str, float]] = None,
        extras: Optional[Dict[str, object]] = None,
    ) -> Dict[str, object]:
        """Append one measurement record; returns the record dict.

        *repeat* is the trial index within a min-of-N leg (0-based).
        *phases* is a :meth:`~.timeline.PhaseTimeline.totals`-shaped
        breakdown. *extras* rides along verbatim (must be JSON-safe).
        """
        entry = {
            "schema": SCHEMA_VERSION,
            "run_id": self._run_id,
            "seq": self._seq,
            "leg": leg,
            "repeat": int(repeat),
            "value": value,
            "unit": unit,
            "backend": self._backend,
            "wall_unix_ts": time.time(),
            "host": host_snapshot(),
            "phases": dict(phases or {}),
            "extras": dict(extras or {}),
        }
        self._file.write(json.dumps(entry, sort_keys=True) + "\n")
        self._file.flush()
        self._seq += 1
        return entry

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()

    def __enter__(self) -> "RunLedger":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()


def read_ledger(path: Union[str, Path]) -> List[Dict[str, object]]:
    """Parse a ledger file; a torn/garbage FINAL line is dropped, torn
    interior lines raise (an interior parse failure means the file is not
    an append-only ledger — refuse to guess)."""
    records: List[Dict[str, object]] = []
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                break  # torn tail: the process died mid-append
            raise ValueError(f"{path}: malformed ledger line {i + 1}")
    return records


def min_of_repeats(
    records: List[Dict[str, object]], leg: str
) -> Optional[Dict[str, object]]:
    """The min-of-N policy applied to one leg's records.

    Returns ``{"leg", "n", "min", "max", "spread_pct", "unit",
    "loadavg_1m_range"}`` over every record of *leg* that carries a
    numeric value, or ``None`` when there are none. ``min`` is the
    publishable number (load noise only ever adds time — for a
    throughput-style value the caller wants ``max``; both are here).
    """
    values = []
    loads = []
    unit = None
    for rec in records:
        if rec.get("leg") != leg:
            continue
        value = rec.get("value")
        if not isinstance(value, (int, float)):
            continue
        values.append(float(value))
        unit = rec.get("unit") or unit
        load = (rec.get("host") or {}).get("loadavg_1m")
        if isinstance(load, (int, float)):
            loads.append(float(load))
    if not values:
        return None
    lo, hi = min(values), max(values)
    band = {
        "leg": leg,
        "n": len(values),
        "min": lo,
        "max": hi,
        "spread_pct": round((hi - lo) / lo * 100.0, 1) if lo else None,
        "unit": unit,
        "loadavg_1m_range": (
            [min(loads), max(loads)] if loads else None
        ),
    }
    band.update(_latency_quantiles(records, leg))
    band.update(_slo_summary(records, leg))
    band.update(_qos_summary(records, leg))
    band.update(_ingest_wait_summary(records, leg))
    band.update(_intern_summary(records, leg))
    band.update(_peak_mem_summary(records, leg))
    band.update(_hbm_read_summary(records, leg))
    band.update(_recovery_summary(records, leg))
    band.update(_replay_summary(records, leg))
    band.update(_bp_iters_summary(records, leg))
    band.update(_autotune_summary(records, leg))
    return band


def _autotune_summary(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """Recorded tuner verdicts carried by a leg's records.

    Kernel-bearing legs record the honesty-guarded adjudication next to
    their timings (``extras["autotune_decision"]`` /
    ``extras["bp_autotune_decision"]`` / any ``*autotune_decision`` key —
    the ``choice``/``default``/``beat_default`` entry plus the
    ``source`` tag: ``"race"`` for a verdict this host measured,
    ``"bank"`` for one served from a loaded autotune bank). The LAST
    recorded verdict per key wins (repeats re-read the same cache entry;
    the freshest read is the one the leg acted on). Rendered as a
    follow-up line under the leg row, and diffed by ``--against`` with
    an explicit verdict-flip flag.
    """
    decisions: Dict[str, Dict[str, object]] = {}
    for rec in records:
        if rec.get("leg") != leg:
            continue
        extras = rec.get("extras") or {}
        for key, value in extras.items():
            if not str(key).endswith("autotune_decision"):
                continue
            if isinstance(value, dict) and "choice" in value:
                decisions[str(key)] = {
                    field: value.get(field)
                    for field in (
                        "choice", "default", "beat_default", "source"
                    )
                }
    return {"autotune": decisions} if decisions else {}


def _min_extras_summary(
    records: List[Dict[str, object]],
    leg: str,
    key: str,
    positive_only: bool = False,
) -> Dict[str, object]:
    """``{key: min over the leg's extras[key]}`` — the shared fold under
    every per-metric summary below (the min-of-N reading the wall band
    uses). Legs without the extra contribute nothing, so the stats table
    renders a dash. ``positive_only`` additionally drops zeros (sampled
    metrics whose backends report 0 for "no data", e.g. CPU allocator
    stats)."""
    values = [
        (rec.get("extras") or {}).get(key)
        for rec in records
        if rec.get("leg") == leg
    ]
    values = [
        v for v in values
        if isinstance(v, (int, float)) and (not positive_only or v > 0)
    ]
    if not values:
        return {}
    return {key: min(values)}


def _recovery_summary(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """Best-case recovery latency over a leg's records.

    Records carrying ``extras["recovery_s"]`` (the kill-soak
    leg: seconds from the worker kill to the first re-settled dead-band
    batch on the degraded membership) fold to their MINIMUM across
    repeats. Next to the merged ``goodput_within_slo`` (``extras.slo``)
    this is the whole failure story in one stats row: how much offered
    traffic survived the objective, and how long the stream was
    degraded.
    """
    return _min_extras_summary(records, leg, "recovery_s")


def _replay_summary(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """Worst-case replay-sweep throughput over a leg's records.

    Records carrying ``extras["replay_batches_per_s"]`` (the
    ``e2e_replay_sweep`` leg: recorded batches re-driven per second by
    the K-lane vmapped sweep) fold to their MINIMUM across repeats — for
    a throughput the min is the conservative publishable reading, the
    same policy as every other extras column (host load only ever
    SHRINKS a rate). A regression that de-amortises the sweep (per-lane
    plan builds creeping back, a program-cache miss per batch) shows up
    as this column collapsing toward the sequential baseline in the
    same stats/``--against`` workflow as hbm_read.
    """
    return _min_extras_summary(
        records, leg, "replay_batches_per_s", positive_only=True
    )


def _bp_iters_summary(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """Best-case adaptive sweep depth over a leg's records.

    Records carrying ``extras["bp_iters"]`` (the ``e2e_infer``
    leg: the adaptive moment sweep's deterministic trip count on the
    sparse workload) fold to their MINIMUM across repeats — though the
    count is a pure function of the inputs, so repeats agree and the
    fold is a formality; a CHANGE in this column between ledgers is the
    signal (``--against`` diffs it): the sweep math, the tolerance, or
    the workload moved, never the host.
    """
    return _min_extras_summary(records, leg, "bp_iters", positive_only=True)


def _peak_mem_summary(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """Best-case peak device memory over a leg's records.

    Records carrying ``extras["hbm_peak_bytes"]`` (the device-memory legs:
    the allocator's peak-bytes high-water mark sampled after the timed
    region) fold to their MINIMUM across repeats — the repeat least
    polluted by co-resident allocations is the leg's own footprint, the
    same min-of-N reading the wall band uses. Legs without the extra (and
    CPU backends, which expose no allocator stats) contribute nothing, so
    the stats table renders a dash. This is how a memory regression shows
    up in the same stats/``--against`` workflow as a wall-time
    regression .
    """
    return _min_extras_summary(
        records, leg, "hbm_peak_bytes", positive_only=True
    )


def _hbm_read_summary(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """Best-case per-settle HBM read bytes over a leg's records.

    Records carrying ``extras["hbm_read_bytes"]`` (the one-pass
    legs: argument + temp bytes of the AOT-compiled settle program that
    actually ran — every argument byte is read at least once and every
    temp byte written then read, so the sum is the program's
    bytes-read-per-settle floor) fold to their MINIMUM across repeats.
    This is the single-pass vs multi-pass sweep story in the same
    stats/``--against`` workflow as peak_mem: a kernel
    regression that re-grows the read traffic shows up as the hbm_read
    column shifting up.
    """
    return _min_extras_summary(
        records, leg, "hbm_read_bytes", positive_only=True
    )


def _ingest_wait_summary(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """Best-case ingest wait over a leg's records.

    Records carrying ``extras["ingest_wait_s"]`` (the stream/serve bench
    legs: consumer seconds blocked on plan builds) fold to their MINIMUM
    across repeats — the min-of-N reading that matches the wall band's
    policy (a loaded-host repeat inflates the wait; the best repeat is
    the machine's capability). Legs without the extra contribute
    nothing, so the stats table renders a dash.
    """
    return _min_extras_summary(records, leg, "ingest_wait_s")


def _intern_summary(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """Best-case pair-interning seconds over a leg's records.

    Records carrying ``extras["intern_s"]`` (the ingest/stream/
    serve legs: seconds inside the pair-interning pass — the slice of
    ingest that cannot overlap onto a pack thread because interning
    order IS row assignment) fold to their MINIMUM across repeats. The
    delta-interning path's whole point is driving this column toward
    zero for drifting topologies; a regression shows up here in the same
    stats/``--against`` workflow as ingest_wait.
    """
    return _min_extras_summary(records, leg, "intern_s")


def _latency_quantiles(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """p50/p99 over a leg's per-request latency distributions.

    Records that carry ``extras["latency_hist"]`` (a
    :meth:`~.metrics.Histogram.snapshot` dict — the serving bench's
    per-request record) are MERGED across repeats by summing bucket
    counts (legal only for identical bounds; a layout mismatch raises —
    the layout is part of the schema), then folded into p50/p99 via the
    shared bucket interpolation. Legs without latency records contribute
    nothing — the keys stay absent so the stats table renders dashes.
    """
    from bayesian_consensus_engine_tpu_torch.obs.metrics import (
        quantile_from_snapshot,
    )

    merged_bounds = None
    merged_counts: List[int] = []
    for rec in records:
        if rec.get("leg") != leg:
            continue
        hist = (rec.get("extras") or {}).get("latency_hist")
        if not isinstance(hist, dict):
            continue
        bounds = list(hist.get("bounds") or [])
        counts = list(hist.get("counts") or [])
        if merged_bounds is None:
            merged_bounds, merged_counts = bounds, counts
        else:
            if bounds != merged_bounds:
                raise ValueError(
                    f"leg {leg!r}: latency_hist bucket layouts differ "
                    "across records — cannot merge repeats"
                )
            merged_counts = [
                a + b for a, b in zip(merged_counts, counts)
            ]
    if merged_bounds is None:
        return {}
    snap = {"bounds": merged_bounds, "counts": merged_counts}
    return {
        "p50": quantile_from_snapshot(snap, 0.5),
        "p99": quantile_from_snapshot(snap, 0.99),
    }


def _slo_summary(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """Merged SLO/goodput accounting over a leg's records.

    Records carrying ``extras["slo"]`` (an
    :meth:`~.slo.SloTracker.snapshot`-shaped dict — the serving bench's
    per-act record) are merged across repeats by summing per-outcome
    ``counts``; the merged ``goodput_within_slo`` fraction (met /
    offered, refused traffic counting against — the goodput-within-
    objective framing) lands in the band next to the latency quantiles.
    Legs without SLO records contribute nothing, so the stats table
    renders dashes.
    """
    from bayesian_consensus_engine_tpu_torch.obs.slo import goodput_from_counts

    merged: Dict[str, int] = {}
    objective = None
    for rec in records:
        if rec.get("leg") != leg:
            continue
        slo = (rec.get("extras") or {}).get("slo")
        if not isinstance(slo, dict):
            continue
        counts = slo.get("counts")
        if not isinstance(counts, dict):
            continue
        for name in sorted(counts):
            value = counts[name]
            if isinstance(value, (int, float)):
                merged[name] = merged.get(name, 0) + int(value)
        if isinstance(slo.get("objective_s"), (int, float)):
            objective = float(slo["objective_s"])
    if not merged:
        return {}
    return {
        "slo_objective_s": objective,
        "slo_counts": merged,
        "goodput_within_slo": goodput_from_counts(merged),
        # Every offered-but-not-met outcome, summed: the absolute SLO
        # damage next to the goodput fraction (a goodput dip over 10
        # offered and one over 10k read very differently) — the `slo`
        # stats column, diffed by --against like hbm_read.
        "slo_violations": sum(
            int(v) for k, v in merged.items() if k != "met"
        ),
    }


def _qos_summary(
    records: List[Dict[str, object]], leg: str
) -> Dict[str, object]:
    """Merged per-class QoS accounting over a leg's records.

    Records carrying ``extras["qos"]`` (class name →
    ``{slo_s, counts}`` — the ``e2e_netserve`` acts record the
    service's :meth:`~.serve.coalesce.ConsensusService.qos_snapshot`)
    merge across repeats by summing each class's per-outcome counts —
    the same rule as the global ``extras.slo`` fold, applied per class.
    The class vocabulary is schema: records of one leg disagreeing on
    the class-name set or a class's ``slo_s`` refuse, like a
    latency-histogram layout mismatch. The band gains
    ``qos: {class: {slo_s, counts, goodput_within_slo,
    slo_violations}}`` — the per-class goodput/slo columns the stats renderer renders under the leg row and ``--against`` diffs.
    """
    from bayesian_consensus_engine_tpu_torch.obs.slo import goodput_from_counts

    merged: Dict[str, Dict[str, object]] = {}
    for rec in records:
        if rec.get("leg") != leg:
            continue
        qos = (rec.get("extras") or {}).get("qos")
        if not isinstance(qos, dict) or not qos:
            continue
        if merged and sorted(qos) != sorted(merged):
            raise ValueError(
                f"leg {leg!r}: QoS class vocabularies differ across "
                f"records ({sorted(merged)} vs {sorted(qos)}) — the "
                "class list is schema; cannot merge repeats"
            )
        for name in sorted(qos):
            record = qos[name] or {}
            slo_s = record.get("slo_s")
            held = merged.setdefault(
                name, {"slo_s": slo_s, "counts": {}}
            )
            if held["slo_s"] != slo_s:
                raise ValueError(
                    f"leg {leg!r}: class {name!r} declares slo_s="
                    f"{slo_s} vs {held['slo_s']} across records — "
                    "cannot merge repeats"
                )
            counts = record.get("counts")
            if not isinstance(counts, dict):
                continue
            for outcome in sorted(counts):
                value = counts[outcome]
                if isinstance(value, (int, float)):
                    held["counts"][outcome] = (
                        held["counts"].get(outcome, 0) + int(value)
                    )
    if not merged:
        return {}
    for name, held in merged.items():
        counts = held["counts"]
        held["goodput_within_slo"] = goodput_from_counts(counts)
        held["slo_violations"] = sum(
            int(v) for k, v in counts.items() if k != "met"
        )
    return {"qos": merged}


def summarize(records: List[Dict[str, object]]) -> Dict[str, Dict[str, object]]:
    """Per-leg min/max bands over a whole ledger, legs sorted by name."""
    legs = sorted({rec.get("leg") for rec in records if rec.get("leg")})
    out: Dict[str, Dict[str, object]] = {}
    for leg in legs:
        band = min_of_repeats(records, leg)
        if band is None:
            n = sum(1 for rec in records if rec.get("leg") == leg)
            band = {"leg": leg, "n": n, "min": None, "max": None,
                    "spread_pct": None, "unit": None,
                    "loadavg_1m_range": None}
            # Value-less summary records (the --leg entry point's
            # dict-result legs, e.g. pallas_ab) still carry tuner
            # adjudications worth rendering.
            band.update(_autotune_summary(records, leg))
        out[leg] = band
    return out


def diff_bands(
    old_records: List[Dict[str, object]],
    new_records: List[Dict[str, object]],
) -> Dict[str, Dict[str, object]]:
    """Cross-round band comparison — the regression signal as data.

    For every leg in either ledger, compare the old and new min–max bands
    (``min_of_repeats``). ``status`` per leg:

    * ``"overlap"`` — the bands share at least one value: the rounds are
      statistically indistinguishable under the min-of-N policy (the
      adjudication the VERDICT previously extracted by hand).
    * ``"shifted_up"`` / ``"shifted_down"`` — the bands stopped
      overlapping (``new.min > old.max`` / ``new.max < old.min``). Which
      direction is the regression depends on the leg's unit — seconds up
      is worse, cycles/sec up is better — so the diff reports direction
      and leaves the verdict to the reader (the unit rides along).
    * ``"old_only"`` / ``"new_only"`` — the leg has numeric values in
      only one ledger (added, removed, or failed legs).

    The ``old``/``new`` bands are included verbatim so a renderer (or a
    round note) can quote the ranges, not just the flag. Legs whose
    bands carry the merged per-request latency quantiles
    (``extras.latency_hist`` → ``p50``/``p99``) or SLO accounting
    (``extras.slo`` → ``goodput_within_slo``) additionally get a
    ``metrics`` mapping with each side's value — the serving leg's p99
    and goodput move across rounds even when the wall band overlaps, and
    a diff that ignored them would miss exactly the regressions the
    latency records exist to catch.
    """
    old_summary = summarize(old_records)
    new_summary = summarize(new_records)
    out: Dict[str, Dict[str, object]] = {}
    for leg in sorted(set(old_summary) | set(new_summary)):
        old_band = old_summary.get(leg)
        new_band = new_summary.get(leg)
        has_old = old_band is not None and old_band["min"] is not None
        has_new = new_band is not None and new_band["min"] is not None
        if not has_old and not has_new:
            status = "no_values"
        elif not has_old:
            status = "new_only"
        elif not has_new:
            status = "old_only"
        elif new_band["min"] > old_band["max"]:
            status = "shifted_up"
        elif new_band["max"] < old_band["min"]:
            status = "shifted_down"
        else:
            status = "overlap"
        entry: Dict[str, object] = {"leg": leg, "status": status,
                                    "old": old_band, "new": new_band}
        metrics: Dict[str, Dict[str, object]] = {}
        for name in ("p50", "p99", "goodput_within_slo", "slo_violations",
                     "ingest_wait_s", "intern_s", "hbm_peak_bytes",
                     "hbm_read_bytes", "recovery_s",
                     "replay_batches_per_s", "bp_iters"):
            old_value = (old_band or {}).get(name)
            new_value = (new_band or {}).get(name)
            if old_value is not None or new_value is not None:
                metrics[name] = {"old": old_value, "new": new_value}
        # Per-class QoS metrics: each class's goodput and
        # absolute SLO-damage count diff under a ``qos.<class>.<label>``
        # key, so a premium-class regression shows up even when the
        # global goodput (best-effort-dominated) moved the other way.
        old_qos = (old_band or {}).get("qos") or {}
        new_qos = (new_band or {}).get("qos") or {}
        for cls in sorted(set(old_qos) | set(new_qos)):
            for field, label in (
                ("goodput_within_slo", "goodput"),
                ("slo_violations", "slo"),
            ):
                old_value = (old_qos.get(cls) or {}).get(field)
                new_value = (new_qos.get(cls) or {}).get(field)
                if old_value is not None or new_value is not None:
                    metrics[f"qos.{cls}.{label}"] = {
                        "old": old_value, "new": new_value,
                    }
        # Tuner verdicts: diff each recorded adjudication's
        # choice and flag a VERDICT FLIP explicitly — a kernel that won
        # last round and lost this one is exactly the re-adjudication
        # signal the honesty guard exists to surface, and it can flip
        # with both wall bands still overlapping.
        old_autotune = (old_band or {}).get("autotune") or {}
        new_autotune = (new_band or {}).get("autotune") or {}
        for name in sorted(set(old_autotune) | set(new_autotune)):
            old_verdict = old_autotune.get(name)
            new_verdict = new_autotune.get(name)
            old_choice = (old_verdict or {}).get("choice")
            new_choice = (new_verdict or {}).get("choice")
            record: Dict[str, object] = {
                "old": old_choice, "new": new_choice,
            }
            if (
                old_verdict is not None
                and new_verdict is not None
                and old_choice != new_choice
            ):
                record["verdict_flip"] = True
            source = (new_verdict or {}).get("source")
            if source is not None:
                record["source"] = source
            metrics[f"autotune.{name}"] = record
        if metrics:
            entry["metrics"] = metrics
        out[leg] = entry
    return out


def render_diff(diff: Dict[str, Dict[str, object]]) -> str:
    """Human-readable cross-round table for the ``--against`` comparison.

    Legs with merged latency/SLO metrics get a ``p99 old→new`` (and
    ``goodput old→new``) trailer so the serving leg's per-request story
    diffs alongside its wall band.  Kernel-bearing legs with recorded
    autotune adjudications get an ``autotune.* old->new`` trailer, with
    ``FLIP`` appended when the verdict changed between rounds.
    """
    if not diff:
        return "no legs in either ledger"

    def band_str(band):
        if band is None or band["min"] is None:
            return "-"
        return f"{band['min']:.4g}..{band['max']:.4g}"

    def metric_str(entry, name):
        metric = (entry.get("metrics") or {}).get(name)
        if not metric:
            return ""
        def num(x):
            if isinstance(x, str):
                return x
            return f"{x:.4g}" if isinstance(x, (int, float)) else "-"
        label = {
            "goodput_within_slo": "goodput",
            "slo_violations": "slo",
            "ingest_wait_s": "ingest_wait",
            "intern_s": "intern",
            "hbm_peak_bytes": "peak_mem",
            "hbm_read_bytes": "hbm_read",
            "recovery_s": "recovery",
            "replay_batches_per_s": "replay",
            "bp_iters": "iters",
        }.get(name, name)
        flip = " FLIP" if metric.get("verdict_flip") else ""
        return f"  {label} {num(metric['old'])}->{num(metric['new'])}{flip}"

    lines = [
        f"{'leg':<34} {'old band':>16} {'new band':>16} {'status':>13} unit"
    ]
    moved = 0
    for leg, entry in diff.items():
        band = entry["new"] or entry["old"]
        unit = (band or {}).get("unit") or "-"
        if entry["status"] in ("shifted_up", "shifted_down"):
            moved += 1
        trailer = "".join(
            metric_str(entry, name)
            for name in ("p99", "goodput_within_slo", "slo_violations",
                         "ingest_wait_s", "intern_s", "hbm_peak_bytes",
                         "hbm_read_bytes", "recovery_s",
                         "replay_batches_per_s", "bp_iters")
        )
        trailer += "".join(
            metric_str(entry, name)
            for name in sorted(entry.get("metrics") or {})
            if name.startswith("qos.") or name.startswith("autotune.")
        )
        lines.append(
            f"{leg:<34} {band_str(entry['old']):>16} "
            f"{band_str(entry['new']):>16} {entry['status']:>13} {unit}"
            f"{trailer}"
        )
    lines.append(
        f"{moved} leg(s) stopped overlapping"
        if moved
        else "all shared legs overlap"
    )
    return "\n".join(lines)


def render(records: List[Dict[str, object]]) -> str:
    """Human-readable per-leg table for the stats renderer.

    The ``p50``/``p99`` columns render for legs whose records carry
    per-request latency distributions (``extras.latency_hist`` — the
    serving bench), ``goodput`` and ``slo`` for legs carrying SLO
    accounting (``extras.slo`` — the fraction of offered requests that
    completed within the objective, and the absolute count that did
    NOT: violated + shed + rejected + failed, merged across repeats),
    ``ingest_w`` for legs carrying consumer
    ingest-wait seconds (``extras.ingest_wait_s`` — the stream/serve
    legs; ≈ 0 means packing fully overlapped behind device compute),
    ``intern`` for legs carrying pair-interning seconds
    (``extras.intern_s`` — the delta-interning signal: the
    slice of ingest that cannot overlap because interning order IS row
    assignment), ``peak_mem`` for legs carrying the device allocator's
    high-water mark (``extras.hbm_peak_bytes``, min across repeats — the
    memory-diet regression signal), and ``hbm_read`` for legs carrying
    per-settle bytes-read captures (``extras.hbm_read_bytes`` — the
    one-pass sweep signal), and ``replay`` for legs carrying
    the counterfactual-sweep throughput (``extras.replay_batches_per_s``
    — the ``e2e_replay_sweep`` leg: recorded batches per
    second through the K-lane vmapped replay, min across repeats), and
    ``iters`` for legs carrying the adaptive sweep's deterministic trip
    count (``extras.bp_iters`` — the ``e2e_infer`` leg; a
    change here means the sweep math, tolerance, or workload moved);
    every other leg shows dashes.
    """
    summary = summarize(records)
    if not summary:
        return "empty ledger"
    lines = [
        f"{'leg':<34} {'n':>3} {'min':>12} {'max':>12} "
        f"{'spread':>7} {'p50':>9} {'p99':>9} {'goodput':>8} {'slo':>7} "
        f"{'ingest_w':>9} {'intern':>9} {'peak_mem':>9} {'hbm_read':>9} "
        f"{'recovery':>9} {'replay':>8} {'iters':>6} {'load(1m)':>12} unit"
    ]
    for leg, band in summary.items():

        def num(x):
            return f"{x:.4g}" if isinstance(x, (int, float)) else "-"

        load_range = band["loadavg_1m_range"]
        load = (
            f"{load_range[0]:.2f}-{load_range[1]:.2f}"
            if load_range
            else "-"
        )
        spread = (
            f"{band['spread_pct']:.1f}%"
            if isinstance(band["spread_pct"], (int, float))
            else "-"
        )
        goodput = band.get("goodput_within_slo")
        goodput_str = (
            f"{goodput * 100:.1f}%"
            if isinstance(goodput, (int, float))
            else "-"
        )
        def mb(value):
            return (
                f"{value / 1e6:.0f}MB"
                if isinstance(value, (int, float))
                else "-"
            )

        peak_str = mb(band.get("hbm_peak_bytes"))
        read_str = mb(band.get("hbm_read_bytes"))
        violations = band.get("slo_violations")
        slo_str = (
            str(int(violations))
            if isinstance(violations, (int, float))
            else "-"
        )
        lines.append(
            f"{leg:<34} {band['n']:>3} {num(band['min']):>12} "
            f"{num(band['max']):>12} {spread:>7} "
            f"{num(band.get('p50')):>9} {num(band.get('p99')):>9} "
            f"{goodput_str:>8} {slo_str:>7} "
            f"{num(band.get('ingest_wait_s')):>9} "
            f"{num(band.get('intern_s')):>9} "
            f"{peak_str:>9} {read_str:>9} {num(band.get('recovery_s')):>9} "
            f"{num(band.get('replay_batches_per_s')):>8} "
            f"{num(band.get('bp_iters')):>6} "
            f"{load:>12} {band['unit'] or '-'}"
        )
        # QoS-carrying legs (extras.qos — the e2e_netserve acts) get a
        # per-class goodput/slo follow-up line under the leg row: the
        # tiering verdict reads class by class, not as one global
        # fraction.
        qos = band.get("qos")
        if qos:
            parts = []
            for cls in sorted(qos):
                record = qos[cls]
                cls_goodput = record.get("goodput_within_slo")
                cls_goodput_str = (
                    f"{cls_goodput * 100:.1f}%"
                    if isinstance(cls_goodput, (int, float)) else "-"
                )
                parts.append(
                    f"{cls}: goodput {cls_goodput_str} "
                    f"slo {record.get('slo_violations', '-')}"
                )
            lines.append(f"{'':<6}qos  " + " | ".join(parts))
        # Kernel-bearing legs with recorded tuner adjudications
        # (extras.*autotune_decision — the pallas_ab/bp_ab benches) get
        # a provenance follow-up line: which kernel was chosen, and
        # whether it came from a live race or a shipped bank.
        autotune = band.get("autotune")
        if autotune:
            parts = []
            for name in sorted(autotune):
                verdict = autotune[name]
                source = verdict.get("source") or "race"
                verdict_str = (
                    "beat default"
                    if verdict.get("beat_default")
                    else "default held"
                )
                parts.append(
                    f"{name}: {verdict.get('choice')} "
                    f"({source}; {verdict_str})"
                )
            lines.append(f"{'':<6}autotune  " + " | ".join(parts))
    return "\n".join(lines)
