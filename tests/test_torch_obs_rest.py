"""The port's ``obs`` read side and records ≡ the JAX package's, on the CPU.

Cross-package: the same observations, outcome sequences, snapshots and
ledger records go through both packages' ``obs.export``, ``obs.health``,
``obs.slo``, ``obs.fleet`` and ``obs.ledger``, and what comes out must be
equal — the Prometheus text and the live line byte for byte, the HTTP
exporter's ``/metrics`` and ``/snapshot`` (without its wall clock) over
real sockets on port 0, every intermediate health verdict and the
registry dump it feeds, the SLO snapshots, the fleet view's JSON and
Prometheus bytes (and each package decoding the other's wire bytes), and
the ledger files written under a pinned clock and host snapshot (and
each package reading, summarising, rendering and diffing the other's
file). No tolerance: these modules are stdlib arithmetic on the same
inputs.

Port-only: the JAX package's test classes for the same modules that need
no JAX — bucket layouts, quantiles, deterministic export, disabled mode,
timelines, the ledger and its diff, SLO and autotune columns, the
Prometheus render, the exporter, burn-rate health and the fleet merge —
run against the port's copies.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request  # noqa: F811

import pytest

from bayesian_consensus_engine_tpu.obs import export as jexport
from bayesian_consensus_engine_tpu.obs import fleet as jfleet
from bayesian_consensus_engine_tpu.obs import health as jhealth
from bayesian_consensus_engine_tpu.obs import ledger as jledger
from bayesian_consensus_engine_tpu.obs import metrics as jmetrics
from bayesian_consensus_engine_tpu.obs import slo as jslo
from bayesian_consensus_engine_tpu_torch import obs
from bayesian_consensus_engine_tpu_torch.obs import export as obs_export
from bayesian_consensus_engine_tpu_torch.obs import fleet as obs_fleet
from bayesian_consensus_engine_tpu_torch.obs import health as obs_health
from bayesian_consensus_engine_tpu_torch.obs import ledger as obs_ledger
from bayesian_consensus_engine_tpu_torch.obs import metrics as obs_metrics
from bayesian_consensus_engine_tpu_torch.obs import slo as obs_slo
from bayesian_consensus_engine_tpu_torch.obs import timeline as obs_timeline

PACKAGES = {
    "jax": dict(export=jexport, fleet=jfleet, health=jhealth,
                ledger=jledger, metrics=jmetrics, slo=jslo),
    "torch": dict(export=obs_export, fleet=obs_fleet, health=obs_health,
                  ledger=obs_ledger, metrics=obs_metrics, slo=obs_slo),
}
OUTCOME_TRACE = (
    ["met"] * 20 + ["violated"] * 16 + ["shed", "rejected", "failed"] * 3
    + ["met"] * 40
)


def _populate(metrics, registry):
    """The same observations, in one fixed order, on either package."""
    registry.counter("serve.requests").inc(7)
    registry.counter("stream.batches").inc(3)
    registry.gauge("stream.intern_wait_s").set(0.125)
    registry.gauge("hbm.bytes_in_use").set(123456789)
    for value in (1e-6, 3e-4, 0.003, 0.05, 2.5, 250.0):
        registry.histogram("serve.latency_total_s").observe(value)
    custom = registry.histogram("lat", bounds=(0.01, 0.1, 1.0))
    for value in (0.005, 0.05, 0.5, 5.0):
        custom.observe(value)
    return registry


def _registries():
    return {name: _populate(mods["metrics"], mods["metrics"].MetricsRegistry())
            for name, mods in PACKAGES.items()}


def test_prometheus_text_and_live_line_equal_jax():
    registries = _registries()
    texts = {name: PACKAGES[name]["export"].render_prometheus(r.export())
             for name, r in registries.items()}
    assert texts["torch"].encode() == texts["jax"].encode()
    assert registries["torch"].to_json() == registries["jax"].to_json()
    lines = {}
    for name, registry in registries.items():
        health = PACKAGES[name]["health"].HealthMonitor(objective_goodput=0.9)
        for outcome in OUTCOME_TRACE[:30]:
            health.record(outcome)
        snapshot = {"host_id": 3, "epoch": 2, "metrics": registry.export(),
                    "qos": None}
        lines[name] = PACKAGES[name]["export"].render_live_snapshot(
            snapshot, healthz={"verdict": health.verdict()["verdict"]})
    assert lines["torch"] == lines["jax"]


def _fetch(url):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as response:
            return response.status, response.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_http_exporter_serves_jax_bytes():
    """Both exporters on port 0, fed the same state and scraped in the
    same order: equal status codes and bodies (``/snapshot`` without its
    wall clock)."""
    served = {}
    for name, registry in _registries().items():
        mods = PACKAGES[name]
        health = mods["health"].HealthMonitor(objective_goodput=0.9,
                                              metric_prefix="health")
        for outcome in OUTCOME_TRACE[:36]:
            health.record(outcome)
        with mods["export"].TelemetryServer(
                registry=registry, health=health, port=0, host_id=1,
                epoch=4) as server:
            assert server.port > 0
            got = [_fetch(server.url + path)
                   for path in ("/healthz", "/metrics", "/snapshot", "/nope")]
        snapshot = json.loads(got[2][1])
        assert snapshot.pop("wall_ts") > 0
        # The scrape-latency histogram holds wall-clock seconds: compare
        # its count only.
        scrapes = snapshot["metrics"]["histograms"].pop(
            "export.scrape_latency_s")["count"]
        text = "\n".join(line for line in got[1][1].decode().splitlines()
                         if "scrape_latency_s" not in line)
        dump = json.loads(registry.to_json())
        dump["histograms"].pop("export.scrape_latency_s")
        served[name] = (got[0], (got[1][0], text), snapshot, got[3][0],
                        dump, scrapes)
    assert served["torch"] == served["jax"]
    assert served["torch"][0][0] == 503  # the violation burst is burning


def test_health_verdicts_and_gauges_equal_jax():
    verdicts, dumps = {}, {}
    for name, mods in PACKAGES.items():
        registry = mods["metrics"].MetricsRegistry()
        previous = mods["metrics"].set_metrics_registry(registry)
        try:
            monitor = mods["health"].HealthMonitor(
                objective_goodput=0.95,
                windows=(mods["health"].BurnWindow(4, 16, 2.0),
                         mods["health"].BurnWindow(8, 32, 1.5)),
            )
            seen = []
            for step, outcome in enumerate(OUTCOME_TRACE):
                monitor.record(outcome)
                if step == 50:
                    monitor.set_degraded("hosts absent")
                if step == 60:
                    monitor.clear_degraded()
                seen.append(monitor.verdict())
        finally:
            mods["metrics"].set_metrics_registry(previous)
        verdicts[name], dumps[name] = seen, registry.to_json()
    assert verdicts["torch"] == verdicts["jax"]
    assert dumps["torch"] == dumps["jax"]
    assert {v["verdict"] for v in verdicts["torch"]} == {
        "healthy", "burning", "degraded"}


def test_slo_snapshots_equal_jax():
    snapshots = {}
    for name, mods in PACKAGES.items():
        tracker = mods["slo"].SloTracker(
            mods["slo"].LatencyObjective(0.05), window=16)
        seen = []
        for step, outcome in enumerate(OUTCOME_TRACE):
            if outcome == "met":
                tracker.record_latency(0.01 * (step % 9))
            else:
                tracker.record(outcome)
            seen.append(tracker.snapshot())
        counts = dict(tracker.snapshot()["counts"])
        snapshots[name] = (seen, mods["slo"].goodput_from_counts(counts))
    assert snapshots["torch"] == snapshots["jax"]


def _fleet_snapshots(mods):
    snaps = []
    for host, epoch, scale in ((2, 1, 1), (0, 1, 3), (5, 2, 2), (5, 1, 9)):
        registry = mods["metrics"].MetricsRegistry()
        registry.counter("serve.requests").inc(5 * scale)
        registry.gauge("stream.intern_wait_s").set(0.5 * scale)
        lat = registry.histogram("lat", bounds=(0.01, 0.1, 1.0))
        for value in (0.05 * scale, 0.002):
            lat.observe(value)
        qos = {"gold": {"slo_s": 0.05, "counts": {
            "met": 10 * scale, "violated": scale, "shed": 0,
            "rejected": 1, "failed": 0}}}
        snaps.append(mods["fleet"].snapshot_host(host, epoch, registry,
                                                 qos=qos))
    return snaps


def test_fleet_fold_equal_jax_and_wire_crosses():
    views, wires = {}, {}
    for name, mods in PACKAGES.items():
        snaps = _fleet_snapshots(mods)
        view = mods["fleet"].merge_fleet(snaps, expected_hosts=[0, 2, 5, 7])
        views[name] = (mods["fleet"].fleet_to_json(view),
                       mods["fleet"].render_fleet_prometheus(view))
        wires[name] = [mods["fleet"].snapshot_to_json(s) for s in snaps]
    assert views["torch"] == views["jax"]
    assert wires["torch"] == wires["jax"]
    # Each package folds the other's wire bytes to the same view.
    crossed = obs_fleet.merge_fleet(
        [obs_fleet.snapshot_from_json(raw) for raw in wires["jax"]],
        expected_hosts=[0, 2, 5, 7])
    assert obs_fleet.fleet_to_json(crossed) == views["jax"][0]
    back = jfleet.merge_fleet(
        [jfleet.snapshot_from_json(raw) for raw in wires["torch"]],
        expected_hosts=[0, 2, 5, 7])
    assert jfleet.fleet_to_json(back) == views["torch"][0]
    assert '"hosts_absent":[7]' in views["torch"][0].replace(" ", "")


def _write_ledger(mods, path):
    """Records of every summarised kind, as the bench legs write them."""
    with mods["ledger"].RunLedger(path, run_id="run-1", backend="gpu") as led:
        for repeat, (value, peak) in enumerate(((2.5, 300), (1.5, 120))):
            led.record(
                "e2e_stream", value=value, unit="s", repeat=repeat,
                phases={"pack": 0.25, "settle_dispatch": 0.125},
                extras={"hbm_peak_bytes": peak, "hbm_read_bytes": 64 * peak,
                        "ingest_wait_s": 0.5 / (repeat + 1),
                        "intern_s": 0.25, "recovery_s": 3.0 + repeat,
                        "replay_batches_per_s": 40.0 + repeat,
                        "bp_iters": 6 + repeat,
                        "latency_hist": {"bounds": [1.0, 10.0, 100.0],
                                         "counts": [5, 5, 0, 0]},
                        "slo": {"objective_s": 0.05, "counts": {
                            "met": 90, "violated": 5 + repeat, "shed": 3,
                            "rejected": 2, "failed": 0}},
                        "settle_autotune_decision": {
                            "choice": "pallas", "default": "xla",
                            "beat_default": True, "timings_s": {},
                            "source": "race"}},
            )
        led.record("plain_leg", value=4.0, unit="s")


def test_ledger_files_equal_jax_and_read_across(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(os, "getloadavg", lambda: (0.5, 0.25, 0.125))
    paths = {}
    for name, mods in PACKAGES.items():
        paths[name] = tmp_path / f"{name}.jsonl"
        _write_ledger(mods, paths[name])
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    ours = obs_ledger.read_ledger(paths["jax"])
    theirs = jledger.read_ledger(paths["torch"])
    assert ours == theirs
    assert obs_ledger.summarize(ours) == jledger.summarize(theirs)
    assert obs_ledger.render(ours) == jledger.render(theirs)
    faster = [dict(r, value=r["value"] / 4) if r["value"] else r
              for r in ours]
    assert obs_ledger.diff_bands(ours, faster) == jledger.diff_bands(
        theirs, faster)
    assert obs_ledger.render_diff(obs_ledger.diff_bands(ours, faster)) == (
        jledger.render_diff(jledger.diff_bands(theirs, faster)))
    assert obs_ledger.min_of_repeats(ours, "e2e_stream")["min"] == 1.5


def test_obs_package_exports_equal_jax():
    """The port's ``obs`` package exposes the JAX package's names, and the
    read-side modules stay out of it as there."""
    from bayesian_consensus_engine_tpu import obs as jobs

    assert obs.__all__ == jobs.__all__
    assert obs_metrics.DEFAULT_BOUNDS == jmetrics.DEFAULT_BOUNDS
    assert obs_health.BURN_RATE_BOUNDS == jhealth.BURN_RATE_BOUNDS
    assert obs_export.SCRAPE_LATENCY_BOUNDS == jexport.SCRAPE_LATENCY_BOUNDS
    assert [(w.fast, w.slow, w.threshold)
            for w in obs_health.DEFAULT_WINDOWS] == [
        (w.fast, w.slow, w.threshold) for w in jhealth.DEFAULT_WINDOWS]
    assert obs_slo.OUTCOMES == jslo.OUTCOMES
    assert obs.PHASES == ("pack", "upload", "state_adopt", "settle_dispatch",
                          "analytics", "fetch", "journal_fsync",
                          "journal_async_wait", "checkpoint",
                          "interchange_export", "replay")


# -- port cases of the JAX package's obs test classes ------------------------


class TestHistogramLayout:
    def test_default_bounds_pinned(self):
        # 1 µs → 100 s, 2 per decade: 17 edges, frozen. Re-deriving from
        # the closed form guards the formula; the literal endpoints guard
        # the parameters.
        bounds = obs_metrics.DEFAULT_BOUNDS
        assert len(bounds) == 17
        assert bounds[0] == 1e-6
        assert bounds[-1] == pytest.approx(100.0)
        expected = tuple(1e-6 * 10.0 ** (i / 2) for i in range(17))
        assert bounds == expected

    def test_bounds_require_whole_decade_steps(self):
        with pytest.raises(ValueError):
            obs_metrics.log_spaced_bounds(1e-3, 5e-2, 2)
        with pytest.raises(ValueError):
            obs_metrics.log_spaced_bounds(-1.0, 1.0, 2)

    def test_observe_bins_and_overflow(self):
        h = obs_metrics.Histogram(bounds=(1.0, 10.0, 100.0))
        for value in (0.5, 1.0, 5.0, 99.0, 1000.0):
            h.observe(value)
        snap = h.snapshot()
        # value <= edge lands in that bucket; past the last edge is the
        # implicit overflow bucket.
        assert snap["counts"] == [2, 1, 1, 1]
        assert snap["count"] == 5
        assert snap["sum"] == pytest.approx(0.5 + 1.0 + 5.0 + 99.0 + 1000.0)

    def test_conflicting_bounds_rejected(self):
        registry = obs_metrics.MetricsRegistry()
        registry.histogram("h", bounds=(1.0, 2.0))
        with pytest.raises(ValueError, match="different"):
            registry.histogram("h", bounds=(1.0, 3.0))


class TestWireBucketLayouts:
    """The telemetry plane's layouts, frozen like the default one:
    bucket edges are schema — a changed edge silently re-bins every
    historical scrape/burn capture."""

    def test_scrape_latency_bounds_pinned(self):
        from bayesian_consensus_engine_tpu_torch.obs.export import (
            SCRAPE_LATENCY_BOUNDS,
        )

        # 10 µs → 10 s, 2 per decade: 13 edges. A scrape is a registry
        # snapshot + a text render — the span from a no-op handler tick
        # to a pathological fleet-size export.
        assert len(SCRAPE_LATENCY_BOUNDS) == 13
        assert SCRAPE_LATENCY_BOUNDS[0] == 1e-5
        assert SCRAPE_LATENCY_BOUNDS[-1] == pytest.approx(10.0)
        expected = tuple(1e-5 * 10.0 ** (i / 2) for i in range(13))
        assert SCRAPE_LATENCY_BOUNDS == expected

    def test_burn_rate_bounds_pinned(self):
        from bayesian_consensus_engine_tpu_torch.obs.health import (
            BURN_RATE_BOUNDS,
        )

        # 0.01× → 1000× of budget pace, 2 per decade: 11 edges — burn 1
        # (spending exactly on budget) sits on an exact edge.
        assert len(BURN_RATE_BOUNDS) == 11
        assert BURN_RATE_BOUNDS[0] == 0.01
        assert BURN_RATE_BOUNDS[-1] == pytest.approx(1000.0)
        expected = tuple(0.01 * 10.0 ** (i / 2) for i in range(11))
        assert BURN_RATE_BOUNDS == expected


class TestHistogramQuantile:
    """The quantile surface: bucket-interpolated, EXACT when the
    rank lands on a log-bucket boundary, reproducible from counts alone
    (the stats renderer's p50/p99 come from exported snapshots)."""

    def _hist(self, values, bounds=(1.0, 10.0, 100.0)):
        h = obs_metrics.Histogram(bounds=bounds)
        for value in values:
            h.observe(value)
        return h

    def test_empty_histogram_has_no_quantile(self):
        assert self._hist([]).quantile(0.5) is None
        assert obs_metrics.NULL_REGISTRY.histogram("x").quantile(0.5) is None

    def test_exact_on_log_bucket_boundary(self):
        # 5 observations in (0,1], 5 in (1,10]: the 0.5 rank lands
        # EXACTLY on the first bucket's cumulative count → its upper
        # edge, exactly — no interpolation drift.
        h = self._hist([0.5] * 5 + [5.0] * 5)
        assert h.quantile(0.5) == 1.0
        # ...and with 5+5+10, rank 0.25 ends bucket 0, rank 0.5 ends
        # bucket 1 — each is that bucket's exact upper edge.
        h = self._hist([0.5] * 5 + [5.0] * 5 + [50.0] * 10)
        assert h.quantile(0.25) == 1.0
        assert h.quantile(0.5) == 10.0
        assert h.quantile(1.0) == 100.0

    def test_interpolates_within_a_bucket(self):
        # All 4 observations in (1, 10]: rank q falls q of the way
        # through the bucket — linear between the edges.
        h = self._hist([5.0] * 4)
        assert h.quantile(0.5) == pytest.approx(1.0 + (10.0 - 1.0) * 0.5)
        assert h.quantile(0.0) == pytest.approx(1.0)

    def test_overflow_clamps_to_last_finite_edge(self):
        h = self._hist([1000.0] * 3)
        assert h.quantile(0.99) == 100.0  # a lower bound, never invented

    def test_rejects_out_of_range_q(self):
        with pytest.raises(ValueError, match="quantile"):
            self._hist([1.0]).quantile(1.5)

    def test_snapshot_and_merged_snapshot_agree(self):
        h = self._hist([0.5, 5.0, 5.0, 50.0])
        snap = h.snapshot()
        assert obs_metrics.quantile_from_snapshot(snap, 0.99) == (
            h.quantile(0.99)
        )
        # Merging two identical snapshots (the ledger's cross-repeat
        # path) preserves every quantile: same distribution, more mass.
        merged = {
            "bounds": snap["bounds"],
            "counts": [c * 2 for c in snap["counts"]],
        }
        for q in (0.25, 0.5, 0.75, 0.99):
            assert obs_metrics.quantile_from_snapshot(merged, q) == (
                h.quantile(q)
            )

    def test_summary_names_percentiles(self):
        h = self._hist([0.5] * 5 + [5.0] * 5)
        summary = h.summary((0.5, 0.99, 0.999))
        assert summary["count"] == 10
        assert summary["p50"] == 1.0
        assert set(summary) == {"count", "sum", "p50", "p99", "p99.9"}

    def test_ledger_merges_latency_hists_into_p50_p99(self, tmp_path):
        path = tmp_path / "latency.jsonl"
        bounds = [1.0, 10.0, 100.0]
        with obs.RunLedger(path, run_id="r1") as ledger:
            for counts in ([5, 5, 0, 0], [5, 5, 0, 0]):
                ledger.record(
                    "serve.latency", value=1.0, unit="s",
                    extras={"latency_hist": {
                        "bounds": bounds, "counts": counts,
                    }},
                )
            ledger.record("plain_leg", value=2.0, unit="s")
        records = obs.read_ledger(path)
        summary = obs.summarize(records)
        # Merged counts [10, 10, 0, 0]: the q=0.5 rank (10 of 20) lands
        # exactly on bucket 0's cumulative end → its upper edge, 1.0.
        assert summary["serve.latency"]["p50"] == 1.0
        assert summary["serve.latency"]["p99"] is not None
        assert "p50" not in summary["plain_leg"]
        rendered = obs_ledger.render(records)
        header = rendered.splitlines()[0]
        assert "p50" in header and "p99" in header

    def test_ledger_peak_mem_min_across_repeats(self, tmp_path):
        # extras.hbm_peak_bytes folds to the MIN across repeats (the
        # repeat least polluted by co-resident allocations) and renders
        # as the stats table's peak_mem column; zero/absent samples (CPU
        # backends) contribute nothing.
        path = tmp_path / "mem.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            for peak in (300_000_000, 120_000_000, 0):
                ledger.record(
                    "ring.chunked", value=1.0, unit="s",
                    extras={"hbm_peak_bytes": peak},
                )
            ledger.record("plain_leg", value=2.0, unit="s")
        records = obs.read_ledger(path)
        summary = obs.summarize(records)
        assert summary["ring.chunked"]["hbm_peak_bytes"] == 120_000_000
        assert "hbm_peak_bytes" not in summary["plain_leg"]
        rendered = obs_ledger.render(records)
        assert "peak_mem" in rendered.splitlines()[0]
        assert "120MB" in rendered

    def test_ledger_hbm_read_min_across_repeats(self, tmp_path):
        # extras.hbm_read_bytes (the one-pass legs: arg + temp
        # bytes of the AOT settle program that ran — per-settle
        # bytes-read floor) folds to the MIN across repeats and renders
        # as the stats table's hbm_read column; zero/absent samples
        # contribute nothing.
        path = tmp_path / "read.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            for read in (96_000_000, 48_000_000, 0):
                ledger.record(
                    "e2e_onepass.onepass", value=1.0, unit="s",
                    extras={"hbm_read_bytes": read},
                )
            ledger.record("plain_leg", value=2.0, unit="s")
        records = obs.read_ledger(path)
        summary = obs.summarize(records)
        assert summary["e2e_onepass.onepass"]["hbm_read_bytes"] == 48_000_000
        assert "hbm_read_bytes" not in summary["plain_leg"]
        rendered = obs_ledger.render(records)
        assert "hbm_read" in rendered.splitlines()[0]
        assert "48MB" in rendered

    def test_ledger_intern_min_across_repeats(self, tmp_path):
        # extras.intern_s (the ingest/stream/serve legs:
        # seconds inside the pair-interning pass) folds to the MIN
        # across repeats and renders as the stats table's intern column.
        path = tmp_path / "intern.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            for intern_s in (0.31, 0.024):
                ledger.record(
                    "e2e_ingest_drift.drift1", value=1.0, unit="s",
                    extras={"intern_s": intern_s},
                )
            ledger.record("plain_leg", value=2.0, unit="s")
        records = obs.read_ledger(path)
        summary = obs.summarize(records)
        assert summary["e2e_ingest_drift.drift1"]["intern_s"] == 0.024
        assert "intern_s" not in summary["plain_leg"]
        rendered = obs_ledger.render(records)
        assert "intern" in rendered.splitlines()[0]

    def test_diff_bands_carries_intern_metric(self, tmp_path):
        def ledger_records(path, intern_s):
            with obs.RunLedger(path, run_id="r") as ledger:
                ledger.record(
                    "e2e_ingest_drift.drift1", value=1.0, unit="s",
                    extras={"intern_s": intern_s},
                )
            return obs.read_ledger(path)

        old = ledger_records(tmp_path / "old.jsonl", 0.3)
        new = ledger_records(tmp_path / "new.jsonl", 0.024)
        diff = obs.diff_bands(old, new)
        metric = diff["e2e_ingest_drift.drift1"]["metrics"]["intern_s"]
        assert metric == {"old": 0.3, "new": 0.024}
        rendered = obs.render_diff(diff)
        assert "intern 0.3->0.024" in rendered

    def test_diff_bands_carries_hbm_read_metric(self, tmp_path):
        def ledger_records(path, read):
            with obs.RunLedger(path, run_id="r") as ledger:
                ledger.record(
                    "e2e_onepass", value=1.0, unit="s",
                    extras={"hbm_read_bytes": read},
                )
            return obs.read_ledger(path)

        old = ledger_records(tmp_path / "old.jsonl", 200_000_000)
        new = ledger_records(tmp_path / "new.jsonl", 80_000_000)
        diff = obs.diff_bands(old, new)
        metric = diff["e2e_onepass"]["metrics"]["hbm_read_bytes"]
        assert metric == {"old": 200_000_000, "new": 80_000_000}
        rendered = obs.render_diff(diff)
        assert "hbm_read 2e+08->8e+07" in rendered

    def test_ledger_recovery_min_across_repeats(self, tmp_path):
        # extras.recovery_s (the kill-soak leg: kill → first
        # re-settled dead-band batch) folds to the MIN across repeats and
        # renders as the stats table's recovery column; legs without it
        # contribute nothing.
        path = tmp_path / "recovery.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            for value in (1.8, 0.42):
                ledger.record(
                    "e2e_kill_soak", value=value, unit="s",
                    extras={"recovery_s": value},
                )
            ledger.record("plain_leg", value=2.0, unit="s")
        records = obs.read_ledger(path)
        summary = obs.summarize(records)
        assert summary["e2e_kill_soak"]["recovery_s"] == 0.42
        assert "recovery_s" not in summary["plain_leg"]
        rendered = obs_ledger.render(records)
        assert "recovery" in rendered.splitlines()[0]

    def test_diff_bands_carries_recovery_metric(self, tmp_path):
        def ledger_records(path, value):
            with obs.RunLedger(path, run_id="r") as ledger:
                ledger.record(
                    "e2e_kill_soak", value=value, unit="s",
                    extras={"recovery_s": value},
                )
            return obs.read_ledger(path)

        old = ledger_records(tmp_path / "old.jsonl", 1.5)
        new = ledger_records(tmp_path / "new.jsonl", 0.5)
        diff = obs.diff_bands(old, new)
        assert diff["e2e_kill_soak"]["metrics"]["recovery_s"] == {
            "old": 1.5, "new": 0.5
        }
        rendered = obs.render_diff(diff)
        assert "recovery 1.5->0.5" in rendered

    def test_diff_bands_carries_peak_mem_metric(self, tmp_path):
        def ledger_records(path, peak):
            with obs.RunLedger(path, run_id="r") as ledger:
                ledger.record(
                    "ring", value=1.0, unit="s",
                    extras={"hbm_peak_bytes": peak},
                )
            return obs.read_ledger(path)

        old = ledger_records(tmp_path / "old.jsonl", 300_000_000)
        new = ledger_records(tmp_path / "new.jsonl", 90_000_000)
        diff = obs.diff_bands(old, new)
        metric = diff["ring"]["metrics"]["hbm_peak_bytes"]
        assert metric == {"old": 300_000_000, "new": 90_000_000}
        rendered = obs.render_diff(diff)
        assert "peak_mem 3e+08->9e+07" in rendered

    def test_mismatched_hist_layouts_refuse_to_merge(self, tmp_path):
        path = tmp_path / "bad.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            ledger.record("leg", value=1.0, extras={"latency_hist": {
                "bounds": [1.0, 10.0], "counts": [1, 1, 0],
            }})
            ledger.record("leg", value=1.0, extras={"latency_hist": {
                "bounds": [1.0, 100.0], "counts": [1, 1, 0],
            }})
        with pytest.raises(ValueError, match="layouts differ"):
            obs.summarize(obs.read_ledger(path))


class TestDeterministicExport:
    def test_byte_stable_across_registration_order(self):
        def populate(registry, names):
            for name in names:
                registry.counter(f"c.{name}").inc(3)
                registry.gauge(f"g.{name}").set(1.5)
                registry.histogram(f"h.{name}").observe(0.01)

        a = obs_metrics.MetricsRegistry()
        b = obs_metrics.MetricsRegistry()
        populate(a, ["alpha", "beta", "gamma"])
        populate(b, ["gamma", "alpha", "beta"])
        assert a.to_json().encode() == b.to_json().encode()

    def test_export_names_sorted(self):
        registry = obs_metrics.MetricsRegistry()
        registry.counter("z").inc()
        registry.counter("a").inc()
        assert list(registry.export()["counters"]) == ["a", "z"]


class TestDisabledModeIdentity:
    def test_null_registry_returns_one_shared_object(self):
        null = obs_metrics.NULL_REGISTRY
        assert null.counter("a") is null.counter("b")
        assert null.counter("a") is null.gauge("x") is null.histogram("y")
        # The no-ops really are no-ops.
        null.counter("a").inc(5)
        null.histogram("h").observe(1.0)
        assert null.export() == {
            "counters": {}, "gauges": {}, "histograms": {},
        }

    def test_default_registry_is_the_null_one(self):
        assert obs.metrics_registry() is obs_metrics.NULL_REGISTRY
        assert not obs.metrics_registry().enabled

    def test_set_registry_roundtrip(self):
        live = obs_metrics.MetricsRegistry()
        previous = obs.set_metrics_registry(live)
        try:
            assert obs.metrics_registry() is live
        finally:
            obs.set_metrics_registry(previous)
        assert obs.metrics_registry() is previous

    def test_null_timeline_span_is_one_shared_noop(self):
        null = obs_timeline.NULL_TIMELINE
        assert null.span("a") is null.span("b")
        with null.span("a"):
            pass
        assert null.totals() == {}
        assert not null.enabled

    def test_default_active_timeline_is_null(self):
        assert obs.active_timeline() is obs_timeline.NULL_TIMELINE


class TestTimeline:
    def test_recording_is_thread_local(self):
        timeline = obs.PhaseTimeline()
        seen = {}

        def worker():
            seen["timeline"] = obs.active_timeline()

        with obs.recording(timeline):
            assert obs.active_timeline() is timeline
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join()
        # The worker thread saw the null timeline: overlapped worker time
        # must not enter the additive breakdown.
        assert seen["timeline"] is obs_timeline.NULL_TIMELINE
        assert obs.active_timeline() is obs_timeline.NULL_TIMELINE

    def test_nested_spans_attribute_exclusively(self, monkeypatch):
        # A scripted clock: outer enter 0, inner 0.25-0.75, outer exit 1
        # (exact in binary), so the attribution is checked to the bit and
        # the host's load cannot stretch a sleep past a bound.
        ticks = iter([0.0, 0.25, 0.75, 1.0])
        monkeypatch.setattr(obs_timeline, "perf_counter", lambda: next(ticks))
        timeline = obs.PhaseTimeline()
        with obs.recording(timeline):
            with obs.active_timeline().span("checkpoint"):
                with obs.active_timeline().span("journal_fsync"):
                    pass
        totals = timeline.totals()
        # The outer phase excludes the nested one, and the pair sums to
        # the outer wall instead of double-counting it.
        assert totals == {"checkpoint": 0.5, "journal_fsync": 0.5}
        assert timeline.counts() == {"checkpoint": 1, "journal_fsync": 1}

    def test_delta_reports_only_advanced_phases(self):
        before = {"pack": 1.0, "upload": 2.0}
        after = {"pack": 1.5, "upload": 2.0, "fetch": 0.25}
        assert obs.PhaseTimeline.delta(before, after) == {
            "fetch": 0.25, "pack": 0.5,
        }

    def test_canonical_phase_vocabulary(self):
        assert obs.PHASES == (
            "pack", "upload", "state_adopt", "settle_dispatch",
            "analytics", "fetch", "journal_fsync", "journal_async_wait",
            "checkpoint", "interchange_export", "replay",
        )


class TestLedger:
    def test_schema_roundtrip(self, tmp_path):
        path = tmp_path / "run.jsonl"
        with obs.RunLedger(path, run_id="r1", backend="cpu") as ledger:
            ledger.record(
                "leg_a", value=1.25, unit="s", repeat=0,
                phases={"pack": 0.5}, extras={"k": "v"},
            )
            ledger.record("leg_a", value=1.5, unit="s", repeat=1)
        first, second = obs.read_ledger(path)
        assert first["schema"] == obs_ledger.SCHEMA_VERSION
        assert first["run_id"] == "r1"
        assert first["backend"] == "cpu"
        assert (first["seq"], second["seq"]) == (0, 1)
        assert first["leg"] == "leg_a"
        assert first["value"] == 1.25
        assert first["unit"] == "s"
        assert first["repeat"] == 0
        assert first["phases"] == {"pack": 0.5}
        assert first["extras"] == {"k": "v"}
        assert "loadavg_1m" in first["host"]
        assert first["host"]["cpu_count"] == os.cpu_count()
        assert first["wall_unix_ts"] <= second["wall_unix_ts"]

    def test_record_lines_are_sorted_key_json(self, tmp_path):
        path = tmp_path / "run.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            ledger.record("leg", extras={"zz": 1, "aa": 2})
        (line,) = path.read_text().strip().splitlines()
        assert line == json.dumps(json.loads(line), sort_keys=True)

    def test_append_only_across_writers(self, tmp_path):
        path = tmp_path / "run.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            ledger.record("a")
        with obs.RunLedger(path, run_id="r2") as ledger:
            ledger.record("b")
        records = obs.read_ledger(path)
        assert [r["run_id"] for r in records] == ["r1", "r2"]

    def test_torn_tail_dropped_interior_garbage_raises(self, tmp_path):
        path = tmp_path / "run.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            ledger.record("a")
            ledger.record("b")
        with open(path, "a") as f:
            f.write('{"torn": ')  # crash mid-append
        records = obs.read_ledger(path)
        assert [r["leg"] for r in records] == ["a", "b"]
        with open(path, "w") as f:
            f.write('{"torn": \n')
            f.write(json.dumps({"leg": "c"}) + "\n")
        with pytest.raises(ValueError, match="malformed"):
            obs.read_ledger(path)

    def test_truncated_final_record_dropped_exactly(self, tmp_path):
        # The explicit torn-tail case: a REAL
        # record cut mid-bytes — a SIGKILL between write and flush
        # boundary — must drop exactly that record, never a neighbour
        # (the appended-garbage case above exercises a different tail).
        path = tmp_path / "run.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            for i in range(3):
                ledger.record("leg", value=float(i), unit="s", repeat=i)
        lines = path.read_bytes().splitlines(keepends=True)
        assert len(lines) == 3
        path.write_bytes(
            b"".join(lines[:2]) + lines[2][: len(lines[2]) // 2]
        )
        records = obs.read_ledger(path)
        assert [r["repeat"] for r in records] == [0, 1]
        assert [r["value"] for r in records] == [0.0, 1.0]

    def test_min_of_repeats_band(self, tmp_path):
        path = tmp_path / "run.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            for i, value in enumerate((2.0, 1.0, 1.5)):
                ledger.record("leg", value=value, unit="s", repeat=i)
            ledger.record("leg", value=None)  # non-numeric: ignored
        band = obs.min_of_repeats(obs.read_ledger(path), "leg")
        assert band["n"] == 3
        assert band["min"] == 1.0
        assert band["max"] == 2.0
        assert band["spread_pct"] == 100.0
        assert band["unit"] == "s"
        assert obs.min_of_repeats([], "leg") is None

    def test_summarize_and_render(self, tmp_path):
        path = tmp_path / "run.jsonl"
        with obs.RunLedger(path, run_id="r1") as ledger:
            ledger.record("b_leg", value=3.0, unit="s")
            ledger.record("a_leg", value=1.0, unit="s")
        records = obs.read_ledger(path)
        summary = obs.summarize(records)
        assert list(summary) == ["a_leg", "b_leg"]
        rendered = obs_ledger.render(records)
        assert "a_leg" in rendered and "b_leg" in rendered


class TestLedgerDiff:
    """Cross-run band diffing (the ``--against`` comparison): the
    regression signal is bands that STOPPED overlapping, with direction
    reported and the verdict left to the unit's polarity."""

    @staticmethod
    def _records(leg, values, unit="s"):
        return [
            {"leg": leg, "value": v, "unit": unit, "host": {}}
            for v in values
        ]

    def test_overlapping_bands_are_a_wash(self):
        old = self._records("leg", [1.0, 2.0])
        new = self._records("leg", [1.5, 3.0])
        diff = obs.diff_bands(old, new)
        assert diff["leg"]["status"] == "overlap"

    def test_disjoint_bands_flag_direction(self):
        old = self._records("leg", [1.0, 2.0])
        up = obs.diff_bands(old, self._records("leg", [2.5, 3.0]))
        down = obs.diff_bands(old, self._records("leg", [0.25, 0.5]))
        assert up["leg"]["status"] == "shifted_up"
        assert down["leg"]["status"] == "shifted_down"
        # Bands ride along verbatim so a round note can quote the range.
        assert up["leg"]["old"]["max"] == 2.0
        assert up["leg"]["new"]["min"] == 2.5

    def test_touching_bands_still_overlap(self):
        # Shared endpoint = one value both rounds produced: not a shift.
        old = self._records("leg", [1.0, 2.0])
        new = self._records("leg", [2.0, 3.0])
        assert obs.diff_bands(old, new)["leg"]["status"] == "overlap"

    def test_one_sided_legs_reported_not_compared(self):
        old = self._records("gone", [1.0])
        new = self._records("fresh", [2.0])
        diff = obs.diff_bands(old, new)
        assert diff["gone"]["status"] == "old_only"
        assert diff["fresh"]["status"] == "new_only"

    def test_render_diff_counts_moved_legs(self):
        old = self._records("a", [1.0, 2.0]) + self._records("b", [5.0])
        new = self._records("a", [4.0, 6.0]) + self._records("b", [5.0])
        rendered = obs.render_diff(obs.diff_bands(old, new))
        assert "shifted_up" in rendered
        assert "1 leg(s) stopped overlapping" in rendered
        # An all-overlap diff says so instead of counting zero.
        calm = obs.render_diff(obs.diff_bands(old, old))
        assert "all shared legs overlap" in calm


class TestSloColumn:
    """The stats surface: the absolute offered-but-not-met count
    (``slo_violations``) rides beside the goodput fraction, sourced from
    the serve-leg records' ``extras.slo`` and diffed by ``--against``
    like ``hbm_read``."""

    @staticmethod
    def _slo_records(leg, counts_list):
        return [
            {
                "leg": leg, "value": 1.0, "unit": "s", "host": {},
                "extras": {"slo": {"objective_s": 0.05, "counts": counts}},
            }
            for counts in counts_list
        ]

    def test_violations_merge_across_repeats(self):
        records = self._slo_records(
            "e2e_serve",
            [
                {"met": 90, "violated": 5, "shed": 3, "rejected": 2,
                 "failed": 0},
                {"met": 95, "violated": 1, "shed": 0, "rejected": 0,
                 "failed": 4},
            ],
        )
        band = obs.min_of_repeats(records, "e2e_serve")
        assert band["slo_violations"] == 15  # every non-met outcome
        assert band["goodput_within_slo"] == pytest.approx(185 / 200)

    def test_render_has_slo_column(self):
        records = self._slo_records(
            "e2e_serve", [{"met": 9, "violated": 1}]
        )
        rendered = obs_ledger.render(records)
        header, row = rendered.splitlines()[:2]
        assert "slo" in header.split()
        assert " 1 " in row  # the violation count renders as an integer
        # Legs without SLO records dash the column.
        plain = obs_ledger.render(
            [{"leg": "plain", "value": 1.0, "unit": "s", "host": {}}]
        )
        assert "-" in plain.splitlines()[1]

    def test_diff_carries_slo_violations(self):
        old = self._slo_records("e2e_serve", [{"met": 99, "violated": 1}])
        new = self._slo_records("e2e_serve", [{"met": 80, "violated": 20}])
        diff = obs.diff_bands(old, new)
        metric = diff["e2e_serve"]["metrics"]["slo_violations"]
        assert (metric["old"], metric["new"]) == (1, 20)
        assert "slo 1->20" in obs.render_diff(diff)


class TestAutotuneProvenance:
    """The stats surface: kernel-bearing legs render their tuner
    verdict WITH provenance (a local ``race`` vs a loaded ``bank``),
    and ``--against`` flags a verdict FLIP — the regression that
    matters when a shipped bank drifts from what this host would
    measure."""

    @staticmethod
    def _records(leg, choice, source="race", beat=True):
        decision = {
            "choice": choice, "default": "xla", "beat_default": beat,
            "timings_s": {}, "source": source,
        }
        return [{
            "leg": leg, "value": 1.0, "unit": "s", "host": {},
            "extras": {"settle_autotune_decision": decision},
        }]

    def test_band_and_render_carry_provenance(self):
        records = self._records("pallas_ab", "pallas", source="bank")
        band = obs.min_of_repeats(records, "pallas_ab")
        verdict = band["autotune"]["settle_autotune_decision"]
        assert verdict["choice"] == "pallas"
        assert verdict["source"] == "bank"
        rendered = obs_ledger.render(records)
        assert "settle_autotune_decision: pallas (bank; beat default)" in (
            rendered
        )
        # Legs without a decision render no autotune trailer.
        plain = obs_ledger.render(
            [{"leg": "plain", "value": 1.0, "unit": "s", "host": {}}]
        )
        assert "autotune" not in plain

    def test_diff_flags_verdict_flip(self):
        old = self._records("pallas_ab", "pallas")
        new = self._records("pallas_ab", "xla", source="bank", beat=False)
        diff = obs.diff_bands(old, new)
        metric = diff["pallas_ab"]["metrics"][
            "autotune.settle_autotune_decision"
        ]
        assert (metric["old"], metric["new"]) == ("pallas", "xla")
        assert metric["verdict_flip"] is True
        assert metric["source"] == "bank"
        rendered = obs.render_diff(diff)
        assert "pallas->xla FLIP" in rendered
        # Same verdict both rounds: reported, not flagged.
        calm = obs.diff_bands(old, old)
        same = calm["pallas_ab"]["metrics"][
            "autotune.settle_autotune_decision"
        ]
        assert "verdict_flip" not in same


def _get(url, timeout=5.0):
    """GET → (status, parsed-JSON-or-text); 503 bodies are answers."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            raw = r.read()
            status = r.status
    except urllib.error.HTTPError as exc:
        raw = exc.read()
        status = exc.code
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


def _registry_ab(order):
    """One registry fed the same observations in the given site order."""
    registry = obs.MetricsRegistry()
    sites = {
        "c": lambda: registry.counter("serve.requests").inc(3),
        "g": lambda: registry.gauge("stream.intern_wait_s").set(0.25),
        "h": lambda: registry.histogram(
            "serve.latency_total_s"
        ).observe(0.003),
    }
    for key in order:
        sites[key]()
    return registry


class TestPrometheusRender:
    def test_bytes_independent_of_registration_order(self):
        a = obs_export.render_prometheus(_registry_ab("cgh").export())
        b = obs_export.render_prometheus(_registry_ab("hgc").export())
        assert a == b
        assert a.encode() == b.encode()

    def test_counter_gauge_histogram_shapes(self):
        text = obs_export.render_prometheus(_registry_ab("cgh").export())
        lines = text.splitlines()
        assert "# TYPE bce_serve_requests counter" in lines
        assert "bce_serve_requests 3" in lines
        assert "bce_stream_intern_wait_s 0.25" in lines
        # Histogram: cumulative buckets, +Inf, _sum, _count.
        buckets = [
            line for line in lines
            if line.startswith("bce_serve_latency_total_s_bucket")
        ]
        assert buckets[-1] == (
            'bce_serve_latency_total_s_bucket{le="+Inf"} 1'
        )
        counts = [int(line.rsplit(" ", 1)[1]) for line in buckets]
        assert counts == sorted(counts)  # cumulative never decreases
        assert "bce_serve_latency_total_s_count 1" in lines
        assert any(
            line.startswith("bce_serve_latency_total_s_sum ")
            for line in lines
        )

    def test_names_sorted(self):
        text = obs_export.render_prometheus(_registry_ab("cgh").export())
        type_lines = [
            line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE")
        ]
        # Sorted within each metric kind (counters, then gauges, then
        # histograms) — the render contract the fleet fold relies on.
        assert type_lines == [
            "bce_serve_requests",
            "bce_stream_intern_wait_s",
            "bce_serve_latency_total_s",
        ]

    def test_empty_export_renders_empty(self):
        assert obs_export.render_prometheus(
            obs.MetricsRegistry().export()
        ) == ""


class TestTelemetryServer:
    def test_endpoints_and_scrape_accounting(self):
        registry = _registry_ab("cgh")
        with obs_export.TelemetryServer(
            registry=registry, host_id=7, epoch=3
        ) as server:
            status, text = _get(server.url + "/metrics")
            assert status == 200
            assert "bce_serve_requests 3" in text
            status, snap = _get(server.url + "/snapshot")
            assert status == 200
            assert snap["host_id"] == 7 and snap["epoch"] == 3
            assert snap["metrics"]["counters"]["serve.requests"] == 3
            status, payload = _get(server.url + "/healthz")
            assert status == 200
            assert payload == {
                "ok": True, "verdict": "healthy", "detail": None,
            }
            status, _ = _get(server.url + "/nope")
            assert status == 404
            # Scrapes self-account on the pinned layout.
            export = registry.export()
            assert export["counters"]["export.scrapes"] >= 3
            hist = export["histograms"]["export.scrape_latency_s"]
            assert tuple(hist["bounds"]) == (
                obs_export.SCRAPE_LATENCY_BOUNDS
            )
            assert hist["count"] >= 3

    def test_healthz_tracks_the_monitor(self):
        monitor = obs_health.HealthMonitor(
            objective_goodput=0.9,
            windows=(obs_health.BurnWindow(4, 16, 2.0),),
        )
        with obs_export.TelemetryServer(
            registry=obs.MetricsRegistry(), health=monitor
        ) as server:
            status, payload = _get(server.url + "/healthz")
            assert (status, payload["verdict"]) == (200, "healthy")
            for _ in range(16):
                monitor.record("violated")
            status, payload = _get(server.url + "/healthz")
            assert (status, payload["verdict"]) == (503, "burning")
            assert payload["ok"] is False
            assert payload["detail"]["windows"][0]["burning"] is True
            monitor.set_degraded("host 1 absent")
            status, payload = _get(server.url + "/healthz")
            assert (status, payload["verdict"]) == (503, "degraded")
            monitor.clear_degraded()
            for _ in range(16):
                monitor.record("met")
            status, payload = _get(server.url + "/healthz")
            assert (status, payload["verdict"]) == (200, "healthy")

    def test_set_epoch_moves_the_snapshot_tag(self):
        with obs_export.TelemetryServer(
            registry=obs.MetricsRegistry(), host_id=1, epoch=0
        ) as server:
            _, snap = _get(server.url + "/snapshot")
            assert snap["epoch"] == 0
            server.set_epoch(4)  # recovery adopted a degraded view
            _, snap = _get(server.url + "/snapshot")
            assert snap["epoch"] == 4

    def test_snapshot_carries_trace_ring_depths(self):
        tracer = obs.Tracer()
        tracer.batch_event(0, "batch")
        tracer.request_event(0, "enqueue")
        with obs_export.TelemetryServer(
            registry=obs.MetricsRegistry(), tracer=tracer
        ) as server:
            _, snap = _get(server.url + "/snapshot")
        assert snap["trace"]["enabled"] is True
        assert snap["trace"]["ring_depths"] == {"driver": 1, "service": 1}


class TestHealthMonitor:
    def _monitor(self, fast=4, slow=16, threshold=2.0, target=0.9):
        return obs_health.HealthMonitor(
            objective_goodput=target,
            windows=(obs_health.BurnWindow(fast, slow, threshold),),
        )

    def test_verdict_is_pure_function_of_outcome_sequence(self):
        trace = (
            ["met"] * 20 + ["violated"] * 16 + ["met"] * 16
        )
        runs = []
        for _ in range(2):
            monitor = self._monitor()
            verdicts = []
            for outcome in trace:
                monitor.record(outcome)
                verdicts.append(monitor.verdict()["verdict"])
            runs.append(verdicts)
        assert runs[0] == runs[1]
        assert "burning" in runs[0]          # the violation burst fires
        assert runs[0][-1] == "healthy"      # ...and the met tail clears

    def test_burning_requires_fast_and_slow(self):
        monitor = self._monitor(fast=4, slow=16, threshold=2.0)
        for _ in range(12):
            monitor.record("met")
        # 4 violations: fast window (4) is all-error (burn 10) but the
        # slow window holds 4/16 = burn 2.5 >= 2 — both over, burning.
        for _ in range(4):
            monitor.record("violated")
        assert monitor.burning is True
        # One met resets the fast window below threshold: not burning,
        # even though the slow window still carries the errors.
        for _ in range(4):
            monitor.record("met")
        assert monitor.burning is False
        state = monitor.verdict()["windows"][0]
        assert state["fast_burn"] < state["threshold"]
        assert state["slow_burn"] > 0

    def test_every_non_met_outcome_burns_budget(self):
        for outcome in ("violated", "shed", "rejected", "failed"):
            monitor = self._monitor(fast=2, slow=4, threshold=1.0)
            for _ in range(4):
                monitor.record(outcome)
            assert monitor.burning is True, outcome

    def test_degraded_outranks_burning(self):
        monitor = self._monitor()
        for _ in range(16):
            monitor.record("violated")
        monitor.set_degraded("adopting band 1")
        verdict = monitor.verdict()
        assert verdict["verdict"] == "degraded"
        assert verdict["burning"] is True  # both facts visible
        monitor.clear_degraded()
        assert monitor.verdict()["verdict"] == "burning"

    def test_gauges_and_pinned_burn_histogram(self):
        registry = obs.MetricsRegistry()
        previous = obs.set_metrics_registry(registry)
        try:
            monitor = self._monitor(fast=4, slow=16)
            for _ in range(8):
                monitor.record("violated")
        finally:
            obs.set_metrics_registry(previous)
        export = registry.export()
        assert export["gauges"]["health.burning"] == 1.0
        assert export["gauges"]["health.burn_rate_fast"] == (
            pytest.approx(10.0)
        )
        hist = export["histograms"]["health.burn_rate"]
        assert tuple(hist["bounds"]) == obs_health.BURN_RATE_BOUNDS
        assert hist["count"] > 0

    def test_validation(self):
        with pytest.raises(ValueError, match="objective_goodput"):
            obs_health.HealthMonitor(objective_goodput=1.0)
        with pytest.raises(ValueError, match="slow window"):
            obs_health.BurnWindow(8, 8, 1.0)
        with pytest.raises(ValueError, match="outcome"):
            self._monitor().record("mystery")


def _snap(host, epoch, counters=None, gauges=None, hist=None):
    registry = obs.MetricsRegistry()
    for name, n in (counters or {}).items():
        registry.counter(name).inc(n)
    for name, value in (gauges or {}).items():
        registry.gauge(name).set(value)
    for name, values in (hist or {}).items():
        h = registry.histogram(name, bounds=(0.01, 0.1, 1.0))
        for value in values:
            h.observe(value)
    return obs_fleet.snapshot_host(host, epoch, registry)


class TestFleetMerge:
    def test_any_fold_order_same_bytes(self):
        snaps = [
            _snap(2, 1, {"serve.requests": 5}, {"stream.intern_wait_s": 1.0},
                  {"lat": [0.05]}),
            _snap(0, 1, {"serve.requests": 7}, {"stream.intern_wait_s": 2.0},
                  {"lat": [0.5, 0.02]}),
            _snap(5, 1, {"serve.requests": 1}, {}, {"lat": [0.05]}),
        ]
        views = [
            obs_fleet.merge_fleet(order, expected_hosts=[0, 2, 5])
            for order in (snaps, list(reversed(snaps)),
                          [snaps[1], snaps[2], snaps[0]])
        ]
        as_json = {obs_fleet.fleet_to_json(v) for v in views}
        assert len(as_json) == 1
        rendered = {obs_fleet.render_fleet_prometheus(v) for v in views}
        assert len(rendered) == 1

    def test_counters_sum_gauges_stay_per_host(self):
        view = obs_fleet.merge_fleet(
            [
                _snap(0, 0, {"serve.requests": 5}, {"depth": 2.0}),
                _snap(1, 0, {"serve.requests": 7}, {"depth": 3.0}),
            ]
        )
        assert view["counters"]["serve.requests"] == 12
        assert view["gauges"]["depth"] == {"0": 2.0, "1": 3.0}
        text = obs_fleet.render_fleet_prometheus(view)
        assert 'bce_depth{host="0"} 2.0' in text
        assert 'bce_depth{host="1"} 3.0' in text
        assert "bce_serve_requests 12" in text

    def test_histograms_merge_by_bucket_sum(self):
        view = obs_fleet.merge_fleet(
            [
                _snap(0, 0, hist={"lat": [0.05, 0.5]}),
                _snap(1, 0, hist={"lat": [0.05]}),
            ]
        )
        assert view["histograms"]["lat"]["count"] == 3
        assert view["histograms"]["lat"]["counts"] == [0, 2, 1, 0]

    def test_histogram_layout_mismatch_refuses(self):
        a = _snap(0, 0, hist={"lat": [0.05]})
        registry = obs.MetricsRegistry()
        registry.histogram("lat", bounds=(1.0, 2.0)).observe(1.5)
        b = obs_fleet.snapshot_host(1, 0, registry)
        with pytest.raises(ValueError, match="layouts differ"):
            obs_fleet.merge_fleet([a, b])

    def test_absent_hosts_are_explicit(self):
        view = obs_fleet.merge_fleet(
            [_snap(0, 1), _snap(2, 1)], expected_hosts=[0, 1, 2, 3]
        )
        assert view["hosts_absent"] == [1, 3]
        text = obs_fleet.render_fleet_prometheus(view)
        assert "bce_fleet_hosts_absent 2" in text

    def test_higher_epoch_supersedes_same_epoch_conflict_refuses(self):
        stale = _snap(0, 0, {"serve.requests": 1})
        fresh = _snap(0, 2, {"serve.requests": 9})
        view = obs_fleet.merge_fleet([stale, fresh])
        assert view["counters"]["serve.requests"] == 9
        assert view["epoch"] == 2
        conflicting = _snap(0, 2, {"serve.requests": 10})
        with pytest.raises(ValueError, match="conflicting"):
            obs_fleet.merge_fleet([fresh, conflicting])
        # ...but an identical duplicate (the same scrape seen twice) is
        # not a conflict.
        assert obs_fleet.merge_fleet(
            [fresh, obs_fleet.snapshot_from_json(
                obs_fleet.snapshot_to_json(fresh)
            )]
        )["counters"]["serve.requests"] == 9

    def test_conflict_refusal_is_order_independent(self):
        # A conflict at a SUPERSEDED epoch still refuses, wherever the
        # superseding snapshot sits in the sequence — otherwise two
        # observers of the same set could disagree (one refuses, one
        # folds), which is exactly the split the refusal exists to stop.
        a = _snap(0, 3, {"c": 1})
        b = _snap(0, 3, {"c": 2})   # conflicts with a at epoch 3
        c = _snap(0, 5, {"c": 9})   # supersedes both
        for order in ([a, b, c], [a, c, b], [c, a, b], [b, c, a]):
            with pytest.raises(ValueError, match="conflicting"):
                obs_fleet.merge_fleet(order)

    def test_wire_roundtrip(self):
        snap = _snap(3, 2, {"c": 1}, {"g": 0.5}, {"lat": [0.05]})
        back = obs_fleet.snapshot_from_json(obs_fleet.snapshot_to_json(snap))
        assert back == snap


def _qos_snap(host, epoch, qos):
    return obs_fleet.HostSnapshot(
        host_id=host, epoch=epoch,
        metrics={"counters": {}, "gauges": {}, "histograms": {}},
        qos=qos,
    )


def _qos_block(slo_s=0.05, counts=None, pending=0, burning=False):
    return {
        "slo_s": slo_s,
        "counts": dict(counts or {}),
        "pending": pending,
        "burning": burning,
    }


class TestQosFleetMerge:
    """Class-labeled QoS series fold under the same sorted-
    deterministic discipline — conflicting class vocabularies refuse
    like histogram layout mismatches."""

    def test_counts_sum_goodput_recomputed(self):
        view = obs_fleet.merge_fleet([
            _qos_snap(0, 1, {
                "premium": _qos_block(0.05, {"met": 8, "violated": 2}),
            }),
            _qos_snap(1, 1, {
                "premium": _qos_block(
                    0.05, {"met": 6, "shed": 4}, pending=3, burning=True,
                ),
            }),
        ])
        premium = view["qos"]["premium"]
        assert premium["counts"] == {"met": 14, "shed": 4, "violated": 2}
        assert premium["offered"] == 20
        assert premium["goodput_within_slo"] == 0.7
        # Pending stays a per-host series; burning names hosts, never
        # averages.
        assert premium["pending"] == {"0": 0, "1": 3}
        assert premium["hosts_burning"] == [1]

    def test_fold_order_independent_bytes(self):
        snaps = [
            _qos_snap(2, 1, {"a": _qos_block(0.1, {"met": 1}),
                             "b": _qos_block(1.0, {"shed": 2})}),
            _qos_snap(0, 1, {"a": _qos_block(0.1, {"met": 4}),
                             "b": _qos_block(1.0, {"met": 1})}),
        ]
        views = [
            obs_fleet.merge_fleet(order)
            for order in (snaps, list(reversed(snaps)))
        ]
        assert len({obs_fleet.fleet_to_json(v) for v in views}) == 1
        assert len({
            obs_fleet.render_fleet_prometheus(v) for v in views
        }) == 1

    def test_class_vocabulary_mismatch_refuses(self):
        with pytest.raises(ValueError, match="vocabularies differ"):
            obs_fleet.merge_fleet([
                _qos_snap(0, 1, {"premium": _qos_block()}),
                _qos_snap(1, 1, {"gold": _qos_block()}),
            ])

    def test_slo_disagreement_is_a_vocabulary_mismatch(self):
        with pytest.raises(ValueError, match="vocabularies differ"):
            obs_fleet.merge_fleet([
                _qos_snap(0, 1, {"premium": _qos_block(slo_s=0.05)}),
                _qos_snap(1, 1, {"premium": _qos_block(slo_s=5.0)}),
            ])

    def test_hosts_without_qos_contribute_nothing(self):
        view = obs_fleet.merge_fleet([
            _qos_snap(0, 1, {"premium": _qos_block(0.05, {"met": 3})}),
            _snap(1, 1, {"serve.requests": 5}),
        ])
        assert view["qos"]["premium"]["counts"] == {"met": 3}
        no_qos = obs_fleet.merge_fleet([_snap(0, 1), _snap(1, 1)])
        assert "qos" not in no_qos

    def test_same_epoch_qos_conflict_refuses(self):
        a = _qos_snap(0, 1, {"premium": _qos_block(0.05, {"met": 3})})
        b = _qos_snap(0, 1, {"premium": _qos_block(0.05, {"met": 4})})
        with pytest.raises(ValueError, match="conflicting"):
            obs_fleet.merge_fleet([a, b])

    def test_wire_roundtrip_preserves_qos(self):
        snap = _qos_snap(3, 2, {"premium": _qos_block(0.05, {"met": 1})})
        back = obs_fleet.snapshot_from_json(
            obs_fleet.snapshot_to_json(snap)
        )
        assert back == snap

    def test_rendered_class_series(self):
        view = obs_fleet.merge_fleet([
            _qos_snap(0, 1, {
                "premium": _qos_block(0.05, {"met": 3, "violated": 1}),
            }),
        ])
        text = obs_fleet.render_fleet_prometheus(view)
        assert 'bce_qos_offered{class="premium"} 4' in text
        assert 'bce_qos_goodput_within_slo{class="premium"} 0.75' in text
