"""The live telemetry plane: Prometheus text, snapshots, an HTTP exporter.

The port's copy of the JAX package's ``obs/export.py``: the same wire
format, bucket layout and snapshot schema, so a registry that saw the
same observations renders the same BYTES in either package.

* :func:`render_prometheus` — the text exposition of
  ``MetricsRegistry.export()``, names, labels and buckets sorted: two
  registries with the same state are identical BYTES regardless of
  registration order.
* :class:`TelemetryServer` — a stdlib ``http.server`` exporter on a
  background thread: ``/metrics`` (the text above), ``/snapshot`` (the
  deterministic JSON snapshot: registry export, epoch, flight-recorder
  depths, the health verdict) and ``/healthz`` — liveness plus the
  multi-window SLO burn-rate verdict (HTTP 200 for ``healthy``, 503 for
  ``burning`` or ``degraded``; the body always carries the full
  verdict).
* :func:`scrape_endpoint` and :func:`render_live_snapshot` — the client half: fetch an
  exporter's endpoints and render one live line.

The exporter is write-only with respect to settlement: it reads the
registry under its own lock and never touches a store, so a server
scraping mid-settle moves no settlement byte. Stdlib-only and read-side:
the engine's own modules record into ``obs.metrics`` and never import
this module.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from time import perf_counter
from typing import Dict, Mapping, Optional

from bayesian_consensus_engine_tpu_torch.obs.metrics import (
    log_spaced_bounds,
    metrics_registry,
)

#: Scrape-handling latency layout: 10 µs → 10 s, 2 per decade (13 edges).
#: Pinned — bucket edges are schema: a changed edge
#: silently re-bins every historical scrape capture.
SCRAPE_LATENCY_BOUNDS = log_spaced_bounds(1e-5, 10.0, 2)


# -- Prometheus text exposition ----------------------------------------------


def sanitize_metric_name(name: str, prefix: str = "bce") -> str:
    """Dotted obs name → Prometheus-legal name (``serve.shed`` →
    ``bce_serve_shed``). Deterministic character-for-character, so equal
    names always render equal bytes."""
    cleaned = "".join(
        c if (c.isascii() and (c.isalnum() or c == "_")) else "_"
        for c in name
    )
    return f"{prefix}_{cleaned}" if prefix else cleaned


def format_metric_value(value) -> str:
    """One deterministic number rendering for the exposition: ints as
    ints, floats via ``repr`` (shortest round-trip — two observers of
    the same float emit the same bytes)."""
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, int):
        return str(value)
    return repr(float(value))


def format_labels(labels: Optional[Mapping[str, object]]) -> str:
    """``{a="1",b="x"}`` with keys sorted; empty string for no labels."""
    if not labels:
        return ""
    parts = [f'{k}="{labels[k]}"' for k in sorted(labels)]
    return "{" + ",".join(parts) + "}"


def render_histogram_lines(
    name: str, snapshot: Mapping[str, object],
    labels: Optional[Mapping[str, object]] = None,
) -> list:
    """The ``_bucket``/``_sum``/``_count`` block for one histogram
    snapshot (cumulative counts, ``+Inf`` overflow), deterministic."""
    lines = [f"# TYPE {name} histogram"]
    bounds = list(snapshot["bounds"])
    counts = list(snapshot["counts"])
    base = dict(labels) if labels else {}
    cumulative = 0
    for edge, count in zip(bounds, counts):
        cumulative += int(count)
        lines.append(
            f"{name}_bucket"
            f"{format_labels({**base, 'le': format_metric_value(edge)})}"
            f" {cumulative}"
        )
    cumulative += int(counts[-1]) if len(counts) > len(bounds) else 0
    lines.append(
        f"{name}_bucket{format_labels({**base, 'le': '+Inf'})} {cumulative}"
    )
    lines.append(
        f"{name}_sum{format_labels(base)}"
        f" {format_metric_value(snapshot['sum'])}"
    )
    lines.append(f"{name}_count{format_labels(base)} {int(snapshot['count'])}")
    return lines


def render_prometheus(export: Mapping[str, Mapping], prefix: str = "bce") -> str:
    """Prometheus text exposition of a registry ``export()`` snapshot.

    Deterministic by construction: metric names sorted (``export()``
    already sorts them, re-sorted here so any export-shaped dict works),
    fixed value formatting, fixed bucket rendering — two registries that
    saw the same observations produce the same BYTES.
    """
    lines = []
    for raw_name in sorted(export.get("counters", {})):
        name = sanitize_metric_name(raw_name, prefix)
        lines.append(f"# TYPE {name} counter")
        lines.append(
            f"{name} {format_metric_value(export['counters'][raw_name])}"
        )
    for raw_name in sorted(export.get("gauges", {})):
        name = sanitize_metric_name(raw_name, prefix)
        lines.append(f"# TYPE {name} gauge")
        lines.append(
            f"{name} {format_metric_value(export['gauges'][raw_name])}"
        )
    for raw_name in sorted(export.get("histograms", {})):
        lines.extend(
            render_histogram_lines(
                sanitize_metric_name(raw_name, prefix),
                export["histograms"][raw_name],
            )
        )
    return "\n".join(lines) + "\n" if lines else ""


# -- the server ---------------------------------------------------------------


class TelemetryServer:
    """Bounded stdlib HTTP exporter over the process obs state.

    One instance serves one registry (default: the process's active one
    at request time, so enabling obs after the server started still
    works) plus optional health monitor, phase timeline, and tracer.
    ``port=0`` binds an ephemeral port (read :attr:`port` back after
    :meth:`start` — the kill soak's workers publish it to the
    supervisor). ``host_id``/``epoch`` are the fleet identity the
    ``/snapshot`` endpoint tags (:meth:`set_epoch` moves the epoch when
    a membership change — a degraded view, a host return — is adopted,
    so recovery is visible in the tag, not just in the series).
    """

    def __init__(
        self,
        registry=None,
        health=None,
        timeline=None,
        tracer=None,
        host: str = "127.0.0.1",
        port: int = 0,
        host_id: int = 0,
        epoch: int = 0,
        qos=None,
    ) -> None:
        self._registry = registry
        self.health = health
        self._timeline = timeline
        self._tracer = tracer
        #: Per-class QoS provider: a zero-arg callable (or a
        #: static mapping) yielding class name → accounting dict — what
        #: ``ConsensusService.start_telemetry`` wires so ``/snapshot``
        #: carries the class-labeled goodput block the fleet merge and
        #: ``stats --live`` consume. ``None`` keeps the block absent.
        self._qos = qos
        self._host = host
        self._requested_port = int(port)
        self.host_id = int(host_id)
        self._epoch = int(epoch)
        self._epoch_lock = threading.Lock()
        self._server: Optional[HTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- identity ------------------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._epoch_lock:
            return self._epoch

    def set_epoch(self, epoch: int) -> None:
        """Adopt a new membership epoch tag (recovery rides this: the
        kill-soak survivor bumps it when it derives the degraded view)."""
        with self._epoch_lock:
            self._epoch = int(epoch)

    def registry(self):
        """The registry this server reads (the process's active one when
        none was pinned at construction)."""
        return self._registry if self._registry is not None else metrics_registry()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "TelemetryServer":
        """Bind and serve on a daemon thread; returns self (chainable)."""
        if self._server is not None:
            return self
        server = HTTPServer(
            (self._host, self._requested_port), _TelemetryHandler
        )
        server.telemetry = self  # the handler's way back to the state
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="bce-telemetry",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("telemetry server not started")
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def close(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc_info: object) -> None:
        self.close()

    # -- endpoint payloads (also callable without HTTP, for tests) -----------

    def metrics_text(self) -> str:
        return render_prometheus(self.registry().export())

    def snapshot(self) -> Dict[str, object]:
        """The ``/snapshot`` payload: everything live in one JSON-safe
        dict — the per-host record :func:`~.obs.fleet.merge_fleet`
        consumes (``host_id``/``epoch``/``metrics`` are the
        :class:`~.obs.fleet.HostSnapshot` fields)."""
        tracer = self._tracer
        health = self.health
        qos = self._qos() if callable(self._qos) else self._qos
        return {
            "host_id": self.host_id,
            "epoch": self.epoch,
            "metrics": self.registry().export(),
            "phases": self._timeline.totals() if self._timeline else {},
            "trace": {
                "enabled": bool(tracer is not None and tracer.enabled),
                "ring_depths": tracer.ring_depths() if tracer else {},
            },
            "health": health.verdict() if health is not None else None,
            "qos": qos,
            "wall_ts": time.time(),
        }

    def healthz(self) -> Dict[str, object]:
        """The ``/healthz`` payload. Without a health monitor this is
        pure liveness (a server that answers is alive); with one, the
        burn-rate verdict decides."""
        if self.health is None:
            return {"ok": True, "verdict": "healthy", "detail": None}
        verdict = self.health.verdict()
        return {
            "ok": verdict["verdict"] == "healthy",
            "verdict": verdict["verdict"],
            "detail": verdict,
        }


class _TelemetryHandler(BaseHTTPRequestHandler):
    """Route GETs; count and time every scrape; never log to stderr."""

    server_version = "bce-telemetry/1"

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass

    def do_GET(self) -> None:  # noqa: N802 — stdlib dispatch name
        telemetry: TelemetryServer = self.server.telemetry
        start = perf_counter()
        try:
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            if path == "/metrics":
                body = telemetry.metrics_text().encode()
                self._reply(200, body, "text/plain; version=0.0.4")
            elif path == "/snapshot":
                body = json.dumps(
                    telemetry.snapshot(), sort_keys=True,
                    separators=(",", ":"),
                ).encode()
                self._reply(200, body, "application/json")
            elif path == "/healthz":
                payload = telemetry.healthz()
                body = json.dumps(
                    payload, sort_keys=True, separators=(",", ":")
                ).encode()
                self._reply(
                    200 if payload["ok"] else 503, body, "application/json"
                )
            else:
                self._reply(404, b'{"error":"not found"}', "application/json")
        except OSError:
            # Scraper went away mid-reply (broken pipe, connection
            # reset, a poller's timeout abandoning us): nothing to
            # salvage, and never a stderr traceback from this thread.
            return
        registry = telemetry.registry()
        registry.counter("export.scrapes").inc()
        registry.histogram(
            "export.scrape_latency_s", bounds=SCRAPE_LATENCY_BOUNDS
        ).observe(perf_counter() - start)

    def _reply(self, status: int, body: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


# -- scraping (the client half: cli --live, soak pollers) ---------------------


def scrape_endpoint(url: str, timeout: float = 5.0):
    """GET one exporter endpoint → ``(status, parsed_json)``.

    The one place the ``/healthz`` idiom lives: a 503 (burning/degraded)
    carries the verdict in its BODY — an answer, not an error — so HTTP
    error bodies parse like 200s. Network-level failures (refused,
    reset, timeout) still raise: a server that cannot answer at all is
    genuinely unreachable, and the caller decides what absence means.
    """
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as response:
            return response.status, json.load(response)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


# -- live snapshot rendering (the live stats line) ---------------------------


def render_live_snapshot(
    snapshot: Mapping[str, object],
    healthz: Optional[Mapping[str, object]] = None,
) -> str:
    """Human-readable view of one ``/snapshot`` payload (plus, when
    given, the ``/healthz`` verdict) — what a live stats line
    prints next to the ledger bands."""
    lines = []
    verdict = (healthz or {}).get("verdict")
    lines.append(
        f"live host {snapshot.get('host_id', '?')} "
        f"epoch {snapshot.get('epoch', '?')}"
        + (f"  health={verdict}" if verdict else "")
    )
    metrics = snapshot.get("metrics") or {}
    counters = metrics.get("counters") or {}
    gauges = metrics.get("gauges") or {}
    histograms = metrics.get("histograms") or {}
    for title, mapping in (("counters", counters), ("gauges", gauges)):
        if not mapping:
            continue
        lines.append(f"  {title}:")
        for name in sorted(mapping):
            lines.append(f"    {name:<36} {format_metric_value(mapping[name])}")
    if histograms:
        from bayesian_consensus_engine_tpu_torch.obs.metrics import (
            quantile_from_snapshot,
        )

        lines.append("  histograms (count / p50 / p99):")
        for name in sorted(histograms):
            snap = histograms[name]
            p50 = quantile_from_snapshot(snap, 0.5)
            p99 = quantile_from_snapshot(snap, 0.99)

            def num(x):
                return f"{x:.4g}" if isinstance(x, (int, float)) else "-"

            lines.append(
                f"    {name:<36} {int(snap.get('count', 0)):>7}"
                f" {num(p50):>9} {num(p99):>9}"
            )
    qos = snapshot.get("qos") or {}
    if qos:
        lines.append(
            "  qos classes (pending / offered / goodput / burning):"
        )
        for name in sorted(qos):
            record = qos[name] or {}
            goodput = record.get("goodput_within_slo")
            goodput_str = (
                f"{goodput * 100:.1f}%"
                if isinstance(goodput, (int, float)) else "-"
            )
            lines.append(
                f"    {name:<20} {record.get('pending', 0):>7}"
                f" {record.get('offered', 0):>9} {goodput_str:>9}"
                f" {'yes' if record.get('burning') else 'no':>8}"
            )
    phases = snapshot.get("phases") or {}
    if phases:
        lines.append("  phases (exclusive seconds):")
        for name in sorted(phases):
            lines.append(f"    {name:<36} {phases[name]:.4g}")
    rings = (snapshot.get("trace") or {}).get("ring_depths") or {}
    if rings:
        depth = ", ".join(f"{k}={v}" for k, v in sorted(rings.items()))
        lines.append(f"  flight rings: {depth}")
    return "\n".join(lines)
