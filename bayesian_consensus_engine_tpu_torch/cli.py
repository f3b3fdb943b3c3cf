"""Command-line surface of the port — the JAX package's CLI, on the card.

    python -m bayesian_consensus_engine_tpu_torch.cli \
        [--db PATH] [--dry-run] [--input FILE] [--backend B] [--device D] \
        [COMMAND ...]

(installed as ``bce-torch``). The parser is the JAX package's: the same
global flags, subcommands, argument names and defaults, and the same
stdout and exit codes on the same arguments. Subcommands:
``consensus``, ``report-outcome``, ``list-sources``, ``journal-export``,
``serve``, ``replay``, ``stats`` and ``trace``; with no subcommand,
legacy consensus on ``--input``/stdin without a DB. Output is
pretty-printed JSON on stdout; validation errors go to stderr with exit code 1, and DB
subcommand failures print ``Error: ...`` and exit 1.

The port adds one global flag, ``--device`` (default ``cuda``), its
device seam: it reaches the store ``serve`` builds
(``TensorReliabilityStore(device=...)``), ``journal-export``'s
``replay_journal(..., device=...)``, the array backend's
``compute_consensus(..., device=...)`` and ``replay``'s sweep. Without
CUDA a command that needs a device fails with the store's message
unless ``--device cpu`` is given; nothing falls back. ``--backend`` takes ``python`` (the
default, the scalar path), ``torch`` (the batched array path), and the
JAX package's ``jax`` and ``tpu``, which select the same array path.

``serve`` runs the network front door — :class:`~.net.server.
ConsensusServer` over the coalescing :class:`~.serve.coalesce.
ConsensusService`, on the flat settle path (the ``settle_cycles``
kernel on the card) — printing a banner JSON line on bind and a summary
document on exit; repeated ``--qos`` specs declare tenant classes.
``journal-export`` replays a durability journal and writes the SQLite
interchange file; ``stats`` renders an obs run ledger (and, with
``--live URL``, a running telemetry exporter's snapshot); ``trace``
converts a span log to Chrome/Perfetto trace-event JSON.

``replay`` re-drives a recorded journal's trace sidecar under K altered
configs through the replay lab (``replay/``): lane 0 reproduces the
recorded run byte for byte, and every lane advances through one
``settle_cycles_lanes`` launch a batch on ``--device``.

``lint`` and ``bank`` stay in the parser, so the surface matches, but are
not ported yet: each prints an error naming the ROADMAP item that brings
it and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from typing import Any

from bayesian_consensus_engine_tpu_torch.core import (
    ValidationError,
    compute_consensus,
    validate_input_payload,
)
from bayesian_consensus_engine_tpu_torch.state import SQLiteReliabilityStore


def _read_payload(input_path: str | None) -> dict[str, Any]:
    """Load the JSON payload from a file or stdin (reference: cli.py:14-22)."""
    if input_path:
        with open(input_path, "r", encoding="utf-8") as f:
            return json.load(f)
    if sys.stdin.isatty():
        raise ValidationError("Input required: provide --input <file> or JSON via stdin")
    return json.load(sys.stdin)


def _emit(document: dict[str, Any]) -> None:
    print(json.dumps(document, indent=2))


def _run_consensus(args: argparse.Namespace) -> None:
    try:
        payload = _read_payload(args.input)
        validate_input_payload(payload)

        source_reliability = None
        if args.db:
            with SQLiteReliabilityStore(args.db) as store:
                source_reliability = {}
                for signal in payload.get("signals", []):
                    sid = signal.get("sourceId")
                    if sid:
                        record = store.get_reliability(
                            sid, payload["marketId"], apply_decay=True
                        )
                        source_reliability[sid] = {
                            "reliability": record.reliability,
                            "confidence": record.confidence,
                        }

        result = compute_consensus(
            payload["signals"], source_reliability, backend=args.backend,
            device=args.device,
        )
        if args.dry_run:
            result["diagnostics"]["dryRun"] = True
        _emit(result)
    except (json.JSONDecodeError, ValidationError) as exc:
        print(f"Validation error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc
    except (NotImplementedError, RuntimeError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc


def _run_legacy_consensus(args: argparse.Namespace) -> None:
    """No-subcommand mode: consensus from --input/stdin, no DB lookups."""
    try:
        payload = _read_payload(args.input)
        validate_input_payload(payload)
        result = compute_consensus(
            payload["signals"], backend=args.backend, device=args.device
        )
        if args.dry_run:
            result["diagnostics"]["dryRun"] = True
        _emit(result)
    except (json.JSONDecodeError, ValidationError) as exc:
        print(f"Validation error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc
    except (NotImplementedError, RuntimeError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc


def _run_report_outcome(args: argparse.Namespace) -> None:
    if not args.db:
        print("Error: --db is required for report-outcome", file=sys.stderr)
        raise SystemExit(1)
    try:
        with SQLiteReliabilityStore(args.db) as store:
            record = store.update_reliability(
                source_id=args.source_id,
                market_id=args.market_id,
                outcome_correct=args.correct,
                dry_run=args.dry_run,
            )
        _emit(
            {
                "sourceId": record.source_id,
                "marketId": record.market_id,
                "reliability": record.reliability,
                "confidence": record.confidence,
                "updatedAt": record.updated_at,
                "dryRun": args.dry_run,
            }
        )
    except Exception as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc


def _run_journal_export(args: argparse.Namespace) -> None:
    """Replay a durability journal and export the SQLite interchange file.

    Additive maintenance command (no reference counterpart): the
    crash-recovery path for a service that streamed with
    ``settle_stream(journal=...)`` — replay the fsynced epochs (torn
    tails dropped), report the durable watermark, and write the
    reference-compatible SQLite file. Honors the global ``--dry-run``
    (replay + report, never write) and ``--db`` (the export target).
    """
    if not args.db and not args.dry_run:
        print(
            "Error: --db is required for journal-export (or use --dry-run)",
            file=sys.stderr,
        )
        raise SystemExit(1)
    if (
        not args.dry_run
        and os.path.exists(args.db)
        and os.path.getsize(args.db) > 0
    ):
        # An export must EQUAL the recovered journal state; flushing into
        # an existing file would UPSERT-merge and leave stale rows the
        # journal never held.
        print(
            f"Error: export target {args.db} already exists — "
            "journal-export writes a fresh interchange file",
            file=sys.stderr,
        )
        raise SystemExit(1)
    try:
        from bayesian_consensus_engine_tpu_torch.state.journal import replay_journal

        store, tag = replay_journal(args.journal, device=args.device)
        rows = store.live_row_count()
        exported = None
        if not args.dry_run:
            store.flush_to_sqlite(args.db)
            exported = args.db
        _emit(
            {
                "journal": args.journal,
                "epochTag": tag,
                "rows": rows,
                "exportedTo": exported,
                "dryRun": args.dry_run,
            }
        )
    except Exception as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc


def _run_list_sources(args: argparse.Namespace) -> None:
    if not args.db:
        print("Error: --db is required for list-sources", file=sys.stderr)
        raise SystemExit(1)
    try:
        with SQLiteReliabilityStore(args.db) as store:
            records = store.list_sources(market_id=args.market_id)
        _emit(
            {
                "sources": [
                    {
                        "sourceId": r.source_id,
                        "marketId": r.market_id,
                        "reliability": r.reliability,
                        "confidence": r.confidence,
                        "updatedAt": r.updated_at,
                    }
                    for r in records
                ],
                "count": len(records),
            }
        )
    except Exception as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc


def _parse_replay_config(spec: str):
    """``field=value[,field=value...]`` → :class:`~.replay.ReplayConfig`.

    Fields are the sweep's knobs (``half_life_days``, ``decay_floor``,
    ``base_learning_rate``, ``max_update_step``, ``band_z``,
    ``graph_damping``, ``graph_steps``, ``graph_tol``); unnamed fields keep
    the recorded constants.
    """
    from bayesian_consensus_engine_tpu_torch.replay import ReplayConfig

    kwargs: dict[str, Any] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, value = part.partition("=")
        name = name.strip()
        if not eq or name not in ReplayConfig._fields:
            raise ValueError(
                f"--configs takes field=value pairs over "
                f"{', '.join(ReplayConfig._fields)}; got {part!r}"
            )
        kwargs[name] = int(value) if name == "graph_steps" else float(value)
    return ReplayConfig(**kwargs)


def _run_replay(args: argparse.Namespace) -> None:
    """Counterfactual replay: re-drive a journal's trace under K configs.

    Loads the trace sidecar of one recorded journal (or the merged trace
    of several fleet band journals) and runs one
    :func:`~.replay.replay_sweep` on ``--device``: every ``--configs``
    spec is a lane beside the recorded lane 0. Prints a per-lane table
    (markets settled, Brier mean, band width, graph Brier) with each
    lane's Brier against the recorded lane's, or with ``--json`` the
    machine document. The global ``--db`` exports lane 0's rebuilt state
    as the SQLite interchange file (refused if the target exists;
    ``--dry-run`` skips the write), and the printed lane-0 digest equals
    the live run's store digest. ``--strict`` refuses a torn trace tail.
    Lanes with ``graph_steps > 0`` need a market graph: Python API only.
    """
    try:
        configs = [_parse_replay_config(s) for s in (args.configs or [])]
    except ValueError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc
    if any(config.graph_steps > 0 for config in configs):
        print(
            "Error: graph_steps > 0 needs a MarketGraph — use the "
            "Python API (replay.replay_sweep(..., graph=...))",
            file=sys.stderr,
        )
        raise SystemExit(1)
    export_db = args.db if not args.dry_run else None
    if (
        export_db
        and os.path.exists(export_db)
        and os.path.getsize(export_db) > 0
    ):
        print(
            f"Error: export target {export_db} already exists — "
            "replay writes a fresh interchange file",
            file=sys.stderr,
        )
        raise SystemExit(1)
    try:
        from bayesian_consensus_engine_tpu_torch.replay import (
            RECORDED_CONFIG,
            load_cluster_trace,
            load_trace,
            replay_sweep,
        )

        if len(args.journals) == 1:
            trace = load_trace(args.journals[0], strict=args.strict)
        else:
            trace = load_cluster_trace(args.journals, strict=args.strict)
        result = replay_sweep(trace, configs, db_path=export_db,
                              device=args.device)
    except Exception as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc

    recorded = result.lanes[0]

    def delta_fields(config) -> dict[str, Any]:
        return {
            field: getattr(config, field)
            for field in RECORDED_CONFIG._fields
            if getattr(config, field) != getattr(RECORDED_CONFIG, field)
        }

    if args.json:
        _emit(
            {
                "journals": list(args.journals),
                "batches": result.batches,
                "digest": result.digest,
                "resultDigest": result.result_digest,
                "exportedTo": export_db,
                "dryRun": args.dry_run,
                "lanes": [
                    {
                        "config": dict(lane.config._asdict()),
                        "delta": delta_fields(lane.config),
                        "marketsSettled": lane.markets_settled,
                        "brierMean": lane.brier_mean,
                        "bandWidthMean": lane.band_width_mean,
                        "graphBrierMean": lane.graph_brier_mean,
                    }
                    for lane in result.lanes
                ],
            }
        )
        return

    def num(x: float) -> str:
        return f"{x:.4g}" if x == x else "-"  # NaN when nothing settled

    print(
        f"{', '.join(args.journals)}: {result.batches} batches, "
        f"{len(result.lanes)} lanes, lane-0 digest {result.digest}"
    )
    print(
        f"{'lane':>4} {'settled':>8} {'brier':>9} {'band_w':>9} "
        f"{'g_brier':>9}  config"
    )
    for index, lane in enumerate(result.lanes):
        delta = delta_fields(lane.config)
        label = (
            "recorded"
            if not delta
            else ",".join(f"{k}={v:g}" for k, v in sorted(delta.items()))
        )
        trailer = (
            f"  brier {num(recorded.brier_mean)}->{num(lane.brier_mean)}"
            if index else ""
        )
        print(
            f"{index:>4} {lane.markets_settled:>8} "
            f"{num(lane.brier_mean):>9} {num(lane.band_width_mean):>9} "
            f"{num(lane.graph_brier_mean):>9}  {label}{trailer}"
        )
    if export_db:
        print(f"exported lane-0 state to {export_db}")


def _not_ported(command: str, item: int):
    """A handler for a subcommand the port does not carry yet."""

    def handler(args: argparse.Namespace) -> None:
        print(
            f"Error: {command} is not ported yet (ROADMAP queue 1 item "
            f"{item})",
            file=sys.stderr,
        )
        raise SystemExit(1)

    return handler


def _run_stats(args: argparse.Namespace) -> None:
    """Render an obs run ledger (JSONL) as per-leg bands.

    Folds one ledger file (``obs/ledger.py`` records) into per-leg
    min/max bands with the host load that attributes the spread, with
    the extra columns its records carry (latency quantiles, peak device
    memory, ingest and interning waits, recovery, SLO and per-class
    goodput). ``--json`` emits the machine-shaped summary instead of the
    table. ``--against OLD.jsonl`` compares each leg's band against an
    older ledger's and flags bands that stopped overlapping. ``--live
    URL`` scrapes a running telemetry exporter (``obs/export.py``'s
    ``/snapshot`` and ``/healthz``, as ``ConsensusService.
    start_telemetry`` serves them) and renders the live counters,
    gauges, latency histograms, phase sums and burn-rate verdict beside
    the ledger bands, or alone when no ledger is given.
    """
    from bayesian_consensus_engine_tpu_torch.obs.ledger import (
        diff_bands,
        read_ledger,
        render,
        render_diff,
        summarize,
    )

    if args.ledger is None and not args.live:
        print("Error: give a ledger path and/or --live URL", file=sys.stderr)
        raise SystemExit(1)
    if args.against and args.ledger is None:
        # Diffing needs a NEW ledger to stand on — a live scrape is not
        # band-shaped data, and diffing OLD against nothing would render
        # every leg as removed.
        print(
            "Error: --against diffs two ledgers — give the new ledger "
            "path too",
            file=sys.stderr,
        )
        raise SystemExit(1)

    live_snapshot = live_health = None
    if args.live:
        from bayesian_consensus_engine_tpu_torch.obs.export import scrape_endpoint

        base = args.live.rstrip("/")
        try:
            _status, live_snapshot = scrape_endpoint(base + "/snapshot")
            # A 503 /healthz (burning/degraded) still carries the
            # verdict in its body — scrape_endpoint parses it either way.
            _status, live_health = scrape_endpoint(base + "/healthz")
        except (OSError, ValueError) as exc:
            print(f"Error: scrape of {base} failed: {exc}", file=sys.stderr)
            raise SystemExit(1) from exc

    try:
        records = read_ledger(args.ledger) if args.ledger else []
        old_records = (
            read_ledger(args.against) if args.against else None
        )
    except (OSError, ValueError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc
    if args.leg:
        records = [r for r in records if r.get("leg") == args.leg]
        if old_records is not None:
            old_records = [
                r for r in old_records if r.get("leg") == args.leg
            ]
    def _print_live() -> None:
        if live_snapshot is None:
            return
        from bayesian_consensus_engine_tpu_torch.obs.export import (
            render_live_snapshot,
        )

        print(f"{args.live} (live)")
        print(render_live_snapshot(live_snapshot, live_health))

    live_payload = (
        {"url": args.live, "snapshot": live_snapshot,
         "healthz": live_health}
        if live_snapshot is not None else None
    )
    if old_records is not None:
        diff = diff_bands(old_records, records)
        if args.json:
            document = {"ledger": args.ledger, "against": args.against,
                        "legs": diff}
            if live_payload is not None:
                document["live"] = live_payload
            _emit(document)
        else:
            print(f"{args.ledger} vs {args.against}")
            print(render_diff(diff))
            _print_live()
        return
    if args.json:
        document = {"ledger": args.ledger, "records": len(records),
                    "legs": summarize(records)}
        if live_payload is not None:
            document["live"] = live_payload
        _emit(document)
    else:
        if args.ledger is not None:
            print(f"{args.ledger}: {len(records)} records")
            print(render(records))
        _print_live()


def _parse_qos_spec(spec: str):
    """``name:slo_s:max_pending[:policy[:burning]]`` → QosClass.

    The CLI shape of :class:`~.serve.admission.QosClass`:
    ``premium:0.05:512`` declares class *premium* with a 50 ms SLO and
    a 512-request budget (reject policy); a fourth field picks the
    overload policy (``reject``/``shed_oldest``) and a literal fifth
    field ``burning`` opts the class into shedding on its own burn-rate
    verdict (``shed_when_burning``).
    """
    from bayesian_consensus_engine_tpu_torch.serve import QosClass

    parts = spec.split(":")
    if len(parts) < 3 or len(parts) > 5:
        raise ValueError(
            f"--qos takes name:slo_s:max_pending[:policy[:burning]]; "
            f"got {spec!r}"
        )
    if len(parts) == 5 and parts[4] != "burning":
        raise ValueError(
            f"--qos fifth field must be the literal 'burning'; got "
            f"{parts[4]!r}"
        )
    return QosClass(
        name=parts[0],
        slo_s=float(parts[1]),
        max_pending=int(parts[2]),
        policy=parts[3] if len(parts) > 3 else "reject",
        shed_when_burning=len(parts) == 5,
    )


def _run_serve(args: argparse.Namespace) -> None:
    """Run the network front door: socket server → coalescer → session.

    Composes the serving stack over one fresh store on ``--device``:
    a :class:`~.serve.coalesce.ConsensusService` (journal durability
    via ``--journal``, rolling SQLite via the global ``--db``, QoS
    classes via repeated ``--qos`` specs, a global SLO via
    ``--slo-ms``) behind a :class:`~.net.server.ConsensusServer`
    (``--port 0`` binds ephemeral), optionally exposing the live
    telemetry plane (``--telemetry-port``). Prints ONE banner JSON line
    (address, port, classes, telemetry URL) when the socket is bound —
    the line a launcher script parses — then serves for ``--duration``
    seconds (0 = until interrupted). On exit the service drains and
    closes (journal ends on a joined epoch) and a summary JSON document
    (requests, batches, per-class goodput) lands on stdout. The service
    runs without a mesh, so every batch is one flat settle (one
    ``settle_cycles`` launch on the card).
    """
    import asyncio

    try:
        qos = [_parse_qos_spec(spec) for spec in (args.qos or [])]
    except ValueError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc

    from bayesian_consensus_engine_tpu_torch import obs
    from bayesian_consensus_engine_tpu_torch.net import ConsensusServer
    from bayesian_consensus_engine_tpu_torch.obs.metrics import metrics_registry
    from bayesian_consensus_engine_tpu_torch.serve import ConsensusService
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    # A live registry BEFORE the service binds its counters: without
    # one, every metric is the shared no-op (obs disabled by default),
    # the exit summary would report zeros, and --telemetry-port would
    # export an empty plane — the one process where obs is the product.
    obs.set_metrics_registry(obs.MetricsRegistry())
    try:
        store = TensorReliabilityStore(device=args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc

    async def main() -> dict[str, Any]:
        service = ConsensusService(
            store,
            steps=args.steps,
            journal=args.journal,
            db_path=args.db,
            max_batch=args.max_batch,
            max_delay_s=args.max_delay_ms / 1e3,
            qos=qos or None,
            slo=(args.slo_ms / 1e3) if args.slo_ms else None,
        )
        telemetry_url = None
        if args.telemetry_port is not None:
            telemetry = service.start_telemetry(port=args.telemetry_port)
            telemetry_url = telemetry.url
        server = await ConsensusServer(
            service, host=args.host, port=args.port,
            acceptors=args.acceptors,
        ).start()
        banner = {
            "address": server.address,
            "port": server.port,
            "classes": [cls.name for cls in qos],
            "telemetry": telemetry_url,
        }
        print(json.dumps(banner, sort_keys=True), flush=True)
        # Ctrl-C must still land the exit summary: route SIGINT through
        # a stop event so the interrupted path drains and returns like
        # the --duration path, instead of cancelling main() before the
        # summary is built (the outer KeyboardInterrupt catch is only
        # the fallback for loops without signal-handler support).
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(signal.SIGINT, stop.set)
            sigint_routed = True
        except (NotImplementedError, RuntimeError, ValueError):
            sigint_routed = False
        try:
            if args.duration > 0:
                try:
                    await asyncio.wait_for(stop.wait(), args.duration)
                except asyncio.TimeoutError:
                    pass
            else:
                await stop.wait()  # until interrupted
        finally:
            if sigint_routed:
                loop.remove_signal_handler(signal.SIGINT)
            await server.close()
            await service.close()
        counters = metrics_registry().export().get("counters", {})
        return {
            "served": {
                "connections": counters.get("net.connections", 0),
                "requests": counters.get("net.requests", 0),
                "responses": counters.get("net.responses", 0),
                "wireErrors": counters.get("net.wire_errors", 0),
                "batches": counters.get("serve.batches", 0),
            },
            "goodputWithinSlo": (service.goodput() or {}).get(
                "goodput_within_slo"
            ),
            "qos": service.qos_snapshot(),
        }

    try:
        summary = asyncio.run(main())
    except KeyboardInterrupt:
        return
    except Exception as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc
    _emit(summary)


def _run_trace(args: argparse.Namespace) -> None:
    """Convert a tracer span log (JSONL) to Chrome trace-event JSON.

    The reading half of request-scoped tracing (obs/trace.py): a service
    dumps its span log with ``Tracer.write_jsonl``; this subcommand
    converts it to the Chrome trace-event format, which loads at
    https://ui.perfetto.dev (or ``chrome://tracing``) — host request/
    batch/journal spans on named lanes, viewable alongside a device
    profile captured with ``utils.profiling.trace``. Output keys are
    sorted (deterministic bytes for a deterministic span log, the DT203
    contract).
    """
    from bayesian_consensus_engine_tpu_torch.obs.trace import (
        load_trace_jsonl,
        to_chrome_trace,
    )

    try:
        events = load_trace_jsonl(args.trace)
        document = to_chrome_trace(events)
        out = args.out or (args.trace + ".chrome.json")
        with open(out, "w", encoding="utf-8") as f:
            json.dump(document, f, sort_keys=True)
    except (OSError, ValueError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc
    _emit(
        {
            "trace": args.trace,
            "events": len(events),
            "traceEvents": len(document["traceEvents"]),
            "out": out,
        }
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="bce-torch",
        description=(
            "Reliability-weighted consensus over probability signals, "
            "with persistent per-(source, market) track records — "
            "PyTorch/CUDA port, reference-compatible surface"
        ),
    )
    parser.add_argument(
        "--db",
        type=str,
        help="SQLite file holding reliability state (omit for an ephemeral run)",
    )
    parser.add_argument(
        "--dry-run",
        action="store_true",
        help="show what would change while guaranteeing the DB is never written",
    )
    parser.add_argument(
        "--input",
        type=str,
        help="read the consensus payload from this JSON file instead of stdin",
    )
    parser.add_argument(
        "--backend",
        choices=("python", "torch", "jax", "tpu"),
        default="python",
        help=(
            "which consensus engine runs the math (default: python, "
            "bit-exact; torch is the batched array path, jax and tpu "
            "select the same path)"
        ),
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help=(
            "where the array backend, journal-export and serve run "
            "(default: cuda; pass cpu to run on the CPU)"
        ),
    )

    sub = parser.add_subparsers(dest="command", help="subcommands")

    consensus = sub.add_parser(
        "consensus",
        help="weigh a payload's signals into a consensus document",
    )
    consensus.add_argument(
        "--input", help="JSON payload file (stdin when omitted)"
    )
    consensus.set_defaults(handler=_run_consensus)

    outcome = sub.add_parser(
        "report-outcome",
        help="settle one source's prediction and adjust its reliability",
    )
    outcome.add_argument(
        "--source-id", required=True, help="which source to settle"
    )
    outcome.add_argument(
        "--market-id", required=True, help="the market the prediction was for"
    )
    outcome.add_argument(
        "--correct",
        action="store_true",
        help="the source called it right (omit for a wrong call)",
    )
    outcome.set_defaults(handler=_run_report_outcome)

    listing = sub.add_parser(
        "list-sources",
        help="dump every stored reliability record as JSON",
    )
    listing.add_argument(
        "--market-id", help="restrict the listing to one market"
    )
    listing.set_defaults(handler=_run_list_sources)

    journal = sub.add_parser(
        "journal-export",
        help=(
            "replay a settle_stream durability journal and export the "
            "SQLite interchange file to --db"
        ),
    )
    journal.add_argument(
        "journal", help="path to the journal written by settle_stream"
    )
    journal.set_defaults(handler=_run_journal_export)

    serve = sub.add_parser(
        "serve",
        help=(
            "run the network front door: a length-prefixed socket "
            "server (net/) over the coalescing consensus service, with "
            "optional multi-tenant QoS classes"
        ),
    )
    serve.add_argument(
        "--host", default="127.0.0.1", help="bind address"
    )
    serve.add_argument(
        "--port", type=int, default=0,
        help="bind port (0 = ephemeral; read the banner JSON back)",
    )
    serve.add_argument(
        "--acceptors", type=int, default=4,
        help="asyncio acceptor tasks over the listening socket",
    )
    serve.add_argument(
        "--qos", action="append", metavar="NAME:SLO_S:MAX_PENDING[:POLICY[:burning]]",
        help=(
            "declare one QoS class (repeatable; first = default class); "
            "e.g. premium:0.05:512 besteffort:1.0:64:shed_oldest:burning"
        ),
    )
    serve.add_argument(
        "--steps", type=int, default=1, help="settlement steps per batch"
    )
    serve.add_argument(
        "--max-batch", type=int, default=256,
        help="coalescing window size bound",
    )
    serve.add_argument(
        "--max-delay-ms", type=float, default=5.0,
        help="coalescing window max delay",
    )
    serve.add_argument(
        "--slo-ms", type=float, default=None,
        help="service-wide latency objective (per-class SLOs ride --qos)",
    )
    serve.add_argument(
        "--journal", default=None,
        help="durability journal path (epochs per checkpoint cadence)",
    )
    serve.add_argument(
        "--telemetry-port", type=int, default=None,
        help="also expose the live telemetry plane on this port (0 = ephemeral)",
    )
    serve.add_argument(
        "--duration", type=float, default=0.0,
        help="serve this many seconds then drain (0 = until interrupted)",
    )
    serve.set_defaults(handler=_run_serve)

    replay = sub.add_parser(
        "replay",
        help=(
            "counterfactual replay: re-drive a recorded journal's trace "
            "sidecar under K altered configs through one vmapped "
            "settlement program (lane 0 = the recorded run, "
            "byte-exact)"
        ),
    )
    replay.add_argument(
        "journals", nargs="+",
        help=(
            "journal(s) with trace sidecars (settle_stream trace=); "
            "several paths merge as one fleet trace"
        ),
    )
    replay.add_argument(
        "--configs", action="append",
        metavar="FIELD=VALUE[,FIELD=VALUE...]",
        help=(
            "one counterfactual lane (repeatable); fields: "
            "half_life_days, decay_floor, base_learning_rate, "
            "max_update_step, band_z, graph_damping, graph_steps, "
            "graph_tol — "
            "e.g. --configs half_life_days=20,max_update_step=0.05"
        ),
    )
    replay.add_argument(
        "--strict", action="store_true",
        help=(
            "refuse a torn trace tail instead of replaying to the last "
            "joined epoch"
        ),
    )
    replay.add_argument(
        "--json", action="store_true",
        help="machine-readable sweep document instead of the table",
    )
    replay.set_defaults(handler=_run_replay)

    stats = sub.add_parser(
        "stats",
        help=(
            "render an obs run ledger (bench/soak JSONL) as per-leg "
            "min/max bands with host-load attribution"
        ),
    )
    stats.add_argument(
        "ledger", nargs="?", default=None,
        help=(
            "path to a JSONL run ledger (bench.py --ledger); optional "
            "when --live is given"
        ),
    )
    stats.add_argument("--leg", help="restrict to one leg name")
    stats.add_argument(
        "--against", metavar="OLD_LEDGER",
        help=(
            "cross-round diff: compare each leg's band against this "
            "older ledger and flag bands that stopped overlapping"
        ),
    )
    stats.add_argument(
        "--live", metavar="URL",
        help=(
            "scrape a running telemetry exporter (obs/export.py) and "
            "render its /snapshot + /healthz next to the ledger bands"
        ),
    )
    stats.add_argument(
        "--json", action="store_true",
        help="machine-readable summary instead of the table",
    )
    stats.set_defaults(handler=_run_stats)

    trace = sub.add_parser(
        "trace",
        help=(
            "convert a tracer span log (obs.Tracer.write_jsonl JSONL) "
            "to Chrome/Perfetto trace-event JSON"
        ),
    )
    trace.add_argument(
        "trace", help="path to a span-log JSONL written by obs.Tracer"
    )
    trace.add_argument(
        "--out",
        help="output path (default: <trace>.chrome.json)",
    )
    trace.set_defaults(handler=_run_trace)

    lint = sub.add_parser(
        "lint",
        help=(
            "(not ported yet) run graftlint — JAX/determinism/layering "
            "static analysis "
            "(exit 1 on any error-severity finding)"
        ),
    )
    lint.add_argument(
        "paths",
        nargs="*",
        help="files/dirs to check (default: the repo gate set)",
    )
    lint.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format (default: text)",
    )
    lint.add_argument(
        "--select",
        help="comma-separated rule IDs to run (default: all)",
    )
    lint.add_argument(
        "--cache",
        metavar="PATH",
        help=(
            "JSON sidecar for per-file result caching — warm runs of an "
            "unchanged tree skip re-parsing entirely"
        ),
    )
    lint.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )
    lint.set_defaults(handler=_not_ported("lint", 10))

    bank = sub.add_parser(
        "bank",
        help=(
            "(not ported yet) export/merge/show the versioned autotune "
            "bank — shippable "
            "kernel-knob verdicts keyed by (device generation, shape)"
        ),
    )
    bank_sub = bank.add_subparsers(dest="bank_verb", required=True)
    bank_export = bank_sub.add_parser(
        "export",
        help="fold a host's tuner cache into a shippable bank payload",
    )
    bank_export.add_argument(
        "--cache",
        help=(
            "tuner cache to export (default: the live BCE_AUTOTUNE_CACHE "
            "resolution)"
        ),
    )
    bank_export.add_argument(
        "--device-kind",
        help="export only this accelerator's verdicts (default: all)",
    )
    bank_export.add_argument(
        "-o", "--out", help="write the bank here (default: stdout)"
    )
    bank_export.set_defaults(handler=_not_ported("bank", 10))
    bank_merge = bank_sub.add_parser(
        "merge",
        help=(
            "merge bank files; refuses on a verdict flip (same "
            "knob/shape/generation, different adjudication)"
        ),
    )
    bank_merge.add_argument(
        "banks", nargs="+", help="bank files to merge"
    )
    bank_merge.add_argument(
        "-o", "--out", help="write the merged bank here (default: stdout)"
    )
    bank_merge.set_defaults(handler=_not_ported("bank", 10))
    bank_show = bank_sub.add_parser(
        "show",
        help="schema-validate a bank file and render its verdicts",
    )
    bank_show.add_argument("bank", help="bank file to inspect")
    bank_show.set_defaults(handler=_not_ported("bank", 10))

    return parser


def main() -> None:
    args = build_parser().parse_args()
    if args.command is None:
        _run_legacy_consensus(args)
    else:
        args.handler(args)


if __name__ == "__main__":
    main()
