"""The kill soak: failure as steady state, goodput as the verdict.

Runs a shared-nothing banded cluster (``cluster/membership.py``: N worker
PROCESSES, each settling its deterministic band of the global markets
axis on its own local mesh through a resident session, journaling every
batch), then — mid-stream — sends SIGKILL to one live worker and proves
the recovery end to end:

  1. the supervisor observes the death and publishes the DEGRADED
     membership view (epoch + 1 over the survivors; every survivor would
     derive the same view: the supervisor is a failure detector, never a
     layout coordinator);
  2. exactly one survivor picks the epoch bump up between batches,
     replays the dead band's journal INTO its live store
     (``cluster.recover.adopt_journal``), and its resident session carries
     the orphan rows onto the device block through the adopt relayout —
     the stream resumes on the degraded view without a process restart, a
     session teardown or a single ``rebuild``;
  3. the headline is the recovered ``goodput_within_slo``
     (``obs/slo.py``): every offered request counts, and the batches the
     dead worker offered but never made durable re-drive on the survivor
     and land as SLO violations;
  4. the byte coda: at adoption the survivor's live store must equal
     (``store_digest`` and SQLite export bytes) ``replay_cluster_journals``
     over the surviving journals, and at exit the survivor's OWN journal
     must replay to its final store;
  5. every worker serves the live telemetry plane (``obs/export.py``:
     ``/metrics``, ``/snapshot``, ``/healthz`` on an ephemeral port) and
     feeds a burn-rate monitor (``obs/health.py``); the supervisor polls
     ``/healthz`` through the kill window and folds the scraped
     ``/snapshot``\\ s (``obs/fleet.py``): the degraded epoch shows the dead
     host in ``hosts_absent``, and two fold orders give identical bytes.

Run from a checkout's root::

    python -m bayesian_consensus_engine_tpu_torch.cluster.soak
        [--hosts 2] [--markets 64] [--batches 12] [--kill-after 3]
        [--interval 0.15] [--slo 0.5] [--device cuda|cpu] [--json]
        [--ledger soak.jsonl]

Workers settle on ``--device`` (``cuda`` by default: every worker on the
current card, each with its own CUDA context; ``cpu`` for tests). With
``cuda`` the supervisor builds the kernels once before it starts the
workers, which load that build. Exit code 0 iff every assertion holds;
the final stdout line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

SOAK_SEED = 20260803
MODULE = "bayesian_consensus_engine_tpu_torch.cluster.soak"


def _membership_path(shared: str) -> str:
    return os.path.join(shared, "membership.json")


def _telemetry_path(shared: str, host: int) -> str:
    return os.path.join(shared, f"telemetry_{host}.json")


def _write_telemetry_port(shared: str, host: int, port: int) -> None:
    tmp = _telemetry_path(shared, host) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"host": host, "port": port}, f, sort_keys=True)
    os.replace(tmp, _telemetry_path(shared, host))


def _write_membership(shared: str, view, kill_ts=None) -> None:
    payload = {
        "epoch": view.epoch,
        "hosts": list(view.hosts),
        "devices_per_host": view.devices_per_host,
        "fingerprint": view.fingerprint.hex(),
        "kill_ts": kill_ts,
    }
    tmp = _membership_path(shared) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True)
    os.replace(tmp, _membership_path(shared))


def _read_membership(shared: str) -> dict:
    with open(_membership_path(shared)) as f:
        return json.load(f)


def _initial_view(args):
    from bayesian_consensus_engine_tpu_torch.cluster.membership import MeshView

    return MeshView(
        epoch=0,
        hosts=tuple(range(args.hosts)),
        devices_per_host=args.devices_per_host,
    )


def view0_rows(args, host: int) -> range:
    """Epoch-0 band rows of *host* — the ownership the workload is keyed
    by (orphan bands keep their original rows; only the SERVING host
    changes across epochs)."""
    return _initial_view(args).owned_markets(host, args.markets)


def _band_batch(args, index: int, rows: range, key_cache: dict):
    """Band *rows*' columnar slice of deterministic global batch *index*:
    ``(keys, source codes, probabilities, offsets, outcomes)``.

    Every host draws the SAME global batch from the seed alone and keeps
    its rows, which is what lets a survivor re-drive a dead band's
    remaining batches bit for bit. The topology (signal counts and the
    source assignment ``s{(g·3 + j·7 + drift) % sources}``) is a function
    of the drift period ``index // 2``, the values of the batch: batches
    inside a period are fingerprint hits (probability refresh), period
    boundaries topology misses (adopt relayout). The draws are the JAX
    package's ``scripts/kill_soak.py``'s, made in bulk."""
    import numpy as np

    from bayesian_consensus_engine_tpu_torch.cluster.rank import band_columns

    markets = args.markets
    drift = index // 2
    rng_topo = np.random.default_rng((SOAK_SEED, 1, drift))
    rng_vals = np.random.default_rng((SOAK_SEED, 2, index))
    counts = rng_topo.integers(1, 4, markets)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    probs = rng_vals.random(int(counts.sum()))
    outcomes = rng_vals.random(markets) < 0.5
    market = np.repeat(np.arange(markets, dtype=np.int64), counts)
    slot = np.arange(offsets[-1], dtype=np.int64) - np.repeat(
        offsets[:-1], counts)
    codes = (market * 3 + slot * 7 + drift) % args.sources
    if "keys" not in key_cache:
        key_cache["keys"] = [f"m{g}" for g in range(markets)]
    return band_columns(
        (key_cache["keys"], codes, probs, offsets, outcomes), rows)


# --------------------------------------------------------------------------
# worker
# --------------------------------------------------------------------------


def run_worker(args) -> int:
    import numpy as np
    import torch

    from bayesian_consensus_engine_tpu_torch.cluster.recover import (
        adopt_journal,
        replay_cluster_journals,
        store_digest,
    )
    from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes
    from bayesian_consensus_engine_tpu_torch.obs.export import TelemetryServer
    from bayesian_consensus_engine_tpu_torch.obs.health import (
        BurnWindow,
        HealthMonitor,
    )
    from bayesian_consensus_engine_tpu_torch.obs.metrics import (
        MetricsRegistry,
        set_metrics_registry,
    )
    from bayesian_consensus_engine_tpu_torch.parallel.mesh import make_mesh
    from bayesian_consensus_engine_tpu_torch.serve.driver import (
        PlanCache,
        SessionDriver,
    )
    from bayesian_consensus_engine_tpu_torch.state.journal import JournalWriter
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    me = args.worker
    shared = args.dir
    view = _initial_view(args)
    # Shared-nothing: this host's LOCAL mesh over its own devices (on one
    # card every worker's mesh repeats that card).
    mesh = make_mesh((args.devices_per_host, 1),
                     [torch.device(args.device)] * args.devices_per_host)
    registry = MetricsRegistry()
    set_metrics_registry(registry)
    source_table = [f"s{i}" for i in range(args.sources)]
    key_cache: dict = {}

    # The live health surface: a burn-rate monitor fed with this band's
    # per-request outcomes, windows sized to the band (one batch's worth
    # fast, four slow), exported over the stdlib telemetry server.
    band_rows = max(1, len(view0_rows(args, me)))
    monitor = HealthMonitor(
        objective_goodput=0.9,
        windows=(
            BurnWindow(
                fast=max(8, band_rows),
                slow=4 * max(8, band_rows),
                threshold=2.0,
            ),
        ),
    )
    server = TelemetryServer(
        registry=registry, health=monitor, host_id=me, epoch=view.epoch,
    ).start()
    _write_telemetry_port(shared, me, server.port)

    store = TensorReliabilityStore(device=args.device)
    journal = JournalWriter(os.path.join(shared, f"band{me}.jrnl"))
    # Strict durability (a synchronous epoch every batch): a yielded batch
    # IS fsynced, the honest SLO endpoint (submit → durable) and what
    # makes the adoption-time byte coda exact.
    driver = SessionDriver(
        store, steps=args.steps, mesh=mesh, journal=journal,
        owns_journal=True, checkpoint_every=1, sync_checkpoints=True,
    )
    cache = PlanCache(store, num_slots=args.num_slots)
    progress = open(os.path.join(shared, f"progress_{me}.jsonl"), "w")

    def log(kind: str, **payload) -> None:
        payload.update(kind=kind, ts=time.time())
        progress.write(json.dumps(payload, sort_keys=True) + "\n")
        progress.flush()

    def fallbacks() -> int:
        counters = registry.export().get("counters", {})
        return int(counters.get("stream.resident_fallbacks", 0))

    last_verdict = [None]

    def log_health(force: bool = False) -> None:
        """A ``health`` progress line on every verdict change (or forced):
        the worker-side transition record the supervisor folds into the
        JSON's health timeline."""
        v = monitor.verdict()
        if force or v["verdict"] != last_verdict[0]:
            last_verdict[0] = v["verdict"]
            log(
                "health", verdict=v["verdict"], burning=v["burning"],
                degraded=v["degraded"], epoch=view.epoch,
            )

    own_next = 0
    orphans: list = []  # [host, next_index] bands adopted from the dead
    adoption_report = None
    result: dict = {"ok": False, "host": me}
    dispatch_index = 0
    now0 = 20_950.0
    drain_deadline = None
    #: (band, index) → the dead worker's offer wall time for batches it
    #: offered but never made durable: their re-drive latency counts from
    #: the ORIGINAL offer.
    victim_offers: dict = {}
    degraded_pending = False

    try:
        log_health(force=True)  # the timeline's starting "healthy"
        while True:
            # Membership poll — the coordinator-free agreement point: the
            # view file names the epoch and survivors; this worker derives
            # everything else from the view alone.
            member = _read_membership(shared)
            if member["epoch"] > view.epoch:
                survivors = member["hosts"]
                dead = [h for h in view.hosts if h not in survivors]
                view = view.degraded(survivors)
                if me not in view.hosts:
                    break  # this worker was declared dead
                server.set_epoch(view.epoch)
                for host in dead:
                    # Exactly ONE survivor owns each orphan band, a pure
                    # function of (dead host, degraded view): a band
                    # adopted twice would put its pairs in two journals,
                    # the split-brain replay_cluster_journals refuses.
                    owner = view.hosts[host % view.num_hosts]
                    if owner != me:
                        log("orphan_assigned", dead_host=host, owner=owner)
                        continue
                    dead_path = os.path.join(shared, f"band{host}.jrnl")
                    monitor.set_degraded(
                        f"adopting band {host} (hosts absent: {dead})"
                    )
                    degraded_pending = True
                    log_health()
                    for line in _read_lines(
                        os.path.join(shared, f"progress_{host}.jsonl")
                    ):
                        if line["kind"] != "offered":
                            continue
                        for band, index in line["parts"]:
                            key = (band, index)
                            victim_offers[key] = min(
                                victim_offers.get(key, line["ts"]),
                                line["ts"],
                            )
                    adopt_start = time.perf_counter()
                    tag, rows_adopted = adopt_journal(store, dead_path)
                    adopt_s = time.perf_counter() - adopt_start
                    resume_at = 0 if tag is None else tag + 1
                    orphans.append([host, resume_at])
                    # The byte coda at the adoption point: the live store
                    # (own band through the last durable epoch + the
                    # adopted band) equals the merged replay of the
                    # surviving journals.
                    coda_start = time.perf_counter()
                    merged = replay_cluster_journals(
                        [os.path.join(shared, f"band{me}.jrnl"), dead_path],
                        device=args.device,
                    )
                    live_digest = store_digest(store)
                    byte_equal_store = live_digest == store_digest(
                        merged.store
                    )
                    live_db = os.path.join(shared, f"coda_live_{me}.db")
                    replay_db = os.path.join(shared, f"coda_replay_{me}.db")
                    # Both exports at once (the background writers).
                    flushes = (store.flush_to_sqlite_async(live_db),
                               merged.store.flush_to_sqlite_async(replay_db))
                    for flush in flushes:
                        flush.result()
                    with open(live_db, "rb") as fa, open(replay_db, "rb") as fb:
                        byte_equal_sqlite = fa.read() == fb.read()
                    del merged
                    adoption_report = {
                        "dead_host": host,
                        "journal_tag": tag,
                        "resume_at": resume_at,
                        "rows_adopted": rows_adopted,
                        "adopt_s": adopt_s,
                        "coda_s": time.perf_counter() - coda_start,
                        "byte_equal_store": byte_equal_store,
                        "byte_equal_sqlite": byte_equal_sqlite,
                    }
                    log("adopt", epoch=view.epoch, **adoption_report)

            own_done = own_next >= args.batches
            live_orphans = [o for o in orphans if o[1] < args.batches]
            if own_done and not live_orphans:
                if orphans or args.hosts == 1:
                    break
                # Own batches done and no epoch bump yet: drain briefly in
                # case this worker is about to inherit a band.
                if drain_deadline is None:
                    drain_deadline = time.time() + args.drain_wait
                if time.time() >= drain_deadline:
                    break
                time.sleep(0.05)
                continue

            parts = []
            if not own_done:
                parts.append((me, own_next))
                own_next += 1
            for entry in live_orphans:
                parts.append((entry[0], entry[1]))
                entry[1] += 1

            columns = [
                _band_batch(args, index, view0_rows(args, host), key_cache)
                for host, index in parts
            ]
            keys = [k for c in columns for k in c[0]]
            codes = np.concatenate([c[1] for c in columns])
            probs = np.concatenate([c[2] for c in columns])
            offsets = np.cumsum(np.concatenate(
                [[0]] + [np.diff(c[3]) for c in columns])).astype(np.int64)
            outcomes = np.concatenate([c[4] for c in columns])

            offer_wall = time.time()
            log("offered", parts=parts, requests=len(keys))
            time.sleep(args.interval)
            plan = cache.plan_for(keys, SourceCodes(codes, source_table),
                                  probs, offsets)
            driver.dispatch(plan, outcomes, now=now0 + dispatch_index)
            driver.checkpoint(dispatch_index)
            log(
                "durable", parts=parts, adopt=driver.last_adopt,
                fallbacks=fallbacks(), batch=dispatch_index,
            )
            # The batch's per-request outcomes against the offer → durable
            # objective; re-driven crash-eaten parts measure from the dead
            # worker's offer.
            durable_wall = time.time()
            for i, (band, index) in enumerate(parts):
                offer_ts = victim_offers.get((band, index), offer_wall)
                outcome = (
                    "met" if durable_wall - offer_ts <= args.slo
                    else "violated"
                )
                for _ in range(len(columns[i][0])):
                    monitor.record(outcome)
            if degraded_pending and any(band != me for band, _ in parts):
                # The orphan band just flowed through a durable batch here:
                # the membership impairment is carried.
                monitor.clear_degraded()
                degraded_pending = False
            log_health()
            dispatch_index += 1

        log_health(force=True)  # the timeline's closing verdict
        result.update(
            ok=True,
            batches_settled=dispatch_index,
            fallbacks=fallbacks(),
            adoption=adoption_report,
            final_store_digest=None,
            final_rows=len(store),
            device=str(store.device),
        )
    finally:
        driver.finalize()
        try:
            result["final_store_digest"] = store_digest(store)
        except Exception as exc:  # reported; the supervisor fails on it
            result["digest_error"] = repr(exc)
        with open(os.path.join(shared, f"result_{me}.json"), "w") as f:
            json.dump(result, f, sort_keys=True)
        server.close()
        progress.close()
    return 0


# --------------------------------------------------------------------------
# supervisor
# --------------------------------------------------------------------------


def _read_lines(path: str) -> list:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn tail of a killed worker
    return out


class _HealthPoller:
    """Supervisor-side live poller: ``/healthz`` + ``/snapshot`` of every
    worker on a background thread through the whole soak — the proof the
    health surface answers WHILE the kill and recovery happen."""

    def __init__(self, shared: str, hosts) -> None:
        import threading

        self._shared = shared
        self._hosts = list(hosts)
        self._ports: dict = {}
        self._stop = threading.Event()
        self.polls: list = []          # {ts, host, verdict, ok}
        self.snapshots: dict = {}      # host → latest parsed /snapshot
        self._thread = threading.Thread(
            target=self._loop, name="soak-health-poller", daemon=True
        )

    def start(self) -> "_HealthPoller":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _port(self, host: int):
        port = self._ports.get(host)
        if port is not None:
            return port
        path = _telemetry_path(self._shared, host)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                port = int(json.load(f)["port"])
        except (ValueError, KeyError, OSError):
            return None
        self._ports[host] = port
        return port

    def _loop(self) -> None:
        from bayesian_consensus_engine_tpu_torch.obs.export import (
            scrape_endpoint,
        )

        while not self._stop.is_set():
            for host in self._hosts:
                port = self._port(host)
                if port is None:
                    continue
                base = f"http://127.0.0.1:{port}"
                try:
                    # A 503 /healthz is burning or degraded; the body is
                    # the answer either way.
                    _status, payload = scrape_endpoint(
                        base + "/healthz", timeout=0.5
                    )
                    self.polls.append(
                        {
                            "ts": time.time(), "host": host,
                            "verdict": payload.get("verdict"), "ok": True,
                        }
                    )
                    _status, snapshot = scrape_endpoint(
                        base + "/snapshot", timeout=0.5
                    )
                    self.snapshots[host] = snapshot
                except Exception:
                    # A dead worker, a port not bound yet, a slow scrape:
                    # the absence of an answer is itself data.
                    self.polls.append(
                        {
                            "ts": time.time(), "host": host,
                            "verdict": None, "ok": False,
                        }
                    )
            self._stop.wait(0.05)


def _worker_env() -> dict:
    """The workers' environment: this one, with the checkout that holds
    the package first on ``PYTHONPATH`` (``-m`` must find it from any
    working directory)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    return env


def run_supervisor(args) -> int:
    from bayesian_consensus_engine_tpu_torch.cluster.recover import (
        replay_cluster_journals,
        store_digest,
    )
    from bayesian_consensus_engine_tpu_torch.obs.fleet import (
        fleet_to_json,
        merge_fleet,
        snapshot_from_wire,
    )
    from bayesian_consensus_engine_tpu_torch.obs.ledger import RunLedger
    from bayesian_consensus_engine_tpu_torch.obs.slo import (
        SloTracker,
        goodput_from_counts,
    )
    from bayesian_consensus_engine_tpu_torch.utils.device import resolve_device

    wall_start = time.perf_counter()
    device = resolve_device(args.device)  # raises without CUDA for "cuda"
    if device.type == "cuda":
        # Built once here; every worker loads this build.
        from bayesian_consensus_engine_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    build_s = time.perf_counter() - wall_start
    shared = args.dir or tempfile.mkdtemp(prefix="bce_kill_soak_")
    os.makedirs(shared, exist_ok=True)
    view = _initial_view(args)
    _write_membership(shared, view)
    victim = args.hosts - 1
    survivor_hosts = [h for h in view.hosts if h != victim]

    base_cmd = [
        sys.executable, "-m", MODULE,
        "--dir", shared,
        "--hosts", str(args.hosts),
        "--markets", str(args.markets),
        "--batches", str(args.batches),
        "--sources", str(args.sources),
        "--steps", str(args.steps),
        "--num-slots", str(args.num_slots),
        "--interval", str(args.interval),
        "--slo", str(args.slo),
        "--devices-per-host", str(args.devices_per_host),
        "--drain-wait", str(args.drain_wait),
        "--device", args.device,
    ]
    procs = {}
    env = _worker_env()
    poller = None
    try:
        for host in view.hosts:
            procs[host] = subprocess.Popen(
                base_cmd + ["--worker", str(host)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env,
            )
        poller = _HealthPoller(shared, view.hosts).start()

        def durable_lines(host):
            return [
                line
                for line in _read_lines(
                    os.path.join(shared, f"progress_{host}.jsonl")
                )
                if line["kind"] == "durable"
            ]

        # Phase 1: the steady stream until the victim has made kill_after
        # batches durable — then the real kill, mid-stream, no warning.
        deadline = time.time() + args.phase_timeout
        while len(durable_lines(victim)) < args.kill_after:
            if time.time() > deadline:
                raise RuntimeError(
                    f"victim never reached {args.kill_after} durable "
                    f"batches within {args.phase_timeout}s"
                )
            for host, proc in procs.items():
                if proc.poll() is not None:
                    out = proc.stdout.read()
                    raise RuntimeError(
                        f"worker {host} exited (rc={proc.returncode}) before "
                        f"the kill:\n{out[-4000:]}"
                    )
            time.sleep(0.03)

        kill_ts = time.time()
        os.kill(procs[victim].pid, signal.SIGKILL)
        procs[victim].wait(timeout=30)

        # Phase 2: the failure detector publishes the degraded view; the
        # survivors do the rest (replay, adopt, resume) on their own.
        degraded = view.degraded(survivor_hosts)
        _write_membership(shared, degraded, kill_ts=kill_ts)

        deadline = time.time() + args.phase_timeout
        for host in survivor_hosts:
            remaining = max(5.0, deadline - time.time())
            try:
                out, _ = procs[host].communicate(timeout=remaining)
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"survivor {host} did not finish within {remaining:.0f}s"
                ) from None
            if procs[host].returncode != 0:
                raise RuntimeError(
                    f"survivor {host} failed rc={procs[host].returncode}:"
                    f"\n{out[-4000:]}"
                )
    finally:
        # Every exit stops every process this run started.
        if poller is not None:
            poller.stop()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
            if proc.stdout is not None:
                proc.stdout.close()

    # -- adjudication -------------------------------------------------------
    # The orphan band's owner (the one survivor that adopted it) is the
    # story's protagonist; other survivors keep streaming their own bands.
    survivor_results = {}
    for host in survivor_hosts:
        with open(os.path.join(shared, f"result_{host}.json")) as f:
            survivor_results[host] = json.load(f)
        assert survivor_results[host]["ok"], survivor_results[host]
    adopters = [
        h for h, res in survivor_results.items()
        if res["adoption"] is not None
    ]
    assert len(adopters) == 1, (
        f"exactly one survivor must adopt the dead band; got {adopters}"
    )
    survivor = adopters[0]
    survivor_result = survivor_results[survivor]
    adoption = survivor_result["adoption"]

    # Offered at the FIRST offer anywhere (the dead worker's offers count:
    # crash-eaten traffic stays in the denominator), durable at the first
    # journal-fsynced settle covering the part.
    offered: dict = {}
    durable: dict = {}
    requests_per_band = {
        band: len(view0_rows(args, band)) for band in view.hosts
    }
    for host in view.hosts:
        for line in _read_lines(
            os.path.join(shared, f"progress_{host}.jsonl")
        ):
            if line["kind"] not in ("offered", "durable"):
                continue
            for band, index in line["parts"]:
                key = (band, index)
                if line["kind"] == "offered":
                    offered[key] = min(
                        offered.get(key, line["ts"]), line["ts"]
                    )
                else:
                    durable[key] = min(
                        durable.get(key, line["ts"]), line["ts"]
                    )

    # The journal is the durable authority for the victim's last pre-kill
    # batch: a SIGKILL can land between the epoch's fsync and the worker's
    # own durable line. The batch IS durable (the survivor resumes after
    # it), so it counts durable no later than the kill.
    dead_tag = adoption["journal_tag"]
    if dead_tag is not None:
        for index in range(dead_tag + 1):
            durable.setdefault((victim, index), kill_ts)

    tracker = SloTracker(args.slo)
    for key, offer_ts in sorted(offered.items()):
        n = requests_per_band[key[0]]
        if key not in durable:
            for _ in range(n):
                tracker.record("failed")
            continue
        latency = durable[key] - offer_ts
        for _ in range(n):
            tracker.record_latency(latency)
    snapshot = tracker.snapshot()
    goodput = goodput_from_counts(snapshot["counts"])

    # Recovery latency: kill → the first durable batch covering a dead-band
    # part on the survivor.
    orphan_durable = [
        ts for (band, _idx), ts in durable.items()
        if band == victim and ts > kill_ts
    ]
    assert orphan_durable, "no dead-band batch ever re-settled"
    recovery_s = min(orphan_durable) - kill_ts

    # Residency: no fallback before the kill on any worker, none on the
    # survivors (the adoption rides the relayout, not a rebuild).
    pre_kill_fallbacks = max(
        (
            line["fallbacks"]
            for host in view.hosts
            for line in _read_lines(
                os.path.join(shared, f"progress_{host}.jsonl"))
            if line["kind"] == "durable" and line["ts"] <= kill_ts
        ),
        default=0,
    )
    survivor_fallbacks = max(
        res["fallbacks"] for res in survivor_results.values()
    )
    adopt_modes = sorted({
        line["adopt"]
        for line in _read_lines(
            os.path.join(shared, f"progress_{survivor}.jsonl"))
        if line["kind"] == "durable"
    })

    # Self-containment: the survivor's OWN journal now carries the adopted
    # band, and alone replays to its final store.
    survivor_journal = os.path.join(shared, f"band{survivor}.jrnl")
    final_replay = replay_cluster_journals([survivor_journal],
                                           device=args.device)
    journal_self_contained = (
        store_digest(final_replay.store)
        == survivor_result["final_store_digest"]
    )
    del final_replay

    # -- the live health surface --------------------------------------------
    # The transition timeline comes from the workers' own health lines; the
    # HTTP polls prove /healthz answered over the wire during the kill. The
    # adopting survivor must read healthy → burning/degraded → healthy.
    health_timeline = sorted(
        (
            {
                "ts": line["ts"], "host": host,
                "verdict": line["verdict"], "burning": line["burning"],
                "degraded": line["degraded"], "epoch": line["epoch"],
            }
            for host in view.hosts
            for line in _read_lines(
                os.path.join(shared, f"progress_{host}.jsonl")
            )
            if line["kind"] == "health"
        ),
        key=lambda e: (e["ts"], e["host"]),
    )
    survivor_verdicts = [
        e for e in health_timeline if e["host"] == survivor
    ]
    health_transitions_ok = bool(
        survivor_verdicts
        and survivor_verdicts[0]["verdict"] == "healthy"
        and any(
            e["verdict"] != "healthy" and e["ts"] >= kill_ts
            for e in survivor_verdicts
        )
        and survivor_verdicts[-1]["verdict"] == "healthy"
    )
    polls_ok = [p for p in poller.polls if p["ok"]]
    healthz_poll_ok = len(polls_ok) > 0
    poll_transitions: list = []
    last_polled: dict = {}
    for p in poller.polls:
        if not p["ok"]:
            continue
        if last_polled.get(p["host"]) != p["verdict"]:
            last_polled[p["host"]] = p["verdict"]
            poll_transitions.append(
                {"ts": p["ts"], "host": p["host"], "verdict": p["verdict"]}
            )

    # The fleet fold over the scraped survivor snapshots: the dead host is
    # an explicit hosts_absent entry, and the fold is order-independent.
    fleet_snaps = [
        snapshot_from_wire(poller.snapshots[host])
        for host in survivor_hosts
        if host in poller.snapshots
    ]
    fleet_summary = None
    fleet_ok = False
    if fleet_snaps:
        fleet_view = merge_fleet(fleet_snaps, expected_hosts=view.hosts)
        fleet_ok = bool(
            fleet_view["hosts_absent"] == [victim]
            and fleet_view["epoch"] == degraded.epoch
            and fleet_to_json(fleet_view) == fleet_to_json(
                merge_fleet(
                    list(reversed(fleet_snaps)),
                    expected_hosts=view.hosts,
                )
            )
        )
        fleet_summary = {
            "epoch": fleet_view["epoch"],
            "hosts": fleet_view["hosts"],
            "hosts_absent": fleet_view["hosts_absent"],
            "host_epochs": fleet_view["host_epochs"],
            "deterministic": fleet_ok,
        }

    wall_s = time.perf_counter() - wall_start
    every_batch_durable = all(
        (band, index) in durable
        for band in view.hosts
        for index in range(args.batches)
    )
    payload = {
        "ok": bool(
            adoption["byte_equal_store"]
            and adoption["byte_equal_sqlite"]
            and journal_self_contained
            and every_batch_durable
            and pre_kill_fallbacks == 0
            and survivor_fallbacks == 0
            and health_transitions_ok
            and healthz_poll_ok
            and fleet_ok
        ),
        "device": survivor_result["device"],
        "hosts": args.hosts,
        "markets": args.markets,
        "killed_host": victim,
        "kill_after_durable": args.kill_after,
        "batches_per_band": args.batches,
        "requests_offered": snapshot["offered"],
        "goodput_within_slo": goodput,
        "slo": snapshot,
        "recovery_s": recovery_s,
        "adopt_s": adoption["adopt_s"],
        "coda_s": adoption["coda_s"],
        "rows_adopted": adoption["rows_adopted"],
        "dead_journal_tag": adoption["journal_tag"],
        "resident_fallbacks_steady": pre_kill_fallbacks,
        "resident_fallbacks_survivor": survivor_fallbacks,
        "survivor_adopt_modes": adopt_modes,
        "byte_equal_store": adoption["byte_equal_store"],
        "byte_equal_sqlite": adoption["byte_equal_sqlite"],
        "survivor_journal_self_contained": journal_self_contained,
        "every_batch_durable": every_batch_durable,
        "health_timeline": health_timeline,
        "health_transitions_ok": health_transitions_ok,
        "healthz_polls": len(poller.polls),
        "healthz_poll_ok": healthz_poll_ok,
        "healthz_poll_transitions": poll_transitions,
        "fleet": fleet_summary,
        "build_s": build_s,
        "wall_s": wall_s,
        "dir": shared,
    }

    if args.ledger:
        ledger = RunLedger(args.ledger, backend=str(device))
        ledger.record(
            "soak.kill.recovery", value=round(recovery_s, 4), unit="s",
            extras={
                "slo": snapshot,
                "recovery_s": recovery_s,
                "goodput_within_slo": goodput,
                "resident_fallbacks": survivor_fallbacks,
            },
        )
        ledger.close()

    if not args.json:
        print(
            f"kill soak: {args.hosts} hosts on {device}, killed host {victim} "
            f"after {args.kill_after} durable batches"
        )
        print(
            f"  recovered goodput_within_slo = {goodput:.3f} over "
            f"{snapshot['offered']} offered requests "
            f"(counts {snapshot['counts']})"
        )
        print(
            f"  recovery_s = {recovery_s:.3f}  adopt_s = "
            f"{adoption['adopt_s']:.3f}  rows_adopted = "
            f"{adoption['rows_adopted']}"
        )
        print(
            f"  byte coda: store={adoption['byte_equal_store']} "
            f"sqlite={adoption['byte_equal_sqlite']} "
            f"self_contained={journal_self_contained} "
            f"fallbacks={survivor_fallbacks}"
        )
        transitions = " -> ".join(
            e["verdict"] for e in health_timeline if e["host"] == survivor
        )
        print(
            f"  health: {transitions or '(none)'} "
            f"(transitions_ok={health_transitions_ok}, "
            f"{len(poller.polls)} /healthz polls, fleet absent="
            f"{fleet_summary['hosts_absent'] if fleet_summary else '?'})"
        )
    print(json.dumps(payload, sort_keys=True), flush=True)
    return 0 if payload["ok"] else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + MODULE,
        description="Kill one worker of a banded cluster mid-stream and "
                    "check the recovery.")
    parser.add_argument("--worker", type=int, default=None,
                        help="internal: run as worker RANK")
    parser.add_argument("--dir", default=None,
                        help="shared soak directory (default: mkdtemp)")
    parser.add_argument("--hosts", type=int, default=2)
    parser.add_argument("--markets", type=int, default=64,
                        help="GLOBAL market count (bands split it)")
    parser.add_argument("--batches", type=int, default=12,
                        help="batches per band")
    parser.add_argument("--kill-after", type=int, default=3,
                        help="victim durable batches before the SIGKILL")
    parser.add_argument("--sources", type=int, default=40)
    parser.add_argument("--steps", type=int, default=1)
    parser.add_argument("--num-slots", type=int, default=8)
    parser.add_argument("--interval", type=float, default=0.15,
                        help="per-batch arrival pacing, seconds")
    parser.add_argument("--slo", type=float, default=0.5,
                        help="submit→durable objective, seconds")
    parser.add_argument("--devices-per-host", type=int, default=2)
    parser.add_argument("--drain-wait", type=float, default=8.0)
    parser.add_argument("--phase-timeout", type=float, default=120.0,
                        help="seconds each phase may take before every "
                             "worker is killed and the soak fails")
    parser.add_argument("--device", default="cuda",
                        help="where the workers settle: cuda (default) or cpu")
    parser.add_argument("--json", action="store_true",
                        help="suppress the prose; emit only the JSON line")
    parser.add_argument("--ledger",
                        help="append obs run-ledger records here")
    args = parser.parse_args(argv)
    if args.hosts < 2:
        parser.error("--hosts must be >= 2 (someone has to die)")
    if args.worker is not None:
        return run_worker(args)
    return run_supervisor(args)


if __name__ == "__main__":
    sys.exit(main())
