"""The port's command line ≡ the JAX package's, on the CPU.

Both packages' ``main()`` run in this process on the same arguments
(``sys.argv`` patched, stdout and stderr captured, ``SystemExit``
caught); stdout, stderr and the exit code must be byte-equal:

* ``consensus`` on ``tests/fixtures/golden_regression.json`` (the
  fixture's expected output, byte for byte) and on the three ``sim_*``
  fixtures, legacy mode from stdin, ``--dry-run``, and the validation
  errors;
* ``report-outcome`` and ``list-sources`` over a DB each package wrote
  (with and without ``--dry-run``, with ``--market-id``), and their
  errors;
* ``journal-export`` of a journal written by each package through the
  other's CLI (the cross case), the port with ``--device cpu``, and the
  export's errors;
* ``stats`` of a run ledger (alone, ``--leg``, ``--json`` and
  ``--against``), its errors, and ``trace`` of a span log (the Chrome
  file byte-equal too);
* ``serve``'s argument errors, and the unported ``lint`` and ``bank``,
  which exit 1 naming their ROADMAP item (``replay`` is held against the
  reference CLI in ``tests/test_torch_replay.py``).

``--backend torch --device cpu`` (and ``jax``, the same path) agrees
with the JAX package's ``--backend jax`` at float32 within rtol=1e-6 in
every number of the document, and every other field is equal. Without
CUDA the commands that need a device fail unless ``--device cpu`` is
given. One subprocess runs ``serve --device cpu --port 0 --duration 2``
and holds its banner and summary.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from bayesian_consensus_engine_tpu import cli as jcli
from bayesian_consensus_engine_tpu import obs as jobs
from bayesian_consensus_engine_tpu.state.journal import (
    JournalWriter as JaxJournalWriter,
)
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import cli as tcli
from bayesian_consensus_engine_tpu_torch import obs as tobs
from bayesian_consensus_engine_tpu_torch.net import ConsensusClient
from bayesian_consensus_engine_tpu_torch.obs.ledger import RunLedger
from bayesian_consensus_engine_tpu_torch.obs.trace import TraceContext, Tracer
from bayesian_consensus_engine_tpu_torch.state.journal import JournalWriter
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
FLOAT32_TOL = 1e-6


def run_main(module, argv, stdin=None):
    """One in-process CLI run: (exit code, stdout, stderr). ``serve``
    installs a live metrics registry in its process; the registries in
    place before the run are put back."""
    out, err = io.StringIO(), io.StringIO()
    code = 0
    registries = [(obs, obs.metrics_registry()) for obs in (tobs, jobs)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["bce", *argv])
        mp.setattr(sys, "stdin", io.StringIO(stdin if stdin is not None
                                             else ""))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                module.main()
            except SystemExit as exc:
                code = exc.code if isinstance(exc.code, int) else 1
            finally:
                for obs, registry in registries:
                    obs.set_metrics_registry(registry)
    return code, out.getvalue(), err.getvalue()


def both(argv, stdin=None, port_extra=()):
    """The same arguments through both CLIs (the port's with
    *port_extra* global flags in front); asserts byte-equal results."""
    mine = run_main(tcli, [*port_extra, *argv], stdin)
    theirs = run_main(jcli, argv, stdin)
    assert mine == theirs, (argv, mine, theirs)
    return mine


def payload(signals):
    return json.dumps({"schemaVersion": "1.0.0", "marketId": "market-1",
                       "signals": signals})


@pytest.mark.parametrize("fixture", ["golden_regression", "sim_polarized_split",
                                     "sim_single_outlier",
                                     "sim_uniform_agreement"])
def test_consensus_documents_byte_equal(fixture, tmp_path):
    document = json.loads((FIXTURES / f"{fixture}.json").read_text())
    path = tmp_path / "in.json"
    path.write_text(json.dumps(document["input"]))
    code, out, err = both(["consensus", "--input", str(path)])
    assert code == 0 and err == ""
    if fixture == "golden_regression":
        assert out == json.dumps(document["expectedOutput"], indent=2) + "\n"
    assert both(["--input", str(path)]) == (0, out, "")
    assert both(["--dry-run", "consensus"], stdin=json.dumps(
        document["input"]))[0] == 0


@pytest.mark.parametrize("stdin, argv", [
    (payload([{"sourceId": "a", "probability": 0.5}]), []),
    (payload([{"sourceId": "a", "probability": 0.5}]), ["--dry-run"]),
    (payload([]), ["consensus"]),
    ("{not json", []),
    ("{not json", ["consensus"]),
    (json.dumps({"marketId": "m", "signals": []}), []),
    (payload([{"sourceId": "a", "probability": 1.5}]), ["consensus"]),
    (payload([{"probability": 0.5}]), []),
], ids=["legacy", "legacy_dry_run", "no_signals", "bad_json",
        "bad_json_sub", "no_schema", "out_of_range", "no_source"])
def test_legacy_mode_and_validation_errors_byte_equal(stdin, argv):
    code, out, err = both(argv, stdin)
    assert (code == 0) == (err == "")


def test_missing_input_file_raises_the_same_error():
    """An unreadable ``--input`` escapes both handlers as the same
    error."""
    errors = []
    for module in (tcli, jcli):
        with pytest.raises(FileNotFoundError) as info:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(sys, "argv", ["bce", "--input", "/nonexistent/x"])
                module.main()
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_db_commands_byte_equal(tmp_path, monkeypatch):
    # The stores stamp ``updatedAt`` and decay reads by the wall clock:
    # pin both.
    from bayesian_consensus_engine_tpu.state import sqlite_store as jsqlite
    from bayesian_consensus_engine_tpu_torch.state import sqlite_store

    for module in (sqlite_store, jsqlite):
        monkeypatch.setattr(module, "utc_now_iso",
                            lambda: "2026-01-02T03:04:05+00:00")
        monkeypatch.setattr(module, "days_since_update", lambda stamp: 3.25)
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    steps = [
        ["report-outcome", "--source-id", "a", "--market-id", "m1",
         "--correct"],
        ["report-outcome", "--source-id", "b", "--market-id", "m1"],
        ["--dry-run", "report-outcome", "--source-id", "c", "--market-id",
         "m2", "--correct"],
        ["report-outcome", "--source-id", "a", "--market-id", "m2",
         "--correct"],
        ["list-sources"],
        ["list-sources", "--market-id", "m1"],
        ["consensus"],
    ]
    stdin = payload([{"sourceId": "a", "probability": 0.8},
                     {"sourceId": "b", "probability": 0.3}])
    for argv in steps:
        results = []
        for module, name in ((tcli, "port"), (jcli, "jax")):
            # The same DB path text on both sides: each package writes its
            # own file, one after the other, in its own directory.
            cwd = os.getcwd()
            os.chdir(tmp_path / name)
            try:
                results.append(run_main(module, ["--db", "state.db", *argv],
                                        stdin))
            finally:
                os.chdir(cwd)
        assert results[0] == results[1], argv
        assert results[0][0] == 0
    for argv in (["report-outcome", "--source-id", "a", "--market-id", "m"],
                 ["list-sources"], ["journal-export", "x.jrnl"],
                 ["stats"], ["stats", "--against", "old.jsonl"],
                 ["serve", "--qos", "bad"],
                 ["serve", "--qos", "a:1:2:reject:hot"],
                 ["serve", "--qos", "bad name:1:2"]):
        code, _out, err = both(argv)
        assert code == 1 and err.startswith("Error: ")


def journal_of(kind, path):
    """A two-epoch journal of one package's store."""
    pairs = [("a", "m1"), ("b", "m1"), ("a", "m2"), ("c", "m3")]
    if kind == "torch":
        store, writer = TensorReliabilityStore(device="cpu"), JournalWriter
    else:
        store, writer = JaxStore(), JaxJournalWriter
    with writer(path) as journal:
        store.batch_update_reliability(pairs, [True, False, True, True])
        store.flush_to_journal(journal, tag=0)
        store.batch_update_reliability(pairs[1:], [True, True, False])
        store.flush_to_journal(journal, tag=1)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_journal_export_cross_byte_equal(writer, tmp_path):
    journal = tmp_path / "run.jrnl"
    journal_of(writer, journal)
    db = tmp_path / "export.db"
    results, listings = [], []
    for module, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        if db.exists():
            db.unlink()
        results.append(run_main(module, [*extra, "--db", str(db),
                                         "journal-export", str(journal)]))
        listings.append(run_main(module, ["--db", str(db), "list-sources"]))
        results.append(run_main(module, [*extra, "--dry-run",
                                         "journal-export", str(journal)]))
        results.append(run_main(module, [*extra, "--db", str(db),
                                         "journal-export", str(journal)]))
    assert results[:3] == results[3:]
    assert listings[0] == listings[1]
    assert results[0][0] == 0 and json.loads(results[0][1])["epochTag"] == 1
    assert results[2][0] == 1 and "already exists" in results[2][2]
    bad = tmp_path / "bad.jrnl"
    bad.write_bytes(b"not a journal")
    assert both(["--db", str(tmp_path / "b.db"), "journal-export", str(bad)],
                port_extra=["--device", "cpu"])[0] == 1


def test_stats_and_trace_byte_equal(tmp_path):
    ledger, old = tmp_path / "new.jsonl", tmp_path / "old.jsonl"
    for path, scale in ((old, 1.0), (ledger, 1.5)):
        with RunLedger(path, run_id="r", backend="cuda") as run:
            for repeat in range(3):
                run.record("settle", 0.1 * scale + 0.01 * repeat, "s",
                           repeat=repeat, phases={"settle_dispatch": 0.01})
                run.record("serve", 2000.0 / scale + repeat, "req/s",
                           repeat=repeat, extras={
                               "ingest_wait_s": 0.02 * scale,
                               "slo": {"counts": {"met": 9, "violated": 1,
                                                  "shed": 0, "rejected": 0,
                                                  "failed": 0},
                                       "objective_s": 0.05}})
    for argv in ([str(ledger)], [str(ledger), "--json"],
                 [str(ledger), "--leg", "serve"],
                 [str(ledger), "--against", str(old)],
                 [str(ledger), "--against", str(old), "--json"],
                 [str(tmp_path / "missing.jsonl")]):
        code, out, _err = both(["stats", *argv])
        assert code == (1 if "missing" in argv[0] else 0)
    tracer = Tracer()
    for seq in range(3):
        ctx = TraceContext(seq, f"m-{seq}")
        tracer.request_event(ctx, "enqueue", dur_s=0.001)
        tracer.request_event(ctx, "settled", dur_s=0.002, args={"batch": 0})
    spans = tmp_path / "spans.jsonl"
    tracer.write_jsonl(spans)
    chrome = tmp_path / "out.json"
    code, out, _err = run_main(tcli, ["trace", str(spans), "--out",
                                      str(chrome)])
    mine = chrome.read_bytes()
    assert both(["trace", str(spans), "--out", str(chrome)]) == (code, out, "")
    assert chrome.read_bytes() == mine and code == 0
    assert both(["trace", str(tmp_path / "none.jsonl")])[0] == 1


@pytest.mark.parametrize("backend", ["torch", "jax"])
def test_array_backend_within_float32_tolerance(backend, tmp_path):
    document = json.loads((FIXTURES / "golden_regression.json").read_text())
    path = tmp_path / "in.json"
    path.write_text(json.dumps(document["input"]))
    code, out, err = run_main(tcli, ["--backend", backend, "--device", "cpu",
                                     "consensus", "--input", str(path)])
    jcode, jout, jerr = run_main(jcli, ["--backend", "jax", "consensus",
                                        "--input", str(path)])
    assert (code, err) == (jcode, jerr) == (0, "")

    def numbers(value, path=()):
        if isinstance(value, dict):
            for key in sorted(value):
                yield from numbers(value[key], path + (key,))
        elif isinstance(value, list):
            for index, item in enumerate(value):
                yield from numbers(item, path + (index,))
        else:
            yield path, value

    mine, theirs = dict(numbers(json.loads(out))), dict(numbers(
        json.loads(jout)))
    assert mine.keys() == theirs.keys()
    for key, value in mine.items():
        if isinstance(value, float) and not isinstance(value, bool):
            np.testing.assert_allclose(value, theirs[key], rtol=FLOAT32_TOL,
                                       err_msg=str(key))
        else:
            assert value == theirs[key], key


def test_unported_commands_name_their_roadmap_item():
    # ``replay`` is ported (tests/test_torch_replay.py); lint and bank wait.
    for argv, item in ((["lint"], 10), (["bank", "show", "b.json"], 10)):
        code, out, err = run_main(tcli, argv)
        assert (code, out) == (1, "")
        assert err == (f"Error: {argv[0]} is not ported yet (ROADMAP queue 1 "
                       f"item {item})\n")


def test_no_device_no_fallback(monkeypatch, tmp_path):
    """Without CUDA every command that needs a device fails with the
    store's message unless ``--device cpu`` is given."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    stdin = payload([{"sourceId": "a", "probability": 0.6}])
    journal = tmp_path / "j.jrnl"
    journal_of("torch", journal)
    for argv in (["--backend", "torch", "consensus"], ["--backend", "jax"],
                 ["--db", str(tmp_path / "x.db"), "journal-export",
                  str(journal)],
                 ["serve", "--duration", "0.1"]):
        code, out, err = run_main(tcli, argv, stdin)
        assert (code, out) == (1, ""), argv
        assert "no CUDA device" in err and err.startswith("Error: ")
    code, out, _err = run_main(tcli, ["--device", "cpu", "--backend", "torch",
                                      "consensus"], stdin)
    assert code == 0 and json.loads(out)["consensus"] == pytest.approx(0.6)
    # The scalar backend needs no device.
    assert run_main(tcli, ["consensus"], stdin)[0] == 0


def test_serve_subprocess_banner_and_summary(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "bayesian_consensus_engine_tpu_torch.cli",
         "--device", "cpu", "serve", "--port", "0", "--duration", "2",
         "--journal", str(tmp_path / "s.jrnl"),
         "--qos", "premium:5.0:256", "--qos", "besteffort:5.0:64:shed_oldest",
         "--max-delay-ms", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
    )
    try:
        start = time.perf_counter()
        banner = json.loads(proc.stdout.readline())
        assert time.perf_counter() - start < 60
        assert banner["classes"] == ["premium", "besteffort"]
        assert banner["address"] == f"127.0.0.1:{banner['port']}"
        with ConsensusClient(port=banner["port"]) as client:
            results = client.submit_pipelined([
                ("m-1", [("s-1", 0.7)], True, "premium"),
                ("m-2", [("s-1", 0.4), ("s-2", 0.6)], False, "besteffort"),
            ], return_exceptions=False)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, stderr
    assert [r.market_id for r in results] == ["m-1", "m-2"]
    assert results[0].consensus == pytest.approx(0.7, rel=1e-6)
    summary = json.loads(stdout)
    assert summary["served"] == {"connections": 1, "requests": 2,
                                 "responses": 2, "wireErrors": 0,
                                 "batches": summary["served"]["batches"]}
    assert summary["served"]["batches"] >= 1
    assert list(summary["qos"]) == ["premium", "besteffort"]
    assert summary["qos"]["premium"]["offered"] == 1
    assert (tmp_path / "s.jrnl").stat().st_size > 8
