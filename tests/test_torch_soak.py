"""The port's kill soak on the CPU, at its default size.

``python -m bayesian_consensus_engine_tpu_torch.cluster.soak --device
cpu`` (with a 5 s objective) runs two worker processes, kills one after
three durable batches, and must exit 0 with one adopter, no ``rebuild`` and no resident
fallback, every batch durable, and a byte coda that holds (the live store
at adoption equals the merged replay of the surviving journals, by digest
and SQLite bytes, and the survivor's own journal replays to its final
store). The journals the port's workers wrote then go through the JAX
package's recovery: its merged store has the port's digest. The soak runs
once for the module, under a 120 s limit that kills it and its workers.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from bayesian_consensus_engine_tpu import cluster as jcluster
from bayesian_consensus_engine_tpu_torch import cluster

_ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    shared = tmp_path_factory.mktemp("soak")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", "bayesian_consensus_engine_tpu_torch.cluster.soak",
         "--device", "cpu", "--json", "--dir", str(shared),
         "--phase-timeout", "90",
         # The verdicts under test are the recovery's, not this machine's
         # load: a batch here takes milliseconds beside its 0.15 s pacing,
         # but a loaded test run can stall an fsync past the 0.5 s
         # default objective.
         "--slo", "5.0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(shared), start_new_session=True,
    )
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)  # the supervisor and its workers
        proc.communicate()
        raise
    lines = [line for line in out.splitlines() if line.startswith("{")]
    return proc.returncode, json.loads(lines[-1]) if lines else None, out, shared


def test_soak_exits_zero_with_one_adopter_and_no_rebuild(soak):
    rc, payload, out, _shared = soak
    assert rc == 0, out[-4000:]
    assert payload["ok"] is True and payload["device"] == "cpu"
    assert payload["killed_host"] == 1 and payload["hosts"] == 2
    assert payload["every_batch_durable"]
    assert payload["resident_fallbacks_steady"] == 0
    assert payload["resident_fallbacks_survivor"] == 0
    assert not any(m.startswith("rebuild")
                   for m in payload["survivor_adopt_modes"])
    assert "relayout" in payload["survivor_adopt_modes"]
    assert payload["rows_adopted"] > 0
    assert 0.0 <= payload["goodput_within_slo"] <= 1.0
    assert payload["fleet"]["hosts_absent"] == [1]
    assert payload["health_transitions_ok"] and payload["healthz_poll_ok"]


def test_soak_byte_coda_holds(soak):
    _rc, payload, out, _shared = soak
    assert payload is not None, out[-4000:]
    assert payload["byte_equal_store"] and payload["byte_equal_sqlite"]
    assert payload["survivor_journal_self_contained"]


def test_survivor_journal_recovers_alike_in_both_packages(soak):
    _rc, payload, out, shared = soak
    assert payload is not None, out[-4000:]
    result = json.loads((shared / "result_0.json").read_text())
    journal = shared / "band0.jrnl"
    ours = cluster.replay_cluster_journals([journal], device="cpu")
    theirs = jcluster.replay_cluster_journals([journal])
    assert cluster.store_digest(ours.store) == result["final_store_digest"]
    assert jcluster.store_digest(theirs.store) == result["final_store_digest"]
    assert ours.tags == theirs.tags and ours.rows == theirs.rows
