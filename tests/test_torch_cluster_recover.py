"""The port's cluster recovery ≡ the JAX package's, on the CPU.

Band journals are written by both packages' ``settle_stream`` on the same
seeded batches (the clock pinned, both on their Python host routes, so
the journal files are byte-equal), then recovered through both packages'
``replay_cluster_journals`` and ``adopt_journal``:

* the merged and adopted stores give equal ``store_digest``\\ s and
  byte-equal SQLite exports in both packages, on either package's
  journal files;
* a one-journal merge is bit-equal to ``replay_journal``;
* overlapping journals (two hosts claiming one band) raise split-brain;
* adopted rows ride the survivor's next epoch: its own journal alone
  replays to the live store;
* an adoption under a tracer records the ``recovery`` span chain.
"""

import random
import shutil

import numpy as np
import pytest

from bayesian_consensus_engine_tpu import cluster as jcluster
from bayesian_consensus_engine_tpu import pipeline as jpipe
from bayesian_consensus_engine_tpu.state import journal as jjournal
from bayesian_consensus_engine_tpu_torch import cluster
from bayesian_consensus_engine_tpu_torch import obs
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.cluster import recover
from bayesian_consensus_engine_tpu_torch.state import journal as tjournal
from test_torch_stream import run_stream

NOW = 21_400.0


def band_batches(tag, seed, markets=10, batches=3):
    rng = random.Random(seed)
    out = []
    for _ in range(batches):
        pays = []
        for m in range(markets):
            pays.append((f"m{tag}-{m}", [
                {"sourceId": f"s{rng.randrange(8)}",
                 "probability": round(rng.random(), 6)}
                for _ in range(rng.randint(1, 3))]))
        out.append((pays, [rng.random() < 0.5 for _ in pays]))
    return out


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """{kind: {band: (live store, journal path)}} for bands a and b."""
    tmp = tmp_path_factory.mktemp("band_journals")
    out = {}
    for kind in ("jax", "torch"):
        out[kind] = {}
        for band, seed in (("a", 5), ("b", 6)):
            run = run_stream(kind, band_batches(band, seed), tmp,
                             f"{kind}-{band}", db=False, journal=True,
                             python_route=True, steps=1, now=NOW,
                             sync_checkpoints=True)
            out[kind][band] = (run.store, run.journal)
    return out


def flush_bytes(store, path, monkeypatch):
    monkeypatch.setenv("BCE_NO_NATIVE", "1")
    store.flush_to_sqlite(path)
    return path.read_bytes()


def test_both_packages_write_the_same_journal_bytes(journals):
    for band in ("a", "b"):
        assert journals["torch"][band][1].read_bytes() == (
            journals["jax"][band][1].read_bytes())


@pytest.mark.parametrize("source", ["jax", "torch"])
def test_merge_equals_jax_digest_and_sqlite(tmp_path, monkeypatch, journals,
                                            source):
    paths = [journals[source]["a"][1], journals[source]["b"][1]]
    ours = cluster.replay_cluster_journals(paths, device="cpu")
    theirs = jcluster.replay_cluster_journals(paths)
    assert (ours.tags, ours.rows, ours.paths) == (
        theirs.tags, theirs.rows, theirs.paths)
    assert ours.tags == (2, 2)
    assert ours.rows == tuple(len(journals["torch"][b][0]) for b in "ab")
    assert [ours.resume_index(i) for i in range(2)] == [3, 3]
    assert cluster.store_digest(ours.store) == jcluster.store_digest(
        theirs.store)
    assert flush_bytes(ours.store, tmp_path / "ours.db", monkeypatch) == (
        flush_bytes(theirs.store, tmp_path / "theirs.db", monkeypatch))
    # Order is part of the contract: callers must agree on it.
    flipped = cluster.replay_cluster_journals(paths[::-1], device="cpu")
    assert cluster.store_digest(flipped.store) != cluster.store_digest(
        ours.store)


def test_one_journal_merge_is_bit_equal_to_replay(journals):
    path = journals["torch"]["a"][1]
    merged = cluster.replay_cluster_journals([path], device="cpu")
    ref, tag = tjournal.replay_journal(path, device="cpu")
    assert merged.tags == (tag,) and merged.resume_index(0) == tag + 1
    assert cluster.store_digest(merged.store) == cluster.store_digest(ref)
    used = len(ref)
    for column in ("_rel", "_conf", "_days", "_exists"):
        np.testing.assert_array_equal(getattr(merged.store, column)[:used],
                                      getattr(ref, column)[:used])
    assert merged.store._pairs.ids() == ref._pairs.ids()
    assert merged.store.device.type == "cpu"


def test_replay_needs_cuda_unless_the_cpu_is_asked(journals, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster.replay_cluster_journals([journals["torch"]["a"][1]])


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_overlapping_journals_are_split_brain(journals, package):
    path = journals["torch"]["a"][1]
    with pytest.raises(ValueError, match="split-brain"):
        if package == "jax":
            jcluster.replay_cluster_journals([path, path])
        else:
            cluster.replay_cluster_journals([path, path], device="cpu")


def test_bad_magic_and_empty_lists_raise(tmp_path):
    bogus = tmp_path / "bogus.jrnl"
    bogus.write_bytes(b"NOTAJRNL" + b"\0" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        cluster.replay_cluster_journals([bogus], device="cpu")
    with pytest.raises(ValueError, match="no journals"):
        cluster.replay_cluster_journals([], device="cpu")


def test_adopt_journal_equals_offline_merge_and_jax(tmp_path, monkeypatch,
                                                    journals):
    j_a, j_b = journals["torch"]["a"][1], journals["torch"]["b"][1]
    live, _ = tjournal.replay_journal(j_a, device="cpu")
    jax_live, _ = jjournal.replay_journal(j_a)
    got = cluster.adopt_journal(live, j_b)
    assert got == jcluster.adopt_journal(jax_live, j_b)
    assert got == (2, len(journals["torch"]["b"][0]))
    merged = cluster.replay_cluster_journals([j_a, j_b], device="cpu")
    digest = cluster.store_digest(live)
    assert digest == cluster.store_digest(merged.store)
    assert digest == jcluster.store_digest(jax_live)
    live_db = flush_bytes(live, tmp_path / "live.db", monkeypatch)
    assert live_db == flush_bytes(merged.store, tmp_path / "merged.db",
                                  monkeypatch)
    assert live_db == flush_bytes(jax_live, tmp_path / "jax.db", monkeypatch)


def test_adopted_rows_ride_the_next_epoch(tmp_path, monkeypatch, journals):
    """After adoption the survivor's own journal is self-contained: one
    more settle and epoch, and it alone replays to the live store, in both
    packages, to the same digest."""
    digests = []
    for kind, pipe, journal_module, cluster_module in (
            ("jax", jpipe, jjournal, jcluster),
            ("torch", tpipe, tjournal, cluster)):
        j_a = tmp_path / f"{kind}-a.jrnl"
        shutil.copy(journals[kind]["a"][1], j_a)
        with monkeypatch.context() as mp:
            mp.setenv("BCE_NO_NATIVE", "1")
            mp.setattr("time.time", lambda: 9_876.5)
            if kind == "jax":
                live, _ = journal_module.replay_journal(j_a)
            else:
                live, _ = journal_module.replay_journal(j_a, device="cpu")
            cluster_module.adopt_journal(live, journals[kind]["b"][1])
            writer = journal_module.JournalWriter(j_a, resume=True)
            rng = random.Random(9)
            pays = [(f"ma-{m}", [{"sourceId": f"s{rng.randrange(8)}",
                                  "probability": round(rng.random(), 6)}])
                    for m in range(6)]
            list(pipe.settle_stream(
                live, [(pays, [True] * len(pays))], steps=1, now=NOW + 9,
                journal=writer, sync_checkpoints=True,
            ))
            live.sync()
        if kind == "jax":
            solo = cluster_module.replay_cluster_journals([j_a])
        else:
            solo = cluster_module.replay_cluster_journals([j_a], device="cpu")
        digest = cluster_module.store_digest(solo.store)
        assert digest == cluster_module.store_digest(live)
        digests.append(digest)
    assert digests[0] == digests[1]


def test_adoption_records_the_recovery_span_chain(journals):
    tracer = obs.Tracer()
    previous = obs.set_tracer(tracer)
    try:
        live, _ = tjournal.replay_journal(journals["torch"]["a"][1],
                                          device="cpu")
        tag, rows = cluster.adopt_journal(live, journals["torch"]["b"][1])
    finally:
        obs.set_tracer(previous)
    events = [e for e in tracer.events() if e["scope"] == recover.RECOVERY_SCOPE]
    assert [e["name"] for e in events] == ["adopt_start", "adopt_done"]
    assert events[0]["args"]["journal"] == str(journals["torch"]["b"][1])
    assert events[1]["args"]["rows_adopted"] == rows > 0
    assert events[1]["args"]["tag"] == tag == 2


def test_exports_follow_the_jax_package():
    assert set(jcluster.__all__) <= set(cluster.__all__)
    assert issubclass(cluster.ClusterModeUnsupported, RuntimeError)
