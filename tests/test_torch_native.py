"""The port's C extensions (``native/fastpack.c``, ``native/internmap.c``)
≡ their Python twins ≡ the JAX package's Python twins.

The build: first use compiles both into ``.torch_kernels/`` under a
content-keyed name; the Python twins run only for ``BCE_NO_NATIVE``, a
missing compiler or a missing ``Python.h``, and a failing build raises.
Then the packer and the interner, each on its C route and its Python
route, against the JAX package forced onto its Python twins
(``BCE_NO_NATIVE=1``: its own tests pin its C route to them), and the
C SQLite writer against the sqlite3-module route and the JAX package's,
full and incremental. Everything compared is host arithmetic on the same
inputs: equal bit for bit. The SQLite dumps are compared with the CREATE
TABLE statement's whitespace normalised: the C writer's schema text is one
line, the sqlite3 route's several (the same columns, types and keys).
"""

import contextlib
import random
import sqlite3
import threading

import numpy as np
import pytest

from bayesian_consensus_engine_tpu.core import batch as jbatch
from bayesian_consensus_engine_tpu.state.records import (
    ReliabilityRecord as JaxRecord,
)
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu.utils import interning as jinterning
from bayesian_consensus_engine_tpu_torch.core import batch as tbatch
from bayesian_consensus_engine_tpu_torch.native import build
from bayesian_consensus_engine_tpu_torch.state.records import ReliabilityRecord
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore as TorchStore,
)
from bayesian_consensus_engine_tpu_torch.utils import interning


@pytest.fixture(autouse=True)
def native_route(monkeypatch):
    """Each test starts on the C route whatever the environment says; the
    tests that want the Python twins set ``BCE_NO_NATIVE`` themselves."""
    monkeypatch.delenv("BCE_NO_NATIVE", raising=False)


def dump(path):
    """``iterdump()`` of a checkpoint, the CREATE statements' whitespace
    normalised."""
    with contextlib.closing(sqlite3.connect(path)) as conn:
        return [" ".join(line.split()) if line.startswith("CREATE") else line
                for line in conn.iterdump()]


# ---------------------------------------------------------------------------
# The build.
# ---------------------------------------------------------------------------


def test_build_loads_the_ports_own_copies():
    fastpack = build.load("fastpack")
    internmap = build.load("internmap")
    assert fastpack.__name__ == "bayesian_consensus_engine_tpu_torch._native.fastpack"
    assert internmap.__name__ == (
        "bayesian_consensus_engine_tpu_torch._native.internmap")
    for name, module in (("fastpack", fastpack), ("internmap", internmap)):
        assert module.__file__ == str(build.library_path(name))
        assert build.library_path(name).parent == build.BUILD_DIR
    report = build.report()
    assert report["built"] and report["python_h"] and report["compiler"]
    assert report["fallback_reason"] is None
    assert isinstance(interning.make_pair_interner(),
                      interning.NativePairInterner)


@pytest.mark.parametrize("cause", ["env", "compiler", "header"])
def test_fallback_only_for_the_three_reasons(monkeypatch, cause):
    if cause == "env":
        monkeypatch.setenv("BCE_NO_NATIVE", "1")
        want = "BCE_NO_NATIVE"
    elif cause == "compiler":
        monkeypatch.setattr(build, "compiler", lambda: None)
        monkeypatch.setattr(build, "_loaded", {})
        want = "no C compiler"
    else:
        monkeypatch.setattr(build, "python_header", lambda: None)
        monkeypatch.setattr(build, "_loaded", {})
        want = "Python.h"
    assert build.load("internmap") is None
    assert want in build.fallback_reason()
    assert want in build.report()["fallback_reason"]
    assert isinstance(interning.make_pair_interner(), interning.IdInterner)
    assert not tbatch._columnar_native_available()
    if cause == "env":
        # An explicit native=True wins over the knob.
        assert build.load("fastpack", force=True) is not None
    else:
        with pytest.raises(RuntimeError, match=want):
            tbatch.group_columns(np.zeros(1, np.int32), np.zeros(1, np.int64),
                                 np.array([0, 1]), np.ones(1), native=True)


def test_failing_build_raises_with_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.c"
    broken.write_text("#include <Python.h>\nint broken(void) { return }\n")
    monkeypatch.setattr(build, "SOURCES", {"broken": broken})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="cc failed on broken.c") as info:
        build.load("broken")
    assert "error" in str(info.value)
    assert list((tmp_path / "out").iterdir()) == []  # no half-written file


def test_concurrent_builds_and_content_keyed_names(tmp_path, monkeypatch):
    source = tmp_path / "fastpack.c"
    source.write_bytes(build.SOURCES["fastpack"].read_bytes())
    monkeypatch.setattr(build, "SOURCES", {"fastpack": source})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build.library_path("fastpack")
    errors = []

    def run():
        try:
            build.build("fastpack")
        except Exception as exc:  # noqa: BLE001 — collected for the assert
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [first.name]
    source.write_bytes(source.read_bytes() + b"\n/* edited */\n")
    assert build.library_path("fastpack") != first


# ---------------------------------------------------------------------------
# The packer: C route, Python route, the JAX package's twins.
# ---------------------------------------------------------------------------


def edge_payloads(name):
    if name == "dup_signals":
        return [
            ("m0", [{"sourceId": "a", "probability": 0.1},
                    {"sourceId": "b", "probability": 0.9},
                    {"sourceId": "a", "probability": 0.3},
                    {"sourceId": "a", "probability": 0.70000001}]),
            ("m1", [{"sourceId": "b", "probability": 0.5}]),
        ]
    if name == "empty_market":
        return [
            ("m0", [{"sourceId": "x", "probability": 0.25}]),
            ("empty", []),
            ("m2", [{"sourceId": "y", "probability": 0.75},
                    {"sourceId": "x", "probability": 0.5}]),
        ]
    if name == "extreme_probs":
        return [("m0", [{"sourceId": "s0", "probability": 0.0},
                        {"sourceId": "s1", "probability": 1.0},
                        {"sourceId": "s0", "probability": 1.0},
                        {"sourceId": "s2", "probability": 0.0}])]
    if name == "unicode":
        return [(f"mé-{m}", [{"sourceId": sid, "probability": 0.1 * (i + 1)}
                             for i, sid in enumerate(["ζeta", "a", "ab", "é",
                                                      "a", "abc"][m:])])
                for m in range(4)]
    if name == "empty":
        return []
    assert name == "random"
    rng = random.Random(11)
    return [(f"market-{m}", [{"sourceId": f"src-{rng.randint(0, 30)}",
                              "probability": rng.random()}
                             for _ in range(rng.randint(0, 9))])
            for m in range(40)]


EDGES = ("random", "dup_signals", "empty_market", "extreme_probs", "unicode",
         "empty")


def _assert_same(got, want):
    assert len(got) == len(want)
    for mine, ref in zip(got, want):
        if isinstance(ref, np.ndarray):
            assert mine.dtype == ref.dtype
            np.testing.assert_array_equal(mine, ref)
        else:
            assert list(mine) == list(ref)


@pytest.mark.parametrize("edge", EDGES)
def test_packer_routes_match_reference(edge, monkeypatch):
    payloads = edge_payloads(edge)
    routes = {native: (tbatch.pack_markets(payloads, native=native),
                       tbatch.columns_from_payloads(payloads, native=native))
              for native in (True, False)}
    monkeypatch.setenv("BCE_NO_NATIVE", "1")
    want_packed = jbatch.pack_markets(payloads)
    want_columns = jbatch.columns_from_payloads(payloads)
    for packed, columns in routes.values():
        for field in want_packed.__dataclass_fields__:
            _assert_same([getattr(packed, field)], [getattr(want_packed, field)])
        _assert_same(columns, want_columns)

    keys, sources, probs, offsets = want_columns
    want_codes = jbatch.encode_source_ids(sources)
    monkeypatch.delenv("BCE_NO_NATIVE")
    codes = tbatch.encode_source_ids(sources)  # the C intern_batch route
    np.testing.assert_array_equal(codes.codes, want_codes.codes)
    assert codes.table == list(want_codes.table)
    order = sorted(range(len(codes.table)), key=codes.table.__getitem__)
    rank_of_code = np.empty(max(len(order), 1), dtype=np.int64)
    rank_of_code[order] = np.arange(len(order))
    grouped = [tbatch.group_columns(codes.codes, rank_of_code, offsets, probs,
                                    native=native) for native in (True, False)]
    pair_sums = [tbatch.pair_accumulate(grouped[0][0], probs, len(grouped[0][1]),
                                        native=native) for native in (True, False)]
    fingerprints = [tbatch.topology_fingerprint(keys, ids, offsets)
                    for ids in (sources, codes)]  # join_codes on the C route
    monkeypatch.setenv("BCE_NO_NATIVE", "1")
    want_grouped = jbatch.group_columns(codes.codes, rank_of_code, offsets, probs)
    for got in grouped:
        _assert_same(got, want_grouped)
    for got in pair_sums:
        _assert_same([got], [want_grouped[4]])
    assert fingerprints == [jbatch.topology_fingerprint(keys, sources, offsets)] * 2


def test_twins_reject_negative_indices_alike():
    for native in (True, False):
        with pytest.raises(IndexError):
            tbatch.group_columns(np.array([-1], np.int32), np.zeros(1, np.int64),
                                 np.array([0, 1]), np.ones(1), native=native)
        with pytest.raises(IndexError):
            tbatch.pair_accumulate(np.array([-1]), np.ones(1), 1, native=native)


# ---------------------------------------------------------------------------
# The interner.
# ---------------------------------------------------------------------------


def random_pairs(count, sources, markets, seed):
    rng = random.Random(seed)
    alphabet = ["a", "ab", "abc", "src-é", "src-éx", "zz", "ζeta"]
    return [(f"{rng.choice(alphabet)}{rng.randrange(sources)}",
             f"m{rng.choice(alphabet)}{rng.randrange(markets)}")
            for _ in range(count)]


def test_interner_rows_match_reference():
    pairs = random_pairs(3000, 60, 40, seed=5)
    sources, markets = [p[0] for p in pairs], [p[1] for p in pairs]
    native, twin = interning.NativePairInterner(), interning.IdInterner()
    reference = jinterning.IdInterner()
    half = len(pairs) // 2
    got = [native.intern_arrays(sources[:half], markets[:half]),
           twin.intern_arrays(sources[:half], markets[:half])]
    want = reference.intern_arrays(sources[:half], markets[:half])
    # The second half through the (table, code) form.
    src_table = sorted(set(sources[half:]))
    mkt_table = sorted(set(markets[half:]))
    src_codes = np.array([src_table.index(s) for s in sources[half:]], np.int32)
    mkt_codes = np.array([mkt_table.index(m) for m in markets[half:]], np.int32)
    got.append(native.intern_arrays_indexed(src_table, src_codes, mkt_table,
                                            mkt_codes))
    want_second = reference.intern_arrays(sources[half:], markets[half:])
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)
    np.testing.assert_array_equal(got[2], want_second)
    assert native.ids()[:len(twin)] == twin.ids()
    assert native.ids() == reference.ids()
    assert native.items() == list(reference.items())
    probes = pairs[::7] + [("nobody", "nowhere")]
    np.testing.assert_array_equal(
        native.lookup_arrays([p[0] for p in probes], [p[1] for p in probes]),
        reference.lookup_arrays([p[0] for p in probes], [p[1] for p in probes]))
    assert len(native) == len(reference)


def test_sorted_rows_unicode_prefix_and_nul():
    native = interning.NativePairInterner()
    pairs = [("ab", "z"), ("a", "é"), ("a", "b"), ("abc", "a"), ("é", "a"),
             ("ζ", "m"), ("a", "bb"), ("aé", "x"), ("a", "bé"),
             ("a\U0001f600", "m"), ("a", "")]
    pairs += list(dict.fromkeys(random_pairs(500, 30, 20, seed=9)))
    pairs = list(dict.fromkeys(pairs))
    for pair in pairs:
        native.intern(pair)
    shuffled = np.arange(len(pairs), dtype=np.int32)
    random.Random(1).shuffle(shuffled)
    got = native.sorted_rows(shuffled)
    assert got.tolist() == sorted(range(len(pairs)), key=pairs.__getitem__)
    # Embedded NUL: refused on writes, absent on reads.
    with pytest.raises(ValueError):
        native.intern(("a\0b", "m"))
    assert native.get(("a\0b", "m")) == -1
    assert native.lookup_arrays(["a\0b", "a"], ["m", "b"]).tolist() == [
        -1, pairs.index(("a", "b"))]


# ---------------------------------------------------------------------------
# The SQLite writer.
# ---------------------------------------------------------------------------


def records(seed, count):
    rng = random.Random(seed)
    out = {}
    for sid, mid in random_pairs(count, 40, 25, seed):
        out[(sid, mid)] = (rng.random(), rng.random(),
                           f"2026-0{rng.randint(1, 9)}-1{rng.randint(0, 9)}"
                           f"T0{rng.randint(0, 9)}:00:00.000000+00:00")
    return out


def _flush_twice(store, record_cls, path, first, second):
    for (sid, mid), (rel, conf, iso) in first.items():
        store.put_record(record_cls(sid, mid, rel, conf, iso))
    full = store.flush_to_sqlite(path)
    after_full = dump(path)
    for (sid, mid), (rel, conf, iso) in second.items():
        store.put_record(record_cls(sid, mid, rel, conf, iso))
    incremental = store.flush_to_sqlite(path)
    return (full, incremental), after_full, dump(path)


def test_c_writer_matches_sqlite3_route_and_reference(tmp_path, monkeypatch):
    first = records(13, 400)
    second = dict(list(records(29, 60).items())
                  + list(first.items())[:20])  # rewrites and new rows
    c_store = TorchStore(device="cpu")
    assert c_store._pairs.sqlite_writer_available()
    called = []
    real = TorchStore._ordered_flush_rows
    monkeypatch.setattr(TorchStore, "_ordered_flush_rows",
                        lambda self, *a: called.append(a) or real(self, *a))
    got_c = _flush_twice(c_store, ReliabilityRecord, tmp_path / "c.db",
                         first, second)
    assert not called  # the C route wrote both flushes
    monkeypatch.setenv("BCE_NO_NATIVE", "1")
    py_store = TorchStore(device="cpu")
    assert isinstance(py_store._pairs, interning.IdInterner)
    got_py = _flush_twice(py_store, ReliabilityRecord, tmp_path / "py.db",
                          first, second)
    want = _flush_twice(JaxStore(), JaxRecord, tmp_path / "ref.db", first, second)
    assert len(called) == 2
    assert got_c == got_py == want
    assert want[0][1] < want[0][0]  # the second flush was incremental


def test_failed_c_write_propagates(tmp_path, monkeypatch):
    store = TorchStore(device="cpu")
    store.put_record(ReliabilityRecord("s", "m", 0.7, 0.6,
                                       "2026-01-01T00:00:00.000000+00:00"))
    monkeypatch.setattr(TorchStore, "_ordered_flush_rows",
                        lambda *a: pytest.fail("fell back to sqlite3"))
    with pytest.raises(RuntimeError, match="sqlite checkpoint"):
        store.flush_to_sqlite(tmp_path / "missing" / "x.db")
