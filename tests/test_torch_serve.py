"""The port's request front door ≡ the JAX package's, on the CPU.

One submission-ordered trace (hits, drift with adopts, growth; the shape
of ``tests/test_serve.py::mixed_trace``) goes through the JAX package's
``ConsensusService`` and the port's, each on a fresh store (the port on
``device="cpu"`` with the plain kernel versions, the JAX side on its
Python host route), ``max_delay_s=None``, ``now`` fixed, width 8,
journal epochs every two batches and a SQLite tail flush, flat and on
(1, 1) and (1, 4) meshes:

* every request's ``ServeResult`` has the same ``market_id`` and
  ``batch_index``, its consensus within rtol=1e-5, atol=1e-6 (float32:
  XLA's ``exp2`` and slot-sum order, as ``tests/test_torch_stream.py``
  states it), and the ``batch_log`` is equal column for column;
* the stores' records are bit-equal, the journal epochs byte-equal with
  each epoch's wall clock masked, and the SQLite files' ``iterdump()``
  equal (the CREATE statement's whitespace normalised: the port's C
  writer keeps its schema on one line); on the port's Python host route
  the SQLite files are byte-equal;
* the port's ``batch_log`` re-driven through its ``drive_trace`` on the
  same mesh gives the served store, journal and consensus bit for bit.

Under ``analytics=True`` the bands agree within rtol=1e-5, atol=1e-3 (the
band stderr cancels; ``tests/test_torch_analytics_math.py``) and the
consensus, store and files are those of the run without analytics. The
same futures fail with the same ``Overloaded`` (``retry_after_s``,
``pending``) or ``ShedError`` under ``reject`` and ``shed_oldest``, the
variance-aware shed order and a two-class ``qos_snapshot()`` are equal,
``AdaptiveWindow`` logs the same delays for the same latencies, and a
mid-serve journal failure leaves the same ``settled_batches`` and
resumes to the same store. The JAX runs are made once per module.
"""

import asyncio
import sqlite3
import struct

import jax
import numpy as np
import pytest

from bayesian_consensus_engine_tpu import serve as jserve
from bayesian_consensus_engine_tpu.parallel.mesh import make_mesh as jax_mesh
from bayesian_consensus_engine_tpu.state import journal as jjournal
from bayesian_consensus_engine_tpu.state.tensor_store import (
    TensorReliabilityStore as JaxStore,
)
from bayesian_consensus_engine_tpu_torch import serve as tserve
from bayesian_consensus_engine_tpu_torch.parallel.mesh import make_mesh
from bayesian_consensus_engine_tpu_torch.serve import coalesce
from bayesian_consensus_engine_tpu_torch.state import journal as tjournal
from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
    TensorReliabilityStore,
)

NOW = 21_900.0
TOL = dict(rtol=1e-5, atol=1e-6)
ANALYTICS_TOL = dict(rtol=1e-5, atol=1e-3)
MESHES = [None, (1, 1), (1, 4)]


def mixed_trace(width=8):
    """Two rounds of one stable universe (fingerprint hits), two rounds of
    a drifted one (an adopt, then a hit), then 2×*width* fresh markets
    (growth); every round submits *width* distinct markets, so
    ``max_batch=width`` seals one window a round."""
    trace = []
    for rnd in range(2):
        for m in range(width):
            trace.append((
                f"m-{m}",
                [(f"s-{m}", 0.55 + 0.01 * rnd), (f"s-{(m + 1) % 5}", 0.40)],
                (m + rnd) % 2 == 0,
            ))
    for rnd in range(2):
        for m in range(width):
            trace.append((
                f"m-{m}",
                [(f"s-{m}", 0.35 + 0.01 * rnd), ("s-drift", 0.70)],
                (m + rnd) % 3 == 0,
            ))
    for m in range(2 * width):
        trace.append((
            f"fresh-{m}", [(f"s-{m % 5}", 0.62), (f"g-{m}", 0.48)],
            m % 2 == 1,
        ))
    return trace


def journal_epochs_sans_clock(path):
    """Each epoch's header fields but the wall clock, and its payload."""
    blob = path.read_bytes()
    assert blob[:8] == b"BCEJRNL1"
    hdr = struct.Struct("<QQQQQdQ")
    off, epochs = 8, []
    while off < len(blob):
        (epoch_index, used_after, pair_len, dirty, iso_len,
         _wall_ts, tag) = hdr.unpack_from(blob, off)
        payload_len = pair_len + 33 * dirty + iso_len
        start = off + hdr.size
        epochs.append((
            (epoch_index, used_after, pair_len, dirty, iso_len, tag),
            blob[start:start + payload_len],
        ))
        off = start + payload_len + 4
    return epochs


def records(store):
    store.sync()
    return [(r.source_id, r.market_id, r.reliability, r.confidence,
             r.updated_at) for r in store.list_sources()]


def dump(path):
    with sqlite3.connect(path) as conn:
        return [" ".join(line.split()) if line.startswith("CREATE") else line
                for line in conn.iterdump()]


def side(kind, mesh_shape):
    """(store, serve module, mesh) of one package."""
    if kind == "jax":
        mesh = None
        if mesh_shape is not None:
            count = mesh_shape[0] * mesh_shape[1]
            mesh = jax_mesh(mesh_shape, devices=jax.devices()[:count])
        return JaxStore(), jserve, mesh
    mesh = None
    if mesh_shape is not None:
        mesh = make_mesh(mesh_shape, ["cpu"] * (mesh_shape[0] * mesh_shape[1]))
    return TensorReliabilityStore(device="cpu"), tserve, mesh


def outcome_of(future):
    """A settled future as comparable data."""
    exc = future.exception()
    if exc is not None:
        return (type(exc).__name__, str(exc))
    return future.result()


class Served:
    def __init__(self, service, outcomes, store, tmp, name):
        self.service, self.outcomes, self.store = service, outcomes, store
        self.journal = tmp / f"{name}.jrnl"
        self.db = tmp / f"{name}.db"


def run_service(kind, trace, tmp, name, mesh_shape=None, width=8,
                journal=True, db=True, python_route=False, **kwargs):
    """Submit *trace* in order, drain and close one package's service
    (the JAX side on its Python host route, the port on its C route
    unless *python_route*)."""
    kwargs.setdefault("steps", 2)
    kwargs.setdefault("now", NOW)
    kwargs.setdefault("checkpoint_every", 2)
    with pytest.MonkeyPatch.context() as mp:
        if kind == "jax" or python_route:
            mp.setenv("BCE_NO_NATIVE", "1")
        else:
            mp.delenv("BCE_NO_NATIVE", raising=False)
        store, module, mesh = side(kind, mesh_shape)

        async def main():
            service = module.ConsensusService(
                store, mesh=mesh,
                journal=(tmp / f"{name}.jrnl") if journal else None,
                db_path=(tmp / f"{name}.db") if db else None,
                max_batch=width, max_delay_s=None, record_batches=True,
                **kwargs,
            )
            futures = []
            async with service:
                for market_id, signals, outcome in trace:
                    futures.append(service.submit(market_id, signals,
                                                  outcome))
                await service.drain()
            return service, futures

        service, futures = asyncio.run(main())
    return Served(service, [outcome_of(f) for f in futures], store, tmp,
                  name)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Service runs by (package, mesh shape, analytics), made on demand
    and shared by the tests of this module."""
    tmp = tmp_path_factory.mktemp("serve")
    cache = {}

    def get(kind, mesh_shape, analytics=False, python_route=False):
        key = (kind, mesh_shape, analytics, python_route)
        if key not in cache:
            name = f"{kind}-{mesh_shape and 'x'.join(map(str, mesh_shape))}"
            kw = dict(python_route=python_route)
            if python_route:
                name += "-py"
            if analytics:
                name += "-bands"
                kw["analytics"] = True
            cache[key] = run_service(kind, mixed_trace(), tmp, name,
                                     mesh_shape, **kw)
        return cache[key]

    return get


def assert_same_batches(mine, theirs):
    assert len(mine) == len(theirs)
    for ((keys, sids, probs, offsets), outcomes), (
            (jkeys, jsids, jprobs, joffsets), joutcomes) in zip(mine, theirs):
        assert list(keys) == list(jkeys) and list(sids) == list(jsids)
        np.testing.assert_array_equal(probs, jprobs)
        np.testing.assert_array_equal(offsets, joffsets)
        assert list(outcomes) == list(joutcomes)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["flat", "1x1", "1x4"])
def test_service_equals_jax_and_its_redrive(served, mesh_shape, tmp_path):
    port, ref = served("torch", mesh_shape), served("jax", mesh_shape)
    assert len(port.service.batch_log) == 6
    assert port.service.settled_batches == ref.service.settled_batches == 6
    for mine, theirs in zip(port.outcomes, ref.outcomes):
        assert (mine.market_id, mine.batch_index) == (
            theirs.market_id, theirs.batch_index)
        np.testing.assert_allclose(mine.consensus, theirs.consensus, **TOL)
        assert mine.band_lo is None and theirs.band_lo is None
    assert_same_batches(port.service.batch_log, ref.service.batch_log)
    assert records(port.store) == records(ref.store)
    assert journal_epochs_sans_clock(port.journal) == (
        journal_epochs_sans_clock(ref.journal))
    assert dump(port.db) == dump(ref.db)
    # On the port's Python host route (the sqlite3 writer, as the JAX side
    # runs here) the SQLite file is the JAX package's byte for byte.
    python_route = served("torch", mesh_shape, python_route=True)
    assert python_route.db.read_bytes() == ref.db.read_bytes()
    assert records(python_route.store) == records(ref.store)

    # The batch log re-driven through the port's drive_trace, as the trace
    # sidecar would record it: the served store, journal and consensus.
    trace = [
        tjournal.TraceBatch(index, tuple(keys), tuple(sids),
                            np.asarray(probs), np.asarray(offsets),
                            np.asarray(outcomes), NOW + index, 2)
        for index, ((keys, sids, probs, offsets), outcomes)
        in enumerate(port.service.batch_log)
    ]
    store, _module, mesh = side("torch", mesh_shape)
    results = tserve.drive_trace(store, trace, mesh=mesh,
                                 journal=tmp_path / "again.jrnl",
                                 db_path=tmp_path / "again.db",
                                 checkpoint_every=2)
    assert records(store) == records(port.store)
    assert journal_epochs_sans_clock(tmp_path / "again.jrnl") == (
        journal_epochs_sans_clock(port.journal))
    assert (tmp_path / "again.db").read_bytes() == port.db.read_bytes()
    for served_result in port.outcomes:
        batch = results[served_result.batch_index].by_market()
        assert served_result.consensus == batch[served_result.market_id]


def test_analytics_bands_equal_jax_and_move_no_byte(served):
    plain = served("torch", (1, 1))
    port, ref = served("torch", (1, 1), True), served("jax", (1, 1), True)
    for mine, theirs, without in zip(port.outcomes, ref.outcomes,
                                     plain.outcomes):
        assert mine.consensus == without.consensus
        assert mine.batch_index == theirs.batch_index
        for field in ("band_lo", "band_hi", "band_stderr"):
            got, want = getattr(mine, field), getattr(theirs, field)
            assert isinstance(got, float)
            np.testing.assert_allclose(got, want, **ANALYTICS_TOL)
        assert mine.propagated is None and mine.propagated_stderr is None
    assert records(port.store) == records(plain.store) == records(ref.store)
    assert port.db.read_bytes() == plain.db.read_bytes()
    assert journal_epochs_sans_clock(port.journal) == (
        journal_epochs_sans_clock(plain.journal))
    # The live stderr map the shed ranking reads: every settled market.
    assert set(port.service.market_band_stderr) == {
        market for market, _s, _o in mixed_trace()}


def burst(kind, policy, max_pending, max_batch, n):
    """*n* distinct-market submits against a bounded service: each arrival
    as ``("rejected", retry_after_s, pending, message)`` or its future."""
    store, module, _mesh = side(kind, None)

    async def main():
        service = module.ConsensusService(
            store, now=NOW, max_batch=max_batch, max_delay_s=None,
            admission=module.AdmissionConfig(
                max_pending=max_pending, policy=policy, retry_after_s=0.01),
        )
        arrivals, pending = [], []
        async with service:
            for i in range(n):
                try:
                    arrivals.append(service.submit(f"m-{i}", [("s", 0.5)],
                                                   True))
                except module.Overloaded as exc:
                    arrivals.append(("rejected", exc.retry_after_s,
                                     exc.pending, str(exc)))
                pending.append(service.pending_requests)
            await service.drain()
        return arrivals, pending

    arrivals, pending = asyncio.run(main())
    out = []
    for arrival in arrivals:
        if isinstance(arrival, tuple):
            out.append(arrival)
        else:
            value = outcome_of(arrival)
            out.append(value if isinstance(value, tuple)
                       else (value.market_id, value.batch_index,
                             np.float32(value.consensus)))
    return out, pending


@pytest.mark.parametrize("policy, max_pending, max_batch, n", [
    ("reject", 4, 2, 30),
    ("shed_oldest", 5, 100, 12),
    ("shed_oldest", 2, 1, 20),
], ids=["reject", "shed", "shed_degrades"])
def test_overload_fails_the_same_futures(policy, max_pending, max_batch, n):
    mine, pending = burst("torch", policy, max_pending, max_batch, n)
    theirs, jpending = burst("jax", policy, max_pending, max_batch, n)
    assert mine == theirs and pending == jpending
    assert max(pending) <= max_pending
    kinds = {item[0] for item in mine if isinstance(item[0], str)
             and not item[0].startswith("m-")}
    assert kinds == ({"rejected"} if policy == "reject" or max_batch == 1
                     else {"ShedError"})


def shed_victims(kind):
    store, module, _mesh = side(kind, None)
    victims = []

    async def main():
        service = module.ConsensusService(
            store, steps=1, now=NOW, max_batch=64, max_delay_s=None,
            qos=[module.QosClass("be", 3600.0, 3, policy="shed_oldest")],
        )
        service.seed_band_stderr(
            {"m-wide": 0.40, "m-mid": 0.20, "m-narrow": 0.05})
        pending = {}
        for market in ("m-narrow", "m-wide", "m-mid", "m-new"):
            pending[market] = service.submit(market, [("s", 0.6)], True,
                                             qos_class="be")
        for i in range(3):
            pending[f"m-fresh-{i}"] = service.submit(
                f"m-fresh-{i}", [("s", 0.6)], True, qos_class="be")
            for market, future in list(pending.items()):
                if future.done() and isinstance(future.exception(),
                                                module.ShedError):
                    victims.append((market, str(future.exception())))
                    del pending[market]
        await service.drain()
        await service.close()
        return service.qos_snapshot()

    return victims, asyncio.run(main())


def two_class_snapshot(kind):
    store, module, _mesh = side(kind, None)

    async def main():
        service = module.ConsensusService(
            store, steps=1, now=NOW, max_batch=4, max_delay_s=None, qos=[
                module.QosClass("premium", 3600.0, 64),
                module.QosClass("besteffort", 1e-9, 3, policy="shed_oldest"),
            ])
        refused = 0
        for i in range(12):
            try:
                service.submit(f"m-{i}", [("s", 0.6), ("t", 0.2)], i % 3 == 0,
                               qos_class="premium" if i % 2 else "besteffort")
            except module.Overloaded:
                refused += 1
        await service.drain()
        await service.close()
        return refused, service.qos_snapshot()

    return asyncio.run(main())


def test_shed_order_and_qos_snapshot_equal_jax():
    mine, theirs = shed_victims("torch"), shed_victims("jax")
    assert mine == theirs
    # Widest known band first, then the unknown-band market.
    assert [market for market, _ in mine[0]] == [
        "m-wide", "m-mid", "m-narrow", "m-new"]
    mine, theirs = two_class_snapshot("torch"), two_class_snapshot("jax")
    assert mine == theirs
    snapshot = mine[1]
    assert list(snapshot) == ["premium", "besteffort"]
    assert snapshot["premium"]["counts"]["met"] == 6
    assert snapshot["besteffort"]["counts"]["violated"] > 0


def test_adaptive_window_logs_the_same_delays():
    batches = [[0.01, 0.02, 0.015], [0.3, 0.25, 0.4], [0.05, 0.5], [],
               [0.08], [1e-4] * 40, [10.0] * 3]
    logs = []
    for module in (tserve, jserve):
        window = module.AdaptiveWindow(target_p99_s=0.1,
                                       initial_delay_s=0.005)
        for latencies in batches:
            for latency in latencies:
                window.observe(latency)
            window.step()
        logs.append((window.delay_log, window.floor_s, window.cap_s))
    assert logs[0] == logs[1]
    errors = []
    for module, store in ((tserve, TensorReliabilityStore(device="cpu")),
                          (jserve, JaxStore())):
        found = []
        for kwargs in (dict(max_delay_s=None, target_p99_s=0.05),
                       dict(max_batch=0), dict(band_stderr_bound=0),
                       dict(max_delay_s=-1.0), dict(slo=None, health=object())):
            with pytest.raises(ValueError) as info:
                module.ConsensusService(store, **kwargs)
            found.append(str(info.value))
        with pytest.raises(ValueError) as info:
            module.AdaptiveWindow(0.1, 0.0)
        found.append(str(info.value))
        errors.append(found)
    assert errors[0] == errors[1]


def crash_and_resume(kind, tmp, trace):
    """A service whose second async epoch fails mid-serve, then the tail of
    its batch log re-served on the same store with a resumed journal."""
    store, module, _mesh = side(kind, None)
    journal_module = tjournal if kind == "torch" else jjournal
    store_type = type(store)
    real_flush = store_type.flush_to_journal_async
    calls = {"n": 0}

    def broken_second(self, journal, tag=0):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("journal disk gone")
        return real_flush(self, journal, tag=tag)

    path = tmp / f"crash-{kind}.jrnl"

    async def crashing():
        service = module.ConsensusService(
            store, steps=2, now=NOW, checkpoint_every=2, journal=path,
            max_batch=8, max_delay_s=None, record_batches=True)
        futures = [service.submit(*request) for request in trace]
        await service.drain()
        with pytest.raises(RuntimeError, match="journal disk gone"):
            await service.close()
        return service, futures

    with pytest.MonkeyPatch.context() as mp:
        if kind == "jax":
            mp.setenv("BCE_NO_NATIVE", "1")
        mp.setattr(store_type, "flush_to_journal_async", broken_second)
        service, futures = asyncio.run(crashing())
        mp.setattr(store_type, "flush_to_journal_async", real_flush)
        settled = service.settled_batches

        async def resumed():
            resume = module.ConsensusService(
                store, steps=2, now=NOW + settled, checkpoint_every=2,
                journal=journal_module.JournalWriter(path, resume=True),
                max_batch=8, max_delay_s=None)
            async with resume:
                for (keys, sids, probs, offsets), outcomes in (
                        service.batch_log[settled:]):
                    for i, market in enumerate(keys):
                        lo, hi = int(offsets[i]), int(offsets[i + 1])
                        resume.submit(market, list(zip(sids[lo:hi],
                                                       probs[lo:hi])),
                                      outcomes[i])
                    await resume.flush()
                await resume.drain()

        asyncio.run(resumed())
    failed = [i for i, f in enumerate(futures) if f.exception() is not None]
    messages = sorted({str(futures[i].exception()) for i in failed})
    if kind == "torch":
        replayed, tag = tjournal.replay_journal(path, device="cpu")
    else:
        replayed, tag = jjournal.replay_journal(path)
    return settled, failed, messages, records(store), records(replayed), tag


def test_crash_and_resume_equal_jax(served, tmp_path):
    trace = mixed_trace()
    mine = crash_and_resume("torch", tmp_path, trace)
    theirs = crash_and_resume("jax", tmp_path, trace)
    assert mine == theirs
    settled, failed, _messages, state, replayed, _tag = mine
    assert 0 < settled < 6 and failed
    # The resumed store is the uninterrupted run's (the journal replays to
    # it too).
    assert state == replayed == records(served("torch", None).store)


def test_worker_settles_on_the_store_device():
    store = TensorReliabilityStore(device="cpu")
    assert coalesce._settle_device(store, None) == store.device
    mesh = make_mesh((1, 2), ["cpu", "cpu"])
    assert coalesce._settle_device(store, mesh).type == "cpu"


def test_a_batch_comes_to_the_host_in_one_copy(monkeypatch):
    """The consensus and every analytics column, lazy session views
    included, reach the host through one ``.cpu()`` of one stacked
    tensor, their values unchanged (float32 through float64 is exact)."""
    import torch

    from bayesian_consensus_engine_tpu_torch.ops.propagate import (
        PropagatedBeliefs,
    )
    from bayesian_consensus_engine_tpu_torch.ops.uncertainty import (
        UncertaintyBands,
    )
    from bayesian_consensus_engine_tpu_torch.pipeline import (
        SettlementResult,
        _BandView,
    )

    rng = np.random.default_rng(3)
    cols = [torch.tensor(rng.random(5), dtype=torch.float32) for _ in range(6)]
    cols[0][2] = float("nan")
    bands = UncertaintyBands(cols[1], _BandView(cols[2]), cols[3],
                             _BandView(cols[4]), cols[1], cols[1])
    prop = PropagatedBeliefs(cols[5], cols[3], torch.tensor(3),
                             torch.tensor(0.0))
    result = SettlementResult(list("abcde"), _BandView(cols[0]))
    fetches = []
    real_cpu = torch.Tensor.cpu

    def counted(self, *args, **kwargs):
        fetches.append(tuple(self.shape))
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    consensus, host_bands, propagated, prop_stderr = coalesce._host_columns(
        result, (None, bands, prop))
    assert fetches == [(6, 5)]
    for got, want in ((consensus, cols[0]), (host_bands["lo"], cols[2]),
                      (host_bands["hi"], cols[3]),
                      (host_bands["stderr"], cols[4]), (propagated, cols[5]),
                      (prop_stderr, cols[3])):
        np.testing.assert_array_equal(got, want.numpy().astype(np.float64))
    fetches.clear()
    flat = SettlementResult(list("abcde"), cols[0])
    consensus, none, *_rest = coalesce._host_columns(flat, None)
    assert fetches == [(1, 5)] and none is None and _rest == [None, None]
    # Read on the host first, the column is stacked from its host copy.
    np.testing.assert_array_equal(flat.consensus, cols[0].numpy())
    consensus, *_rest = coalesce._host_columns(flat, None)
    np.testing.assert_array_equal(consensus,
                                  cols[0].numpy().astype(np.float64))
