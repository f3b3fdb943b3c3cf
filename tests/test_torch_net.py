"""The port's network front door ≡ the JAX package's, on the CPU.

* **Frames.** ``encode_request``/``encode_response``/``encode_error`` and
  ``encode_frame`` give the JAX package's bytes, ids with non-ASCII
  characters and 300 characters included, and each package decodes the
  other's frames to the same payloads.
* **Robustness.** The JAX package's wire-robustness inputs (a torn
  header, a torn payload, an oversized frame, a version mismatch, bad
  magic, a corrupted CRC, a response frame from a client, a non-integer
  id) raise the same exception classes with the same messages in both
  codecs, and draw the same error frames (code and message) from both
  servers, which count the same ``net.wire_errors``.
* **Served bytes.** The submission trace of ``tests/test_torch_serve.py``
  served by the port's ``ConsensusServer`` on localhost, after the
  hostile traffic, to one pipelining ``ConsensusClient`` gives the
  results, batch log, store records, journal epochs (wall clock masked)
  and SQLite bytes of the port's in-process service, flat and on a
  (1, 1) mesh; the JAX package's client gets the same results from the
  port's server, and the JAX package's in-process service the same
  batch log, records and journal epochs (its consensus within the
  tolerance of ``tests/test_torch_serve.py``).
"""

import asyncio
import socket
import zlib

import numpy as np
import pytest

from bayesian_consensus_engine_tpu import obs as jobs
from bayesian_consensus_engine_tpu.net import ConsensusClient as JaxClient
from bayesian_consensus_engine_tpu.net import ConsensusServer as JaxServer
from bayesian_consensus_engine_tpu.net import wire as jwire
from bayesian_consensus_engine_tpu.serve import ServeResult as JaxServeResult
from bayesian_consensus_engine_tpu_torch import obs as tobs
from bayesian_consensus_engine_tpu_torch.net import (
    ConsensusClient,
    ConsensusServer,
)
from bayesian_consensus_engine_tpu_torch.net import wire
from bayesian_consensus_engine_tpu_torch.serve import ServeResult
from test_torch_serve import (
    TOL,
    journal_epochs_sans_clock,
    mixed_trace,
    records,
    run_service,
    side,
)

LONG_ID = "марке́т-" + "x" * 292  # 300 characters, non-ASCII


def frames(codec, result_type):
    """Every frame shape, with awkward ids."""
    result = result_type(LONG_ID, 0.6125, 3, band_lo=0.5, band_hi=0.75,
                         band_stderr=0.0625, propagated=None)
    return [
        codec.encode_request("m-1", [("s-1", 0.5), {"sourceId": "s-2",
                                                    "probability": 0.25}],
                             True, qos_class="premium", request_id=7),
        codec.encode_request(LONG_ID, [("源-1", 1.0 / 3.0), ("s\t2", 0.0)],
                             False, request_id=2**40),
        codec.encode_response(9, result),
        codec.encode_error("overloaded", "busy ✓", request_id=4,
                           retry_after_s=0.05, pending=12),
        codec.encode_error("shed", LONG_ID),
        codec.encode_frame(codec.KIND_REQUEST, {"z": [1, 2.5, None],
                                                "a": {"ö": True}}),
    ]


def test_frames_are_the_jax_packages_bytes():
    mine, theirs = frames(wire, ServeResult), frames(jwire, JaxServeResult)
    assert mine == theirs
    assert (wire.HEADER.format, wire.MAGIC, wire.WIRE_VERSION,
            wire.MAX_FRAME_BYTES, wire.ERROR_CODES) == (
        jwire.HEADER.format, jwire.MAGIC, jwire.WIRE_VERSION,
        jwire.MAX_FRAME_BYTES, jwire.ERROR_CODES)
    for frame in theirs:
        kind, _length, crc = wire.decode_header(frame[:wire.HEADER.size])
        payload = wire.decode_payload(frame[wire.HEADER.size:], crc)
        jkind, _jl, jcrc = jwire.decode_header(frame[:jwire.HEADER.size])
        assert (kind, payload) == (
            jkind, jwire.decode_payload(frame[jwire.HEADER.size:], jcrc))


def codec_failures(codec):
    """What each malformed input raises in one codec: (class, message)."""
    good = codec.encode_request("m-x", [("s", 0.5)], True)
    cases = {
        "truncated_header": lambda: codec.decode_header(codec.MAGIC + b"\x01"),
        "bad_magic": lambda: codec.decode_header(
            b"HTTP/1.1 GET /\r\n" + b"\x00" * 4),
        "version": lambda: codec.decode_header(codec.HEADER.pack(
            codec.MAGIC, codec.WIRE_VERSION + 1, codec.KIND_REQUEST, 0, 2, 0)),
        "oversized": lambda: codec.decode_header(codec.HEADER.pack(
            codec.MAGIC, codec.WIRE_VERSION, codec.KIND_REQUEST, 0,
            codec.MAX_FRAME_BYTES + 1, 0)),
        "unknown_kind": lambda: codec.decode_header(codec.HEADER.pack(
            codec.MAGIC, codec.WIRE_VERSION, 9, 0, 2, 0)),
        "crc": lambda: codec.decode_payload(
            good[codec.HEADER.size:-1] + bytes([good[-1] ^ 0xFF]),
            codec.decode_header(good[:codec.HEADER.size])[2]),
        "not_json": lambda: codec.decode_payload(b"{x", zlib.crc32(b"{x")),
        "not_object": lambda: codec.decode_payload(b"[1]",
                                                   zlib.crc32(b"[1]")),
        "bad_kind": lambda: codec.encode_frame(7, {}),
        "bad_code": lambda: codec.encode_error("nope", "x"),
        "overloaded": lambda: codec.raise_error_payload({
            "code": "overloaded", "message": "x", "retry_after_s": 0.25,
            "pending": 9}),
        "shed": lambda: codec.raise_error_payload({"code": "shed",
                                                   "message": ""}),
        "closed": lambda: codec.raise_error_payload({"code": "closed",
                                                     "message": "bye"}),
        "oversized_payload": lambda: codec.raise_error_payload({
            "code": "oversized", "message": "x"}),
        "unknown_code": lambda: codec.raise_error_payload({"code": "later",
                                                           "message": "x"}),
    }
    out = {}
    for name, case in cases.items():
        with pytest.raises(Exception) as info:
            case()
        exc = info.value
        out[name] = (type(exc).__name__, str(exc),
                     getattr(exc, "retry_after_s", None),
                     getattr(exc, "pending", None))
    return out


def test_codec_failures_raise_the_same_classes_and_messages():
    mine, theirs = codec_failures(wire), codec_failures(jwire)
    assert mine == theirs
    assert mine["overloaded"][0] == "Overloaded"
    assert mine["crc"][0] == "ChecksumMismatch"


def read_error(sock):
    """One error frame off a raw socket: (code, message), or None at EOF."""
    header = b""
    while len(header) < wire.HEADER.size:
        chunk = sock.recv(wire.HEADER.size - len(header))
        if not chunk:
            return None
        header += chunk
    kind, length, crc = wire.decode_header(header)
    body = b""
    while len(body) < length:
        body += sock.recv(length - len(body))
    payload = wire.decode_payload(body, crc)
    assert kind == wire.KIND_ERROR
    return payload["code"], payload["message"]


def misbehave(port):
    """The hostile traffic of the JAX package's robustness tests; returns
    each connection's answer: its error frame and whether it then closed."""
    answers = []

    def raw():
        return socket.create_connection(("127.0.0.1", port), timeout=10.0)

    with raw() as sock:  # torn header, then death
        sock.sendall(wire.MAGIC + b"\x01")
    with raw() as sock:  # a header claiming 64 bytes, 10 sent, then death
        sock.sendall(wire.HEADER.pack(wire.MAGIC, wire.WIRE_VERSION,
                                      wire.KIND_REQUEST, 0, 64, 0) + b"x" * 10)
    hostile = [
        wire.HEADER.pack(wire.MAGIC, wire.WIRE_VERSION, wire.KIND_REQUEST, 0,
                         wire.MAX_FRAME_BYTES + 1, 0),
        wire.HEADER.pack(wire.MAGIC, wire.WIRE_VERSION + 1,
                         wire.KIND_REQUEST, 0, 2, 0),
        b"HTTP/1.1 GET /\r\n" + b"\x00" * 16,
        wire.encode_request("m-x", [("s", 0.5)], True)[:-1] + b"\x00",
        wire.encode_frame(wire.KIND_RESPONSE, {"id": 0}),
    ]
    for frame in hostile:
        with raw() as sock:
            sock.sendall(frame)
            answers.append((read_error(sock), sock.recv(1)))
    with raw() as sock:  # a well-framed request with a non-integer id
        sock.sendall(wire.encode_frame(wire.KIND_REQUEST, {
            "id": "abc", "market": "m-x", "signals": [["s", 0.5]],
            "outcome": True}))
        answers.append((read_error(sock), None))
    return answers


def serve_over_wire(kind, trace, tmp, name, mesh_shape=None, client=None,
                    hostile=False):
    """*trace* through one package's server on localhost and one pipelining
    client (*client*: the class; the port's by default). Returns (service,
    results, store, hostile answers, counters)."""
    store, module, mesh = side(kind, mesh_shape)
    server_type = ConsensusServer if kind == "torch" else JaxServer
    client_type = client or ConsensusClient
    obs = tobs if kind == "torch" else jobs
    registry = obs.MetricsRegistry()
    answers = []

    async def main():
        service = module.ConsensusService(
            store, mesh=mesh, steps=2, now=21_900.0, checkpoint_every=2,
            journal=tmp / f"{name}.jrnl", db_path=tmp / f"{name}.db",
            max_batch=8, max_delay_s=None, record_batches=True)
        server = await server_type(service, acceptors=2).start()
        loop = asyncio.get_running_loop()

        def drive():
            if hostile:
                answers.extend(misbehave(server.port))
            with client_type(port=server.port) as conn:
                return conn.submit_pipelined(trace, return_exceptions=False)

        try:
            results = await loop.run_in_executor(None, drive)
            await service.drain()
        finally:
            await server.close()
            await service.close()
        return service, results

    previous = obs.set_metrics_registry(registry)
    try:
        with pytest.MonkeyPatch.context() as mp:
            if kind == "jax":
                mp.setenv("BCE_NO_NATIVE", "1")
            service, results = asyncio.run(main())
    finally:
        obs.set_metrics_registry(previous)
    counters = {k: v for k, v in registry.export()["counters"].items()
                if k.startswith("net.")}
    return service, results, store, answers, counters


def test_hostile_traffic_draws_the_same_frames_from_both_servers(tmp_path):
    trace = mixed_trace()[:8]
    *_rest, mine, my_counters = serve_over_wire(
        "torch", trace, tmp_path, "port", hostile=True)
    *_rest, theirs, their_counters = serve_over_wire(
        "jax", trace, tmp_path, "jax", hostile=True)
    assert mine == theirs
    assert [answer[0][0] for answer in mine] == [
        "oversized", "version_mismatch", "bad_frame", "bad_frame",
        "bad_frame", "bad_request"]
    assert all(closed == b"" for _frame, closed in mine[:5])
    assert my_counters == their_counters
    assert my_counters["net.wire_errors"] == 7
    assert my_counters["net.requests"] == my_counters["net.responses"] + 1


@pytest.mark.parametrize("mesh_shape", [None, (1, 1)], ids=["flat", "1x1"])
def test_wire_equals_inprocess_and_jax(tmp_path, mesh_shape):
    trace = mixed_trace()
    service, results, store, _answers, counters = serve_over_wire(
        "torch", trace, tmp_path, "wire", mesh_shape, hostile=True)
    assert counters["net.wire_errors"] == 7
    inprocess = run_service("torch", trace, tmp_path, "ref", mesh_shape)
    assert results == inprocess.outcomes
    assert [(cols[0], outs) for cols, outs in service.batch_log] == [
        (cols[0], outs) for cols, outs in inprocess.service.batch_log]
    assert records(store) == records(inprocess.store)
    assert journal_epochs_sans_clock(tmp_path / "wire.jrnl") == (
        journal_epochs_sans_clock(inprocess.journal))
    assert (tmp_path / "wire.db").read_bytes() == inprocess.db.read_bytes()

    # The JAX package's client against the port's server: the same results.
    _s, jax_client_results, _st, _a, _c = serve_over_wire(
        "torch", trace, tmp_path, "jclient", mesh_shape, client=JaxClient)
    assert [(r.market_id, r.consensus, r.batch_index)
            for r in jax_client_results] == [
        (r.market_id, r.consensus, r.batch_index) for r in results]

    # The JAX package's served run of the same trace.
    ref = run_service("jax", trace, tmp_path, "jax", mesh_shape)
    assert [(r.market_id, r.batch_index) for r in results] == [
        (r.market_id, r.batch_index) for r in ref.outcomes]
    np.testing.assert_allclose([r.consensus for r in results],
                               [r.consensus for r in ref.outcomes], **TOL)
    assert records(store) == records(ref.store)
    assert journal_epochs_sans_clock(tmp_path / "wire.jrnl") == (
        journal_epochs_sans_clock(ref.journal))


def test_refusals_cross_the_wire_as_the_serve_exceptions(tmp_path):
    """A class budget of 2 under ``reject`` and one of 2 under
    ``shed_oldest``: the pipelined client gets ``Overloaded`` with its
    retry hint and ``ShedError`` in the slots the service fails, as the
    JAX package's client does from the JAX server."""
    answers = []
    for kind, client in (("torch", ConsensusClient), ("jax", JaxClient)):
        store, module, _mesh = side(kind, None)

        async def main(module=module, store=store, kind=kind, client=client):
            # One window: two gold admitted and two rejected, two
            # best-effort shed by the next two, and two of a third class
            # filling it to max_batch, which flushes it.
            service = module.ConsensusService(
                store, steps=1, now=21_900.0, max_batch=6, max_delay_s=None,
                qos=[module.QosClass("gold", 3600.0, 2, retry_after_s=0.125),
                     module.QosClass("be", 3600.0, 2, policy="shed_oldest"),
                     module.QosClass("fill", 3600.0, 64)])
            server_type = ConsensusServer if kind == "torch" else JaxServer
            server = await server_type(service).start()
            loop = asyncio.get_running_loop()

            def drive():
                with client(port=server.port) as conn:
                    requests = [(f"m-{i}", [("s", 0.5)], True,
                                 ("gold", "be", "fill")[min(i // 4, 2)])
                                for i in range(10)]
                    return conn.submit_pipelined(requests)

            try:
                out = await loop.run_in_executor(None, drive)
                await service.drain()
            finally:
                await server.close()
                await service.close()
            return out

        with pytest.MonkeyPatch.context() as mp:
            if kind == "jax":
                mp.setenv("BCE_NO_NATIVE", "1")
            out = asyncio.run(main())
        answers.append([
            (type(value).__name__, str(value),
             getattr(value, "retry_after_s", None))
            if isinstance(value, BaseException)
            else (value.market_id, value.batch_index)
            for value in out
        ])
    assert answers[0] == answers[1]
    names = [answer[0] for answer in answers[0]]
    assert names.count("Overloaded") == 2 and names.count("ShedError") == 2
    assert ("Overloaded", answers[0][2][1], 0.125) == answers[0][2]
