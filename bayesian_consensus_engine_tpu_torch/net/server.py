"""The network front door: N asyncio acceptor tasks feeding the one
deterministic coalescer.

The port's copy of the JAX package's ``net/server.py``.
:class:`ConsensusServer` puts a multi-client transport in front of
:class:`~.serve.coalesce.ConsensusService` without a second batching
discipline: every connection's requests are submitted, on the event-loop
thread and in wire arrival order, through the same ``service.submit`` an
in-process caller uses, so the batch sequence stays a function of the
admitted-request trace. The server owns sockets and frames; the service
owns windows, admission, QoS and settlement (and the card: nothing here
touches a tensor). So the same admitted trace served over the wire and
submitted in process gives the same results, journal epochs (wall clock
masked) and SQLite bytes.

**Acceptor pool.** ``acceptors`` tasks loop on ``sock_accept`` over one
listening socket (the kernel spreads the accept queue across them); each
accepted connection gets its own reader task.

**Pipelining.** A connection may send request frames back to back; each
settled future writes its response frame (under a per-connection write
lock) when it resolves, carrying the request's ``id``, so a pipelining
client matches responses arriving in completion order. A client that
awaited each settlement before its next submit could never fill a
coalescing window.

**Failure containment.** Admission refusals (``Overloaded``/
``ShedError``/``ServiceClosed``) are ERROR frames on a healthy
connection. Framing violations (bad magic, version mismatch, oversized
or checksum-failed frames, torn writes) kill only the offending
connection — a best-effort error frame, then close — and are counted
(``net.wire_errors``); the coalescer, every other connection and the
journal bytes are untouched.
"""

from __future__ import annotations

import asyncio
import socket
from typing import Optional

from bayesian_consensus_engine_tpu_torch.net import wire
from bayesian_consensus_engine_tpu_torch.obs.metrics import metrics_registry
from bayesian_consensus_engine_tpu_torch.serve.admission import (
    Overloaded,
    ServeError,
    ServiceClosed,
    ShedError,
)


def _error_frame_for(exc: BaseException, request_id=None) -> bytes:
    """Map a serve-layer exception onto its explicit error frame."""
    if isinstance(exc, Overloaded):
        return wire.encode_error(
            "overloaded", str(exc), request_id=request_id,
            retry_after_s=exc.retry_after_s, pending=exc.pending,
        )
    if isinstance(exc, ShedError):
        return wire.encode_error("shed", str(exc), request_id=request_id)
    if isinstance(exc, ServiceClosed):
        return wire.encode_error("closed", str(exc), request_id=request_id)
    if isinstance(exc, (ValueError, KeyError, TypeError)):
        return wire.encode_error(
            "bad_request", repr(exc), request_id=request_id
        )
    return wire.encode_error("failed", repr(exc), request_id=request_id)


class ConsensusServer:
    """Length-prefixed socket front door over one coalescing service.

    Start from inside the event loop that owns *service* (its coalescer
    is loop-owned state): ``server = await ConsensusServer(service).
    start()``; ``port`` reads the bound port back (``port=0`` binds
    ephemeral). ``close()`` stops the acceptors and closes every open
    connection; the service is NOT closed — the caller that composed
    them owns both lifecycles (the CLI's ``serve`` closes the service
    after the server).
    """

    def __init__(
        self,
        service,
        host: str = "127.0.0.1",
        port: int = 0,
        acceptors: int = 4,
        max_frame_bytes: int = wire.MAX_FRAME_BYTES,
    ) -> None:
        if acceptors < 1:
            raise ValueError("acceptors must be >= 1")
        self._service = service
        self._host = host
        self._requested_port = int(port)
        self._acceptors = int(acceptors)
        self._max_frame_bytes = int(max_frame_bytes)
        self._sock: Optional[socket.socket] = None
        self._tasks: set = set()
        self._closed = False
        registry = metrics_registry()
        self._connections = registry.counter("net.connections")
        self._open_gauge = registry.gauge("net.open_connections")
        self._requests = registry.counter("net.requests")
        self._responses = registry.counter("net.responses")
        self._errors = registry.counter("net.error_frames")
        self._wire_errors = registry.counter("net.wire_errors")
        self._open = 0

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "ConsensusServer":
        if self._sock is not None:
            return self
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self._host, self._requested_port))
        sock.listen(128)
        sock.setblocking(False)
        self._sock = sock
        loop = asyncio.get_running_loop()
        for i in range(self._acceptors):
            self._track(loop.create_task(self._accept_loop(i)))
        return self

    def _track(self, task) -> None:
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    @property
    def port(self) -> int:
        if self._sock is None:
            raise RuntimeError("server not started")
        return self._sock.getsockname()[1]

    @property
    def address(self) -> str:
        return f"{self._host}:{self.port}"

    async def close(self) -> None:
        """Stop accepting, close every connection; idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._sock is not None:
            self._sock.close()
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)

    async def __aenter__(self) -> "ConsensusServer":
        return await self.start()

    async def __aexit__(self, *exc_info: object) -> None:
        await self.close()

    # -- accepting -----------------------------------------------------------

    async def _accept_loop(self, index: int) -> None:
        loop = asyncio.get_running_loop()
        while not self._closed:
            try:
                conn, _addr = await loop.sock_accept(self._sock)
            except asyncio.CancelledError:
                raise
            except OSError:
                return  # listening socket closed under us: shutdown
            self._connections.inc()
            self._track(loop.create_task(self._serve_connection(conn)))

    # -- per-connection ------------------------------------------------------

    async def _serve_connection(self, conn: socket.socket) -> None:
        loop = asyncio.get_running_loop()
        reader = asyncio.StreamReader(loop=loop)
        protocol = asyncio.StreamReaderProtocol(reader, loop=loop)
        transport, _ = await loop.connect_accepted_socket(
            lambda: protocol, conn
        )
        writer = asyncio.StreamWriter(transport, protocol, reader, loop)
        write_lock = asyncio.Lock()
        self._open += 1
        self._open_gauge.set(float(self._open))
        try:
            await self._read_frames(reader, writer, write_lock, loop)
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError):
            pass  # peer went away; nothing to salvage
        finally:
            self._open -= 1
            self._open_gauge.set(float(self._open))
            try:
                writer.close()
            except (ConnectionError, OSError):
                pass

    async def _read_frames(self, reader, writer, write_lock, loop) -> None:
        while True:
            try:
                header = await reader.readexactly(wire.HEADER.size)
            except asyncio.IncompleteReadError as exc:
                if exc.partial:
                    # Torn mid-header: the peer died mid-send. Count it;
                    # there is no framing left to answer into.
                    self._wire_errors.inc()
                return  # clean EOF at a frame boundary
            try:
                kind, length, crc = wire.decode_header(
                    header, self._max_frame_bytes
                )
                payload = wire.decode_payload(
                    await reader.readexactly(length), crc
                )
            except asyncio.IncompleteReadError:
                # Torn mid-payload (a slow client that died mid-frame):
                # the stream is desynced — close, never resynchronise by
                # guesswork.
                self._wire_errors.inc()
                return
            except wire.WireError as exc:
                # A framing violation gets its explicit refusal, then
                # the connection dies: after a desync every subsequent
                # byte is noise. best-effort — the peer may be gone.
                self._wire_errors.inc()
                code = (
                    "version_mismatch"
                    if isinstance(exc, wire.VersionMismatch)
                    else "oversized"
                    if isinstance(exc, wire.FrameTooLarge)
                    else "bad_frame"
                )
                await self._send(
                    writer, write_lock, wire.encode_error(code, str(exc))
                )
                return
            if kind != wire.KIND_REQUEST:
                self._wire_errors.inc()
                await self._send(
                    writer, write_lock,
                    wire.encode_error(
                        "bad_frame",
                        f"clients send request frames; got kind {kind}",
                    ),
                )
                return
            await self._handle_request(payload, writer, write_lock, loop)

    async def _handle_request(self, payload, writer, write_lock, loop):
        self._requests.inc()
        # The id is echoed through int() on every reply path
        # (encode_response / encode_error), so a non-integer id must be
        # refused HERE as bad_request — discovering it at respond time
        # would kill the reply task after the request already settled,
        # and the client would never get a frame.
        raw_id = payload.get("id", 0)
        try:
            request_id = int(raw_id)
        except (TypeError, ValueError):
            await self._send(
                writer, write_lock,
                wire.encode_error(
                    "bad_request",
                    f"request id must be an integer; got {raw_id!r}",
                ),
            )
            return
        try:
            market = payload["market"]
            signals = [
                (sid, prob) for sid, prob in payload["signals"]
            ]
            outcome = bool(payload["outcome"])
            qos_class = payload.get("class")
            future = self._service.submit(
                market, signals, outcome, qos_class=qos_class
            )
        except ServeError as exc:
            # Admission said no: an answer on a healthy connection.
            await self._send(
                writer, write_lock, _error_frame_for(exc, request_id)
            )
            return
        except (KeyError, TypeError, ValueError) as exc:
            await self._send(
                writer, write_lock,
                wire.encode_error(
                    "bad_request", repr(exc), request_id=request_id
                ),
            )
            return
        # Pipelining: the reader moves on; this task replies when the
        # settlement resolves. Submission order (= wire arrival order)
        # already fixed the request's place in the batch trace.
        self._track(
            loop.create_task(
                self._respond(future, request_id, writer, write_lock)
            )
        )

    async def _respond(self, future, request_id, writer, write_lock):
        try:
            result = await future
        except asyncio.CancelledError:
            raise
        except BaseException as exc:  # noqa: BLE001 — refusals ride frames
            await self._send(
                writer, write_lock, _error_frame_for(exc, request_id)
            )
            return
        self._responses.inc()
        await self._send(
            writer, write_lock, wire.encode_response(request_id, result)
        )

    async def _send(self, writer, write_lock, frame: bytes) -> None:
        try:
            async with write_lock:
                writer.write(frame)
                await writer.drain()
        except (ConnectionError, OSError):
            pass  # peer gone mid-reply; its future already resolved
        else:
            # Header byte 5 is the kind field (magic 4s, version B, kind B).
            if frame[5] == wire.KIND_ERROR:
                self._errors.inc()
