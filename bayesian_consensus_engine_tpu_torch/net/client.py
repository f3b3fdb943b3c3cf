"""Blocking client for the network front door.

The port's copy of the JAX package's ``net/client.py``.
:class:`ConsensusClient` speaks the :mod:`~.net.wire` protocol over one
TCP connection with plain blocking sockets (load generators are
threads, tests are synchronous, the CLI is a script). Two calling
shapes:

* :meth:`submit` — one request, wait for its frame: the closed-loop
  client. Raises what in-process ``submit`` would have raised
  (:class:`~.serve.admission.Overloaded` with its retry hint,
  :class:`~.serve.admission.ShedError`,
  :class:`~.serve.admission.ServiceClosed`).
* :meth:`submit_pipelined` — send a whole request list back to back,
  then collect the responses: the trace driver. Responses arrive in
  completion order and are matched by request id; the list returned is
  in request order, each slot a :class:`~.serve.coalesce.ServeResult` or
  the mapped exception instance.

Framing violations from the server arrive as error frames and raise
:class:`~.net.wire.WireError`; a connection that dies mid-frame raises
:class:`~.net.wire.TruncatedFrame`.
"""

from __future__ import annotations

import socket
from typing import Dict, List, Optional, Sequence, Union

from bayesian_consensus_engine_tpu_torch.net import wire
from bayesian_consensus_engine_tpu_torch.serve.coalesce import ServeResult


def _result_from_payload(payload) -> ServeResult:
    return ServeResult(
        market_id=payload["market"],
        consensus=float(payload["consensus"]),
        batch_index=int(payload["batch"]),
        band_lo=payload.get("band_lo"),
        band_hi=payload.get("band_hi"),
        band_stderr=payload.get("band_stderr"),
        propagated=payload.get("propagated"),
    )


class ConsensusClient:
    """One blocking connection to a :class:`~.net.server.ConsensusServer`.

    ``timeout`` bounds every socket operation (None blocks forever —
    fine for tests, unkind in production loops). Use as a context
    manager or call :meth:`close`.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        timeout: Optional[float] = 30.0,
        max_frame_bytes: int = wire.MAX_FRAME_BYTES,
    ) -> None:
        self._max_frame_bytes = int(max_frame_bytes)
        self._next_id = 0
        self._sock = socket.create_connection((host, port), timeout=timeout)
        # One request is tiny; batching happens server-side in the
        # coalescer, so trade throughput for latency on the socket.
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    # -- raw frame IO (also used by the robustness tests) --------------------

    def _recv_exactly(self, n: int) -> bytes:
        chunks = []
        remaining = n
        while remaining:
            chunk = self._sock.recv(remaining)
            if not chunk:
                raise wire.TruncatedFrame(
                    f"connection closed {remaining} bytes short of a frame"
                )
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def send_frame(self, frame: bytes) -> None:
        self._sock.sendall(frame)

    def read_frame(self):
        """One ``(kind, payload)`` off the wire; raises on violations."""
        kind, length, crc = wire.decode_header(
            self._recv_exactly(wire.HEADER.size), self._max_frame_bytes
        )
        return kind, wire.decode_payload(self._recv_exactly(length), crc)

    # -- request/response ----------------------------------------------------

    def submit(
        self,
        market_id: str,
        signals: Sequence,
        outcome: bool,
        qos_class: Optional[str] = None,
    ) -> ServeResult:
        """One request, one settled result — or the mapped refusal."""
        (result,) = self.submit_pipelined(
            [(market_id, signals, outcome)], qos_class=qos_class,
            return_exceptions=False,
        )
        return result

    def submit_pipelined(
        self,
        requests: Sequence,
        qos_class: Optional[str] = None,
        return_exceptions: bool = True,
    ) -> List[Union[ServeResult, BaseException]]:
        """Send every ``(market_id, signals, outcome)`` (or 4-tuple with
        a per-request class overriding *qos_class*) back to back, then
        collect all responses. Returns request-ordered results; with
        ``return_exceptions=False`` the first refusal raises instead."""
        ids: List[int] = []
        for request in requests:
            if len(request) == 4:
                market_id, signals, outcome, cls = request
            else:
                market_id, signals, outcome = request
                cls = qos_class
            request_id = self._next_id
            self._next_id += 1
            ids.append(request_id)
            self.send_frame(
                wire.encode_request(
                    market_id, signals, outcome,
                    qos_class=cls, request_id=request_id,
                )
            )
        by_id: Dict[int, Union[ServeResult, BaseException]] = {}
        want = set(ids)
        while want:
            kind, payload = self.read_frame()
            request_id = payload.get("id")
            if kind == wire.KIND_RESPONSE:
                outcome_value: Union[ServeResult, BaseException] = (
                    _result_from_payload(payload)
                )
            elif kind == wire.KIND_ERROR:
                try:
                    wire.raise_error_payload(payload)
                except BaseException as exc:  # noqa: BLE001 — data here
                    outcome_value = exc
                if request_id is None:
                    # A connection-scoped error frame (framing violation):
                    # nothing request-shaped is coming after it.
                    raise outcome_value
            else:
                raise wire.WireError(
                    f"unexpected frame kind {kind} from server"
                )
            if request_id in want:
                want.discard(request_id)
                by_id[request_id] = outcome_value
        ordered = [by_id[i] for i in ids]
        if not return_exceptions:
            for value in ordered:
                if isinstance(value, BaseException):
                    raise value
        return ordered

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ConsensusClient":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()
