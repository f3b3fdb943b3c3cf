"""Length-prefixed wire codec for the network front door: framed
request/response with a versioned header, CRC, and explicit error frames.

The port's copy of the JAX package's ``net/wire.py``: the same frame
layout, kinds, error codes and canonical payload bytes, so a client of
either package talks to a server of the other. The serving byte contract
("same admitted-request trace, same settled bytes") survives a network
hop only if the transport never corrupts a request silently and a
malformed frame never takes the service down. This module is the
sans-IO half of that: bytes in, bytes out, no sockets, shared by the
asyncio server (:mod:`~.net.server`) and the blocking client
(:mod:`~.net.client`).

* **Frame layout** (little-endian): a fixed :data:`HEADER` —
  ``magic(4s) version(B) kind(B) reserved(H) payload_len(I) crc32(I)`` —
  then ``payload_len`` bytes of payload. The CRC covers the payload
  only (the header is checked field by field); a frame whose CRC
  disagrees raises :class:`ChecksumMismatch` and the connection dies.
* **Versioned**: every header carries :data:`WIRE_VERSION`. A peer
  speaking another version gets an explicit ``version_mismatch`` ERROR
  frame and a clean close, never a silent misparse.
* **Bounded**: ``payload_len`` above ``max_frame_bytes`` raises
  :class:`FrameTooLarge` before any allocation.
* **Payloads are canonical JSON** (sorted keys, fixed separators): two
  encoders given the same request produce the same frame bytes.
* **Errors are frames, not disconnects**: admission refusals
  (``overloaded`` with its retry hint, ``shed``), shutdown (``closed``),
  dispatch failures (``failed``) and transport violations
  (``bad_frame``/``version_mismatch``/``oversized``) travel as
  :data:`KIND_ERROR` frames; :func:`raise_error_payload` maps them back
  to the serve-layer exceptions.

Standard library only (``struct``, ``zlib.crc32``, ``json``).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Mapping, Optional, Tuple

#: Bump on any header or payload-schema change; the handshake is the
#: header itself (every frame carries the version).
WIRE_VERSION = 1

MAGIC = b"BCEW"

#: magic(4s) version(B) kind(B) reserved(H) payload_len(I) crc32(I)
HEADER = struct.Struct("<4sBBHII")

#: Frame kinds. Requests flow client → server, responses and errors
#: server → client. The vocabulary is deliberately tiny: everything
#: request-shaped rides in the JSON payload, so new fields never need a
#: new kind.
KIND_REQUEST = 1
KIND_RESPONSE = 2
KIND_ERROR = 3

_KINDS = (KIND_REQUEST, KIND_RESPONSE, KIND_ERROR)

#: Default refusal bound for one frame's payload. A request is one
#: market's signal list — far below this; the bound exists so a hostile
#: (or corrupted) length prefix is refused before allocation.
MAX_FRAME_BYTES = 1 << 20

#: Error payload ``code`` vocabulary (the wire analogue of the SLO
#: outcome vocabulary — every refusal names its policy).
ERROR_CODES = (
    "overloaded",   # admission bound under reject policy; retry_after_s rides
    "shed",         # this request was admitted then shed under overload
    "closed",       # service is draining/closed
    "failed",       # dispatch/journal failure ate the batch
    "bad_request",  # request payload did not validate
    "bad_frame",    # magic/CRC/framing violation — connection closes
    "version_mismatch",  # peer speaks a different WIRE_VERSION
    "oversized",    # payload_len exceeded the server's bound
)


class WireError(ValueError):
    """Base class for framing violations (the connection-fatal tier)."""


class BadMagic(WireError):
    """The stream does not start with a frame (desync or not our peer)."""


class VersionMismatch(WireError):
    def __init__(self, got: int, expected: int = WIRE_VERSION) -> None:
        super().__init__(
            f"wire version mismatch: peer speaks v{got}, this end v{expected}"
        )
        self.got = got
        self.expected = expected


class FrameTooLarge(WireError):
    def __init__(self, length: int, bound: int) -> None:
        super().__init__(
            f"frame payload of {length} bytes exceeds the {bound}-byte bound"
        )
        self.length = length
        self.bound = bound


class ChecksumMismatch(WireError):
    """Payload bytes disagree with the header CRC — torn or corrupted."""


class TruncatedFrame(WireError):
    """The stream ended mid-frame (torn write / peer died mid-send)."""


def encode_frame(kind: int, payload: Mapping[str, object]) -> bytes:
    """One complete frame: header + canonical-JSON payload bytes."""
    if kind not in _KINDS:
        raise ValueError(f"unknown frame kind {kind}")
    body = json.dumps(
        payload, sort_keys=True, separators=(",", ":")
    ).encode("utf-8")
    return HEADER.pack(
        MAGIC, WIRE_VERSION, kind, 0, len(body), zlib.crc32(body)
    ) + body


def decode_header(
    header: bytes, max_frame_bytes: int = MAX_FRAME_BYTES
) -> Tuple[int, int, int]:
    """Validate one header; returns ``(kind, payload_len, crc32)``.

    Raises the specific :class:`WireError` subclass the server turns
    into its explicit error frame: :class:`BadMagic`,
    :class:`VersionMismatch`, :class:`FrameTooLarge`, or a generic
    :class:`WireError` for an unknown kind. Version is checked BEFORE
    the kind — a future version may well add kinds, and the peer
    deserves the precise refusal.
    """
    if len(header) != HEADER.size:
        raise TruncatedFrame(
            f"header is {len(header)} bytes; need {HEADER.size}"
        )
    magic, version, kind, _reserved, length, crc = HEADER.unpack(header)
    if magic != MAGIC:
        raise BadMagic(f"bad frame magic {magic!r}")
    if version != WIRE_VERSION:
        raise VersionMismatch(version)
    if kind not in _KINDS:
        raise WireError(f"unknown frame kind {kind}")
    if length > max_frame_bytes:
        raise FrameTooLarge(length, max_frame_bytes)
    return kind, length, crc


def decode_payload(payload: bytes, crc: int) -> dict:
    """CRC-check and parse one frame's payload bytes."""
    if zlib.crc32(payload) != crc:
        raise ChecksumMismatch(
            "frame payload fails its CRC — torn or corrupted"
        )
    try:
        decoded = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise WireError(f"frame payload is not JSON: {exc}") from exc
    if not isinstance(decoded, dict):
        raise WireError("frame payload must be a JSON object")
    return decoded


# -- request / response / error payload shapes --------------------------------


def encode_request(
    market_id: str,
    signals,
    outcome: bool,
    qos_class: Optional[str] = None,
    request_id: int = 0,
) -> bytes:
    """One submit as a frame. ``signals`` is the serve layer's shape —
    ``(source_id, probability)`` pairs or reference payload dicts —
    normalised here to pairs so the frame bytes are canonical."""
    pairs = []
    for signal in signals:
        if isinstance(signal, Mapping):
            pairs.append(
                [str(signal["sourceId"]), float(signal["probability"])]
            )
        else:
            sid, prob = signal
            pairs.append([str(sid), float(prob)])
    payload = {
        "id": int(request_id),
        "market": str(market_id),
        "signals": pairs,
        "outcome": bool(outcome),
    }
    if qos_class is not None:
        payload["class"] = str(qos_class)
    return encode_frame(KIND_REQUEST, payload)


def encode_response(request_id: int, result) -> bytes:
    """A settled :class:`~.serve.coalesce.ServeResult` as a frame."""
    return encode_frame(
        KIND_RESPONSE,
        {
            "id": int(request_id),
            "market": result.market_id,
            "consensus": result.consensus,
            "batch": result.batch_index,
            "band_lo": result.band_lo,
            "band_hi": result.band_hi,
            "band_stderr": result.band_stderr,
            "propagated": result.propagated,
        },
    )


def encode_error(
    code: str,
    message: str,
    request_id: Optional[int] = None,
    retry_after_s: Optional[float] = None,
    pending: Optional[int] = None,
) -> bytes:
    """An explicit refusal/failure frame (``code`` ∈ :data:`ERROR_CODES`)."""
    if code not in ERROR_CODES:
        raise ValueError(f"error code must be one of {ERROR_CODES}; got {code!r}")
    payload: dict = {"code": code, "message": str(message)}
    if request_id is not None:
        payload["id"] = int(request_id)
    if retry_after_s is not None:
        payload["retry_after_s"] = float(retry_after_s)
    if pending is not None:
        payload["pending"] = int(pending)
    return encode_frame(KIND_ERROR, payload)


def raise_error_payload(payload: Mapping[str, object]) -> None:
    """Lift an ERROR frame back into the serve-layer exception the
    in-process ``submit`` would have raised — the client-side half of
    "the wire adds transport, not semantics". Transport-tier codes
    (``bad_frame``/``version_mismatch``/``oversized``) raise
    :class:`WireError`; unknown codes raise the base
    :class:`~.serve.admission.ServeError` so a newer server never
    crashes an older client with a KeyError.
    """
    from bayesian_consensus_engine_tpu_torch.serve.admission import (
        Overloaded,
        ServeError,
        ServiceClosed,
        ShedError,
    )

    code = payload.get("code")
    message = str(payload.get("message", ""))
    if code == "overloaded":
        raise Overloaded(
            float(payload.get("retry_after_s") or 0.0),
            int(payload.get("pending") or 0),
        )
    if code == "shed":
        raise ShedError(message or "request shed under overload")
    if code == "closed":
        raise ServiceClosed(message or "service closed")
    if code in ("bad_frame", "version_mismatch", "oversized"):
        raise WireError(f"{code}: {message}")
    raise ServeError(f"{code}: {message}")
