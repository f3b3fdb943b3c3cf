"""net/ — the standard-library network front door over the coalescing
service.

The port's copy of the JAX package's ``net`` package, frame for frame:

* :mod:`~.net.wire` — the sans-IO framed codec: length-prefixed frames
  with a versioned header, payload CRC, canonical-JSON payloads and
  explicit error frames.
* :mod:`~.net.server` — :class:`ConsensusServer`: N asyncio acceptor
  tasks over one listening socket, each connection's requests submitted
  in wire arrival order into the one coalescer, responses pipelined back
  by request id.
* :mod:`~.net.client` — :class:`ConsensusClient`: a blocking client for
  tests, load generators and the CLI, raising the same serve-layer
  exceptions as in-process ``submit``.

The same admitted-request trace served over the wire and submitted in
process gives the same results, journal epochs (wall clock masked) and
SQLite bytes, flat and on a resident session.
"""

from bayesian_consensus_engine_tpu_torch.net.client import ConsensusClient
from bayesian_consensus_engine_tpu_torch.net.server import ConsensusServer
from bayesian_consensus_engine_tpu_torch.net.wire import (
    MAX_FRAME_BYTES,
    WIRE_VERSION,
    WireError,
)

__all__ = [
    "ConsensusClient",
    "ConsensusServer",
    "MAX_FRAME_BYTES",
    "WIRE_VERSION",
    "WireError",
]
