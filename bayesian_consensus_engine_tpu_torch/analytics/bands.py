"""The analytics options bag — the port of ``analytics/bands.py``'s
:class:`AnalyticsOptions`.

Only the dataclass is ported. ``build_band_program`` and the
``chunk_slots="auto"`` tuner wait for later slices; the session refuses
``tiebreak="sorted"`` with ``NotImplementedError`` rather than ignoring it.
``graph`` (an ``analytics.MarketGraph``), ``inference`` (an
``infer.InferenceOptions``) and ``blocks`` (an ``infer.MarketBlocks``) run
the belief sweep after the settle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from bayesian_consensus_engine_tpu_torch.ops.uncertainty import Z_95


@dataclass(frozen=True)
class AnalyticsOptions:
    """Per-call analytics configuration of the session entry.

    ``chunk_slots``/``chunk_agents`` take an int, ``None`` (unchunked) or
    ``"default"`` (the recorded defaults); no result depends on them.
    ``tiebreak=False`` drops the tie-break stage (its slot returns
    ``None``); ``z`` scales the credible interval (default two-sided 95%);
    ``precision`` is the tie-break's quantisation in decimals.
    ``kernel`` and ``sweep_kernel`` take the JAX package's route names
    (``"xla"``, ``"pallas"``, ``"auto"``); on CUDA every accepted value
    runs the port's one-pass kernel, and every accepted ``sweep_kernel``
    the ``bp_sweep`` kernel. ``graph``, ``inference`` and ``blocks`` are
    typed loosely, as in the JAX package; the session checks them.
    """

    z: float = Z_95
    chunk_slots: "int | str | None" = "default"
    chunk_agents: "int | str | None" = "default"
    graph: Optional[object] = None
    precision: int = 6
    tiebreak: "bool | str" = True
    kernel: str = "xla"
    sweep_kernel: str = "xla"
    inference: Optional[object] = None
    blocks: Optional[object] = None
