"""The port's standalone band program ≡ the JAX package's.

``analytics.build_band_program(mesh, chunk_slots=...)`` against the
reference's on (1, 1) and (1, 4) meshes (the JAX side on that many of
conftest's CPU devices, the port on a grid of the CPU), at ``chunk_slots``
None, 2 and 4, over a seeded slot-major state block with cold slots, pad
slots and empty markets:

* every ``UncertaintyBands`` field bit-equal where no read decays (every
  stamp is ``now`` or never), and within rtol 1e-5, atol 1e-3 with equal
  counts where reads decay (``exp2`` differs by ulps between XLA and
  PyTorch, as the port states);
* the state grid is left exactly as it was (the program never owns it);
* a state whose ``exists`` is ``None`` reads as the JAX program reads it;
* run on a resident session's own block, state and read day, it gives the
  bands ``settle_with_analytics`` returns from that block, bit for bit;
* ``chunk_slots="auto"`` raises ``NotImplementedError`` citing ROADMAP
  queue 1 item 10, another string the reference's ``ValueError``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu.analytics.bands import (
    build_band_program as jax_band_program,
)
from bayesian_consensus_engine_tpu.parallel import mesh as jmesh
from bayesian_consensus_engine_tpu.parallel.sharded import (
    MarketBlockState as JaxState,
)
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.analytics import (
    AnalyticsOptions,
    build_band_program,
)
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
from bayesian_consensus_engine_tpu_torch.parallel import mesh as tmesh

from test_torch_session import Side, make_payloads

K, M = 8, 24
NOW = 400.0
BAND_TOL = dict(rtol=1e-5, atol=1e-3)


def block(decayed, seed=5):
    """Slot-major (K, M) probs, mask and state fields (numpy): a fifth of
    the slots cold, markets 0 and 7 without a signal, stamps at ``NOW``
    or never (exact) or up to 90 days earlier (decayed)."""
    rng = np.random.default_rng(seed)
    probs = rng.random((K, M)).astype(np.float32)
    mask = rng.random((K, M)) < 0.75
    mask[:, [0, 7]] = False
    exists = rng.random((K, M)) < 0.8
    if decayed:
        days = np.float32(NOW) - rng.integers(0, 90, (K, M)).astype(np.float32)
    else:
        days = np.where(rng.random((K, M)) < 0.7, NOW, 0.0).astype(np.float32)
    rel = rng.uniform(0.05, 1.0, (K, M)).astype(np.float32)
    conf = rng.random((K, M)).astype(np.float32)
    return probs, mask, (rel, conf, days, exists)


def jax_bands(shape, chunk, probs, mask, fields, with_exists=True):
    mesh = jmesh.make_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])
    state = JaxState(*(jnp.asarray(x) for x in fields[:3]),
                     jnp.asarray(fields[3]) if with_exists else None)
    out = jax_band_program(mesh, chunk_slots=chunk)(
        jnp.asarray(probs), jnp.asarray(mask), state, jnp.float32(NOW)
    )
    return {name: np.asarray(x) for name, x in zip(out._fields, out)}


def port_grid(shape):
    mesh = tmesh.make_mesh(shape, [torch.device("cpu")] * (shape[0] * shape[1]))
    return mesh, lambda x: tmesh.shard_slot_block(x, mesh)


def port_state(cut, fields, with_exists=True):
    rel, conf, days, exists = (cut(x) for x in fields)
    return tuple(
        tuple(
            MarketBlockState(rel[i][j], conf[i][j], days[i][j],
                             exists[i][j] if with_exists else None)
            for j in range(len(rel[i]))
        )
        for i in range(len(rel))
    )


def port_bands(shape, chunk, probs, mask, fields, with_exists=True):
    mesh, cut = port_grid(shape)
    state = port_state(cut, fields, with_exists)
    before = [[tuple(x.clone() for x in shard if x is not None)
               for shard in row] for row in state]
    out = build_band_program(mesh, chunk_slots=chunk)(
        cut(probs), cut(mask), state, NOW
    )
    for row, kept in zip(state, before):
        for shard, fields_before in zip(row, kept):
            for now_, then in zip([x for x in shard if x is not None],
                                  fields_before):
                assert torch.equal(now_, then), "the program wrote the state"
    return {name: x.numpy() for name, x in zip(out._fields, out)}


def assert_bands_match(ours, theirs, decayed):
    assert ours.keys() == theirs.keys()
    for name in theirs:
        assert ours[name].dtype == theirs[name].dtype, name
        if not decayed or name == "count":
            np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
        else:
            np.testing.assert_allclose(ours[name], theirs[name], equal_nan=True,
                                       err_msg=name, **BAND_TOL)


@pytest.mark.parametrize("chunk", [None, 2, 4])
@pytest.mark.parametrize("shape", [(1, 1), (1, 4)], ids=["1x1", "1x4"])
@pytest.mark.parametrize("decayed", [False, True], ids=["exact", "decayed"])
def test_band_program_matches_jax(shape, chunk, decayed):
    probs, mask, fields = block(decayed)
    assert_bands_match(port_bands(shape, chunk, probs, mask, fields),
                       jax_bands(shape, chunk, probs, mask, fields), decayed)


def test_state_without_exists_matches_jax():
    probs, mask, fields = block(False, seed=6)
    # exists=None promises cold slots already hold the prior.
    fields = (np.where(fields[3], fields[0], 0.5).astype(np.float32),
              *fields[1:])
    assert_bands_match(
        port_bands((1, 4), None, probs, mask, fields, with_exists=False),
        jax_bands((1, 4), None, probs, mask, fields, with_exists=False),
        False,
    )


@pytest.mark.parametrize("shape", [(1, 1), (1, 4)], ids=["1x1", "1x4"])
def test_band_program_equals_the_session_bands(shape):
    """On a live session's block, state and read day, the standalone
    program gives the bands the fused call computes from them."""
    payloads, outcomes = make_payloads(3)
    store = Side("torch", "f32").store(payloads, ("2024-08-01T00:00:00+00:00",))
    plan = tpipe.build_settlement_plan(store, payloads)
    mesh, _cut = port_grid(shape)
    now = 20010.5
    with tpipe.ShardedSettlementSession(store, plan, mesh) as session:
        session.settle(outcomes, steps=2, now=now - 30.0)
        state = tuple(tuple(MarketBlockState(*(x.clone() for x in shard))
                            for shard in row) for row in session._state)
        program = build_band_program(mesh)
        want = program(session._probs_g, session._mask_g, state,
                       session._now0(now))
        _result, _tb, bands, _ = session.settle_with_analytics(
            outcomes, steps=2, now=now, analytics=AnalyticsOptions(chunk_slots=None),
        )
    live = plan.num_markets
    for name, got in zip(bands._fields, bands):
        np.testing.assert_array_equal(np.asarray(got),
                                      getattr(want, name)[:live].numpy(),
                                      err_msg=name)


def test_chunk_slots_strings():
    probs, mask, fields = block(False)
    mesh, cut = port_grid((1, 1))
    state = port_state(cut, fields)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        build_band_program(mesh, chunk_slots="auto")(cut(probs), cut(mask),
                                                     state, NOW)
    with pytest.raises(ValueError, match="auto"):
        build_band_program(mesh, chunk_slots="wide")(cut(probs), cut(mask),
                                                     state, NOW)
