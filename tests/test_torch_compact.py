"""The port's counter-compact loop ≡ the JAX package's ``parallel/compact.py``.

The same workloads, made with numpy from a seed, go through the JAX
package's compact programs and the port's on the CPU:

* the counters (int8 reliability steps, uint8 update counts) and the day
  stamps are bit-equal, on the flat loop, on (8, 1) and (2, 4) meshes, in
  both layouts, with float32 and uint16 days;
* the decoded confidence ``1 − 0.75·2^(n·log₂0.9)`` goes through ``exp2``,
  which rounds differently on XLA and the CPU (and the card), so decoded
  states and the consensus are held within rtol 1e-6, atol 1e-6, the
  bound the reference pins between its compact and float32 loops
  (``tests/test_compact.py``); on a sources-sharded mesh the consensus
  sums are also added in the shards' order, within rtol 2e-6, atol 1e-6,
  the reference's mesh bound;
* ``advance_counters`` equals the loop, and the JAX package's closed form;
* ``encode_probs_u16`` is bit-equal to the JAX encoding, and the loop on
  encoded probabilities equals the loop on their decode bit for bit;
* the port's loop is bit-equal whatever its market tiling.

The decayed reads of a narrower shard can differ by ulps on the CPU
(PyTorch's vectorised and scalar ``exp2`` paths), so even on an (8, 1)
mesh the consensus is held to the mesh bound; on the card every element
takes the same path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bayesian_consensus_engine_tpu.parallel import compact as jcompact
from bayesian_consensus_engine_tpu.parallel import make_mesh
from bayesian_consensus_engine_tpu_torch.parallel import compact as tcompact
from bayesian_consensus_engine_tpu_torch.parallel import mesh as tmesh

M, K = 96, 8
DECODE_TOL = dict(rtol=1e-6, atol=1e-6)
MESH_TOL = dict(rtol=2e-6, atol=1e-6)
COUNTERS = ("rel_steps", "conf_steps", "updated_days")


def workload(seed, m=M, k=K, occupancy=0.9):
    rng = np.random.default_rng(seed)
    return (rng.random((k, m)).astype(np.float32), rng.random((k, m)) < occupancy,
            rng.random(m) < 0.5)


def warm_state(seed, m=M, k=K, days=np.float32):
    """A compact state with counters across their range and stamps some
    days before the loop's first day."""
    rng = np.random.default_rng(seed)
    conf = rng.integers(0, 256, (k, m)).astype(np.uint8)
    rel = np.where(conf > 0, rng.integers(-5, 6, (k, m)), 0).astype(np.int8)
    stamps = np.where(conf > 0, rng.choice([3.0, 9.0, 10.0], (k, m)), 0.0)
    return rel, conf, stamps.astype(days)


def jax_state(arrays):
    return jcompact.CompactBlockState(*(jnp.asarray(a) for a in arrays))


def port_state(arrays):
    return tcompact.CompactBlockState(*(torch.from_numpy(np.asarray(a)) for a in arrays))


def as_numpy(state):
    return [np.asarray(x) for x in state]


def assert_counters_equal(got, want):
    for name, a, b in zip(COUNTERS, as_numpy(got), as_numpy(want)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def run_jax(probs, mask, outcome, state, now0, steps, slot_major=True):
    loop = jcompact.build_compact_cycle_loop(
        mesh=None, slot_major=slot_major, donate=False)
    return loop(jnp.asarray(probs), jnp.asarray(mask), jnp.asarray(outcome),
                jax_state(state), jnp.float32(now0), steps)


def run_port(probs, mask, outcome, state, now0, steps, slot_major=True):
    loop = tcompact.build_compact_cycle_loop(slot_major=slot_major)
    probs = probs if isinstance(probs, torch.Tensor) else torch.from_numpy(probs)
    return loop(probs, torch.from_numpy(mask), torch.from_numpy(outcome),
                port_state(state), now0, steps)


# -- decode ---------------------------------------------------------------------


def test_decode_matches_jax_and_the_recurrence():
    cold = tcompact.init_compact_state(4, 2, device="cpu")
    assert cold.rel_steps.dtype == torch.int8
    assert cold.conf_steps.dtype == torch.uint8
    assert torch.all(tcompact.decode_reliability(cold.rel_steps) == 0.5)
    assert torch.all(tcompact.decode_confidence(cold.conf_steps) == 0.25)
    steps = np.arange(-5, 6, dtype=np.int8)
    np.testing.assert_array_equal(
        tcompact.decode_reliability(torch.from_numpy(steps)).numpy(),
        np.asarray(jcompact.decode_reliability(jnp.asarray(steps))))
    counts = np.arange(256, dtype=np.uint8)
    ours = tcompact.decode_confidence(torch.from_numpy(counts)).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jcompact.decode_confidence(jnp.asarray(counts))),
        **DECODE_TOL)
    c = 0.25
    for n in range(1, 60):
        c = min(1.0, c + (1.0 - c) * 0.1)
        assert ours[n] == pytest.approx(c, abs=2e-6), n


def test_init_checks_days_dtype():
    with pytest.raises(ValueError, match="float32 or uint16"):
        tcompact.init_compact_state(4, 2, days_dtype=torch.int32, device="cpu")
    state = tcompact.init_compact_state(4, 2, slot_major=False,
                                        days_dtype=torch.uint16, device="cpu")
    assert state.updated_days.dtype == torch.uint16
    assert state.rel_steps.shape == (4, 2)


# -- the loop against the JAX loop ----------------------------------------------


@pytest.mark.parametrize("steps", [1, 2, 7])
def test_loop_matches_jax(steps):
    probs, mask, outcome = workload(steps)
    state = warm_state(steps)
    want_state, want = run_jax(probs, mask, outcome, state, 11.0, steps)
    got_state, got = run_port(probs, mask, outcome, state, 11.0, steps)
    assert_counters_equal(got_state, want_state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), equal_nan=True,
                               **DECODE_TOL)
    decoded, decoded_ref = (tcompact.compact_to_block(got_state),
                            jcompact.compact_to_block(want_state))
    for name in ("reliability", "confidence"):
        np.testing.assert_allclose(
            getattr(decoded, name).numpy(), np.asarray(getattr(decoded_ref, name)),
            **DECODE_TOL)
    np.testing.assert_array_equal(decoded.exists.numpy(),
                                  np.asarray(decoded_ref.exists))


def test_market_major_layout_matches_slot_major():
    probs, mask, outcome = workload(4)
    state = warm_state(4)
    sm_state, sm = run_port(probs, mask, outcome, state, 11.0, 3)
    mm_state, mm = run_port(probs.T.copy(), mask.T.copy(), outcome,
                            [a.T.copy() for a in state], 11.0, 3, slot_major=False)
    np.testing.assert_array_equal(mm.numpy(), sm.numpy())
    for a, b in zip(mm_state, sm_state):
        np.testing.assert_array_equal(a.numpy().T, b.numpy())


def test_zero_steps_identity():
    probs, mask, outcome = workload(5)
    state = warm_state(5)
    got_state, got = run_port(probs, mask, outcome, state, 11.0, 0)
    assert_counters_equal(got_state, port_state(state))
    assert got.shape == (M,) and not got.any()


def test_tiling_changes_no_bit(monkeypatch):
    """Tiles of 128 markets give the untiled loop's bits, in both layouts
    (the block is a multiple of 128 markets wide, so the CPU's vector and
    scalar ``exp2`` paths see the same runs)."""
    probs, mask, outcome = workload(6, m=384)
    state = warm_state(6, m=384)
    whole_state, whole = run_port(probs, mask, outcome, state, 11.0, 4)
    monkeypatch.setattr(tcompact, "TILE_SLOTS", 128 * K)
    for slot_major in (True, False):
        args = ((probs, mask, state) if slot_major
                else (probs.T.copy(), mask.T.copy(), [a.T.copy() for a in state]))
        tiled_state, tiled = run_port(args[0], args[1], outcome, args[2], 11.0, 4,
                                      slot_major=slot_major)
        np.testing.assert_array_equal(tiled.numpy(), whole.numpy())
        for a, b in zip(tiled_state, whole_state):
            got = a.numpy() if slot_major else a.numpy().T
            np.testing.assert_array_equal(got, b.numpy())


# -- the closed form ------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 4, 9])
def test_advance_counters_equals_the_loop_and_jax(steps):
    probs, mask, outcome = workload(10 + steps)
    state = warm_state(10 + steps)
    loop_state, _ = run_port(probs, mask, outcome, state, 11.0, steps)
    correct = (probs >= 0.5) == outcome[None, :]
    got = tcompact.advance_counters(
        port_state(state), torch.from_numpy(mask), torch.from_numpy(correct),
        steps, 11.0)
    assert_counters_equal(got, loop_state)
    want = jcompact.advance_counters(
        jax_state(state), jnp.asarray(mask), jnp.asarray(correct), steps,
        jnp.float32(11.0))
    assert_counters_equal(got, want)
    assert tcompact.advance_counters(port_state(state), torch.from_numpy(mask),
                                     torch.from_numpy(correct), 0, 11.0) is not None


def test_conf_cap_and_u16_stamp_clip_match_jax():
    probs, mask, outcome = workload(20)
    rel, conf, _ = warm_state(20, days=np.uint16)
    conf = np.full_like(conf, 250)
    state = (rel, conf, np.full(conf.shape, 65530, np.uint16))
    correct = (probs >= 0.5) == outcome[None, :]
    got = tcompact.advance_counters(
        port_state(state), torch.from_numpy(mask), torch.from_numpy(correct),
        9, 65530.0)
    want = jcompact.advance_counters(
        jax_state(state), jnp.asarray(mask), jnp.asarray(correct), 9,
        jnp.float32(65530.0))
    assert_counters_equal(got, want)
    assert got.conf_steps.max().item() == 255
    assert got.updated_days.to(torch.int32).max().item() == 65535


# -- reduced-precision inputs ---------------------------------------------------


def test_u16_encoding_matches_jax_and_decodes_bitwise():
    probs, mask, outcome = workload(3, m=512)
    probs[0, :3] = [-0.25, 1.5, 0.5 / 65535]
    encoded = tcompact.encode_probs_u16(torch.from_numpy(probs))
    assert encoded.dtype == torch.uint16
    np.testing.assert_array_equal(
        encoded.numpy(), np.asarray(jcompact.encode_probs_u16(jnp.asarray(probs))))
    state = warm_state(3, m=512)
    enc_state, enc = run_port(encoded, mask, outcome, state, 11.0, 3)
    ref_state, ref = run_port(tcompact._decode_probs(encoded), mask, outcome,
                              state, 11.0, 3)
    assert enc.dtype == torch.float32
    np.testing.assert_array_equal(enc.numpy(), ref.numpy())
    assert_counters_equal(enc_state, ref_state)


@pytest.mark.parametrize("steps", [1, 5])
def test_u16_days_bit_identical_to_f32_days(steps):
    probs, mask, outcome = workload(30 + steps)
    state32 = warm_state(30 + steps)
    state16 = warm_state(30 + steps, days=np.uint16)
    s32, c32 = run_port(probs, mask, outcome, state32, 11.0, steps)
    s16, c16 = run_port(probs, mask, outcome, state16, 11.0, steps)
    assert s16.updated_days.dtype == torch.uint16
    np.testing.assert_array_equal(c16.numpy(), c32.numpy())
    np.testing.assert_array_equal(s16.updated_days.numpy().astype(np.float32),
                                  s32.updated_days.numpy())
    for a, b in zip(s16[:2], s32[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    want_state, _ = run_jax(probs, mask, outcome, state16, 11.0, steps)
    assert_counters_equal(s16, want_state)


# -- on a mesh ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_mesh_parity(shape):
    probs, mask, outcome = workload(11)
    state = warm_state(11)
    mesh = tmesh.make_mesh(shape, [torch.device("cpu")] * 8)
    grids = [tmesh.shard_slot_block(a, mesh) for a in state]
    state_g = tuple(
        tuple(tcompact.CompactBlockState(*(g[i][j] for g in grids))
              for j in range(shape[1]))
        for i in range(shape[0])
    )
    got_state, got = tcompact.build_compact_cycle_loop(mesh)(
        tmesh.shard_slot_block(probs, mesh), tmesh.shard_slot_block(mask, mesh),
        tmesh.shard_market_vector(outcome, mesh), state_g, 11.0, 3)
    flat_state, flat = run_port(probs, mask, outcome, state, 11.0, 3)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), equal_nan=True, **MESH_TOL)
    for f, name in enumerate(COUNTERS):
        whole = tmesh.unshard_slot_block(
            tuple(tuple(shard[f] for shard in row) for row in got_state)).numpy()
        np.testing.assert_array_equal(whole, flat_state[f].numpy(), err_msg=name)
    # The JAX package's sharded loop on the same mesh.
    jmesh = make_mesh(shape, devices=jax.devices()[:8])
    block = NamedSharding(jmesh, P("sources", "markets"))
    want_state, want = jcompact.build_compact_cycle_loop(jmesh, donate=False)(
        jax.device_put(jnp.asarray(probs), block),
        jax.device_put(jnp.asarray(mask), block),
        jax.device_put(jnp.asarray(outcome), NamedSharding(jmesh, P("markets"))),
        jax.tree.map(lambda x: jax.device_put(x, block), jax_state(state)),
        jnp.float32(11.0), 3)
    assert_counters_equal(flat_state, want_state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), equal_nan=True,
                               **MESH_TOL)
