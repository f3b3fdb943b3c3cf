"""The port's ``parallel/ring.py`` ≡ the JAX package's, on 8 CPU devices.

The same inputs, made with numpy from a seed, go through the JAX
package's ring programs on a mesh of the conftest's 8 host devices and
the port's on a mesh of the same shape whose every device is the CPU:

* ``ring_allreduce`` on (1, 8), (2, 4) and (4, 2): every shard's sum is
  bit-equal to the JAX ring's on that shard (the hop order is matched:
  shard j adds its own value, then the values 1, 2, … hops behind it),
  and within rtol 1e-6 of ``psum`` (the reference's own bound);
* ``build_ring_cycle`` and ``build_ring_cycle_loop`` with ``chunk_slots``
  None, 3 and 8: the state is bit-equal (the update phase is elementwise);
  the consensus, confidence and total weight agree within the reference's
  bound against the psum cycle (``tests/test_ring.py``: rtol 2e-6, atol
  1e-6). They are not bit-equal because the port's local slot sums run in
  ``torch.sum``'s order where XLA's row sums run left to right, and the
  decayed reads carry the reference's ``exp2`` ulps. With one slot a chunk
  and no read decayed, the local sums are added left to right on both
  sides, and the consensus is bit-equal: the ring's hop order, and the
  copy of it the per-market output takes, are the reference's;
* the loop's reduced carry (``exists=None``), zero steps, and a resumed
  loop equal to an uninterrupted one bit for bit;
* ``reshard``: REDUCE → UPDATE → REDUCE round trip, the update layout's
  shard shapes;
* the standalone ring tie-break against ``build_ring_tiebreak`` with
  ``chunk_agents`` None and 3: every field bit-equal; ``"auto"`` and other
  strings refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from bayesian_consensus_engine_tpu.parallel import MarketBlockState as JaxState
from bayesian_consensus_engine_tpu.parallel import make_mesh
from bayesian_consensus_engine_tpu.parallel import ring as jring
from bayesian_consensus_engine_tpu.parallel._jax_compat import shard_map
from bayesian_consensus_engine_tpu_torch.ops.collectives import psum
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
from bayesian_consensus_engine_tpu_torch.parallel import mesh as tmesh
from bayesian_consensus_engine_tpu_torch.parallel import ring as tring

M, K = 32, 16
BOUND = dict(rtol=2e-6, atol=1e-6)
MESHES = [(1, 8), (2, 4), (4, 2)]


def inputs(seed=0, decays=True):
    """(M, K) market-major inputs; without ``decays`` every stamp is 0 or
    ``now``, so no read decays."""
    rng = np.random.default_rng(seed)
    stamps = [0.0, 5.0, 40.0, 400.0] if decays else [0.0, 401.0]
    return dict(
        probs=rng.random((M, K)).astype(np.float32),
        mask=rng.random((M, K)) < 0.7,
        outcome=rng.random(M) < 0.5,
        reliability=rng.uniform(0.1, 1.0, (M, K)).astype(np.float32),
        confidence=rng.uniform(0.0, 1.0, (M, K)).astype(np.float32),
        updated_days=rng.choice(stamps, (M, K)).astype(np.float32),
        exists=rng.random((M, K)) < 0.6,
        now=np.float32(401.0),
    )


def reduced(x):
    """The loop's reduced carry: cold slots at the priors, no exists."""
    x = dict(x)
    x["reliability"] = np.where(x["exists"], x["reliability"], np.float32(0.5))
    x["confidence"] = np.where(x["exists"], x["confidence"], np.float32(0.25))
    x["updated_days"] = np.where(x["exists"], x["updated_days"], np.float32(0.0))
    x["exists"] = None
    return x


FIELDS = ("reliability", "confidence", "updated_days", "exists")


def jax_args(x):
    state = JaxState(*(None if x[f] is None else jnp.asarray(x[f]) for f in FIELDS))
    return (jnp.asarray(x["probs"]), jnp.asarray(x["mask"]),
            jnp.asarray(x["outcome"]), state)


def jax_mesh(shape):
    return make_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])


def port_mesh(shape):
    return tmesh.make_mesh(shape, [torch.device("cpu")] * (shape[0] * shape[1]))


def port_args(x, mesh):
    grids = {f: None if x[f] is None else tmesh.shard_block(x[f], mesh)
             for f in FIELDS}
    state = tuple(
        tuple(
            MarketBlockState(*(None if grids[f] is None else grids[f][i][j]
                               for f in FIELDS))
            for j in range(len(row))
        )
        for i, row in enumerate(mesh.devices)
    )
    return (tmesh.shard_block(x["probs"], mesh), tmesh.shard_block(x["mask"], mesh),
            tmesh.shard_market_vector(x["outcome"], mesh), state)


def global_state(grid):
    """The port's state grid as global (M, K) numpy fields."""
    out = []
    for f in range(4):
        if grid[0][0][f] is None:
            out.append(None)
            continue
        out.append(tmesh.unshard_block(
            tuple(tuple(shard[f] for shard in row) for row in grid)).numpy())
    return out


# -- ring_allreduce -------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=[f"{m}x{s}" for m, s in MESHES])
def test_ring_allreduce_matches_the_jax_ring_on_every_shard(shape):
    m_size, s_size = shape
    rng = np.random.default_rng(1)
    x = rng.random((M, s_size)).astype(np.float32)
    mesh = jax_mesh(shape)
    spec = P("markets", "sources")
    jax_ring = shard_map(
        lambda b: jring.ring_allreduce(b[:, 0], "sources", s_size)[:, None],
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False,
    )
    want = np.asarray(jax_ring(jnp.asarray(x)))  # (M, S): shard j's sum
    rows = M // m_size
    for i in range(m_size):
        pieces = [torch.from_numpy(x[i * rows:(i + 1) * rows, j].copy())
                  for j in range(s_size)]
        got = tring.ring_allreduce(pieces)
        assert len(got) == s_size
        for j in range(s_size):
            np.testing.assert_array_equal(
                got[j].numpy(), want[i * rows:(i + 1) * rows, j])
        np.testing.assert_allclose(got[0].numpy(), psum(pieces, "cpu").numpy(),
                                   rtol=1e-6)
    assert tring.ring_allreduce([torch.tensor([1.5])])[0].item() == 1.5


# -- the ring cycle and loop ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_results():
    """JAX ring programs' outputs per (program, mesh, chunk, case), once."""
    cache = {}

    def get(kind, shape, chunk, case="decays", steps=3):
        key = (kind, shape, chunk, case, steps)
        if key not in cache:
            x = CASES[case]
            probs, mask, outcome, state = jax_args(x)
            mesh = jax_mesh(shape)
            if kind == "cycle":
                out = jring.build_ring_cycle(mesh, chunk_slots=chunk, donate=False)(
                    probs, mask, outcome, state, jnp.float32(x["now"]))
                cache[key] = ([None if f is None else np.asarray(f)
                               for f in out.state],
                              [np.asarray(v) for v in out[1:]])
            else:
                st, cons = jring.build_ring_cycle_loop(
                    mesh, chunk_slots=chunk, donate=False)(
                    probs, mask, outcome, state, jnp.float32(x["now"]), steps)
                cache[key] = ([None if f is None else np.asarray(f) for f in st],
                              [np.asarray(cons)])
        return cache[key]

    return get


CASES = {
    "decays": inputs(0),
    "exact": inputs(3, decays=False),
    "reduced": reduced(inputs(8)),
}
CYCLE_CASES = [(shape, chunk) for shape in MESHES for chunk in (None, 3, 8)]


def run_port(kind, shape, chunk, case="decays", steps=3):
    x = CASES[case]
    mesh = port_mesh(shape)
    probs, mask, outcome, state = port_args(x, mesh)
    if kind == "cycle":
        out = tring.build_ring_cycle(mesh, chunk_slots=chunk)(
            probs, mask, outcome, state, x["now"])
        return global_state(out.state), [v.numpy() for v in out[1:]]
    st, cons = tring.build_ring_cycle_loop(mesh, chunk_slots=chunk)(
        probs, mask, outcome, state, x["now"], steps)
    return global_state(st), [cons.numpy()]


def assert_state_equal(got, want):
    for field, a, b in zip(FIELDS, got, want):
        if b is None:
            assert a is None, field
            continue
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("shape, chunk", CYCLE_CASES,
                         ids=[f"{m}x{s}-chunk{c}" for (m, s), c in CYCLE_CASES])
def test_ring_cycle_matches_jax(jax_results, shape, chunk):
    got_state, got = run_port("cycle", shape, chunk)
    want_state, want = jax_results("cycle", shape, chunk)
    assert_state_equal(got_state, want_state)
    for a, b in zip(got, want):
        assert a.shape == (M,) and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, equal_nan=True, **BOUND)


LOOP_CASES = [((1, 8), None), ((2, 4), 3), ((4, 2), 8), ((2, 4), 5)]


@pytest.mark.parametrize("shape, chunk", LOOP_CASES,
                         ids=[f"{m}x{s}-chunk{c}" for (m, s), c in LOOP_CASES])
def test_ring_loop_matches_jax(jax_results, shape, chunk):
    got_state, (got,) = run_port("loop", shape, chunk)
    want_state, (want,) = jax_results("loop", shape, chunk)
    assert_state_equal(got_state, want_state)
    np.testing.assert_allclose(got, want, equal_nan=True, **BOUND)


@pytest.mark.parametrize("kind", ["cycle", "loop"])
def test_ring_consensus_bit_equal_with_one_slot_a_chunk(jax_results, kind):
    """Local sums left to right on both sides, no read decayed (one step:
    a later step reads the day before's stamps): the consensus is the JAX
    ring's bit for bit on a (2, 4) mesh."""
    got_state, got = run_port(kind, (2, 4), 1, "exact", steps=1)
    want_state, want = jax_results(kind, (2, 4), 1, "exact", steps=1)
    assert_state_equal(got_state, want_state)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_ring_loop_reduced_carry_matches_jax(jax_results):
    got_state, (got,) = run_port("loop", (2, 4), 6, "reduced", steps=2)
    want_state, (want,) = jax_results("loop", (2, 4), 6, "reduced", steps=2)
    assert got_state[3] is None
    assert_state_equal(got_state, want_state)
    np.testing.assert_allclose(got, want, equal_nan=True, **BOUND)


def test_ring_cycle_without_signals_reports_nan():
    x = dict(inputs(4))
    x["mask"] = x["mask"].copy()
    x["mask"][0] = False
    mesh = port_mesh((2, 4))
    out = tring.build_ring_cycle(mesh)(*port_args(x, mesh), x["now"])
    assert np.isnan(out.consensus[0].item()) and out.total_weight[0].item() == 0.0


def test_ring_loop_zero_steps_and_resume():
    x = inputs(10)
    mesh = port_mesh((2, 4))
    loop = tring.build_ring_cycle_loop(mesh, chunk_slots=6)
    probs, mask, outcome, state = port_args(x, mesh)
    same, zeros = loop(probs, mask, outcome, state, 10.0, 0)
    assert_state_equal(global_state(same), global_state(state))
    assert not zeros.any() and zeros.shape == (M,)
    full_state, full = loop(probs, mask, outcome, state, 10.0, 5)
    mid_state, _ = loop(probs, mask, outcome, state, 10.0, 3)
    res_state, res = loop(probs, mask, outcome, mid_state, 13.0, 2)
    np.testing.assert_array_equal(res.numpy(), full.numpy())
    assert_state_equal(global_state(res_state), global_state(full_state))


# -- reshard --------------------------------------------------------------------


def test_reshard_round_trip_and_layouts():
    mesh = port_mesh((2, 4))
    x = torch.from_numpy(np.random.default_rng(3).random((M, K)).astype(np.float32))
    x_reduce = tring.reshard(x, mesh, tring.REDUCE_SPEC)
    assert x_reduce.spec == tring.REDUCE_SPEC
    assert {s.shape for row in x_reduce.shards for s in row} == {(M // 2, K // 4)}
    x_update = tring.reshard(x_reduce, mesh, tring.UPDATE_SPEC)
    assert x_update.spec == tring.UPDATE_SPEC
    assert {s.shape for row in x_update.shards for s in row} == {(M // 8, K)}
    np.testing.assert_array_equal(
        torch.cat([s for row in x_update.shards for s in row]).numpy(), x.numpy())
    back = tring.reshard(x_update, mesh, tring.REDUCE_SPEC)
    np.testing.assert_array_equal(tmesh.unshard_block(back.shards).numpy(),
                                  x.numpy())
    assert tring.reshard(back, mesh, tring.REDUCE_SPEC) is back
    with pytest.raises(ValueError, match="REDUCE_SPEC or UPDATE_SPEC"):
        tring.reshard(x, mesh, ("sources", "markets"))


# -- the standalone ring tie-break ----------------------------------------------


def tiebreak_inputs(seed=5, m=M, a=K):
    rng = np.random.default_rng(seed)
    grid = np.round(np.linspace(0.05, 0.95, 7), 6)
    return (rng.choice(grid, (m, a)).astype(np.float32),
            rng.choice([0.25, 0.5, 1.0, 2.0], (m, a)).astype(np.float32),
            rng.uniform(0, 1, (m, a)).astype(np.float32),
            rng.choice([0.25, 0.5, 0.75], (m, a)).astype(np.float32),
            rng.random((m, a)) < 0.85)


@pytest.mark.parametrize("shape, chunk", [((2, 4), None), ((2, 4), 3), ((1, 8), 3),
                                          ((4, 1), None)])
def test_ring_tiebreak_matches_jax(shape, chunk):
    args = tiebreak_inputs()
    want = jring.build_ring_tiebreak(jax_mesh(shape), chunk_agents=chunk)(
        *(jnp.asarray(a) for a in args))
    mesh = port_mesh(shape)
    got = tring.build_ring_tiebreak(mesh, chunk_agents=chunk)(
        *(tmesh.shard_block(a, mesh) for a in args))
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_ring_tiebreak_chunk_strings():
    mesh = port_mesh((1, 2))
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tring.build_ring_tiebreak(mesh, chunk_agents="auto")
    with pytest.raises(ValueError, match="the only supported string") as ours:
        tring.build_ring_tiebreak(mesh, chunk_agents="fast")
    with pytest.raises(ValueError) as theirs:
        jring.build_ring_tiebreak(jax_mesh((1, 2)), chunk_agents="fast")(
            *(jnp.asarray(a) for a in tiebreak_inputs(m=4, a=4)))
    assert str(ours.value) == str(theirs.value)
