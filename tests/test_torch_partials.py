"""The partials kernel's plain version ≡ the JAX package's partials kernel,
and the port's in-process psum ≡ ``jax.lax.psum``.

``onepass_partials_reference`` (the plain version the CUDA kernel is held
against on the card) and ``build_onepass_partials(..., interpret=True)``
take the same float32 shard block: K_loc in {1, 3, 4, 8}, M = 96, steps in
{1, 2, 5}, with cold slots, pad slots (mask false, the cold prior), empty
markets and, in the decaying cases, stamps on and off multiples of the
30-day half-life. State and count are bit-equal; the views and band roots
bit-equal where no read decays and within rtol=1e-6, atol=1e-7 otherwise
(XLA's ``exp2`` is inexact at integers); the raw consensus sums within
rtol=1e-5, atol=1e-6 (the K-sum order differs).

The psum cases find and pin the order of XLA CPU's all-reduce under
``shard_map`` on 4 and 8 devices: the shards added left to right in mesh
order, on values chosen so that any other association changes the bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from bayesian_consensus_engine_tpu.ops.cycle_math import (
    MarketBlockState as JaxState,
)
from bayesian_consensus_engine_tpu.ops.pallas_settle import build_onepass_partials
from bayesian_consensus_engine_tpu_torch.ops import partials_kernel
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
from bayesian_consensus_engine_tpu_torch.ops import collectives

try:
    from jax import shard_map
except ImportError:  # older JAX
    from jax.experimental.shard_map import shard_map

M = 96
NOW0 = 600.0
SUMS_TOL = dict(rtol=1e-5, atol=1e-6)
VIEW_TOL = dict(rtol=1e-6, atol=1e-7)


def shard_case(seed, num_slots, decaying):
    """One shard's (K_loc, M) block. Exact cases stamp every existing row
    at ``now0`` or never, so no read decays."""
    rng = np.random.default_rng(seed)
    shape = (num_slots, M)
    mask = rng.random(shape) < 0.7
    mask[:, ::11] = False  # empty markets
    exists = rng.random(shape) < 0.6
    rel = rng.uniform(0.0, 1.0, shape)
    conf = rng.uniform(0.0, 1.0, shape)
    stamps = ([0.0, NOW0, NOW0 - 30.0, NOW0 - 90.0, 3.0, 35.0, NOW0 + 12.5]
              if decaying else [0.0, NOW0])
    days = rng.choice(stamps, shape)
    # Pad slots of a padded slot axis: last row, mask false, cold prior.
    if num_slots > 1:
        mask[-1], exists[-1], rel[-1], conf[-1], days[-1] = False, False, 0.5, 0.25, 0.0
    f32 = np.float32
    return dict(
        probs=(rng.integers(0, 9, shape) / 8).astype(f32), mask=mask,
        outcome=rng.random(M) < 0.5, rel=rel.astype(f32), conf=conf.astype(f32),
        days=days.astype(f32), exists=exists,
    )


@pytest.fixture(scope="module")
def results():
    cache = {}

    def run(num_slots, steps, decaying):
        key = (num_slots, steps, decaying)
        if key not in cache:
            case = shard_case(num_slots * 10 + steps, num_slots, decaying)
            partials = build_onepass_partials(M, num_slots, steps, interpret=True)
            want = partials(
                jnp.asarray(case["probs"]), jnp.asarray(case["mask"]),
                jnp.asarray(case["outcome"]),
                JaxState(*(jnp.asarray(case[k])
                           for k in ("rel", "conf", "days", "exists"))),
                jnp.float32(NOW0),
            )
            state = MarketBlockState(*(torch.tensor(case[k])
                                       for k in ("rel", "conf", "days", "exists")))
            got = partials_kernel.onepass_partials(
                torch.tensor(case["probs"]), torch.tensor(case["mask"]),
                torch.tensor(case["outcome"]), state, NOW0, steps,
            )
            cache[key] = (got, [np.asarray(x) if not isinstance(x, tuple)
                                else tuple(np.asarray(y) for y in x)
                                for x in want])
        return cache[key]

    return run


CASES = [(1, 1, False), (3, 2, False), (4, 5, False), (8, 2, False),
         (3, 2, True), (4, 5, True), (8, 1, True)]
IDS = [f"K{k}-steps{s}-{'decaying' if d else 'exact'}" for k, s, d in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_state_and_count_bit_equal(results, case):
    got, (state, _csums, _bsums, count, _rr, _rc) = results(*case)
    for field, ours, theirs in zip(MarketBlockState._fields, got.state, state):
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=field)
        assert ours.numpy().dtype == theirs.dtype, field
    np.testing.assert_array_equal(got.band_count.numpy(), count)
    assert got.band_count.dtype == torch.int32


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_views_and_band_roots(results, case):
    got, (_state, _csums, bsums, _count, read_rel, read_conf) = results(*case)
    pairs = [("band roots", got.band_sums, bsums),
             ("read_rel", got.read_rel, read_rel),
             ("read_conf", got.read_conf, read_conf)]
    for what, ours, theirs in pairs:
        ours = ours.numpy()
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, what
        if case[2]:
            np.testing.assert_allclose(ours, theirs, err_msg=what, **VIEW_TOL)
        else:
            np.testing.assert_array_equal(ours, theirs, err_msg=what)
    # The confidence view never decays.
    np.testing.assert_array_equal(got.read_conf.numpy(), read_conf)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_consensus_sums_within_tolerance(results, case):
    got, (_state, csums, *_rest) = results(*case)
    ours = got.consensus_sums.numpy()
    assert ours.shape == csums.shape == (3, M) and ours.dtype == csums.dtype
    np.testing.assert_allclose(ours, csums, **SUMS_TOL)


def test_stages_off_and_zero_steps():
    """The stage flags only drop outputs; zero steps leave the state and
    give zero sums, views and band roots of the unchanged state."""
    case = shard_case(5, 4, True)

    def args():
        return (torch.tensor(case["probs"]), torch.tensor(case["mask"]),
                torch.tensor(case["outcome"]),
                MarketBlockState(*(torch.tensor(case[k])
                                   for k in ("rel", "conf", "days", "exists"))))

    full = partials_kernel.onepass_partials(*args(), NOW0, 3)
    bare = partials_kernel.onepass_partials(
        *args(), NOW0, 3, with_views=False, with_bands=False)
    assert bare.read_rel is None and bare.band_sums is None
    for ours, theirs in zip(bare.state, full.state):
        assert torch.equal(ours, theirs)
    assert torch.equal(bare.consensus_sums, full.consensus_sums)
    zero = partials_kernel.onepass_partials(*args(), NOW0, 0)
    for ours, theirs in zip(zero.state, args()[3]):
        assert torch.equal(ours, theirs)
    assert not torch.any(zero.consensus_sums)
    for ours, theirs in zip((zero.read_rel, zero.read_conf, zero.band_sums,
                             zero.band_count),
                            (full.read_rel, full.read_conf, full.band_sums,
                             full.band_count)):
        assert torch.equal(ours, theirs)


def test_bound_bytes_counts_each_byte_once():
    # f32, 2 slots x 3 markets; 4 masked slots, 3 of them existing; 5
    # existing slots in all.
    mask, markets = 2 * 3, 3
    sums, bands = markets * 3 * 4, markets * 5 * 4
    probs = 4 * 4
    views = 2 * 3 + 5 * 3 * 4 + 2 * 2 * 3 * 4  # exists, state, views out
    writes = markets + 4 * 3 * 4 + 1  # outcome; rel, conf, stamp; one turns on
    assert partials_kernel.bound_bytes(2, 3, 4, 3, 5, 20, 4) == (
        mask + sums + probs + views + writes + bands)
    # Views off: masked slots' exists bytes, existing masked slots' rel,
    # conf and (for the bands) stamp.
    assert partials_kernel.bound_bytes(
        2, 3, 4, 3, 5, 20, 4, with_views=False,
    ) == mask + sums + probs + 4 + 3 * 3 * 4 + writes + bands
    # Stages off, steps > 1: no stamp is read.
    assert partials_kernel.bound_bytes(
        2, 3, 4, 3, 5, 20, 4, with_views=False, with_bands=False,
    ) == mask + sums + probs + 4 + 3 * 2 * 4 + writes
    # Zero steps: nothing of the state is written, the outcome not read.
    assert partials_kernel.bound_bytes(2, 3, 4, 3, 5, 0, 4) == (
        mask + sums + probs + views + bands)


# -- the psum order ------------------------------------------------------------


def _shards(num_shards, seed):
    """Per-shard f32 vectors of mixed magnitudes: adding them in any other
    association than left to right changes some bits."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(-4, 5, (num_shards, 512))
    return (rng.standard_normal((num_shards, 512)) * scale).astype(np.float32)


def _other_orders(x):
    """The sums of the shards in a reversed and a pairwise-tree order."""
    reverse = x[-1].copy()
    for row in x[-2::-1]:
        reverse = reverse + row
    level = list(x)
    while len(level) > 1:
        level = [level[i] + level[i + 1] for i in range(0, len(level), 2)]
    return reverse, level[0]


@pytest.mark.parametrize("shape", [(1, 4), (2, 4), (1, 8)])
def test_psum_order_matches_xla(shape):
    markets, sources = shape
    x = _shards(sources, sources * 10 + markets)
    devices = np.asarray(jax.devices()[: markets * sources]).reshape(shape)
    mesh = Mesh(devices, ("markets", "sources"))
    fn = jax.jit(shard_map(
        lambda a: jax.lax.psum(a, "sources"), mesh=mesh,
        in_specs=P("sources", "markets"), out_specs=P("sources", "markets"),
    ))
    out = np.asarray(fn(np.tile(x, (1, markets)))).reshape(sources, markets, -1)
    want = out[0, 0]
    for d in range(sources):  # every shard holds the same bits
        for m in range(markets):
            np.testing.assert_array_equal(out[d, m], want)
    got = collectives.psum([torch.tensor(row) for row in x], "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    # The values do tell the orders apart.
    for other in _other_orders(x):
        assert not np.array_equal(other, want)


def test_all_gather_stacks_in_mesh_order_without_changing_bits():
    x = _shards(4, 3)
    pieces = [torch.tensor(row) for row in x]
    gathered = collectives.all_gather(pieces, "cpu")
    assert gathered.shape == (4, 512)
    np.testing.assert_array_equal(gathered.numpy().view(np.uint32),
                                  x.view(np.uint32))
