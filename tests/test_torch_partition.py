"""The port's banded halo sweep ≡ the JAX package's ``infer/partition.py``.

The same aligned neighbour blocks and seeds, made with numpy from a seed,
go through ``bayesian_consensus_engine_tpu.infer.partition`` and the
port's ``infer/partition.py`` on the CPU:

* ``partition_csr``'s blocks, halos, routing tables and ``cross_edges``
  are equal array for array, and its ``ValueError``s are raised alike;
* ``exchange_halos`` moves exactly the halo positions, from their owners;
* ``banded_bp_sweep`` is bit-equal to the JAX banded sweep and to the
  port's whole-axis ``bp_sweep`` (means, variances, ``iters_run``,
  residual), on the point and the moments lane, with and without ``tol``,
  at degrees 1 and 3 (one lane fuses the other product of the blend), on
  one, two, three and eight bands.

On the CPU every band step is the sweep kernel's plain version; the card
test of the one-step launch the band step makes is
``tests/test_torch_bp_kernel.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayesian_consensus_engine_tpu.infer import partition as jpartition
from bayesian_consensus_engine_tpu_torch import infer as tinfer
from bayesian_consensus_engine_tpu_torch.infer import partition as tpartition
from bayesian_consensus_engine_tpu_torch.ops import bp_kernel

M = 40
DAMPING = 0.4
STEPS = 24


def graph_blocks(m=M, degree=3, seed=5, edge_p=0.6):
    """Dense per-row neighbour blocks with -1 padding."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, (m, degree)).astype(np.int32)
    idx[rng.random((m, degree)) > edge_p] = -1
    w = rng.uniform(0.2, 1.8, (m, degree)).astype(np.float32)
    return idx, w


def moment_seeds(m=M, seed=6, nan_rows=(3, 17)):
    rng = np.random.default_rng(seed)
    means = rng.random(m).astype(np.float32)
    variances = rng.uniform(1e-4, 0.05, m).astype(np.float32)
    for row in nan_rows:
        means[row] = np.nan
        variances[row] = np.nan
    return means, variances


BANDINGS = {
    "one": [(0, M)],
    "two": [(0, M // 2), (M // 2, M)],
    "three": [(0, 7), (7, 26), (26, M)],
    "eight": [(5 * i, 5 * i + 5) for i in range(8)],
}
JAX_BANDINGS = ("three",)


@pytest.mark.parametrize("banding", sorted(BANDINGS))
@pytest.mark.parametrize("degree", [1, 3])
def test_partition_csr_equals_jax(banding, degree):
    idx, w = graph_blocks(degree=degree)
    ours = tpartition.partition_csr(idx, w, BANDINGS[banding])
    theirs = jpartition.partition_csr(jnp.asarray(idx), jnp.asarray(w),
                                      BANDINGS[banding])
    assert isinstance(ours, tinfer.BandedGraph)
    assert ours.num_markets == theirs.num_markets == M
    assert ours.cross_edges == theirs.cross_edges
    assert len(ours.blocks) == len(theirs.blocks)
    for mine, ref in zip(ours.blocks, theirs.blocks):
        assert (mine.lo, mine.hi) == (ref.lo, ref.hi)
        for name in ("neighbor_idx", "neighbor_w", "halo", "halo_owner",
                     "halo_local"):
            a, b = getattr(mine, name), np.asarray(getattr(ref, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    if banding != "one":
        assert ours.cross_edges > 0


@pytest.mark.parametrize("bands, match", [
    ([(0, 20), (21, M)], "contiguously"),
    ([(0, 20), (20, 20), (20, M)], "contiguously"),
    ([(0, 20)], f"{M} rows"),
])
def test_partition_csr_raises_as_jax(bands, match):
    idx, w = graph_blocks()
    with pytest.raises(ValueError, match=match) as ours:
        tpartition.partition_csr(idx, w, bands)
    with pytest.raises(ValueError) as theirs:
        jpartition.partition_csr(idx, w, bands)
    assert str(ours.value) == str(theirs.value)


def test_exchange_moves_only_halo_positions():
    idx = np.asarray([[1, -1], [2, -1], [0, 3], [-1, -1]], np.int32)
    w = np.ones((4, 2), np.float32)
    banded = tpartition.partition_csr(idx, w, [(0, 2), (2, 4)])
    values = [torch.tensor([0.1, 0.2]), torch.tensor([0.3, 0.4])]
    halos = tinfer.exchange_halos(values, banded)
    assert [h.tolist() for h in halos] == [
        [torch.tensor(0.3).item()], [torch.tensor(0.1).item()]]


def test_exchange_matches_jax_on_every_band():
    idx, w = graph_blocks(seed=11)
    means, _ = moment_seeds(nan_rows=())
    bands = BANDINGS["eight"]
    ours = tinfer.exchange_halos(
        [torch.from_numpy(means[lo:hi]) for lo, hi in bands],
        tpartition.partition_csr(idx, w, bands))
    theirs = jpartition.exchange_halos(
        [jnp.asarray(means[lo:hi]) for lo, hi in bands],
        jpartition.partition_csr(idx, w, bands))
    assert len(ours) == len(theirs) == len(bands)
    for band, (a, b) in enumerate(zip(ours, theirs)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        halo = tpartition.partition_csr(idx, w, bands).blocks[band].halo
        np.testing.assert_array_equal(a.numpy(), means[halo])


SWEEPS = [
    # (lane, tol, degree)
    ("moments", None, 3), ("moments", 1e-5, 3), ("moments", 3e-2, 3),
    ("point", None, 3), ("point", 1e-5, 3),
    ("moments", 1e-4, 1), ("point", None, 1),
]


@pytest.fixture(scope="module")
def whole_axis():
    """Each sweep case's JAX whole-axis reference, computed once."""
    from bayesian_consensus_engine_tpu.ops.propagate import bp_sweep_math

    cache = {}

    def get(lane, tol, degree):
        key = (lane, tol, degree)
        if key not in cache:
            idx, w = graph_blocks(degree=degree)
            means, variances = moment_seeds()
            cache[key] = bp_sweep_math(
                jnp.asarray(means),
                jnp.asarray(variances) if lane == "moments" else None,
                jnp.asarray(idx), jnp.asarray(w),
                damping=DAMPING, max_steps=STEPS, tol=tol,
            )
        return cache[key]

    return get


def _numpy(result):
    mean, var, iters, residual = result
    return (np.asarray(mean), None if var is None else np.asarray(var),
            int(iters), np.asarray(residual))


def _assert_same(got, want):
    mean, var, iters, residual = got
    mean_ref, var_ref, iters_ref, residual_ref = want
    assert mean.dtype == mean_ref.dtype == np.float32
    np.testing.assert_array_equal(mean, mean_ref)
    if var_ref is None:
        assert var is None
    else:
        np.testing.assert_array_equal(var, var_ref)
    assert iters == iters_ref
    assert residual.dtype == np.float32
    np.testing.assert_array_equal(residual, residual_ref)


@pytest.mark.parametrize("banding", sorted(BANDINGS))
@pytest.mark.parametrize("lane, tol, degree", SWEEPS)
def test_banded_sweep_bit_equal_to_jax_and_whole_axis(
    whole_axis, banding, lane, tol, degree,
):
    idx, w = graph_blocks(degree=degree)
    means, variances = moment_seeds()
    moments = lane == "moments"
    bands = BANDINGS[banding]
    ours = _numpy(tinfer.banded_bp_sweep(
        torch.from_numpy(means), torch.from_numpy(variances) if moments else None,
        tpartition.partition_csr(idx, w, bands),
        damping=DAMPING, max_steps=STEPS, tol=tol,
    ))
    port_whole = _numpy(bp_kernel.bp_sweep(
        torch.from_numpy(means), torch.from_numpy(variances) if moments else None,
        torch.from_numpy(idx), torch.from_numpy(w),
        damping=DAMPING, max_steps=STEPS, tol=tol,
    ))
    _assert_same(ours, port_whole)
    _assert_same(ours, _numpy(whole_axis(lane, tol, degree)))
    if banding in JAX_BANDINGS:
        # The JAX banded sweep compiles its band step per band shape, so
        # it runs on one uneven banding only.
        _assert_same(ours, _numpy(jpartition.banded_bp_sweep(
            jnp.asarray(means), jnp.asarray(variances) if moments else None,
            jpartition.partition_csr(idx, w, bands),
            damping=DAMPING, max_steps=STEPS, tol=tol,
        )))
    if tol is not None and tol >= 1e-2:
        assert 1 <= ours[2] < STEPS  # the early exit fired


def test_banded_sweep_zero_steps_returns_the_seeds():
    idx, w = graph_blocks()
    means, variances = moment_seeds()
    mean, var, iters, residual = tinfer.banded_bp_sweep(
        torch.from_numpy(means), torch.from_numpy(variances),
        tpartition.partition_csr(idx, w, BANDINGS["two"]),
        damping=DAMPING, max_steps=0,
    )
    np.testing.assert_array_equal(mean.numpy(), means)
    np.testing.assert_array_equal(var.numpy(), variances)
    assert int(iters) == 0 and float(residual) == 0.0
