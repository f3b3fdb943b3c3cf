"""The port's tie-break and band math ≡ the JAX package's, on the CPU.

The same slot-major (K, M) blocks, made with numpy from a seed, go through
``read_phase`` → ``ring_tiebreak_math`` / ``band_sums`` / ``band_epilogue``
/ ``band_math`` of both packages (the JAX side jitted, as the fused program
runs it, with ``axis_name=None``). Workloads are those of
``tests/test_pallas_settle.py``: random, mask_holes, single_agent and
all_tied, at K in {1, 5, 16}.

* On **exact-decay** inputs — no read decays (every row is cold, never
  stamped, or stamped at ``now``) and every probability lies on a 1/8
  grid — every field is bit-equal. A whole multiple of the 30-day
  half-life is not enough: XLA's CPU backend rewrites ``-t / 30`` into
  ``-t · (1/30)`` and its ``exp2`` is not exact even at integers
  (``exp2(-1) != 0.5``), so the reference's decayed weights carry last-ulp
  noise that PyTorch's correctly rounded ``exp2`` does not reproduce.
* Otherwise (stamps 1, 30 and 396 days back, probabilities anywhere) the
  decayed weights may differ by an ulp: the continuous fields
  agree within rtol=1e-5, atol=1e-6 (the bands' stderr, lo and hi within
  5e-4, 1e-3 and 1e-3 absolute, see ``BAND_ATOL``), and the discrete ones (prediction,
  resolved_by) are equal wherever the JAX top-two densities are more than
  that tolerance apart; ``num_groups`` and the band count are always equal.

Output dtypes equal the JAX ones. Each block's JAX results are computed
once per module, all chunk settings in one compiled program per K.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu.ops.cycle_math import (
    MarketBlockState as JaxState,
    read_phase as jax_read_phase,
)
from bayesian_consensus_engine_tpu.ops import tiebreak as jtb
from bayesian_consensus_engine_tpu.ops import uncertainty as junc
from bayesian_consensus_engine_tpu_torch.convert import block_state_from_numpy
from bayesian_consensus_engine_tpu_torch.ops import fma as tfma
from bayesian_consensus_engine_tpu_torch.ops import tiebreak as ttb
from bayesian_consensus_engine_tpu_torch.ops import uncertainty as tunc
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import read_phase

M = 64
NOW = 401.0
RTOL, ATOL = 1e-5, 1e-6
# The band variance is E[p²] − E[p]², which cancels where the signals
# agree: an ulp of the sums (~6e-8) becomes up to sqrt(4·6e-8) ≈ 5e-4 of
# stderr, and z = 1.96 times that of lo and hi.
BAND_ATOL = {"stderr": 5e-4, "lo": 1e-3, "hi": 1e-3}
WORKLOADS = ("random", "mask_holes", "single_agent", "all_tied")
SLOTS = (1, 5, 16)
CHUNK_AGENTS = (None, 3, 1024)
CHUNK_SLOTS = (None, 1, 4, 3)
DISCRETE = ("prediction", "resolved_by")


def make_block(workload, num_slots, exact, seed=0):
    """numpy operands of one block: (probs, valid, rel, conf, days, exists)."""
    rng = np.random.default_rng(seed + 7 * num_slots)
    shape = (num_slots, M)
    probs = rng.random(shape)
    valid = rng.random(shape) < 0.8
    if workload == "mask_holes":
        valid = rng.random(shape) < 0.5
        valid[:, 0] = False  # a market with no signalling slot
    elif workload == "single_agent":
        valid = np.zeros(shape, dtype=bool)
        valid[rng.integers(0, num_slots, M), np.arange(M)] = True
    elif workload == "all_tied":
        probs = np.full(shape, 0.625)
        valid = np.ones(shape, dtype=bool)
    if exact:
        probs = np.round(probs * 8) / 8
        stamps = [0.0, NOW]
    else:
        stamps = [0.0, 5.0, NOW - 30.0, 400.0]
    return (
        probs.astype(np.float32),
        valid,
        rng.uniform(0.1, 1.0, shape).astype(np.float32),
        rng.uniform(0.0, 1.0, shape).astype(np.float32),
        rng.choice(stamps, shape).astype(np.float32),
        rng.random(shape) < 0.6,
    )


@jax.jit
def _jax_analytics(probs, valid, rel, conf, days, exists):
    read_rel, read_conf = jax_read_phase(
        JaxState(rel, conf, days, exists), jnp.float32(NOW)
    )
    out = {"read_rel": read_rel}
    for chunk in CHUNK_AGENTS:
        out[f"tb-{chunk}"] = jtb.ring_tiebreak_math(
            probs, read_rel, read_conf, read_rel, valid,
            axis_name=None, axis_size=1, chunk_agents=chunk,
            agents_last=False,
        )
    out["tb-rows"] = jtb.ring_tiebreak_math(
        probs.T, read_rel.T, read_conf.T, read_rel.T, valid.T,
        axis_name=None, axis_size=1, chunk_agents=3, agents_last=True,
    )
    for chunk in CHUNK_SLOTS:
        out[f"sums-{chunk}"] = junc.band_sums(
            probs, valid, read_rel, axis_name=None, axis_size=1,
            chunk_slots=chunk, agents_last=False,
        )
    out["epilogue"] = junc.band_epilogue(*out["sums-None"])
    out["math"] = junc.band_math(
        probs, valid, read_rel, axis_name=None, axis_size=1,
        chunk_slots=4, agents_last=False,
    )
    return out


def _torch_analytics(block):
    probs, valid, rel, conf, days, exists = block
    state = block_state_from_numpy(rel, conf, days, exists, device="cpu")
    probs, valid = torch.from_numpy(probs), torch.from_numpy(valid)
    read_rel, read_conf = read_phase(state, torch.tensor(NOW))
    out = {"read_rel": (read_rel,)}
    for chunk in CHUNK_AGENTS:
        out[f"tb-{chunk}"] = ttb.ring_tiebreak_math(
            probs, read_rel, read_conf, read_rel, valid,
            chunk_agents=chunk, agents_last=False,
        )
    out["tb-rows"] = ttb.ring_tiebreak_math(
        probs.T, read_rel.T, read_conf.T, read_rel.T, valid.T,
        chunk_agents=3, agents_last=True,
    )
    for chunk in CHUNK_SLOTS:
        out[f"sums-{chunk}"] = tunc.band_sums(
            probs, valid, read_rel, chunk_slots=chunk, agents_last=False,
        )
    out["epilogue"] = tunc.band_epilogue(*out["sums-None"])
    out["math"] = tunc.band_math(
        probs, valid, read_rel, chunk_slots=4, agents_last=False,
    )
    return out


@pytest.fixture(scope="module")
def results():
    """(jax, torch) outputs per (workload, K, exact), computed once."""
    cache = {}

    def get(workload, num_slots, exact):
        key = (workload, num_slots, exact)
        if key not in cache:
            block = make_block(workload, num_slots, exact)
            theirs = jax.tree.map(np.asarray, _jax_analytics(*block))
            ours = {
                name: tuple(x.numpy() for x in value)
                for name, value in _torch_analytics(block).items()
            }
            ours["read_rel"] = ours["read_rel"][0]
            cache[key] = (theirs, ours)
        return cache[key]

    return get


def _assert_fields(theirs, ours, fields, exact, decisive=None):
    for name, want, got in zip(fields, theirs, ours):
        want, got = np.asarray(want), np.asarray(got)
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        if exact or want.dtype.kind == "i" and name != "resolved_by":
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name in DISCRETE:
            np.testing.assert_array_equal(got[decisive], want[decisive], err_msg=name)
        else:
            np.testing.assert_allclose(
                got, want, rtol=RTOL, atol=BAND_ATOL.get(name, ATOL),
                equal_nan=True, err_msg=name,
            )


def _decisive(probs, valid, read_rel):
    """Markets whose top two groups' densities (from the JAX read weights)
    are more than the tolerance apart, or that have fewer than two
    groups: there a last-ulp difference cannot change the winner."""
    keys = np.round(probs.astype(np.float32) * np.float32(1e6))
    decisive = np.ones(probs.shape[1], dtype=bool)
    for m in range(probs.shape[1]):
        members = valid[:, m]
        densities = sorted(
            (float(np.mean(read_rel[members & (keys[:, m] == key), m]))
             for key in np.unique(keys[members, m])),
            reverse=True,
        )
        if len(densities) > 1:
            gap = densities[0] - densities[1]
            decisive[m] = gap > ATOL + RTOL * abs(densities[0])
    return decisive


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "decayed"])
@pytest.mark.parametrize("chunk", CHUNK_AGENTS + ("rows",))
@pytest.mark.parametrize("num_slots", SLOTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_ring_tiebreak_matches_jax(results, workload, num_slots, chunk, exact):
    theirs, ours = results(workload, num_slots, exact)
    probs, valid = make_block(workload, num_slots, exact)[:2]
    decisive = _decisive(probs, valid, theirs["read_rel"])
    _assert_fields(theirs[f"tb-{chunk}"], ours[f"tb-{chunk}"],
                   jtb.RingTieBreakResult._fields, exact, decisive=decisive)
    if exact:
        np.testing.assert_array_equal(ours["read_rel"], theirs["read_rel"])


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "decayed"])
@pytest.mark.parametrize("chunk", CHUNK_SLOTS)
@pytest.mark.parametrize("num_slots", SLOTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_band_sums_match_jax(results, workload, num_slots, chunk, exact):
    theirs, ours = results(workload, num_slots, exact)
    _assert_fields(theirs[f"sums-{chunk}"], ours[f"sums-{chunk}"],
                   ("sums", "count"), exact)
    # Every chunk setting gives the unchunked bits, in both packages.
    for side in (ours, theirs):
        np.testing.assert_array_equal(side[f"sums-{chunk}"][0], side["sums-None"][0])


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "decayed"])
@pytest.mark.parametrize("stage", ["epilogue", "math"])
@pytest.mark.parametrize("num_slots", SLOTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_band_epilogue_matches_jax(results, workload, num_slots, stage, exact):
    theirs, ours = results(workload, num_slots, exact)
    _assert_fields(theirs[stage], ours[stage], junc.UncertaintyBands._fields,
                   exact)


def test_tiebreak_of_empty_market():
    """No valid agent: prediction inf, -inf group metrics, 0 groups,
    variance 0, unanimous — as the JAX package reports it."""
    zeros = torch.zeros((4, 3))
    result = ttb.ring_tiebreak_math(
        zeros, zeros, zeros, zeros, torch.zeros((4, 3), dtype=torch.bool),
        agents_last=False,
    )
    assert torch.all(result.prediction == torch.inf)
    assert torch.all(result.weight_density == -torch.inf)
    assert torch.all(result.max_reliability == -torch.inf)
    assert torch.all(result.num_groups == 0)
    assert torch.all(result.resolved_by == 0)
    assert torch.all(result.confidence_variance == 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fma_rounds_once(dtype):
    """``fma`` is the correctly rounded a + b·c (checked against exact
    rational arithmetic), not the product rounded and then added."""
    rng = np.random.default_rng(3)
    a, b, c = (rng.random(2048).astype(dtype) for _ in range(3))
    b[::2] = -b[::2]  # cancellation: a and b·c of opposite sign
    exact = [Fraction(float(x)) + Fraction(float(y)) * Fraction(float(z))
             for x, y, z in zip(a, b, c)]
    want = np.array([_round_once(v, dtype) for v in exact], dtype=dtype)
    got = tfma.fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.any(a + b * c != got)


def _round_once(value, dtype):
    """*value* (a Fraction) rounded to the nearest *dtype*, ties to even."""
    guess = dtype(float(value))
    candidates = (np.nextafter(guess, dtype(-np.inf)), guess,
                  np.nextafter(guess, dtype(np.inf)))
    bits = np.int32 if dtype is np.float32 else np.int64
    return min(candidates, key=lambda q: (
        abs(Fraction(float(q)) - value), int(np.array(q).view(bits)) & 1,
    ))
