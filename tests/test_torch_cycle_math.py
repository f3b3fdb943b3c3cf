"""The port's cycle math and the settle kernel's plain version ≡ the JAX package.

The same numpy inputs, made from a seed, go through the JAX functions
(``ops/decay.py``, ``ops/update.py``, ``ops/cycle_math.py``, and the Pallas
cycle kernel in interpret mode) and through their torch twins on the CPU.

Tolerances: stored state (reliability, stamps, existence) is bit-equal —
the update is one add and a clamp of the undecayed value, and no decay or
reduction touches it. Values that pass through ``exp2`` or a K-deep sum
(decayed reads, consensus) and device confidences (XLA may contract the
growth into an FMA) are held to rtol=1e-5, atol=1e-6 in float32 and
rtol=1e-12 in float64, NaNs in the same places.

``tests/test_torch_settle_kernel.py`` holds the kernel's plain version
against this loop math, and the CUDA kernel against its plain version.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu.ops import cycle_math as jcm
from bayesian_consensus_engine_tpu.ops import decay as jdecay
from bayesian_consensus_engine_tpu.ops import update as jupdate
from bayesian_consensus_engine_tpu.ops.pallas_cycle import (
    SlotMajorState,
    build_pallas_cycle,
)
from bayesian_consensus_engine_tpu_torch.ops import cycle_math as tcm
from bayesian_consensus_engine_tpu_torch.ops import decay as tdecay
from bayesian_consensus_engine_tpu_torch.ops import settle_kernel
from bayesian_consensus_engine_tpu_torch.ops import update as tupdate

DTYPES = {
    "f32": (np.float32, torch.float32),
    "f64": (np.float64, torch.float64),
}
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "f64": dict(rtol=1e-12, atol=0.0)}


def _x64(name):
    """JAX's float64 needs x64 on; float32 runs with it off."""
    if name == "f64":
        return jax.enable_x64()
    return jax.enable_x64(False)


def _block(seed, num_slots, num_markets, np_dtype):
    """A slot-major block with cold slots, stale and fresh stamps, and
    masked-off slots, plus a flat-state layout (distinct rows, pads)."""
    rng = np.random.default_rng(seed)
    shape = (num_slots, num_markets)
    mask = rng.random(shape) < 0.75
    mask[:, 0] = False  # an empty market: NaN consensus
    return dict(
        probs=rng.random(shape).astype(np_dtype),
        mask=mask,
        outcome=rng.random(num_markets) < 0.5,
        rel=rng.uniform(0.0, 1.0, shape).astype(np_dtype),
        conf=rng.uniform(0.0, 1.0, shape).astype(np_dtype),
        days=rng.choice([0.0, 3.0, 35.0, 499.5], shape).astype(np_dtype),
        exists=rng.random(shape) < 0.6,
        now0=np_dtype(500.0),
    )


def _assert_close(ours, theirs, name):
    np.testing.assert_allclose(
        np.asarray(ours), np.asarray(theirs), equal_nan=True, **TOL[name]
    )


def _assert_equal(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


# -- decay and update twins ---------------------------------------------------


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_decay_twins_match_jax(name):
    np_dtype, torch_dtype = DTYPES[name]
    data = _block(1, 6, 64, np_dtype)
    elapsed = np.abs(data["now0"] - data["days"]).astype(np_dtype)
    elapsed[0] = 0.0
    t = partial(torch.tensor, dtype=torch_dtype)
    with _x64(name):
        j_factor = jdecay.decay_factor(jnp.asarray(elapsed))
        j_dec = jdecay.decayed_reliability(
            jnp.asarray(data["rel"]), jnp.asarray(elapsed)
        )
        j_at = jdecay.decayed_reliability_at(
            jnp.asarray(data["rel"]), jnp.asarray(data["days"]),
            jnp.asarray(data["now0"]), jnp.asarray(data["exists"]),
        )
    t_factor = tdecay.decay_factor(t(elapsed))
    t_dec = tdecay.decayed_reliability(t(data["rel"]), t(elapsed))
    t_at = tdecay.decayed_reliability_at(
        t(data["rel"]), t(data["days"]), t(data["now0"]),
        torch.tensor(data["exists"]),
    )
    for ours, theirs in ((t_factor, j_factor), (t_dec, j_dec), (t_at, j_at)):
        assert ours.dtype == torch_dtype
        _assert_close(ours.numpy(), theirs, name)


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_update_twins_match_jax(name):
    np_dtype, torch_dtype = DTYPES[name]
    data = _block(2, 6, 64, np_dtype)
    correct = data["probs"] >= 0.5
    t = partial(torch.tensor, dtype=torch_dtype)
    with _x64(name):
        j_rel, j_conf = jupdate.outcome_update(
            jnp.asarray(data["rel"]), jnp.asarray(data["conf"]),
            jnp.asarray(correct),
        )
        j_masked = jupdate.masked_outcome_update(
            jnp.asarray(data["rel"]), jnp.asarray(data["conf"]),
            jnp.asarray(correct), jnp.asarray(data["mask"]),
            jnp.asarray(data["now0"]), jnp.asarray(data["days"]),
        )
    t_rel, t_conf = tupdate.outcome_update(
        t(data["rel"]), t(data["conf"]), torch.tensor(correct)
    )
    t_masked = tupdate.masked_outcome_update(
        t(data["rel"]), t(data["conf"]), torch.tensor(correct),
        torch.tensor(data["mask"]), t(data["now0"]), t(data["days"]),
    )
    _assert_equal(t_rel.numpy(), j_rel)
    _assert_close(t_conf.numpy(), j_conf, name)
    _assert_equal(t_masked[0].numpy(), j_masked[0])
    _assert_close(t_masked[1].numpy(), j_masked[1], name)
    _assert_equal(t_masked[2].numpy(), j_masked[2])


# -- make_loop_math -----------------------------------------------------------

K_LOOP, M_LOOP = 5, 96


@pytest.fixture(scope="module")
def jax_loops():
    """JAX ``make_loop_math`` results per (dtype, steps), jitted once each
    (the way ``_settle_math`` runs it) and shared by the cases below."""
    cache = {}

    def run(name, steps):
        key = (name, steps)
        if key not in cache:
            data = _block(3, K_LOOP, M_LOOP, DTYPES[name][0])
            loop = jcm.make_loop_math(
                partial(jcm._cycle_math, axis_name=None, slots_axis=0),
                steps,
                fast_cycle_fn=partial(
                    jcm._fast_cycle_math, axis_name=None, slots_axis=0
                ),
            )
            with _x64(name):
                state = jcm.MarketBlockState(
                    *(jnp.asarray(data[k]) for k in ("rel", "conf", "days",
                                                       "exists"))
                )
                new_state, consensus = jax.jit(loop)(
                    jnp.asarray(data["probs"]), jnp.asarray(data["mask"]),
                    jnp.asarray(data["outcome"]), state,
                    jnp.asarray(data["now0"]),
                )
                cache[key] = (
                    data,
                    [np.asarray(x) for x in new_state],
                    np.asarray(consensus),
                )
        return cache[key]

    return run


def _torch_loop(data, torch_dtype, steps, fast=True):
    t = partial(torch.tensor, dtype=torch_dtype)
    loop = tcm.make_loop_math(
        partial(tcm._cycle_math, slots_axis=0),
        steps,
        fast_cycle_fn=partial(tcm._fast_cycle_math, slots_axis=0) if fast else None,
    )
    state = tcm.MarketBlockState(
        t(data["rel"]), t(data["conf"]), t(data["days"]),
        torch.tensor(data["exists"]),
    )
    return loop(
        t(data["probs"]), torch.tensor(data["mask"]),
        torch.tensor(data["outcome"]), state, t(data["now0"]),
    )


@pytest.mark.parametrize("steps", [0, 1, 2, 5])
@pytest.mark.parametrize("name", ["f32", "f64"])
def test_loop_math_matches_jax(jax_loops, name, steps):
    data, j_state, j_consensus = jax_loops(name, steps)
    t_state, t_consensus = _torch_loop(data, DTYPES[name][1], steps)
    _assert_equal(t_state.reliability.numpy(), j_state[0])
    _assert_equal(t_state.updated_days.numpy(), j_state[2])
    _assert_equal(t_state.exists.numpy(), j_state[3])
    _assert_close(t_state.confidence.numpy(), j_state[1], name)
    _assert_close(t_consensus.numpy(), j_consensus, name)
    assert np.isnan(t_consensus.numpy()[0]) == (steps > 0)


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_fast_loop_equals_chained_cycles(name):
    """Dropping the stamps from the carry changes nothing: the fast loop
    and the chain of full cycles give the same bits."""
    data = _block(4, K_LOOP, M_LOOP, DTYPES[name][0])
    fast_state, fast_consensus = _torch_loop(data, DTYPES[name][1], 4)
    slow_state, slow_consensus = _torch_loop(
        data, DTYPES[name][1], 4, fast=False
    )
    for ours, theirs in zip(fast_state, slow_state):
        _assert_equal(ours.numpy(), theirs.numpy())
    _assert_equal(fast_consensus.numpy(), slow_consensus.numpy())


# -- the kernel's plain version against the TPU kernel -----------------------


def test_plain_single_step_matches_pallas_cycle_kernel():
    """The plain version's one step against the TPU kernel itself
    (``_fused_cycle_kernel``, interpret mode on the CPU), at the tolerance
    ``tests/test_pallas_cycle.py`` holds that kernel to."""
    num_slots, num_markets, tile = 8, 256, 128
    data = _block(6, num_slots, num_markets, np.float32)
    mask = data["mask"]
    # Lay the block over a flat state: each masked slot owns a shuffled
    # row; pads are row -1.
    num_touched = int(mask.sum())
    rows = np.full(mask.shape, -1, dtype=np.int32)
    rows[mask] = np.random.default_rng(16).permutation(num_touched)
    flat = {}
    for key in ("rel", "conf", "days", "exists"):
        flat[key] = np.zeros(num_touched, dtype=data[key].dtype)
        flat[key][rows[mask]] = data[key][mask]
    _touched, offsets = settle_kernel.touched_layout(rows, mask)
    f32 = partial(torch.tensor, dtype=torch.float32)
    out = settle_kernel.settle_cycles(
        f32(flat["rel"]), f32(flat["conf"]), f32(flat["days"]),
        torch.tensor(flat["exists"]), torch.tensor(rows), f32(data["probs"]),
        torch.tensor(mask), torch.tensor(data["outcome"]),
        torch.tensor(offsets), num_touched, float(data["now0"]), 1,
    )

    with _x64("f32"):
        f32 = partial(jnp.asarray, dtype=jnp.float32)
        cycle = build_pallas_cycle(
            num_markets, num_slots, tile_markets=tile, interpret=True
        )
        state, consensus, _conf, _tw = cycle(
            f32(data["probs"]), f32(data["mask"]), f32(data["outcome"])[None, :],
            SlotMajorState(f32(data["rel"]), f32(data["conf"]),
                           f32(data["days"]), f32(data["exists"])),
            float(data["now0"]),
        )
    np.testing.assert_allclose(
        out.consensus.numpy(), np.asarray(consensus)[0], rtol=1e-6,
        equal_nan=True,
    )
    flat_rows = rows[mask]
    np.testing.assert_allclose(
        out.reliability.numpy()[flat_rows],
        np.asarray(state.reliability)[mask], rtol=1e-6,
    )
    np.testing.assert_allclose(
        out.confidence.numpy()[flat_rows],
        np.asarray(state.confidence)[mask], rtol=1e-6,
    )
    np.testing.assert_allclose(
        out.updated_days.numpy()[flat_rows],
        np.asarray(state.updated_days)[mask], rtol=1e-6,
    )
    np.testing.assert_array_equal(
        out.exists.numpy()[flat_rows], np.asarray(state.exists)[mask] > 0
    )
