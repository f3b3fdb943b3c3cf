"""The one-pass settle kernel's plain version, and the CUDA kernel against it.

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest tests/test_torch_onepass_kernel.py -q

The plain version (``onepass_settle_reference``) is held here against its
own parts and its chunk knobs; ``tests/test_torch_analytics_math.py`` and
``tests/test_torch_session.py`` hold those parts against the JAX package.
The ``cuda`` cases hold the kernel against the plain version on the card,
on the cases ``chip_smoke.py``'s ``onepass_check`` uses and on K = 2, 15,
32, 100, 200 and 1000 (every band-tree depth, every block size of the
tie-break's shared memory, and the pairs from device memory beyond
K = 64): state, tie-break
and band moments bit-equal, consensus within rtol=1e-5, atol=1e-6
(float32) or rtol=1e-12 (float64), NaNs in the same places. They skip
where there is no card.
"""

import numpy as np
import pytest
import torch

from bayesian_consensus_engine_tpu_torch.ops import onepass_kernel
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "f64": dict(rtol=1e-12, atol=0.0)}
NOW0 = 600.0
# (with_tiebreak, with_bands): every combination in float32; float64 has
# no tie-break (nor has the JAX reference).
STAGES = {"f32": [(True, True), (True, False), (False, True), (False, False)],
          "f64": [(False, True), (False, False)]}


def block_case(seed, num_slots, num_markets, np_dtype):
    """A resident (K, M) block: pads, empty markets, markets whose every
    slot lands in one tie-break group, cold slots, and stamps on and off
    multiples of the 30-day half-life (one lies after ``now0``)."""
    rng = np.random.default_rng(seed)
    shape = (num_slots, num_markets)
    mask = rng.random(shape) < 0.7
    mask[:, ::17] = False
    probs = rng.random(shape)
    tied = np.arange(num_markets) % 13 == 5
    probs[:, tied] = 0.625
    mask[:, tied] = True
    stamps = [0.0, NOW0, NOW0 - 30.0, NOW0 - 90.0, 3.0, 35.0, NOW0 + 12.5]
    return dict(
        probs=probs.astype(np_dtype),
        mask=mask,
        outcome=rng.random(num_markets) < 0.5,
        rel=rng.uniform(0.0, 1.0, shape).astype(np_dtype),
        conf=rng.uniform(0.0, 1.0, shape).astype(np_dtype),
        days=rng.choice(stamps, shape).astype(np_dtype),
        exists=rng.random(shape) < 0.6,
    )


def case_args(case, torch_dtype, device="cpu"):
    def t(x, dtype=None):
        return torch.tensor(x, dtype=dtype, device=device)

    state = MarketBlockState(
        t(case["rel"], torch_dtype), t(case["conf"], torch_dtype),
        t(case["days"], torch_dtype), t(case["exists"]),
    )
    return (t(case["probs"], torch_dtype), t(case["mask"]), t(case["outcome"]),
            state)


def _equal(got, want, what):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("chunks", [(None, None), (3, 2), (1, 1), (7, 4)])
def test_plain_version_ignores_chunk_knobs(chunks):
    """Tie-break and band moments are the same at every chunk setting."""
    probs, mask, outcome, state = case_args(
        block_case(3, 9, 120, np.float32), torch.float32
    )
    want = onepass_kernel.onepass_settle_reference(
        probs, mask, outcome, state, NOW0, 2,
    )
    got = onepass_kernel.onepass_settle_reference(
        probs, mask, outcome, state, NOW0, 2,
        chunk_agents=chunks[0], chunk_slots=chunks[1],
    )
    for field, a, b in zip(want.tiebreak._fields, got.tiebreak, want.tiebreak):
        _equal(a, b, field)
    _equal(got.band_sums, want.band_sums, "band sums")
    _equal(got.band_count, want.band_count, "band count")


@pytest.mark.parametrize("steps", [0, 1, 5])
def test_stages_only_read(steps):
    """With the stages on or off, the state and consensus are the same:
    the analytics read the state and never write it."""
    probs, mask, outcome, state = case_args(
        block_case(4, 6, 90, np.float32), torch.float32
    )
    full = onepass_kernel.onepass_settle(
        probs, mask, outcome, state, NOW0, steps,
    )
    bare = onepass_kernel.onepass_settle(
        probs, mask, outcome, state, NOW0, steps,
        with_tiebreak=False, with_bands=False,
    )
    assert bare.tiebreak is None and bare.band_sums is None
    for a, b, field in zip(full.state, bare.state, state._fields):
        _equal(a, b, field)
    _equal(full.consensus, bare.consensus, "consensus")


def test_float64_tiebreak_is_refused():
    probs, mask, outcome, state = case_args(
        block_case(5, 3, 20, np.float64), torch.float64
    )
    with pytest.raises(ValueError, match="no float64 tie-break"):
        onepass_kernel.onepass_settle(probs, mask, outcome, state, NOW0, 1)
    out = onepass_kernel.onepass_settle(
        probs, mask, outcome, state, NOW0, 1, with_tiebreak=False,
    )
    assert out.band_sums.dtype == torch.float32


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; anything else that is not
    CUDA raises instead of falling back."""
    probs, mask, outcome, state = case_args(
        block_case(6, 3, 16, np.float32), torch.float32
    )
    meta = [x.to("meta") for x in (probs, mask, outcome)]
    state = MarketBlockState(*(x.to("meta") for x in state))
    with pytest.raises(ValueError, match="cuda or cpu"):
        onepass_kernel.onepass_settle(*meta, state, NOW0, 1)


def test_bound_bytes_counts_each_byte_once():
    # f32, 2 slots x 3 markets, 4 masked slots of which 3 rows exist.
    mask, markets = 2 * 3, 3
    slots = 4 * (4 + 1)  # probability, exists byte
    tiebreak, bands = markets * 6 * 4, markets * 5 * 4
    outputs = markets * 4 + tiebreak + bands  # + consensus
    writes = 4 * 3 * 4 + 1  # rel, conf, stamp; one cold slot turns on
    # Chained: existing rows read rel, conf and the stamp the analytics
    # read decays by; the outcome is read.
    chained = mask + slots + 3 * 3 * 4 + markets + writes + outputs
    assert onepass_kernel.bound_bytes(2, 3, 4, 3, 20, 4) == chained
    # Cold: no stored state is read and every slot turns on.
    cold = mask + slots + markets + 4 * 3 * 4 + 4 + outputs
    assert onepass_kernel.bound_bytes(2, 3, 4, 0, 20, 4) == cold
    # steps == 0: the analytics still read the state, nothing is written
    # but the outputs, and the outcome is not needed.
    assert onepass_kernel.bound_bytes(2, 3, 4, 3, 0, 4) == (
        mask + slots + 3 * 3 * 4 + outputs
    )
    # Stages off and no steps: only the zero consensus is written.
    assert onepass_kernel.bound_bytes(
        2, 3, 4, 3, 0, 4, with_tiebreak=False, with_bands=False,
    ) == markets * 4
    # Bands only, float64, steps > 1: existing rows read rel, the
    # confidence the loop grows and the stamp the bands' read decays by.
    assert onepass_kernel.bound_bytes(
        2, 3, 4, 3, 2, 8, with_tiebreak=False,
    ) == (mask + 4 * (8 + 1) + 3 * 3 * 8 + markets + 4 * 3 * 8 + 1
          + markets * 8 + bands)


# -- the CUDA kernel against its plain version (on the card only) ------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the one-pass kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
# Every band-tree depth (K = 1, 2, 5, 15 and 16, 17, 32, 33 and 64 in
# registers; 65 and up the run-time stack) and every block size of the
# tie-break's shared memory, 8 bytes a slot a thread: 256 threads up to
# K = 24, 128 up to 48, 64 up to 64; beyond, the pairs come from device
# memory (K = 65, 100, 200).
@pytest.mark.parametrize(
    "num_slots", [1, 2, 5, 15, 16, 17, 32, 33, 40, 64, 65, 100, 200])
@pytest.mark.parametrize("name", ["f32", "f64"])
def test_cuda_kernel_matches_plain_version(cuda_device, name, num_slots):
    np_dtype, torch_dtype = DTYPES[name]
    case = block_case(8, num_slots, 1037, np_dtype)
    for steps in (0, 1, 2, 20):
        for with_tiebreak, with_bands in STAGES[name]:
            what = f"{name} K={num_slots} steps={steps} stages={with_tiebreak, with_bands}"
            probs, mask, outcome, state = case_args(case, torch_dtype, cuda_device)
            stages = dict(with_tiebreak=with_tiebreak, with_bands=with_bands)
            want = onepass_kernel.onepass_settle_reference(
                probs, mask, outcome, state, NOW0, steps, **stages,
            )
            clone = MarketBlockState(*(x.clone() for x in state))
            launches = onepass_kernel.LAUNCHES
            got = onepass_kernel.onepass_settle(
                probs, mask, outcome, clone, NOW0, steps, **stages,
            )
            torch.cuda.synchronize()
            assert onepass_kernel.LAUNCHES == launches + 1
            assert got.state.reliability.data_ptr() == clone.reliability.data_ptr()
            for field, a, b in zip(state._fields, got.state, want.state):
                _equal(a, b, f"{what} {field}")
            if with_tiebreak:
                for field, a, b in zip(want.tiebreak._fields, got.tiebreak,
                                       want.tiebreak):
                    _equal(a, b, f"{what} {field}")
            if with_bands:
                _equal(got.band_sums, want.band_sums, f"{what} band sums")
                _equal(got.band_count, want.band_count, f"{what} band count")
            got_c, want_c = got.consensus.cpu().numpy(), want.consensus.cpu().numpy()
            np.testing.assert_array_equal(np.isnan(got_c), np.isnan(want_c))
            np.testing.assert_allclose(got_c, want_c, equal_nan=True,
                                       err_msg=what, **TOL[name])


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 2, 20])
def test_cuda_kernel_matches_plain_version_at_a_thousand_slots(cuda_device, steps):
    """K = 1,000 in float32, every stage combination: the wide
    instantiation takes the tie-break's pairs from device memory, so no K
    is refused. State, tie-break and band moments bit-equal; the
    consensus, a slot-order float32 sum of ~700 terms a market that the
    plain version adds in another order, within rtol=1e-4."""
    case = block_case(10, 1000, 300, np.float32)
    for with_tiebreak, with_bands in STAGES["f32"]:
        what = f"K=1000 steps={steps} stages={with_tiebreak, with_bands}"
        probs, mask, outcome, state = case_args(case, torch.float32, cuda_device)
        stages = dict(with_tiebreak=with_tiebreak, with_bands=with_bands)
        want = onepass_kernel.onepass_settle_reference(
            probs, mask, outcome, state, NOW0, steps, **stages)
        launches = onepass_kernel.LAUNCHES
        got = onepass_kernel.onepass_settle(
            probs, mask, outcome, MarketBlockState(*(x.clone() for x in state)),
            NOW0, steps, **stages)
        torch.cuda.synchronize()
        assert onepass_kernel.LAUNCHES == launches + 1
        for field, a, b in zip(state._fields, got.state, want.state):
            _equal(a, b, f"{what} {field}")
        if with_tiebreak:
            for field, a, b in zip(want.tiebreak._fields, got.tiebreak,
                                   want.tiebreak):
                _equal(a, b, f"{what} {field}")
        if with_bands:
            _equal(got.band_sums, want.band_sums, f"{what} band sums")
            _equal(got.band_count, want.band_count, f"{what} band count")
        got_c, want_c = got.consensus.cpu().numpy(), want.consensus.cpu().numpy()
        np.testing.assert_array_equal(np.isnan(got_c), np.isnan(want_c))
        np.testing.assert_allclose(got_c, want_c, rtol=1e-4, atol=1e-6,
                                   equal_nan=True, err_msg=what)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    probs, mask, outcome, state = case_args(
        block_case(9, 4, 64, np.float32), torch.float32, cuda_device
    )
    with pytest.raises(TypeError, match="probs"):
        onepass_kernel.onepass_settle(probs.double(), mask, outcome, state, NOW0, 2)
    strided = state._replace(reliability=state.reliability.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        onepass_kernel.onepass_settle(probs, mask, outcome, strided, NOW0, 2)
    f64 = MarketBlockState(*(x.double() if x.is_floating_point() else x
                             for x in state))
    with pytest.raises(ValueError, match="no float64 tie-break"):
        onepass_kernel.onepass_settle(probs.double(), mask, outcome, f64, NOW0, 2)
