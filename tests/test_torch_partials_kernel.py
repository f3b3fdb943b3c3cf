"""The partials kernel's plain version, and the CUDA kernel against it.

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest tests/test_torch_partials_kernel.py -q

The plain version (``onepass_partials_reference``) is held here against
its chunk knob and its own parts; ``tests/test_torch_partials.py`` holds it
against the JAX package's partials kernel. The ``cuda`` cases hold the
kernel against the plain version on the card, on the cases
``chip_smoke.py``'s ``partials_check`` uses (K_loc in {1, 2, 3, 4, 5, 8,
16, 17, 33, 64, 65}: every register band-tree depth 0-6 and the wider
stack tree; M = 1037, steps in {0, 1, 2, 20}, float32 and float64, every
combination of the views and bands stages, cold slots, pad
slots, empty markets, stamps on and off multiples of the half-life):
state, views, band roots and count bit-equal (a NaN as a NaN), the raw
consensus sums within rtol=1e-5, atol=1e-6 (float32) or rtol=1e-12
(float64). They also drive the sources-sharded loop on a (1, 4) mesh of
the card against the same loop with the plain partials on the card, and
against the same loop on a (1, 4) mesh of the CPU, which
``tests/test_torch_sharded_session.py`` holds to the JAX reference's bits:
the state bit-equal; the tie-break and bands bit-equal where no read
decays, and where reads decay (the card's ``exp2`` and the CPU's differ by
ulps, as the CPU's and XLA's do) within rtol=1e-5, atol=1e-3, the
tolerance the CPU session is held to against the reference there. They
skip where there is no card.
"""

import numpy as np
import pytest
import torch

from bayesian_consensus_engine_tpu_torch.ops import partials_kernel
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
from bayesian_consensus_engine_tpu_torch.ops.uncertainty import (
    band_epilogue,
    band_sums,
)
from bayesian_consensus_engine_tpu_torch.parallel import mesh as tmesh
from bayesian_consensus_engine_tpu_torch.parallel import sharded
from bayesian_consensus_engine_tpu_torch.parallel.sharded import (
    build_cycle_analytics_loop,
)

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "f64": dict(rtol=1e-12, atol=0.0)}
NOW0 = 600.0
STAGES = [(True, True), (True, False), (False, True), (False, False)]
DECAYED_TOL = dict(rtol=1e-5, atol=1e-3)  # stderr/lo/hi cancel


def shard_case(seed, num_slots, num_markets, np_dtype):
    """One sources shard's (K_loc, M) block: pad slots (mask false, the
    cold prior), empty markets, cold slots, and stamps on and off
    multiples of the 30-day half-life (one lies after ``now0``)."""
    rng = np.random.default_rng(seed)
    shape = (num_slots, num_markets)
    mask = rng.random(shape) < 0.7
    mask[:, ::17] = False
    exists = rng.random(shape) < 0.6
    rel = rng.uniform(0.0, 1.0, shape)
    conf = rng.uniform(0.0, 1.0, shape)
    stamps = [0.0, NOW0, NOW0 - 30.0, NOW0 - 90.0, 3.0, 35.0, NOW0 + 12.5]
    days = rng.choice(stamps, shape)
    if num_slots > 2:
        pad = slice(num_slots - 2, None)
        mask[pad], exists[pad], rel[pad], conf[pad], days[pad] = (
            False, False, 0.5, 0.25, 0.0)
    return dict(
        probs=rng.random(shape).astype(np_dtype), mask=mask,
        outcome=rng.random(num_markets) < 0.5,
        rel=rel.astype(np_dtype), conf=conf.astype(np_dtype),
        days=days.astype(np_dtype), exists=exists,
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


def _bits(got, want, what):
    """Bit-equal tensors, a NaN comparing as NaN whatever its payload."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
        got, want = got[~nan], want[~nan]
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("chunk_slots", [None, 1, 2, 4])
@pytest.mark.parametrize("num_slots", [7, 1, 3, 5, 17, 33, 65])
def test_plain_version_ignores_chunk_slots(num_slots, chunk_slots):
    """The band roots do not depend on the chunking, at K_loc within each
    band-tree depth the kernel is instantiated for and beyond."""
    args = case_args(shard_case(3, num_slots, 120, np.float32), torch.float32)
    want = partials_kernel.onepass_partials_reference(*args, NOW0, 2)
    got = partials_kernel.onepass_partials_reference(
        *args, NOW0, 2, chunk_slots=chunk_slots)
    _bits(got.band_sums, want.band_sums, "band sums")
    _bits(got.band_count, want.band_count, "band count")


def test_pad_slots_stay_untouched_and_add_nothing():
    """Pad slots keep their cold prior and leave every sum and count as a
    block without them leaves it."""
    case = shard_case(4, 6, 90, np.float32)
    full = partials_kernel.onepass_partials(
        *case_args(case, torch.float32), NOW0, 3)
    trimmed = {k: (v[:4] if k not in ("outcome",) else v) for k, v in case.items()}
    short = partials_kernel.onepass_partials(
        *case_args(trimmed, torch.float32), NOW0, 3)
    for ours, theirs in zip(full.state, case_args(case, torch.float32)[3]):
        _bits(ours[4:], theirs[4:], "pad slots")
    _bits(full.band_count, short.band_count, "count")
    _bits(full.band_sums, short.band_sums, "band roots")  # pow2 padding either way
    _bits(full.consensus_sums, short.consensus_sums, "raw sums")


def test_wrapper_refuses_other_devices():
    probs, mask, outcome, state = case_args(
        shard_case(6, 3, 16, np.float32), torch.float32)
    meta = [x.to("meta") for x in (probs, mask, outcome)]
    state = MarketBlockState(*(x.to("meta") for x in state))
    with pytest.raises(ValueError, match="cuda or cpu"):
        partials_kernel.onepass_partials(*meta, state, NOW0, 1)


# -- the CUDA kernel against its plain version (on the card only) ------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the partials kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


# The kernel instantiation for K_loc: its register band tree's depth,
# log2(pow2_at_least(K_loc)), up to K_loc = 64; the stack tree (-1) beyond.
DEPTHS = {1: 0, 2: 1, 3: 2, 4: 2, 5: 3, 8: 3, 16: 4, 17: 5, 33: 6, 64: 6,
          65: -1}


@pytest.mark.cuda
@pytest.mark.parametrize("num_slots", sorted(DEPTHS))
@pytest.mark.parametrize("name", ["f32", "f64"])
def test_cuda_kernel_matches_plain_version(cuda_device, name, num_slots):
    np_dtype, torch_dtype = DTYPES[name]
    case = shard_case(8, num_slots, 1037, np_dtype)
    for steps in (0, 1, 2, 20):
        for with_views, with_bands in STAGES:
            what = f"{name} K={num_slots} steps={steps} stages={with_views, with_bands}"
            probs, mask, outcome, state = case_args(case, torch_dtype, cuda_device)
            stages = dict(with_views=with_views, with_bands=with_bands)
            want = partials_kernel.onepass_partials_reference(
                probs, mask, outcome, state, NOW0, steps, **stages)
            clone = MarketBlockState(*(x.clone() for x in state))
            launches = partials_kernel.LAUNCHES
            depth = torch.full((1,), -2, dtype=torch.int32, device=cuda_device)
            got = partials_kernel.onepass_partials(
                probs, mask, outcome, clone, NOW0, steps, depth_out=depth,
                **stages)
            torch.cuda.synchronize()
            assert partials_kernel.LAUNCHES == launches + 1
            assert int(depth) == DEPTHS[num_slots], what
            assert got.state.reliability.data_ptr() == clone.reliability.data_ptr()
            for field, a, b in zip(state._fields, got.state, want.state):
                _bits(a, b, f"{what} {field}")
            for field in ("band_sums", "band_count", "read_rel", "read_conf"):
                a, b = getattr(got, field), getattr(want, field)
                assert (a is None) == (b is None), f"{what} {field}"
                if b is not None:
                    _bits(a, b, f"{what} {field}")
            np.testing.assert_allclose(
                got.consensus_sums.cpu().numpy(), want.consensus_sums.cpu().numpy(),
                err_msg=what, **TOL[name])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    probs, mask, outcome, state = case_args(
        shard_case(9, 4, 64, np.float32), torch.float32, cuda_device)
    with pytest.raises(TypeError, match="probs"):
        partials_kernel.onepass_partials(probs.double(), mask, outcome, state, NOW0, 2)
    strided = state._replace(reliability=state.reliability.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        partials_kernel.onepass_partials(probs, mask, outcome, strided, NOW0, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 3])
def test_cuda_sharded_loop_matches_plain_partials(cuda_device, steps, monkeypatch):
    """The sources-sharded loop on a (1, 4) mesh of the card, one partials
    launch a shard, against the same loop on the card with the plain
    partials: the merge is the same eager code on the same device, so the
    state, tie-break and bands are bit-equal and the consensus is within
    tolerance."""
    case = shard_case(10, 16, 1037, np.float32)
    mesh = tmesh.make_mesh((1, 4), [cuda_device] * 4)

    def run():
        grids = {k: tmesh.shard_slot_block(case[k], mesh)
                 for k in ("probs", "mask", "rel", "conf", "days", "exists")}
        state = ((tuple(MarketBlockState(*(grids[k][0][j] for k in (
            "rel", "conf", "days", "exists"))) for j in range(4)),))
        outcome = tmesh.shard_market_vector(case["outcome"], mesh)
        out = build_cycle_analytics_loop(mesh)(
            grids["probs"], grids["mask"], outcome, state, NOW0, steps)
        torch.cuda.synchronize()
        return out

    launches = partials_kernel.LAUNCHES
    got = run()
    assert partials_kernel.LAUNCHES == launches + 4
    monkeypatch.setattr(sharded, "onepass_partials",
                        partials_kernel.onepass_partials_reference)
    want = run()
    for j in range(4):
        for field, a, b in zip(MarketBlockState._fields, got[0][0][j], want[0][0][j]):
            _bits(a, b, f"shard {j} {field}")
    for field, a, b in zip(got[2]._fields + got[3]._fields,
                           tuple(got[2]) + tuple(got[3]),
                           tuple(want[2]) + tuple(want[3])):
        _bits(a, b, field)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               equal_nan=True, **TOL["f32"])


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [False, True], ids=["fresh", "decayed"])
@pytest.mark.parametrize("steps", [0, 3])
def test_cuda_sharded_loop_matches_cpu_loop(cuda_device, steps, decay):
    """The (1, 4) loop on the card (partials kernel + the merge on the
    card) against the same loop on the CPU (plain partials + the merge on
    the CPU): the merge's eager ops, the band epilogue's divisions among
    them, round alike on both devices, so the card's bands are the
    reference's bits wherever the CPU's are."""
    case = shard_case(10, 16, 1037, np.float32)
    if not decay:
        case["days"][:] = np.float32(NOW0)  # every read at elapsed time 0

    def run(device):
        mesh = tmesh.make_mesh((1, 4), [device] * 4)
        grids = {k: tmesh.shard_slot_block(case[k], mesh)
                 for k in ("probs", "mask", "rel", "conf", "days", "exists")}
        state = ((tuple(MarketBlockState(*(grids[k][0][j] for k in (
            "rel", "conf", "days", "exists"))) for j in range(4)),))
        outcome = tmesh.shard_market_vector(case["outcome"], mesh)
        return build_cycle_analytics_loop(mesh)(
            grids["probs"], grids["mask"], outcome, state, NOW0, steps)

    launches = partials_kernel.LAUNCHES
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert partials_kernel.LAUNCHES == launches + 4
    want = run(torch.device("cpu"))
    for j in range(4):
        for field, a, b in zip(MarketBlockState._fields, got[0][0][j], want[0][0][j]):
            _bits(a, b, f"shard {j} {field}")
    for name, a, b in zip(got[2]._fields + got[3]._fields,
                          tuple(got[2]) + tuple(got[3]),
                          tuple(want[2]) + tuple(want[3])):
        if not decay or name in ("num_groups", "count"):
            _bits(a, b, name)
        else:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), equal_nan=True,
                                       err_msg=name, **DECAYED_TOL)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               equal_nan=True, **TOL["f32"])


@pytest.mark.cuda
def test_cuda_band_epilogue_matches_cpu(cuda_device):
    """The band epilogue's eager ops (its divisions, the float64 square
    root, the emulated FMAs) give the same bits on the card as on the CPU
    for the same sums, empty and single-slot markets included."""
    rng = np.random.default_rng(12)
    shape = (16, 100_000)
    probs = torch.tensor(rng.random(shape), dtype=torch.float32)
    mask = torch.tensor(rng.random(shape) < 0.7)
    mask[:, ::13] = False
    mask[1:, 5::13] = False
    rel = torch.tensor(rng.random(shape), dtype=torch.float32)
    sums, count = band_sums(probs, mask, rel, agents_last=False)
    want = band_epilogue(sums, count)
    got = band_epilogue(sums.to(cuda_device), count.to(cuda_device))
    for name, a, b in zip(want._fields, got, want):
        _bits(a, b, name)
