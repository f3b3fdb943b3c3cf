"""The settle kernel's plain version, and the CUDA kernel against it.

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest tests/test_torch_settle_kernel.py -q

The plain version (``settle_cycles_reference``: gather through a sink row,
the loop math, scatter) is held here against the loop math on the gathered
block; ``tests/test_torch_cycle_math.py`` holds that loop math against the
JAX package. The ``cuda`` cases hold the CUDA kernel against the plain
version on the card — state and ``rel_touched`` bit-equal, consensus
within rtol=1e-5, atol=1e-6 (float32) or rtol=1e-12 (float64), NaNs in the
same places — and skip where there is no card. Their cases take both of
the kernel's routes: tiles staged in shared memory (one thread a slot)
and, for a ragged tile whose slots overflow the stage or a K whose tiles
do, the per-market walk.
"""

from functools import partial

import numpy as np
import pytest
import torch

from bayesian_consensus_engine_tpu_torch.ops import cycle_math as tcm
from bayesian_consensus_engine_tpu_torch.ops import settle_kernel

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "f64": dict(rtol=1e-12, atol=0.0)}


def _assert_equal(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def _flat_case(seed, num_slots, num_markets, np_dtype, extra_rows=7,
               kind="random"):
    """A slot-major block laid over a flat state: each masked slot owns a
    distinct shuffled row, pads are row -1, empty markets, cold rows,
    stale, fresh and future stamps, and rows no slot touches.

    ``kind`` shapes the mask: "random" (3 in 4 slots), "ragged" (market 7
    has every slot, every other market slot 0 only: a tile the stage
    cannot hold) or "sparse" (9 in 10 markets empty, whole tiles among
    them)."""
    rng = np.random.default_rng(seed)
    shape = (num_slots, num_markets)
    if kind == "ragged":
        mask = np.zeros(shape, dtype=bool)
        mask[0] = True
        mask[:, 7] = True
    elif kind == "sparse":
        mask = (rng.random(shape) < 0.75) & (rng.random(num_markets) < 0.1)
    else:
        mask = rng.random(shape) < 0.75
    mask[:, 0] = False  # an empty market: NaN consensus
    num_touched = int(mask.sum())
    capacity = num_touched + extra_rows
    rows = np.full(shape, -1, dtype=np.int32)
    rows[mask] = rng.permutation(capacity)[:num_touched]
    block = dict(
        probs=rng.random(shape).astype(np_dtype),
        mask=mask,
        outcome=rng.random(num_markets) < 0.5,
        now0=np_dtype(500.0),
    )
    flat = dict(
        rel=rng.uniform(0.0, 1.0, capacity).astype(np_dtype),
        conf=rng.uniform(0.0, 1.0, capacity).astype(np_dtype),
        days=rng.choice([0.0, 3.0, 35.0, 499.5, 512.5], capacity).astype(np_dtype),
        exists=rng.random(capacity) < 0.6,
    )
    return block, rows, flat


def _args(block, rows, flat, torch_dtype, steps, device="cpu"):
    touched_rows, offsets = settle_kernel.touched_layout(rows, block["mask"])
    t = partial(torch.tensor, dtype=torch_dtype, device=device)
    args = (
        t(flat["rel"]), t(flat["conf"]), t(flat["days"]),
        torch.tensor(flat["exists"], device=device),
        torch.tensor(rows, device=device), t(block["probs"]),
        torch.tensor(block["mask"], device=device),
        torch.tensor(block["outcome"], device=device),
        torch.tensor(offsets, device=device), len(touched_rows),
        float(block["now0"]), steps,
    )
    return touched_rows, args


@pytest.mark.parametrize("steps", [0, 1, 5])
@pytest.mark.parametrize("num_slots, num_markets, kind", [
    (6, 40, "random"), (65, 300, "ragged"), (15, 600, "sparse"),
])
def test_plain_version_equals_loop_on_gathered_block(num_slots, num_markets,
                                                     kind, steps):
    """Gather → loop → scatter equals the loop on the gathered block;
    untouched rows keep their bits; ``rel_touched`` lists the settled rows
    market by market. Also on the plans whose tiles take the kernel's wide
    route on the card (a ragged market) or hold whole empty tiles."""
    block, rows, flat = _flat_case(5, num_slots, num_markets, np.float64,
                                   kind=kind)
    touched_rows, args = _args(block, rows, flat, torch.float64, steps)
    out = settle_kernel.settle_cycles(*args)

    mask = block["mask"]
    gathered = {}
    for key, fill in (("rel", 0.5), ("conf", 0.25), ("days", 0.0),
                      ("exists", False)):
        values = np.full(mask.shape, fill, dtype=flat[key].dtype)
        values[mask] = flat[key][rows[mask]]
        gathered[key] = torch.tensor(values)
    loop = tcm.make_loop_math(
        partial(tcm._cycle_math, slots_axis=0), steps,
        fast_cycle_fn=partial(tcm._fast_cycle_math, slots_axis=0),
    )
    state, consensus = loop(
        torch.tensor(block["probs"]), torch.tensor(mask),
        torch.tensor(block["outcome"]),
        tcm.MarketBlockState(gathered["rel"], gathered["conf"],
                             gathered["days"], gathered["exists"]),
        torch.tensor(block["now0"]),
    )
    index = rows[mask]
    _assert_equal(out.reliability.numpy()[index], state.reliability.numpy()[mask])
    _assert_equal(out.confidence.numpy()[index], state.confidence.numpy()[mask])
    _assert_equal(out.updated_days.numpy()[index],
                  state.updated_days.numpy()[mask])
    _assert_equal(out.exists.numpy()[index], state.exists.numpy()[mask])
    _assert_equal(out.consensus.numpy(), consensus.numpy())
    _assert_equal(out.rel_touched.numpy(), out.reliability.numpy()[touched_rows])
    untouched = np.setdiff1d(np.arange(len(flat["rel"])), touched_rows)
    for key in ("rel", "conf", "days", "exists"):
        field = {"rel": "reliability", "conf": "confidence",
                 "days": "updated_days", "exists": "exists"}[key]
        _assert_equal(getattr(out, field).numpy()[untouched], flat[key][untouched])


def test_touched_layout_is_market_major():
    rows = np.array([[4, 7, -1], [2, -1, -1]], dtype=np.int32)
    mask = rows >= 0
    touched, offsets = settle_kernel.touched_layout(rows, mask)
    _assert_equal(touched, np.array([4, 2, 7], dtype=np.int32))
    _assert_equal(offsets, np.array([0, 2, 3, 3], dtype=np.int64))


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; anything else that is not
    CUDA raises instead of falling back."""
    block, rows, flat = _flat_case(7, 3, 16, np.float32)
    _touched, args = _args(block, rows, flat, torch.float32, 1)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        settle_kernel.settle_cycles(*meta)


def test_bound_bytes_counts_each_byte_once():
    # f32, 2 slots x 3 markets, 4 masked slots of which 3 rows exist.
    mask = 2 * 3
    markets = 3 * (1 + 8 + 4)  # outcome, offset, consensus
    slots = 4 * (4 + 4 + 1)  # row index, probability, exists
    writes = 4 * (3 * 4 + 4) + 1  # rel, conf, stamp, rel_touched; 1 turns on
    reads = 3 * 2 * 4  # rel and conf of the existing rows only
    steady = mask + markets + slots + writes + reads
    assert settle_kernel.bound_bytes(2, 3, 4, 3, 20, 4) == steady
    # A cold block reads no stored state and turns every row on.
    assert settle_kernel.bound_bytes(2, 3, 4, 0, 20, 4) == steady - reads + 3
    # steps == 1 also reads each existing row's stamp.
    assert settle_kernel.bound_bytes(2, 3, 4, 3, 1, 4) == steady + 3 * 4
    # steps == 0 reads the row index and stored reliability of each
    # masked slot and writes rel_touched and the consensus.
    assert settle_kernel.bound_bytes(2, 3, 4, 3, 0, 4) == (
        mask + 4 * (4 + 4) + 4 * 4 + 3 * (8 + 4)
    )


# -- the CUDA kernel against its plain version (on the card only) ------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the settle kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 1, 2, 20])
@pytest.mark.parametrize("num_slots, num_markets, kind", [
    (1, 251, "random"), (5, 251, "random"), (15, 251, "random"),
    (40, 251, "random"), (64, 251, "random"), (65, 251, "random"),
    (200, 251, "random"), (200, 1037, "ragged"), (15, 1037, "sparse"),
    (15, 300_000, "random"),
])
@pytest.mark.parametrize("name", ["f32", "f64"])
def test_cuda_kernel_matches_plain_version(cuda_device, name, num_slots,
                                           num_markets, kind, steps):
    np_dtype, torch_dtype = DTYPES[name]
    block, rows, flat = _flat_case(8, num_slots, num_markets, np_dtype, kind=kind)
    _touched, args = _args(block, rows, flat, torch_dtype, steps, cuda_device)
    want = settle_kernel.settle_cycles_reference(*args)
    clones = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    launches = settle_kernel.LAUNCHES
    routes = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    got = settle_kernel.settle_cycles(*clones, routes=routes)
    torch.cuda.synchronize()
    assert settle_kernel.LAUNCHES == launches + 1
    # The kernel's own route report: every tile of 256 markets takes one
    # route; the ragged market's tile overflows the stage, the others fit.
    staged, wide, stage = routes.tolist()
    assert staged + wide == -(-num_markets // 256)
    assert 32 <= stage and stage * (2 * np_dtype().itemsize + 5) <= 48 * 1024
    if kind == "ragged":
        assert (staged, wide) == (-(-num_markets // 256) - 1, 1)
    elif num_slots <= 5:
        assert wide == 0
    assert got.reliability.data_ptr() == clones[0].data_ptr()  # in place
    for field in ("reliability", "confidence", "updated_days", "exists",
                  "rel_touched"):
        _assert_equal(getattr(got, field).cpu().numpy(),
                      getattr(want, field).cpu().numpy())
    got_c, want_c = got.consensus.cpu().numpy(), want.consensus.cpu().numpy()
    _assert_equal(np.isnan(got_c), np.isnan(want_c))
    np.testing.assert_allclose(got_c, want_c, equal_nan=True, **TOL[name])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    block, rows, flat = _flat_case(9, 4, 64, np.float32)
    _touched, args = _args(block, rows, flat, torch.float32, 2, cuda_device)
    wrong_dtype = list(args)
    wrong_dtype[5] = args[5].double()  # probs not in the state's dtype
    with pytest.raises(TypeError, match="probs"):
        settle_kernel.settle_cycles(*wrong_dtype)
    strided = list(args)
    strided[4] = args[4].t().contiguous().t()  # slot_rows not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        settle_kernel.settle_cycles(*strided)
