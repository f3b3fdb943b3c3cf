"""The lane-batched settle kernel and the replay step, on the card.

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest tests/test_torch_replay_kernel.py -q

``settle_cycles_lanes`` advances C stacked copies of the flat state
through one plan in one launch, each lane with its own rates (a (C, 5)
float32 params tensor). Its plain version, ``settle_cycles_lanes_
reference``, is the single-lane plain version run lane by lane with the
lane's ``CycleParams``; ``tests/test_torch_replay.py`` holds the replay
lanes built on it against the JAX package. Here, on the CPU: the plain
version against that lane-by-lane loop, the rates reaching the state, and
the byte bound. On the card (the ``cuda`` cases skip without one): the
kernel against its plain version at float32 and float64, C in {1, 3, 16,
17, 33, 64} (a block settles a group of up to 16 lanes, so 17, 33 and 64
lanes take two, three and four groups), steps in {0, 1, 2, 20}, over
plans whose tiles take both routes (a ragged market overflows the shared
stage), with the three rate rows cycled over the lanes and, on one plan,
every lane's rates drawn apart, each plan's rows shuffled (a block a tile
and lane) and in plan order (a block a tile and lane group, which reads
the plan once for the group): the stacked state bit-equal and each
lane's consensus bit-equal (the plain version adds a market's slots in
slot order, as the kernel does, and both take ``exp2`` from the card's
math library), in place, one launch for all lanes, its route report
covering every (tile, lane), counting every tile as settled a group of
lanes a block on rows in plan order and none on shuffled rows, and
giving the shared bytes and the lanes a group; and the replay step on the card against the same step on the
CPU (state bit-equal, metrics within rtol 1e-5) and against itself run
twice (metrics bit-equal).
"""

import numpy as np
import pytest
import torch

from bayesian_consensus_engine_tpu_torch.ops import settle_kernel
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import CycleParams
from bayesian_consensus_engine_tpu_torch.parallel.sharded import (
    build_replay_sweep_step,
)

from test_torch_settle_kernel import DTYPES, _args, _flat_case

#: Lane rates: the recorded ones, then two altered lanes, cycled.
RATES = np.float32([
    [30.0, 0.10, 0.15, 0.10, 0.10],
    [12.0, 0.20, 0.05, 0.04, 0.10],
    [45.5, 0.05, 0.30, 0.20, 0.10],
])


def distinct_rates(seed, lanes):
    """(C, 5) float32 rates, every lane's drawn apart from the others'."""
    rng = np.random.default_rng(seed)
    low = np.float32([5.0, 0.02, 0.01, 0.02, 0.02])
    high = np.float32([90.0, 0.40, 0.40, 0.30, 0.30])
    return (low + (high - low) * rng.random((lanes, 5))).astype(np.float32)


def lane_case(seed, num_slots, num_markets, np_dtype, lanes, kind="random",
              steps=2, device="cpu", rates="cycled", order="shuffled"):
    """One plan over C lanes of flat state: lane 0 is ``_flat_case``'s
    state, the others redrawn from the seed over the same rows. ``rates``
    "cycled" gives the lanes :data:`RATES`' rows in turn, "distinct"
    every lane its own (:func:`distinct_rates`). ``order`` "shuffled"
    keeps ``_flat_case``'s rows (each slot a row drawn at random), "rows"
    gives the masked slots the rows 0, 1, ... market by market, in slot
    order: the layout of a store that interned the plan's pairs in order,
    whose tiles the lane kernel settles a group of lanes a block."""
    block, rows, flat = _flat_case(seed, num_slots, num_markets, np_dtype,
                                   kind=kind)
    if order == "rows":
        mask_t = block["mask"].T
        rows_t = rows.T.copy()
        rows_t[mask_t] = np.arange(int(mask_t.sum()), dtype=np.int32)
        rows = np.ascontiguousarray(rows_t.T)
    rng = np.random.default_rng(seed + 1)
    capacity = len(flat["rel"])
    stacked = {key: [flat[key]] for key in flat}
    for _lane in range(1, lanes):
        stacked["rel"].append(rng.uniform(0.0, 1.0, capacity).astype(np_dtype))
        stacked["conf"].append(rng.uniform(0.0, 1.0, capacity).astype(np_dtype))
        stacked["days"].append(rng.choice([0.0, 2.0, 40.0, 499.0], capacity)
                               .astype(np_dtype))
        stacked["exists"].append(rng.random(capacity) < 0.5)
    lanes_flat = {key: np.stack(values) for key, values in stacked.items()}
    _touched, args = _args(block, rows, lanes_flat, DTYPES_OF[np_dtype], steps,
                           device)
    table = (RATES[np.arange(lanes) % len(RATES)] if rates == "cycled"
             else distinct_rates(seed + 2, lanes))
    params = torch.tensor(table, device=device)
    return (*args, params)


DTYPES_OF = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.mark.parametrize("steps", [0, 1, 3])
@pytest.mark.parametrize("name", ["f32", "f64"])
def test_plain_lanes_are_the_single_lane_plain_version(name, steps):
    np_dtype, torch_dtype = DTYPES[name]
    args = lane_case(3, 6, 70, np_dtype, 3, steps=steps)
    got = settle_kernel.settle_cycles_lanes(*args)
    rel, conf, days, exists, *plan, params = args
    for lane in range(3):
        want = settle_kernel.settle_cycles_reference(
            rel[lane], conf[lane], days[lane], exists[lane], *plan,
            params=settle_kernel.lane_params(params[lane], torch_dtype),
            ordered=True,
        )
        for field in range(4):
            assert torch.equal(got[field][lane], want[field])
        torch.testing.assert_close(got.consensus[lane], want.consensus,
                                   rtol=0, atol=0, equal_nan=True)
    # Functional on the CPU: the inputs keep their values.
    assert torch.equal(rel, lane_case(3, 6, 70, np_dtype, 3, steps=steps)[0])


def test_lane_rates_reach_the_state():
    """The altered lanes' rates move the state off the recorded lane's
    (same inputs in every lane)."""
    rel, conf, days, exists, *plan, _params = lane_case(4, 5, 90, np.float32, 1)
    stacked = [x.repeat(3, 1) for x in (rel, conf, days, exists)]
    out = settle_kernel.settle_cycles_lanes(
        *stacked, *plan, torch.tensor(RATES))
    assert not torch.equal(out.reliability[0], out.reliability[1])
    assert not torch.equal(out.reliability[0], out.reliability[2])
    assert torch.equal(out.confidence[0], out.confidence[1])  # growth kept
    recorded = settle_kernel.settle_cycles_reference(rel[0], conf[0], days[0],
                                                     exists[0], *plan)
    assert torch.equal(out.reliability[0], recorded.reliability)


def test_lanes_bound_bytes():
    """The byte bound counts the plan once and each lane's state."""
    one = settle_kernel.lanes_bound_bytes(1, 15, 1000, 4000, [3000], 20, 4)
    two = settle_kernel.lanes_bound_bytes(2, 15, 1000, 4000, [3000, 3000], 20, 4)
    plan = 15 * 1000 + 4000 * 8 + 1000 * 9
    lane = 1000 * 4 + 4000 + 3000 * 8 + 4000 * 12 + 1000
    assert one == plan + 20 + lane and two == plan + 40 + 2 * lane


def test_params_fields_are_the_cycle_params():
    assert settle_kernel.PARAM_FIELDS == CycleParams._fields


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lane kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 1, 2, 20])
@pytest.mark.parametrize("lanes", [1, 3, 16, 17, 33, 64])
@pytest.mark.parametrize("num_slots, num_markets, kind, rates, order", [
    (5, 1037, "random", "cycled", "shuffled"),
    (15, 600, "random", "cycled", "shuffled"),
    (200, 1037, "ragged", "cycled", "shuffled"),
    (15, 600, "random", "distinct", "shuffled"),
    (5, 1037, "random", "cycled", "rows"),
    (200, 1037, "ragged", "cycled", "rows"),
    (15, 600, "random", "distinct", "rows"),
])
@pytest.mark.parametrize("name", ["f32", "f64"])
def test_cuda_lane_kernel_matches_plain_version(cuda_device, name, num_slots,
                                                num_markets, kind, rates,
                                                order, lanes, steps):
    np_dtype, torch_dtype = DTYPES[name]
    args = lane_case(8, num_slots, num_markets, np_dtype, lanes, kind=kind,
                     steps=steps, device=cuda_device, rates=rates,
                     order=order)
    want = settle_kernel.settle_cycles_lanes_reference(*args)
    clones = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    launches = settle_kernel.LANE_LAUNCHES
    routes = torch.zeros(settle_kernel.LANE_ROUTE_SLOTS, dtype=torch.int32,
                         device=cuda_device)
    got = settle_kernel.settle_cycles_lanes(*clones, routes=routes)
    torch.cuda.synchronize()
    assert settle_kernel.LANE_LAUNCHES == launches + 1
    staged, wide, stage, grouped, shared, group_lanes = routes.tolist()
    assert staged + wide == lanes * -(-num_markets // 256)
    if kind == "ragged":
        assert wide == lanes
    # Rows in plan order: every tile settled a group of lanes a block;
    # shuffled: none.
    assert grouped == (staged + wide if order == "rows" else 0)
    itemsize = torch.empty((), dtype=torch_dtype).element_size()
    assert stage * (2 * itemsize + 5) < shared <= 48 * 1024
    groups = -(-lanes // 16)
    assert group_lanes == -(-lanes // groups)
    # The main kernel's three-slot report still takes the lane launch.
    three = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    settle_kernel.settle_cycles_lanes(
        *[a.clone() if isinstance(a, torch.Tensor) else a for a in args],
        routes=three)
    assert three.tolist() == [staged, wide, stage]
    assert got.reliability.data_ptr() == clones[0].data_ptr()  # in place
    for field in range(5):
        ours, theirs = got[field].cpu().numpy(), want[field].cpu().numpy()
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.cuda
def test_cuda_lane_wrapper_rejects_bad_inputs(cuda_device):
    args = list(lane_case(9, 4, 64, np.float32, 3, device=cuda_device))
    wrong = list(args)
    wrong[-1] = args[-1].double()
    with pytest.raises(TypeError, match="params"):
        settle_kernel.settle_cycles_lanes(*wrong)
    wrong = list(args)
    wrong[-1] = args[-1][:2]
    with pytest.raises(ValueError, match="params"):
        settle_kernel.settle_cycles_lanes(*wrong)


def _step_inputs(device, lanes=4, seed=11):
    rel, conf, days, exists, rows, probs, mask, outcome, offsets, touched, \
        now0, _steps, params = lane_case(seed, 7, 900, np.float32, lanes,
                                         device=device)
    state = (rel, conf, days, exists)
    cycle = CycleParams(*(params[:, i] for i in range(5)))
    band_z = torch.tensor([1.96, 1.25, 1.5, 2.0][:lanes], device=device)
    metrics = torch.zeros((lanes, 4), dtype=torch.float32, device=device)
    return (state, metrics, cycle, band_z, (), rows, probs, mask, outcome,
            now0, ()), (offsets, touched)


def test_replay_step_derives_the_touched_layout():
    """Given no ``touched=``, the step takes the offsets and the masked
    count from the mask: the same lanes as with the plan's."""
    step = build_replay_sweep_step(2)
    args, touched = _step_inputs(torch.device("cpu"))
    with_plan = step(*args, touched=touched)
    args, _touched = _step_inputs(torch.device("cpu"))
    from_mask = step(*args)
    for ours, theirs in zip((*with_plan[0], with_plan[1]),
                            (*from_mask[0], from_mask[1])):
        assert torch.equal(ours, theirs)
    assert build_replay_sweep_step(2) is step  # one step a (steps, depth)


@pytest.mark.cuda
def test_cuda_replay_step_matches_cpu_and_itself(cuda_device):
    step = build_replay_sweep_step(3)
    runs = []
    for device in (cuda_device, cuda_device, torch.device("cpu")):
        args, touched = _step_inputs(device)
        launches = settle_kernel.LANE_LAUNCHES
        state, metrics = step(*args, touched=touched)
        if device.type == "cuda":
            assert settle_kernel.LANE_LAUNCHES == launches + 1
        runs.append(([x.cpu() for x in state], metrics.cpu()))
    (card, card_m), (again, again_m), (cpu, cpu_m) = runs
    for a, b, c in zip(card, again, cpu):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(card_m, again_m)
    torch.testing.assert_close(card_m, cpu_m, rtol=1e-5, atol=1e-5)
