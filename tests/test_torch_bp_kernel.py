"""The belief-propagation sweep kernel's wrapper and plain version, and the
CUDA kernel against it.

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest tests/test_torch_bp_kernel.py -q

``tests/test_torch_infer.py`` holds the plain version
(``ops/propagate.py::bp_sweep_math``) against the JAX package. Here: the
byte bound counted by hand, the wrapper's checks, the plain version taken
for CPU tensors only, the early exit's semantics, and the ``cuda`` cases:
the kernel against the plain version on the card, over the cases
``chip_smoke.py``'s ``bp_check`` uses (M = 1037; D in {1, 2, 8, 33}; the
point lane with either blend contraction and the moments lane; fixed and
adaptive depth, the tolerance reached after 1, 5 or all of the sweeps;
``max_steps`` in {1, 2, 24}; edgeless rows, NaN seeds,
zero variances and a row whose mix is NaN), and at 300,000 rows (more
than one wave of the persistent grid) on every lane, with early exits
after 1 and 6 sweeps and at fixed depth 24: mean, variance, ``iters_run``
and ``residual`` bit-equal (a NaN compares as NaN), one launch a call;
the banded sweep's step (``infer/partition.py``: one launch, ``max_steps=1``
and no tolerance, over a band's own rows and its halo, whose neighbour
rows are ``-1``) at D = 5 with the halo rows last and first, on every
lane; and ``banded_bp_sweep`` over four uneven bands bit-equal to one
whole-axis launch, one launch a band an iteration. They skip where there
is no card.
"""

import numpy as np
import pytest
import torch

from bayesian_consensus_engine_tpu_torch.ops import bp_kernel, cuda_build, partials_kernel

# lane → (moments, keep_fma): the point lane as propagate_beliefs runs it,
# as the session runs it (the reference's damped sweep), and moments.
LANES = {"point": (False, None), "point_keep": (False, True), "moments": (True, None)}
TOL = 1e-3


def bp_case(seed, num_markets, degree):
    """``(means, variances, neighbor_idx, neighbor_w)`` as numpy arrays:
    pads, edgeless rows, NaN seeds, zero variances and, with D = 33, one
    row with infinite weights (its mix is NaN: a NaN residual)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, num_markets, (num_markets, degree)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.2] = -1
    idx[::11] = -1  # edgeless rows
    weights = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
    means = rng.random(num_markets).astype(np.float32)
    variances = (rng.random(num_markets) * 0.01).astype(np.float32)
    means[rng.random(num_markets) < 0.05] = np.nan
    variances[rng.random(num_markets) < 0.1] = 0.0
    if degree == 33:
        idx[7] = np.arange(degree) + 20
        weights[7] = np.inf
    return means, variances, idx, weights


def case_tensors(case, moments, device="cpu"):
    means, variances, idx, weights = (torch.tensor(x, device=device) for x in case)
    return means, variances if moments else None, idx, weights


def assert_bits(got, want, what):
    """Bit-equal float tensors; NaNs compare as NaN whatever their payload."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32), err_msg=what)


def test_bound_bytes_counts_each_byte_once():
    # 10 markets, D = 3, 4 sweeps run: idx + weights 10*3*8 per sweep,
    # mean and variance read and written 10*16 (moments) or the mean
    # alone 10*8 (point); then the 8-byte audit pair.
    assert bp_kernel.bound_bytes(10, 3, 4, True) == 4 * (10 * 3 * 8 + 10 * 16) + 8
    assert bp_kernel.bound_bytes(10, 3, 4, False) == 4 * (10 * 3 * 8 + 10 * 8) + 8
    assert bp_kernel.bound_bytes(10, 3, 1, True) == 10 * 3 * 8 + 10 * 16 + 8
    assert bp_kernel.bound_bytes(10, 3, 0, True) == 0
    # The chip's inference path: 1M markets, D = 5, moments: 56 MB a sweep.
    assert bp_kernel.bound_bytes(1_000_000, 5, 1, True) == 56_000_008


def test_launches_per_call():
    # One cooperative launch runs every sweep of a call; none at depth 0.
    assert [bp_kernel.launches_per_call(n) for n in (0, 1, 2, 24)] == [0, 1, 1, 1]


def test_every_kernel_source_is_registered():
    assert bp_kernel.SOURCE in cuda_build.SOURCES
    assert partials_kernel.SOURCE in cuda_build.SOURCES
    assert len(cuda_build.SOURCES) == 4
    assert all(source.is_file() for source in cuda_build.SOURCES)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi4EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi4EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 0 barriers, 360 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILin1EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILin1EEvPf
    544 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 47 registers, used 0 barriers, 544 bytes cumulative stack size
"""


def test_ptxas_report_reads_each_entry_function():
    assert cuda_build.ptxas_report(PTXAS_LOG) == {
        "_Z6kernelILi4EEvPf": dict(
            stack_bytes=0, spill_stores=0, spill_loads=0, registers=62),
        "_Z6kernelILin1EEvPf": dict(
            stack_bytes=544, spill_stores=4, spill_loads=8, registers=47),
    }
    assert cuda_build.ptxas_report("") == {}


def test_a_reused_build_returns_its_log(tmp_path, monkeypatch):
    """The build log is kept beside the library: a second build of the
    same source compiles nothing and returns the first build's log; a
    library found without its log is built again."""
    nvcc = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    # A stand-in compiler: writes the -o file, prints a log, counts calls.
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"\n'
        f"cat <<'EOF'\n{PTXAS_LOG}EOF\n"
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    source = tmp_path / "kernel.cu"
    source.write_text("// a kernel\n")
    (library, first), = cuda_build.build(source)
    (again, second), = cuda_build.build(source)
    assert library == again and library.read_text() == "lib\n"
    assert first == second == PTXAS_LOG
    assert calls.read_text() == "x\n"
    library.with_suffix(".log").unlink()
    (_library, third), = cuda_build.build(source)
    assert third == PTXAS_LOG
    assert calls.read_text() == "x\nx\n"


def test_plain_version_only_for_cpu_tensors(monkeypatch):
    """CPU tensors take the plain version; anything else that is not CUDA
    raises before it, instead of falling back."""
    calls = []
    real = bp_kernel.bp_sweep_reference

    def counting(*args, **kwargs):
        calls.append(args[0].device.type)
        return real(*args, **kwargs)

    monkeypatch.setattr(bp_kernel, "bp_sweep_reference", counting)
    case = bp_case(1, 40, 2)
    bp_kernel.bp_sweep(*case_tensors(case, True), max_steps=3)
    assert calls == ["cpu"]
    meta = [x.to("meta") if x is not None else None
            for x in case_tensors(case, True)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        bp_kernel.bp_sweep(*meta, max_steps=3)
    assert calls == ["cpu"]


@pytest.mark.parametrize("change, error, match", [
    (lambda m, v, i, w: (m.double(), v, i, w), TypeError, "means has dtype"),
    (lambda m, v, i, w: (m, v.double(), i, w), TypeError, "variances has dtype"),
    (lambda m, v, i, w: (m, v, i.long(), w), TypeError, "neighbor_idx has dtype"),
    (lambda m, v, i, w: (m, v, i, w.half()), TypeError, "neighbor_w has dtype"),
    (lambda m, v, i, w: (m, v[:-1], i, w), ValueError, "variances has shape"),
    (lambda m, v, i, w: (m, v, i[:-1], w), ValueError, "neighbor_idx has shape"),
    (lambda m, v, i, w: (m, v, i, w[:, :1]), ValueError, "neighbor_w has shape"),
    (lambda m, v, i, w: (m, v, i.t().contiguous().t(), w), ValueError,
     "contiguous"),
    (lambda m, v, i, w: (m[None], v, i, w), ValueError, r"means must be \(M,\)"),
    (lambda m, v, i, w: (m.numpy(), v, i, w), TypeError, "torch.Tensor"),
])
def test_wrapper_refuses_bad_inputs(change, error, match):
    args = change(*case_tensors(bp_case(2, 30, 3), True))
    with pytest.raises(error, match=match):
        bp_kernel.bp_sweep(*args, max_steps=2)


@pytest.mark.parametrize("tol", [0.0, -1.0])
def test_wrapper_refuses_non_positive_tol(tol):
    with pytest.raises(ValueError, match="positive residual tolerance"):
        bp_kernel.bp_sweep(*case_tensors(bp_case(2, 30, 3), True), tol=tol)


def test_zero_steps_launches_nothing():
    launches = bp_kernel.LAUNCHES
    means, variances, idx, weights = case_tensors(bp_case(3, 50, 4), True)
    mean, var, iters, residual = bp_kernel.bp_sweep(
        means, variances, idx, weights, max_steps=0, tol=TOL)
    assert mean is means and var is variances
    assert int(iters) == 0 and float(residual) == 0.0
    assert bp_kernel.LAUNCHES == launches and bp_kernel.launches_per_call(0) == 0


def mid_tol(args, keep_fma, depth=7):
    """A tolerance the early exit reaches within ``depth`` sweeps: the
    fixed-depth sweep's residual after that many."""
    return float(bp_kernel.bp_sweep_reference(
        *args, damping=0.3, max_steps=depth, keep_fma=keep_fma)[3])


@pytest.mark.parametrize("lane", sorted(LANES))
def test_adaptive_equals_fixed_at_its_depth(lane):
    """The early exit stops after the first sweep whose residual is at or
    below tol; the fixed-depth sweep of that many steps gives the same
    bits, and reports the same residual."""
    moments, keep_fma = LANES[lane]
    args = case_tensors(bp_case(4, 300, 5), moments)
    tol = mid_tol(args, keep_fma)
    adaptive = bp_kernel.bp_sweep(*args, damping=0.3, max_steps=24, tol=tol,
                                  keep_fma=keep_fma)
    iters = int(adaptive[2])
    assert 1 < iters <= 7 and float(adaptive[3]) <= tol
    fixed = bp_kernel.bp_sweep(*args, damping=0.3, max_steps=iters,
                               keep_fma=keep_fma)
    assert int(fixed[2]) == iters
    for a, b, what in zip(adaptive, fixed, ("mean", "var", "iters", "residual")):
        if b is not None:
            assert_bits(a, b, what)


def test_nan_residual_stops_the_sweep():
    args = case_tensors(bp_case(5, 100, 33), True)
    mean, _var, iters, residual = bp_kernel.bp_sweep(*args, max_steps=24, tol=TOL)
    assert int(iters) == 1 and np.isnan(float(residual))
    assert np.isnan(float(mean[7]))


# -- the CUDA kernel against its plain version (on the card only) ------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bp_sweep kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("degree", [1, 2, 8, 33])
def test_cuda_kernel_matches_plain_version(cuda_device, degree, lane):
    moments, keep_fma = LANES[lane]
    case = bp_case(10 + degree, 1037, degree)
    # Early exits after an odd and an even count of sweeps.
    mid = mid_tol(case_tensors(case, moments), keep_fma, depth=5 + degree % 2)
    for tol in (None, TOL, mid):
        for max_steps in (1, 2, 24):
            what = f"D={degree} {lane} tol={tol} max_steps={max_steps}"
            args = case_tensors(case, moments, cuda_device)
            seeds = [x.clone() for x in args if x is not None]
            sweep = dict(damping=0.3, max_steps=max_steps, tol=tol,
                         keep_fma=keep_fma)
            want = bp_kernel.bp_sweep_reference(*args, **sweep)
            launches = bp_kernel.LAUNCHES
            got = bp_kernel.bp_sweep(*args, **sweep)
            torch.cuda.synchronize()
            assert bp_kernel.LAUNCHES == launches + 1, what
            for field, a, b in zip(("mean", "var", "iters", "residual"), got, want):
                if b is None:
                    assert a is None, what
                elif field == "iters":
                    assert a.dtype == torch.int32 and int(a) == int(b), what
                else:
                    assert_bits(a, b, f"{what} {field}")
            for before, after in zip(seeds, (x for x in args if x is not None)):
                assert_bits(after, before, f"{what}: an input changed")


@pytest.mark.cuda
@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("stop", ["after_1", "after_6", "fixed_24"])
def test_cuda_kernel_beyond_one_wave(cuda_device, lane, stop):
    """300,000 rows: each thread of the persistent grid walks several rows
    a sweep, and the early exit must stop every block at the same sweep."""
    moments, keep_fma = LANES[lane]
    case = bp_case(21, 300_000, 5)
    args = case_tensors(case, moments, cuda_device)
    sweep = dict(damping=0.3, keep_fma=keep_fma)
    tol, expected = {
        "after_1": (10.0, 1),
        "after_6": (mid_tol(args, keep_fma, depth=6), 6),
        "fixed_24": (None, 24),
    }[stop]
    want = bp_kernel.bp_sweep_reference(*args, max_steps=24, tol=tol, **sweep)
    assert int(want[2]) == expected
    launches = bp_kernel.LAUNCHES
    got = bp_kernel.bp_sweep(*args, max_steps=24, tol=tol, **sweep)
    torch.cuda.synchronize()
    assert bp_kernel.LAUNCHES == launches + 1
    assert got[2].dtype == torch.int32 and int(got[2]) == expected
    for field, a, b in zip(("mean", "var", "residual"),
                           (got[0], got[1], got[3]), (want[0], want[1], want[3])):
        if b is None:
            assert a is None
        else:
            assert_bits(a, b, f"{lane} {stop} {field}")


@pytest.mark.cuda
def test_cuda_zero_steps_launch_nothing(cuda_device):
    launches = bp_kernel.LAUNCHES
    args = case_tensors(bp_case(6, 64, 3), True, cuda_device)
    out = bp_kernel.bp_sweep(*args, max_steps=0)
    assert bp_kernel.LAUNCHES == launches and out[0] is args[0]
    assert int(out[2]) == 0 and float(out[3]) == 0.0


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    means, variances, idx, weights = case_tensors(bp_case(7, 64, 3), True, cuda_device)
    with pytest.raises(ValueError, match="neighbor_idx is on cpu"):
        bp_kernel.bp_sweep(means, variances, idx.cpu(), weights)
    with pytest.raises(TypeError, match="means has dtype"):
        bp_kernel.bp_sweep(means.double(), variances, idx, weights)
    with pytest.raises(ValueError, match="contiguous"):
        bp_kernel.bp_sweep(means, variances, idx, weights.t().contiguous().t())


def band_step_case(seed, halo_at, rows=700, halo=300, degree=5):
    """One band step's operands, as ``infer/partition.py`` lays them out:
    the vector of a band's own rows and its halo, neighbour rows indexing
    into it, and ``-1`` rows for the halo (they never mix). *halo_at*
    puts the halo rows last (the layout ``banded_bp_sweep`` uses) or
    first in the index space."""
    means, variances, idx, weights = bp_case(seed, rows + halo, degree)
    own = np.arange(halo, rows + halo) if halo_at == "first" else np.arange(rows)
    halo_rows = np.setdiff1d(np.arange(rows + halo), own)
    idx[halo_rows] = -1
    return means, variances, idx, weights, own, halo_rows


@pytest.mark.cuda
@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("halo_at", ["last", "first"])
def test_cuda_band_step_matches_plain_version(cuda_device, halo_at, lane):
    """The banded sweep's step: one ``bp_sweep`` launch with
    ``max_steps=1`` and no tolerance over ``[own ; halo]`` (D = 5). The
    halo rows keep their values, the residual is the own rows' ``max
    |Δmean|``, and every bit equals the plain version's."""
    moments, keep_fma = LANES[lane]
    *case, own, halo_rows = band_step_case(31, halo_at)
    args = case_tensors(case, moments, cuda_device)
    sweep = dict(damping=0.35, max_steps=1, tol=None, keep_fma=keep_fma)
    want = bp_kernel.bp_sweep_reference(*args, **sweep)
    launches = bp_kernel.LAUNCHES
    got = bp_kernel.bp_sweep(*args, **sweep)
    torch.cuda.synchronize()
    assert bp_kernel.LAUNCHES == launches + 1
    assert int(got[2]) == 1
    for field, a, b in zip(("mean", "var", "residual"),
                           (got[0], got[1], got[3]), (want[0], want[1], want[3])):
        if b is None:
            assert a is None
        else:
            assert_bits(a, b, f"{halo_at} {lane} {field}")
    halo = torch.as_tensor(halo_rows, device=cuda_device)
    assert_bits(got[0][halo], args[0][halo], "halo means moved")
    delta = (got[0] - args[0]).abs()[torch.as_tensor(own, device=cuda_device)]
    finite = delta[~torch.isnan(delta)]
    assert float(got[3]) == float(finite.max())


@pytest.mark.cuda
@pytest.mark.parametrize("stop", ["fixed_12", "after_5"])
def test_cuda_banded_sweep_equals_the_whole_axis_sweep(cuda_device, stop):
    """``infer/partition.banded_bp_sweep`` on the card: bit-equal to one
    whole-axis ``bp_sweep`` launch, one launch a band an iteration."""
    from bayesian_consensus_engine_tpu_torch.infer import partition

    means, variances, idx, weights = bp_case(41, 5000, 5)
    bands = [(0, 1200), (1200, 1201), (1201, 3900), (3900, 5000)]
    banded = partition.partition_csr(idx, weights, bands)
    assert banded.cross_edges > 0
    args = case_tensors((means, variances, idx, weights), True, cuda_device)
    tol = None if stop == "fixed_12" else mid_tol(args, None, depth=5)
    sweep = dict(damping=0.3, max_steps=12, tol=tol)
    want = bp_kernel.bp_sweep(*args, **sweep)
    launches = bp_kernel.LAUNCHES
    got = partition.banded_bp_sweep(args[0], args[1], banded, **sweep)
    torch.cuda.synchronize()
    iters = int(want[2])
    assert int(got[2]) == iters == (12 if tol is None else 5)
    assert bp_kernel.LAUNCHES == launches + len(bands) * iters
    for field, a, b in zip(("mean", "var", "residual"),
                           (got[0], got[1], got[3]), (want[0], want[1], want[3])):
        assert_bits(a, b, f"{stop} {field}")
