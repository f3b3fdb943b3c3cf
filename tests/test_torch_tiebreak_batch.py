"""The port's sort-based tie-break ≡ the JAX package's.

Two levels, each against the JAX package on the CPU:

* ``ops.tiebreak.batched_tiebreak`` against the reference's jitted
  ``build_batched_tiebreak``: every field bit-equal, on hand-built rows
  that resolve at each ``resolved_by`` level (the reliability-decided
  density tie included), equal keys in unsorted order with distinct
  weights (the sort must be stable: the order inside a group moves the
  running weight sums), empty rows, one-agent rows, and seeded random
  rows 1 to 32 agents wide on a grid whose weights add exactly; and rows
  with weights that do not add exactly, bit-equal up to 16 agents and,
  wider, within rtol 1e-5, atol 1e-3 (the port adds a row's running
  weight sums left to right; XLA CPU's ``cumsum`` blocks a row wider than
  16 agents, so a group's density may differ in its last bits).
* ``AnalyticsOptions(tiebreak="sorted")`` through
  ``settle_with_analytics`` on a (1, 1) mesh against the JAX session, two
  chained calls: the block state, records and SQLite dump bit-equal, the
  consensus within rtol 1e-5, atol 1e-6; the tie-break and bands bit-equal
  where no read decays, and within rtol 1e-5, atol 1e-3 where reads decay,
  the tolerance the port states for ``exp2``: there the group counts are
  equal, and ``resolved_by`` and the prediction on every row but multi-group
  rows whose decision differs while the winner's density and maximum
  reliability sit within a few ulps of the JAX package's (the hierarchy
  compares group metrics exactly, and an ulp of ``exp2`` can decide a
  near tie); such rows are at most 10% of the markets.
  The same at float64 state where no read decays (the tie-break stays
  float32; the JAX session runs it under x64). The refusals: a
  sources-sharded mesh and ``kernel="pallas"``.

The session scenarios run once per module and share their results.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu.ops.tiebreak import (
    build_batched_tiebreak as jax_batched_tiebreak,
)
from bayesian_consensus_engine_tpu_torch import pipeline as tpipe
from bayesian_consensus_engine_tpu_torch.analytics import AnalyticsOptions
from bayesian_consensus_engine_tpu_torch.ops import (
    BatchTieBreakResult,
    batched_tiebreak,
    build_batched_tiebreak,
)
from bayesian_consensus_engine_tpu_torch.parallel import mesh as tmesh
from bayesian_consensus_engine_tpu_torch.utils.timeconv import days_to_iso

from test_torch_session import (
    ANALYTICS_TOL,
    NOW,
    STATE_FIELDS,
    STEPS,
    TOL,
    Side,
    _dump,
    _fields,
    _records,
    make_payloads,
)

FIELDS = BatchTieBreakResult._fields


@pytest.fixture(scope="module")
def jax_tiebreak():
    return jax_batched_tiebreak(6)


#: How far (in float32 ulps) a winner's density or maximum reliability may
#: sit from the JAX package's for the row's decision to be exempt: the
#: hierarchy compares group metrics for exact equality, so where two
#: groups of a row sit within an ulp of each other, an ulp of a sum taken
#: in another order (or of ``exp2``) can turn a full tie into a win, or
#: pick the other group.
CODE_ULPS = 16

#: The largest share of rows whose decision may be exempt. A quarter of
#: the port's decayed reads differ from the JAX package's by an ulp or
#: two, and the sorted session's second call reads sources that every
#: earlier step updated in lockstep, so many of its markets are multi-way
#: density ties that such an ulp decides (25 of 480 at this seed).
CODE_EXEMPT_SHARE = 0.1


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


def _assert_decisions_match(mine, ref):
    """``resolved_by`` and ``prediction`` equal on every row, except rows of
    two or more groups whose decision differs while the winner's density
    and maximum reliability each sit within :data:`CODE_ULPS` of the JAX
    package's; such rows are at most :data:`CODE_EXEMPT_SHARE` of all.
    Returns the exempt rows."""
    close = ref["num_groups"] >= 2
    for metric in ("weight_density", "max_reliability"):
        a, b = mine[metric], ref[metric]
        close &= (a == b) | (_ulps(a, b) <= CODE_ULPS)
    pred, pred_ref = mine["prediction"], ref["prediction"]
    decided = ((mine["resolved_by"] != ref["resolved_by"])
               | ~((pred == pred_ref) | (np.isnan(pred) & np.isnan(pred_ref))))
    exempt = decided & close
    np.testing.assert_array_equal(mine["resolved_by"][~exempt],
                                  ref["resolved_by"][~exempt],
                                  err_msg="resolved_by")
    np.testing.assert_array_equal(pred[~exempt], pred_ref[~exempt],
                                  err_msg="prediction")
    assert exempt.mean() <= CODE_EXEMPT_SHARE, exempt.sum()
    return exempt


def _compare(rows, jax_tiebreak):
    """Run (pred, weight, conf, rel, valid) numpy blocks through both
    packages; every field must be bit-equal (NaN where NaN)."""
    want = jax_tiebreak(*(jnp.asarray(x) for x in rows))
    got = batched_tiebreak(*(torch.from_numpy(x) for x in rows))
    assert isinstance(got, BatchTieBreakResult)
    for name, mine, ref in zip(FIELDS, got, want):
        mine, ref = mine.numpy(), np.asarray(ref)
        assert mine.dtype == ref.dtype, name
        np.testing.assert_array_equal(mine, ref, err_msg=name)
    return got


def _pack(rows, width):
    """Rows of (prediction, weight, confidence, reliability) agents as
    padded (M, width) float32 blocks and a validity mask."""
    blocks = [np.zeros((len(rows), width), np.float32) for _ in range(4)]
    valid = np.zeros((len(rows), width), bool)
    for i, agents in enumerate(rows):
        for j, agent in enumerate(agents):
            for block, value in zip(blocks, agent):
                block[i, j] = value
            valid[i, j] = True
    return (*blocks, valid)


HAND_ROWS = [
    # unanimous: one group of three
    [(0.7, 1.0, 0.9, 0.5), (0.7, 2.0, 0.8, 0.6), (0.7, 0.5, 0.1, 0.9)],
    # weight density decides
    [(0.7, 2.0, 0.9, 0.8), (0.7, 2.0, 0.8, 0.6), (0.3, 1.0, 0.7, 0.9)],
    # equal density, reliability decides (labelled weight_density)
    [(0.6, 1.0, 0.5, 0.9), (0.4, 1.0, 0.5, 0.2)],
    # full tie: the smallest prediction
    [(0.6, 1.0, 0.5, 0.5), (0.4, 1.0, 0.5, 0.5), (0.8, 1.0, 0.5, 0.5)],
    # equal keys in unsorted order, distinct weights (sort stability)
    [(0.5, 0.3, 0.2, 0.1), (0.2, 0.7, 0.4, 0.3), (0.5, 0.1, 0.6, 0.7),
     (0.2, 0.9, 0.8, 0.2), (0.5, 0.6, 0.1, 0.4), (0.2, 0.1, 0.3, 0.8)],
    # one agent, a prediction with more than six decimals
    [(0.123456789, 1.5, 0.25, 0.5)],
    # empty
    [],
    # keys that round together (half to even) and apart
    [(0.1234565, 1.0, 0.5, 0.5), (0.1234575, 1.0, 0.5, 0.5),
     (0.1234566, 2.0, 0.5, 0.5)],
]


def test_hand_rows_match_jax(jax_tiebreak):
    got = _compare(_pack(HAND_ROWS, 8), jax_tiebreak)
    assert got.resolved_by[:4].tolist() == [0, 1, 1, 2]
    assert np.isnan(got.prediction[6].item())
    assert got.num_groups[6].item() == 0 and got.num_groups[0].item() == 1


@pytest.mark.parametrize("width", [1, 2, 5, 16, 17, 20, 32])
def test_random_rows_match_jax(jax_tiebreak, width):
    """Seeded rows on a 1/8 grid (many ties), weights from a small set
    (many equal densities), a third of the lanes invalid."""
    rng = np.random.default_rng(width)
    shape = (600, width)
    rows = (
        (rng.integers(0, 9, shape) / 8).astype(np.float32),
        rng.choice(np.float32([0.25, 0.5, 0.75, 1.0]), shape),
        rng.random(shape).astype(np.float32),
        rng.choice(np.float32([0.1, 0.5, 0.9]), shape),
        rng.random(shape) < 0.67,
    )
    _compare(rows, jax_tiebreak)


@pytest.mark.parametrize("width", [5, 16, 20, 32])
def test_continuous_weights_match_jax(jax_tiebreak, width):
    """Weights that do not add exactly, so a group's running sum depends on
    its order: bit-equal up to 16 agents, where XLA CPU's ``cumsum`` adds
    left to right as the port does; wider, XLA blocks its ``cumsum`` and
    the port does not, so the densities agree within the decay tolerance,
    the counts exactly, and the decisions as
    :func:`_assert_decisions_match` states."""
    rng = np.random.default_rng(100 + width)
    shape = (2000, width)
    rows = (
        (rng.integers(0, 9, shape) / 8).astype(np.float32),
        rng.random(shape).astype(np.float32),
        rng.random(shape).astype(np.float32),
        rng.choice(np.float32([0.1, 0.5, 0.9]), shape),
        rng.random(shape) < 0.67,
    )
    if width <= 16:
        _compare(rows, jax_tiebreak)
        return
    want = jax_tiebreak(*(jnp.asarray(x) for x in rows))
    got = batched_tiebreak(*(torch.from_numpy(x) for x in rows))
    mine = {name: x.numpy() for name, x in zip(FIELDS, got)}
    ref = {name: np.asarray(x) for name, x in zip(FIELDS, want)}
    for name in ("max_reliability", "num_groups"):
        np.testing.assert_array_equal(mine[name], ref[name], err_msg=name)
    for name in ("weight_density", "confidence_variance"):
        np.testing.assert_allclose(mine[name], ref[name], equal_nan=True,
                                   err_msg=name, **ANALYTICS_TOL)
    _assert_decisions_match(mine, ref)


def test_build_batched_tiebreak_fixes_the_precision(jax_tiebreak):
    rows = _pack(HAND_ROWS, 8)
    tensors = [torch.from_numpy(x) for x in rows]
    for ours, theirs in zip(build_batched_tiebreak(3)(*tensors),
                            batched_tiebreak(*tensors, precision=3)):
        torch.testing.assert_close(ours, theirs, rtol=0, atol=0,
                                   equal_nan=True)


# -- the sorted session --------------------------------------------------------


#: Enough markets that a share of them (:data:`CODE_EXEMPT_SHARE`) is a
#: count of whole rows.
SESSION_MARKETS = 480


def _sorted_scenario(kind, decayed, tmp, dtype="f32"):
    """Two chained sorted-tie-break analytics calls through one package's
    (1, 1) session; returns (consensus, analytics, state, records, dump)."""
    side = Side(kind, dtype)
    payloads, outcomes = make_payloads(4, num_markets=SESSION_MARKETS)
    stamps = (
        ("2024-08-01T00:00:00+00:00", days_to_iso(NOW), "") if decayed
        else (days_to_iso(NOW), "")
    )
    store = side.store(payloads, stamps)
    plan = side.plan(store, payloads)
    session = side.session(store, plan)
    times = (NOW, NOW + STEPS + 9) if decayed else (NOW, NOW + STEPS - 1)
    consensus, analytics = [], []
    for now in times:
        result, tiebreak, bands, propagated = session.settle_with_analytics(
            outcomes, steps=STEPS, now=now,
            analytics=side.options(tiebreak="sorted"),
        )
        assert propagated is None
        consensus.append(result.consensus)
        analytics += [_fields(tiebreak), _fields(bands)]
    state = side.block_state(session)
    session.close()
    return consensus, analytics, state, _records(store), _dump(store, tmp / "s.db")


@pytest.fixture(scope="module")
def sorted_runs(tmp_path_factory):
    cache = {}

    def run(case):
        decayed, dtype = case
        if case not in cache:
            runs = {}
            with pytest.MonkeyPatch.context() as patch:
                patch.setenv("BCE_NO_NATIVE", "1")
                for kind in ("jax", "torch"):
                    tmp = tmp_path_factory.mktemp(f"sorted-{kind}-{decayed}")
                    if kind == "jax" and dtype == "f64":
                        with jax.enable_x64():
                            runs[kind] = _sorted_scenario(kind, decayed, tmp,
                                                          dtype)
                    else:
                        runs[kind] = _sorted_scenario(kind, decayed, tmp, dtype)
            cache[case] = runs
        return cache[case]

    return run


# The sorted tie-break computes in float32 whatever the state's dtype, and
# the JAX package runs it under x64 too (its ring tie-break fails there).
SCENARIOS = pytest.mark.parametrize(
    "case", [(False, "f32"), (True, "f32"), (False, "f64")],
    ids=["exact", "decayed", "exact-f64"])


@SCENARIOS
def test_sorted_session_state_matches_jax(sorted_runs, case):
    runs = sorted_runs(case)
    for field, ours, theirs in zip(STATE_FIELDS, runs["torch"][2],
                                   runs["jax"][2]):
        np.testing.assert_array_equal(ours, theirs, err_msg=field)
    assert runs["torch"][3] == runs["jax"][3] and runs["torch"][3]
    assert runs["torch"][4] == runs["jax"][4]


@SCENARIOS
def test_sorted_session_consensus_matches_jax(sorted_runs, case):
    runs = sorted_runs(case)
    for ours, theirs in zip(runs["torch"][0], runs["jax"][0]):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
        np.testing.assert_allclose(ours, theirs, equal_nan=True, **TOL[case[1]])


@SCENARIOS
def test_sorted_session_analytics_match_jax(sorted_runs, case):
    decayed = case[0]
    runs = sorted_runs(case)
    ours, theirs = runs["torch"][1], runs["jax"][1]
    assert len(ours) == len(theirs) == 4
    for mine, ref in zip(ours, theirs):
        assert mine.keys() == ref.keys()
        for name in ref:
            a, b = mine[name], ref[name]
            assert a.dtype == b.dtype, name
            if not decayed or name in ("num_groups", "count"):
                np.testing.assert_array_equal(a, b, err_msg=name)
            elif name in ("resolved_by", "prediction"):
                _assert_decisions_match(mine, ref)
            else:
                np.testing.assert_allclose(a, b, equal_nan=True, err_msg=name,
                                           **ANALYTICS_TOL)
    # Empty markets take the sorted convention: NaN prediction, zeroed stats.
    tiebreak = ours[0]
    empty = tiebreak["num_groups"] == 0
    assert empty.any()
    assert np.isnan(tiebreak["prediction"][empty]).all()
    assert (tiebreak["weight_density"][empty] == 0).all()


def _port_store(payloads):
    return Side("torch", "f32").store(payloads, ("2024-08-01T00:00:00+00:00",))


def test_sorted_on_sources_sharded_mesh_raises():
    payloads, outcomes = make_payloads(4)
    store = _port_store(payloads)
    plan = tpipe.build_settlement_plan(store, payloads)
    mesh = tmesh.make_mesh((1, 4), [torch.device("cpu")] * 4)
    with tpipe.ShardedSettlementSession(store, plan, mesh) as session:
        with pytest.raises(ValueError, match="sources axis 4 ways"):
            session.settle_with_analytics(
                outcomes, now=NOW, analytics=AnalyticsOptions(tiebreak="sorted"),
            )


def test_sorted_with_pallas_kernel_raises():
    payloads, outcomes = make_payloads(4)
    store = _port_store(payloads)
    plan = tpipe.build_settlement_plan(store, payloads)
    with tpipe.ShardedSettlementSession(store, plan) as session:
        with pytest.raises(ValueError, match="kernel='pallas' unavailable"):
            session.settle_with_analytics(
                outcomes, now=NOW, kernel="pallas",
                analytics=AnalyticsOptions(tiebreak="sorted"),
            )
