"""The port's inference ops and host layer ≡ the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX package
and the port:

* ``ops/propagate.py``: the port's ``bp_sweep_math`` (the plain version
  of the ``bp_sweep`` kernel) and ``damped_sweep_math`` against
  ``jax.jit(bp_sweep_math)`` at ``axis_name=None``, the route the JAX
  session runs by default, over {sparse degree 2, dense degree 8, one lane,
  edgeless, NaN neighbours, zero variances, an infinite weight} ×
  {point, moments} × {fixed depth, adaptive ``tol``} × λ ∈ {0.3, 0.5}:
  mean, variance, ``iters_run`` and ``residual`` bit-equal in every cell
  (a NaN compares as NaN). λ = 0.5 makes every blend product exact; 0.3
  shows where XLA contracts the blends into fused multiply-adds. The
  Pallas route is not the yardstick: it is pinned bit-equal to this one
  in interpret mode by ``tests/test_pallas_bp.py``;
* ``MarketGraph``: fingerprints byte-equal, and ``align`` byte-equal with
  absent markets, duplicate edges, nodes with no surviving edge and
  ``padded_total`` above the market count; ``market_graph_from_fields``
  carries a JAX graph across;
* ``InferenceOptions`` validation, ``MarketBlocks.to_edges`` and
  ``project``, and ``propagate_beliefs`` under both kernel names.

Each jitted reference is compiled once per module and shared.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu.analytics.graph import MarketGraph as JaxGraph
from bayesian_consensus_engine_tpu.infer import blocks as jblocks
from bayesian_consensus_engine_tpu.infer import bp as jbp
from bayesian_consensus_engine_tpu.ops import propagate as jprop
from bayesian_consensus_engine_tpu_torch import convert
from bayesian_consensus_engine_tpu_torch import infer as tinfer
from bayesian_consensus_engine_tpu_torch.analytics import MarketGraph
from bayesian_consensus_engine_tpu_torch.infer import (
    InferenceOptions,
    MarketBlock,
    MarketBlocks,
    propagate_beliefs,
)
from bayesian_consensus_engine_tpu_torch.ops import propagate

NUM = 96  # markets in the sweep matrix


def sweep_case(kind, seed=11):
    """``(means, variances, neighbor_idx, neighbor_w)`` as numpy f32/i32."""
    rng = np.random.default_rng(seed)
    degree = {"sparse2": 2, "dense8": 8, "one_lane": 1, "edgeless": 1}.get(kind, 4)
    idx = rng.integers(0, NUM, (NUM, degree)).astype(np.int32)
    idx[rng.random((NUM, degree)) < 0.25] = -1  # padding lanes
    if kind == "edgeless":
        idx[:] = -1
    weights = rng.uniform(0.25, 2.0, (NUM, degree)).astype(np.float32)
    means = rng.random(NUM).astype(np.float32)
    variances = (rng.random(NUM) * 0.02).astype(np.float32)
    if kind == "nan_neighbour":
        means[rng.random(NUM) < 0.2] = np.nan
        variances[rng.random(NUM) < 0.1] = np.nan
    if kind == "zero_variance":
        variances[rng.random(NUM) < 0.3] = 0.0
    if kind == "inf_weight":  # a row whose mix is NaN: a NaN residual
        weights[5, :] = np.inf
        idx[5, :] = np.arange(degree) + 10
    return means, variances, idx, weights


KINDS = ["sparse2", "dense8", "one_lane", "edgeless", "nan_neighbour",
         "zero_variance", "inf_weight"]
MAX_STEPS = 6


@pytest.fixture(scope="module")
def jax_sweep():
    """``jax.jit(bp_sweep_math)`` per static configuration, shared."""
    cache = {}

    def get(damping, tol, moments):
        key = (damping, tol, moments)
        if key not in cache:
            fn = partial(jprop.bp_sweep_math, damping=damping,
                         max_steps=MAX_STEPS, tol=tol)
            cache[key] = (jax.jit(fn) if moments
                          else jax.jit(lambda m, i, w: fn(m, None, i, w)))
        return cache[key]

    return get


def assert_bits(got, want, what):
    """Bit-equal float arrays; NaNs compare as NaN whatever their payload."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32), err_msg=what)


@pytest.mark.parametrize("damping", [0.3, 0.5])
@pytest.mark.parametrize("depth", ["fixed", "adaptive"])
@pytest.mark.parametrize("lane", ["point", "moments"])
@pytest.mark.parametrize("kind", KINDS)
def test_sweep_bit_equal_to_jitted_reference(jax_sweep, kind, lane, depth, damping):
    means, variances, idx, weights = sweep_case(kind)
    moments = lane == "moments"
    tol = 1e-3 if depth == "adaptive" else None
    fn = jax_sweep(damping, tol, moments)
    want = (fn(means, variances, idx, weights) if moments
            else fn(means, idx, weights))
    got = propagate.bp_sweep_math(
        torch.from_numpy(means), torch.from_numpy(variances) if moments else None,
        torch.from_numpy(idx), torch.from_numpy(weights),
        damping=damping, max_steps=MAX_STEPS, tol=tol,
    )
    assert_bits(got[0].numpy(), want[0], "mean")
    if moments:
        assert_bits(got[1].numpy(), want[1], "variance")
    else:
        assert got[1] is None and want[1] is None
    assert got[2].dtype == torch.int32 and int(got[2]) == int(want[2])
    assert_bits(got[3].numpy(), want[3], "residual")
    if kind == "inf_weight" and depth == "adaptive":
        # The first sweep's residual is NaN, which stops the sweep (later
        # sweeps no longer mix the row, so a fixed depth ends finite).
        assert np.isnan(float(want[3])) and int(want[2]) == 1


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_damped_sweep_bit_equal(steps):
    means, _, idx, weights = sweep_case("dense8", seed=4)
    want = jax.jit(partial(jprop.damped_sweep_math, damping=0.3, steps=steps))(
        means, idx, weights)
    got = propagate.damped_sweep_math(
        torch.from_numpy(means), torch.from_numpy(idx), torch.from_numpy(weights),
        damping=0.3, steps=steps,
    )
    assert_bits(got.numpy(), want, "damped")


def test_zero_steps_is_the_identity():
    means, variances, idx, weights = sweep_case("dense8")
    got = propagate.bp_sweep_math(
        torch.from_numpy(means), torch.from_numpy(variances),
        torch.from_numpy(idx), torch.from_numpy(weights), max_steps=0, tol=1e-3,
    )
    assert_bits(got[0].numpy(), means, "mean")
    assert_bits(got[1].numpy(), variances, "variance")
    assert int(got[2]) == 0 and float(got[3]) == 0.0


def test_constants_match():
    assert propagate.DEFAULT_DAMPING == jprop.DEFAULT_DAMPING
    assert propagate.DEFAULT_SWEEP_STEPS == jprop.DEFAULT_SWEEP_STEPS
    assert propagate.VAR_EPS == jprop.VAR_EPS
    assert propagate.PropagatedBeliefs._fields == jprop.PropagatedBeliefs._fields


# -- MarketGraph -------------------------------------------------------------


def edge_list(seed, num_nodes=30, num_edges=90):
    """Random edges over ``n-0`` .. ``n-{num_nodes-1}``, with duplicates."""
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(num_edges):
        a, b = rng.choice(num_nodes, 2, replace=False)
        edges.append((f"n-{a}", f"n-{b}", float(rng.uniform(0.1, 3.0))))
    edges += edges[:5]  # duplicate edges
    return edges


GRAPHS = {
    "random": lambda: (edge_list(1), dict(damping=0.3, steps=4)),
    "defaults": lambda: (edge_list(2, 12, 20), {}),
    "star": lambda: ([("hub", f"leaf-{i}", 1.0 + i) for i in range(9)]
                     + [(f"leaf-{i}", "hub", 0.5) for i in range(9)],
                     dict(damping=1.0, steps=0)),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_fields_and_fingerprints_match(name):
    edges, kwargs = GRAPHS[name]()
    ours, theirs = MarketGraph.from_edges(edges, **kwargs), JaxGraph.from_edges(
        edges, **kwargs)
    assert ours.node_ids == theirs.node_ids
    for field in ("offsets", "indices", "weights"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert (ours.damping, ours.steps) == (theirs.damping, theirs.steps)
    assert ours.fingerprint == theirs.fingerprint
    for topology in (None, b"plan-digest"):
        assert ours.extended_fingerprint(topology) == theirs.extended_fingerprint(
            topology)


# Market universes for align: all present; some absent (their edges drop,
# and nodes whose every neighbour is absent keep no edge); reordered and
# padded; none present.
ALIGN = [
    ("all", lambda nodes: nodes, None),
    ("absent", lambda nodes: [n for i, n in enumerate(nodes) if i % 3] + ["x-1"], None),
    ("padded", lambda nodes: list(reversed(nodes[::2])) + ["x-2"], 50),
    ("none", lambda nodes: ["x-3", "x-4"], 4),
]


@pytest.mark.parametrize("universe", ALIGN, ids=[a[0] for a in ALIGN])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_align_byte_equal(name, universe):
    _, keys_of, padded = universe
    edges, kwargs = GRAPHS[name]()
    ours, theirs = MarketGraph.from_edges(edges, **kwargs), JaxGraph.from_edges(
        edges, **kwargs)
    keys = keys_of(theirs.node_ids)
    got, want = ours.align(keys, padded), theirs.align(keys, padded)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_align_case_shapes():
    """The absent universe leaves a present node with no surviving edge."""
    edges = [("a", "b", 1.0), ("a", "b", 2.0), ("c", "gone", 1.0), ("b", "c", 0.5)]
    idx, w = MarketGraph.from_edges(edges).align(["a", "b", "c"], 5)
    np.testing.assert_array_equal(idx, [[1, 1], [2, -1], [-1, -1], [-1, -1], [-1, -1]])
    np.testing.assert_array_equal(w[0], np.float32([1.0, 2.0]))


@pytest.mark.parametrize("build, match", [
    (lambda g: g.from_edges([("a", "a", 1.0)]), "self-edge"),
    (lambda g: g.from_edges([("a", "b", 0.0)]), "must be > 0"),
    (lambda g: g.from_edges([("a", "b", float("nan"))]), "must be > 0"),
    (lambda g: g.from_edges([("a", "b", 1.0)], damping=1.5), "damping"),
    (lambda g: g.from_edges([("a", "b", 1.0)], steps=-1), "steps"),
    (lambda g: g.from_edges([("a", "b", 1.0)]).align(["a", "b"], 1), "padded_total"),
])
def test_graph_errors_match(build, match):
    for cls in (JaxGraph, MarketGraph):
        with pytest.raises(ValueError, match=match):
            build(cls)


def test_market_graph_from_fields_round_trip():
    theirs = JaxGraph.from_edges(edge_list(3), damping=0.25, steps=5)
    ours = convert.market_graph_from_fields(
        theirs.node_ids, theirs.offsets, theirs.indices, theirs.weights,
        theirs.damping, theirs.steps, theirs.fingerprint,
    )
    rebuilt = MarketGraph.from_edges(edge_list(3), damping=0.25, steps=5)
    for field in ("node_ids", "damping", "steps", "fingerprint"):
        assert getattr(ours, field) == getattr(rebuilt, field)
    for field in ("offsets", "indices", "weights"):
        assert getattr(ours, field).tobytes() == getattr(rebuilt, field).tobytes()
        assert not getattr(ours, field).flags.writeable
    keys = theirs.node_ids[::2]
    for a, b in zip(ours.align(keys, 40), theirs.align(keys, 40)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("change, match", [
    (dict(offsets=[0, 1]), "one entry per node"),
    (dict(indices=[0, 9]), "outside node_ids"),
    (dict(weights=[1.0]), "differ in length"),
    (dict(offsets=[0, 2, 1, 2]), "non-decreasing"),
])
def test_market_graph_from_fields_checks(change, match):
    fields = dict(node_ids=["a", "b", "c"], offsets=[0, 1, 2, 2],
                  indices=[1, 2], weights=[1.0, 2.0], damping=0.5, steps=2,
                  fingerprint=b"x")
    fields.update(change)
    with pytest.raises(ValueError, match=match):
        convert.market_graph_from_fields(**fields)


# -- InferenceOptions, MarketBlocks, propagate_beliefs ------------------------


@pytest.mark.parametrize("kwargs, match", [
    (dict(tol=0.0), "positive residual tolerance"),
    (dict(tol=-1e-3), "positive residual tolerance"),
    (dict(max_steps=-1), "must be >= 0"),
    (dict(damping=1.5), "must lie in"),
    (dict(moments=False, tol=1e-3), "rides the moments sweep"),
])
def test_inference_options_validation_matches(kwargs, match):
    for cls in (jbp.InferenceOptions, InferenceOptions):
        with pytest.raises(ValueError, match=match):
            cls(**kwargs)


@pytest.mark.parametrize("kwargs", [{}, dict(max_steps=7, damping=0.2, tol=1e-4),
                                    dict(moments=False, max_steps=0)])
def test_inference_options_resolve_matches(kwargs):
    graph = GRAPHS["random"]()
    ours = InferenceOptions(**kwargs).resolve(MarketGraph.from_edges(graph[0], **graph[1]))
    theirs = jbp.InferenceOptions(**kwargs).resolve(
        JaxGraph.from_edges(graph[0], **graph[1]))
    assert ours == theirs


def block_list(module):
    return module.MarketBlocks([
        module.MarketBlock("mutually_exclusive", ("e-a", "e-b", "e-c", "e-d")),
        module.MarketBlock("implies", ("parlay", "e-a", "leg-2"), weight=2.5),
        module.MarketBlock("mutually_exclusive", ("y", "n"), weight=0.5),
        module.MarketBlock("implies", ("absent", "y")),
    ])


def test_blocks_edges_and_graph_match():
    ours, theirs = block_list(tinfer), block_list(jblocks)
    assert ours.to_edges() == theirs.to_edges()
    extra = [("e-a", "y", 0.7), ("leg-2", "n", 1.3)]
    assert (ours.to_graph(0.4, 3, extra).fingerprint
            == theirs.to_graph(0.4, 3, extra).fingerprint)


@pytest.mark.parametrize("with_stderr", [False, True])
def test_blocks_project_matches(with_stderr):
    ours, theirs = block_list(tinfer), block_list(jblocks)
    ids = ["e-a", "e-b", "e-c", "e-d", "parlay", "leg-2", "y", "n", "lone"]
    rng = np.random.default_rng(5)
    means = rng.random(len(ids)).astype(np.float32)
    means[2] = np.nan  # a member without evidence is skipped
    means[3] = -0.25   # clipped to 0 before the renormalisation
    stderr = (rng.random(len(ids)) * 0.1).astype(np.float32) if with_stderr else None
    got, want = ours.project(ids, means, stderr), theirs.project(ids, means, stderr)
    assert_bits(got[0], want[0], "projected mean")
    if with_stderr:
        assert_bits(got[1], want[1], "projected stderr")
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("kind, members, weight, match", [
    ("bogus", ("a", "b"), 1.0, "kind="),
    ("implies", ("a",), 1.0, "at least 2"),
    ("mutually_exclusive", ("a", "a"), 1.0, "duplicate"),
    ("implies", ("a", "b"), 0.0, "weight="),
])
def test_block_validation_matches(kind, members, weight, match):
    for cls in (jblocks.MarketBlock, MarketBlock):
        with pytest.raises(ValueError, match=match):
            cls(kind, members, weight)
    with pytest.raises(TypeError, match="MarketBlock entries"):
        MarketBlocks([("a", "b")])


PROPAGATE_OPTIONS = {
    "default": dict(), "adaptive": dict(tol=1e-4, max_steps=12),
    "point": dict(moments=False, damping=0.3), "zero": dict(max_steps=0),
}


@pytest.fixture(scope="module")
def propagate_case():
    """Inputs and the JAX package's ``propagate_beliefs`` per options, once."""
    edges, kwargs = GRAPHS["random"]()
    theirs_graph = JaxGraph.from_edges(edges, **kwargs)
    keys = theirs_graph.node_ids[1:] + ["x-9"]
    rng = np.random.default_rng(8)
    padded = len(keys) + 3
    means = rng.random(padded).astype(np.float32)
    variances = (rng.random(padded) * 0.01).astype(np.float32)
    means[-3:] = np.nan
    cache = {}

    def get(name):
        if name not in cache:
            want = jbp.propagate_beliefs(
                jnp.asarray(means), jnp.asarray(variances), theirs_graph, keys,
                padded, options=jbp.InferenceOptions(**PROPAGATE_OPTIONS[name]),
                kernel="xla",
            )
            cache[name] = (edges, kwargs, keys, padded, means, variances, want)
        return cache[name]

    return get


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(PROPAGATE_OPTIONS))
def test_propagate_beliefs_matches(propagate_case, kernel, name):
    edges, kwargs, keys, padded, means, variances, want = propagate_case(name)
    got = propagate_beliefs(
        torch.from_numpy(means), torch.from_numpy(variances),
        MarketGraph.from_edges(edges, **kwargs), keys, padded,
        options=InferenceOptions(**PROPAGATE_OPTIONS[name]), kernel=kernel,
    )
    assert got.mean.device.type == "cpu"
    for field in ("mean", "stderr", "residual"):
        assert_bits(getattr(got, field).numpy(), getattr(want, field), field)
    assert int(got.iters_run) == int(want.iters_run)


def test_propagate_beliefs_kernel_name_checked():
    graph = MarketGraph.from_edges(edge_list(1))
    for fn in (jbp.propagate_beliefs, propagate_beliefs):
        with pytest.raises(ValueError, match="kernel='auto'"):
            fn(np.zeros(3, np.float32), np.zeros(3, np.float32), graph,
               ["n-0", "n-1", "n-2"], 3, kernel="auto")
