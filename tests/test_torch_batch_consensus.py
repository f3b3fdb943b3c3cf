"""The port's batched consensus ≡ the JAX package's, bit for bit on the CPU.

* ``ops.consensus``'s ordered segment sums against the JAX package's
  ``core.batch._batch_kernel`` (XLA's ``segment_sum``) at float64 (under
  ``jax.enable_x64()``) and float32: random ragged segments, pairs and
  markets with nothing in them, one skewed segment, unsorted segment ids,
  NaN, -0.0 and 0/1 values.
* ``run_packed`` against the JAX package's on the same packed batches.
* The batched documents against ``compute_batch_consensus`` /
  ``compute_consensus_jax`` dict for dict, the golden fixture byte for byte,
  and the ``backend=`` seam of ``compute_consensus``.

The JAX kernel is jitted per shape, so the array cases share one shape
(module-scoped), and the payload cases stay inside a few of the JAX
package's power-of-two buckets.
"""

import ast
import inspect
import json
import pathlib
import random
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu.core import batch as jbatch
from bayesian_consensus_engine_tpu.core import compute_consensus as jax_compute
from bayesian_consensus_engine_tpu_torch.core import batch as tbatch
from bayesian_consensus_engine_tpu_torch.core import compute_consensus
from bayesian_consensus_engine_tpu_torch.ops import consensus as tops

from test_torch_engine import random_case

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
SIGNALS, PAIRS, MARKETS = 3000, 600, 80

#: name → (torch dtype, JAX x64 flag, unsigned view of the float's bits)
DTYPES = {
    "float64": (torch.float64, True, np.uint64),
    "float32": (torch.float32, False, np.uint32),
}


def array_case(kind: str, seed: int):
    """``(flat_probs, flat_pair, pair_rel, pair_conf, pair_market)`` of the
    shared shape, float64 on the host."""
    rng = np.random.default_rng(seed)
    probs = rng.random(SIGNALS)
    rel = rng.random(PAIRS)
    conf = rng.random(PAIRS)
    flat_pair = rng.integers(0, PAIRS, SIGNALS)
    pair_market = np.sort(rng.integers(0, MARKETS, PAIRS))
    if kind == "unsorted":
        pair_market = rng.integers(0, MARKETS, PAIRS)
    elif kind == "empty_segments":
        flat_pair = 2 * rng.integers(0, PAIRS // 2, SIGNALS)
        pair_market = np.sort(3 * rng.integers(0, MARKETS // 3, PAIRS))
    elif kind == "skewed_pair":
        flat_pair[rng.random(SIGNALS) < 0.8] = 7
    elif kind == "skewed_market":
        pair_market = np.sort(
            np.where(rng.random(PAIRS) < 0.85, 3, pair_market)
        )
    elif kind == "specials":
        probs[rng.integers(0, SIGNALS, 40)] = np.nan
        probs[rng.integers(0, SIGNALS, 200)] = -0.0
        probs[rng.integers(0, SIGNALS, 200)] = 1.0
        probs[rng.integers(0, SIGNALS, 200)] = 0.0
        rel[rng.integers(0, PAIRS, 10)] = np.nan
        rel[rng.integers(0, PAIRS, 60)] = -0.0
        conf[rng.integers(0, PAIRS, 60)] = -0.0
        # A market whose every pair is all -0.0: its sums stay +0.0.
        probs[np.isin(flat_pair, np.flatnonzero(pair_market == 5))] = -0.0
    return (probs, flat_pair.astype(np.int32), rel, conf,
            pair_market.astype(np.int32))


ARRAY_KINDS = ["ragged", "unsorted", "empty_segments", "skewed_pair",
               "skewed_market", "specials"]


def assert_bits_equal(got, want, bits, what=""):
    """Bit-equal, a NaN as a NaN (its payload aside)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    np.testing.assert_array_equal(
        got[~nan].view(bits), want[~nan].view(bits), err_msg=what
    )


@pytest.fixture(scope="module")
def jax_kernel():
    """The JAX package's device pass at the shared shape, per x64 flag."""

    def run(arrays, x64):
        probs, flat_pair, rel, conf, pair_market = arrays
        with jax.enable_x64(x64):
            dtype = jnp.float64 if x64 else jnp.float32
            out = jbatch._batch_kernel(
                jnp.asarray(probs, dtype=dtype), jnp.asarray(flat_pair),
                jnp.asarray(rel, dtype=dtype), jnp.asarray(conf, dtype=dtype),
                jnp.asarray(pair_market), num_pairs=PAIRS, num_markets=MARKETS,
            )
            return [np.asarray(x) for x in out]

    return run


def port_pass(arrays, dtype, rounds=None):
    probs, flat_pair, rel, conf, pair_market = arrays

    def f(x):
        return torch.from_numpy(x).to(dtype)

    pair_mean = tops.pair_mean_from_flat(
        f(probs), torch.from_numpy(flat_pair), PAIRS, rounds
    )
    sums = tops.weighted_sums_from_pairs(
        pair_mean, f(rel), f(conf), torch.from_numpy(pair_market), MARKETS,
        rounds,
    )
    return [x.numpy() for x in (pair_mean, *sums)]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("kind", ARRAY_KINDS)
def test_ordered_sums_bit_equal_to_jax(jax_kernel, kind, dtype_name):
    dtype, x64, bits = DTYPES[dtype_name]
    arrays = array_case(kind, seed=ARRAY_KINDS.index(kind))
    rounds = []
    got = port_pass(arrays, dtype, rounds)
    want = jax_kernel(arrays, x64)
    for name, g, w in zip(("pair_mean", "total_weight", "weighted_prob",
                           "weighted_conf"), got, want):
        assert_bits_equal(g, w, bits, f"{kind} {dtype_name} {name}")
    _probs, flat_pair, _rel, _conf, pair_market = arrays
    assert rounds == [np.bincount(flat_pair).max(),
                      np.bincount(pair_market).max()]


@pytest.mark.parametrize("columns", [1, 3])
def test_ordered_segment_sum_is_sequential_in_element_order(columns):
    # np.add.at adds in element order from +0.0: the order being reproduced.
    rng = np.random.default_rng(11)
    values = rng.standard_normal((5000, columns)) * 10.0 ** rng.integers(
        -8, 8, (5000, columns))
    ids = rng.integers(0, 40, 5000)
    ids[:1500] = 39  # one long segment, interleaved with the others
    rng.shuffle(ids)
    want = np.zeros((41, columns))
    np.add.at(want, ids, values)
    rounds = []
    got = tops.ordered_segment_sum(
        torch.from_numpy(values), torch.from_numpy(ids), 41, rounds
    )
    assert_bits_equal(got.numpy(), want, np.uint64)
    assert rounds == [np.bincount(ids).max()]


def test_ordered_segment_sum_empty_and_signed_zero():
    empty = tops.ordered_segment_sum(
        torch.zeros(0, dtype=torch.float32), torch.zeros(0, dtype=torch.int64), 3
    )
    assert empty.dtype == torch.float32 and empty.tolist() == [0.0, 0.0, 0.0]
    zeros = tops.ordered_segment_sum(
        torch.tensor([-0.0, -0.0]), torch.tensor([1, 1]), 2
    )
    assert [np.signbit(x) for x in zeros.numpy()] == [False, False]


def _names_used(obj) -> set:
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    return {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)} \
        | {node.id for node in ast.walk(tree) if isinstance(node, ast.Name)} \
        | {node.arg for node in ast.walk(tree) if isinstance(node, ast.keyword)}


def test_device_pass_uses_no_atomic_accumulation(monkeypatch):
    # No call that adds floats with atomics on CUDA appears in the code of
    # the pass (docstrings aside), and none runs when it does.
    used = _names_used(tops) | _names_used(tbatch.run_packed)
    forbidden = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                 "scatter_reduce", "scatter_reduce_", "index_put",
                 "index_put_", "accumulate", "bincount", "segment_reduce"}
    assert not used & forbidden, used & forbidden
    for name in ("index_add_", "index_add", "scatter_add_", "scatter_add",
                 "scatter_reduce", "index_put_"):
        def refuse(*_args, _name=name, **_kwargs):
            raise AssertionError(f"{_name} called by the device pass")
        monkeypatch.setattr(torch.Tensor, name, refuse)
    batch = tbatch.pack_markets(
        [("m", [{"sourceId": "a", "probability": 0.25},
                {"sourceId": "b", "probability": 0.5},
                {"sourceId": "a", "probability": 0.75}])])
    pair_mean, total, prob, conf = tbatch.run_packed(batch, device="cpu")
    assert pair_mean.tolist() == [0.5, 0.5] and total.tolist() == [1.0]


def _payloads(seed, num_markets=24, empty_every=5):
    """Markets of random cases, every *empty_every*-th one empty, with a
    per-market reliability table."""
    rng = random.Random(seed)
    markets, tables = [], {}
    for m in range(num_markets):
        mid = f"market-{seed}-{m}"
        signals, table = random_case(rng)
        if m % empty_every == 0:
            signals = []
        markets.append((mid, signals))
        tables[mid] = table
    return markets, tables


def _lookups(tables):
    def lookup(mapping_lookup):
        return lambda sid, mid: mapping_lookup(tables[mid])(sid, mid)
    return lookup(jbatch.mapping_lookup), lookup(tbatch.mapping_lookup)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_run_packed_bit_equal_to_jax(seed, dtype_name):
    dtype, x64, bits = DTYPES[dtype_name]
    markets, tables = _payloads(seed)
    live = [(mid, sigs) for mid, sigs in markets if sigs]
    jax_lookup, port_lookup = _lookups(tables)
    ours = tbatch.pack_markets(live, port_lookup)
    with jax.enable_x64(x64):
        want = jbatch.run_packed(jbatch.pack_markets(live, jax_lookup))
    got = tbatch.run_packed(ours, device="cpu", dtype=dtype)
    for g, w in zip(got, want):
        assert_bits_equal(g, w, bits)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("seed", [4, 5])
def test_batch_documents_equal_to_jax(seed, dtype_name):
    dtype, x64, _bits = DTYPES[dtype_name]
    markets, tables = _payloads(seed)
    jax_lookup, port_lookup = _lookups(tables)
    with jax.enable_x64(x64):
        want = jbatch.compute_batch_consensus(markets, jax_lookup)
    got = tbatch.compute_batch_consensus(
        markets, port_lookup, device="cpu", dtype=dtype
    )
    assert got == want
    assert list(got) == list(want)


@pytest.mark.parametrize("markets", [
    [("empty", [])],
    [("live", [{"sourceId": "a", "probability": 0.8}]), ("empty", [])],
    [("e1", []), ("live", [{"sourceId": "b", "probability": True},
                           {"sourceId": "a", "probability": 0}]), ("e2", [])],
    [],
], ids=["empty", "live_then_empty", "mixed", "none"])
def test_empty_and_mixed_batches_equal_to_jax(markets):
    with jax.enable_x64():
        want = jbatch.compute_batch_consensus(markets)
    got = tbatch.compute_batch_consensus(markets, device="cpu",
                                         dtype=torch.float64)
    assert got == want
    for mid, signals in markets:
        if not signals:
            assert got[mid] == {"schemaVersion": "1.0.0", "consensus": None,
                                "confidence": 0.0, "marketId": mid}


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("chunk", range(4))
def test_single_market_array_path_equal_to_jax(chunk, dtype_name):
    dtype, x64, _bits = DTYPES[dtype_name]
    rng = random.Random(100 + chunk)
    for _ in range(10):
        signals, reliability = random_case(rng)
        with jax.enable_x64(x64):
            want = jbatch.compute_consensus_jax(signals, reliability)
        got = tbatch.compute_consensus_torch(
            signals, reliability, device="cpu", dtype=dtype
        )
        assert json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("backend", ["torch", "jax", "tpu"])
def test_golden_fixture_byte_exact_through_array_backends(backend):
    fixture = json.loads((FIXTURES / "golden_regression.json").read_text())
    doc = compute_consensus(
        fixture["input"]["signals"], backend=backend, device="cpu",
        dtype=torch.float64,
    )
    assert json.dumps(doc, indent=2) == json.dumps(
        fixture["expectedOutput"], indent=2
    )


@pytest.mark.parametrize("name", [
    "sim_uniform_agreement.json",
    "sim_polarized_split.json",
    "sim_single_outlier.json",
])
def test_sim_fixtures_through_array_backend(name):
    signals = json.loads((FIXTURES / name).read_text())["input"]["signals"]
    doc = compute_consensus(signals, backend="torch", device="cpu",
                            dtype=torch.float64)
    with jax.enable_x64():
        assert doc == jax_compute(signals, backend="jax")
    assert json.loads(json.dumps(doc)) == doc
    assert doc["consensus"] == pytest.approx(
        compute_consensus(signals)["consensus"], rel=1e-12
    )


def test_backend_aliases_agree_and_empty_stays_scalar(monkeypatch):
    signals = [{"sourceId": "b", "probability": 0.3},
               {"sourceId": "a", "probability": 0.9}]
    table = {"a": {"reliability": 0.8, "confidence": 0.6}}
    docs = [compute_consensus(signals, table, backend=b, device="cpu")
            for b in ("torch", "jax", "tpu")]
    assert docs[0] == docs[1] == docs[2]
    with jax.enable_x64(False):
        assert docs[0] == jax_compute(signals, table, backend="jax")
    # Empty signals take the scalar path on every backend, so they need no
    # device at all.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert compute_consensus([], backend="torch") == jax_compute(
        [], backend="jax")


def test_array_backend_unavailable_raises_not_implemented(monkeypatch):
    monkeypatch.setitem(
        sys.modules, "bayesian_consensus_engine_tpu_torch.core.batch", None
    )
    with pytest.raises(NotImplementedError, match="backend 'torch' requires"):
        compute_consensus([{"sourceId": "a", "probability": 0.6}],
                          backend="torch")


def test_array_path_rejects_unsupported_dtype_and_device():
    signals = [{"sourceId": "a", "probability": 0.6}]
    with pytest.raises(ValueError, match="float32 or"):
        compute_consensus(signals, backend="torch", device="cpu",
                          dtype=torch.float16)
    with pytest.raises(ValueError, match="expected cuda or cpu"):
        compute_consensus(signals, backend="torch", device="meta")
