"""The port's public surface ≡ the JAX package's.

* ``__all__`` per package module: every name a module of the JAX package
  exports (read with ``ast``, nothing imported) is exported by the port's
  module of the same path and bound there, and every module of the JAX
  package has its port counterpart, but for the exemptions below.
* ``build_cycle``, ``build_cycle_loop`` and ``build_cycle_tiebreak_loop``
  against the JAX functions on the CPU. The same inputs, made with numpy
  from a seed, go through the JAX program (whole arrays; on a mesh of the
  conftest's host devices) and the port's: whole tensors with
  ``mesh=None``, grids of per-shard blocks on a mesh of the same shape
  whose every device is the CPU. Market-major and slot-major, with
  ``exists`` and with the reduced carry (``exists=None``). The state is
  bit-equal (the update is elementwise). The consensus, confidence and
  total weight agree within rtol 1e-5, atol 1e-6: the slot sums run in
  another order than XLA's, and the decayed reads carry ``exp2``'s ulps
  (``tests/test_torch_sharded_session.py``'s bound). The tie-break is
  bit-equal where no read decays, and within rtol 1e-5, atol 1e-3 with
  equal group counts where reads decay.
* ``donate``: with ``donate=False`` the caller's tensors are unchanged;
  with ``donate=True`` the result is the same.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_consensus_engine_tpu import parallel as jpar
from bayesian_consensus_engine_tpu_torch import parallel as tpar
from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
from bayesian_consensus_engine_tpu_torch.parallel import mesh as tmesh

_ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = _ROOT / "bayesian_consensus_engine_tpu"
PORT = _ROOT / "bayesian_consensus_engine_tpu_torch"

# -- __all__ per package module ----------------------------------------------

#: Modules of the JAX package with no port counterpart, and why.
EXEMPT_MODULES = {
    "lint": "checks JAX code; the port has none",
    "ops/pallas_bp.py": "the Pallas kernels are replaced by csrc/",
    "ops/pallas_cycle.py": "the Pallas kernels are replaced by csrc/",
    "ops/pallas_settle.py": "the Pallas kernels are replaced by csrc/",
    "parallel/_jax_compat.py": "JAX version shims",
    "utils/dtypes.py": "the x64 switch; the port takes dtype= per call",
    "_native": "the port builds its own C extensions (native/)",
    "utils/autotune.py": "the shape tuner: ROADMAP queue 1 item 10",
}
#: Exported names with no port counterpart: ``NamedSharding`` objects. A
#: port mesh places per-shard tensors and has no sharding object.
EXEMPT_NAMES = {"block_sharding", "market_sharding", "slot_block_sharding"}


def exempt(rel: pathlib.PurePath) -> bool:
    return any(rel.as_posix() == key or rel.parts[0] == key
               for key in EXEMPT_MODULES)


def module_all(path: pathlib.Path):
    """The literal ``__all__`` of a module, or None."""
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
            return ast.literal_eval(node.value)
    return None


def bound_names(path: pathlib.Path) -> set:
    """Names bound at a module's top level: imports, defs, classes and
    assignments (those under ``if``/``try`` too)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return names


REFERENCE_EXPORTS = sorted(
    path.relative_to(REFERENCE) for path in REFERENCE.rglob("*.py")
    if module_all(path) is not None
    and not exempt(path.relative_to(REFERENCE))
)


def test_every_module_of_the_jax_package_has_its_port():
    missing = [
        rel.as_posix() for rel in
        (path.relative_to(REFERENCE) for path in REFERENCE.rglob("*.py"))
        if not exempt(rel) and not (PORT / rel).exists()
    ]
    assert not missing, missing
    assert len(REFERENCE_EXPORTS) >= 5


@pytest.mark.parametrize("rel", REFERENCE_EXPORTS, ids=str)
def test_module_exports_what_the_jax_module_exports(rel):
    want = set(module_all(REFERENCE / rel)) - EXEMPT_NAMES
    got = module_all(PORT / rel)
    assert got is not None, f"{rel} has no __all__"
    assert len(got) == len(set(got)), f"{rel}: a name repeats in __all__"
    assert sorted(want - set(got)) == []
    unbound = set(got) - bound_names(PORT / rel)
    assert not unbound, f"{rel}: __all__ names unbound names {sorted(unbound)}"


def test_shard_market_is_the_port_vector_sharding():
    assert tpar.shard_market is tmesh.shard_market_vector
    assert not EXEMPT_NAMES & set(tpar.__all__)


# -- the cycle builders against the JAX package -------------------------------

M, K = 32, 8
NOW = 401.0
BOUND = dict(rtol=1e-5, atol=1e-6)
DECAYED_TB = dict(rtol=1e-5, atol=1e-3)
FIELDS = MarketBlockState._fields


def inputs(seed: int, decays: bool = True, reduced: bool = False) -> dict:
    """Market-major (M, K) numpy inputs. Without ``decays`` every stamp is
    0 or ``NOW``, so no read decays. ``reduced``: the reduced carry (cold
    slots at the priors, no ``exists``). Probabilities lie on a 1/8 grid,
    so many markets hold tied groups."""
    rng = np.random.default_rng(seed)
    stamps = [0.0, 5.0, 40.0, 400.0] if decays else [0.0, NOW]
    x = dict(
        probs=(rng.integers(0, 9, (M, K)) / 8).astype(np.float32),
        mask=rng.random((M, K)) < 0.7,
        outcome=rng.random(M) < 0.5,
        reliability=rng.uniform(0.1, 1.0, (M, K)).astype(np.float32),
        confidence=rng.uniform(0.0, 1.0, (M, K)).astype(np.float32),
        updated_days=rng.choice(stamps, (M, K)).astype(np.float32),
        exists=rng.random((M, K)) < 0.6,
    )
    x["mask"][3] = False  # a market without a signal: NaN consensus
    if reduced:
        cold = ~x["exists"]
        x["reliability"][cold] = 0.5
        x["confidence"][cold] = 0.25
        x["updated_days"][cold] = 0.0
        x["exists"] = None
    return x


CASES = {
    "decays": inputs(0),
    "exact": inputs(1, decays=False),
    "reduced": inputs(2, reduced=True),
}


def layout(array, slot_major):
    return None if array is None else (array.T.copy() if slot_major else array)


def jax_call(program, x, slot_major, *rest):
    state = jpar.MarketBlockState(*(
        None if x[f] is None else jnp.asarray(layout(x[f], slot_major))
        for f in FIELDS))
    return program(jnp.asarray(layout(x["probs"], slot_major)),
                   jnp.asarray(layout(x["mask"], slot_major)),
                   jnp.asarray(x["outcome"]), state, *rest)


def port_inputs(x, shape, slot_major):
    """Whole tensors (``shape=None``) or the mesh's grids, in the layout."""
    if shape is None:
        def cut(a):
            return torch.from_numpy(layout(a, slot_major).copy())

        outcome = torch.from_numpy(x["outcome"].copy())
        state = MarketBlockState(*(None if x[f] is None else cut(x[f])
                                   for f in FIELDS))
        return None, (cut(x["probs"]), cut(x["mask"]), outcome, state)
    mesh = tmesh.make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))

    def cut(a):
        if a is None:
            return None
        if slot_major:
            return tmesh.shard_slot_block(a.T, mesh)
        return tmesh.shard_block(a, mesh)

    grids = {f: cut(x[f]) for f in FIELDS}
    state = tuple(
        tuple(
            MarketBlockState(*(None if grids[f] is None else grids[f][i][j]
                               for f in FIELDS))
            for j in range(shape[1])
        )
        for i in range(shape[0])
    )
    return mesh, (cut(x["probs"]), cut(x["mask"]),
                  tmesh.shard_market_vector(x["outcome"], mesh), state)


def whole_state(state, shape, slot_major):
    """The port's state (whole, or a grid) as market-major numpy fields."""
    out = []
    for f in range(4):
        if shape is None:
            field = state[f]
        elif state[0][0][f] is None:
            field = None
        else:
            pieces = tuple(tuple(shard[f] for shard in row) for row in state)
            field = (tmesh.unshard_slot_block(pieces) if slot_major
                     else tmesh.unshard_block(pieces))
        out.append(None if field is None
                   else layout(field.numpy(), slot_major))
    return out


def assert_state_equal(got, want):
    for field, a, b in zip(FIELDS, got, want):
        if b is None:
            assert a is None, field
            continue
        assert a is not None and a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def snapshot(args):
    """Copies of every tensor in the port's inputs."""
    return [x.clone() for x in _tensors(args)]


def _tensors(nest):
    if isinstance(nest, torch.Tensor):
        return [nest]
    if isinstance(nest, (tuple, list)):
        return [t for item in nest for t in _tensors(item)]
    return []


def assert_unchanged(args, before):
    for got, want in zip(_tensors(args), before):
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX programs' outputs per (builder, mesh, layout, case), once."""
    cache = {}

    def get(kind, shape, slot_major, case, steps=3):
        key = (kind, shape, slot_major, case, steps)
        if key not in cache:
            mesh = None if shape is None else jpar.make_mesh(
                shape, devices=jax.devices()[: shape[0] * shape[1]])
            x = CASES[case]
            if kind == "cycle":
                out = jax_call(jpar.build_cycle(mesh, donate=False,
                                                slot_major=slot_major),
                               x, slot_major, jnp.float32(NOW))
                state, per_market = out.state, out[1:]
            elif kind == "loop":
                state, consensus = jax_call(
                    jpar.build_cycle_loop(mesh, slot_major=slot_major,
                                          donate=False),
                    x, slot_major, jnp.float32(NOW), steps)
                per_market = (consensus,)
            else:
                state, consensus, tiebreak = jax_call(
                    jpar.build_cycle_tiebreak_loop(mesh, donate=False),
                    x, True, jnp.float32(NOW), steps)
                per_market = (consensus, *tiebreak)
            cache[key] = (
                [None if f is None else layout(np.asarray(f), slot_major)
                 for f in state],
                [np.asarray(v) for v in per_market],
            )
        return cache[key]

    return get


CYCLE_CASES = [
    (None, False, "decays"), (None, True, "decays"),
    (None, False, "reduced"), (None, True, "reduced"),
    ((1, 2), False, "decays"), ((2, 1), False, "decays"),
    ((2, 2), False, "decays"), ((2, 2), True, "decays"),
    ((1, 2), False, "reduced"),
]


def case_id(case):
    shape, slot_major, name = case[:3]
    mesh = "whole" if shape is None else f"{shape[0]}x{shape[1]}"
    return f"{mesh}-{'slot' if slot_major else 'market'}-{name}"


@pytest.mark.parametrize("shape, slot_major, case", CYCLE_CASES,
                         ids=[case_id(c) for c in CYCLE_CASES])
def test_build_cycle_matches_jax(jax_outputs, shape, slot_major, case):
    want_state, want = jax_outputs("cycle", shape, slot_major, case)
    for donate in (False, True):
        mesh, args = port_inputs(CASES[case], shape, slot_major)
        before = snapshot(args)
        out = tpar.build_cycle(mesh, donate=donate, slot_major=slot_major)(
            *args, NOW)
        if not donate:
            assert_unchanged(args, before)
        assert_state_equal(whole_state(out.state, shape, slot_major), want_state)
        for got, ref in zip(out[1:], want):
            assert got.shape == (M,) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref, equal_nan=True,
                                       **BOUND)
        assert np.isnan(out.consensus[3].item())


LOOP_CASES = [
    (None, True, "decays"), (None, False, "decays"),
    (None, True, "reduced"), (None, False, "reduced"),
    ((1, 2), True, "decays"), ((2, 1), True, "decays"),
    ((2, 2), True, "decays"), ((2, 2), False, "decays"),
    ((1, 2), True, "reduced"),
]


@pytest.mark.parametrize("shape, slot_major, case", LOOP_CASES,
                         ids=[case_id(c) for c in LOOP_CASES])
def test_build_cycle_loop_matches_jax(jax_outputs, shape, slot_major, case):
    want_state, (want,) = jax_outputs("loop", shape, slot_major, case)
    for donate in (False, True):
        mesh, args = port_inputs(CASES[case], shape, slot_major)
        before = snapshot(args)
        state, consensus = tpar.build_cycle_loop(
            mesh, slot_major=slot_major, donate=donate)(*args, NOW, 3)
        if not donate:
            assert_unchanged(args, before)
        assert_state_equal(whole_state(state, shape, slot_major), want_state)
        np.testing.assert_allclose(consensus.numpy(), want, equal_nan=True,
                                   **BOUND)


TIEBREAK_CASES = [
    ((1, 1), True, "exact"), (None, True, "exact"),
    ((1, 2), True, "exact"), ((2, 1), True, "exact"), ((2, 2), True, "exact"),
    ((1, 1), True, "decays"), ((2, 2), True, "decays"),
    ((1, 2), True, "reduced"),
]


@pytest.mark.parametrize("shape, slot_major, case", TIEBREAK_CASES,
                         ids=[case_id(c) for c in TIEBREAK_CASES])
def test_build_cycle_tiebreak_loop_matches_jax(jax_outputs, shape, slot_major,
                                               case):
    want_state, (want_consensus, *want_tb) = jax_outputs(
        "tiebreak", shape or (1, 1), True, case, steps=2)
    for donate in (False, True):
        mesh, args = port_inputs(CASES[case], shape, True)
        before = snapshot(args)
        state, consensus, tiebreak = tpar.build_cycle_tiebreak_loop(
            mesh, donate=donate)(*args, NOW, 2)
        if not donate:
            assert_unchanged(args, before)
        assert_state_equal(whole_state(state, shape, True), want_state)
        np.testing.assert_allclose(consensus.numpy(), want_consensus,
                                   equal_nan=True, **BOUND)
        assert isinstance(tiebreak, tpar.RingTieBreakResult)
        for name, got, ref in zip(tiebreak._fields, tiebreak, want_tb):
            got = got.numpy()
            assert got.shape == (M,) and got.dtype == ref.dtype, name
            if case == "exact" or got.dtype.kind == "i":
                np.testing.assert_array_equal(got, ref, err_msg=name)
            else:
                np.testing.assert_allclose(got, ref, equal_nan=True,
                                           err_msg=name, **DECAYED_TB)


def test_loop_over_steps_resumes_bit_for_bit():
    """3 steps equal 2 steps then 1 from the returned state (market-major,
    the reduced carry and the full state)."""
    for case in ("decays", "reduced"):
        _, args = port_inputs(CASES[case], None, False)
        loop = tpar.build_cycle_loop(slot_major=False, donate=False)
        full_state, full = loop(*args, NOW, 3)
        mid, _ = loop(*args, NOW, 2)
        resumed_state, resumed = loop(*args[:3], mid, NOW + 2, 1)
        np.testing.assert_array_equal(resumed.numpy(), full.numpy())
        assert_state_equal(whole_state(resumed_state, None, False),
                           whole_state(full_state, None, False))


def test_zero_steps_and_the_conventions():
    """Zero steps return the state and a zero consensus; a device names
    its (1, 1) mesh (grids); the refusals."""
    x = CASES["decays"]
    _, args = port_inputs(x, None, True)
    state, consensus = tpar.build_cycle_loop(donate=False)(*args, NOW, 0)
    assert torch.equal(consensus, torch.zeros(M))
    assert_state_equal(whole_state(state, None, True),
                       whole_state(args[3], None, True))
    mesh, grids = port_inputs(x, (1, 1), True)
    on_device = tpar.build_cycle_loop("cpu", donate=False)(*grids, NOW, 2)
    on_mesh = tpar.build_cycle_loop(mesh, donate=False)(*grids, NOW, 2)
    whole = tpar.build_cycle_loop(donate=False)(*args, NOW, 2)
    np.testing.assert_array_equal(on_device[1].numpy(), whole[1].numpy())
    assert_state_equal(whole_state(on_device[0], (1, 1), True),
                       whole_state(whole[0], None, True))
    assert_state_equal(whole_state(on_mesh[0], (1, 1), True),
                       whole_state(whole[0], None, True))
    with pytest.raises(NotImplementedError, match="item 10"):
        tpar.build_cycle_tiebreak_loop(mesh, chunk_agents="auto")
    meta = [torch.empty((K, M), device="meta")] * 2
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpar.build_cycle()(*meta, None, None, NOW)
