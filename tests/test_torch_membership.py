"""The port's ``MeshView`` ≡ the JAX package's, on the CPU.

Over host sets, ``devices_per_host`` and ``ici_shape``: the validated
fields, ``shape``, ``band``, ``owned_markets``, ``padded_markets``,
``rank_of``, the degraded views and the ``fingerprint`` bytes equal the
JAX ``MeshView``'s, and the same bad inputs raise the same exception
types with the same messages. ``build_mesh`` on a one-host view gives the
local mesh over the caller's devices, and ``runtime_view`` reads one host
outside a ``torch.distributed`` group.
"""

import pytest
import torch

from bayesian_consensus_engine_tpu.cluster.membership import (
    MeshView as JaxMeshView,
)
from bayesian_consensus_engine_tpu_torch.cluster import MeshView, runtime_view
from bayesian_consensus_engine_tpu_torch.parallel.mesh import MARKETS_AXIS

VIEWS = [
    dict(epoch=0, hosts=(0,)),
    dict(epoch=0, hosts=(0, 1)),
    dict(epoch=3, hosts=(2, 0, 5), devices_per_host=2),
    dict(epoch=7, hosts=(4, 1, 3, 0), devices_per_host=4, ici_shape=(2, 2)),
    dict(epoch=1, hosts=(9, 8), devices_per_host=8, ici_shape=(1, 8)),
    dict(epoch=2, hosts=range(5), devices_per_host=6, ici_shape=(3, 2)),
]
GLOBAL_MARKETS = (0, 1, 7, 64, 250_000, 1_000_003)


def both(**kw):
    return MeshView(**kw), JaxMeshView(**kw)


@pytest.mark.parametrize("kw", VIEWS, ids=lambda kw: str(tuple(kw.values())))
def test_view_layout_equals_jax(kw):
    ours, theirs = both(**kw)
    assert (ours.epoch, ours.hosts, ours.devices_per_host, ours.ici_shape) == (
        theirs.epoch, theirs.hosts, theirs.devices_per_host, theirs.ici_shape)
    assert (ours.num_hosts, ours.markets_extent, ours.sources_extent,
            ours.shape) == (theirs.num_hosts, theirs.markets_extent,
                            theirs.sources_extent, theirs.shape)
    assert ours.fingerprint == theirs.fingerprint
    assert isinstance(ours.fingerprint, bytes) and len(ours.fingerprint) == 16
    for host in ours.hosts:
        assert ours.rank_of(host) == theirs.rank_of(host)
        for markets in GLOBAL_MARKETS:
            assert ours.padded_markets(markets) == theirs.padded_markets(markets)
            assert ours.band(host, markets) == theirs.band(host, markets)
            assert ours.owned_markets(host, markets) == (
                theirs.owned_markets(host, markets))
    assert hash(ours) == hash(MeshView(**kw)) and ours == MeshView(**kw)


@pytest.mark.parametrize("kw", VIEWS[1:], ids=lambda kw: str(tuple(kw.values())))
def test_degraded_views_equal_jax(kw):
    ours, theirs = both(**kw)
    hosts = list(ours.hosts)
    for survivors in (hosts[1:], hosts[:-1], hosts[::2]):
        mine, jax_view = ours.degraded(survivors), theirs.degraded(survivors)
        assert mine.epoch == ours.epoch + 1 == jax_view.epoch
        assert mine.hosts == jax_view.hosts
        assert mine.fingerprint == jax_view.fingerprint
        for markets in GLOBAL_MARKETS:
            for host in mine.hosts:
                assert mine.band(host, markets) == jax_view.band(host, markets)
    # The live bands of a view tile the global axis, in host order.
    for markets in GLOBAL_MARKETS:
        rows = [r for h in ours.hosts for r in ours.owned_markets(h, markets)]
        assert rows == list(range(markets))


@pytest.mark.parametrize("call", [
    lambda cls: cls(epoch=-1, hosts=(0,)),
    lambda cls: cls(epoch=0, hosts=()),
    lambda cls: cls(epoch=0, hosts=(1, 1)),
    lambda cls: cls(epoch=0, hosts=(0,), devices_per_host=0),
    lambda cls: cls(epoch=0, hosts=(0,), devices_per_host=4, ici_shape=(3, 1)),
    lambda cls: cls(epoch=0, hosts=(0, 1)).rank_of(7),
    lambda cls: cls(epoch=0, hosts=(0, 1)).degraded([]),
    lambda cls: cls(epoch=0, hosts=(0, 1)).degraded([2]),
    lambda cls: cls(epoch=0, hosts=(0, 1)).band(3, 10),
], ids=["epoch", "empty", "duplicate", "devices", "ici", "rank_of",
        "degrade_empty", "degrade_stranger", "band_stranger"])
def test_bad_inputs_raise_as_jax(call):
    errors = []
    for cls in (MeshView, JaxMeshView):
        with pytest.raises(Exception) as info:
            call(cls)
        errors.append(info)
    assert errors[0].type is errors[1].type is ValueError
    assert str(errors[0].value) == str(errors[1].value)


def test_distinct_views_never_share_a_fingerprint():
    views = {MeshView(**kw) for kw in VIEWS}
    views |= {view.degraded(list(view.hosts)[:1]) for view in list(views)}
    prints = {view.fingerprint for view in views}
    assert len(views) > len(VIEWS) and len(prints) == len(views)


@pytest.mark.parametrize("ici_shape", [None, (1, 2), (2, 1), (4, 1)])
def test_one_host_build_mesh_is_the_local_mesh(ici_shape):
    dph = 2 if ici_shape is None else ici_shape[0] * ici_shape[1]
    view = MeshView(epoch=0, hosts=(3,), devices_per_host=dph,
                    ici_shape=ici_shape)
    mesh = view.build_mesh(devices=[torch.device("cpu")] * dph)
    assert (mesh.shape[MARKETS_AXIS], mesh.shape["sources"]) == view.shape
    assert mesh.owners is None
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)


def test_build_mesh_without_devices_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshView(epoch=0, hosts=(0,)).build_mesh()


def test_runtime_view_outside_a_group_is_one_host():
    view = runtime_view(epoch=4)
    assert view.epoch == 4 and view.hosts == (0,)
    assert view.devices_per_host >= 1
