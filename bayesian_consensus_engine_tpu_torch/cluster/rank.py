"""One rank of a multi-process band settlement.

A rank joins the ``torch.distributed`` group (gloo, the control plane
only), and for each per-rank ``ici_shape`` of its job settles ITS band of
the global markets axis on its rows of the hybrid mesh
(:meth:`~.cluster.membership.MeshView.build_mesh`) through a band plan and
a band session: two chained settles, the adopt of a second,
drifted batch (its block held against a session rebuilt from the host)
and a third settle. With ``local`` it runs the same calls once more on
the one-host view's local mesh (``MeshView.degraded([rank])``), with the
band's markets as the whole axis.

Run from a checkout's root::

    python -m bayesian_consensus_engine_tpu_torch.cluster.rank JOB

JOB is one JSON object:

* ``port``, ``rank``, ``ranks`` — the rendezvous on ``127.0.0.1:port``;
* ``device`` — ``"cuda"`` (the current card; raises without CUDA) or
  ``"cpu"``;
* ``batches`` — the ``.npz`` that :func:`save_batches` wrote: this rank's
  band of the two batches, band-local;
* ``markets`` — the global markets axis; ``num_slots`` — the globally
  agreed K; ``steps`` — each settle's steps; ``now`` — the three
  settles' days;
* ``icis`` — the per-rank ici shapes, one band run each; ``local`` — an
  ici shape for the local-mesh run, or null;
* ``out`` — the path of each run's ``.npz``, ``%s`` standing for the
  run's name (``"1x2"``, ``"local"``): the three settles' consensus, the
  band's market keys, the stored values at both plans' slots and, with
  ``records``, the store's records (ids and stamps, values).

The report (seconds, launches, peak device bytes, band checks) is the
last line of standard output, one JSON object. Any failed check raises.
"""

from __future__ import annotations

import json
import sys
import time
from datetime import timedelta

import numpy as np
import torch

#: The stored fields a run writes at each plan's slots.
FIELDS = ("rel", "conf", "days", "exists")


def band_columns(columns, rows: range):
    """The band *rows* of a global columnar batch ``(keys, sources, probs,
    offsets, outcomes)``, band-local: its keys, sources (a
    :class:`~.core.batch.SourceCodes` or a per-signal sequence),
    probabilities, offsets rebased to 0, and outcomes."""
    from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes

    keys, sources, probs, offsets, outcomes = columns
    lo, hi = rows.start, rows.stop
    a, b = int(offsets[lo]), int(offsets[hi])
    if isinstance(sources, SourceCodes):
        sources = SourceCodes(sources.codes[a:b], sources.table)
    else:
        sources = sources[a:b]
    return (keys[lo:hi], sources, probs[a:b],
            np.asarray(offsets[lo:hi + 1]) - a, outcomes[lo:hi])


def save_batches(path: str, rows: range, batches) -> None:
    """Write a rank's band-local columnar *batches* (sources as
    ``SourceCodes``) and its band *rows* of the global axis to *path*."""
    arrays = {"rows": np.array([rows.start, rows.stop])}
    for i, (keys, sources, probs, offsets, outcomes) in enumerate(batches):
        arrays.update({
            f"keys_{i}": np.asarray(keys, dtype=str),
            f"codes_{i}": sources.codes, f"table_{i}": np.asarray(
                sources.table, dtype=str),
            f"probs_{i}": probs, f"offsets_{i}": offsets,
            f"outcomes_{i}": outcomes})
    np.savez(path, **arrays)


def load_batches(path: str):
    """``(rows, batches)`` as :func:`save_batches` wrote them."""
    from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes

    with np.load(path) as data:
        batches = []
        i = 0
        while f"keys_{i}" in data:
            batches.append((
                data[f"keys_{i}"].tolist(),
                SourceCodes(data[f"codes_{i}"], data[f"table_{i}"].tolist()),
                data[f"probs_{i}"], data[f"offsets_{i}"],
                data[f"outcomes_{i}"]))
            i += 1
        start, stop = (int(x) for x in data["rows"])
    return range(start, stop), batches


def _timed(device: torch.device, fn):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - start


def _settle_run(job: dict, device: torch.device, mesh, band, batches) -> tuple:
    """Plan, two settles, the drifted batch's adopt (held against a
    rebuild), a third settle. Returns ``(report, arrays)``."""
    from bayesian_consensus_engine_tpu_torch import convert, pipeline
    from bayesian_consensus_engine_tpu_torch.ops import (
        onepass_kernel,
        partials_kernel,
    )
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    first, second = batches
    steps, now, num_slots = job["steps"], job["now"], job["num_slots"]
    onepass_kernel.LAUNCHES = partials_kernel.LAUNCHES = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    seconds = {}
    store = TensorReliabilityStore(device=device)
    plan, seconds["plan"] = _timed(device, lambda: (
        pipeline.build_settlement_plan_columnar(
            store, *first[:4], num_slots=num_slots)))
    session = pipeline.ShardedSettlementSession(store, plan, mesh, band=band)
    consensus = []
    for call in range(2):
        result, seconds[f"settle_{call + 1}"] = _timed(device, lambda: (
            session.settle(first[4], steps=steps, now=now[call])))
        consensus.append(np.asarray(result.consensus))
    plan2, seconds["plan_2"] = _timed(device, lambda: (
        pipeline.build_settlement_plan_columnar(
            store, *second[:4], num_slots=num_slots)))
    served, seconds["adopt"] = _timed(
        device, lambda: session.adopt(plan2, band=band))
    # The adopted block against one rebuilt from the synced host store.
    start = time.perf_counter()
    adopted = convert.sharded_block_to_numpy(session._state)
    store.sync()
    rebuild = pipeline.ShardedSettlementSession(store, plan2, mesh, band=band)
    rebuild._build_state(session._epoch0)
    rebuilt = convert.sharded_block_to_numpy(rebuild._state)
    rebuild_equal = [bool(np.array_equal(a, b))
                     for a, b in zip(adopted, rebuilt)]
    del adopted, rebuilt, rebuild
    seconds["rebuild_check"] = time.perf_counter() - start
    result, seconds["settle_3"] = _timed(device, lambda: session.settle(
        second[4], steps=steps, now=now[2]))
    consensus.append(np.asarray(result.consensus))
    keys = list(result.market_keys)
    session.close()
    arrays = {f"consensus_{i}": c for i, c in enumerate(consensus, 1)}
    arrays["keys"] = np.asarray(keys, dtype=str)
    for label, bound in (("plan1", plan), ("plan2", plan2)):
        values = store.host_rows(bound.slot_rows[bound.mask])
        for field, column in zip(FIELDS, values):
            arrays[f"{label}_{field}"] = column
    if job.get("records"):
        records = store.list_sources()
        arrays["record_ids"] = np.asarray(
            [[r.source_id, r.market_id, r.updated_at] for r in records],
            dtype=str).reshape(-1, 3)
        arrays["record_values"] = np.asarray(
            [[r.reliability, r.confidence] for r in records],
            dtype=np.float64).reshape(-1, 2)
    report = dict(
        served=served, rebuild_equal=rebuild_equal, store_rows=len(store),
        local_mesh_rows=len(session._local_mesh.devices), seconds=seconds,
        launches={"onepass_settle": onepass_kernel.LAUNCHES,
                  "onepass_partials": partials_kernel.LAUNCHES},
        peak_device_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None))
    return report, arrays


def run_rank(job: dict) -> dict:
    """Run *job* (see the module's docstring); return the report."""
    from bayesian_consensus_engine_tpu_torch import pipeline
    from bayesian_consensus_engine_tpu_torch.cluster.membership import MeshView
    from bayesian_consensus_engine_tpu_torch.parallel import distributed
    from bayesian_consensus_engine_tpu_torch.parallel.mesh import make_mesh

    rank, ranks, markets = job["rank"], job["ranks"], job["markets"]
    # The device as a mesh names it (the current card; raising without
    # CUDA when the job asks for one).
    device = make_mesh((1, 1), [job["device"]]).devices[0][0]
    start = time.perf_counter()
    address = f"127.0.0.1:{job['port']}"
    info = distributed.init_distributed(
        coordinator_address=address, num_processes=ranks, process_id=rank,
        timeout=timedelta(seconds=job.get("timeout_s", 120)))
    report = {"rank": rank, "rendezvous_s": time.perf_counter() - start}
    if (info["process_index"], info["process_count"]) != (rank, ranks) \
            or pipeline._process_count() != ranks:
        raise AssertionError(f"rank {rank}: the session does not see the "
                             f"group ({info})")
    if distributed.init_distributed(coordinator_address=address,
                                    num_processes=ranks,
                                    process_id=rank) != info:
        raise AssertionError(f"rank {rank}: a second bring-up is not a no-op")
    rows, batches = load_batches(job["batches"])
    view = MeshView(epoch=0, hosts=tuple(range(ranks)))
    if view.owned_markets(rank, markets) != rows:
        raise AssertionError(f"rank {rank}: batches for rows {rows}")
    runs = [(tuple(ici), False) for ici in job["icis"]]
    if job.get("local"):
        runs.append((tuple(job["local"]), True))
    for ici, local in runs:
        width = ici[0] * ici[1]
        view = MeshView(epoch=0, hosts=tuple(range(ranks)),
                        devices_per_host=width, ici_shape=ici)
        if local:
            name, band = "local", None
            mesh = view.degraded([rank]).build_mesh([device] * width)
            if mesh.local(rank) is not mesh:
                raise AssertionError(f"rank {rank}: the local mesh is not "
                                     "wholly this process's")
            checks = {}
        else:
            name, band = "%dx%d" % ici, view.band(rank, markets)
            mesh = view.build_mesh([device] * width)
            lo, hi = distributed.process_market_rows(
                view.padded_markets(markets), mesh)
            want_owners = tuple(r for r in range(ranks) for _ in range(ici[0]))
            if (lo, markets) != band or mesh.owners != want_owners \
                    or view.owned_markets(rank, markets) != rows:
                raise AssertionError(
                    f"rank {rank} {name}: band {band}, rows [{lo}, {hi}), "
                    f"owners {mesh.owners}")
            checks = {"band": list(band), "padded_band": [lo, hi]}
        run, arrays = _settle_run(job, device, mesh, band, batches)
        np.savez(job["out"] % name, **arrays)
        counts = [None] * ranks
        torch.distributed.all_gather_object(counts, run["store_rows"])
        report[name] = dict(checks, rows=[rows.start, rows.stop],
                            store_rows_by_rank=counts, **run)
        torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m bayesian_consensus_engine_tpu_torch.cluster."
              "rank JOB", file=sys.stderr)
        return 2
    print(json.dumps(run_rank(json.loads(argv[0]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
