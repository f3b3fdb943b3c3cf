"""Time the replay lanes' settle kernel on the card, on chip_smoke's replay trace.

    python3 scripts/time_lane_kernel.py

Builds ``chip_smoke.py``'s main batch (``main_data``) and its stream
phase's four batches (``stream_batches``: the main batch, the same markets
in the same order with new probabilities, then a drifted batch whose
markets come shuffled, twice), replays them as a trace with the stream
phase's settlement days and steps under ``replay_configs``' 16 lanes
(``replay_sweep(rebuild=False)``), and captures each batch's
``settle_cycles_lanes`` inputs. For each batch it then times the launch
at each C of chip_smoke's ``LANE_SCALING`` lanes (beyond 16, the 16
repeated), in place after a warm-up launch, with chip_smoke's
``time_cuda`` (CUDA events over 21 launches behind a queued wait), and
prints one JSON line: per batch, the time, the time a lane and the byte
bound (``lanes_bound_bytes``) at each C, the share of (tile, lane) pairs
that the sweep's launch settled a group of lanes a block (its six-slot
route report; null where the package's wrapper takes three slots), the
main path's ``settle_cycles`` on lane 0's state and the same plan (in
place, timed the same way), and a digest of the 16-lane state and
consensus after one launch on the captured inputs (two trees' kernels
that give the same digest gave the same bits); then the card's name and
power limit.

The port's package comes from the first entry of ``sys.path`` that holds
it, and ``chip_smoke.py`` from this checkout, so ``PYTHONPATH=<tree>``
times another tree's kernel on the same trace (a ``git archive`` of a
parent commit, unpacked in a git-ignored directory): run parent, change,
change, parent in one call to compare them. Exits 2 without a CUDA
device.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)  # the package, unless PYTHONPATH names another tree


def load_chip_smoke():
    """This checkout's chip_smoke.py, whatever tree the package comes from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    if not torch.cuda.is_available():
        print("time_lane_kernel: no CUDA device", file=sys.stderr)
        return 2
    from bayesian_consensus_engine_tpu_torch import replay
    from bayesian_consensus_engine_tpu_torch.ops import settle_kernel
    from bayesian_consensus_engine_tpu_torch.parallel import sharded
    from bayesian_consensus_engine_tpu_torch.state.journal import TraceBatch

    smoke = load_chip_smoke()
    _counts, codes, probs, offsets, outcomes, market_keys = smoke.main_data()
    batches = smoke.stream_batches(market_keys, codes, probs, offsets,
                                   outcomes)
    trace = [TraceBatch(index, tuple(keys), tuple(sids),
                        np.asarray(batch_probs, dtype=np.float64),
                        np.asarray(batch_offsets, dtype=np.int64),
                        np.asarray(batch_outcomes, dtype=bool),
                        smoke.STREAM_NOW + index, smoke.STEPS)
             for index, ((keys, sids, batch_probs, batch_offsets),
                         batch_outcomes) in enumerate(batches)]
    del batches, codes, probs, offsets, outcomes, market_keys
    configs = smoke.replay_configs(replay)
    slots = getattr(settle_kernel, "LANE_ROUTE_SLOTS", None)

    real_lanes = sharded.settle_cycles_lanes
    captured = []

    def capturing_lanes(*args, **kwargs):
        inputs = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args]
        share = None
        if slots is None:
            out = real_lanes(*args, **kwargs)
        else:
            routes = torch.zeros(slots, dtype=torch.int32,
                                 device=args[0].device)
            out = real_lanes(*args, routes=routes, **kwargs)
            staged, wide, _stage, grouped = routes.tolist()[:4]
            share = grouped / (staged + wide) if staged + wide else None
        captured.append((inputs, share))
        return out

    sharded.settle_cycles_lanes = capturing_lanes
    try:
        replay.replay_sweep(trace, configs, rebuild=False, device="cuda")
    finally:
        sharded.settle_cycles_lanes = real_lanes
    del trace

    def launch(a):
        return settle_kernel.settle_cycles_lanes(*a)

    out = {"lanes": len(configs), "lane_scaling": smoke.LANE_SCALING,
           "batches": []}
    for index, (args, share) in enumerate(captured):
        got = launch([a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args])
        digest = hashlib.sha256()
        for field in got:
            digest.update(field.cpu().numpy().tobytes())
        del got
        launch(args)  # every masked row exists: the steady state
        rows = args[4][args[6]].long()
        existing = [int(args[3][c][rows].sum()) for c in range(len(configs))]
        entries = []
        for count in smoke.LANE_SCALING:
            reps = -(-count // len(configs))
            lanes_args = [
                *(x.repeat(reps, 1)[:count].contiguous() for x in args[:4]),
                *args[4:12], args[12].repeat(reps, 1)[:count].contiguous()]
            ms = smoke.time_cuda(launch, lambda: lanes_args, warmup=2,
                                 runs=21)
            del lanes_args
            bound = settle_kernel.lanes_bound_bytes(
                count, int(args[4].shape[0]), int(args[4].shape[1]),
                int(args[9]), [existing[c % len(configs)]
                               for c in range(count)], int(args[11]), 4)
            entries.append({"lanes": count, "ms": ms,
                            "ms_per_lane": ms / count,
                            "bound_ms": bound / smoke.HBM_BYTES_PER_S * 1e3})
        lane0 = [x[0].clone() for x in args[:4]] + list(args[4:12])
        settle_ms = smoke.time_cuda(lambda a: settle_kernel.settle_cycles(*a),
                                    lambda: lane0, warmup=2, runs=21)
        del lane0
        out["batches"].append({
            "batch": index, "markets": int(args[4].shape[1]),
            "masked_slots": int(args[9]), "group_share": share,
            "digest": digest.hexdigest()[:16], "scaling": entries,
            "settle_cycles_lane0_ms": settle_ms})
        captured[index] = None
    out["package"] = os.path.dirname(os.path.dirname(
        os.path.abspath(settle_kernel.__file__)))
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
