"""Deterministic cross-host merge of telemetry snapshots.

The port's copy of the JAX package's ``obs/fleet.py``: the same fold,
wire format and refusals, so two observers (one per package) folding
the same snapshot set produce the same fleet view and ``/metrics`` BYTES.

* Counters sum across hosts; gauges stay per host (a gauge of one host
  is not additive with another's); histograms merge by bucket sum and
  refuse a bucket-layout mismatch.
* Expected-but-missing hosts are EXPLICIT (``hosts_absent``), a higher
  epoch of one host supersedes a lower one, and a same-epoch conflict
  refuses.
* Per-class QoS blocks sum their counts and recompute goodput.
* The fold is order-independent: any fold order gives the same BYTES.

Stdlib-only and read-side: the fold runs on snapshots, never on a live
store.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

from bayesian_consensus_engine_tpu_torch.obs.export import (
    format_labels,
    format_metric_value,
    render_histogram_lines,
    sanitize_metric_name,
)
from bayesian_consensus_engine_tpu_torch.obs.slo import goodput_from_counts


@dataclass(frozen=True)
class HostSnapshot:
    """One host's epoch-tagged metric snapshot.

    ``metrics`` is a :meth:`~.obs.metrics.MetricsRegistry.export`-shaped
    dict (``counters``/``gauges``/``histograms``). ``qos`` is
    the host's per-class QoS block when its service declared tenant
    classes — class name → ``{slo_s, counts, ...}``, exactly the
    ``/snapshot`` endpoint's qos payload — and ``None`` on hosts without
    one. Instances are what a host publishes and what every observer
    folds — the fold never goes back to the host.
    """

    host_id: int
    epoch: int
    metrics: Mapping[str, Mapping]
    qos: Optional[Mapping[str, Mapping]] = None

    def __post_init__(self) -> None:
        if self.epoch < 0:
            raise ValueError(f"epoch must be >= 0; got {self.epoch}")


def snapshot_host(
    host_id: int, epoch: int, registry, qos=None
) -> HostSnapshot:
    """This host's snapshot of *registry*, tagged with its membership
    identity — the publish half of the fleet fold."""
    return HostSnapshot(
        host_id=int(host_id), epoch=int(epoch), metrics=registry.export(),
        qos=dict(qos) if qos is not None else None,
    )


def snapshot_to_json(snapshot: HostSnapshot) -> str:
    """Byte-deterministic serialisation (sorted keys, fixed separators —
    the deterministic-bytes contract): what a host writes to the wire or a soak dir."""
    payload = {
        "host_id": snapshot.host_id,
        "epoch": snapshot.epoch,
        "metrics": snapshot.metrics,
    }
    if snapshot.qos is not None:
        payload["qos"] = snapshot.qos
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def snapshot_from_json(raw: str) -> HostSnapshot:
    return snapshot_from_wire(json.loads(raw))


def snapshot_from_wire(payload: Mapping[str, object]) -> HostSnapshot:
    """Lift a scraped ``/snapshot`` payload (or a
    :func:`snapshot_to_json` round trip) into a :class:`HostSnapshot` —
    extra endpoint fields (phases, trace, health) are ignored; the fleet
    fold is a metrics (+ per-class QoS) fold."""
    qos = payload.get("qos")
    return HostSnapshot(
        host_id=int(payload["host_id"]),
        epoch=int(payload["epoch"]),
        metrics=dict(payload["metrics"]),
        qos=dict(qos) if qos is not None else None,
    )


def merge_fleet(
    snapshots: Sequence[HostSnapshot],
    expected_hosts: Optional[Sequence[int]] = None,
) -> Dict[str, object]:
    """Fold a snapshot set into the canonical fleet view.

    Deterministic regardless of input order: snapshots are keyed by
    host, each host's highest-epoch snapshot wins (two snapshots for one
    host at ONE epoch is a contradiction and raises — the telemetry
    analogue of the split-brain refusal), hosts iterate sorted
    ascending — the same ordering discipline ``MeshView`` lays bands out
    with, which is what lets any observer reproduce any other's bytes.
    """
    if not snapshots:
        raise ValueError("no snapshots to merge")
    # Conflicts are checked per (host, epoch) over the WHOLE input —
    # not just against the current winner — so the refusal itself is
    # order-independent: a conflict at a superseded epoch still refuses
    # no matter where the superseding snapshot sat in the sequence.
    seen: Dict[tuple, HostSnapshot] = {}
    latest: Dict[int, HostSnapshot] = {}
    for snap in snapshots:
        held_at_epoch = seen.get((snap.host_id, snap.epoch))
        if held_at_epoch is None:
            seen[(snap.host_id, snap.epoch)] = snap
        elif (
            held_at_epoch.metrics != snap.metrics
            or held_at_epoch.qos != snap.qos
        ):
            raise ValueError(
                f"two conflicting snapshots for host {snap.host_id} "
                f"at epoch {snap.epoch} — refusing to merge"
            )
        held = latest.get(snap.host_id)
        if held is None or snap.epoch > held.epoch:
            latest[snap.host_id] = snap
    hosts = sorted(latest)
    epoch = max(snap.epoch for snap in latest.values())
    expected = (
        sorted(int(h) for h in expected_hosts)
        if expected_hosts is not None else hosts
    )
    absent = sorted(set(expected) - set(hosts))

    counters: Dict[str, int] = {}
    gauges: Dict[str, Dict[str, float]] = {}
    histograms: Dict[str, Dict[str, object]] = {}
    per_host_epochs: Dict[str, int] = {}
    for host in hosts:
        snap = latest[host]
        per_host_epochs[str(host)] = snap.epoch
        metrics = snap.metrics
        for name in sorted(metrics.get("counters", {})):
            counters[name] = counters.get(name, 0) + int(
                metrics["counters"][name]
            )
        for name in sorted(metrics.get("gauges", {})):
            gauges.setdefault(name, {})[str(host)] = float(
                metrics["gauges"][name]
            )
        for name in sorted(metrics.get("histograms", {})):
            snap_hist = metrics["histograms"][name]
            merged = histograms.get(name)
            if merged is None:
                histograms[name] = {
                    "bounds": list(snap_hist["bounds"]),
                    "counts": list(snap_hist["counts"]),
                    "count": int(snap_hist["count"]),
                    "sum": float(snap_hist["sum"]),
                }
                continue
            if list(snap_hist["bounds"]) != merged["bounds"]:
                raise ValueError(
                    f"histogram {name!r}: bucket layouts differ across "
                    "hosts — the layout is schema; cannot merge"
                )
            merged["counts"] = [
                a + b for a, b in zip(merged["counts"], snap_hist["counts"])
            ]
            merged["count"] += int(snap_hist["count"])
            merged["sum"] += float(snap_hist["sum"])
    qos = _merge_qos(hosts, latest)
    view = {
        "epoch": epoch,
        "hosts": hosts,
        "host_epochs": per_host_epochs,
        "expected_hosts": expected,
        "hosts_absent": absent,
        "counters": {name: counters[name] for name in sorted(counters)},
        "gauges": {name: gauges[name] for name in sorted(gauges)},
        "histograms": {
            name: histograms[name] for name in sorted(histograms)
        },
    }
    if qos is not None:
        view["qos"] = qos
    return view


def _merge_qos(hosts, latest) -> Optional[Dict[str, object]]:
    """Fold the class-labeled QoS blocks under the same discipline.

    Hosts without a qos block contribute nothing (a host can serve
    without tenant classes); hosts WITH one must agree on the class
    VOCABULARY — the sorted class-name set and each class's ``slo_s``.
    A disagreement refuses like a histogram-layout mismatch: the class
    list is schema, and summing a "premium" that means 50 ms on host 0
    into a "premium" that means 5 s on host 1 would be a number nobody
    declared. Per class: outcome ``counts`` SUM (the SloTracker merge
    rule), goodput is recomputed from the sum, ``pending`` stays a
    per-host series, and ``hosts_burning`` lists the hosts whose class
    monitor was burning — burning is a statement about one host's
    budget, never a fleet average.
    """
    carrying = [
        (host, latest[host].qos) for host in hosts
        if latest[host].qos  # None or {} both mean "no tenant classes"
    ]
    if not carrying:
        return None
    vocabulary = None
    vocabulary_host = None
    for host, qos in carrying:
        vocab = {
            str(name): float((qos[name] or {}).get("slo_s") or 0.0)
            for name in qos
        }
        if vocabulary is None:
            vocabulary, vocabulary_host = vocab, host
        elif vocab != vocabulary:
            raise ValueError(
                "QoS class vocabularies differ across hosts "
                f"(host {vocabulary_host}: {sorted(vocabulary)} vs "
                f"host {host}: {sorted(vocab)}, slo_s compared per "
                "class) — the class list is schema; cannot merge"
            )
    merged: Dict[str, Dict[str, object]] = {}
    for name in sorted(vocabulary):
        counts: Dict[str, int] = {}
        pending: Dict[str, int] = {}
        burning_hosts = []
        for host, qos in carrying:
            record = qos[name] or {}
            for outcome in sorted(record.get("counts") or {}):
                value = record["counts"][outcome]
                if isinstance(value, (int, float)):
                    counts[outcome] = counts.get(outcome, 0) + int(value)
            pending[str(host)] = int(record.get("pending") or 0)
            if record.get("burning"):
                burning_hosts.append(host)
        merged[name] = {
            "slo_s": vocabulary[name],
            "counts": {k: counts[k] for k in sorted(counts)},
            "offered": sum(counts.values()),
            "goodput_within_slo": goodput_from_counts(counts),
            "pending": pending,
            "hosts_burning": burning_hosts,
        }
    return merged


def fleet_to_json(view: Mapping[str, object]) -> str:
    """Byte-deterministic dump of a :func:`merge_fleet` view — the
    observer-agreement witness (two observers, same snapshot set, same
    bytes)."""
    return json.dumps(view, sort_keys=True, separators=(",", ":"))


def render_fleet_prometheus(
    view: Mapping[str, object], prefix: str = "bce"
) -> str:
    """Prometheus text exposition of a fleet view.

    Counters render fleet-summed (no labels), gauges render one labeled
    series per host (``bce_x{host="0"}``, hosts sorted), histograms
    render bucket-merged; ``bce_fleet_epoch`` / ``bce_fleet_hosts`` /
    ``bce_fleet_hosts_absent`` carry the membership story. Same
    determinism contract as the single-host renderer: identical view,
    identical bytes.
    """
    lines: List[str] = []
    for name, value in (
        ("fleet.epoch", view["epoch"]),
        ("fleet.hosts", len(view["hosts"])),
        ("fleet.hosts_absent", len(view["hosts_absent"])),
    ):
        metric = sanitize_metric_name(name, prefix)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {format_metric_value(value)}")
    qos_view = view.get("qos") or {}
    if qos_view:
        # Class-labeled series: one ``class=`` label per declared tenant
        # class, names sorted — same determinism contract as hosts.
        offered_metric = sanitize_metric_name("qos.offered", prefix)
        goodput_metric = sanitize_metric_name(
            "qos.goodput_within_slo", prefix
        )
        lines.append(f"# TYPE {offered_metric} counter")
        for name in sorted(qos_view):
            lines.append(
                f"{offered_metric}{format_labels({'class': name})} "
                f"{format_metric_value(qos_view[name].get('offered', 0))}"
            )
        lines.append(f"# TYPE {goodput_metric} gauge")
        for name in sorted(qos_view):
            goodput = qos_view[name].get("goodput_within_slo")
            if goodput is not None:
                lines.append(
                    f"{goodput_metric}{format_labels({'class': name})} "
                    f"{format_metric_value(goodput)}"
                )
    for raw_name in sorted(view.get("counters", {})):
        metric = sanitize_metric_name(raw_name, prefix)
        lines.append(f"# TYPE {metric} counter")
        lines.append(
            f"{metric} {format_metric_value(view['counters'][raw_name])}"
        )
    for raw_name in sorted(view.get("gauges", {})):
        metric = sanitize_metric_name(raw_name, prefix)
        lines.append(f"# TYPE {metric} gauge")
        per_host = view["gauges"][raw_name]
        for host in sorted(per_host, key=int):
            lines.append(
                f"{metric}{format_labels({'host': host})} "
                f"{format_metric_value(per_host[host])}"
            )
    for raw_name in sorted(view.get("histograms", {})):
        lines.extend(
            render_histogram_lines(
                sanitize_metric_name(raw_name, prefix),
                view["histograms"][raw_name],
            )
        )
    return "\n".join(lines) + "\n" if lines else ""
