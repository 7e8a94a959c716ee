"""Run reports: one document from a run's telemetry artifacts.

Counterpart of ``photon_ml_tpu/telemetry/report.py``, with its record
formats, sections and rendering, so both packages' reports of the same
artifacts read alike. :class:`RunReport` merges a span JSONL, a telemetry
JSONL (its last ``metrics`` snapshot and its ``heartbeat`` lines) and a
checkpoint directory's manifests:

- the phase-time breakdown: the ``fit > cd_iteration > coordinate:<name>``
  span tree aggregated by name path, with count, total and self time;
- the top spans and the fetch accounting;
- per-coordinate convergence and guard history from the newest checkpoint
  manifest (steps, retries, rollbacks, frozen coordinates);
- the sweep, ingestion, serving, freshness, pipeline, quality, recovery,
  memory and heartbeat sections, each present only when the run has data
  for it;
- ``key_metrics()``, the scalars ``compare(baseline)`` gates on: a metric
  that moved against its direction by more than the threshold is flagged,
  and ``python -m photon_ml_tpu_torch.cli report --compare baseline.json
  --fail-on-regress`` exits 3.

The "Requests" section summarizes the request ring (records, tail-sampled
persists, ring drops, p50/p99 by phase) and lists the slowest persisted
request traces. "Device utilization" gives the run's and each phase's
modelled FLOPs and bytes (``telemetry/executables.py``), MFU, bandwidth
utilization, collective bytes and compile share; "Hot executables" ranks
the executables by the profiler's estimated exclusive device seconds
(``telemetry/profile.py``), with MFU, intensity and bound class. The key
metrics ``mfu`` and ``exec.<name>.mfu`` are built on them.

This module only reads artifacts (or the live registries through
:meth:`RunReport.from_live`); it never touches a device.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import re
from typing import Any, Mapping, Optional, Sequence

__all__ = [
    "RunReport",
    "MetricDelta",
    "PhaseNode",
    "compare_metrics",
    "KEY_METRIC_DIRECTIONS",
    "REPORT_FORMAT_VERSION",
    "report_path",
    "directions_with_exec",
]

REPORT_FORMAT_VERSION = 1

#: Key metrics and their goodness direction: +1 higher-is-better,
#: -1 lower-is-better. Only metrics named here participate in compare()
#: (the reference's table: a baseline of either package compares).
KEY_METRIC_DIRECTIONS: dict[str, int] = {
    "rows_per_sec": +1,
    "coeffs_per_sec": +1,
    "fit_seconds": -1,
    "jit_compiles": -1,
    "jit_compile_seconds": -1,
    "device_fetches": -1,
    "device_fetch_seconds": -1,
    "dropped_spans": -1,
    "mfu": +1,
    "xla_recompiles": -1,
}

def directions_with_exec(*metric_dicts: Mapping[str, Any]) -> dict[str, int]:
    """``KEY_METRIC_DIRECTIONS`` extended with the dynamic per-executable
    utilization metrics (``exec.<name>.mfu``, higher is better) present
    in any of the given metric dicts — executable names are data, so they
    cannot be enumerated statically like the other keys."""
    directions = dict(KEY_METRIC_DIRECTIONS)
    for metrics_dict in metric_dicts:
        for name in metrics_dict:
            if name.startswith("exec.") and name.endswith(".mfu"):
                directions[name] = +1
    return directions

# Fields of the xla.exec.<name>.<field> metric names the executable table
# is reconstructed from (suffix-matched: executable names may contain
# dots, field names never do).
_XLA_EXEC_COUNTER_FIELDS = (
    "calls",
    "compiles",
    "compile_seconds",
    "recompiles",
    "flops_total",
    "bytes_total",
)
_XLA_EXEC_GAUGE_FIELDS = ("flops_per_call", "bytes_per_call", "temp_bytes")

# Fields of the profile.exec.<name>.<field> gauges the Hot-executables
# table is reconstructed from (same suffix-match convention).
_PROFILE_EXEC_GAUGE_FIELDS = (
    "dispatches",
    "sampled",
    "sampled_seconds",
    "est_exclusive_seconds",
    "mean_dispatch_seconds",
    "mfu",
    "intensity",
    "bound_code",
    "timing_suspect",
)

# Human names for the profiler's numeric bound-class codes, kept in sync
# with telemetry.profile.BOUND_CLASS_NAMES (duplicated so reports load
# without importing the profiler). Codes 1 and 2 carry the card's names
# (the reference's MXU and VPU are TPU units); 0, 3 and 4 are the same.
_BOUND_CLASS_NAMES = {
    0: "unknown",
    1: "compute-bound",
    2: "low-compute-bound",
    3: "HBM-bound",
    4: "dispatch-bound",
}

# device_utilization() cache sentinel (the computed value may be None)
_DU_UNSET = object()


_STEP_MANIFEST_RE = re.compile(r"^step-(\d{8})$")


@dataclasses.dataclass
class MetricDelta:
    """One key metric compared against a baseline value."""

    metric: str
    current: float
    baseline: float
    change: float  # signed fraction: (current - baseline) / baseline
    regressed: bool

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def compare_metrics(
    current: Mapping[str, float],
    baseline: Mapping[str, float],
    threshold: float = 0.2,
    directions: Optional[Mapping[str, int]] = None,
) -> list[MetricDelta]:
    """Compare two key-metric dicts; a metric is *regressed* when it moved
    against its goodness direction by more than ``threshold`` (fractional,
    default 20%). Metrics missing from either side, or with a zero
    baseline (no ratio exists), are skipped. Shared by the run-report
    compare and the bench_suite ``--gate``."""
    directions = KEY_METRIC_DIRECTIONS if directions is None else directions
    out: list[MetricDelta] = []
    for name in sorted(set(current) & set(baseline)):
        direction = directions.get(name)
        if direction is None:
            continue
        cur, base = float(current[name]), float(baseline[name])
        if base == 0:
            continue
        change = (cur - base) / abs(base)
        regressed = (direction > 0 and change < -threshold) or (
            direction < 0 and change > threshold
        )
        out.append(
            MetricDelta(
                metric=name,
                current=cur,
                baseline=base,
                change=change,
                regressed=regressed,
            )
        )
    return out


@dataclasses.dataclass
class PhaseNode:
    """One aggregated node of the phase-time tree (all spans sharing the
    same name-path merged: count, total wall time, and self time).

    ``flops``/``bytes``/``comms_bytes`` hold the device-cost attributes
    (``xla_flops``, ``xla_bytes``, ``comms_bytes``) the executable
    accounting accumulated on the spans at this node; the ``subtree_*``
    accessors include descendants: the per-phase roofline numerators."""

    name: str
    count: int = 0
    total_s: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0
    comms_bytes: float = 0.0
    children: dict[str, "PhaseNode"] = dataclasses.field(default_factory=dict)

    @property
    def self_s(self) -> float:
        return max(
            self.total_s - sum(c.total_s for c in self.children.values()), 0.0
        )

    def _subtree(self, field: str) -> float:
        return getattr(self, field) + sum(
            c._subtree(field) for c in self.children.values()
        )

    @property
    def subtree_flops(self) -> float:
        return self._subtree("flops")

    @property
    def subtree_bytes(self) -> float:
        return self._subtree("bytes")

    @property
    def subtree_comms_bytes(self) -> float:
        return self._subtree("comms_bytes")

    def to_dict(self) -> dict[str, Any]:
        d = {
            "name": self.name,
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "self_s": round(self.self_s, 6),
            "children": [
                c.to_dict()
                for c in sorted(
                    self.children.values(), key=lambda c: -c.total_s
                )
            ],
        }
        if self.subtree_flops:
            d["flops"] = self.subtree_flops
        if self.subtree_bytes:
            d["bytes_accessed"] = self.subtree_bytes
        if self.subtree_comms_bytes:
            d["comms_bytes"] = self.subtree_comms_bytes
        return d


def build_phase_tree(spans: Sequence[Mapping[str, Any]]) -> PhaseNode:
    """Aggregate span records (``Span.to_dict()`` / trace JSONL lines)
    into a name-path tree under a synthetic root. Spans whose parents fell
    out of a bounded buffer root at their earliest surviving ancestor."""
    by_id = {s.get("id"): s for s in spans if s.get("id") is not None}
    root = PhaseNode(name="")
    for s in spans:
        names: list[str] = []
        cur: Optional[Mapping[str, Any]] = s
        seen: set[Any] = set()
        while cur is not None and cur.get("id") not in seen:
            seen.add(cur.get("id"))
            names.append(str(cur.get("name", "?")))
            parent = cur.get("parent")
            cur = by_id.get(parent) if parent is not None else None
        node = root
        for name in reversed(names):
            node = node.children.setdefault(name, PhaseNode(name=name))
        node.count += 1
        node.total_s += float(s.get("dur") or 0.0)
        attrs = s.get("attrs") or {}
        node.flops += float(attrs.get("xla_flops") or 0.0)
        node.bytes += float(attrs.get("xla_bytes") or 0.0)
        node.comms_bytes += float(attrs.get("comms_bytes") or 0.0)
    return root


def report_path(trace_out: str) -> str:
    """Sibling ``.report.md`` path for a trace/telemetry JSONL path."""
    base = trace_out[:-6] if trace_out.endswith(".jsonl") else trace_out
    return base + ".report.md"


def _read_jsonl(path: str) -> list[dict]:
    records = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # a crashed run leaves a truncated last line
            if isinstance(rec, dict):
                records.append(rec)
    return records


def _load_checkpoint_manifests(directory: str) -> list[dict]:
    """Every readable ``step-*/manifest.json`` under ``directory``, oldest
    first. Reads only — no dependency on the checkpoint module (reports
    must load anywhere, including hosts without the training stack)."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in sorted(names):
        if not _STEP_MANIFEST_RE.match(name):
            continue
        path = os.path.join(directory, name, "manifest.json")
        try:
            with open(path, encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, ValueError):
            continue  # partial/corrupt checkpoints are the restore path's job
        if isinstance(manifest, dict):
            out.append(manifest)
    return out


@dataclasses.dataclass
class RunReport:
    """One run's merged telemetry: spans + metrics snapshot + heartbeats +
    checkpoint manifests, with markdown/JSON rendering and compare()."""

    spans: list[dict] = dataclasses.field(default_factory=list)
    snapshot: dict = dataclasses.field(default_factory=dict)
    heartbeats: list[dict] = dataclasses.field(default_factory=list)
    manifests: list[dict] = dataclasses.field(default_factory=list)
    sources: dict = dataclasses.field(default_factory=dict)

    # -- construction --------------------------------------------------------

    @classmethod
    def load(
        cls,
        trace: Optional[str] = None,
        telemetry: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
    ) -> "RunReport":
        """Build from on-disk artifacts: a span JSONL (``--trace-out``), a
        telemetry JSONL (``--telemetry-out``; its last ``metrics`` line is
        the snapshot, its ``heartbeat`` lines the liveness record), and a
        checkpoint directory's manifests."""
        spans: list[dict] = []
        snapshot: dict = {}
        heartbeats: list[dict] = []
        manifests: list[dict] = []
        if trace:
            spans = [
                r for r in _read_jsonl(trace) if r.get("type") == "span"
            ]
        if telemetry:
            for rec in _read_jsonl(telemetry):
                if rec.get("type") == "metrics":
                    snapshot = rec.get("snapshot") or {}
                elif rec.get("type") == "heartbeat":
                    heartbeats.append(rec)
        if checkpoint_dir:
            manifests = _load_checkpoint_manifests(checkpoint_dir)
        return cls(
            spans=spans,
            snapshot=snapshot,
            heartbeats=heartbeats,
            manifests=manifests,
            sources={
                "trace": trace,
                "telemetry": telemetry,
                "checkpoint_dir": checkpoint_dir,
            },
        )

    @classmethod
    def from_live(
        cls, checkpoint_dir: Optional[str] = None
    ) -> "RunReport":
        """Build from THIS process's live registries (the train driver's
        ``--report-out`` path needs no re-parse of its own sinks)."""
        from photon_ml_tpu_torch.telemetry import metrics, profile, trace

        # the profiler publishes its derived gauges (MFU, bound class) only
        # on demand: publish them so the snapshot carries the hot list
        profile.publish_metrics()
        return cls(
            spans=[s.to_dict() for s in trace.finished_spans()],
            snapshot=metrics.snapshot(),
            manifests=(
                _load_checkpoint_manifests(checkpoint_dir)
                if checkpoint_dir
                else []
            ),
            sources={"live": True, "checkpoint_dir": checkpoint_dir},
        )

    # -- derived views -------------------------------------------------------

    def phase_tree(self) -> PhaseNode:
        return build_phase_tree(self.spans)

    def top_spans(self, k: int = 10) -> list[dict]:
        """Top-k span NAMES by total wall time (count + total), the
        flame-chart hotspots without opening Perfetto."""
        agg: dict[str, list[float]] = {}
        for s in self.spans:
            entry = agg.setdefault(str(s.get("name", "?")), [0, 0.0])
            entry[0] += 1
            entry[1] += float(s.get("dur") or 0.0)
        ranked = sorted(agg.items(), key=lambda kv: -kv[1][1])[:k]
        return [
            {"name": name, "count": int(c), "total_s": round(t, 6)}
            for name, (c, t) in ranked
        ]

    def key_metrics(self) -> dict[str, float]:
        """The scalar summary compare() gates on."""
        counters = self.snapshot.get("counters", {})
        gauges = self.snapshot.get("gauges", {})
        out: dict[str, float] = {}
        # OUTERMOST fit spans only: the train driver's timed("fit") phase
        # wraps the estimator's own fit span — summing both would double
        # the wall time
        by_id = {
            s.get("id"): s for s in self.spans if s.get("id") is not None
        }

        def _has_fit_ancestor(s) -> bool:
            seen: set[Any] = set()
            parent = s.get("parent")
            while parent is not None and parent not in seen:
                seen.add(parent)
                p = by_id.get(parent)
                if p is None:
                    return False
                if p.get("name") == "fit":
                    return True
                parent = p.get("parent")
            return False

        fit_s = sum(
            float(s.get("dur") or 0.0)
            for s in self.spans
            if s.get("name") == "fit" and not _has_fit_ancestor(s)
        )
        if fit_s:
            out["fit_seconds"] = round(fit_s, 6)
        for key, gauge_name in (
            ("rows_per_sec", "progress.rows_per_sec"),
            ("coeffs_per_sec", "progress.coeffs_per_sec"),
        ):
            value = gauges.get(gauge_name)
            if value is not None:
                out[key] = float(value)
        for name in (
            "jit_compiles",
            "jit_compile_seconds",
            "device_fetches",
            "device_fetch_seconds",
        ):
            if name in counters:
                out[name] = float(counters[name])
        dropped = counters.get("trace.dropped_spans")
        if dropped:
            out["dropped_spans"] = float(dropped)
        sweep_metric = gauges.get("sweep.selected_metric")
        if sweep_metric is not None:
            out["sweep_selected_metric"] = float(sweep_metric)
        recompiles = counters.get("xla.recompiles")
        if recompiles:
            out["xla_recompiles"] = float(recompiles)
        ingest_rate = gauges.get("ingest.rows_per_sec")
        if ingest_rate is not None:
            out["ingest_rows_per_sec"] = float(ingest_rate)
        ttf = gauges.get("incremental.time_to_fresh_s")
        if ttf is not None:
            out["time_to_fresh_s"] = float(ttf)
        du = self.device_utilization()
        if du is not None and du.get("mfu") is not None:
            out["mfu"] = float(du["mfu"])
        # per-executable MFU from the profiler (exec.<name>.mfu): a compare
        # flags one kernel's utilization regressing; names on one side only
        # are skipped by compare_metrics
        prefix, suffix = "profile.exec.", ".mfu"
        for key, value in gauges.items():
            if key.startswith(prefix) and key.endswith(suffix) and value is not None:
                name = key[len(prefix): -len(suffix)]
                out[f"exec.{name}.mfu"] = float(value)
        return out

    def coordinate_summary(self) -> list[dict]:
        """Per-coordinate convergence + guard history from the NEWEST
        checkpoint manifest (steps, seconds, retries, rollbacks, frozen
        status, last validation metrics)."""
        if not self.manifests:
            return []
        manifest = self.manifests[-1]
        frozen = set(manifest.get("frozen") or ())
        rollback_counts = manifest.get("consecutive_rollbacks") or {}
        agg: dict[str, dict[str, Any]] = {}
        for entry in manifest.get("history") or ():
            name = entry.get("coordinate")
            if name is None:
                continue
            c = agg.setdefault(
                name,
                {
                    "coordinate": name,
                    "steps": 0,
                    "seconds": 0.0,
                    "solve_retries": 0,
                    "rollbacks": 0,
                    "last_metrics": None,
                },
            )
            c["steps"] += 1
            c["seconds"] += float(entry.get("seconds") or 0.0)
            c["solve_retries"] += int(entry.get("solve_retries") or 0)
            c["rollbacks"] += 1 if entry.get("rolled_back") else 0
            if entry.get("metrics") is not None:
                c["last_metrics"] = entry["metrics"]
        for name, c in agg.items():
            c["seconds"] = round(c["seconds"], 6)
            c["frozen"] = name in frozen
            c["consecutive_rollbacks"] = int(rollback_counts.get(name, 0))
        return sorted(agg.values(), key=lambda c: c["coordinate"])

    def sweep_summary(self) -> Optional[dict[str, Any]]:
        """Per-config convergence record of a hyperparameter sweep, from
        the ``sweep_config`` spans the sweep runner emits (one per lane,
        attrs: λs, iterations, convergence reason, final loss, validation
        metric) plus the ``sweep.*`` counters/gauges. None when the run
        swept nothing."""
        configs = []
        for s in self.spans:
            if s.get("name") != "sweep_config":
                continue
            attrs = s.get("attrs") or {}
            configs.append(
                {
                    "index": attrs.get("index"),
                    "lambdas": {
                        k: v
                        for k, v in attrs.items()
                        if k == "lambda" or k.startswith("lambda.")
                    },
                    "iterations": attrs.get("iterations"),
                    "reason": attrs.get("reason"),
                    "final_loss": attrs.get("final_loss"),
                    "metric": attrs.get("metric"),
                    "metric_name": attrs.get("metric_name"),
                }
            )
        gauges = self.snapshot.get("gauges", {})
        counters = self.snapshot.get("counters", {})
        total = gauges.get("sweep.configs_total")
        if not configs and not total:
            return None
        configs.sort(key=lambda c: (c["index"] is None, c["index"]))
        out: dict[str, Any] = {"configs": configs}
        if total is not None:
            out["configs_total"] = int(total)
            out["configs_done"] = int(gauges.get("sweep.configs_done") or 0)
        if gauges.get("sweep.selected_index") is not None:
            out["selected_index"] = int(gauges["sweep.selected_index"])
            out["selected_metric"] = gauges.get("sweep.selected_metric")
        for name in ("sweep.solves", "sweep.nan_configs",
                     "sweep.published_versions"):
            if name in counters:
                out[name.split(".", 1)[1]] = counters[name]
        return out

    def _sweep_markdown(self) -> list[str]:
        sweep = self.sweep_summary()
        if sweep is None:
            return []
        out = ["## Hyperparameter sweep", ""]
        if "configs_total" in sweep:
            out.append(
                f"- {sweep['configs_done']}/{sweep['configs_total']} "
                "config(s) processed"
            )
        if "selected_index" in sweep:
            out.append(
                f"- selected config **#{sweep['selected_index']}** "
                f"(metric {_fmt_or_unknown(sweep.get('selected_metric'))})"
            )
        if sweep.get("nan_configs"):
            out.append(
                f"- **{int(sweep['nan_configs'])} config(s) excluded** "
                "(non-finite validation metric)"
            )
        configs = sweep["configs"]
        if configs:
            lam_keys: list[str] = []
            for c in configs:
                for k in c["lambdas"]:
                    if k not in lam_keys:
                        lam_keys.append(k)
            metric_name = next(
                (c["metric_name"] for c in configs if c.get("metric_name")),
                "metric",
            )
            header = (
                ["config"] + [f"`{k}`" for k in lam_keys]
                + ["iterations", "reason", "final loss", str(metric_name)]
            )
            out += [
                "",
                "| " + " | ".join(header) + " |",
                "|" + "---|" * len(header),
            ]
            for c in configs:
                row = [str(c["index"])]
                row += [
                    _fmt_or_unknown(c["lambdas"].get(k)) for k in lam_keys
                ]
                row += [
                    _fmt_or_unknown(c["iterations"]),
                    str(c["reason"] or "?"),
                    _fmt_or_unknown(c["final_loss"]),
                    _fmt_or_unknown(c["metric"]),
                ]
                out.append("| " + " | ".join(row) + " |")
        out.append("")
        return out

    # -- device utilization (telemetry.executables, telemetry.profile) -------

    def xla_executables(self, k: int = 10) -> list[dict]:
        """Top-k accounted executables, reconstructed from the
        ``xla.exec.<name>.<field>`` metrics so a report loaded from a
        metrics JSONL alone still ranks them. Ranked by total FLOPs when
        known, else by compile seconds."""
        counters = self.snapshot.get("counters", {})
        gauges = self.snapshot.get("gauges", {})
        execs: dict[str, dict[str, Any]] = {}
        for source, fields in (
            (counters, _XLA_EXEC_COUNTER_FIELDS),
            (gauges, _XLA_EXEC_GAUGE_FIELDS),
        ):
            for key, value in source.items():
                if not key.startswith("xla.exec.") or value is None:
                    continue
                rest = key[len("xla.exec."):]
                for field in fields:
                    if rest.endswith("." + field):
                        name = rest[: -len(field) - 1]
                        execs.setdefault(name, {"name": name})[field] = value
                        break
        ranked = sorted(
            execs.values(),
            key=lambda e: (
                e.get("flops_total") or 0.0,
                e.get("compile_seconds") or 0.0,
            ),
            reverse=True,
        )
        return ranked[:k]

    def hot_executables(self, k: int = 10) -> list[dict]:
        """Top-k executables by estimated exclusive device time, from the
        ``profile.exec.<name>.<field>`` gauges (the profiler's sampled
        stream timings, see telemetry.profile), so a report loaded from a
        metrics JSONL alone still ranks them.
        Each row carries MFU / intensity / bound class plus the matching
        ``xla.exec.<name>.*`` compile split and recompile count. Empty
        when the run carried no profiled dispatches."""
        gauges = self.snapshot.get("gauges", {})
        counters = self.snapshot.get("counters", {})
        execs: dict[str, dict[str, Any]] = {}
        for key, value in gauges.items():
            if not key.startswith("profile.exec.") or value is None:
                continue
            rest = key[len("profile.exec."):]
            for field in _PROFILE_EXEC_GAUGE_FIELDS:
                if rest.endswith("." + field):
                    name = rest[: -len(field) - 1]
                    execs.setdefault(name, {"name": name})[field] = value
                    break
        for e in execs.values():
            e["bound_class"] = _BOUND_CLASS_NAMES.get(
                int(e.get("bound_code") or 0), "unknown"
            )
            e["timing_suspect"] = bool(e.get("timing_suspect"))
            for field, source in (
                ("compile_seconds", counters),
                ("recompiles", counters),
            ):
                v = source.get(f"xla.exec.{e['name']}.{field}")
                if v is not None:
                    e[field] = v
        ranked = sorted(
            execs.values(),
            key=lambda e: e.get("est_exclusive_seconds") or 0.0,
            reverse=True,
        )
        return ranked[:k]

    def device_utilization(self) -> Optional[dict[str, Any]]:
        """Roofline accounting for the run: overall + per-phase FLOPs,
        MFU, HBM-bandwidth utilization, comms bytes/fraction, and
        compile-time share. ``None`` when the run carried no executable
        accounting at all; individual fields are None ("unknown") when no
        modelled work ran or the device peaks are unknown. Cached per instance: a report render
        consumes it from key_metrics, markdown, AND to_json, and the
        underlying spans/snapshot never change after construction."""
        cached = self.__dict__.get("_du_cache", _DU_UNSET)
        if cached is not _DU_UNSET:
            return cached
        du = self._device_utilization()
        self.__dict__["_du_cache"] = du
        return du

    def _device_utilization(self) -> Optional[dict[str, Any]]:
        counters = self.snapshot.get("counters", {})
        gauges = self.snapshot.get("gauges", {})
        if not any(
            k.startswith(("xla.", "comms.")) for k in counters
        ):
            return None
        peak_flops = gauges.get("device.peak_flops")
        peak_bw = gauges.get("device.peak_hbm_bytes_per_sec")
        tree = self.phase_tree()
        run_total_s = sum(c.total_s for c in tree.children.values())
        flops_total = counters.get("xla.flops_total")
        bytes_total = counters.get("xla.bytes_total")
        comms_total = counters.get("comms.bytes_total")
        compile_s = counters.get(
            "xla.compile_seconds", counters.get("jit_compile_seconds")
        )

        def _util(work, peak, seconds):
            if work is None or not peak or not seconds:
                return None
            return work / (peak * seconds)

        def _comms_fraction(comms, hbm_bytes):
            # comms recorded but HBM bytes unknown (no cost analysis):
            # the denominator is unknowable — say "unknown", never 100%
            if hbm_bytes is None:
                return None
            total = (comms or 0.0) + hbm_bytes
            return (comms or 0.0) / total if total else None

        phases: list[dict[str, Any]] = []

        def walk(node: PhaseNode, path: list[str]) -> None:
            for child in sorted(
                node.children.values(), key=lambda c: -c.total_s
            ):
                p = path + [child.name]
                f = child.subtree_flops or None
                b = child.subtree_bytes or None
                cb = child.subtree_comms_bytes or None
                if f or b or cb:
                    phases.append(
                        {
                            "phase": " > ".join(p),
                            "total_s": round(child.total_s, 6),
                            "flops": f,
                            "bytes_accessed": b,
                            "comms_bytes": cb,
                            "mfu": _util(f, peak_flops, child.total_s),
                            "bandwidth_utilization": _util(
                                b, peak_bw, child.total_s
                            ),
                            "comms_fraction": _comms_fraction(cb, b),
                        }
                    )
                walk(child, p)

        walk(tree, [])
        return {
            "peak_flops": peak_flops,
            "peak_hbm_bytes_per_sec": peak_bw,
            "flops_total": flops_total,
            "bytes_accessed_total": bytes_total,
            "comms_bytes_total": comms_total,
            "mfu": _util(flops_total, peak_flops, run_total_s),
            "bandwidth_utilization": _util(bytes_total, peak_bw, run_total_s),
            "comms_fraction": _comms_fraction(comms_total, bytes_total),
            "compile_seconds": compile_s,
            "compile_time_share": (
                compile_s / run_total_s
                if compile_s is not None and run_total_s
                else None
            ),
            "recompiles": counters.get("xla.recompiles", 0),
            "phases": phases,
            "top_executables": self.xla_executables(),
        }

    # -- request traces ------------------------------------------------------

    def requests_summary(self) -> Optional[dict[str, Any]]:
        """The request ring's accounting, or None when no request record was
        taken: records, tail-sampled persists, ring drops, and p50/p99
        latency by phase (batcher wait, device dispatch, fan-out, fold, ...)."""
        c = self.snapshot.get("counters", {})
        h = self.snapshot.get("histograms", {})
        if not c.get("request.records"):
            return None
        total = h.get("request.total_ms") or {}
        phases: dict[str, Any] = {}
        prefix = "request.phase."
        for name, summary in sorted(h.items()):
            if name.startswith(prefix) and name.endswith("_ms"):
                phases[name[len(prefix):-3]] = {"count": summary.get("count"),
                                                "p50_ms": summary.get("p50"),
                                                "p99_ms": summary.get("p99")}
        return {
            "records": int(c.get("request.records", 0)),
            "persisted": int(c.get("request.persisted", 0)),
            "dropped": int(c.get("telemetry.trace_dropped", 0)),
            "p50_ms": total.get("p50"),
            "p99_ms": total.get("p99"),
            "phases": phases,
        }

    def slowest_requests(self, k: int = 10) -> list[dict[str, Any]]:
        """The slowest persisted request traces (the ``request:*`` root
        spans of tail sampling), slowest first: ids, status, why it was
        kept, and its phases."""
        out = []
        for s in self.spans:
            name = s.get("name") or ""
            attrs = s.get("attrs") or {}
            if not name.startswith("request:") or "request_id" not in attrs:
                continue  # phase children ride under their root
            out.append({
                "name": name[len("request:"):],
                "trace_id": attrs.get("trace_id"),
                "request_id": attrs.get("request_id"),
                "role": attrs.get("role"),
                "status": attrs.get("status"),
                "sampled_reason": attrs.get("sampled_reason"),
                "dur_ms": attrs.get("dur_ms"),
                "phases": attrs.get("phases") or {},
                "error": attrs.get("error"),
            })
        out.sort(key=lambda r: -(r["dur_ms"] if isinstance(r["dur_ms"], (int, float)) else 0.0))
        return out[:k]

    def _requests_markdown(self, k: int = 5) -> list[str]:
        rs = self.requests_summary()
        if rs is None:
            return []
        out = ["## Requests", ""]
        line = f"- {rs['records']} request record(s)"
        if rs.get("p99_ms") is not None:
            line += f" — p50 {rs['p50_ms']:.1f} ms / p99 {rs['p99_ms']:.1f} ms"
        line += f"; {rs['persisted']} persisted by tail sampling"
        if rs.get("dropped"):
            line += f"; **{rs['dropped']} ring overflow drop(s)**"
        out.append(line)
        if rs["phases"]:
            out += ["", "| phase | count | p50 ms | p99 ms |", "|---|---|---|---|"]
            for pname, p in rs["phases"].items():
                out.append(f"| `{pname}` | {p['count']} | {_fmt_or_unknown(p['p50_ms'])} | "
                           f"{_fmt_or_unknown(p['p99_ms'])} |")
        slow = self.slowest_requests(k=k)
        if slow:
            out += ["", "_Slowest persisted traces (tail sampling: "
                    "slow / degraded / errored / sampled):_", "",
                    "| request | ms | status | why | phases |", "|---|---|---|---|---|"]
            for r in slow:
                phases = "; ".join(f"{n} {ms:.1f}" for n, ms in r["phases"].items()
                                   if isinstance(ms, (int, float)))
                out.append(f"| `{r['name']}` `{r['trace_id']}` | {_fmt_or_unknown(r['dur_ms'])} | "
                           f"{r['status']} | {r['sampled_reason']} | {phases} |")
        out.append("")
        return out

    # -- compare -------------------------------------------------------------

    def compare(
        self,
        baseline: Mapping[str, Any],
        threshold: float = 0.2,
    ) -> list[MetricDelta]:
        """Compare against a baseline: either a full report JSON document
        (``to_json()`` output — its ``key_metrics`` field is used) or a
        bare ``{metric: value}`` dict; metrics on one side only are
        skipped, per-executable ``exec.<name>.mfu`` rows included."""
        base = baseline.get("key_metrics", baseline)
        current = self.key_metrics()
        return compare_metrics(current, base, threshold=threshold,
                               directions=directions_with_exec(current, base))

    # -- rendering -----------------------------------------------------------

    def to_json(self) -> dict[str, Any]:
        counters = self.snapshot.get("counters", {})
        doc: dict[str, Any] = {
            "type": "run_report",
            "format_version": REPORT_FORMAT_VERSION,
            "generated": datetime.datetime.now(
                datetime.timezone.utc
            ).isoformat(),
            "sources": self.sources,
            "key_metrics": self.key_metrics(),
            "phases": self.phase_tree().to_dict()["children"],
            "top_spans": self.top_spans(),
            "coordinates": self.coordinate_summary(),
            "sweep": self.sweep_summary(),
            "device_utilization": self.device_utilization(),
            "hot_executables": self.hot_executables(),
            "ingestion": self.ingestion_summary(),
            "serving": self.serving_summary(),
            "requests": self.requests_summary(),
            "slowest_requests": self.slowest_requests(),
            "recovery": self.recovery_summary(),
            "freshness": self.freshness_summary(),
            "pipeline": self.pipeline_summary(),
            "quality": self.quality_summary(),
            "counters": counters,
            "gauges": self.snapshot.get("gauges", {}),
            "histograms": self.snapshot.get("histograms", {}),
            "heartbeats": {
                "count": len(self.heartbeats),
                "last": self.heartbeats[-1] if self.heartbeats else None,
            },
        }
        if self.manifests:
            doc["checkpoint"] = {
                "steps": [int(m.get("step", -1)) for m in self.manifests],
                "last_step": int(self.manifests[-1].get("step", -1)),
                "best_metric": self.manifests[-1].get("best_metric"),
            }
        return doc

    def save_json(self, path: str) -> dict[str, Any]:
        from photon_ml_tpu_torch.utils.atomic import atomic_write_json

        doc = self.to_json()
        atomic_write_json(path, doc, indent=2, sort_keys=True, default=str)
        return doc

    def to_markdown(
        self, deltas: Optional[Sequence[MetricDelta]] = None
    ) -> str:
        lines: list[str] = ["# Run report", ""]
        src = ", ".join(
            f"{k}=`{v}`" for k, v in self.sources.items() if v
        )
        if src:
            lines += [f"_Sources: {src}_", ""]

        metrics_now = self.key_metrics()
        if metrics_now:
            lines += ["## Key metrics", "", "| metric | value |", "|---|---|"]
            for name, value in sorted(metrics_now.items()):
                lines.append(f"| `{name}` | {_fmt(value)} |")
            lines.append("")

        tree = self.phase_tree()
        if tree.children:
            run_total = sum(c.total_s for c in tree.children.values())
            lines += ["## Phase time breakdown", ""]
            _render_tree(tree, 0, run_total, lines)
            lines.append("")

        top = self.top_spans()
        if top:
            lines += [
                "## Top spans by total time",
                "",
                "| span | count | total s |",
                "|---|---|---|",
            ]
            for t in top:
                lines.append(
                    f"| `{t['name']}` | {t['count']} | {t['total_s']:.3f} |"
                )
            lines.append("")

        lines += self._device_utilization_markdown()
        lines += self._hot_executables_markdown()
        lines += self._accounting_markdown()
        lines += self._ingestion_markdown()
        lines += self._serving_markdown()
        lines += self._requests_markdown()
        lines += self._recovery_markdown()
        lines += self._freshness_markdown()
        lines += self._pipeline_markdown()
        lines += self._quality_markdown()
        lines += self._memory_markdown()
        lines += self._coordinates_markdown()
        lines += self._sweep_markdown()
        lines += self._heartbeat_markdown()

        dropped = self.snapshot.get("counters", {}).get("trace.dropped_spans")
        if dropped:
            lines += [
                f"> **Warning**: {int(dropped)} span(s) were dropped from "
                "the bounded trace buffer — phase totals undercount; raise "
                "`telemetry.configure(buffer_limit=...)`.",
                "",
            ]

        if deltas is not None:
            lines += _compare_markdown(deltas)
        return "\n".join(lines).rstrip() + "\n"

    def _device_utilization_markdown(self) -> list[str]:
        du = self.device_utilization()
        if du is None:
            return []
        out = ["## Device utilization", ""]
        peak = du["peak_flops"]
        out.append(
            "- MFU: "
            + _fmt_pct(du["mfu"])
            + (
                f" (peak {_fmt(peak / 1e12)} TFLOP/s)"
                if peak
                else " (device peak FLOP/s unknown)"
            )
        )
        out.append(
            "- HBM bandwidth utilization: "
            + _fmt_pct(du["bandwidth_utilization"])
            + (
                f" (peak {_fmt_bytes(du['peak_hbm_bytes_per_sec'])}/s)"
                if du["peak_hbm_bytes_per_sec"]
                else " (device peak bandwidth unknown)"
            )
        )
        out.append(
            "- FLOPs and bytes are modelled from the kernels' and dense "
            "contractions' shapes (kernels/cost.py): a lower bound, the "
            "solvers' vector arithmetic is not counted"
        )
        out.append(
            f"- total FLOPs: {_fmt_or_unknown(du['flops_total'])}; "
            f"bytes accessed: "
            + (
                _fmt_bytes(du["bytes_accessed_total"])
                if du["bytes_accessed_total"] is not None
                else "unknown"
            )
        )
        comms = du["comms_bytes_total"]
        out.append(
            "- estimated collective bytes: "
            + (_fmt_bytes(comms) if comms is not None else "unknown")
            + f" (comms fraction {_fmt_pct(du['comms_fraction'])})"
        )
        out.append(
            "- compile time: "
            + (
                f"{_fmt(du['compile_seconds'])}s "
                f"({_fmt_pct(du['compile_time_share'])} of run)"
                if du["compile_seconds"] is not None
                else "unknown"
            )
            + f"; recompiles: {int(du['recompiles'])}"
        )
        if du["phases"]:
            out += [
                "",
                "| phase | s | FLOPs | MFU | bytes | BW util | comms |",
                "|---|---|---|---|---|---|---|",
            ]
            for p in du["phases"]:
                out.append(
                    f"| `{p['phase']}` | {p['total_s']:.3f} | "
                    f"{_fmt_or_unknown(p['flops'])} | "
                    f"{_fmt_pct(p['mfu'])} | "
                    + (
                        _fmt_bytes(p["bytes_accessed"])
                        if p["bytes_accessed"] is not None
                        else "unknown"
                    )
                    + f" | {_fmt_pct(p['bandwidth_utilization'])} | "
                    + (
                        _fmt_bytes(p["comms_bytes"])
                        if p["comms_bytes"] is not None
                        else "—"
                    )
                    + " |"
                )
        top = du["top_executables"]
        if top:
            out += [
                "",
                "Top executables by cost:",
                "",
                "| executable | calls | compiles | compile s | "
                "FLOPs total | bytes total | recompiles |",
                "|---|---|---|---|---|---|---|",
            ]
            for e in top:
                out.append(
                    f"| `{e['name']}` | {_fmt(e.get('calls'))} | "
                    f"{_fmt(e.get('compiles'))} | "
                    f"{_fmt(e.get('compile_seconds'))} | "
                    f"{_fmt_or_unknown(e.get('flops_total'))} | "
                    f"{_fmt_or_unknown(e.get('bytes_total'))} | "
                    f"{_fmt(e.get('recompiles') or 0)} |"
                )
        out.append("")
        return out

    def _hot_executables_markdown(self, k: int = 10) -> list[str]:
        hot = self.hot_executables(k)
        if not hot:
            return []
        out = [
            "## Hot executables",
            "",
            "_Sampled timings per executable (telemetry.profile): "
            "exclusive device seconds are extrapolated from every-Nth "
            "call timed by CUDA events on its stream (the host clock on the "
            "CPU), read once complete._",
            "",
            "| executable | excl s | dispatches | mean ms | MFU | "
            "intensity | bound | compile s | recompiles |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for e in hot:
            mean = e.get("mean_dispatch_seconds")
            name = e["name"] + (" ⚠" if e["timing_suspect"] else "")
            out.append(
                f"| `{name}` | "
                f"{_fmt(e.get('est_exclusive_seconds'))} | "
                f"{_fmt(e.get('dispatches'))} | "
                f"{_fmt(None if mean is None else mean * 1e3)} | "
                f"{_fmt_pct(e.get('mfu'))} | "
                f"{_fmt_or_unknown(e.get('intensity'))} | "
                f"{e['bound_class']} | "
                f"{_fmt(e.get('compile_seconds'))} | "
                f"{_fmt(e.get('recompiles') or 0)} |"
            )
        suspects = [e["name"] for e in hot if e["timing_suspect"]]
        if suspects:
            out += [
                "",
                "> **Warning — timing suspect**: "
                + ", ".join(f"`{n}`" for n in suspects)
                + " measured ABOVE the resolved device peak, which is "
                "physically impossible — the clock is not seeing the "
                "device's work. Treat these rates as fake.",
            ]
        out.append("")
        return out

    def _accounting_markdown(self) -> list[str]:
        c = self.snapshot.get("counters", {})
        h = self.snapshot.get("histograms", {})
        rows = []
        for name in (
            "device_fetches",
            "device_fetch_bytes",
            "device_fetch_seconds",
            "jit_compiles",
            "jit_compile_seconds",
        ):
            if name in c:
                extra = ""
                hist = h.get(name) if name.endswith("seconds") else None
                if hist and hist.get("count"):
                    extra = (
                        f"p50 {_fmt(hist.get('p50'))}, "
                        f"p95 {_fmt(hist.get('p95'))}"
                    )
                rows.append((name, c[name], extra))
        if not rows:
            return []
        out = [
            "## Fetch / compile accounting",
            "",
            "| counter | total | distribution |",
            "|---|---|---|",
        ]
        for name, value, extra in rows:
            out.append(f"| `{name}` | {_fmt(value)} | {extra} |")
        out.append("")
        return out

    def ingestion_summary(self) -> Optional[dict[str, Any]]:
        """Ingest-pipeline accounting, or None when no stream ran.

        The headline is ``solve_waits``/``solve_wait_seconds``: whether
        (and for how long) the SOLVE ever waited on data after warm-up —
        zero means the decode/upload/solve overlap fully hid ingestion;
        a large fraction of the chunks means the fit is ingest-bound and
        needs more decode workers or deeper prefetch.
        """
        c = self.snapshot.get("counters", {})
        g = self.snapshot.get("gauges", {})
        h = self.snapshot.get("histograms", {})
        if "ingest.chunks" not in c and "ingest.rows" not in c:
            return None
        wait = h.get("ingest.solve_wait_s") or {}
        out: dict[str, Any] = {
            "rows": c.get("ingest.rows"),
            "chunks": c.get("ingest.chunks"),
            "rows_per_sec": g.get("ingest.rows_per_sec"),
            "stalls": c.get("ingest.stalls", 0),
            "buffer_growths": c.get("ingest.buffer_growths", 0),
            "read_retries": c.get("ingest.read_retries", 0),
            "solve_waits": c.get("ingest.solve_waits", 0),
            "solve_wait_seconds": (
                round(wait["mean"] * wait["count"], 6)
                if wait.get("count") and wait.get("mean") is not None
                else 0.0
            ),
            "staging_bytes": g.get("ingest.staging_bytes"),
            "queue_depth_last": g.get("ingest.queue_depth"),
        }
        return out

    def _ingestion_markdown(self) -> list[str]:
        ing = self.ingestion_summary()
        if ing is None:
            return []
        out = ["## Ingestion", ""]
        rows = ing.get("rows")
        if rows is not None:
            rate = ing.get("rows_per_sec")
            out.append(
                f"- streamed {int(rows)} rows in "
                f"{int(ing.get('chunks') or 0)} chunks"
                + (f" ({rate:,.0f} rows/s end-to-end)" if rate else "")
            )
        if ing.get("staging_bytes") is not None:
            out.append(
                "- host staging ring: "
                f"{_fmt_bytes(ing['staging_bytes'])} resident"
            )
        waits = int(ing.get("solve_waits") or 0)
        if waits:
            out.append(
                f"- **the solve waited on data {waits} time(s)** "
                f"({ing['solve_wait_seconds']:.3f} s total) — the fit is "
                "(partly) ingest-bound; add decode workers or prefetch "
                "depth"
            )
        else:
            out.append(
                "- the solve never waited on data after warm-up — "
                "decode + upload fully overlapped the compute"
            )
        stalls = int(ing.get("stalls") or 0)
        if stalls:
            out.append(
                f"- **{stalls} pipeline stall(s)** (`ingest.stalls`) — "
                "a stage hit its stall timeout"
            )
        growths = int(ing.get("buffer_growths") or 0)
        if growths:
            out.append(
                f"- {growths} staging-buffer growth(s) — raise "
                "`nnz_per_row_hint` to pre-size the ring exactly"
            )
        retries = int(ing.get("read_retries") or 0)
        if retries:
            out.append(
                f"- {retries} transient read failure(s) absorbed by the "
                "per-chunk retry (`ingest.read_retries`) — the storage "
                "layer flaked but the stream survived"
            )
        out.append("")
        return out

    def serving_summary(self) -> Optional[dict[str, Any]]:
        """Online-serving accounting, or None when no requests were
        served. The headline is request latency (p50/p99 of
        ``serving.total_ms``) plus the SLO disturbance story: how many
        hot swaps happened, how many nearline per-entity applies landed
        and how fast (``serving.nearline.update_lag_ms`` — the
        event-enqueue -> applied-on-tables window), and how much traffic
        admission control shed."""
        c = self.snapshot.get("counters", {})
        h = self.snapshot.get("histograms", {})
        if not c.get("serving.requests"):
            return None
        total = h.get("serving.total_ms") or {}
        batch = h.get("serving.batch_size") or {}
        lag = h.get("serving.nearline.update_lag_ms") or {}
        out: dict[str, Any] = {
            "requests": int(c.get("serving.requests", 0)),
            "scored_rows": int(c.get("serving.scored_rows", 0)),
            "shed": int(c.get("serving.shed", 0)),
            "p50_ms": total.get("p50"),
            "p99_ms": total.get("p99"),
            "mean_batch_rows": batch.get("mean"),
            "model_swaps": int(c.get("serving.model_swaps", 0)),
            "nearline_applies": int(c.get("serving.nearline.applies", 0)),
            "nearline_applied_rows": int(
                c.get("serving.nearline.applied_rows", 0)
            ),
            "nearline_lag_p99_ms": lag.get("p99"),
            "unseen_entities": int(c.get("serving.unseen_entities", 0)),
        }
        return out

    def _serving_markdown(self) -> list[str]:
        srv = self.serving_summary()
        if srv is None:
            return []
        out = ["## Serving", ""]
        line = f"- {srv['requests']} request(s), {srv['scored_rows']} rows"
        if srv.get("p99_ms") is not None:
            line += (
                f" — p50 {srv['p50_ms']:.1f} ms / p99 {srv['p99_ms']:.1f} ms"
            )
        if srv.get("mean_batch_rows"):
            line += f" ({srv['mean_batch_rows']:.1f} rows/device batch)"
        out.append(line)
        shed = srv.get("shed", 0)
        if shed:
            out.append(
                f"- **{shed} request(s) shed** by admission control "
                "(returned 503 — the queue-depth budget, not failures)"
            )
        swaps = srv.get("model_swaps", 0)
        applies = srv.get("nearline_applies", 0)
        if swaps or applies:
            line = f"- {swaps} registry hot-swap(s)"
            if applies:
                line += (
                    f", {applies} nearline apply(ies) covering "
                    f"{srv['nearline_applied_rows']} entity row(s)"
                )
                if srv.get("nearline_lag_p99_ms") is not None:
                    line += (
                        f" — p99 event->applied "
                        f"{srv['nearline_lag_p99_ms']:.1f} ms"
                    )
            line += (
                " — p99 across each disturbance is the SLO bench's "
                "flatness gate (`serving_slo_p99_swap_ratio`)"
            )
            out.append(line)
        unseen = srv.get("unseen_entities", 0)
        if unseen:
            out.append(
                f"- {unseen} unseen-entity row(s) served fixed-effect-only"
            )
        out.append("")
        return out

    def freshness_summary(self) -> Optional[dict[str, Any]]:
        """The incremental-retrain accounting, or None when the run was
        not an incremental fit.

        Answers the continuous-freshness questions: what base did this
        model start from (the ``incremental_fit`` span's lineage attrs),
        how much of the entity space did the delta touch, how many RE
        lanes actually re-solved vs kept their converged coefficients
        bit-identical (lane/bucket skip counters — the structural
        speedup evidence), and how long retrain-to-fresh-model took.
        """
        c = self.snapshot.get("counters", {})
        g = self.snapshot.get("gauges", {})
        fit_spans = [
            s for s in self.spans if s.get("name") == "incremental_fit"
        ]
        keys = (
            "incremental.lanes_solved", "incremental.lanes_skipped",
            "incremental.bucket_solves", "incremental.buckets_skipped",
            "incremental.touched_entities", "incremental.warm_restores",
            "incremental.grown_entities",
            "incremental.published_versions", "incremental.fits",
        )
        if not fit_spans and not any(c.get(k) for k in keys):
            return None
        out: dict[str, Any] = {
            k.split(".", 1)[1]: int(c.get(k, 0)) for k in keys if k in c
        }
        frac = g.get("incremental.touched_fraction")
        if frac is not None:
            out["touched_fraction"] = float(frac)
        per_coord = {
            name[len("incremental.touched_fraction."):]: float(v)
            for name, v in g.items()
            if name.startswith("incremental.touched_fraction.")
        }
        if per_coord:
            out["touched_fraction_by_coordinate"] = per_coord
        ttf = g.get("incremental.time_to_fresh_s")
        if ttf is not None:
            out["time_to_fresh_s"] = float(ttf)
        if fit_spans:
            # the newest incremental_fit span carries the lineage attrs
            attrs = fit_spans[-1].get("attrs") or {}
            base = {
                k: v for k, v in attrs.items()
                if k in ("base", "kind", "base_digest", "base_step",
                         "delta_digest", "delta_rows", "touched_fraction")
            }
            if base:
                out["base"] = base
        solved = out.get("lanes_solved", 0)
        skipped = out.get("lanes_skipped", 0)
        if solved or skipped:
            out["lanes_solved_fraction"] = round(
                solved / max(solved + skipped, 1), 6
            )
        return out

    def _freshness_markdown(self) -> list[str]:
        fresh = self.freshness_summary()
        if fresh is None:
            return []
        out = ["## Freshness", ""]
        base = fresh.get("base") or {}
        if base.get("base"):
            line = f"- warm-started from `{base['base']}`"
            if base.get("kind"):
                line += f" ({base['kind']}"
                if base.get("base_step") is not None:
                    line += f", step {base['base_step']}"
                line += ")"
            out.append(line)
            if base.get("base_digest"):
                out.append(f"  - base digest `{base['base_digest'][:16]}…`")
        if base.get("delta_digest"):
            line = f"- delta digest `{base['delta_digest'][:16]}…`"
            if base.get("delta_rows") is not None:
                line += f", {int(base['delta_rows'])} delta row(s)"
            out.append(line)
        touched = fresh.get("touched_entities")
        if touched is not None:
            line = f"- touched entities: {touched}"
            if fresh.get("touched_fraction") is not None:
                line += f" ({_fmt_pct(fresh['touched_fraction'])})"
            out.append(line)
        grown = fresh.get("grown_entities", 0)
        if grown:
            out.append(f"- {grown} new entity row(s) zero-initialized "
                       "(vocabulary growth)")
        solved = fresh.get("lanes_solved", 0)
        skipped = fresh.get("lanes_skipped", 0)
        if solved or skipped:
            out.append(
                f"- RE lanes re-solved: **{solved}**; kept bit-identical: "
                f"**{skipped}** "
                f"({_fmt_pct(fresh.get('lanes_solved_fraction'))} of lanes "
                "solved)"
            )
        bs = fresh.get("bucket_solves", 0)
        bsk = fresh.get("buckets_skipped", 0)
        if bs or bsk:
            out.append(
                f"- bucket solves dispatched: {bs}; skipped entirely "
                f"(zero touched entities): {bsk}"
            )
        ttf = fresh.get("time_to_fresh_s")
        if ttf is not None:
            out.append(f"- time-to-fresh-model: {ttf:.2f} s")
        published = fresh.get("published_versions", 0)
        if published:
            out.append(
                f"- {published} version(s) published with lineage metadata"
            )
        out.append("")
        return out

    def pipeline_summary(self) -> Optional[dict[str, Any]]:
        """The freshness conductor's accounting, or None when no
        ``cli pipeline`` daemon ran.

        Answers the freshness-tier questions: how many cycles ran (and
        how many were idle — unchanged delta digest), how many versions
        published vs escalated to full retrains, how many cycles had a
        nearline version to reconcile against, and the headline SLO —
        event→served staleness p99 across every delta shard served.
        """
        c = self.snapshot.get("counters", {})
        g = self.snapshot.get("gauges", {})
        cycle_spans = [
            s for s in self.spans if s.get("name") == "pipeline.cycle"
        ]
        keys = (
            "pipeline.cycles", "pipeline.idle_cycles",
            "pipeline.publishes", "pipeline.escalations",
            "pipeline.reconciliations",
        )
        if not cycle_spans and not any(c.get(k) for k in keys):
            return None
        out: dict[str, Any] = {
            k.split(".", 1)[1]: int(c.get(k, 0)) for k in keys if k in c
        }
        p99 = g.get("pipeline.event_to_served_staleness_p99_s")
        if p99 is not None:
            out["event_to_served_staleness_p99_s"] = float(p99)
        if cycle_spans:
            out["cycle_time_s"] = {
                "count": len(cycle_spans),
                "total": round(
                    sum(float(s.get("dur") or 0.0) for s in cycle_spans), 3
                ),
                "max": round(
                    max(float(s.get("dur") or 0.0) for s in cycle_spans), 3
                ),
            }
        return out

    def _pipeline_markdown(self) -> list[str]:
        pipe = self.pipeline_summary()
        if pipe is None:
            return []
        out = ["## Pipeline", ""]
        cycles = pipe.get("cycles", 0)
        idle = pipe.get("idle_cycles", 0)
        if cycles:
            out.append(
                f"- {cycles} conductor cycle(s), {idle} idle "
                "(unchanged delta digest)"
            )
        publishes = pipe.get("publishes", 0)
        escalations = pipe.get("escalations", 0)
        if publishes:
            line = f"- {publishes} version(s) published with lineage"
            if escalations:
                line += (
                    f", {escalations} via full-retrain escalation"
                )
            out.append(line)
        rec = pipe.get("reconciliations", 0)
        if rec:
            out.append(
                f"- {rec} cycle(s) reconciled a nearline-published "
                "version (retrain-wins-touched; superseded version named "
                "in lineage)"
            )
        p99 = pipe.get("event_to_served_staleness_p99_s")
        if p99 is not None:
            out.append(
                f"- **event→served staleness p99: {p99:.3f} s** (delta "
                "shard mtime → registry hot-swap confirmed)"
            )
        ct = pipe.get("cycle_time_s")
        if ct:
            out.append(
                f"- non-idle cycle time: {ct['total']:.3f} s total over "
                f"{ct['count']} cycle(s), max {ct['max']:.3f} s"
            )
        out.append("")
        return out

    def quality_summary(self) -> Optional[dict[str, Any]]:
        """Quality-observability accounting, or None when the run never
        touched the quality layer (no gated publish, no bootstrap, no
        drift sketches).

        Answers the quality questions in one place: how many candidate
        versions had quality stats computed (weighted AUC + bootstrap
        CI), what the champion/challenger gate decided (published /
        quarantined / bypassed / no-champion), how many masked-lane
        bootstrap fits attached coefficient CIs, and the online drift
        rows (per-version score sketches + calibration bins + PSI) the
        serving fleet accumulated — lifted verbatim from the ``quality``
        snapshot section the drift monitor publishes.
        """
        c = self.snapshot.get("counters", {})
        drift = self.snapshot.get("quality") or {}
        keys = (
            "quality.stats_computed", "quality.bootstrap_fits",
            "quality.gate_published", "quality.gate_quarantined",
            "quality.gate_bypassed", "quality.gate_no_champion",
            "quality.scores_observed", "quality.labeled_observed",
            "quality.versions_evicted", "pipeline.quarantines",
        )
        if not drift.get("versions") and not any(c.get(k) for k in keys):
            return None
        out: dict[str, Any] = {
            k.replace("quality.", "").replace(".", "_"): int(c.get(k, 0))
            for k in keys
            if k in c
        }
        if drift.get("versions"):
            out["drift"] = drift
        return out

    def _quality_markdown(self) -> list[str]:
        q = self.quality_summary()
        if q is None:
            return []
        out = ["## Quality", ""]
        stats = q.get("stats_computed", 0)
        if stats:
            out.append(
                f"- candidate quality stats computed: {stats} "
                "(weighted validation AUC + bootstrap CI"
                " + Hosmer–Lemeshow where logistic)"
            )
        fits = q.get("bootstrap_fits", 0)
        if fits:
            out.append(
                f"- {fits} masked-lane bootstrap fit(s) attached "
                "per-entity coefficient CIs to published metadata"
            )
        gate_bits = []
        for key, label in (
            ("gate_published", "published"),
            ("gate_quarantined", "**quarantined**"),
            ("gate_bypassed", "gate-bypassed"),
            ("gate_no_champion", "published without a champion"),
        ):
            v = q.get(key, 0)
            if v:
                gate_bits.append(f"{v} {label}")
        if gate_bits:
            out.append(
                "- champion/challenger gate decisions: "
                + ", ".join(gate_bits)
            )
        quarantines = q.get("pipeline_quarantines", 0)
        if quarantines:
            out.append(
                f"- **{quarantines} regressed challenger(s) quarantined "
                "by the conductor** (digest advanced; no retry loop)"
            )
        drift = q.get("drift") or {}
        versions = drift.get("versions") or {}
        if versions:
            base = drift.get("baseline_version")
            line = f"- online drift sketches for {len(versions)} version(s)"
            if base:
                line += f" (PSI baseline `{base}`)"
            out.append(line)
            out.append("")
            out.append(
                "| version | scores | mean | std | PSI vs baseline "
                "| labeled | max calib gap |"
            )
            out.append("|---|---|---|---|---|---|---|")
            for v, row in versions.items():
                s = row.get("scores") or {}
                cal = row.get("calibration") or {}
                out.append(
                    "| `{}` | {} | {} | {} | {} | {} | {} |".format(
                        v,
                        s.get("count", 0),
                        _fmt(s.get("mean")),
                        _fmt(s.get("std")),
                        _fmt(row.get("psi_vs_baseline")),
                        cal.get("count", 0),
                        _fmt(cal.get("max_gap")),
                    )
                )
        out.append("")
        return out

    def recovery_summary(self) -> Optional[dict[str, Any]]:
        """Fault-tolerance accounting, or None when the run exercised no
        recovery machinery at all (no checkpoints, no retries, no
        injections — the common healthy case).

        The section exists so "the run recovered" is an auditable
        statement: how many checkpoints were written (and with how many
        per-shard saves — ``max_shard_fetch_bytes`` proves a sharded save
        never assembled the table on the host), whether restore fell back
        past corrupt directories, whether a resume was ELASTIC (restored
        onto a different device topology than the one that saved), and
        how many transient-IO retries the ingest/serving paths absorbed.
        ``faults.injected`` is nonzero only under deliberate fault
        injection (tools/chaos.py or an armed ``PHOTON_FAULT_PLAN``) —
        loud in a report because an armed production run is an incident.
        """
        c = self.snapshot.get("counters", {})
        g = self.snapshot.get("gauges", {})
        keys = (
            "checkpoint.saves", "checkpoint.restores", "checkpoint.corrupt",
            "checkpoint.shard_saves", "recovery.elastic_resumes",
            "faults.injected", "serving.version_retries",
            "ingest.read_retries", "streaming.feed_retries",
            "solves.rolled_back", "solves.frozen",
            # fleet recovery (multi-process fits under tools/fleet.py)
            "recovery.fleet_member_deaths", "recovery.fleet_relaunches",
            "checkpoint.quorum_timeouts", "checkpoint.peer_manifests",
            "checkpoint.quorum_cover_violations",
            "multihost.init_retries",
        )
        if not any(c.get(k) for k in keys):
            return None
        out: dict[str, Any] = {k.replace(".", "_"): int(c.get(k, 0))
                               for k in keys}
        max_fetch = g.get("checkpoint.max_shard_fetch_bytes")
        if max_fetch is not None:
            out["max_shard_fetch_bytes"] = int(max_fetch)
        injected_by_point = {
            name[len("faults.injected."):]: int(value)
            for name, value in c.items()
            if name.startswith("faults.injected.")
        }
        if injected_by_point:
            out["faults_injected_by_point"] = injected_by_point
        return out

    def _recovery_markdown(self) -> list[str]:
        rec = self.recovery_summary()
        if rec is None:
            return []
        out = ["## Recovery", ""]
        saves = rec.get("checkpoint_saves", 0)
        if saves:
            line = f"- {saves} checkpoint save(s)"
            shard_saves = rec.get("checkpoint_shard_saves", 0)
            if shard_saves:
                line += f", {shard_saves} per-shard payload write(s)"
                max_fetch = rec.get("max_shard_fetch_bytes")
                if max_fetch is not None:
                    line += (
                        f" (largest single host fetch "
                        f"{_fmt_bytes(max_fetch)} — never the full table)"
                    )
            out.append(line)
        restores = rec.get("checkpoint_restores", 0)
        if restores:
            elastic = rec.get("recovery_elastic_resumes", 0)
            out.append(
                f"- {restores} restore(s)"
                + (
                    f", **{elastic} elastic** (resumed onto a different "
                    "device topology than the one that saved)"
                    if elastic else ""
                )
            )
        corrupt = rec.get("checkpoint_corrupt", 0)
        if corrupt:
            out.append(
                f"- **{corrupt} corrupt/partial checkpoint(s) skipped** "
                "during restore (newest-valid fallback)"
            )
        retries = [
            ("serving_version_retries", "serving model-version loads"),
            ("ingest_read_retries", "ingest chunk reads"),
            ("streaming_feed_retries", "streaming host→device feeds"),
        ]
        for key, what in retries:
            n = rec.get(key, 0)
            if n:
                out.append(
                    f"- {n} transient-IO retry(ies) absorbed on {what}"
                )
        deaths = rec.get("recovery_fleet_member_deaths", 0)
        relaunches = rec.get("recovery_fleet_relaunches", 0)
        if deaths or relaunches:
            out.append(
                f"- **fleet: {deaths} member death(s), {relaunches} "
                "survivor relaunch(es)** (supervised multi-process fit — "
                "the fit continued on the surviving host set)"
            )
        quorum_timeouts = rec.get("checkpoint_quorum_timeouts", 0)
        peer_manifests = rec.get("checkpoint_peer_manifests", 0)
        if quorum_timeouts or peer_manifests:
            out.append(
                f"- coordinated checkpoints: {peer_manifests} per-process "
                f"manifest(s) written, {quorum_timeouts} quorum "
                "timeout(s) (saves abandoned uncertified — a dead peer "
                "never hangs the fleet or certifies a partial checkpoint)"
            )
        cover = rec.get("checkpoint_quorum_cover_violations", 0)
        if cover:
            out.append(
                f"- **{cover} coordinated save(s) abandoned on a "
                "shard-cover violation** (merged peer shards had a "
                "gap/overlap or a missing payload file — never certified)"
            )
        init_retries = rec.get("multihost_init_retries", 0)
        if init_retries:
            out.append(
                f"- {init_retries} distributed-init retry(ies) absorbed "
                "(flaky rendezvous, exponential backoff)"
            )
        rolled = rec.get("solves_rolled_back", 0)
        frozen = rec.get("solves_frozen", 0)
        if rolled or frozen:
            out.append(
                f"- guard: {rolled} solve rollback(s), {frozen} "
                "coordinate freeze(s)"
            )
        injected = rec.get("faults_injected", 0)
        if injected:
            by_point = rec.get("faults_injected_by_point") or {}
            detail = ", ".join(
                f"`{p}`×{n}" for p, n in sorted(by_point.items())
            )
            out.append(
                f"- **{injected} fault(s) deliberately injected** "
                f"({detail}) — this run had an armed fault plan"
            )
        out.append("")
        return out

    def _memory_markdown(self) -> list[str]:
        g = self.snapshot.get("gauges", {})
        phase_peaks = {
            name[len("memory.phase."):-len(".peak_bytes")]: value
            for name, value in g.items()
            if name.startswith("memory.phase.")
            and name.endswith(".peak_bytes")
            # memory.phase.<phase>.device.<id>.peak_bytes rows are the
            # per-device watermarks, rendered separately below
            and ".device." not in name[len("memory.phase."):]
            and value is not None
        }
        headroom = self.snapshot.get("counters", {}).get(
            "memory.headroom_warnings"
        )
        has_device_gauges = any(
            name.startswith("memory.device.") and name.endswith(".bytes_in_use")
            for name in g
        )
        if (
            not phase_peaks
            and not headroom
            and not has_device_gauges
            and "memory.bytes_in_use" not in g
        ):
            return []
        out = ["## HBM / memory", ""]
        if "memory.bytes_in_use" in g:
            out.append(
                f"- in use: {_fmt_bytes(g['memory.bytes_in_use'])}"
                + (
                    f" of {_fmt_bytes(g['memory.bytes_limit'])}"
                    if g.get("memory.bytes_limit") is not None
                    else ""
                )
            )
        per_device = {
            name[len("memory.device."):-len(".bytes_in_use")]: value
            for name, value in g.items()
            if name.startswith("memory.device.")
            and name.endswith(".bytes_in_use")
            and value is not None
        }
        if len(per_device) >= 2:
            # shard-imbalance signal: a balanced entity sharding keeps the
            # per-device spread near zero; a lopsided one concentrates
            # table bytes on few devices (heartbeats carry the same number
            # live as hbm_device_spread_bytes)
            lo, hi = min(per_device.values()), max(per_device.values())
            out.append(
                f"- per-device in use across {len(per_device)} devices: "
                f"min {_fmt_bytes(lo)}, max {_fmt_bytes(hi)}, spread "
                f"{_fmt_bytes(hi - lo)}"
            )
        elif g.get("memory.device_spread_bytes") is not None:
            out.append(
                "- per-device in-use spread (max-min): "
                f"{_fmt_bytes(g['memory.device_spread_bytes'])}"
            )
        watermarks = {
            name[len("memory.device."):-len(".peak_bytes")]: value
            for name, value in g.items()
            if name.startswith("memory.device.")
            and name.endswith(".peak_bytes")
            and value is not None
        }
        if watermarks:
            # high-watermarks sampled by memory.record_device_watermarks:
            # they catch a transient spike the end-of-phase probes miss
            lo, hi = min(watermarks.values()), max(watermarks.values())
            line = (
                f"- HBM high-watermark across {len(watermarks)} "
                f"device(s): peak {_fmt_bytes(hi)}"
            )
            if len(watermarks) >= 2:
                line += (
                    f" (min {_fmt_bytes(lo)}, watermark spread "
                    f"{_fmt_bytes(hi - lo)})"
                )
            out.append(line)
        if headroom:
            out.append(
                f"- **{int(headroom)} headroom warning(s)** — predicted "
                "allocations exceeded free HBM (`memory.headroom_warnings`)"
            )
        if phase_peaks:
            out += ["", "| phase | peak bytes |", "|---|---|"]
            for phase, value in sorted(
                phase_peaks.items(), key=lambda kv: -(kv[1] or 0)
            ):
                out.append(f"| `{phase}` | {_fmt_bytes(value)} |")
        out.append("")
        return out

    def _coordinates_markdown(self) -> list[str]:
        coords = self.coordinate_summary()
        if not coords:
            return []
        out = [
            "## Coordinates (from newest checkpoint)",
            "",
            "| coordinate | steps | seconds | retries | rollbacks "
            "| frozen | last metrics |",
            "|---|---|---|---|---|---|---|",
        ]
        for c in coords:
            metrics_str = (
                json.dumps(c["last_metrics"], default=str)
                if c["last_metrics"]
                else ""
            )
            out.append(
                f"| `{c['coordinate']}` | {c['steps']} | "
                f"{c['seconds']:.3f} | {c['solve_retries']} | "
                f"{c['rollbacks']} | {'yes' if c['frozen'] else ''} | "
                f"{metrics_str} |"
            )
        out.append("")
        return out

    def _heartbeat_markdown(self) -> list[str]:
        if not self.heartbeats:
            return []
        last = self.heartbeats[-1]
        line = (
            f"- {len(self.heartbeats)} beat(s); last at uptime "
            f"{last.get('uptime_s', '?')}s in span "
            f"`{last.get('span') or '(idle)'}` — "
            f"{_fmt(last.get('rows_per_s'))} rows/s, "
            f"{_fmt(last.get('coeffs_per_s'))} coeffs/s"
        )
        if last.get("hot_exec"):
            line += f"; hot executable `{last['hot_exec']}`"
        return ["## Heartbeats", "", line, ""]


def _render_tree(
    node: PhaseNode, depth: int, run_total: float, lines: list[str]
) -> None:
    for child in sorted(node.children.values(), key=lambda c: -c.total_s):
        pct = 100.0 * child.total_s / run_total if run_total else 0.0
        lines.append(
            f"{'  ' * depth}- `{child.name}` — n={child.count}, "
            f"total {child.total_s:.3f}s, self {child.self_s:.3f}s "
            f"({pct:.1f}%)"
        )
        _render_tree(child, depth + 1, run_total, lines)


def _compare_markdown(deltas: Sequence[MetricDelta]) -> list[str]:
    out = [
        "## Comparison vs baseline",
        "",
        "| metric | current | baseline | change | status |",
        "|---|---|---|---|---|",
    ]
    for d in deltas:
        status = "**REGRESSED**" if d.regressed else "ok"
        out.append(
            f"| `{d.metric}` | {_fmt(d.current)} | {_fmt(d.baseline)} | "
            f"{d.change:+.1%} | {status} |"
        )
    regressed = [d.metric for d in deltas if d.regressed]
    out.append("")
    if regressed:
        out.append(
            f"**{len(regressed)} regression(s)**: "
            + ", ".join(f"`{m}`" for m in regressed)
        )
    else:
        out.append("No regressions beyond threshold.")
    out.append("")
    return out


def _fmt(value: Any) -> str:
    if value is None:
        return ""
    try:
        f = float(value)
    except (TypeError, ValueError):
        return str(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.4g}"


def _fmt_pct(value: Any) -> str:
    """Percentage or the explicit string "unknown" (backends without cost
    analysis / unknown device peaks must say so, never show 0)."""
    if value is None:
        return "unknown"
    try:
        return f"{float(value):.1%}"
    except (TypeError, ValueError):
        return "unknown"


def _fmt_or_unknown(value: Any) -> str:
    return "unknown" if value is None else _fmt(value)


def _fmt_bytes(value: Any) -> str:
    try:
        b = float(value)
    except (TypeError, ValueError):
        return str(value)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024 or unit == "TiB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{int(b)} B"
        b /= 1024
    return f"{b:.1f} TiB"
