"""Fleet reports: a fleet's per-member telemetry merged into one answer.

Counterpart of ``photon_ml_tpu/telemetry/fleet_report.py``, with its
discovery rules, record formats, rows and markdown, on the port's
:class:`~photon_ml_tpu_torch.telemetry.report.RunReport`. A multi-process
run writes one artifact stream per member (``trace.proc-0.jsonl``,
``telemetry.proc-1.jsonl``, ...: the ``telemetry.identity`` suffix), and
:class:`FleetReport` merges them:

- **discovery**: a fleet directory's ``*.proc-<i>.jsonl`` streams, each
  classified by its first record (``trace_header``/``span`` or
  ``metrics``/``heartbeat``), one ``RunReport`` per member; the
  ``tools/fleet.py`` workdir layout (``telemetry/``, then the newest
  ``gen<g>``) is searched when the directory itself holds none; the
  serving router's ``*.router.jsonl`` and the flight records
  ``flight-proc-<i>.json`` (never their ``.tmp`` shadows);
- **alignment**: each trace header's anchor pair (``anchor_unix_s``,
  ``monotonic_anchor``) maps a member's span times onto one absolute
  timeline; the residual clock skew is the median difference of the
  coordinated checkpoint saves' ends (``checkpoint:save`` with
  ``coordinated=True``: every member leaves the same barrier);
- **attribution**: per-member rows (rows/s, collective wait and its share,
  chunks, heartbeat gaps, skew) and the straggler: at a barrier the member
  that arrives last waits about nothing, so the member with the least
  ``comms.wait_seconds_total`` is the one the fleet waited on;
- **degradation**: a member whose final metrics snapshot never landed (a
  SIGKILL, an ``os._exit``) is marked ``lost`` and renders with what
  survived, its flight record as its last words; a member with no artifact
  at all, known from a peer's header, gets a synthesized lost row;
- **requests**: the persisted ``request:*`` spans of the router and every
  member, plus the flight records' entries, joined by ``trace_id``.

- **device accounting**: each member row's ``mfu`` and ``comms_fraction``
  (its report's Device utilization; None, "unknown", without modelled work
  or known peaks) and ``hot_exec`` (its hottest profiled executable), the
  key metric ``fleet_mfu_spread`` (max - min member MFU, with two or more),
  and the fleet's hot list: per-name sums of the members' profiled
  exclusive seconds.

``python -m photon_ml_tpu_torch.cli report --fleet <dir>`` renders it;
``compare``/``--fail-on-regress`` gate :meth:`FleetReport.key_metrics`
through ``compare_metrics``. This module only reads artifacts.
"""

from __future__ import annotations

import dataclasses
import datetime
import glob as _glob
import json
import os
import re
import statistics
from typing import Any, Mapping, Optional, Sequence

from photon_ml_tpu_torch.telemetry.report import (
    KEY_METRIC_DIRECTIONS,
    MetricDelta,
    RunReport,
    _compare_markdown,
    _fmt,
    _fmt_or_unknown,
    _fmt_pct,
    compare_metrics,
)

__all__ = [
    "FleetMember",
    "FleetReport",
    "FLEET_KEY_METRIC_DIRECTIONS",
    "FLEET_REPORT_FORMAT_VERSION",
    "discover_member_streams",
    "discover_flight_records",
    "discover_router_trace",
]

FLEET_REPORT_FORMAT_VERSION = 1

_PROC_RE = re.compile(r"\.proc-(\d+)\.jsonl$")
_GEN_RE = re.compile(r"^gen(\d+)$")
#: anchored at the exact ``.json`` suffix: the ``.tmp`` a kill in the middle
#: of a dump leaves behind is never adopted
_FLIGHT_RE = re.compile(r"^flight-proc-(\d+)\.json$")

#: the fleet's key metrics and their direction (the reference's table, so a
#: baseline of either package compares); the single-run ones are inherited
FLEET_KEY_METRIC_DIRECTIONS: dict[str, int] = {
    **KEY_METRIC_DIRECTIONS,
    "fleet_rows_per_sec": +1,
    "fleet_coeffs_per_sec": +1,
    "fleet_collective_wait_fraction": -1,
    "fleet_collective_wait_s": -1,
    "fleet_mfu_spread": -1,
    "fleet_lost_members": -1,
    "fleet_heartbeat_gap_max_s": -1,
    "fleet_clock_skew_max_s": -1,
}

#: below this spread of the members' waits no straggler is named (it would
#: be scheduling noise)
_STRAGGLER_MIN_SPREAD_S = 0.005


def discover_member_streams(fleet_dir: str) -> dict[int, dict]:
    """``process_index -> {"trace": path, "telemetry": path, "header":
    dict}`` for the member streams under ``fleet_dir``: any
    ``*.proc-<i>.jsonl`` is member ``i``'s, classified by its first
    parseable record (``header`` is the trace's ``trace_header``, when it
    leads). The first candidate directory holding any stream wins:
    ``fleet_dir``, its ``telemetry/``, then the newest ``gen<g>`` under
    either (a relaunched generation renumbers its members, so one directory
    is one generation)."""
    out: dict[int, dict] = {}
    for directory in _candidate_dirs(fleet_dir):
        for path in sorted(_glob.glob(os.path.join(directory, "*.jsonl"))):
            m = _PROC_RE.search(os.path.basename(path))
            if not m:
                continue
            proc = int(m.group(1))
            kind, first = _classify_stream(path)
            if kind is None:
                continue
            entry = out.setdefault(proc, {})
            entry.setdefault(kind, path)
            if kind == "trace" and entry["trace"] == path and first.get("type") == "trace_header":
                entry["header"] = first
        if out:
            break
    return out


def _candidate_dirs(fleet_dir: str) -> list[str]:
    """Where one fleet run's artifacts may lie: the directory, its
    ``telemetry/``, and the newest ``gen<g>`` under either."""
    candidates = [fleet_dir, os.path.join(fleet_dir, "telemetry")]
    for base in list(candidates):
        gens = sorted((d for d in _glob.glob(os.path.join(base, "gen*"))
                       if os.path.isdir(d) and _GEN_RE.match(os.path.basename(d))),
                      key=lambda d: int(os.path.basename(d)[3:]))
        if gens:
            candidates.append(gens[-1])
    return candidates


def discover_flight_records(fleet_dir: str) -> dict[int, str]:
    """``process_index -> flight-proc-<i>.json`` in the first candidate
    directory holding any; only the exact ``.json`` name matches."""
    for directory in _candidate_dirs(fleet_dir):
        out: dict[int, str] = {}
        for path in sorted(_glob.glob(os.path.join(directory, "flight-proc-*.json"))):
            m = _FLIGHT_RE.match(os.path.basename(path))
            if m:
                out[int(m.group(1))] = path
        if out:
            return out
    return {}


def discover_router_trace(fleet_dir: str) -> Optional[str]:
    """The serving router's own span stream (``trace.router.jsonl``): its
    ``request:route`` spans are one half of every fan-out trace."""
    for directory in _candidate_dirs(fleet_dir):
        for path in sorted(_glob.glob(os.path.join(directory, "*.router.jsonl"))):
            kind, _first = _classify_stream(path)
            if kind == "trace":
                return path
    return None


def _classify_stream(path: str) -> tuple[Optional[str], dict]:
    """``("trace" | "telemetry" | None, first record)`` from a stream's
    first parseable record."""
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(rec, dict):
                    continue
                kind = rec.get("type")
                if kind in ("trace_header", "span"):
                    return "trace", rec
                if kind in ("metrics", "heartbeat"):
                    return "telemetry", rec
    except OSError:
        return None, {}
    return None, {}


@dataclasses.dataclass
class FleetMember:
    """One member's artifacts and its derived row."""

    process_index: int
    trace_path: Optional[str] = None
    telemetry_path: Optional[str] = None
    report: RunReport = dataclasses.field(default_factory=RunReport)
    header: dict = dataclasses.field(default_factory=dict)
    lost: bool = False
    #: the estimated clock skew against the reference member, in seconds
    clock_skew_s: float = 0.0
    #: the adopted flight record (a drain dump or a supervisor's harvest)
    flight: Optional[dict] = None
    flight_path: Optional[str] = None
    # memos: the report never changes after load, and its derived views
    # walk every span
    _km: Optional[dict] = dataclasses.field(default=None, repr=False, compare=False)
    _run_s: Optional[float] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def hostname(self) -> Optional[str]:
        return self.header.get("hostname")

    def key_metrics(self) -> dict[str, float]:
        if self._km is None:
            self._km = self.report.key_metrics()
        return self._km

    def _abs_time(self, ts: float) -> Optional[float]:
        """Member-local tracer seconds as skew-corrected epoch seconds, or
        None without an anchor pair in the header."""
        anchor_unix = self.header.get("anchor_unix_s")
        anchor_mono = self.header.get("monotonic_anchor")
        if anchor_unix is None or anchor_mono is None:
            return None
        return anchor_unix + (ts - anchor_mono) - self.clock_skew_s

    def run_seconds(self) -> float:
        """The member's traced wall time (the top-level phases' sum)."""
        if self._run_s is None:
            tree = self.report.phase_tree()
            self._run_s = sum(c.total_s for c in tree.children.values())
        return self._run_s

    def collective_wait_seconds(self) -> Optional[float]:
        value = self.report.snapshot.get("counters", {}).get("comms.wait_seconds_total")
        return None if value is None else float(value)

    def heartbeat_gap_max_s(self) -> Optional[float]:
        """The largest gap between consecutive heartbeats (uptime deltas):
        a long one means the member went quiet."""
        ups = [hb.get("uptime_s") for hb in self.report.heartbeats
               if isinstance(hb.get("uptime_s"), (int, float))]
        if len(ups) < 2:
            return None
        return max(b - a for a, b in zip(ups, ups[1:]))

    def row(self) -> dict[str, Any]:
        """The member's report row (JSON-safe)."""
        km = self.key_metrics()
        counters = self.report.snapshot.get("counters", {})
        du = self.report.device_utilization()
        wait = self.collective_wait_seconds()
        run_s = self.run_seconds()
        last_hb = self.report.heartbeats[-1] if self.report.heartbeats else None
        chunks = counters.get("streaming_chunks")
        hot = self.report.hot_executables(k=1)
        return {
            "process_index": self.process_index,
            "hostname": self.hostname,
            "status": "lost" if self.lost else "ok",
            "rows_per_sec": km.get("rows_per_sec"),
            "coeffs_per_sec": km.get("coeffs_per_sec"),
            "mfu": km.get("mfu"),
            "comms_fraction": du.get("comms_fraction") if du is not None else None,
            "collective_wait_s": wait,
            "collective_wait_calls": counters.get("comms.wait_calls"),
            "collective_wait_share": wait / run_s if wait is not None and run_s else None,
            "chunks_done": None if chunks is None else int(chunks),
            "hot_exec": hot[0]["name"] if hot else None,
            "run_seconds": round(run_s, 6) if run_s else None,
            "heartbeats": len(self.report.heartbeats),
            "heartbeat_gap_max_s": self.heartbeat_gap_max_s(),
            "last_heartbeat": last_hb,
            "clock_skew_s": round(self.clock_skew_s, 6),
            "flight_records": (len(self.flight.get("records") or [])
                               if self.flight is not None else None),
            "artifacts": {"trace": self.trace_path, "telemetry": self.telemetry_path,
                          "flight": self.flight_path},
        }


def _rendezvous_endpoints(member: FleetMember) -> dict[int, float]:
    """``next_chunk -> absolute end`` of the member's coordinated
    checkpoint saves: the shared barrier the skew is estimated from."""
    out: dict[int, float] = {}
    for s in member.report.spans:
        if s.get("name") != "checkpoint:save":
            continue
        attrs = s.get("attrs") or {}
        if not attrs.get("coordinated"):
            continue
        chunk = attrs.get("next_chunk")
        if not isinstance(chunk, int):
            continue
        ts, dur = s.get("ts"), s.get("dur")
        if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
            continue
        end = member._abs_time(ts + dur)
        if end is not None:
            out[chunk] = end
    return out


@dataclasses.dataclass
class FleetReport:
    """One fleet run's merged per-member telemetry."""

    fleet_dir: str
    members: list[FleetMember] = dataclasses.field(default_factory=list)
    num_processes: int = 0
    #: the router's span stream and pseudo-member (process_index -1), joined
    #: into the request traces but left out of the member accounting
    router_trace_path: Optional[str] = None
    router: Optional[FleetMember] = dataclasses.field(default=None, repr=False, compare=False)

    # -- construction --------------------------------------------------------

    @classmethod
    def load(cls, fleet_dir: str) -> "FleetReport":
        """Build from a directory of member streams. Missing, truncated or
        half-written artifacts never raise: a member renders with what
        survived, marked ``lost`` when its final metrics snapshot is
        absent; an expected member with no artifact at all (the fleet's
        size from a peer's header or a flight record) gets a lost row."""
        from photon_ml_tpu_torch.telemetry import requests as _requests

        streams = discover_member_streams(fleet_dir)
        members: list[FleetMember] = []
        for proc in sorted(streams):
            paths = streams[proc]
            report = RunReport.load(trace=paths.get("trace"), telemetry=paths.get("telemetry"))
            member = FleetMember(process_index=proc, trace_path=paths.get("trace"),
                                 telemetry_path=paths.get("telemetry"), report=report,
                                 header=paths.get("header") or {})
            # no final snapshot: the member died before its exit flush
            member.lost = not report.snapshot
            members.append(member)
        flights = discover_flight_records(fleet_dir)
        expected = 0
        for member in members:
            nproc = member.header.get("num_processes")
            if isinstance(nproc, int):
                expected = max(expected, nproc)
        if members:
            expected = max(expected, members[-1].process_index + 1)
        if flights:
            expected = max(expected, max(flights) + 1)
        present = {m.process_index for m in members}
        members += [FleetMember(process_index=p, lost=True)
                    for p in range(expected) if p not in present]
        members.sort(key=lambda m: m.process_index)
        for member in members:
            path = flights.get(member.process_index)
            if path is not None:
                member.flight_path = path
                member.flight = _requests.read_flight(path)  # a torn one reads None
        router_path = discover_router_trace(fleet_dir)
        router = None
        if router_path is not None:
            _kind, first = _classify_stream(router_path)
            router = FleetMember(process_index=-1, trace_path=router_path,
                                 report=RunReport.load(trace=router_path),
                                 header=first if first.get("type") == "trace_header" else {})
        report = cls(fleet_dir=fleet_dir, members=members,
                     num_processes=max(expected, len(members)),
                     router_trace_path=router_path, router=router)
        report._estimate_skew()
        return report

    def _estimate_skew(self) -> None:
        """Each member's residual clock skew against the first member with
        coordinated saves, the median over the saves both ended. Its
        resolution is one quorum poll; a fleet that never saved together
        keeps skew 0 (the anchor pair alone aligns it)."""
        endpoints = {m.process_index: _rendezvous_endpoints(m) for m in self.members}
        reference = next((p for p in sorted(endpoints) if endpoints[p]), None)
        if reference is None:
            return
        ref = endpoints[reference]
        for member in self.members:
            if member.process_index == reference:
                continue
            mine = endpoints[member.process_index]
            shared = sorted(set(mine) & set(ref))
            if shared:
                member.clock_skew_s = statistics.median([mine[k] - ref[k] for k in shared])

    # -- derived views -------------------------------------------------------

    def merged_spans(self) -> list[dict]:
        """Every member's spans on one absolute timeline: each record gains
        ``process_index`` and ``abs_ts`` (skew-corrected epoch seconds;
        absent without an anchor), sorted by absolute start."""
        merged: list[dict] = []
        for member in self.members:
            for s in member.report.spans:
                rec = dict(s)
                rec["process_index"] = member.process_index
                ts = s.get("ts")
                if isinstance(ts, (int, float)):
                    abs_ts = member._abs_time(ts)
                    if abs_ts is not None:
                        rec["abs_ts"] = round(abs_ts, 6)
                merged.append(rec)
        merged.sort(key=lambda r: (r.get("abs_ts") is None, r.get("abs_ts") or 0.0,
                                   r.get("process_index")))
        return merged

    def request_traces(self) -> list[dict[str, Any]]:
        """One view per request: every persisted ``request:*`` root span of
        the router's and each member's stream, plus the flight records'
        entries, grouped by ``trace_id``, so a request that fanned out reads
        as one trace whose hops span processes. Slowest first (by its
        slowest hop)."""
        traces: dict[str, dict[str, Any]] = {}
        seen: set[tuple] = set()

        def _hop(trace_id: str, entry: dict[str, Any]) -> None:
            key = (trace_id, entry.get("source"), entry.get("name"), entry.get("request_id"),
                   entry.get("dur_ms"))
            if key in seen:
                # a harvested flight re-reads the stream its member already
                # persisted to: one hop, not two
                return
            seen.add(key)
            traces.setdefault(trace_id, {"trace_id": trace_id, "hops": []})["hops"].append(entry)

        def _span_hop(member: FleetMember, label: str, s: dict) -> None:
            name = s.get("name") or ""
            if not name.startswith("request:"):
                return
            attrs = s.get("attrs") or {}
            tid = attrs.get("trace_id")
            if not tid or "request_id" not in attrs:
                return  # phase children join through their root
            entry: dict[str, Any] = {
                "source": label,
                "process_index": member.process_index,
                "name": name[len("request:"):],
                "request_id": attrs.get("request_id"),
                "role": attrs.get("role"),
                "status": attrs.get("status"),
                "sampled_reason": attrs.get("sampled_reason"),
                "dur_ms": attrs.get("dur_ms"),
                "phases": attrs.get("phases") or {},
                "attrs": attrs,
            }
            ts = s.get("ts")
            if isinstance(ts, (int, float)):
                abs_ts = member._abs_time(ts)
                if abs_ts is not None:
                    entry["abs_ts"] = round(abs_ts, 6)
            _hop(tid, entry)

        sources = list(self.members)
        if self.router is not None:
            sources.append(self.router)
        for member in sources:
            label = "router" if member.process_index < 0 else f"proc-{member.process_index}"
            for s in member.report.spans:
                _span_hop(member, label, s)
            for r in (member.flight or {}).get("records") or []:
                if not isinstance(r, dict):
                    continue
                if r.get("type") == "request" and r.get("trace_id"):
                    _hop(r["trace_id"], {
                        "source": label,
                        "process_index": member.process_index,
                        "name": r.get("name"),
                        "request_id": r.get("request_id"),
                        "role": r.get("role"),
                        "status": r.get("status"),
                        "dur_ms": r.get("dur_ms"),
                        "phases": {p["name"]: p["ms"] for p in r.get("phases") or []
                                   if isinstance(p, dict) and "name" in p},
                        "attrs": r.get("attrs") or {},
                        "from_flight": True,
                    })
                elif r.get("type") == "span":
                    _span_hop(member, label, r)
        out = list(traces.values())
        for t in out:
            durs = [h["dur_ms"] for h in t["hops"] if isinstance(h.get("dur_ms"), (int, float))]
            t["dur_ms"] = max(durs) if durs else None
            t["status"] = "error" if any(h.get("status") == "error" for h in t["hops"]) else "ok"
            t["sources"] = sorted({h["source"] for h in t["hops"]})
            t["hops"].sort(key=lambda h: (h.get("abs_ts") is None, h.get("abs_ts") or 0.0,
                                          h.get("source") or ""))
        out.sort(key=lambda t: -(t["dur_ms"] or 0.0))
        return out

    def rows(self) -> list[dict[str, Any]]:
        return [m.row() for m in self.members]

    def lost_members(self) -> list[int]:
        return [m.process_index for m in self.members if m.lost]

    def straggler(self) -> Optional[dict[str, Any]]:
        """The member the fleet waited on: the least total collective wait
        among members that report waits (the last to arrive at a barrier
        waits about nothing). None with fewer than two such members or a
        spread below noise."""
        waits = {m.process_index: w for m in self.members
                 if (w := m.collective_wait_seconds()) is not None}
        if len(waits) < 2:
            return None
        spread = max(waits.values()) - min(waits.values())
        if spread < _STRAGGLER_MIN_SPREAD_S:
            return None
        straggler = min(waits, key=lambda p: waits[p])
        return {
            "process_index": straggler,
            "wait_s": round(waits[straggler], 6),
            "fleet_max_wait_s": round(max(waits.values()), 6),
            "spread_s": round(spread, 6),
            "waits_by_member": {str(p): round(w, 6) for p, w in sorted(waits.items())},
        }

    def merged_hot_executables(self, k: int = 10) -> list[dict[str, Any]]:
        """The fleet's hot-executable list: per-name sums of the members'
        profiled exclusive seconds and calls (every member runs the same
        executables, so the fleet pays each member's copy), the best MFU
        seen on any member, and the set of bound classes. Empty when no
        member profiled anything."""
        merged: dict[str, dict[str, Any]] = {}
        for m in self.members:
            for e in m.report.hot_executables(k=1_000_000):
                agg = merged.setdefault(e["name"], {
                    "name": e["name"], "est_exclusive_seconds": 0.0, "dispatches": 0,
                    "members": 0, "mfu_max": None, "bound_classes": [],
                    "timing_suspect": False})
                agg["est_exclusive_seconds"] += float(e.get("est_exclusive_seconds") or 0.0)
                agg["dispatches"] += int(e.get("dispatches") or 0)
                agg["members"] += 1
                mfu = e.get("mfu")
                if mfu is not None and (agg["mfu_max"] is None or mfu > agg["mfu_max"]):
                    agg["mfu_max"] = mfu
                bc = e.get("bound_class", "unknown")
                if bc not in agg["bound_classes"]:
                    agg["bound_classes"].append(bc)
                agg["timing_suspect"] = agg["timing_suspect"] or bool(e.get("timing_suspect"))
        out = list(merged.values())
        for agg in out:
            agg["est_exclusive_seconds"] = round(agg["est_exclusive_seconds"], 6)
            agg["bound_classes"] = sorted(agg["bound_classes"])
        out.sort(key=lambda e: e["est_exclusive_seconds"], reverse=True)
        return out[:k]

    def _hot_executables_markdown(self, k: int = 10) -> list[str]:
        hot = self.merged_hot_executables(k)
        if not hot:
            return []
        lines = ["## Fleet hot executables", "",
                 "_Per-executable profiled exclusive seconds summed across members (SPMD: "
                 "the fleet pays every member's copy); MFU is the best observed on any "
                 "member._", "",
                 "| executable | excl s (fleet) | dispatches | members | MFU max | bound |",
                 "|---|---|---|---|---|---|"]
        for e in hot:
            name = f"`{e['name']}`" + (" ⚠" if e["timing_suspect"] else "")
            lines.append(f"| {name} | {_fmt(e['est_exclusive_seconds'])} | {e['dispatches']} | "
                         f"{e['members']} | {_fmt_pct(e['mfu_max'])} | "
                         f"{', '.join(e['bound_classes'])} |")
        lines.append("")
        return lines

    def _requests_markdown(self, k: int = 10) -> list[str]:
        traces = self.request_traces()
        if not traces:
            return []
        lines = ["## Requests", "",
                 "_Persisted request traces (tail sampling: slow / degraded / errored / "
                 "explicitly sampled), joined across router and member streams by `trace_id`; "
                 "slowest hop first._", "",
                 "| trace | ms | status | hops | phases |", "|---|---|---|---|---|"]
        for t in traces[:k]:
            phases = [f"{name} {ms:.1f}" for h in t["hops"]
                      for name, ms in (h.get("phases") or {}).items()
                      if isinstance(ms, (int, float))]
            lines.append(f"| `{t['trace_id']}` | {_fmt_or_unknown(t['dur_ms'])} | "
                         f"{t['status']} | {', '.join(t['sources'])} | {'; '.join(phases[:8])} |")
        lines.append("")
        return lines

    def _last_words_markdown(self, k: int = 5) -> list[str]:
        """The lost members' flight records: the last entries of each, what
        the member was doing when it died."""
        lines: list[str] = []
        for m in self.members:
            if not m.lost or not m.flight:
                continue
            recs = m.flight.get("records") or []
            how = ("harvested from the span-stream tail" if m.flight.get("harvested")
                   else "drain-path dump")
            note = (f"_{len(recs)} record(s) in the final {_fmt(m.flight.get('window_s'))}s "
                    f"window ({how}")
            if m.flight.get("dropped"):
                note += f"; {m.flight['dropped']} ring drop(s)"
            note += ")._"
            lines += [f"### Last words — member {m.process_index}", "", note, ""]
            for r in recs[-k:]:
                if not isinstance(r, dict):
                    continue
                if r.get("type") == "request":
                    desc = (f"- `{r.get('name')}` {r.get('status')} "
                            f"{_fmt_or_unknown(r.get('dur_ms'))} ms")
                    if r.get("error"):
                        desc += f" — {r['error']}"
                else:
                    desc = f"- span `{r.get('name')}`"
                    dur = r.get("dur")
                    if isinstance(dur, (int, float)):
                        desc += f" {dur * 1000.0:.1f} ms"
                    err = (r.get("attrs") or {}).get("error")
                    if err:
                        desc += f" — {err}"
                lines.append(desc)
            lines.append("")
        if lines:
            lines = ["## Flight recorder", ""] + lines
        return lines

    def key_metrics(self) -> dict[str, float]:
        """The fleet's scalars ``compare()`` gates on."""
        out: dict[str, float] = {"fleet_members": float(self.num_processes),
                                 "fleet_lost_members": float(len(self.lost_members()))}
        rates = [r for m in self.members if (r := m.key_metrics().get("rows_per_sec"))]
        if rates:
            out["fleet_rows_per_sec"] = float(sum(rates))
        coeff_rates = [r for m in self.members if (r := m.key_metrics().get("coeffs_per_sec"))]
        if coeff_rates:
            out["fleet_coeffs_per_sec"] = float(sum(coeff_rates))
        waits = [w for m in self.members if (w := m.collective_wait_seconds()) is not None]
        run_total = sum(m.run_seconds() for m in self.members)
        if waits:
            out["fleet_collective_wait_s"] = round(sum(waits), 6)
            if run_total:
                out["fleet_collective_wait_fraction"] = round(sum(waits) / run_total, 6)
        mfus = [mfu for m in self.members if (mfu := m.key_metrics().get("mfu")) is not None]
        if len(mfus) >= 2:
            out["fleet_mfu_spread"] = round(max(mfus) - min(mfus), 6)
        gaps = [g for m in self.members if (g := m.heartbeat_gap_max_s()) is not None]
        if gaps:
            out["fleet_heartbeat_gap_max_s"] = round(max(gaps), 3)
        skews = [abs(m.clock_skew_s) for m in self.members]
        if any(skews):
            out["fleet_clock_skew_max_s"] = round(max(skews), 6)
        return out

    def compare(self, baseline: Mapping[str, Any], threshold: float = 0.2) -> list[MetricDelta]:
        """The key metrics against a baseline fleet-report JSON (its
        ``key_metrics``) or a bare ``{metric: value}`` dict."""
        base = baseline.get("key_metrics", baseline)
        return compare_metrics(self.key_metrics(), base, threshold=threshold,
                               directions=FLEET_KEY_METRIC_DIRECTIONS)

    # -- rendering -----------------------------------------------------------

    def to_json(self) -> dict[str, Any]:
        return {
            "type": "fleet_report",
            "format_version": FLEET_REPORT_FORMAT_VERSION,
            "generated": datetime.datetime.now(datetime.timezone.utc).isoformat(),
            "fleet_dir": self.fleet_dir,
            "num_processes": self.num_processes,
            "lost_members": self.lost_members(),
            "key_metrics": self.key_metrics(),
            "members": self.rows(),
            "straggler": self.straggler(),
            "hot_executables": self.merged_hot_executables(),
            "router_trace": self.router_trace_path,
            "request_traces": self.request_traces()[:20],
        }

    def save_json(self, path: str) -> dict[str, Any]:
        from photon_ml_tpu_torch.utils.atomic import atomic_write_json

        doc = self.to_json()
        atomic_write_json(path, doc, indent=2, sort_keys=True, default=str)
        return doc

    def _quality_markdown(self) -> list[str]:
        """Gate decisions summed over the members, and each member's drift
        sketches; empty when no member touched the quality layer."""
        totals: dict[str, int] = {}
        drift_rows: list[str] = []
        for m in self.members:
            q = m.report.quality_summary()
            if not q:
                continue
            for key in ("stats_computed", "bootstrap_fits", "gate_published", "gate_quarantined",
                        "gate_bypassed", "gate_no_champion", "pipeline_quarantines"):
                if q.get(key):
                    totals[key] = totals.get(key, 0) + int(q[key])
            versions = (q.get("drift") or {}).get("versions") or {}
            if versions:
                scored = sum((row.get("scores") or {}).get("count", 0)
                             for row in versions.values())
                drift_rows.append(f"- member {m.process_index}: drift sketches for "
                                  f"{len(versions)} version(s), {scored} score(s) observed")
        if not totals and not drift_rows:
            return []
        out = ["## Quality", ""]
        if totals:
            out.append("- fleet totals: " + ", ".join(f"{v} {k.replace('_', ' ')}"
                                                      for k, v in sorted(totals.items())))
        out += drift_rows
        out.append("")
        return out

    def to_markdown(self, deltas: Optional[Sequence[MetricDelta]] = None) -> str:
        lines: list[str] = ["# Fleet report", "",
                            f"_Fleet dir: `{self.fleet_dir}` — {self.num_processes} member(s)_",
                            ""]
        lost = self.lost_members()
        if lost:
            lines += [f"> **Warning**: member(s) {lost} are **lost** — their final metrics "
                      "snapshot never landed (killed before the atexit flush, or artifacts "
                      "missing). Rows below render whatever survived; fleet aggregates "
                      "undercount.", ""]
        km = self.key_metrics()
        if km:
            lines += ["## Fleet key metrics", "", "| metric | value |", "|---|---|"]
            lines += [f"| `{name}` | {_fmt(value)} |" for name, value in sorted(km.items())]
            lines.append("")
        lines += ["## Members", "",
                  "| proc | status | rows/s | MFU | comms | wait s | wait share | chunks | "
                  "hot exec | beats | max gap s | skew s |",
                  "|---|---|---|---|---|---|---|---|---|---|---|---|"]
        for row in self.rows():
            lines.append(
                f"| {row['process_index']}"
                + (f" ({row['hostname']})" if row.get("hostname") else "")
                + f" | {row['status']} | {_fmt_or_unknown(row['rows_per_sec'])} | "
                f"{_fmt_pct(row['mfu'])} | {_fmt_pct(row['comms_fraction'])} | "
                f"{_fmt_or_unknown(row['collective_wait_s'])} | "
                f"{_fmt_pct(row['collective_wait_share'])} | "
                f"{_fmt_or_unknown(row['chunks_done'])} | "
                + (f"`{row['hot_exec']}`" if row.get("hot_exec") else "unknown")
                + f" | {row['heartbeats']} | {_fmt_or_unknown(row['heartbeat_gap_max_s'])} | "
                f"{_fmt(row['clock_skew_s'])} |")
        lines.append("")
        lines += self._last_words_markdown()
        lines += self._requests_markdown()
        lines += self._hot_executables_markdown()
        lines += self._quality_markdown()
        straggler = self.straggler()
        if straggler is not None:
            lines += [f"**Straggler: member {straggler['process_index']}** — it waited only "
                      f"{straggler['wait_s']:.3f}s at the fleet's collectives while the "
                      f"slowest-waiting member stood by for {straggler['fleet_max_wait_s']:.3f}s "
                      "(low wait = last to arrive = the member everyone else waited on).", ""]
        elif not lost:
            lines += ["No straggler callout: collective waits are balanced (or unrecorded) "
                      "across members.", ""]
        if deltas is not None:
            lines += _compare_markdown(deltas)
        return "\n".join(lines).rstrip() + "\n"
