"""The port's fleet report (``photon_ml_tpu_torch.telemetry.fleet_report``)
and ``cli report --fleet`` against the JAX package's, case for case with
tests/test_fleet_report.py:296-535 and :596-649 (its cases at :32-187, the
identity suffix, the heartbeat tail parser and the collective-wait counters,
have twins in test_torch_telemetry.py, test_torch_report.py and
test_torch_multihost.py):

- discovery by content, the newest generation's directory, an empty one;
- the same synthetic fleet directory into both packages' ``FleetReport.load``
  gives equal ``to_json()`` (but ``generated``) and equal markdown: the rows,
  the straggler, the clock skew from the coordinated saves, the merged
  spans on the anchors, a killed member marked lost, a member with no
  artifact synthesized lost, ``compare`` over the fleet's key metrics;
- the fields built on the executable accounting are equal too: the member
  rows' ``mfu``, ``comms_fraction`` and ``hot_exec``, the key metric
  ``fleet_mfu_spread`` and the merged ``hot_executables`` with their
  markdown section, but for one named difference: bound classes 1 and 2
  carry the card's names (compute-bound, low-compute-bound) where the
  reference names TPU units; members without profiles render "unknown"
  alike;
- ``cli report --fleet``: markdown, JSON, ``--compare --fail-on-regress``
  and the exit codes 0, 1, 2 (usage) and 3, equal to the JAX package's.

Tolerances: the reference test's (``pytest.approx`` where it uses it, else
exact).
"""

from __future__ import annotations

import json
import os

import pytest

from photon_ml_tpu.cli.report import main as j_report_main
from photon_ml_tpu.telemetry.fleet_report import FleetReport as JFleetReport
from photon_ml_tpu.telemetry.fleet_report import discover_member_streams as j_discover
from photon_ml_tpu_torch.cli.report import main as report_main
from photon_ml_tpu_torch.telemetry.fleet_report import FleetReport, discover_member_streams

#: what the executable accounting feeds into the rows and the key metrics
XLA_ROW_KEYS = ("mfu", "comms_fraction", "hot_exec")
XLA_KEY_METRICS = ("fleet_mfu_spread",)

#: the one named difference: bound classes 1 and 2 carry the card's names
#: (the reference's MXU and VPU are TPU units); the codes are the same
CARD_BOUND_NAMES = {"MXU-bound": "compute-bound", "VPU-bound": "low-compute-bound"}


def _card_names(text: str) -> str:
    for tpu, card in CARD_BOUND_NAMES.items():
        text = text.replace(tpu, card)
    return text


def _write_member(directory, proc: int, *, anchor_unix: float, wait_s: float = None,
                  rows_per_sec: float = None, mfu: float = None, heartbeat_uptimes=(),
                  truncate_trace: bool = False, write_metrics: bool = True,
                  rendezvous_end: float = None, extra_gauges: dict = None,
                  extra_counters: dict = None):
    """One member's artifact pair, tests/test_fleet_report.py's
    ``_write_member``: the truncated trace without a metrics snapshot is the
    shape a hard-killed member leaves."""
    header = {"type": "trace_header", "wall_time": "2026-08-03T00:00:00+00:00",
              "monotonic_anchor": 5.0, "anchor_unix_s": anchor_unix,
              "hostname": f"host{proc}", "process_index": proc, "num_processes": 2}
    spans = [{"type": "span", "id": 1, "parent": None, "name": "fit", "ts": 6.0, "dur": 10.0,
              "thread": "MainThread", "attrs": {}, "events": []}]
    if rendezvous_end is not None:
        spans.append({"type": "span", "id": 2, "parent": 1, "name": "checkpoint:save",
                      "ts": rendezvous_end - 1.0, "dur": 1.0, "thread": "MainThread",
                      "attrs": {"coordinated": True, "next_chunk": 1}, "events": []})
    with open(os.path.join(directory, f"trace.proc-{proc}.jsonl"), "w") as fh:
        fh.write(json.dumps(header) + "\n")
        for s in spans:
            fh.write(json.dumps(s) + "\n")
        if truncate_trace:
            fh.write('{"type": "span", "id": 99, "name": "torn')
    with open(os.path.join(directory, f"telemetry.proc-{proc}.jsonl"), "w") as fh:
        for i, up in enumerate(heartbeat_uptimes):
            fh.write(json.dumps({"type": "heartbeat", "seq": i + 1, "proc": proc,
                                 "uptime_s": up}) + "\n")
        if write_metrics:
            counters = {"streaming_chunks": 4}
            gauges = {}
            if wait_s is not None:
                counters["comms.wait_seconds_total"] = wait_s
                counters["comms.wait_calls"] = 4
            if rows_per_sec is not None:
                gauges["progress.rows_per_sec"] = rows_per_sec
            if mfu is not None:
                counters["xla.flops_total"] = mfu * 1e12 * 10.0
                gauges["device.peak_flops"] = 1e12
            gauges.update(extra_gauges or {})
            counters.update(extra_counters or {})
            fh.write(json.dumps({"type": "metrics", "wall_time": "2026-08-03T00:00:30+00:00",
                                 "process_index": proc,
                                 "snapshot": {"counters": counters, "gauges": gauges,
                                              "histograms": {}}}) + "\n")


def _docs(directory):
    """Both packages' reports of ``directory`` and their JSON documents
    (``generated`` checked and dropped)."""
    t, j = FleetReport.load(str(directory)), JFleetReport.load(str(directory))
    docs = []
    for r in (t, j):
        doc = json.loads(json.dumps(r.to_json(), default=str))
        assert doc.pop("generated")
        docs.append(doc)
    t_doc, j_doc = docs
    for e in j_doc["hot_executables"]:
        e["bound_classes"] = sorted(CARD_BOUND_NAMES.get(b, b) for b in e["bound_classes"])
    for row_t, row_j in zip(t_doc["members"], j_doc["members"]):
        for key in XLA_ROW_KEYS:
            assert row_t[key] == row_j[key], key
    for key in XLA_KEY_METRICS:
        assert t_doc["key_metrics"].get(key) == j_doc["key_metrics"].get(key)
    assert t_doc["hot_executables"] == j_doc["hot_executables"]
    return t, j, t_doc, j_doc


def _same(t, j, t_doc, j_doc):
    assert t_doc == j_doc
    assert t.to_markdown() == _card_names(j.to_markdown())


# ---------------------------------------------------------------------------
# discovery
# ---------------------------------------------------------------------------


def test_discover_member_streams_classifies_by_content(tmp_path):
    _write_member(tmp_path, 0, anchor_unix=1000.0, wait_s=1.0)
    streams = discover_member_streams(str(tmp_path))
    assert streams == j_discover(str(tmp_path))
    assert set(streams) == {0}
    assert streams[0]["trace"].endswith("trace.proc-0.jsonl")
    assert streams[0]["telemetry"].endswith("telemetry.proc-0.jsonl")
    assert streams[0]["header"]["process_index"] == 0


def test_discover_falls_back_to_newest_generation_dir(tmp_path):
    gen0, gen1 = tmp_path / "telemetry" / "gen0", tmp_path / "telemetry" / "gen1"
    gen0.mkdir(parents=True)
    gen1.mkdir(parents=True)
    _write_member(gen0, 0, anchor_unix=1000.0, wait_s=1.0)
    _write_member(gen0, 1, anchor_unix=1000.0, wait_s=1.0)
    _write_member(gen1, 0, anchor_unix=2000.0, wait_s=2.0)
    streams = discover_member_streams(str(tmp_path))
    assert streams == j_discover(str(tmp_path))
    assert set(streams) == {0} and "gen1" in streams[0]["trace"]
    assert set(discover_member_streams(str(gen0))) == {0, 1}


def test_fleet_report_empty_dir_has_no_members(tmp_path):
    report = FleetReport.load(str(tmp_path))
    assert report.members == []
    assert report.key_metrics()["fleet_members"] == 0.0
    _same(*_docs(tmp_path))


# ---------------------------------------------------------------------------
# the report against the JAX package's
# ---------------------------------------------------------------------------


def test_fleet_report_rows_straggler_and_roundtrip(tmp_path):
    _write_member(tmp_path, 0, anchor_unix=1000.0, wait_s=3.0, rows_per_sec=100.0, mfu=0.30,
                  heartbeat_uptimes=(1.0, 2.0, 3.0), rendezvous_end=9.0)
    _write_member(tmp_path, 1, anchor_unix=1002.0, wait_s=0.2, rows_per_sec=80.0, mfu=0.20,
                  heartbeat_uptimes=(1.0, 2.5), rendezvous_end=7.1)
    t, j, t_doc, j_doc = _docs(tmp_path)
    _same(t, j, t_doc, j_doc)
    assert [m.process_index for m in t.members] == [0, 1] and t.lost_members() == []
    # the skew from the coordinated save's end: 1004.1 against 1004
    assert t.members[1].clock_skew_s == pytest.approx(0.1, abs=1e-6)
    straggler = t.straggler()
    assert straggler["process_index"] == 1
    assert straggler["wait_s"] == pytest.approx(0.2)
    assert straggler["fleet_max_wait_s"] == pytest.approx(3.0)
    km = t.key_metrics()
    assert km["fleet_rows_per_sec"] == pytest.approx(180.0)
    assert km["fleet_collective_wait_s"] == pytest.approx(3.2)
    assert km["fleet_collective_wait_fraction"] == pytest.approx(3.2 / 20.0, abs=1e-5)
    assert km["fleet_lost_members"] == 0.0
    assert km["fleet_mfu_spread"] == pytest.approx(0.1)  # MFU 0.30 and 0.20 over 10 s
    by_proc = {r["process_index"]: r for r in t_doc["members"]}
    assert by_proc[0]["collective_wait_s"] == pytest.approx(3.0)
    assert by_proc[0]["status"] == "ok" and by_proc[1]["hostname"] == "host1"
    md = t.to_markdown()
    assert "Straggler: member 1" in md and "| 0 (host0) | ok |" in md


def test_fleet_report_merged_spans_align_on_anchors(tmp_path):
    _write_member(tmp_path, 0, anchor_unix=1000.0, rendezvous_end=9.0)
    _write_member(tmp_path, 1, anchor_unix=1002.0, rendezvous_end=7.0)
    t = FleetReport.load(str(tmp_path))
    merged = t.merged_spans()
    assert merged == JFleetReport.load(str(tmp_path)).merged_spans()
    by_proc = {s["process_index"]: s["abs_ts"] for s in merged if s["name"] == "fit"}
    assert by_proc[0] == pytest.approx(1001.0, abs=1e-3)
    assert by_proc[1] == pytest.approx(1003.0, abs=1e-3)
    _same(*_docs(tmp_path))


def test_fleet_report_degraded_killed_member_marked_lost(tmp_path):
    _write_member(tmp_path, 0, anchor_unix=1000.0, wait_s=2.0, rows_per_sec=50.0,
                  heartbeat_uptimes=(1.0, 2.0))
    _write_member(tmp_path, 1, anchor_unix=1000.1, truncate_trace=True, write_metrics=False,
                  heartbeat_uptimes=(1.0,))
    t, j, t_doc, j_doc = _docs(tmp_path)
    _same(t, j, t_doc, j_doc)
    assert t.lost_members() == [1]
    rows = {r["process_index"]: r for r in t_doc["members"]}
    assert (rows[1]["status"], rows[0]["status"], rows[1]["heartbeats"]) == ("lost", "ok", 1)
    km = t.key_metrics()
    assert km["fleet_lost_members"] == 1.0
    assert km["fleet_rows_per_sec"] == pytest.approx(50.0)
    assert "lost" in t.to_markdown()


def test_fleet_report_member_with_no_artifacts_is_synthesized_lost(tmp_path):
    _write_member(tmp_path, 0, anchor_unix=1000.0, wait_s=1.0)
    t, j, t_doc, j_doc = _docs(tmp_path)
    _same(t, j, t_doc, j_doc)
    assert t.num_processes == 2 and t.lost_members() == [1]
    rows = {r["process_index"]: r for r in t.rows()}
    assert rows[1]["artifacts"] == {"trace": None, "telemetry": None, "flight": None}


def test_fleet_report_compare_gates_aggregated_metrics(tmp_path):
    _write_member(tmp_path, 0, anchor_unix=1000.0, wait_s=3.0, rows_per_sec=100.0)
    _write_member(tmp_path, 1, anchor_unix=1000.0, wait_s=0.5, rows_per_sec=100.0)
    t, j, t_doc, j_doc = _docs(tmp_path)
    _same(t, j, t_doc, j_doc)
    deltas = t.compare(t.to_json())
    assert deltas and not any(d.regressed for d in deltas)
    km = t.key_metrics()
    for metric, factor in (("fleet_collective_wait_fraction", 0.1),
                           ("fleet_rows_per_sec", 10.0)):
        baseline = dict(km)
        baseline[metric] = km[metric] * factor
        got = [d.to_dict() for d in t.compare(baseline)]
        assert got == [d.to_dict() for d in j.compare(baseline)]
        assert metric in {d["metric"] for d in got if d["regressed"]}


# ---------------------------------------------------------------------------
# cli report --fleet
# ---------------------------------------------------------------------------


def test_cli_report_fleet_renders_and_gates(tmp_path, capsys):
    fleet_dir = tmp_path / "fleet_artifacts"
    fleet_dir.mkdir()
    _write_member(fleet_dir, 0, anchor_unix=1000.0, wait_s=3.0, rows_per_sec=100.0,
                  heartbeat_uptimes=(1.0, 2.0))
    _write_member(fleet_dir, 1, anchor_unix=1000.0, wait_s=0.1, rows_per_sec=90.0,
                  heartbeat_uptimes=(1.0,))
    outs = {}
    for name, main in (("t", report_main), ("j", j_report_main)):
        out_md, out_json = tmp_path / f"{name}.md", tmp_path / f"{name}.json"
        assert main(["--fleet", str(fleet_dir), "--out", str(out_md),
                     "--json", str(out_json)]) == 0
        outs[name] = (out_md.read_text(), json.loads(out_json.read_text()))
    md, doc = outs["t"]
    assert md == outs["j"][0]
    assert "# Fleet report" in md and "Straggler: member 1" in md
    assert doc["type"] == "fleet_report" and len(doc["members"]) == 2
    baseline = dict(doc["key_metrics"])
    baseline["fleet_collective_wait_fraction"] /= 10.0
    base_path = tmp_path / "baseline.json"
    base_path.write_text(json.dumps({"key_metrics": baseline}))
    for main in (report_main, j_report_main):
        assert main(["--fleet", str(fleet_dir), "--compare", str(base_path),
                     "--fail-on-regress"]) == 3
        assert main(["--fleet", str(fleet_dir), "--compare", str(tmp_path / "t.json"),
                     "--fail-on-regress"]) == 0
    capsys.readouterr()


def test_cli_report_fleet_usage_errors(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        report_main(["--fleet", str(tmp_path), "--trace", "x.jsonl"])
    assert exc.value.code == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert report_main(["--fleet", str(empty)]) == 1
    assert report_main(["--fleet", str(tmp_path / "missing")]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the executable accounting's fields
# ---------------------------------------------------------------------------


def _profile_gauges(name, excl, dispatches, mfu, bound_code):
    return {f"profile.exec.{name}.est_exclusive_seconds": excl,
            f"profile.exec.{name}.dispatches": dispatches,
            f"profile.exec.{name}.mfu": mfu, f"profile.exec.{name}.bound_code": bound_code}


def test_fleet_report_merged_hot_executables(tmp_path):
    """With profile gauges in the members' snapshots both packages merge the
    same fleet hot list (per-name sums, the best MFU, the bound classes) and
    give each member its hottest executable."""
    g0 = dict(_profile_gauges("solve", 4.0, 100, 0.30, 1))
    g0.update(_profile_gauges("aux", 1.0, 50, 0.05, 4))
    _write_member(tmp_path, 0, anchor_unix=1000.0, wait_s=1.0, rows_per_sec=100.0,
                  extra_gauges=g0)
    _write_member(tmp_path, 1, anchor_unix=1000.0, wait_s=1.0, rows_per_sec=90.0,
                  extra_gauges=_profile_gauges("solve", 2.0, 100, 0.40, 3))
    t, j, t_doc, j_doc = _docs(tmp_path)
    _same(t, j, t_doc, j_doc)
    hot = t.merged_hot_executables()
    assert [e["name"] for e in hot] == ["solve", "aux"]
    assert hot[0]["est_exclusive_seconds"] == pytest.approx(6.0)
    assert hot[0]["mfu_max"] == pytest.approx(0.40) and hot[0]["members"] == 2
    assert hot[0]["bound_classes"] == ["HBM-bound", "compute-bound"]
    assert [r["hot_exec"] for r in t.rows()] == ["solve", "solve"]
    md = t.to_markdown()
    assert "## Fleet hot executables" in md and "| `solve` | 6 |" in md


def test_fleet_report_members_without_profiles_render_unknown(tmp_path):
    _write_member(tmp_path, 0, anchor_unix=1000.0, wait_s=1.0)
    _write_member(tmp_path, 1, anchor_unix=1000.0, wait_s=1.0)
    t, j, t_doc, j_doc = _docs(tmp_path)
    _same(t, j, t_doc, j_doc)
    assert t.to_markdown() == j.to_markdown()
    assert t.merged_hot_executables() == [] and all(r["hot_exec"] is None for r in t.rows())
    md = t.to_markdown()
    assert "## Fleet hot executables" not in md and "unknown" in md
