"""The port's request-scoped tracing (``photon_ml_tpu_torch.telemetry.requests``)
against the JAX package's, case for case with tests/test_requests.py:39-454:

- the context: the header round trip, and ``parse_header`` on the same
  malformed and odd values gives the same answers in both packages;
- the ring and tail sampling: a ``RequestTracer`` in each package, driven by
  the same begin/finish sequence on a patched clock, keeps equal ring
  records and drop counts and persists spans with equal names, attributes
  and parent structure (error over sampled, degraded, sampled, a pinned and
  the rolling p99 threshold); the tracer's buffer overflow; recording off;
- the flight recorder: ``flight_dump``/``read_flight`` (the window, torn and
  foreign files), the ``telemetry.flight_dump`` fault seam failing soft,
  ``tail_records`` and ``harvest_flight`` of the same span JSONL equal in
  both packages;
- the fleet join: one sampled request across a router stream and two member
  streams (one member killed, its flight harvested) read by both packages'
  ``FleetReport`` into equal request traces, last words and Chrome export;
- ``RunReport``'s requests sections and ``cli report --requests``, equal in
  both packages on the same artifacts.

Tolerances: none; the compared records, spans and documents are exact but
for the fields named (wall times, minted ids, the ``generated`` stamp).
"""

from __future__ import annotations

import json
import os

import pytest

from photon_ml_tpu import telemetry as j_telemetry
from photon_ml_tpu.cli import report as j_cli_report
from photon_ml_tpu.telemetry import fleet_report as j_fleet_report
from photon_ml_tpu.telemetry import requests as j_rq
from photon_ml_tpu.telemetry import trace as j_trace
from photon_ml_tpu.telemetry.report import RunReport as JRunReport
from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.cli import report as cli_report
from photon_ml_tpu_torch.telemetry import fleet_report, trace
from photon_ml_tpu_torch.telemetry import requests as rq
from photon_ml_tpu_torch.telemetry.report import RunReport


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    j_telemetry.reset()
    yield
    faults.clear_plan()
    telemetry.reset()
    j_telemetry.reset()


def _counter(name: str) -> int:
    return int(telemetry.snapshot()["counters"].get(name, 0))


class _Clock:
    """A tracer clock that moves only when told to."""

    def __init__(self):
        self.t = 10.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(trace.TRACER, "now", c)
    monkeypatch.setattr(j_trace.TRACER, "now", c)
    return c


# ---------------------------------------------------------------------------
# context propagation
# ---------------------------------------------------------------------------


def test_context_header_roundtrip():
    ctx = rq.make_context()
    assert ";s=1" not in ctx.to_header()
    back = rq.parse_header(ctx.to_header())
    assert (back.trace_id, back.request_id, back.sampled) == (ctx.trace_id, ctx.request_id,
                                                              False)
    sampled = rq.make_context(sampled=True)
    assert sampled.to_header().endswith(";s=1")
    assert rq.parse_header(sampled.to_header()).sampled is True
    assert sampled.trace_id != ctx.trace_id and sampled.request_id != ctx.request_id
    # a header minted by either package parses alike in the other
    for c in (sampled, j_rq.make_context(sampled=True)):
        for parse in (rq.parse_header, j_rq.parse_header):
            got = parse(c.to_header())
            assert (got.trace_id, got.request_id, got.sampled) == (c.trace_id, c.request_id,
                                                                   True)
    assert rq.TRACE_HEADER == j_rq.TRACE_HEADER == "X-Photon-Trace"


@pytest.mark.parametrize("value", [None, "", "abc", "a/b/c", "/b", "a/", "//", ";s=1", 123,
                                   b"a/b", "  tid/rid;x=9;s=1  ", "tid/rid;x=9", "t/r;s=0",
                                   "t/r ; s=1"])
def test_parse_header_malformed_is_none_never_raises(value):
    """The same malformed (None) and odd values give the same answers in
    both packages; a bad header never fails its request."""
    got, want = rq.parse_header(value), j_rq.parse_header(value)
    if want is None:
        assert got is None
    else:
        assert (got.trace_id, got.request_id, got.sampled) == (want.trace_id, want.request_id,
                                                               want.sampled)


# ---------------------------------------------------------------------------
# the ring, drops, tail sampling: both packages on one clock
# ---------------------------------------------------------------------------


def _drive(pkg, clock):
    """One begin/finish program: a capped ring, a fast request, an error,
    a degraded one, a sampled one with phases (error over sampled), a pinned
    threshold, the rolling p99 engaging after enough finishes."""
    clock.t = 10.0
    pkg.configure(ring_limit=6)

    def one(name, dt, ctx=None, status="ok", error=None, phases=(), **attrs):
        rec = pkg.begin(name, ctx=ctx, **attrs)
        for pname, ms in phases:
            rec.phase(pname, ms, ts=clock.t)
        clock.t += dt
        pkg.finish(rec, status=status, error=error)

    one("fast", 0.001)
    one("err", 0.002, status="error", error="boom")
    one("deg", 0.003, degraded=True)
    one("smp", 0.004, ctx=pkg.make_context(sampled=True), role="member", version="v3",
        fleet_size=4, phases=(("batcher_wait", 2.0), ("device_dispatch", 1.0)))
    one("both", 0.005, ctx=pkg.TraceContext("t9", "r9", sampled=True), status="error",
        error="shed", phases=(("fold", 0.5),))
    pkg.configure(slow_threshold_ms=0.0)
    one("slow", 0.006)
    pkg.configure(slow_threshold_ms=None)
    for i in range(130):
        one(f"w{i}", 0.001 * (1 + i % 7))
    one("tail", 0.5)  # far above the rolling p99 now in force
    return pkg.REQUESTS.slow_threshold_ms, pkg.REQUESTS.dropped


def _norm_records(records):
    out = []
    for r in records:
        r = dict(r)
        minted = r["trace_id"] != "t9"
        if minted:
            r.pop("trace_id")
            r.pop("request_id")
        out.append(r)
    return out


def _span_tree(spans):
    """(name, attrs without minted ids, parent's name) for each span."""
    by_id = {s.span_id: s for s in spans}
    out = []
    for s in spans:
        attrs = dict(s.attrs)
        if attrs.get("trace_id") != "t9":
            attrs.pop("trace_id", None)
            attrs.pop("request_id", None)
        parent = by_id[s.parent_id].name if s.parent_id is not None else None
        out.append((s.name, s.ts, s.dur, attrs, parent))
    return out


def test_ring_and_tail_sampling_match_the_jax_package(clock):
    got = _drive(rq, clock)
    want = _drive(j_rq, clock)
    assert got == want and got[0] is not None and got[1] == 137 - 6
    assert _norm_records(rq.records()) == _norm_records(j_rq.records())
    assert [r["name"] for r in rq.records()][-1] == "tail"
    assert _span_tree(trace.finished_spans()) == _span_tree(j_trace.finished_spans())
    reasons = {s.name: s.attrs["sampled_reason"] for s in trace.finished_spans()
               if "sampled_reason" in s.attrs}
    # the window's slowest (7 ms) requests reach its p99 once it is in force
    assert {r for n, r in reasons.items() if n.startswith("request:w")} == {"slow"}
    reasons = {n: r for n, r in reasons.items() if not n.startswith("request:w")}
    assert reasons == {"request:err": "error", "request:deg": "degraded",
                       "request:smp": "sampled", "request:both": "error",
                       "request:slow": "slow", "request:tail": "slow"}
    root = trace.finished_spans("request:smp")[0]
    assert root.attrs["phases"] == {"batcher_wait": 2.0, "device_dispatch": 1.0}
    child = trace.finished_spans("request:smp:batcher_wait")[0]
    assert child.parent_id == root.span_id
    assert child.attrs["trace_id"] == root.attrs["trace_id"]
    snap, j_snap = telemetry.snapshot(), j_telemetry.snapshot()
    for name in ("request.records", "request.persisted", "telemetry.trace_dropped"):
        assert snap["counters"][name] == j_snap["counters"][name], name
    for name in ("request.total_ms", "request.phase.batcher_wait_ms"):
        assert snap["histograms"][name] == j_snap["histograms"][name], name


def test_request_ring_overflow_evicts_oldest_and_counts_drops():
    rq.configure(ring_limit=4)
    for i in range(7):
        rq.finish(rq.begin(f"r{i}"))
    assert [r["name"] for r in rq.records()] == ["r3", "r4", "r5", "r6"]
    assert rq.REQUESTS.dropped == 3
    assert _counter("telemetry.trace_dropped") == 3
    assert _counter("request.records") == 7
    rq.reset()
    assert rq.REQUESTS.dropped == 0
    assert rq.REQUESTS._ring_limit == rq.DEFAULT_RING_LIMIT


def test_tracer_buffer_overflow_evicts_oldest_and_counts_drops():
    telemetry.configure(buffer_limit=4)
    now = trace.TRACER.now()
    for i in range(10):
        assert isinstance(trace.TRACER.emit(f"s{i}", ts=now, dur=0.001), int)
    assert [s.name for s in trace.finished_spans()] == ["s6", "s7", "s8", "s9"]
    assert trace.TRACER.dropped_spans == 6
    assert _counter("trace.dropped_spans") == 6


def test_disabled_tracer_records_nothing():
    rq.configure(enabled=False)
    assert rq.begin("x") is None
    assert rq.finish(None) is None
    assert rq.records() == []
    rq.configure(enabled=True)
    assert rq.begin("x") is not None


def test_rolling_p99_threshold_engages_after_min_samples():
    assert rq.REQUESTS.slow_threshold_ms is None
    for _ in range(128):
        rq.finish(rq.begin("x"))
    assert rq.REQUESTS.slow_threshold_ms is not None


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def test_flight_path_naming_contract(monkeypatch):
    assert rq.flight_path("/x", 3) == "/x/flight-proc-3.json"
    monkeypatch.setenv("PHOTON_PROC_ID", "2")
    assert rq.flight_path("/x").endswith("flight-proc-2.json")
    assert fleet_report._FLIGHT_RE.match("flight-proc-3.json")
    assert not fleet_report._FLIGHT_RE.match("flight-proc-3.json.tmp")


def _flight_doc(pkg, path):
    doc = pkg.read_flight(path)
    for key in ("written", "anchor_unix_s", "monotonic_anchor"):
        doc.pop(key)
    for r in doc["records"]:
        r.pop("trace_id")
        r.pop("request_id")
    return doc


def test_flight_dump_read_roundtrip(tmp_path, clock):
    for pkg, sub in ((rq, "t"), (j_rq, "j")):
        clock.t = 10.0
        for i in range(5):
            rec = pkg.begin(f"r{i}")
            clock.t += 0.25
            pkg.finish(rec)
        os.makedirs(tmp_path / sub)
        assert pkg.flight_dump(str(tmp_path / sub / "flight-proc-0.json")) == 5
        # the window: records that ended within the last 0.6 s
        assert pkg.flight_dump(str(tmp_path / sub / "w.json"), last_s=0.6) == 3
    doc = _flight_doc(rq, str(tmp_path / "t" / "flight-proc-0.json"))
    assert doc == _flight_doc(j_rq, str(tmp_path / "j" / "flight-proc-0.json"))
    assert doc["type"] == "flight_record" and doc["window_s"] == 30.0 and doc["dropped"] == 0
    assert [r["name"] for r in doc["records"]] == [f"r{i}" for i in range(5)]
    assert rq.read_flight(str(tmp_path / "missing.json")) is None
    (tmp_path / "torn.json").write_text('{"type": "flight_record", "rec')
    assert rq.read_flight(str(tmp_path / "torn.json")) is None
    (tmp_path / "other.json").write_text('{"type": "metrics"}')
    assert rq.read_flight(str(tmp_path / "other.json")) is None


def test_flight_dump_fault_seam_fails_soft(tmp_path):
    rq.finish(rq.begin("x"))
    faults.install_plan(faults.FaultPlan([faults.FaultRule("telemetry.flight_dump",
                                                           action="io", nth=1)]))
    path = str(tmp_path / "flight-proc-0.json")
    assert rq.flight_dump(path) is None
    assert _counter("telemetry.flight_dump_failures") == 1
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")
    faults.clear_plan()
    assert rq.flight_dump(path) == 1
    assert rq.read_flight(path)["records"][0]["name"] == "x"


def _span_stream(path, n=50, torn='{"type": "span", "na'):
    header = {"type": "trace_header", "anchor_unix_s": 123.0, "monotonic_anchor": 5.0,
              "hostname": "h", "process_index": 1}
    lines = [json.dumps(header)]
    for i in range(n):
        lines.append(json.dumps({"type": "span", "name": f"s{i}", "ts": float(i) * 2.0,
                                 "dur": 0.001, "attrs": {"pad": "x" * 64}}))
    path.write_text("\n".join(lines) + "\n" + torn)


@pytest.mark.parametrize("max_tail_bytes", [256 * 1024, 400, 2000])
def test_tail_records_drops_torn_first_and_last_lines(tmp_path, max_tail_bytes):
    path = tmp_path / "trace.proc-0.jsonl"
    _span_stream(path)
    got = rq.tail_records(str(path), max_tail_bytes)
    assert got == j_rq.tail_records(str(path), max_tail_bytes)
    hdr, recs = got
    assert hdr["type"] == "trace_header"
    assert recs[-1]["name"] == "s49"
    assert all(isinstance(r, dict) for r in recs)
    if max_tail_bytes > 100_000:
        assert len(recs) == 51  # the header line parses as a record too
    else:
        assert 0 < len(recs) < 20


def test_harvest_flight_windows_and_anchors(tmp_path):
    path = tmp_path / "trace.proc-1.jsonl"
    _span_stream(path)
    docs = []
    for pkg, out in ((rq, "t.json"), (j_rq, "j.json")):
        assert pkg.harvest_flight(str(path), str(tmp_path / out), last_s=10.0) == 6
        docs.append(pkg.read_flight(str(tmp_path / out)))
    assert docs[0] == docs[1]
    assert docs[0]["harvested"] is True and docs[0]["process_index"] == 1
    assert docs[0]["anchor_unix_s"] == 123.0
    assert [r["name"] for r in docs[0]["records"]] == [f"s{i}" for i in range(44, 50)]
    missing_out = str(tmp_path / "flight-proc-2.json")
    assert rq.harvest_flight(str(tmp_path / "nope.jsonl"), missing_out) is None
    assert not os.path.exists(missing_out)


# ---------------------------------------------------------------------------
# the fleet join: one request across router and members
# ---------------------------------------------------------------------------


def _build_fleet_dir(tmp_path, monkeypatch):
    """A 2-member fleet directory (the port's tracer writing it) carrying
    one sampled, fanned-out request; member 1 dies (no metrics snapshot, a
    torn trace tail) and gets a harvested flight record."""
    d = tmp_path / "fleet"
    d.mkdir(exist_ok=True)
    monkeypatch.delenv("PHOTON_PROC_ID", raising=False)
    monkeypatch.setenv("PHOTON_PROC_COUNT", "2")
    telemetry.configure(trace_out=str(d / "trace.router.jsonl"))
    ctx = rq.make_context(sampled=True)
    rec = rq.begin("route", ctx=ctx, role="router", fleet_size=2)
    rec.phase("fanout", 2.0)
    rq.finish(rec)
    monkeypatch.setenv("PHOTON_PROC_ID", "0")
    telemetry.configure(trace_out=telemetry.member_artifact_path(str(d / "trace.jsonl")))
    rec = rq.begin("margins", ctx=ctx, role="member", version="v1", fleet_size=2)
    rec.phase("engine_dispatch", 1.5)
    rq.finish(rec)
    (d / "telemetry.proc-0.jsonl").write_text(
        json.dumps({"type": "metrics", "snapshot": {"counters": {}}}) + "\n")
    monkeypatch.setenv("PHOTON_PROC_ID", "1")
    m1 = telemetry.member_artifact_path(str(d / "trace.jsonl"))
    telemetry.configure(trace_out=m1)
    rec = rq.begin("margins", ctx=ctx, role="member", version="v1", fleet_size=2)
    rec.phase("engine_dispatch", 1.1)
    rq.finish(rec)
    telemetry.configure(trace_out=str(tmp_path / "scratch.jsonl"))
    with open(m1, "a", encoding="utf-8") as fh:
        fh.write('{"type": "span", "torn')  # a hard kill mid-write
    assert rq.harvest_flight(m1, rq.flight_path(str(d), 1)) is not None
    monkeypatch.delenv("PHOTON_PROC_ID", raising=False)
    return d, ctx


def test_fleet_report_joins_one_request_across_processes(tmp_path, monkeypatch):
    d, ctx = _build_fleet_dir(tmp_path, monkeypatch)
    fr = fleet_report.FleetReport.load(str(d))
    jfr = j_fleet_report.FleetReport.load(str(d))
    assert [m.process_index for m in fr.members] == [0, 1]
    assert fr.router is not None and fr.router.process_index == -1
    assert fr.router_trace_path.endswith("trace.router.jsonl")
    traces = fr.request_traces()
    assert traces == jfr.request_traces()
    (t,) = [t for t in traces if t["trace_id"] == ctx.trace_id]
    assert t["sources"] == ["proc-0", "proc-1", "router"] and t["status"] == "ok"
    by_source = {h["source"]: h for h in t["hops"]}
    assert by_source["router"]["phases"] == {"fanout": 2.0}
    for proc in ("proc-0", "proc-1"):
        assert by_source[proc]["phases"]
        assert by_source[proc]["attrs"]["version"] == "v1"
        assert by_source[proc]["attrs"]["fleet_size"] == 2
    assert len(t["hops"]) == 3  # the harvested flight adds no second hop


def test_fleet_report_last_words_for_lost_member(tmp_path, monkeypatch):
    d, _ctx = _build_fleet_dir(tmp_path, monkeypatch)
    fr = fleet_report.FleetReport.load(str(d))
    jfr = j_fleet_report.FleetReport.load(str(d))
    assert fr.lost_members() == [1]
    m1 = fr.members[1]
    assert m1.flight is not None and m1.flight.get("harvested")
    assert m1.flight_path.endswith("flight-proc-1.json")
    md = fr.to_markdown()
    assert md == jfr.to_markdown()
    for section in ("## Flight recorder", "Last words — member 1", "## Requests", "router"):
        assert section in md
    doc, jdoc = fr.to_json(), jfr.to_json()
    doc.pop("generated")
    jdoc.pop("generated")
    assert doc == jdoc
    assert doc["request_traces"] and doc["router_trace"] == fr.router_trace_path


def test_fleet_chrome_export_merges_member_tracks(tmp_path, monkeypatch):
    d, _ctx = _build_fleet_dir(tmp_path, monkeypatch)
    tc = telemetry.to_chrome_trace(str(d))
    assert tc == j_telemetry.to_chrome_trace(str(d))
    names = {e["args"]["name"]: e["pid"] for e in tc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert any(k.startswith("proc-0") for k in names)
    assert any(k.startswith("proc-1") for k in names)
    assert len(set(names.values())) == 2
    assert any(e.get("ph") == "X" and e["name"].startswith("request:")
               for e in tc["traceEvents"])
    out = str(tmp_path / "fleet.perfetto.json")
    telemetry.export_chrome_trace(str(d), out)
    with open(out, encoding="utf-8") as fh:
        assert json.load(fh)["traceEvents"]


# ---------------------------------------------------------------------------
# RunReport and cli report --requests
# ---------------------------------------------------------------------------


def _build_run_artifacts(tmp_path):
    tpath = str(tmp_path / "run.trace.jsonl")
    mpath = str(tmp_path / "run.metrics.jsonl")
    telemetry.configure(trace_out=tpath)
    rec = rq.begin("score", ctx=rq.make_context(sampled=True))
    rec.phase("batcher_wait", 3.0)
    rq.finish(rec)
    rq.finish(rq.begin("score"), status="error", error="boom")
    rq.finish(rq.begin("score"))  # the ring only
    telemetry.flush_metrics(mpath)
    return tpath, mpath


def test_run_report_requests_summary_and_slowest(tmp_path):
    tpath, mpath = _build_run_artifacts(tmp_path)
    run = RunReport.load(trace=tpath, telemetry=mpath)
    jrun = JRunReport.load(trace=tpath, telemetry=mpath)
    rs = run.requests_summary()
    assert rs == jrun.requests_summary()
    assert (rs["records"], rs["persisted"], rs["dropped"]) == (3, 2, 0)
    assert rs["p99_ms"] is not None and rs["phases"]["batcher_wait"]["count"] == 1
    slow = run.slowest_requests()
    assert slow == jrun.slowest_requests()
    assert {r["sampled_reason"] for r in slow} == {"sampled", "error"}
    assert all(r["trace_id"] for r in slow)
    assert run._requests_markdown() == jrun._requests_markdown()
    md = run.to_markdown()
    assert "## Requests" in md and "persisted by tail sampling" in md
    assert run.to_json()["requests"]["records"] == 3


def test_run_report_without_requests_has_no_section():
    run = RunReport(spans=[], snapshot={"counters": {"x": 1}})
    assert run.requests_summary() is None
    assert "## Requests" not in run.to_markdown()


def test_cli_report_requests_flag(tmp_path, capsys):
    tpath, mpath = _build_run_artifacts(tmp_path)
    argv = ["--trace", tpath, "--telemetry", mpath, "--requests", "5"]
    assert cli_report.main(argv) == 0
    out = capsys.readouterr().out
    assert j_cli_report.main(argv) == 0
    assert out == capsys.readouterr().out
    assert "## Requests" in out and "Slowest persisted traces" in out
    # a run with no request records says so instead of an empty report
    empty = str(tmp_path / "empty.trace.jsonl")
    telemetry.reset()
    telemetry.configure(trace_out=empty)
    telemetry.configure(trace_out=str(tmp_path / "scratch2.jsonl"))
    assert cli_report.main(["--trace", empty, "--requests"]) == 0
    assert "No request traces" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the batcher's records against the JAX batcher's
# ---------------------------------------------------------------------------


def test_batcher_records_match_the_jax_batcher():
    """One ``score`` record a unit in both packages' ``MicroBatcher``: the
    caller's context kept (a sampled one persisted), the queue wait and the
    dispatch phases, the version and batch rows, a failing unit's error."""
    from photon_ml_tpu.serving.batcher import MicroBatcher as JBatcher
    from photon_ml_tpu_torch.serving.batcher import MicroBatcher

    def scorer(rows):
        return [float(r["x"]) for r in rows], "v7"

    for cls, pkg in ((MicroBatcher, rq), (JBatcher, j_rq)):
        b = cls(scorer, max_batch=8, max_delay_ms=1.0).start()
        try:
            ctx = pkg.TraceContext("tid", "rid", sampled=True)
            assert b.submit([{"x": 1}, {"x": 2}], ctx=ctx).result(5)["scores"] == [1.0, 2.0]
            b.submit([{"x": 3}]).result(5)
            with pytest.raises(ValueError):
                b.submit([{"x": "bad"}]).result(5)
        finally:
            b.stop()

    def shape(records):
        return [(r["name"], r["role"], r["status"], [p["name"] for p in r["phases"]],
                 r["attrs"], r.get("error"), r["trace_id"] == "tid") for r in records]

    assert shape(rq.records()) == shape(j_rq.records())
    assert [r["status"] for r in rq.records()] == ["ok", "ok", "error"]
    roots = {s.attrs["trace_id"]: s.attrs["sampled_reason"]
             for s in trace.finished_spans("request:score")}
    assert roots["tid"] == "sampled" and sorted(roots.values()) == ["error", "sampled"]
