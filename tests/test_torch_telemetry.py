"""The port's span tree, trace sink and Chrome export
(``photon_ml_tpu_torch.telemetry``) against the JAX package's, case for case
with tests/test_telemetry.py's trace and sink tests (its lines 28-215), its
``sync_fetch`` case (323) and its ``configure_from_env`` reset (622):

- nesting and attributes, events on the current span, per-thread roots,
  the JSONL sink and its Chrome export, the stale-file truncation, a reset
  clearing another thread's open span, an out-of-order exit, the counted
  buffer overflow, the open path seen from another thread, one Chrome lane
  per thread;
- parity: one span program (nested spans with attributes and events, a
  worker thread) runs through both packages' tracers into JSONL sinks; the
  records and the exported Chrome events are equal but for times and ids;
  a fleet directory's merged Chrome export equals the JAX package's;
- ``sync_fetch`` on a tensor: the fetch counters and the ``device_fetch``
  event, beside the port's ``host_syncs``;
- ``reset()`` undoing ``configure_from_env`` (the exit flush, the sink) and
  an injected memory-stats provider;
- ``span_seconds`` totals surviving the buffer's drops;
- the span tree under contention: more threads than cores, a short switch
  interval, every span kept and parented within its own thread;
- the span annotation mirror (``set_annotation_factory``, ``cli
  profile``'s ranges): the same enters and exits as the JAX package's.

Tolerances: none; the compared fields are exact.
"""

import json
import threading

import numpy as np
import pytest
import torch

from photon_ml_tpu import telemetry as j_telemetry
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.telemetry import trace as ttrace


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


# -- spans -------------------------------------------------------------------


def test_span_tree_nesting_and_attrs():
    with telemetry.span("outer", phase="x") as outer:
        with telemetry.span("inner") as inner:
            inner.set_attr(k=1)
        assert inner.parent_id == outer.span_id
    spans = {s.name: s for s in telemetry.finished_spans()}
    assert spans["outer"].parent_id is None
    assert spans["outer"].dur is not None and spans["outer"].dur >= 0
    assert spans["inner"].attrs == {"k": 1}
    assert spans["outer"].attrs == {"phase": "x"}
    assert spans["inner"].ts >= spans["outer"].ts


def test_span_events_attach_to_current_span():
    telemetry.add_event("orphan")  # no open span: a silent no-op
    with telemetry.span("s"):
        telemetry.add_event("marker", code=7)
    (s,) = telemetry.finished_spans("s")
    assert [e["name"] for e in s.events] == ["marker"]
    assert s.events[0]["attrs"] == {"code": 7}


def test_spans_are_per_thread_roots():
    done = threading.Event()

    def worker():
        with telemetry.span("worker_root"):
            pass
        done.set()

    with telemetry.span("main_root"):
        t = threading.Thread(target=worker, name="w0")
        t.start()
        t.join()
    assert done.wait(1)
    (w,) = telemetry.finished_spans("worker_root")
    assert w.parent_id is None
    assert w.thread == "w0"


def test_jsonl_sink_and_chrome_export(tmp_path):
    out = tmp_path / "trace.jsonl"
    telemetry.configure(trace_out=str(out))
    with telemetry.span("fit"):
        with telemetry.span("step"):
            telemetry.add_event("device_fetch", bytes=4)
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines[0]["type"] == "trace_header"
    spans = [x for x in lines if x["type"] == "span"]
    assert [s["name"] for s in spans] == ["step", "fit"]  # close order
    assert spans[0]["parent"] == spans[1]["id"]

    perfetto = tmp_path / "trace.json"
    n = telemetry.export_chrome_trace(str(out), str(perfetto))
    doc = json.loads(perfetto.read_text())
    events = doc["traceEvents"]
    assert n == len(events)
    complete = [e for e in events if e["ph"] == "X"]
    instants = [e for e in events if e["ph"] == "i"]
    assert {e["name"] for e in complete} == {"fit", "step"}
    assert instants[0]["name"] == "device_fetch"
    assert all(e["ts"] >= 0 for e in events if "ts" in e)
    assert telemetry.perfetto_path(str(out)) == str(tmp_path / "trace.perfetto.json")


def test_configure_truncates_stale_trace_file(tmp_path):
    out = tmp_path / "trace.jsonl"
    out.write_text('{"type": "span", "name": "stale_run"}\n')
    telemetry.configure(trace_out=str(out))
    with telemetry.span("fresh"):
        pass
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines[0]["type"] == "trace_header"
    assert [x["name"] for x in lines if x["type"] == "span"] == ["fresh"]


def test_reset_clears_other_threads_open_spans():
    leaked = threading.Event()
    release = threading.Event()

    def worker():
        cm = ttrace.TRACER.span("leaked_parent")
        cm.__enter__()
        leaked.set()
        release.wait(5)
        with ttrace.TRACER.span("post_reset"):
            pass

    t = threading.Thread(target=worker, name="leaky")
    t.start()
    assert leaked.wait(5)
    telemetry.reset()  # must clear the worker's open stack too
    release.set()
    t.join()
    (post,) = telemetry.finished_spans("post_reset")
    assert post.parent_id is None


def test_tracer_survives_out_of_order_exit():
    tr = ttrace.Tracer()
    outer_cm = tr.span("outer")
    outer_cm.__enter__()
    inner_cm = tr.span("inner")
    inner_cm.__enter__()
    outer_cm.__exit__(None, None, None)  # a leaked inner span
    assert tr.current() is None
    with tr.span("next"):
        pass
    assert {s.name for s in tr.finished_spans()} >= {"outer", "next"}


def test_tracer_counts_dropped_spans_on_buffer_overflow():
    ttrace.TRACER.configure(buffer_limit=5)
    for i in range(12):
        with telemetry.span(f"s{i}"):
            pass
    assert len(telemetry.finished_spans()) == 5
    assert ttrace.TRACER.dropped_spans == 7
    assert telemetry.snapshot()["counters"]["trace.dropped_spans"] == 7
    # the per-name totals are not the buffer: every span still counts
    assert set(telemetry.snapshot()["span_seconds"]) == {f"s{i}" for i in range(12)}
    telemetry.reset()
    assert ttrace.TRACER._buffer_limit == ttrace.DEFAULT_BUFFER_LIMIT
    assert ttrace.TRACER.dropped_spans == 0
    assert telemetry.snapshot()["span_seconds"] == {}


def test_active_span_path_visible_from_other_thread():
    seen = {}
    ready = threading.Event()
    release = threading.Event()

    def watcher():
        ready.wait(5)
        seen["path"] = telemetry.active_span_path()
        release.set()

    t = threading.Thread(target=watcher, name="watcher")
    t.start()
    with telemetry.span("fit"):
        with telemetry.span("coordinate:x"):
            ready.set()
            assert release.wait(5)
    t.join()
    assert seen["path"] == "fit > coordinate:x"
    assert telemetry.active_span_path() == ""


def test_to_chrome_trace_multi_thread_spans():
    barrier = threading.Barrier(3)

    def worker():
        barrier.wait(5)
        with telemetry.span("work"):
            telemetry.add_event("tick")

    threads = [threading.Thread(target=worker, name=f"w{i}") for i in range(2)]
    for t in threads:
        t.start()
    with telemetry.span("main_work"):
        barrier.wait(5)
    for t in threads:
        t.join()
    records = [s.to_dict() for s in telemetry.finished_spans()]
    doc = telemetry.to_chrome_trace(records)
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    lanes = {e["args"]["name"]: e["tid"] for e in meta}
    assert {"w0", "w1", "MainThread"} <= set(lanes)
    assert len(set(lanes.values())) == len(lanes)
    by_name = {}
    for e in events:
        if e["ph"] in ("X", "i"):
            by_name.setdefault(e["name"], set()).add(e["tid"])
    assert by_name["work"] == {lanes["w0"], lanes["w1"]}
    assert by_name["tick"] == {lanes["w0"], lanes["w1"]}
    assert by_name["main_work"] == {lanes["MainThread"]}


def test_span_tree_stays_per_thread_under_contention():
    """More threads than cores, each opening nested spans with a short
    switch interval: every span is kept, every child's parent is its own
    thread's outer span, and the per-name totals count every span."""
    import os
    import sys

    n_threads, rounds = max(8, 2 * (os.cpu_count() or 1)), 200
    errors = []

    def worker(k):
        try:
            for i in range(rounds):
                with telemetry.span("outer", k=k, i=i) as outer:
                    with telemetry.span("inner", k=k, i=i) as inner:
                        telemetry.add_event("tick", k=k)
                    if inner.parent_id != outer.span_id:
                        errors.append((k, i))
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,), name=f"t{k}")
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    spans = telemetry.finished_spans()
    assert len(spans) == 2 * n_threads * rounds
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            parent = by_id[s.parent_id]
            assert parent.name == "outer" and parent.thread == s.thread
            assert parent.attrs == s.attrs
        else:
            assert s.parent_id is None
    assert set(telemetry.snapshot()["span_seconds"]) == {"outer", "inner"}
    assert telemetry.active_span_path() == ""


def test_fleet_directory_export_is_refused_naming_its_slice(tmp_path):
    """A fleet directory's Chrome export (once refused) merges the members'
    streams: one Perfetto process per member, each member's spans on the
    fleet's absolute timebase, equal to the JAX package's export of the
    same directory."""
    for proc, anchor in ((0, 1000.0), (1, 1002.0)):
        with open(tmp_path / f"trace.proc-{proc}.jsonl", "w") as fh:
            fh.write(json.dumps({"type": "trace_header", "monotonic_anchor": 5.0,
                                 "anchor_unix_s": anchor, "hostname": f"host{proc}",
                                 "process_index": proc, "num_processes": 2}) + "\n")
            fh.write(json.dumps({"type": "span", "id": 1, "parent": None, "name": "fit",
                                 "ts": 6.0 + proc, "dur": 1.5, "thread": "MainThread",
                                 "attrs": {}, "events": [{"name": "device_fetch", "ts": 6.5,
                                                          "attrs": {}}]}) + "\n")
    doc = telemetry.to_chrome_trace(str(tmp_path))
    assert doc == j_telemetry.to_chrome_trace(str(tmp_path))
    procs = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    assert procs == {"proc-0 (host0)": 1, "proc-1 (host1)": 2}
    fits = {e["pid"]: e["ts"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    # absolute starts 1001 and 1004 s: the origin is the earliest
    assert fits == {1: 0.0, 2: 3e6}
    out = str(tmp_path / "x.json")
    assert telemetry.export_chrome_trace(str(tmp_path), out) == len(doc["traceEvents"])
    with open(out) as fh:
        assert json.load(fh) == doc


# -- parity with the JAX package ----------------------------------------------


def _span_program(pkg, worker_name):
    """Nested spans with attributes and events on the main thread, and a
    root span with an event on a worker thread, in a fixed order."""
    with pkg.span("fit", task="logistic", num_coordinates=2):
        with pkg.span("cd_iteration", iteration=0):
            for name in ("fixed", "perUser"):
                with pkg.span(f"coordinate:{name}", iteration=0) as sp:
                    pkg.add_event("device_fetch", label=name, bytes=4)
                    sp.set_attr(seconds=0.5)
        t = threading.Thread(target=lambda: _worker(pkg), name=worker_name)
        t.start()
        t.join()
    with pkg.span("checkpoint:save", step=1):
        pass


def _worker(pkg):
    with pkg.span("ingest:decode", chunk=3):
        pkg.add_event("stall", seconds=0.0)


_TIMES = {"ts", "dur", "id", "parent"}


def _normalized(records):
    """Records without times and ids, with each span's parent as its name."""
    by_id = {r["id"]: r["name"] for r in records if r.get("type") == "span"}
    out = []
    for r in records:
        if r.get("type") != "span":
            continue
        d = {k: v for k, v in r.items() if k not in _TIMES}
        d["parent_name"] = by_id.get(r["parent"])
        d["events"] = [{k: v for k, v in e.items() if k != "ts"} for e in r["events"]]
        out.append(d)
    return out


def _chrome_normalized(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in doc["traceEvents"]]


def test_span_program_records_and_chrome_events_match_the_jax_package(tmp_path):
    j_telemetry.reset()
    try:
        j_out, t_out = tmp_path / "j.trace.jsonl", tmp_path / "t.trace.jsonl"
        j_telemetry.configure(trace_out=str(j_out))
        telemetry.configure(trace_out=str(t_out))
        _span_program(j_telemetry, "worker")
        _span_program(telemetry, "worker")
        j_lines = [json.loads(x) for x in j_out.read_text().splitlines()]
        t_lines = [json.loads(x) for x in t_out.read_text().splitlines()]
        # the headers carry the same fields (the wall clock and anchors differ)
        assert j_lines[0].keys() == t_lines[0].keys()
        assert t_lines[0]["type"] == "trace_header"
        assert _normalized(t_lines) == _normalized(j_lines)
        assert len(_normalized(t_lines)) == 6
        # the live buffers hold the same records
        assert _normalized([s.to_dict() for s in telemetry.finished_spans()]) == \
            _normalized([s.to_dict() for s in j_telemetry.finished_spans()])
        j_n = j_telemetry.export_chrome_trace(str(j_out), str(tmp_path / "j.json"))
        t_n = telemetry.export_chrome_trace(str(t_out), str(tmp_path / "t.json"))
        assert t_n == j_n
        t_doc = json.loads((tmp_path / "t.json").read_text())
        j_doc = json.loads((tmp_path / "j.json").read_text())
        assert _chrome_normalized(t_doc) == _chrome_normalized(j_doc)
        assert t_doc["displayTimeUnit"] == j_doc["displayTimeUnit"]
    finally:
        j_telemetry.reset()


# -- the sanctioned fetch -----------------------------------------------------


def test_sync_fetch_counts_fetches_bytes_and_span_event():
    x = torch.arange(8, dtype=torch.float32)
    with telemetry.span("host"):
        out = telemetry.sync_fetch(x, label="t")
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.arange(8, dtype=np.float32))
    snap = telemetry.snapshot()
    assert snap["counters"]["device_fetches"] == 1
    assert snap["counters"]["device_fetch_bytes"] == 32
    assert snap["counters"]["device_fetch_seconds"] >= 0
    assert snap["counters"]["host_syncs"] == 1
    assert snap["counters"]["host_sync_bytes"] == 32
    (s,) = telemetry.finished_spans("host")
    assert s.events and s.events[0]["name"] == "device_fetch"
    assert s.events[0]["attrs"]["bytes"] == 32
    assert s.events[0]["attrs"]["label"] == "t"


# -- reset / env configuration ------------------------------------------------


def test_reset_restores_configure_from_env_state(tmp_path, monkeypatch):
    import atexit

    metrics_out = tmp_path / "env.metrics.jsonl"
    trace_out = tmp_path / "env.trace.jsonl"
    monkeypatch.setenv("PHOTON_TELEMETRY_OUT", str(metrics_out))
    monkeypatch.setenv("PHOTON_TRACE_OUT", str(trace_out))
    telemetry.configure_from_env()
    flush = telemetry._env_state["atexit_flush"]
    assert flush is not None
    assert ttrace.TRACER._sink_path == str(trace_out)
    telemetry.configure_from_env()  # replaces, never stacks, the exit flush
    assert telemetry._env_state["atexit_flush"] is not flush

    telemetry.reset()
    assert telemetry._env_state["atexit_flush"] is None
    assert ttrace.TRACER._sink_path is None
    atexit.unregister(flush)

    from photon_ml_tpu_torch.telemetry import memory

    memory.set_stats_provider(lambda: {"bytes_in_use": 1, "bytes_limit": 2})
    assert memory.hbm_stats() == {"bytes_in_use": 1, "bytes_limit": 2}
    telemetry.reset()
    assert memory._stats_provider is None


def test_env_paths_are_suffixed_per_fleet_member(tmp_path, monkeypatch):
    from photon_ml_tpu_torch.telemetry import identity

    monkeypatch.setenv("PHOTON_PROC_ID", "1")
    monkeypatch.setenv("PHOTON_PROC_COUNT", "2")
    monkeypatch.setenv("PHOTON_TRACE_OUT", str(tmp_path / "trace.jsonl"))
    telemetry.configure_from_env()
    assert ttrace.TRACER._sink_path == str(tmp_path / "trace.proc-1.jsonl")
    header = json.loads((tmp_path / "trace.proc-1.jsonl").read_text().splitlines()[0])
    assert header["process_index"] == 1 and header["num_processes"] == 2
    assert identity.member_artifact_path("a/m.jsonl") == "a/m.proc-1.jsonl"
    assert identity.member_artifact_path("a/m.proc-1.jsonl") == "a/m.proc-1.jsonl"
    assert identity.member_artifact_path("a/m", proc=3) == "a/m.proc-3"
    line = telemetry.metrics.flush_jsonl(str(tmp_path / "m.jsonl"))
    assert line is not None
    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert rec["process_index"] == 1 and rec["hostname"] == identity.hostname()
    monkeypatch.delenv("PHOTON_PROC_ID")
    monkeypatch.delenv("PHOTON_PROC_COUNT")
    # outside a fleet, and with torch.distributed not initialized: no identity
    assert identity.fleet_process_index() is None
    assert identity.member_artifact_path("a/m.jsonl") == "a/m.jsonl"


def test_span_annotation_factory_mirrors_spans_like_the_jax_package():
    """``set_annotation_factory`` (``cli profile``'s span mirror): every span
    enters and exits one annotation, in both packages alike; a failing
    annotation never fails its span; a reset drops the mirror."""

    def factory(log):
        class Annotation:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                log.append(("enter", self.name))

            def __exit__(self, *exc):
                log.append(("exit", self.name))

        return Annotation

    logs = {"t": [], "j": []}
    ttrace.set_annotation_factory(factory(logs["t"]))
    j_telemetry.trace.set_annotation_factory(factory(logs["j"]))
    for pkg in (telemetry, j_telemetry):
        with pkg.span("fit"):
            with pkg.span("inner"):
                pass
    j_telemetry.reset()
    assert logs["t"] == logs["j"] == [("enter", "fit"), ("enter", "inner"),
                                      ("exit", "inner"), ("exit", "fit")]
    ttrace.set_annotation_factory(lambda name: 1 / 0)
    with telemetry.span("kept"):
        pass
    assert [s.name for s in telemetry.finished_spans("kept")] == ["kept"]
    telemetry.reset()
    assert ttrace.TRACER._annotation_factory is None
