"""The port's live fleet status (``photon_ml_tpu_torch/parallel/fleet_status.py``),
the seven tests of tests/test_fleet_status.py: snapshot semantics held to
the JAX package's writer on the same files, atomic writes, the
``fleet.status_write`` fault seam (status is observability, never
control), the thread and the HTTP arm, and the members' progress
heartbeats tail-parsed from their telemetry streams into the snapshot.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest

from photon_ml_tpu.parallel.fleet_status import FleetStatusWriter as JWriter
from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.fleet_status import FleetStatusWriter

_SAME_KEYS = ("generation", "num_processes", "deaths", "death_history", "deaths_total",
              "relaunches", "outcome", "alive_members", "type")


def _touch_heartbeat(fleet_dir, pid):
    os.makedirs(fleet_dir, exist_ok=True)
    path = multihost.heartbeat_path(fleet_dir, pid)
    with open(path, "a"):
        os.utime(path, None)


def _both(fleet_dir, **kw):
    return (FleetStatusWriter(fleet_dir=fleet_dir, heartbeat_deadline_s=5.0, **kw),
            JWriter(fleet_dir=fleet_dir, heartbeat_deadline_s=5.0, **kw))


def _agree(port_snap, ref_snap):
    for key in _SAME_KEYS:
        assert port_snap[key] == ref_snap[key], key
    for pid, entry in port_snap["members"].items():
        ref = ref_snap["members"][pid]
        assert {k: entry[k] for k in ("rc", "lost", "alive")} == {
            k: ref[k] for k in ("rc", "lost", "alive")}


def test_snapshot_liveness_from_heartbeat_mtimes(tmp_path):
    fleet_dir = str(tmp_path / "fleet")
    _touch_heartbeat(fleet_dir, 0)
    _touch_heartbeat(fleet_dir, 1)
    past = time.time() - 30.0
    os.utime(multihost.heartbeat_path(fleet_dir, 1), (past, past))
    writer, ref = _both(fleet_dir, num_processes=3)
    snap = writer.snapshot()
    members = snap["members"]
    assert members["0"]["alive"] is True and members["0"]["heartbeat_age_s"] < 5.0
    assert members["1"]["alive"] is False and members["1"]["heartbeat_age_s"] >= 29.0
    assert members["2"]["alive"] is False and members["2"]["heartbeat_age_s"] is None
    assert snap["alive_members"] == [0] and snap["type"] == "fleet_status"
    _agree(snap, ref.snapshot())


def test_snapshot_exited_member_not_alive_and_update_merges(tmp_path):
    fleet_dir = str(tmp_path / "fleet")
    _touch_heartbeat(fleet_dir, 0)
    writer, ref = _both(fleet_dir, num_processes=1)
    for w in (writer, ref):
        w.update(rcs={0: 113}, deaths=[0], generation=1, relaunches=1,
                 death_history=[{"generation": 0, "process_id": 0}])
    snap = writer.snapshot()
    assert snap["members"]["0"]["alive"] is False  # a fresh file does not revive it
    assert snap["members"]["0"]["rc"] == 113 and snap["members"]["0"]["lost"] is True
    assert snap["generation"] == 1 and snap["relaunches"] == 1 and snap["deaths_total"] == 1
    _agree(snap, ref.snapshot())
    for w in (writer, ref):
        w.update(deaths=[], generation=2)
    snap = writer.snapshot()
    assert snap["deaths"] == []
    assert snap["death_history"] == [{"generation": 0, "process_id": 0}]
    assert snap["deaths_total"] == 1
    _agree(snap, ref.snapshot())


def test_snapshot_includes_member_heartbeat_fields(tmp_path):
    """Each member's newest heartbeat line, tail-parsed from its suffixed
    telemetry stream (a line of another ``proc`` and a torn last line are
    skipped), as the JAX package's writer reads the same files; a writer
    without ``telemetry_out`` reports liveness alone."""
    fleet_dir = str(tmp_path / "fleet")
    _touch_heartbeat(fleet_dir, 0)
    _touch_heartbeat(fleet_dir, 1)
    telemetry_out = str(tmp_path / "telemetry.jsonl")
    with open(str(tmp_path / "telemetry.proc-0.jsonl"), "w") as fh:
        fh.write(json.dumps({"type": "heartbeat", "seq": 7, "proc": 0, "rows_per_s": 9.0})
                 + "\n")
        fh.write('{"type": "heartbeat", "seq": 8, "pro')
    with open(str(tmp_path / "telemetry.proc-1.jsonl"), "w") as fh:
        fh.write(json.dumps({"type": "heartbeat", "seq": 3, "proc": 0}) + "\n")
    writer, ref = _both(fleet_dir, num_processes=2, telemetry_out=telemetry_out)
    snap = writer.snapshot()
    hb = snap["members"]["0"]["last_heartbeat"]
    assert hb["seq"] == 7 and hb["rows_per_s"] == 9.0
    assert "last_heartbeat" not in snap["members"]["1"]
    ref_snap = ref.snapshot()
    _agree(snap, ref_snap)
    assert {p: e.get("last_heartbeat") for p, e in snap["members"].items()} == {
        p: e.get("last_heartbeat") for p, e in ref_snap["members"].items()}
    snap = FleetStatusWriter(fleet_dir=fleet_dir, num_processes=1,
                             heartbeat_deadline_s=5.0).snapshot()
    assert "last_heartbeat" not in snap["members"]["0"]


def test_write_once_is_atomic_json(tmp_path):
    fleet_dir = str(tmp_path / "fleet")
    _touch_heartbeat(fleet_dir, 0)
    status_file = str(tmp_path / "status.json")
    writer = FleetStatusWriter(fleet_dir=fleet_dir, num_processes=1, heartbeat_deadline_s=5.0,
                               status_file=status_file)
    telemetry.reset()
    try:
        assert writer.write_once() is not None
        assert json.loads(open(status_file).read())["alive_members"] == [0]
        assert not [n for n in os.listdir(tmp_path) if n.startswith(".") or
                    n.endswith(".tmp")]
        assert telemetry.snapshot()["counters"]["fleet.status_writes"] == 1
    finally:
        telemetry.reset()


def test_status_write_fault_seam_io_is_absorbed(tmp_path):
    """An ``io`` rule at ``fleet.status_write`` is absorbed: write_once returns
    None and counts the error, and the next write succeeds."""
    fleet_dir = str(tmp_path / "fleet")
    _touch_heartbeat(fleet_dir, 0)
    status_file = str(tmp_path / "status.json")
    writer = FleetStatusWriter(fleet_dir=fleet_dir, num_processes=1, heartbeat_deadline_s=5.0,
                               status_file=status_file)
    faults.install_plan(faults.FaultPlan([faults.FaultRule("fleet.status_write", action="io",
                                                           nth=1)]))
    telemetry.reset()
    try:
        assert writer.write_once() is None
        assert not os.path.exists(status_file)
        snap = telemetry.snapshot()["counters"]
        assert snap["fleet.status_write_errors"] == 1
        assert snap["faults.injected.fleet.status_write"] == 1
        assert writer.write_once() is not None
        assert json.loads(open(status_file).read())["alive_members"] == [0]
    finally:
        faults.clear_plan()
        telemetry.reset()


def test_status_writer_thread_and_http_server(tmp_path):
    fleet_dir = str(tmp_path / "fleet")
    _touch_heartbeat(fleet_dir, 0)
    status_file = str(tmp_path / "status.json")
    writer = FleetStatusWriter(fleet_dir=fleet_dir, num_processes=1, heartbeat_deadline_s=5.0,
                               status_file=status_file, port=0, interval_s=0.05)
    with writer:
        assert writer.port
        deadline = time.monotonic() + 5.0
        while not os.path.exists(status_file):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        with urllib.request.urlopen(f"http://127.0.0.1:{writer.port}/statusz",
                                    timeout=5) as resp:
            doc = json.loads(resp.read())
        assert doc["type"] == "fleet_status" and doc["alive_members"] == [0]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{writer.port}/nope", timeout=5)
        writer.update(outcome="complete")
    assert json.loads(open(status_file).read())["outcome"] == "complete"


def test_status_writer_rejects_bad_interval(tmp_path):
    with pytest.raises(ValueError, match="interval_s"):
        FleetStatusWriter(fleet_dir=str(tmp_path), num_processes=1, heartbeat_deadline_s=5.0,
                          interval_s=0.0)
