"""Fleet observability end to end on a real 2-process gloo fleet of the port
(``photon_ml_tpu_torch/tools/fleet.py`` over its small problem, on the CPU),
case for case with tests/test_fleet_observability.py. One supervised run,
shared by the tests, proves the chain:

- each member writes member-suffixed trace and telemetry streams into its
  generation's directory, its identity in the trace header, its progress
  heartbeats and its final metrics snapshot in the telemetry stream;
- the supervisor's live status, polled from the atomic status file while
  the fit runs, shows both members alive with their heartbeat fields;
- ``cli report --fleet`` renders one merged report whose rows, collective
  wait attribution, clock skew and straggler round-trip through JSON, the
  JAX package's ``cli report --fleet`` reads the same directory into the
  same rows, and ``--compare --fail-on-regress`` gates the fleet's key
  metrics (exit 0, then 3).

Member 1 sleeps at every chunk boundary (``chunk_sleep_proc=1``), so it
arrives last at every barrier: the deterministic straggler, whose wait is
about nothing while member 0 stands by.

Tolerances: none; the compared rows are exact.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

from photon_ml_tpu.cli.report import main as j_report_main
from photon_ml_tpu_torch.cli.report import main as report_main
from photon_ml_tpu_torch.tools import fleet


@pytest.fixture(scope="module")
def fleet_obs_run(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("fleet_obs"))
    status_file = os.path.join(workdir, "status.json")
    snapshots: list[dict] = []
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            try:
                with open(status_file, encoding="utf-8") as fh:
                    snapshots.append(json.load(fh))
            except (OSError, ValueError):
                pass  # not written yet
            time.sleep(0.15)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        report = fleet.run_fleet(fleet.FleetSpec(
            workdir=workdir, num_processes=2, device="cpu",
            # the sleep dwarfs the scheduling noise of two workers, the
            # supervisor and the test on a few cores
            chunk_sleep_s=1.25, chunk_sleep_proc=1, progress_heartbeat_every_s=0.4,
            status_file=status_file, status_port=0, status_interval_s=0.25,
            timeout_s=300.0))
    finally:
        stop.set()
        poller.join(timeout=5.0)
    assert report.get("ok"), json.dumps(report, default=str)[:2000]
    return {"report": report, "snapshots": snapshots, "status_file": status_file}


def test_per_member_suffixed_artifacts_with_identity(fleet_obs_run):
    tdir = fleet_obs_run["report"]["telemetry_dir"]
    assert tdir == os.path.join(fleet_obs_run["report"]["workdir"], "telemetry", "gen0")
    names = set(os.listdir(tdir))
    assert {"trace.proc-0.jsonl", "trace.proc-1.jsonl", "telemetry.proc-0.jsonl",
            "telemetry.proc-1.jsonl"} <= names
    assert "trace.jsonl" not in names and "telemetry.jsonl" not in names
    for proc in (0, 1):
        with open(os.path.join(tdir, f"trace.proc-{proc}.jsonl")) as fh:
            header = json.loads(fh.readline())
        assert header["type"] == "trace_header"
        assert (header["process_index"], header["num_processes"]) == (proc, 2)
        assert isinstance(header["anchor_unix_s"], float)
        assert isinstance(header["hostname"], str)
        with open(os.path.join(tdir, f"telemetry.proc-{proc}.jsonl")) as fh:
            lines = [json.loads(line) for line in fh if line.strip()]
        finals = [r for r in lines if r.get("type") == "metrics"]
        assert finals and finals[-1]["process_index"] == proc
        beats = [r for r in lines if r.get("type") == "heartbeat"]
        assert beats and all(b["proc"] == proc for b in beats)


def test_live_status_showed_both_members_alive(fleet_obs_run):
    snapshots = fleet_obs_run["snapshots"]
    assert snapshots, "the status file was never readable during the run"
    both_alive = [s for s in snapshots if s.get("alive_members") == [0, 1]]
    assert both_alive, [s.get("alive_members") for s in snapshots[-5:]]
    with_fields = [s for s in both_alive
                   if all(s["members"][str(p)].get("last_heartbeat", {}).get("proc") == p
                          for p in (0, 1))]
    assert with_fields
    member0 = with_fields[-1]["members"]["0"]
    assert member0["heartbeat_age_s"] < 5.0
    assert member0["last_heartbeat"]["seq"] >= 1
    with open(fleet_obs_run["status_file"]) as fh:
        final = json.load(fh)
    assert final["outcome"] == "complete" and final["deaths"] == []


def test_cli_report_fleet_merges_run_with_straggler(fleet_obs_run, tmp_path, capsys):
    tdir = fleet_obs_run["report"]["telemetry_dir"]
    out_md, out_json = tmp_path / "fleet.md", tmp_path / "fleet.json"
    assert report_main(["--fleet", tdir, "--out", str(out_md), "--json", str(out_json)]) == 0
    doc = json.loads(out_json.read_text())
    assert doc["type"] == "fleet_report" and doc["lost_members"] == []
    rows = {r["process_index"]: r for r in doc["members"]}
    assert set(rows) == {0, 1}
    for row in rows.values():
        assert row["status"] == "ok"
        assert row["collective_wait_s"] is not None and row["collective_wait_calls"] >= 1
        assert row["heartbeats"] >= 1
        assert row["chunks_done"] == fleet.N_CHUNKS
    straggler = doc["straggler"]
    assert straggler is not None and straggler["process_index"] == 1
    assert rows[0]["collective_wait_s"] > rows[1]["collective_wait_s"]
    km = doc["key_metrics"]
    assert km["fleet_collective_wait_s"] > 0
    assert 0 < km["fleet_collective_wait_fraction"] <= 1
    assert km["fleet_lost_members"] == 0
    assert "Straggler: member 1" in out_md.read_text()
    # the JAX package's report of the same directory: the same rows
    j_json = tmp_path / "j.json"
    assert j_report_main(["--fleet", tdir, "--out", str(tmp_path / "j.md"),
                          "--json", str(j_json)]) == 0
    j_doc = json.loads(j_json.read_text())
    assert j_doc["members"] == doc["members"] and j_doc["straggler"] == straggler
    assert j_doc["key_metrics"] == km
    # the fleet's key metrics gate: a self-compare passes, a baseline with a
    # tenth of the wait fraction regresses
    assert report_main(["--fleet", tdir, "--compare", str(out_json), "--fail-on-regress"]) == 0
    worse = dict(km)
    worse["fleet_collective_wait_fraction"] = km["fleet_collective_wait_fraction"] / 10.0
    base = tmp_path / "strict_baseline.json"
    base.write_text(json.dumps({"key_metrics": worse}))
    assert report_main(["--fleet", tdir, "--compare", str(base), "--fail-on-regress"]) == 3
    capsys.readouterr()
