"""The port's device-memory accounting, progress heartbeat, run reports and
``cli report`` (``photon_ml_tpu_torch.telemetry.memory`` / ``.progress`` /
``.report``, ``cli/report.py``) against the JAX package's, case for case
with tests/test_report.py but its JAX-only cases (the ``bench_suite`` gate
and budget; the executable accounting's own cases are in
test_torch_executables.py and test_torch_profile.py):

- memory: no stats on the CPU (None, never 0), the headroom warning before a
  predicted out-of-memory, per-phase peaks, table and batch estimates over
  the port's batch types, the per-device spread;
- the heartbeat: its line, its sink, its sweep and ingest fields, the
  daemon thread, never initializing CUDA;
- reports: the phase tree, ``compare_metrics``, a report loaded from
  artifacts (key metrics, coordinates, markdown, the JSON baseline), the
  sweep, ingestion and recovery sections, ``cli report`` and its exit codes
  (0, 1, 2, 3), its ``--fleet``, ``--requests`` and ``--hot``, an end-to-end fit with sinks and a heartbeat through ``cli
  report --compare --fail-on-regress``;
- parity: identical artifact files (span JSONL, telemetry JSONL, a
  checkpoint directory) into both packages' ``RunReport.load``: equal
  ``to_json()`` but ``generated``, equal markdown; with request and XLA
  metrics in the artifacts the requests sections, Device utilization, Hot
  executables and the ``mfu``/``exec.*``/``xla_recompiles`` key metrics are
  equal too, but for two named lines of text (the port's line on its
  modelled cost, the timing note under the hot table);
- telemetry adds no host sync: a fit with a trace sink, a heartbeat and a
  report makes the same host syncs (and kernel launches) per update as the
  same fit without them; ``sweep_glm``'s config spans ride its one fetch.

Tolerances: the reference test's (exact, or ``pytest.approx`` where it
uses it).
"""

import json
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu import telemetry as j_telemetry
from photon_ml_tpu.telemetry.report import RunReport as JRunReport
from photon_ml_tpu_torch import kernels, telemetry
from photon_ml_tpu_torch.telemetry import memory
from photon_ml_tpu_torch.telemetry.progress import Heartbeat
from photon_ml_tpu_torch.telemetry.report import (
    MetricDelta,
    RunReport,
    build_phase_tree,
    compare_metrics,
    report_path,
)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture
def fake_hbm():
    """A deterministic 16 GB device with 10 GB in use (the CPU has no stats)."""
    memory.set_stats_provider(lambda: {"bytes_in_use": 10 * 2**30, "bytes_limit": 16 * 2**30})
    yield
    memory.set_stats_provider(None)


# -- memory accounting --------------------------------------------------------


def test_hbm_stats_none_on_statless_backend():
    assert memory.hbm_stats() is None
    assert memory.hbm_stats(torch.device("cpu")) is None
    assert memory.check_headroom(2**40, label="huge") is None
    assert memory.record_phase_memory("fit") is None
    assert memory.record_phase_memory("fit", device="cpu") is None
    assert "memory.headroom_warnings" not in telemetry.snapshot()["counters"]


def test_check_headroom_warns_before_predicted_oom(fake_hbm, caplog):
    import logging

    assert memory.check_headroom(2**30, label="small") is True
    with caplog.at_level(logging.WARNING, logger="photon_ml_tpu_torch.telemetry.memory"):
        assert memory.check_headroom(8 * 2**30, label="re chunk") is False
    assert any("re chunk" in r.message for r in caplog.records)
    snap = telemetry.snapshot()
    assert snap["counters"]["memory.headroom_warnings"] == 1
    assert snap["gauges"]["memory.free_bytes"] > 0


def test_record_phase_memory_tracks_peaks(fake_hbm):
    assert memory.record_phase_memory("coordinate:fixed") == 10 * 2**30
    memory.set_stats_provider(lambda: {"bytes_in_use": 12 * 2**30, "bytes_limit": 16 * 2**30})
    memory.record_phase_memory("coordinate:fixed")
    memory.set_stats_provider(lambda: {"bytes_in_use": 6 * 2**30, "bytes_limit": 16 * 2**30})
    memory.record_phase_memory("coordinate:fixed")
    g = telemetry.snapshot()["gauges"]
    assert g["memory.phase.coordinate:fixed.bytes_in_use"] == 6 * 2**30
    assert g["memory.phase.coordinate:fixed.peak_bytes"] == 12 * 2**30
    assert g["memory.bytes_limit"] == 16 * 2**30


def test_estimate_table_and_batch_bytes():
    from photon_ml_tpu.ops.dense import DenseBatch as JDenseBatch
    from photon_ml_tpu.telemetry import memory as j_memory
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.ops.dense import DenseBatch

    assert memory.estimate_table_bytes(1000, 50) == 1000 * 50 * 4
    assert memory.estimate_table_bytes(10, 3, itemsize=8) == 240
    arrays = dict(x=np.zeros((4, 3), np.float32), labels=np.zeros(4, np.float32),
                  offsets=np.zeros(4, np.float32), weights=np.zeros(4, np.float32))
    b = DenseBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    assert memory.estimate_batch_bytes(b) == (4 * 3 + 3 * 4) * 4
    assert memory.estimate_batch_bytes(b) == j_memory.estimate_batch_bytes(JDenseBatch(**arrays))
    # host arrays count what the upload would cost
    assert memory.estimate_batch_bytes(arrays) == (4 * 3 + 3 * 4) * 4
    csr = CSRBatch.from_coo(np.ones(5, np.float32), np.array([0, 0, 1, 2, 3]),
                            np.array([0, 2, 1, 0, 2]), np.ones(4, np.float32), 3,
                            device="cpu")
    assert memory.estimate_batch_bytes(csr) == sum(
        t.numel() * t.element_size() for t in (getattr(csr, f) for f in csr.__dataclass_fields__)
        if isinstance(t, torch.Tensor))


# -- heartbeat ----------------------------------------------------------------


def test_heartbeat_beat_contents(fake_hbm, tmp_path):
    out = tmp_path / "hb.jsonl"
    hb = Heartbeat(interval=60, jsonl_path=str(out))
    telemetry.counter("progress.rows").inc(5000)
    telemetry.counter("progress.coeffs").inc(300)
    telemetry.gauge("checkpoint.last_save_ts").set(telemetry.trace.TRACER.now())
    telemetry.gauge("checkpoint.last_step").set(7)
    with telemetry.span("fit"):
        with telemetry.span("coordinate:perUser"):
            line = hb.beat()
    assert line["type"] == "heartbeat"
    assert line["span"] == "fit > coordinate:perUser"
    assert line["rows_per_s"] > 0 and line["coeffs_per_s"] > 0
    assert line["rows_total"] == 5000
    assert line["hbm_bytes_in_use"] == 10 * 2**30
    assert line["checkpoint_age_s"] >= 0
    assert line["checkpoint_last_step"] == 7
    g = telemetry.snapshot()["gauges"]
    assert g["progress.rows_per_sec"] > 0
    (rec,) = [json.loads(x) for x in out.read_text().splitlines()]
    assert rec["seq"] == 1
    line2 = hb.beat()
    assert line2["rows_per_s"] == 0.0 and line2["seq"] == 2
    # without modelled work, collectives or profiled calls the executable
    # accounting's fields are left out, as in the reference's line
    assert not {"mfu", "comms_fraction", "hot_exec"} & set(line)


def test_heartbeat_line_has_the_jax_packages_fields(tmp_path):
    """One beat of each package over the same registry state: the same
    field names (both on a backend without memory stats)."""
    from photon_ml_tpu.telemetry.progress import Heartbeat as JHeartbeat

    for pkg in (telemetry, j_telemetry):
        pkg.counter("progress.rows").inc(10)
        pkg.counter("solves.retried").inc()
        pkg.gauge("sweep.configs_total").set(4)
        pkg.gauge("checkpoint.last_save_ts").set(pkg.trace.TRACER.now())
    try:
        t_line, j_line = Heartbeat(interval=60).beat(), JHeartbeat(interval=60).beat()
    finally:
        j_telemetry.reset()
    assert set(t_line) == set(j_line)
    assert t_line["guard"] == j_line["guard"]


def test_heartbeat_never_initializes_cuda():
    assert not torch.cuda.is_initialized()
    line = Heartbeat(interval=60).beat()
    assert "hbm_bytes_in_use" not in line  # unknown, never 0
    assert not torch.cuda.is_initialized()


def test_device_spread_from_gauges_and_heartbeat(fake_hbm):
    telemetry.gauge("memory.device.0.bytes_in_use").set(10 * 2**20)
    telemetry.gauge("memory.device.1.bytes_in_use").set(4 * 2**20)
    assert memory.device_spread_bytes() == 6 * 2**20
    assert telemetry.snapshot()["gauges"]["memory.device_spread_bytes"] == 6 * 2**20
    line = Heartbeat(interval=60).beat()
    assert line["hbm_device_spread_bytes"] == 6 * 2**20


def test_device_spread_unknown_with_one_device():
    telemetry.gauge("memory.device.0.bytes_in_use").set(10 * 2**20)
    assert memory.device_spread_bytes() is None
    line = Heartbeat(interval=60).beat()
    assert "hbm_device_spread_bytes" not in line


def test_report_renders_device_spread():
    telemetry.gauge("memory.device.0.bytes_in_use").set(3 * 2**30)
    telemetry.gauge("memory.device.1.bytes_in_use").set(1 * 2**30)
    md = RunReport.from_live().to_markdown()
    assert "spread" in md
    assert "2 devices" in md


def test_heartbeat_daemon_thread_emits_and_stops(tmp_path):
    out = tmp_path / "hb.jsonl"
    hb = Heartbeat(interval=0.02, jsonl_path=str(out))
    with hb:
        deadline = time.monotonic() + 5.0
        while not out.exists() and time.monotonic() < deadline:
            time.sleep(0.005)
    assert out.exists(), "daemon thread never beat"
    n_at_stop = len(out.read_text().splitlines())
    assert n_at_stop >= 1
    time.sleep(0.1)
    assert len(out.read_text().splitlines()) == n_at_stop
    assert hb._thread is None


def test_heartbeat_rejects_bad_interval():
    with pytest.raises(ValueError, match="interval"):
        Heartbeat(interval=0)


def test_heartbeat_sweep_progress_fields():
    line = Heartbeat(interval=60).beat()
    assert "sweep_configs_total" not in line
    telemetry.gauge("sweep.configs_total").set(16)
    telemetry.gauge("sweep.configs_done").set(5)
    line = Heartbeat(interval=60).beat()
    assert line["sweep_configs_total"] == 16
    assert line["sweep_configs_done"] == 5


def test_heartbeat_ingest_fields():
    hb = Heartbeat(interval=60)
    assert "ingest_rows_per_s" not in hb.beat()
    telemetry.counter("ingest.rows").inc(50_000)
    telemetry.gauge("ingest.queue_depth").set(2)
    line = hb.beat()
    assert line["ingest_rows_per_s"] > 0
    assert line["ingest_queue_depth"] == 2
    assert "ingest_stalls" not in line
    telemetry.counter("ingest.stalls").inc()
    assert hb.beat()["ingest_stalls"] == 1


def test_tail_heartbeat_fields_skips_a_truncated_line(tmp_path):
    from photon_ml_tpu_torch.telemetry.progress import tail_heartbeat_fields

    out = tmp_path / "hb.jsonl"
    hb = Heartbeat(interval=60, jsonl_path=str(out))
    hb.beat()
    with open(out, "a") as fh:
        fh.write('{"type": "heartbeat", "seq": 9')
    assert tail_heartbeat_fields(str(out))["seq"] == 1
    assert tail_heartbeat_fields(str(out), expect_proc=0) is None
    assert tail_heartbeat_fields(str(tmp_path / "missing")) is None


# -- report building ----------------------------------------------------------


def _span(id, parent, name, ts, dur, thread="MainThread", **attrs):
    return {"type": "span", "id": id, "parent": parent, "name": name, "ts": ts, "dur": dur,
            "thread": thread, "attrs": attrs, "events": []}


SPANS = [
    _span(1, None, "fit", 0.0, 10.0),
    _span(2, 1, "cd_iteration", 0.5, 4.0),
    _span(3, 2, "coordinate:fixed", 0.5, 2.5),
    _span(4, 2, "coordinate:perUser", 3.0, 1.5),
    _span(5, 1, "cd_iteration", 5.0, 4.5),
    _span(6, 5, "coordinate:fixed", 5.0, 2.0),
    _span(7, 5, "coordinate:perUser", 7.0, 2.5),
]


def test_build_phase_tree_aggregates_by_path():
    root = build_phase_tree(SPANS)
    fit = root.children["fit"]
    assert fit.count == 1 and fit.total_s == 10.0
    cd = fit.children["cd_iteration"]
    assert cd.count == 2 and cd.total_s == pytest.approx(8.5)
    assert cd.children["coordinate:fixed"].total_s == pytest.approx(4.5)
    assert cd.children["coordinate:perUser"].total_s == pytest.approx(4.0)
    assert fit.self_s == pytest.approx(1.5)
    assert cd.self_s == pytest.approx(0.0)


def test_build_phase_tree_orphan_parent_roots_at_survivor():
    root = build_phase_tree(SPANS + [_span(9, 8, "leaked", 9.0, 0.5)])
    assert root.children["leaked"].count == 1


def test_compare_metrics_directions_and_threshold():
    deltas = compare_metrics(
        {"rows_per_sec": 80.0, "jit_compiles": 30.0, "fit_seconds": 95.0},
        {"rows_per_sec": 100.0, "jit_compiles": 20.0, "fit_seconds": 100.0}, threshold=0.2)
    by = {d.metric: d for d in deltas}
    assert not by["rows_per_sec"].regressed
    assert by["jit_compiles"].regressed
    assert not by["fit_seconds"].regressed
    assert compare_metrics({"x": 1.0}, {"x": 0.0}) == []
    assert compare_metrics({"mystery": 1.0}, {"mystery": 2.0}) == []


def _write_basic_artifacts(tmp_path):
    trace = tmp_path / "run.trace.jsonl"
    with open(trace, "w") as fh:
        fh.write(json.dumps({"type": "trace_header"}) + "\n")
        for s in SPANS:
            fh.write(json.dumps(s) + "\n")
        fh.write("{truncated last line")
    tele = tmp_path / "run.metrics.jsonl"
    snapshot = {
        "counters": {"jit_compiles": 12, "jit_compile_seconds": 3.5, "device_fetches": 40,
                     "device_fetch_seconds": 4.2, "trace.dropped_spans": 2,
                     "memory.headroom_warnings": 1},
        "gauges": {"progress.rows_per_sec": 5e5, "progress.coeffs_per_sec": 1e4,
                   "memory.bytes_in_use": 10 * 2**30, "memory.bytes_limit": 16 * 2**30,
                   "memory.phase.coordinate:fixed.peak_bytes": 11 * 2**30},
        "histograms": {"device_fetch_seconds": {"count": 40, "p50": 0.1, "p95": 0.2}},
    }
    with open(tele, "w") as fh:
        fh.write(json.dumps({"type": "heartbeat", "seq": 1, "uptime_s": 30.0, "span": "fit",
                             "rows_per_s": 4e5}) + "\n")
        fh.write(json.dumps({"type": "metrics", "snapshot": snapshot}) + "\n")
    ckpt = tmp_path / "ckpt" / "step-00000003"
    ckpt.mkdir(parents=True)
    (ckpt / "manifest.json").write_text(json.dumps({
        "format_version": 1, "step": 3, "best_metric": 0.71, "frozen": ["perUser"],
        "consecutive_rollbacks": {"perUser": 2},
        "history": [
            {"iteration": 0, "coordinate": "fixed", "seconds": 2.5, "metrics": {"auc": 0.7}},
            {"iteration": 0, "coordinate": "perUser", "seconds": 1.5, "solve_retries": 2,
             "rolled_back": True},
            {"iteration": 1, "coordinate": "fixed", "seconds": 2.0, "metrics": {"auc": 0.71}},
        ],
    }))
    return str(trace), str(tele), str(tmp_path / "ckpt")


def test_run_report_load_merge_and_markdown(tmp_path):
    trace, tele, ckpt = _write_basic_artifacts(tmp_path)
    report = RunReport.load(trace=trace, telemetry=tele, checkpoint_dir=ckpt)
    km = report.key_metrics()
    assert km["fit_seconds"] == 10.0
    assert km["rows_per_sec"] == 5e5
    assert km["jit_compiles"] == 12
    assert km["dropped_spans"] == 2

    by = {c["coordinate"]: c for c in report.coordinate_summary()}
    assert by["fixed"]["steps"] == 2
    assert by["fixed"]["last_metrics"] == {"auc": 0.71}
    assert by["perUser"]["rollbacks"] == 1
    assert by["perUser"]["solve_retries"] == 2
    assert by["perUser"]["frozen"] is True

    md = report.to_markdown()
    assert "- `fit` — n=1" in md
    assert "  - `cd_iteration` — n=2" in md
    assert "    - `coordinate:fixed` — n=2" in md
    assert "    - `coordinate:perUser` — n=2" in md
    assert "`jit_compiles` | 12" in md
    assert "headroom warning" in md
    assert "`coordinate:fixed` | 11.0 GiB" in md
    assert "1 beat(s)" in md
    assert "2 span(s) were dropped" in md

    doc = report.save_json(str(tmp_path / "report.json"))
    assert doc["key_metrics"] == km
    deltas = report.compare(json.load(open(tmp_path / "report.json")), threshold=0.2)
    assert deltas and not any(d.regressed for d in deltas)
    doctored = dict(doc, key_metrics=dict(km, rows_per_sec=km["rows_per_sec"] * 2))
    regressed = [d for d in report.compare(doctored) if d.regressed]
    assert [d.metric for d in regressed] == ["rows_per_sec"]
    assert "**REGRESSED**" in report.to_markdown(deltas=report.compare(doctored))


def test_report_path_sibling():
    assert report_path("x/run.trace.jsonl") == "x/run.trace.report.md"
    assert report_path("run") == "run.report.md"


def test_metric_delta_is_json_safe():
    json.dumps(MetricDelta("m", 1.0, 2.0, -0.5, True).to_dict())


def test_report_without_profiles_has_no_hot_section():
    live = RunReport.from_live()
    assert live.hot_executables() == []
    assert live.device_utilization() is None
    assert live.requests_summary() is None and live.slowest_requests() == []
    md = live.to_markdown()
    assert "## Hot executables" not in md and "## Device utilization" not in md


def test_report_sweep_table_round_trip(tmp_path):
    trace_path = str(tmp_path / "sweep.trace.jsonl")
    tele_path = str(tmp_path / "sweep.metrics.jsonl")
    telemetry.configure(trace_out=trace_path)
    telemetry.gauge("sweep.configs_total").set(3)
    telemetry.gauge("sweep.configs_done").set(3)
    telemetry.gauge("sweep.selected_index").set(1)
    telemetry.gauge("sweep.selected_metric").set(0.81)
    telemetry.counter("sweep.solves").inc(6)
    for g, (lam, iters, reason, metric) in enumerate(
            [(10.0, 12, "FunctionValuesConverged", 0.74), (1.0, 20, "MaxIterations", 0.81),
             (0.1, 18, "GradientConverged", None)]):
        with telemetry.span("sweep_config", index=g, **{"lambda": lam}, iterations=iters,
                            reason=reason, final_loss=100.0 + g, metric=metric,
                            metric_name="auc"):
            pass
    telemetry.flush_metrics(tele_path)

    sweep = RunReport.from_live().sweep_summary()
    assert sweep["configs_total"] == 3
    assert sweep["selected_index"] == 1
    assert [c["index"] for c in sweep["configs"]] == [0, 1, 2]
    assert sweep["configs"][1]["reason"] == "MaxIterations"
    assert sweep["configs"][2]["metric"] is None
    assert sweep["solves"] == 6

    telemetry.reset()
    report = RunReport.load(trace=trace_path, telemetry=tele_path)
    assert report.sweep_summary()["configs"] == sweep["configs"]
    assert report.key_metrics()["sweep_selected_metric"] == 0.81
    md = report.to_markdown()
    assert "## Hyperparameter sweep" in md
    assert "selected config **#1**" in md
    assert "| 0 | 10 | 12 | FunctionValuesConverged |" in md
    assert report.save_json(str(tmp_path / "r.json"))["sweep"]["selected_index"] == 1


def test_report_without_sweep_has_no_section():
    report = RunReport.from_live()
    assert report.sweep_summary() is None
    assert "Hyperparameter sweep" not in report.to_markdown()


def test_report_ingestion_section_round_trip():
    telemetry.counter("ingest.rows").inc(120_000)
    telemetry.counter("ingest.chunks").inc(12)
    telemetry.gauge("ingest.rows_per_sec").set(1.2e6)
    telemetry.gauge("ingest.staging_bytes").set(64 * 2**20)
    live = RunReport.from_live()
    ing = live.ingestion_summary()
    assert ing["rows"] == 120_000 and ing["chunks"] == 12 and ing["solve_waits"] == 0
    md = live.to_markdown()
    assert "## Ingestion" in md and "never waited on data" in md
    assert live.key_metrics()["ingest_rows_per_sec"] == 1.2e6
    assert live.to_json()["ingestion"]["rows"] == 120_000
    telemetry.counter("ingest.solve_waits").inc(5)
    telemetry.histogram("ingest.solve_wait_s").observe_many([0.1] * 5)
    assert "waited on data 5 time(s)" in RunReport.from_live().to_markdown()


def test_report_without_ingest_has_no_section():
    live = RunReport.from_live()
    assert live.ingestion_summary() is None
    assert "## Ingestion" not in live.to_markdown()
    assert "ingest_rows_per_sec" not in live.key_metrics()


def test_report_recovery_section_round_trip():
    telemetry.counter("checkpoint.saves").inc(3)
    telemetry.counter("checkpoint.shard_saves").inc(24)
    telemetry.gauge("checkpoint.max_shard_fetch_bytes").set(5 * 2**20)
    telemetry.counter("checkpoint.restores").inc(1)
    telemetry.counter("checkpoint.corrupt").inc(1)
    telemetry.counter("recovery.elastic_resumes").inc(1)
    telemetry.counter("ingest.read_retries").inc(2)
    telemetry.counter("serving.version_retries").inc(1)
    telemetry.counter("faults.injected").inc(4)
    telemetry.counter("faults.injected.checkpoint.save.before_rename").inc(4)
    live = RunReport.from_live()
    rec = live.recovery_summary()
    assert rec["checkpoint_saves"] == 3 and rec["checkpoint_shard_saves"] == 24
    assert rec["max_shard_fetch_bytes"] == 5 * 2**20
    assert rec["recovery_elastic_resumes"] == 1
    assert rec["faults_injected_by_point"] == {"checkpoint.save.before_rename": 4}
    md = live.to_markdown()
    for text in ("## Recovery", "never the full table", "1 elastic",
                 "corrupt/partial checkpoint(s) skipped",
                 "2 transient-IO retry(ies) absorbed on ingest chunk reads",
                 "deliberately injected", "checkpoint.save.before_rename"):
        assert text in md, text
    assert live.to_json()["recovery"]["checkpoint_restores"] == 1


def test_report_recovery_fleet_rows_round_trip():
    telemetry.counter("recovery.fleet_member_deaths").inc(1)
    telemetry.counter("recovery.fleet_relaunches").inc(1)
    telemetry.counter("checkpoint.peer_manifests").inc(6)
    telemetry.counter("checkpoint.quorum_timeouts").inc(2)
    telemetry.counter("multihost.init_retries").inc(3)
    live = RunReport.from_live()
    rec = live.recovery_summary()
    assert rec["recovery_fleet_member_deaths"] == 1 and rec["checkpoint_peer_manifests"] == 6
    md = live.to_markdown()
    assert "fleet: 1 member death(s), 1 survivor relaunch(es)" in md
    assert "6 per-process manifest(s) written, 2 quorum timeout(s)" in md
    assert "3 distributed-init retry(ies) absorbed" in md


def test_report_without_recovery_activity_has_no_section():
    live = RunReport.from_live()
    assert live.recovery_summary() is None
    assert "## Recovery" not in live.to_markdown()


def test_checkpoint_gauges_ride_the_saves(tmp_path):
    """A step save sets ``checkpoint.last_step`` and ``last_save_ts`` (the
    heartbeat's checkpoint age); a streamed save the largest block fetch."""
    from photon_ml_tpu_torch.game.checkpoint import StreamingCheckpointManager

    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    blocks = StreamingCheckpointManager._write_table(str(tmp_path), "coefficients", table)
    assert blocks[0]["rows"] == 6
    assert telemetry.snapshot()["gauges"]["checkpoint.max_shard_fetch_bytes"] == 48


# -- train CLI wiring ---------------------------------------------------------


def test_train_parse_heartbeat_variants():
    from photon_ml_tpu_torch.cli.train import _parse_heartbeat

    hb = _parse_heartbeat({}, None)
    assert hb is not None and hb.interval == 30.0 and hb.jsonl_path is None
    assert _parse_heartbeat({"heartbeat": False}, None) is None
    assert _parse_heartbeat({"heartbeat": 0}, None) is None
    assert _parse_heartbeat({"heartbeat": None}, None) is None
    assert _parse_heartbeat({"heartbeat": {}}, None).interval == 30.0
    assert _parse_heartbeat({"heartbeat": 10}, None).interval == 10.0
    hb = _parse_heartbeat({"heartbeat": {"every": 5, "out": "hb.jsonl"}}, "m.jsonl")
    assert hb.interval == 5.0 and hb.jsonl_path == "hb.jsonl"
    assert _parse_heartbeat({"heartbeat": {"every": 5}}, "m.jsonl").jsonl_path == "m.jsonl"
    assert _parse_heartbeat({"heartbeat": {"every": 0}}, None) is None
    with pytest.raises(ValueError, match="unknown heartbeat"):
        _parse_heartbeat({"heartbeat": {"interval": 5}}, None)


def test_train_maybe_write_report_from_live(tmp_path):
    from photon_ml_tpu_torch.cli.train import _maybe_write_report

    summary = {}
    _maybe_write_report({}, summary, None, None)
    assert summary == {}
    with telemetry.span("fit"):
        pass
    report_out = tmp_path / "run.report.md"
    _maybe_write_report({"report_out": str(report_out)}, summary, None, None)
    assert summary["report"] == str(report_out)
    assert "- `fit`" in report_out.read_text()
    assert json.loads((tmp_path / "run.report.json").read_text())["type"] == "run_report"


# -- e2e: fit -> report -> compare ---------------------------------------------

_D, _USERS, _PER_USER = 4, 6, 10


def _game():
    """A two-coordinate GLMix problem on the CPU (6 users x 10 rows)."""
    from photon_ml_tpu_torch.game import (
        FeatureShard,
        FixedEffectConfig,
        GameConfig,
        RandomEffectConfig,
        build_game_dataset,
    )
    from photon_ml_tpu_torch.optim.factory import OptimizerConfig

    rng = np.random.default_rng(5)
    n = _USERS * _PER_USER
    X = rng.normal(size=(n, _D))
    users = np.repeat(np.arange(_USERS), _PER_USER)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ rng.normal(size=_D))))).astype(float)
    r, c = np.nonzero(X)
    data = build_game_dataset(response=y, feature_shards={"g": FeatureShard.from_coo(
        X[r, c], r, c, _D)}, id_columns={"userId": np.array([f"u{u}" for u in users])},
        device="cpu")
    opt = OptimizerConfig(max_iterations=5)
    config = GameConfig(task="logistic", num_iterations=2, coordinates={
        "fixed": FixedEffectConfig(shard_name="g", optimizer=opt),
        "perUser": RandomEffectConfig(shard_name="g", id_name="userId", optimizer=opt)})
    return data, config


def test_e2e_fit_report_compare(tmp_path):
    from photon_ml_tpu_torch.cli.report import main as report_main
    from photon_ml_tpu_torch.game import CheckpointSpec, GameEstimator

    data, config = _game()
    trace_out = tmp_path / "run.trace.jsonl"
    tele_out = tmp_path / "run.metrics.jsonl"
    ckpt_dir = tmp_path / "ckpt"
    telemetry.configure(trace_out=str(trace_out))
    with Heartbeat(interval=0.05, jsonl_path=str(tele_out)):
        GameEstimator(config).fit(data, checkpoint_spec=CheckpointSpec(directory=str(ckpt_dir)),
                                  device="cpu")
        time.sleep(0.12)  # a sub-second fit: let the heartbeat beat
    telemetry.flush_metrics(str(tele_out))

    hb_lines = [json.loads(x) for x in tele_out.read_text().splitlines()
                if json.loads(x).get("type") == "heartbeat"]
    assert hb_lines, "no heartbeat lines during the fit"
    assert any(x["rows_total"] > 0 for x in hb_lines)
    snap = telemetry.snapshot()
    assert snap["gauges"]["progress.rows_per_sec"] > 0
    assert snap["counters"]["progress.rows"] == _USERS * _PER_USER * 2 * 2
    assert snap["gauges"]["checkpoint.last_step"] == 3
    assert snap["gauges"]["memory.table_bytes.perUser"] > 0
    # the CPU has no memory stats: no phase gauge, never a fabricated 0
    assert not any(k.startswith("memory.phase.") for k in snap["gauges"])
    telemetry.reset()

    md_path, json_path = tmp_path / "report.md", tmp_path / "report.json"
    assert report_main(["--trace", str(trace_out), "--telemetry", str(tele_out),
                        "--checkpoint-dir", str(ckpt_dir), "--out", str(md_path),
                        "--json", str(json_path)]) == 0
    md = md_path.read_text()
    assert "- `fit` — n=1" in md
    assert "  - `cd_iteration` — n=2" in md
    assert "    - `coordinate:fixed` — n=2" in md
    assert "    - `coordinate:perUser` — n=2" in md
    assert "`build_coordinates`" in md
    assert "## Coordinates" in md and "`perUser` | 2" in md
    assert "## Heartbeats" in md
    assert "## HBM / memory" not in md

    assert report_main(["--trace", str(trace_out), "--telemetry", str(tele_out),
                        "--out", str(tmp_path / "cmp.md"), "--compare", str(json_path),
                        "--fail-on-regress"]) == 0
    doc = json.loads(json_path.read_text())
    assert doc["key_metrics"]["rows_per_sec"] > 0
    doc["key_metrics"]["rows_per_sec"] *= 2.0
    doctored = tmp_path / "doctored.json"
    doctored.write_text(json.dumps(doc))
    assert report_main(["--trace", str(trace_out), "--telemetry", str(tele_out),
                        "--out", str(tmp_path / "cmp2.md"), "--compare", str(doctored),
                        "--fail-on-regress"]) == 3
    assert "**REGRESSED**" in (tmp_path / "cmp2.md").read_text()


def test_cli_report_requires_a_source():
    from photon_ml_tpu_torch.cli.report import main as report_main

    with pytest.raises(SystemExit) as exc:
        report_main([])
    assert exc.value.code == 2


def test_cli_report_bad_baseline(tmp_path):
    from photon_ml_tpu_torch.cli.report import main as report_main

    trace = tmp_path / "t.jsonl"
    trace.write_text("")
    assert report_main(["--trace", str(trace), "--compare", str(tmp_path / "missing.json")]) == 1
    assert report_main(["--trace", str(tmp_path / "missing.jsonl")]) == 1


@pytest.mark.parametrize("flags,item", [(["--fleet", "d"], r"14d \(ii\)"),
                                        (["--requests"], r"14d \(ii\)"),
                                        (["--hot", "3"], r"14d \(iii\)")])
def test_cli_report_refuses_the_later_slices_flags(tmp_path, flags, item, capsys):
    """``--fleet`` and ``--requests`` (refused until 14d (ii)) and ``--hot``
    (refused until 14d (iii)) render; ``--hot`` prints the JAX package's
    table of the same gauges."""
    from photon_ml_tpu.cli.report import main as j_report_main
    from photon_ml_tpu_torch.cli.report import main as report_main

    if item == r"14d \(iii\)":
        tele = tmp_path / "m.jsonl"
        tele.write_text(json.dumps({"type": "metrics", "snapshot": {"gauges": {
            "device.peak_flops": 1e12, "device.peak_hbm_bytes_per_sec": 1e11,
            **{f"profile.exec.{n}.{k}": v for n, excl in (("a", 1.0), ("b", 2.0), ("c", 0.5),
                                                            ("d", 0.1))
               for k, v in (("dispatches", 4), ("est_exclusive_seconds", excl),
                            ("mean_dispatch_seconds", 0.25), ("mfu", 0.02),
                            ("bound_code", 3))}}}}) + "\n")
        outs = []
        for main in (report_main, j_report_main):
            assert main(["--telemetry", str(tele), *flags]) == 0
            outs.append(capsys.readouterr().out)
        assert "## Hot executables" in outs[0] and "## Key metrics" not in outs[0]
        rows = [line for line in outs[0].splitlines() if line.startswith("| `")]
        assert [r.split("`")[1] for r in rows] == ["b", "a", "c"]  # top 3 by excl s
        assert rows == [line for line in outs[1].splitlines() if line.startswith("| `")]
        return
    if flags[0] == "--fleet":
        fleet_dir = tmp_path / flags[1]
        fleet_dir.mkdir()
        (fleet_dir / "telemetry.proc-0.jsonl").write_text(json.dumps(
            {"type": "metrics", "snapshot": {"counters": {"comms.wait_seconds_total": 1.0}}})
            + "\n")
        assert report_main([flags[0], str(fleet_dir)]) == 0
        assert "# Fleet report" in capsys.readouterr().out
        return
    trace = tmp_path / "t.jsonl"
    trace.write_text(json.dumps(_span(1, None, "request:score", 1.0, 0.01, trace_id="t",
                                      request_id="r", status="ok", sampled_reason="sampled",
                                      dur_ms=10.0, phases={"batcher_wait": 2.0})) + "\n")
    tele = tmp_path / "m.jsonl"
    tele.write_text(json.dumps({"type": "metrics", "snapshot": {
        "counters": {"request.records": 3, "request.persisted": 1}}}) + "\n")
    assert report_main(["--trace", str(trace), "--telemetry", str(tele), *flags]) == 0
    out = capsys.readouterr().out
    assert "## Requests" in out and "Slowest persisted traces" in out


# -- parity with the JAX package ----------------------------------------------


def _rich_artifacts(tmp_path, later_slices=False):
    """Artifact files with data for every section the port renders; with
    ``later_slices``, also request and executable (XLA/profiler) metrics."""
    spans = list(SPANS)
    spans[0] = {**spans[0], "events": [{"name": "device_fetch", "ts": 0.2,
                                        "attrs": {"bytes": 4, "seconds": 0.01}}]}
    for g, (lam, reason, metric) in enumerate([(10.0, "MaxIterations", 0.7),
                                               (1.0, "GradientConverged", None)]):
        spans.append(_span(20 + g, None, "sweep_config", 11.0 + g, 0.0, index=g,
                           **{"lambda": lam}, iterations=7 + g, reason=reason,
                           final_loss=50.0 - g, metric=metric, metric_name="auc"))
    spans.append(_span(30, None, "incremental_fit", 12.0, 3.0, base="/ckpt", kind="step",
                       base_digest="ab" * 20, base_step=3, delta_digest="cd" * 20,
                       delta_rows=40, touched_fraction=0.075))
    spans += [_span(31, None, "pipeline.cycle", 15.0, 1.25, cycle=1),
              _span(32, None, "pipeline.cycle", 17.0, 0.5, cycle=3)]
    counters = {
        "device_fetches": 40, "device_fetch_bytes": 160, "device_fetch_seconds": 4.2,
        "trace.dropped_spans": 2, "memory.headroom_warnings": 1,
        "ingest.rows": 120000, "ingest.chunks": 12, "ingest.solve_waits": 3,
        "ingest.stalls": 1, "ingest.read_retries": 2,
        "serving.requests": 100, "serving.scored_rows": 400, "serving.shed": 2,
        "serving.model_swaps": 1, "serving.nearline.applies": 3,
        "serving.nearline.applied_rows": 9, "serving.unseen_entities": 5,
        "checkpoint.saves": 4, "checkpoint.shard_saves": 8, "checkpoint.restores": 1,
        "faults.injected": 1, "faults.injected.checkpoint.save.before_rename": 1,
        "incremental.lanes_solved": 6, "incremental.lanes_skipped": 74,
        "incremental.bucket_solves": 2, "incremental.buckets_skipped": 1,
        "incremental.touched_entities": 3, "incremental.warm_restores": 1,
        "incremental.fits": 1, "incremental.published_versions": 1,
        "pipeline.cycles": 4, "pipeline.idle_cycles": 1, "pipeline.publishes": 1,
        "pipeline.quarantines": 2, "quality.stats_computed": 3, "quality.gate_published": 1,
        "quality.gate_quarantined": 2, "quality.bootstrap_fits": 1, "sweep.solves": 4,
        "solves.rolled_back": 1, "progress.rows": 480,
    }
    gauges = {
        "progress.rows_per_sec": 5e5, "progress.coeffs_per_sec": 1e4,
        "memory.bytes_in_use": 10 * 2**30, "memory.bytes_limit": 16 * 2**30,
        "memory.phase.coordinate:fixed.peak_bytes": 11 * 2**30,
        "memory.phase.coordinate:perUser.peak_bytes": 12 * 2**30,
        "memory.device.0.bytes_in_use": 3 * 2**30, "memory.device.1.bytes_in_use": 2 * 2**30,
        "memory.device.0.peak_bytes": 4 * 2**30,
        "sweep.configs_total": 2, "sweep.configs_done": 2, "sweep.selected_index": 0,
        "sweep.selected_metric": 0.7, "ingest.rows_per_sec": 1.5e6,
        "ingest.staging_bytes": 110231568, "ingest.queue_depth": 2,
        "checkpoint.max_shard_fetch_bytes": 5 * 2**20,
        "incremental.touched_fraction": 0.075,
        "incremental.touched_fraction.perUser": 0.075,
        "incremental.time_to_fresh_s": 2.5,
        "pipeline.event_to_served_staleness_p99_s": 4.25,
    }
    histograms = {
        "device_fetch_seconds": {"count": 40, "p50": 0.1, "p95": 0.2},
        "serving.total_ms": {"count": 100, "p50": 1.5, "p99": 9.25},
        "serving.batch_size": {"count": 25, "mean": 4.0},
        "serving.nearline.update_lag_ms": {"count": 3, "p99": 12.5},
        "ingest.solve_wait_s": {"count": 3, "mean": 0.25},
    }
    quality = {"baseline_version": "v-00000001", "versions": {
        "v-00000001": {"scores": {"count": 400, "mean": 0.42, "std": 0.2},
                       "calibration": {"count": 50, "max_gap": 0.05},
                       "psi_vs_baseline": 0.0}}}
    if later_slices:
        spans.append(_span(40, 2, "glm_value_grad", 0.6, 0.5, xla_flops=2e9, xla_bytes=4e8))
        spans.append(_span(41, None, "request:score", 20.0, 0.02, trace_id="t1",
                           request_id="r1", role="router", status="ok",
                           sampled_reason="slow", dur_ms=20.0, phases={"wait": 5.0}))
        counters.update({"xla.flops_total": 2e9, "xla.bytes_total": 4e8, "xla.recompiles": 2,
                         "comms.bytes_total": 1e6, "xla.exec.solve.calls": 4,
                         "xla.exec.solve.compiles": 1, "xla.exec.solve.recompiles": 1,
                         "request.records": 10, "request.persisted": 1,
                         "jit_compiles": 3, "jit_compile_seconds": 1.5})
        gauges.update({"device.peak_flops": 1e12, "device.peak_hbm_bytes_per_sec": 1e11,
                       "profile.exec.solve.dispatches": 4,
                       "profile.exec.solve.est_exclusive_seconds": 1.6,
                       "profile.exec.solve.mfu": 0.02, "profile.exec.solve.bound_code": 3})
        histograms.update({"request.total_ms": {"count": 10, "p50": 3.0, "p99": 20.0},
                           "request.phase.wait_ms": {"count": 10, "p50": 1.0, "p99": 5.0}})
    trace = tmp_path / "run.trace.jsonl"
    with open(trace, "w") as fh:
        fh.write(json.dumps({"type": "trace_header", "wall_time": "x"}) + "\n")
        for s in spans:
            fh.write(json.dumps(s) + "\n")
    tele = tmp_path / "run.metrics.jsonl"
    with open(tele, "w") as fh:
        for seq in (1, 2):
            fh.write(json.dumps({"type": "heartbeat", "seq": seq, "uptime_s": 30.0 * seq,
                                 "span": "fit > cd_iteration", "rows_per_s": 4e5,
                                 "coeffs_per_s": 2e3}) + "\n")
        fh.write(json.dumps({"type": "metrics", "snapshot": {
            "counters": counters, "gauges": gauges, "histograms": histograms,
            "quality": quality}}) + "\n")
    _, _, ckpt = _write_basic_artifacts(tmp_path / "c")
    return str(trace), str(tele), ckpt


def _both(tmp_path, later_slices):
    (tmp_path / "c").mkdir()
    trace, tele, ckpt = _rich_artifacts(tmp_path, later_slices)
    t = RunReport.load(trace=trace, telemetry=tele, checkpoint_dir=ckpt)
    j = JRunReport.load(trace=trace, telemetry=tele, checkpoint_dir=ckpt)
    docs = []
    for r in (t, j):
        doc = json.loads(json.dumps(r.to_json(), default=str))
        assert doc.pop("generated")
        docs.append(doc)
    return t, j, docs[0], docs[1]


def test_report_of_the_same_artifacts_matches_the_jax_package(tmp_path):
    t, j, t_doc, j_doc = _both(tmp_path, later_slices=False)
    assert t_doc == j_doc
    md = t.to_markdown()
    assert md == j.to_markdown()
    for section in ("## Key metrics", "## Phase time breakdown", "## Fetch / compile accounting",
                    "## Ingestion", "## Serving", "## Recovery", "## Freshness",
                    "## Pipeline", "## Quality", "## HBM / memory",
                    "## Coordinates (from newest checkpoint)", "## Hyperparameter sweep",
                    "## Heartbeats"):
        assert section in md, section
    assert t.key_metrics() == j.key_metrics()
    deltas = t.compare(j_doc)
    assert [d.to_dict() for d in deltas] == [d.to_dict() for d in j.compare(j_doc)]
    assert t.to_markdown(deltas=deltas) == j.to_markdown(deltas=deltas)


def _without_sections(md, headings):
    out, skip = [], False
    for line in md.splitlines():
        if line.startswith("## "):
            skip = line in headings
        if not skip:
            out.append(line)
    return "\n".join(out)


_LATER_KEYS = ("device_utilization", "hot_executables")

#: the named differences of the device sections' text: the port's line on
#: its modelled cost, and the timing method under the hot table's heading
_PORT_ONLY_LINES = ("- FLOPs and bytes are modelled from the kernels' and dense contractions' "
                    "shapes (kernels/cost.py): a lower bound, the solvers' vector arithmetic "
                    "is not counted",)
_TIMING_NOTE_PREFIX = "_Sampled "


def _device_sections_text(md, port):
    lines = [line for line in md.splitlines() if not (port and line in _PORT_ONLY_LINES)]
    return [line for line in lines if not line.startswith(_TIMING_NOTE_PREFIX)]


def test_report_omits_exactly_the_later_slices_sections(tmp_path):
    """The sections the port once left out (Device utilization, Hot
    executables, the ``mfu``/``exec.*``/``xla_recompiles`` key metrics)
    render from the same artifacts as the JAX package's: equal JSON, equal
    markdown but the named differences of their text."""
    t, j, t_doc, j_doc = _both(tmp_path, later_slices=True)
    assert t_doc["requests"] and t_doc["requests"] == j_doc["requests"]
    assert t_doc["slowest_requests"] and t_doc["slowest_requests"] == j_doc["slowest_requests"]
    for key in _LATER_KEYS:
        assert j_doc[key] and t_doc[key] == j_doc[key], key
    assert {"mfu", "xla_recompiles", "exec.solve.mfu"} <= set(t_doc["key_metrics"])
    assert t_doc == j_doc
    t_md, j_md = t.to_markdown(), j.to_markdown()
    for section in ("## Device utilization", "## Hot executables"):
        assert section in t_md, section
    assert _PORT_ONLY_LINES[0] in t_md
    assert _device_sections_text(t_md, port=True) == _device_sections_text(j_md, port=False)


# -- telemetry adds no host sync ------------------------------------------------


def _fit_entries(tmp_path, telemetry_on):
    from photon_ml_tpu_torch.cli.train import _maybe_write_report
    from photon_ml_tpu_torch.game import GameEstimator

    data, config = _game()
    telemetry.reset()
    syncs0 = telemetry.peek_counter("host_syncs") or 0
    launches0 = dict(kernels.LAUNCHES)
    if telemetry_on:
        telemetry.configure(trace_out=str(tmp_path / "t.trace.jsonl"))
        with Heartbeat(interval=0.01, jsonl_path=str(tmp_path / "t.metrics.jsonl")):
            result = GameEstimator(config).fit(data, device="cpu")
        telemetry.flush_metrics(str(tmp_path / "t.metrics.jsonl"))
        summary = {}
        _maybe_write_report({"report_out": str(tmp_path / "t.report.md")}, summary,
                            str(tmp_path / "t.trace.jsonl"), str(tmp_path / "t.metrics.jsonl"))
        assert summary["report"]
    else:
        result = GameEstimator(config).fit(data, device="cpu")
    syncs = (telemetry.peek_counter("host_syncs") or 0) - syncs0
    launches = {k: n - launches0.get(k, 0) for k, n in kernels.LAUNCHES.items()}
    return [(e["coordinate"], e["host_syncs"], e["launches"]) for e in result.history], \
        syncs, launches


def test_telemetry_adds_no_host_sync_to_a_fit(tmp_path):
    off = _fit_entries(tmp_path, telemetry_on=False)
    on = _fit_entries(tmp_path, telemetry_on=True)
    assert on == off
    assert off[1] > 0  # the fit does fetch (its solver rounds), the count is the same
    assert (tmp_path / "t.trace.jsonl").stat().st_size > 0
    assert "## Coordinates" not in (tmp_path / "t.report.md").read_text()  # no checkpoint


def test_sweep_glm_config_spans_ride_its_one_fetch():
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.optim.factory import OptimizerConfig
    from photon_ml_tpu_torch.sweep import sweep_glm

    rng = np.random.default_rng(3)
    X = rng.normal(size=(64, 5))
    y = (rng.random(64) < 0.5).astype(np.float32)
    r, c = np.nonzero(X)
    batch = CSRBatch.from_coo(X[r, c].astype(np.float32), r, c, y, 5, device="cpu")
    res = sweep_glm(batch, "logistic", [1.0, 0.1], OptimizerConfig(max_iterations=10),
                    rounds=1, device="cpu")
    spans = telemetry.finished_spans("sweep_config")
    assert [s.attrs["index"] for s in spans] == [0, 1]
    assert [s.attrs["lambda"] for s in spans] == [1.0, 0.1]
    np.testing.assert_array_equal([s.attrs["final_loss"] for s in spans],
                                  res.values.numpy().astype(np.float32))
    assert [s.attrs["iterations"] for s in spans] == res.iterations.tolist()
    assert telemetry.snapshot()["gauges"]["sweep.configs_done"] == 2
    # the lane solver's own fetches and the one packed fetch at the end: the
    # spans read the packed fetch, so no span adds a sync
    assert len(telemetry.finished_spans("fetch:sweep_glm")) == 1
