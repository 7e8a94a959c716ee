"""The port's crash matrices (``photon_ml_tpu_torch.tools.chaos``) on the CPU,
case for case with tests/test_chaos.py and the chaos rows of
tests/test_pipeline.py and tests/test_quality.py:

- the enumerations: the write-path, distributed, pipeline and serving sets
  the port's harness runs over are the JAX harness's;
- a tier-1 row of the write-path matrix (a fit killed at
  ``checkpoint.save.before_rename`` resumes to the uninterrupted table bit
  for bit, and that table is the JAX harness's worker's within
  tests/test_torch_streaming.py's tolerance) and of the distributed matrix
  (member 1 killed at ``checkpoint.peer_manifest``: the survivor resumes
  from a certified checkpoint, the loss within 1e-6 relative, no partial
  certification), each under ``PHOTON_CHAOS_BUDGET_S``;
- the quality row (a publisher killed at ``quality.publish_gate``);
- the full matrices, marked slow as the reference marks them
  (tests/test_chaos.py:59,141,524).
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import pytest

from photon_ml_tpu_torch import faults
from photon_ml_tpu_torch.tools import chaos

TOL = dict(rtol=5e-3, atol=5e-4)  # tests/test_torch_streaming.py's streamed-table tolerance


def _budget(default: str) -> float:
    return float(os.environ.get("PHOTON_CHAOS_BUDGET_S", default))


def _warn_skipped(report: dict, flag: str) -> bool:
    if report["skipped"]:
        warnings.warn(f"chaos budget truncated the matrix; uncovered this run: "
                      f"{report['skipped']} (full matrix: python -m "
                      f"photon_ml_tpu_torch.tools.chaos {flag})", stacklevel=2)
        return True
    return False


# ---------------------------------------------------------------------------
# the enumerations
# ---------------------------------------------------------------------------


def test_write_path_points_enumeration_is_the_reference_set():
    import photon_ml_tpu.game.checkpoint  # noqa: F401 (registers the JAX seams)
    import photon_ml_tpu_torch.game.checkpoint  # noqa: F401
    from photon_ml_tpu import faults as j_faults

    assert faults.write_path_points() == j_faults.write_path_points() == [
        "checkpoint.save.after_rename", "checkpoint.save.before_manifest",
        "checkpoint.save.before_rename", "checkpoint.save.before_tmp"]


def test_distributed_points_enumeration_is_stable():
    import photon_ml_tpu_torch.game.checkpoint  # noqa: F401
    import photon_ml_tpu_torch.parallel.distributed  # noqa: F401
    import photon_ml_tpu_torch.parallel.multihost  # noqa: F401
    import photon_ml_tpu_torch.serving.router  # noqa: F401
    import photon_ml_tpu_torch.serving.shard  # noqa: F401

    assert faults.distributed_points() == [
        "checkpoint.peer_manifest", "fleet.heartbeat", "multihost.init",
        "parallel.collective.entry", "serving.member_load", "serving.resize_swap",
        "serving.route_fanout"]
    # every training-fleet seam has its arming in the harness
    assert sorted(chaos.FLEET_ARMING) == [p for p in faults.distributed_points()
                                          if not p.startswith("serving.")]


def test_serving_rows_are_the_reference_rows_with_one_not_ported():
    from tools import chaos as j_chaos

    assert chaos.SERVING_ROWS == j_chaos.SERVING_ROWS
    assert chaos.PIPELINE_POINTS == j_chaos.PIPELINE_POINTS
    assert chaos.SERVING_NOT_PORTED == {"flight_dump_kill": "14d"}


def test_unknown_points_and_rows_are_refused(tmp_path):
    with pytest.raises(ValueError, match="write-path"):
        chaos.run_matrix(str(tmp_path), points=["cd.step.boundary"], device="cpu")
    with pytest.raises(ValueError, match="distributed"):
        chaos.run_fleet_matrix(str(tmp_path), points=["serving.member_load"], device="cpu")
    with pytest.raises(ValueError, match="pipeline"):
        chaos.run_pipeline_matrix(str(tmp_path), points=["pipeline.nope"], device="cpu")
    with pytest.raises(ValueError, match="serving"):
        chaos.run_serving_matrix(str(tmp_path), rows=["nope"], device="cpu")


def test_tree_digest_sees_content_and_names(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "x.bin").write_bytes(b"1")
    d0 = chaos.tree_digest(str(tmp_path))
    (tmp_path / "a" / "x.bin").write_bytes(b"2")
    d1 = chaos.tree_digest(str(tmp_path))
    os.rename(tmp_path / "a" / "x.bin", tmp_path / "a" / "y.bin")
    assert len({d0, d1, chaos.tree_digest(str(tmp_path))}) == 3


def test_flight_dump_row_is_reported_not_ported_never_passed(tmp_path):
    report = chaos.run_serving_matrix(str(tmp_path), rows=["flight_dump_kill"], device="cpu")
    assert report["results"] == {}
    assert report["not_ported"] == {"flight_dump_kill": "ROADMAP.md Queue 1 item 14d"}


# ---------------------------------------------------------------------------
# the write-path matrix
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_crash_matrix_tier1_row(tmp_path):
    """A fit killed between its complete tmp directory and the rename resumes
    to the uninterrupted table bit for bit; that table is the JAX harness
    worker's within the streamed tolerance."""
    from tools import chaos as j_chaos

    report = chaos.run_matrix(str(tmp_path / "t"), points=["checkpoint.save.before_rename"],
                              budget_s=_budget("300"), device="cpu")
    if _warn_skipped(report, ""):
        return
    assert report["ok"], json.dumps(report, indent=2)
    entry = report["results"]["checkpoint.save.before_rename"]
    assert entry["armed_rc"] == faults.DEFAULT_EXIT_CODE
    assert entry["exact"] and entry["resume_rc"] == 0
    proc = j_chaos.run_worker(str(tmp_path / "j"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_allclose(np.load(tmp_path / "t" / "reference" / "final.npy"),
                               np.load(tmp_path / "j" / "final.npy"), **TOL)


@pytest.mark.chaos
@pytest.mark.slow
def test_crash_matrix_every_write_path_point_recovers(tmp_path):
    report = chaos.run_matrix(str(tmp_path), budget_s=_budget("300"), device="cpu", jobs=2)
    assert report["ok"], json.dumps(report, indent=2)
    assert report["results"], "the chaos budget covered no point at all"
    for entry in report["results"].values():
        assert entry["armed_rc"] == faults.DEFAULT_EXIT_CODE and entry["exact"]
    _warn_skipped(report, "")


# ---------------------------------------------------------------------------
# the distributed matrix
# ---------------------------------------------------------------------------


@pytest.mark.chaos_distributed
def test_distributed_matrix_tier1_row(tmp_path):
    """Member 1 of a 2-process gloo fleet killed before its manifest of the
    coordinated save after a certified one: the survivor resumes from the
    certified checkpoint, ends within 1e-6 (relative) of the uninterrupted
    fleet's loss, and no checkpoint is certified partial."""
    report = chaos.run_fleet_matrix(str(tmp_path), points=["checkpoint.peer_manifest"],
                                    budget_s=_budget("300"), device="cpu")
    if _warn_skipped(report, "--fleet"):
        return
    assert report["ok"], json.dumps(report, indent=2, default=str)
    entry = report["results"]["checkpoint.peer_manifest"]
    assert entry["victim_rc"] == faults.DEFAULT_EXIT_CODE
    assert entry["relaunches"] == 1
    assert entry["loss_rel_delta"] < chaos.FLEET_LOSS_RTOL
    assert entry["partial_certified"] == []


@pytest.mark.chaos_distributed
@pytest.mark.slow
def test_distributed_matrix_every_fleet_seam_recovers(tmp_path):
    report = chaos.run_fleet_matrix(str(tmp_path), budget_s=_budget("600"), device="cpu")
    assert report["ok"], json.dumps(report, indent=2, default=str)
    assert [p for p, e in report["results"].items() if e.get("passed")]
    for entry in report["results"].values():
        assert entry["victim_rc"] == faults.DEFAULT_EXIT_CODE
        assert entry["partial_certified"] == []
    _warn_skipped(report, "--fleet")


# ---------------------------------------------------------------------------
# the quality row
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_quality_crash_row(tmp_path):
    """A publisher killed at quality.publish_gate leaves the registry as it
    was; the rerun quarantines the regressed challenger and a healthy one
    publishes (the command line prints each row)."""
    rc = chaos.main(["--workdir", str(tmp_path), "--device", "cpu", "--quality",
                     "--json", str(tmp_path / "q.json")])
    with open(tmp_path / "q.json") as fh:
        report = json.load(fh)
    assert rc == 0 and report["ok"], json.dumps(report, indent=2)
    entry = report["results"]["quality.publish_gate"]
    assert entry["armed_rc"] == faults.DEFAULT_EXIT_CODE
    assert entry["quarantined"] == "quarantined-v-00000002"
    assert entry["published"] == "v-00000002"
