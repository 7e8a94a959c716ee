"""The port's training fleet (``photon_ml_tpu_torch/tools/fleet.py``) on the
CPU: 2-process gloo fleets at ``make_problem``'s shape (16 entities x 8 rows
x 4 features, 4 chunks), each member its own subprocess.

- an uninterrupted fleet against the JAX package's single-process streamed
  fit of the same problem (tests/test_torch_streaming.py's rtol 5e-3 /
  atol 5e-4), and bit for bit against the port's in-process 2-device
  ``entity`` mesh over the same chunks (the same pieces);
- member 1 killed at the ``fleet.heartbeat`` seam after the first certified
  checkpoint and the fit relaunched on the survivor: the final loss within
  1e-6 (relative) of the uninterrupted fleet's (tools/chaos.py:366's bound),
  the rows of the chunks solved before the checkpoint bit for bit, and no
  partially certified checkpoint;
- SIGTERM to one member: both stop at the same boundary and exit 75, nothing
  killed, a 2-process quorum manifest (tests/test_chaos.py:552-600).
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.game.streaming import ShardedCoefficientTable as JTable
from photon_ml_tpu.game.streaming import StreamingRandomEffectTrainer as JTrainer
from photon_ml_tpu.ops.dense import DenseBatch as JDense
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu_torch.game.checkpoint import CheckpointSpec, StreamingCheckpointManager
from photon_ml_tpu_torch.game.streaming import ShardedCoefficientTable, StreamingRandomEffectTrainer
from photon_ml_tpu_torch.parallel import make_mesh
from photon_ml_tpu_torch.tools import fleet

STREAM_TOL = dict(rtol=5e-3, atol=5e-4)  # tests/test_torch_streaming.py


def _spec(tmp_path, name, **kw):
    # generous deadlines: the test run shares the machine's cores with others
    kw = {"heartbeat_deadline_s": 20.0, "quorum_timeout_s": 30.0, **kw}
    return fleet.FleetSpec(workdir=str(tmp_path / name), device="cpu", timeout_s=240.0, **kw)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    report = fleet.run_fleet(_spec(tmp_path_factory.mktemp("fleet"), "a"))
    assert report["ok"], json.dumps(report, default=str)[-3000:]
    return report, np.load(report["final_path"])


def test_fleet_matches_the_reference_streamed_fit_and_the_in_process_mesh(uninterrupted):
    report, table = uninterrupted
    (gen,) = report["generations"]
    assert gen["rcs"] == {0: 0, 1: 0} and gen["outcome"] == "complete"
    for pid, line in gen["members"].items():
        assert line["backend"] == "gloo" and line["process_id"] == pid
        assert line["comms_wait_calls"] > 0
    X, y = fleet.make_problem()
    per = fleet.N_ENTITIES // fleet.N_CHUNKS
    ones, zeros = np.ones((per, fleet.N_ROWS), np.float32), np.zeros((per, fleet.N_ROWS),
                                                                   np.float32)
    jcfg = JOpt(max_iterations=60, tolerance=1e-9, regularization_weight=0.3,
                regularization=JReg(JRegType.L2))
    jtable = JTable(fleet.N_ENTITIES, fleet.DIM)
    JTrainer("logistic", jcfg).train(jtable, [
        (i * per, JDense(X[i * per:(i + 1) * per], y[i * per:(i + 1) * per], zeros, ones))
        for i in range(fleet.N_CHUNKS)])
    np.testing.assert_allclose(table, jtable.to_numpy(), **STREAM_TOL)
    # one process driving the same two positions over the same chunks
    mesh = make_mesh({"entity": 2}, [torch.device("cpu")] * 2)
    mine = ShardedCoefficientTable(fleet.N_ENTITIES, fleet.DIM, mesh=mesh)
    StreamingRandomEffectTrainer("logistic", fleet.small_config(), mesh=mesh,
                                 prefetch=False).train(mine, [
        (i * per, fleet._chunk_rows("small", 0, i, 0, per, "cpu"))
        for i in range(fleet.N_CHUNKS)])
    np.testing.assert_array_equal(table, mine.to_numpy())


def test_member_killed_at_the_heartbeat_seam_relaunches_on_the_survivor(tmp_path,
                                                                          uninterrupted):
    _, want = uninterrupted
    report = fleet.run_fleet(_spec(
        tmp_path, "k", victim_plan={"rules": [{"point": "fleet.heartbeat", "action": "exit"}]},
        victim_arm_after_chunk=1))
    assert report["ok"] and report["relaunches"] == 1, json.dumps(report, default=str)[-3000:]
    first, second = report["generations"]
    assert first["rcs"][1] == fleet.LOST_HOST_EXIT_CODE and first["deaths"] == [1]
    assert second["num_processes"] == 1 and second["rcs"] == {0: 0}
    assert second["members"][0]["resumed"] and second["members"][0]["start_chunk"] >= 2
    assert report["detect_s"] is not None and report["relaunch_s"] > 0
    got = np.load(report["final_path"])
    per = fleet.N_ENTITIES // fleet.N_CHUNKS
    done = second["members"][0]["start_chunk"] * per
    np.testing.assert_array_equal(got[:done], want[:done])
    l_got, l_want = (fleet.problem_loss("small", 0, t) for t in (got, want))
    assert abs(l_got - l_want) / abs(l_want) < 1e-6
    ckpt = str(tmp_path / "k" / "ckpt")
    assert fleet.verify_certified_checkpoints(ckpt, fleet.N_ENTITIES, fleet.DIM) == []


def test_sigterm_to_one_member_boundary_stops_the_whole_fleet(tmp_path):
    """... and the supervisor's live status file ends with the outcome."""
    status = str(tmp_path / "status.json")
    report = fleet.run_fleet(_spec(tmp_path, "s", sigterm_after_s=1.0, sigterm_process=0,
                                   chunk_sleep_s=0.3, grace_s=40.0,
                                   status_file=status, status_interval_s=0.1))
    assert report["interrupted"] is True, json.dumps(report, default=str)[-3000:]
    doc = json.load(open(status))
    assert doc["outcome"] == "interrupted" and doc["members"]["0"]["rc"] == 75
    (gen,) = report["generations"]
    assert gen["outcome"] == "interrupted"
    assert gen["rcs"] == {0: fleet.GRACEFUL_EXIT_CODE, 1: fleet.GRACEFUL_EXIT_CODE}
    assert gen["escalated"] == []
    ckpt = str(tmp_path / "s" / "ckpt")
    assert fleet.verify_certified_checkpoints(ckpt, fleet.N_ENTITIES, fleet.DIM) == []
    mgr = StreamingCheckpointManager(CheckpointSpec(directory=ckpt, every=1))
    assert mgr.restore() is not None
    manifest = json.loads(open(os.path.join(mgr._chunk_dirs()[-1][1], "manifest.json")).read())
    assert manifest["quorum"] == {"num_processes": 2}


def test_fleet_spec_refuses_the_members_telemetry_streams(tmp_path):
    """The members' streams, refused until they were ported, are on by
    default: one directory a generation, the members' environment pointed
    into it (the reference's layout); off, the environment carries none. An
    unknown problem is refused."""
    spec = fleet.FleetSpec(workdir=str(tmp_path))
    assert spec.telemetry is True
    gen1 = os.path.join(str(tmp_path), "telemetry", "gen1")
    assert spec.generation_telemetry_dir(1) == gen1
    assert spec.telemetry_out_base(1) == os.path.join(gen1, "telemetry.jsonl")
    env = fleet._worker_env(spec, 1, 2, False, 1)
    assert env["PHOTON_TRACE_OUT"] == os.path.join(gen1, "trace.jsonl")
    assert env["PHOTON_TELEMETRY_OUT"] == os.path.join(gen1, "telemetry.jsonl")
    assert (env["PHOTON_PROC_ID"], env["PHOTON_PROC_COUNT"]) == ("1", "2")
    off = fleet.FleetSpec(workdir=str(tmp_path), telemetry=False)
    assert off.generation_telemetry_dir(0) is None
    env = fleet._worker_env(off, 0, 2, False, 0)
    assert "PHOTON_TRACE_OUT" not in env and "PHOTON_TELEMETRY_OUT" not in env
    with pytest.raises(ValueError, match="problem"):
        fleet.FleetSpec(workdir=str(tmp_path), problem="huge")


def test_problem_loss_is_the_reference_scorer():
    """The fleet's final loss is tools/chaos.py's ``fleet_final_loss`` (the
    JAX package's objective over the same table)."""
    from tools.chaos import fleet_final_loss

    table = np.random.default_rng(0).normal(size=(fleet.N_ENTITIES, fleet.DIM)) * 0.3
    np.testing.assert_allclose(fleet.problem_loss("small", 0, table),
                               fleet_final_loss(table.astype(np.float32)), rtol=1e-5)
