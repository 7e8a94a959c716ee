"""The port's per-process fleet wiring (``photon_ml_tpu_torch/parallel/multihost.py``)
against the JAX package's (tests/test_multihost.py, its fast tests case for
case), and one 2-process gloo fleet on the CPU.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port's single-process meshes repeat the CPU 8 times. The 2-process test
starts two worker processes that join one gloo rendezvous and checks
``process_slice``, ``fleet_any``, ``gather_to_host``, ``host_local_array``,
``collective_wait``'s counters and the piece exchange of a fleet table
across them.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as P

from photon_ml_tpu.game.streaming import LocalChunk as JLocalChunk
from photon_ml_tpu.game.streaming import ShardedCoefficientTable as JTable
from photon_ml_tpu.game.streaming import StreamingRandomEffectTrainer as JTrainer
from photon_ml_tpu.ops.dense import DenseBatch as JDense
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu.parallel import multihost as jmh
from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.game.streaming import (
    LocalChunk,
    ShardedCoefficientTable,
    StreamingRandomEffectTrainer,
)
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.parallel import EntityShards, multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


def test_distributed_config_validation():
    for mod in (multihost, jmh):
        mod.DistributedConfig().validate()  # nothing to join
        with pytest.raises(ValueError, match="num_processes"):
            mod.DistributedConfig(coordinator_address="h:1").validate()
        with pytest.raises(ValueError, match="out of range"):
            mod.DistributedConfig(coordinator_address="h:1", num_processes=2,
                                  process_id=5).validate()
        with pytest.raises(ValueError, match="coordinator_address"):
            mod.DistributedConfig(num_processes=2).validate()
        with pytest.raises(ValueError, match="conflicts"):
            mod.DistributedConfig(auto=True, coordinator_address="h:1").validate()


def test_distributed_config_from_env(monkeypatch):
    monkeypatch.setenv("PHOTON_ML_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("PHOTON_ML_NUM_PROCESSES", "4")
    monkeypatch.setenv("PHOTON_ML_PROCESS_ID", "2")
    for mod in (multihost, jmh):
        cfg = mod.DistributedConfig.from_env()
        assert cfg.coordinator_address == "10.0.0.1:8476"
        assert cfg.num_processes == 4 and cfg.process_id == 2
        cfg.validate()


def test_init_retries_config_from_env(monkeypatch):
    monkeypatch.setenv("PHOTON_ML_INIT_RETRIES", "7")
    assert multihost.DistributedConfig.from_env().init_retries == 7
    assert jmh.DistributedConfig.from_env().init_retries == 7
    monkeypatch.delenv("PHOTON_ML_INIT_RETRIES")
    assert multihost.DistributedConfig.from_env().init_retries == 3


def test_initialize_retries_transient_failures_with_backoff(monkeypatch):
    """A flaky rendezvous is retried with exponential backoff and counted;
    the attempt that succeeds ends the loop (the reference's sleeps)."""
    sleeps = []
    monkeypatch.setattr(multihost.time, "sleep", sleeps.append)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("connection refused")

    telemetry.reset()
    try:
        cfg = multihost.DistributedConfig(coordinator_address="10.0.0.9:8476", num_processes=2,
                                          process_id=0, init_retries=3, init_backoff_s=0.25)
        multihost._init_attempts(cfg, flaky)
        assert calls["n"] == 3 and sleeps == [0.25, 0.5]
        assert telemetry.snapshot()["counters"]["multihost.init_retries"] == 2
    finally:
        telemetry.reset()


def test_initialize_exhaustion_raises_fleet_init_error(monkeypatch):
    monkeypatch.setattr(multihost.time, "sleep", lambda s: None)

    def always_down():
        raise ConnectionError("no route to host")

    cfg = multihost.DistributedConfig(coordinator_address="10.1.2.3:9999", num_processes=2,
                                      process_id=1, init_retries=2)
    with pytest.raises(multihost.FleetInitError, match="10.1.2.3:9999") as ei:
        multihost._init_attempts(cfg, always_down)
    assert "3 attempt(s)" in str(ei.value) and ei.value.coordinator == "10.1.2.3:9999"


def test_initialize_without_a_peer_raises_fleet_init_error():
    """A real rendezvous that never completes (process 1 of 2 with no process
    0 at the coordinator) ends in ``FleetInitError`` naming it, and leaves
    no process group behind: nothing falls back to one process."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = multihost.DistributedConfig(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                                      process_id=1, init_retries=1, init_backoff_s=0.01,
                                      timeout_s=1.0)
    with pytest.raises(multihost.FleetInitError, match=f"127.0.0.1:{port}"):
        multihost.initialize(cfg, device="cpu")
    assert not dist.is_initialized() and multihost.backend() is None


def test_initialize_injected_fault_seam_is_retryable(monkeypatch):
    """An armed ``multihost.init`` raise rule is absorbed by the bounded
    retry, as in the reference."""
    monkeypatch.setattr(multihost.time, "sleep", lambda s: None)
    faults.install_plan(faults.FaultPlan([faults.FaultRule("multihost.init", action="raise",
                                                           nth=1)]))
    telemetry.reset()
    try:
        cfg = multihost.DistributedConfig(coordinator_address="h:1", num_processes=2,
                                          process_id=0, init_retries=1)
        done = {"n": 0}
        multihost._init_attempts(cfg, lambda: done.update(n=done["n"] + 1))
        assert done["n"] == 1
        assert telemetry.snapshot()["counters"]["multihost.init_retries"] == 1
    finally:
        faults.clear_plan()
        telemetry.reset()


def test_backend_follows_placement():
    """NCCL only when every member owns a distinct card; gloo for a shared
    card (NCCL refuses a repeated device) and on the CPU."""
    assert multihost.choose_backend(["cuda/a", "cuda/b"]) == "nccl"
    assert multihost.choose_backend(["cuda/a", "cuda/a"]) == "gloo"
    assert multihost.choose_backend(["cpu/h", "cpu/h"]) == "gloo"
    assert multihost.choose_backend(["cuda/a", "cpu/h"]) == "gloo"


def test_process_slice_single_process_owns_everything():
    mesh = multihost.global_mesh({"entity": 8}, CPU8)
    assert multihost.process_slice(64, mesh, "entity") == (0, 64)
    assert jmh.process_slice(64, jmh.global_mesh({"entity": 8}), "entity") == (0, 64)
    with pytest.raises(ValueError, match="divide"):
        multihost.process_slice(63, mesh, "entity")


def test_host_local_array_and_gather_roundtrip():
    mesh = multihost.global_mesh({"data": 8}, CPU8)
    local = np.arange(32, dtype=np.float32).reshape(8, 4)
    arr = multihost.host_local_array(local, mesh, "data")
    assert isinstance(arr, EntityShards) and arr.shape == (8, 4)
    np.testing.assert_array_equal(multihost.gather_to_host(arr), local)
    ref = jmh.host_local_array(local, jmh.global_mesh({"data": 8}), P("data"))
    np.testing.assert_array_equal(multihost.gather_to_host(arr), jmh.gather_to_host(ref))
    rep = multihost.replicate_to_all(np.float32(3.0), mesh)
    assert [float(t) for t in rep] == [3.0]  # one copy a distinct device


def test_fleet_any_single_process_is_the_local_flag():
    mesh = multihost.global_mesh({"entity": 8}, CPU8)
    assert multihost.fleet_any(True, mesh) is True
    assert multihost.fleet_any(False, mesh) is False
    assert multihost.fleet_any(True, None) is True
    telemetry.reset()
    with multihost.collective_wait("nothing"):  # one process: nothing recorded
        pass
    assert "comms.wait_calls" not in telemetry.snapshot()["counters"]


def test_local_chunk_single_process_matches_dense():
    """The reference test's draw: a ``LocalChunk`` holding every row trains
    as the chunk itself on an 8-way entity mesh (bit for bit in the port;
    the reference holds its pair within atol 1e-6), and within
    tests/test_torch_streaming.py's rtol 5e-3 / atol 5e-4 of the JAX
    package's (10 LBFGS iterations stop short of the optimum, where float32
    rounding steers each package's path)."""
    rng = np.random.default_rng(0)
    n_ent, rows, k = 16, 5, 3
    x = rng.normal(size=(n_ent, rows, k)).astype(np.float32)
    labels = (rng.random((n_ent, rows)) > 0.5).astype(np.float32)
    leaves = (x, labels, np.zeros((n_ent, rows), np.float32), np.ones((n_ent, rows), np.float32))
    cfg = OptimizerConfig(max_iterations=10, tolerance=1e-9, regularization_weight=1.0,
                          regularization=RegularizationContext(RegularizationType.L2))
    mesh = multihost.global_mesh({"entity": 8}, CPU8)

    def train(source):
        table = ShardedCoefficientTable(n_ent, k, mesh=mesh)
        StreamingRandomEffectTrainer("logistic", cfg, mesh=mesh).train(table, [(0, source)])
        return table.to_numpy()

    w_plain = train(DenseBatch(*leaves))
    w_local = train(LocalChunk(DenseBatch(*leaves), global_size=n_ent))
    np.testing.assert_array_equal(w_local, w_plain)
    jcfg = JOpt(max_iterations=10, tolerance=1e-9, regularization_weight=1.0,
                regularization=JReg(JRegType.L2))
    jmesh = jmh.global_mesh({"entity": 8})
    jtable = JTable(n_ent, k, mesh=jmesh)
    JTrainer("logistic", jcfg, mesh=jmesh).train(
        jtable, [(0, JLocalChunk(JDense(*leaves), global_size=n_ent))])
    np.testing.assert_allclose(w_local, jtable.to_numpy(), rtol=5e-3, atol=5e-4)


def test_table_bounds_checked():
    for table in (ShardedCoefficientTable(8, 3, device="cpu"), JTable(8, 3)):
        with pytest.raises(ValueError, match="out of bounds"):
            table.read_chunk(4, 8)
        for start in (-1, 7):
            with pytest.raises(ValueError, match="out of bounds"):
                table.write_chunk(start, torch.zeros((2, 3)) if isinstance(
                    table, ShardedCoefficientTable) else np.zeros((2, 3), np.float32))
    table = ShardedCoefficientTable(8, 3, device="cpu")
    table.write_chunk(6, torch.ones((2, 3)))
    np.testing.assert_array_equal(table.read_chunk(6, 2).numpy(), np.ones((2, 3)))


_TWO_PROCESS = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.game.streaming import ShardedCoefficientTable
    from photon_ml_tpu_torch.parallel import multihost

    pid, port = int(sys.argv[1]), int(sys.argv[2])
    multihost.initialize(multihost.DistributedConfig(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
        init_retries=2, init_backoff_s=0.2), device="cpu")
    mesh = multihost.global_mesh({"entity": 4}, [torch.device("cpu")] * 2)
    lo, hi = multihost.process_slice(16, mesh, "entity")
    local = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)[lo:hi]
    arr = multihost.host_local_array(local, mesh, "entity", global_shape=(16, 3))
    gathered = multihost.gather_to_host(arr)
    # a fleet table: this member's blocks only; chunk [0, 8) lies in member
    # 0's blocks, so member 1's pieces are exchanged both ways
    table = ShardedCoefficientTable(16, 3, mesh=mesh)
    pieces = table.read_pieces(0, 2, mesh.axis_devices("entity"),
                               mesh.local_positions("entity"))
    table.write_pieces(0, 2, {j: torch.full((2, 3), float(j + 1))
                              for j in mesh.local_positions("entity")})
    print(json.dumps({
        "pid": pid, "slice": [lo, hi], "backend": multihost.backend(),
        "count": multihost.process_count(), "index": multihost.process_index(),
        "any_mine": multihost.fleet_any(pid == 1, mesh),
        "any_none": multihost.fleet_any(False, mesh),
        "sum": multihost.fleet_sum([pid + 1.0]),
        "gathered": gathered.tolist(),
        "held": [p.device.type for p in arr.parts],
        "zeros_read": [float(p.abs().sum()) for p in pieces],
        "table": table.to_numpy().tolist(),
        "wait_calls": telemetry.snapshot()["counters"].get("comms.wait_calls", 0),
    }), flush=True)
    multihost.shutdown()
""")


def test_two_process_gloo_fleet_slices_agrees_and_gathers(tmp_path):
    """Two processes, two CPU positions each, one gloo rendezvous:
    ``process_slice`` gives each its contiguous half, ``fleet_any`` is the
    OR of both flags on both, ``gather_to_host`` rebuilds the array from
    both halves, a member holds only its own blocks, the piece exchange
    writes member 1's solved rows into member 0's blocks, and each wait is
    counted in ``comms.wait_calls``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "member.py"
    script.write_text(_TWO_PROCESS)
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for pid in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    docs = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        docs.append(json.loads(out.strip().splitlines()[-1]))
    want = np.arange(48, dtype=np.float32).reshape(16, 3)
    table = np.zeros((16, 3), np.float32)
    for j in range(4):
        table[2 * j:2 * j + 2] = j + 1
    for pid, d in enumerate(docs):
        assert d["slice"] == [pid * 8, pid * 8 + 8]
        assert d["backend"] == "gloo" and d["count"] == 2 and d["index"] == pid
        assert d["any_mine"] is True and d["any_none"] is False
        assert d["sum"] == [3.0]
        np.testing.assert_array_equal(np.asarray(d["gathered"]), want)
        assert d["held"] == (["cpu", "cpu", "meta", "meta"] if pid == 0
                             else ["meta", "meta", "cpu", "cpu"])
        assert d["zeros_read"] == [0.0, 0.0]
        np.testing.assert_array_equal(np.asarray(d["table"]), table)
        assert d["wait_calls"] >= 5
