"""The port's streamed random effect (``photon_ml_tpu_torch/game/streaming.py``)
and its chunk-boundary checkpoints against the JAX package's
(tests/test_streaming.py, case for case but its mesh cases, which
tests/test_torch_mesh.py holds), on the CPU:

- a dense per-entity design against the sparse layout (objective, and the
  LBFGS, TRON and NEWTON solves against the JAX package's sparse solves);
- the same numpy chunks through the JAX trainer and the port's: the tables
  within the reference test's tolerance of each other and of direct
  per-entity solves (rtol 5e-3, atol 5e-4), the iterations per entity
  within the 4 steps of a float32 plateau;
- warm starts, box constraints, variances, the tracker, the guard's
  rollback of a NaN chunk (poisoned data; the ``streaming.solve.result``
  seam drives it in tests/test_torch_faults.py), feed retries, the prefetch arms and host against device chunks bit
  for bit;
- checkpoints at chunk boundaries, SIGTERM, and resume bit for bit; a
  streaming checkpoint written by each package restored by the other;
- a ``LocalChunk`` in one process trains as its chunk (the mesh cases are
  tests/test_torch_mesh.py's, the fleet's tests/test_torch_multihost.py's).
"""

import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game import checkpoint as j_ckpt
from photon_ml_tpu.game.streaming import ShardedCoefficientTable as JTable
from photon_ml_tpu.game.streaming import StreamingRandomEffectTrainer as JTrainer
from photon_ml_tpu.ops.dense import DenseBatch as JDense
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import OptimizerType as JOptType
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu.optim import solve as j_solve
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.game.checkpoint import (
    CheckpointSpec,
    GracefulStop,
    StreamingCheckpointManager,
    TrainingInterrupted,
)
from photon_ml_tpu_torch.game.streaming import (
    LocalChunk,
    ShardedCoefficientTable,
    StreamingRandomEffectTrainer,
)
from photon_ml_tpu_torch.parallel import make_mesh
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.sparse import SparseBatch
from photon_ml_tpu_torch.optim import glm_adapter
from photon_ml_tpu_torch.optim.common import BoxConstraints
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
    dispatch_solve,
)
from photon_ml_tpu_torch.optim.guard import GuardSpec

CPU = "cpu"
_CFG = OptimizerConfig(max_iterations=60, tolerance=1e-9,
                       regularization=RegularizationContext(RegularizationType.L2),
                       regularization_weight=0.3)
_JCFG = JOpt(max_iterations=60, tolerance=1e-9, regularization=JReg(JRegType.L2),
             regularization_weight=0.3)
TOL = dict(rtol=5e-3, atol=5e-4)  # tests/test_streaming.py's streamed-vs-direct tolerance


@pytest.fixture(autouse=True)
def _port_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _table(n, k):
    return ShardedCoefficientTable(n, k, device=CPU)


def _trainer(cfg=_CFG, **kw):
    return StreamingRandomEffectTrainer("logistic", cfg, device=CPU, **kw)


def _problem(rng, n=200, d=12):
    X = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ w)))).astype(float)
    off = rng.normal(size=n) * 0.1
    wgt = rng.random(n) + 0.5
    return X, y, off, wgt


def _chunked_entities(rng, n_ent=24, rows=10, k=6):
    X = rng.normal(size=(n_ent, rows, k))
    W = rng.normal(size=(n_ent, k))
    z = np.einsum("erk,ek->er", X, W)
    y = (rng.random((n_ent, rows)) < 1 / (1 + np.exp(-z))).astype(float)
    return X, y


def _host_chunk(X, y, lo, hi, dense=DenseBatch):
    rows = X.shape[1]
    return dense(x=X[lo:hi].astype(np.float32), labels=y[lo:hi].astype(np.float32),
                 offsets=np.zeros((hi - lo, rows), np.float32),
                 weights=np.ones((hi - lo, rows), np.float32))


def _device_chunk(X, y, lo, hi):
    return lambda: DenseBatch.from_arrays(X[lo:hi], y[lo:hi], device=CPU)


# ---------------------------------------------------------------------------
# the dense local design against the sparse layout
# ---------------------------------------------------------------------------


def test_dense_batch_matches_sparse_objective(rng):
    X, y, off, wgt = _problem(rng)
    db = DenseBatch.from_arrays(X[None], y[None], off[None], wgt[None], device=CPU)
    sb = SparseBatch.from_dense(X, y, offsets=off, weights=wgt, device=CPU)
    obj = make_objective("logistic", l2_weight=0.3)
    w = torch.from_numpy(rng.normal(size=X.shape[1]).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=X.shape[1]).astype(np.float32))
    vd, gd = obj.value_and_grad(w[None], db)
    vs, gs = obj.value_and_grad(w, sb)
    np.testing.assert_allclose(float(vd[0]), float(vs), rtol=1e-5)
    np.testing.assert_allclose(gd[0].numpy(), gs.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(obj.hessian_vector(w[None], v[None], db)[0].numpy(),
                               obj.hessian_vector(w, v, sb).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(obj.hessian_diagonal(w[None], db)[0].numpy(),
                               obj.hessian_diagonal(w, sb).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(obj.margins(w[None], db)[0].numpy(), obj.margins(w, sb).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("opt", ["LBFGS", "TRON", "NEWTON"])
def test_dense_batch_solves_match_sparse(rng, opt):
    """The port's dense one-entity solve against the JAX package's solve of
    the same problem on its sparse layout (the reference test's pair)."""
    X, y, off, wgt = _problem(rng)
    cfg = dataclasses.replace(_CFG, optimizer_type=OptimizerType[opt])
    jcfg = dataclasses.replace(_JCFG, optimizer_type=JOptType[opt])
    db = DenseBatch.from_arrays(X[None], y[None], off[None], wgt[None], device=CPU)
    obj = make_objective("logistic", l2_weight=0.3)
    rd = dispatch_solve(glm_adapter(obj, db), torch.zeros(1, X.shape[1]), cfg, device=CPU)
    rs = j_solve("logistic", JSparse.from_dense(X, y, offsets=off, weights=wgt), jcfg,
                 jnp.zeros(X.shape[1], jnp.float32))
    np.testing.assert_allclose(rd.w[0].numpy(), np.asarray(rs.w), rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# the trainer against the JAX trainer and direct solves
# ---------------------------------------------------------------------------


def test_streaming_trainer_matches_jax_and_direct_solves(rng):
    X, y = _chunked_entities(rng)
    n_ent, rows, k = X.shape
    table = _table(n_ent, k)
    stats = _trainer().train(table, [(0, _host_chunk(X, y, 0, 8)),
                                     (8, _host_chunk(X, y, 8, 16)),
                                     (16, _device_chunk(X, y, 16, 24))], with_tracker=True)
    assert stats.total_entities == n_ent
    assert stats.total_coefficients == n_ent * k
    assert stats.num_chunks == 3
    assert stats.mean_iterations > 0
    assert stats.lanes_rose == 0
    got = table.to_numpy()

    jtable = JTable(n_ent, k)
    jstats = JTrainer("logistic", _JCFG).train(
        jtable, [(lo, _host_chunk(X, y, lo, lo + 8, JDense)) for lo in (0, 8, 16)],
        with_tracker=True)
    np.testing.assert_allclose(got, jtable.to_numpy(), **TOL)
    # at tolerance 1e-9 a lane's last steps follow float32 rounding: the
    # iterations agree within the few steps of a plateau
    off = np.abs(stats.tracker.iterations.astype(int) - jstats.tracker.iterations)
    assert off.max() <= 4, (stats.tracker.iterations, jstats.tracker.iterations)
    np.testing.assert_allclose(stats.total_final_value, jstats.total_final_value, rtol=1e-4)

    obj = make_objective("logistic", l2_weight=0.3)
    for e in range(0, n_ent, 5):
        ref = dispatch_solve(glm_adapter(obj, DenseBatch.from_arrays(X[e:e + 1], y[e:e + 1],
                                                                     device=CPU)),
                             torch.zeros(1, k), OptimizerConfig(), device=CPU)
        np.testing.assert_allclose(got[e], ref.w[0].numpy(), **TOL)


def test_streaming_warm_start_reuses_table(rng):
    X, y = _chunked_entities(rng, n_ent=8)
    n_ent, rows, k = X.shape
    table = _table(n_ent, k)
    trainer = _trainer()
    chunk = _host_chunk(X, y, 0, n_ent)
    s1 = trainer.train(table, [(0, chunk)])
    w1 = table.to_numpy()
    s2 = trainer.train(table, [(0, chunk)])
    assert s2.mean_iterations <= max(s1.mean_iterations * 0.25, 1.5)
    np.testing.assert_allclose(table.to_numpy(), w1, rtol=1e-3, atol=2e-4)


def test_table_chunks_write_in_place_and_check_bounds():
    table = _table(6, 3)
    storage = table.coefficients.data_ptr()
    table.write_chunk(2, torch.ones(3, 3))
    assert table.coefficients.data_ptr() == storage  # never a second copy
    assert table.to_numpy()[2:5].sum() == 9 and table.nbytes == 6 * 3 * 4
    chunk = table.read_chunk(2, 3)
    chunk += 1  # a copy: the table keeps its rows
    assert table.to_numpy()[2:5].sum() == 9
    for start, size in ((5, 2), (-1, 1)):
        with pytest.raises(ValueError, match="out of bounds"):
            table.read_chunk(start, size)
    wrapped = ShardedCoefficientTable.from_coefficients(table.coefficients)
    assert wrapped.coefficients is table.coefficients and wrapped.num_entities == 6


def test_mesh_and_fleet_paths_are_refused_naming_item_12(tmp_path, rng):
    """The refusal this test pinned is gone: in one process a ``LocalChunk``
    holding the whole chunk trains bit for bit as the chunk itself, with
    prefetch on and off, and a ``LocalChunk`` whose rows are not this
    process's share is refused (the fleet's cases are
    tests/test_torch_multihost.py's and tests/test_torch_fleet.py's)."""
    X, y = _chunked_entities(rng, n_ent=8, rows=4, k=3)
    want = _table(8, 3)
    _trainer(prefetch=False).train(want, [(0, _host_chunk(X, y, 0, 8))])
    for prefetch in (True, False):
        got = _table(8, 3)
        _trainer(prefetch=prefetch).train(
            got, [(0, LocalChunk(batch=_host_chunk(X, y, 0, 8), global_size=8))])
        assert np.array_equal(got.to_numpy(), want.to_numpy())
    short = LocalChunk(batch=_host_chunk(X, y, 0, 4), global_size=8)
    with pytest.raises(ValueError, match="LocalChunk of 4 rows"):
        _trainer(prefetch=False).train(_table(8, 3), [(0, short)])
    mesh = make_mesh({"entity": 2}, [torch.device(CPU)] * 2)
    mgr = StreamingCheckpointManager(CheckpointSpec(directory=str(tmp_path)))
    assert mgr.restore_placed(mesh=mesh) is None  # nothing saved yet


def _stream_train(rng, cfg, n_ent=12, rows=8, k=4, **trainer_kw):
    X, y = _chunked_entities(rng, n_ent=n_ent, rows=rows, k=k)
    train_kw = trainer_kw.pop("train_kw", {})
    table = _table(n_ent, k)
    half = n_ent // 2
    stats = _trainer(cfg, **trainer_kw).train(
        table, [(0, _host_chunk(X, y, 0, half)), (half, _host_chunk(X, y, half, n_ent))],
        **train_kw)
    return table, stats, X, y


def test_streaming_box_constraints_match_bucket_semantics(rng):
    """The streamed table honours ``config.box_constraints``: each chunk is
    bit for bit the bucket path's lane solve of the same entities in the
    same box. Projected LBFGS converges slowly along active faces and a
    lane's path follows float32 rounding (which on the CPU depends on the
    batch shape), so against the JAX trainer the check is the total
    objective over the entities within 1%."""
    box = ((0, -0.05, 0.05), (2, 0.0, float("inf")))
    cfg = dataclasses.replace(_CFG, max_iterations=100, box_constraints=box)
    table, stats, X, y = _stream_train(rng, cfg)
    got = table.to_numpy()
    assert np.all(got[:, 0] >= -0.05 - 1e-6) and np.all(got[:, 0] <= 0.05 + 1e-6)
    assert np.all(got[:, 2] >= -1e-6)
    obj = make_objective("logistic", l2_weight=0.3)
    lower, upper = cfg.dense_box_bounds(X.shape[2])
    cons = BoxConstraints(lower=torch.from_numpy(lower), upper=torch.from_numpy(upper))
    for lo, hi in ((0, 6), (6, 12)):
        bucket = DenseBatch.from_arrays(X[lo:hi], y[lo:hi], device=CPU)
        ref = dispatch_solve(glm_adapter(obj, bucket), torch.zeros(hi - lo, X.shape[2]), cfg,
                             constraints=cons, device=CPU)
        np.testing.assert_array_equal(got[lo:hi], ref.w.numpy())
    jtable = JTable(*X.shape[::2])
    JTrainer("logistic", dataclasses.replace(_JCFG, max_iterations=100, box_constraints=box)
             ).train(jtable, [(0, _host_chunk(X, y, 0, 6, JDense)),
                              (6, _host_chunk(X, y, 6, 12, JDense))])
    everyone = DenseBatch.from_arrays(X, y, device=CPU)
    v_stream = float(obj.value_and_grad(torch.from_numpy(got), everyone)[0].sum())
    v_jax = float(obj.value_and_grad(torch.from_numpy(np.array(jtable.to_numpy())),
                                     everyone)[0].sum())
    assert v_stream <= v_jax * 1.01 + 1e-6, (v_stream, v_jax)


def test_streaming_unconstrained_config_trains_free(rng):
    table, stats, X, y = _stream_train(rng, _CFG)
    assert np.any(np.abs(table.to_numpy()) > 0.05)


def test_streaming_variances_match_bucket_path(rng):
    n_ent, k = 12, 4
    var_table = _table(n_ent, k)
    table, stats, X, y = _stream_train(rng, _CFG, n_ent=n_ent, k=k, compute_variances=True,
                                       train_kw=dict(variance_table=var_table))
    got_w, got_v = table.to_numpy(), var_table.to_numpy()
    obj = make_objective("logistic", l2_weight=0.3)
    for e in (0, 7):
        hd = obj.hessian_diagonal(torch.from_numpy(got_w[e:e + 1]),
                                  DenseBatch.from_arrays(X[e:e + 1], y[e:e + 1], device=CPU))
        np.testing.assert_allclose(got_v[e], 1.0 / (hd[0].numpy() + 1e-12), rtol=1e-4)


def test_streaming_variances_require_table_and_hessian():
    with pytest.raises(ValueError, match="twice-differentiable"):
        StreamingRandomEffectTrainer("smoothed_hinge", _CFG, compute_variances=True,
                                     device=CPU)
    tr = _trainer(compute_variances=True)
    with pytest.raises(ValueError, match="variance_table"):
        tr.train(_table(4, 3), [])


def test_streaming_tracker_reports_per_entity_telemetry(rng):
    table, stats, X, y = _stream_train(rng, _CFG, train_kw=dict(with_tracker=True))
    t = stats.tracker
    assert t is not None
    assert len(t.iterations) == len(t.reasons) == stats.total_entities
    assert np.all(t.iterations > 0)
    assert np.isfinite(t.final_values).all()
    assert "iterations" in t.to_summary_string()


def test_streaming_guard_rolls_back_nan_chunk(rng):
    X, y = _chunked_entities(rng, n_ent=8, rows=6, k=3)
    n_ent, rows, k = X.shape
    Xbad = X.copy()
    Xbad[1, 2, 0] = np.nan
    table = _table(n_ent, k)
    trainer = _trainer(guard=GuardSpec(max_retries=1))
    stats = trainer.train(table, [(0, _host_chunk(Xbad, y, 0, 4)),
                                  (4, _host_chunk(X, y, 4, 8))])
    got = table.to_numpy()
    np.testing.assert_array_equal(got[:4], 0.0)  # rolled back
    assert np.any(np.abs(got[4:]) > 0)
    assert np.isfinite(stats.total_final_value)
    counters = telemetry.snapshot()["counters"]
    assert counters["solves.rolled_back"] == 1
    assert counters["solves.retried"] == 1


def test_streaming_feed_retry_survives_transient_failures(rng):
    X, y = _chunked_entities(rng, n_ent=4, rows=6, k=3)
    n_ent, rows, k = X.shape
    attempts = [0]

    def flaky_source():
        attempts[0] += 1
        if attempts[0] < 3:
            raise OSError("transient read failure")
        return _device_chunk(X, y, 0, n_ent)()

    table = _table(n_ent, k)
    stats = _trainer(feed_retries=2).train(table, [(0, flaky_source)])
    assert stats.total_entities == n_ent
    assert telemetry.snapshot()["counters"]["streaming.feed_retries"] == 2
    assert np.any(np.abs(table.to_numpy()) > 0)

    def always_fails():
        raise OSError("dead source")

    with pytest.raises(OSError, match="dead source"):
        _trainer(feed_retries=1).train(_table(n_ent, k), [(0, always_fails)])


def test_streaming_prefetch_and_host_arms_match_bit_for_bit(rng):
    """prefetch=True and the synchronous arm, and host chunks against the
    same chunks made on the device, give the same table bit for bit: the
    overlap and the upload are pure scheduling."""
    X, y = _chunked_entities(rng, n_ent=12, rows=6, k=3)
    n_ent, rows, k = X.shape

    def run(prefetch, make):
        table = _table(n_ent, k)
        _trainer(prefetch=prefetch).train(table, [(0, make(X, y, 0, 6)),
                                                  (6, make(X, y, 6, 12))])
        return table.to_numpy()

    want = run(True, _device_chunk)
    for prefetch in (True, False):
        for make in (_host_chunk, _device_chunk):
            np.testing.assert_array_equal(run(prefetch, make), want)


# ---------------------------------------------------------------------------
# chunk-boundary checkpoints and graceful preemption
# ---------------------------------------------------------------------------


def _stream_fit_chunks(rng, n_ent=16, rows=8, k=4, n_chunks=4):
    X, y = _chunked_entities(rng, n_ent=n_ent, rows=rows, k=k)
    per = n_ent // n_chunks
    return [(i * per, _host_chunk(X, y, i * per, (i + 1) * per))
            for i in range(n_chunks)], (n_ent, k), (X, y)


def test_streaming_checkpoint_roundtrip_and_resume(rng, tmp_path):
    chunks, (n_ent, k), _ = _stream_fit_chunks(rng)
    trainer = _trainer()
    ref = _table(n_ent, k)
    trainer.train(ref, chunks)
    expected = ref.to_numpy()

    mgr = StreamingCheckpointManager(CheckpointSpec(directory=str(tmp_path / "ckpt"), every=1))
    table = _table(n_ent, k)
    trainer.train(table, chunks[:2], checkpointer=mgr)
    state = mgr.restore()
    assert state is not None and state.next_chunk == 2
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "chunk-00000001", "chunk-00000002"]

    table2 = _table(n_ent, k)
    table2.write_chunk(0, torch.from_numpy(state.coefficients))
    trainer.train(table2, chunks, checkpointer=mgr, start_chunk=state.next_chunk)
    np.testing.assert_array_equal(table2.to_numpy(), expected)
    # the placed restore: the newest checkpoint (the terminal one) on the device
    placed = mgr.restore_placed(device=CPU)
    assert placed.next_chunk == 4 and not placed.elastic
    assert placed.saved_env["backend"] == "cpu"
    np.testing.assert_array_equal(placed.coefficients.numpy(), expected)
    resumed = ShardedCoefficientTable.from_coefficients(placed.coefficients)
    assert resumed.num_entities == n_ent


def test_streaming_sigterm_checkpoints_and_resume_replays(rng, tmp_path):
    chunks, (n_ent, k), (X, y) = _stream_fit_chunks(rng)
    trainer = _trainer(prefetch=False)
    ref = _table(n_ent, k)
    trainer.train(ref, chunks)
    expected = ref.to_numpy()

    fired = {}

    def preempting_source(lo=chunks[1][0]):
        if not fired.get("yes"):
            fired["yes"] = True
            signal.raise_signal(signal.SIGTERM)
        return _device_chunk(X, y, lo, lo + 4)()

    preempt_chunks = [chunks[0], (chunks[1][0], preempting_source), *chunks[2:]]
    mgr = StreamingCheckpointManager(CheckpointSpec(directory=str(tmp_path / "ckpt"),
                                                    every=10))
    table = _table(n_ent, k)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        stop = GracefulStop().install(signums=(signal.SIGTERM,))
        with pytest.raises(TrainingInterrupted) as ei:
            trainer.train(table, preempt_chunks, should_stop=stop, checkpointer=mgr)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert ei.value.checkpoint_path is not None
    state = mgr.restore()
    assert state is not None and state.next_chunk == ei.value.step + 1
    assert 0 < state.next_chunk < len(chunks)

    table2 = _table(n_ent, k)
    table2.write_chunk(0, torch.from_numpy(state.coefficients))
    _trainer().train(table2, chunks, start_chunk=state.next_chunk)
    np.testing.assert_array_equal(table2.to_numpy(), expected)


def test_streaming_stop_without_checkpointer_still_interrupts(rng):
    chunks, (n_ent, k), _ = _stream_fit_chunks(rng)
    with pytest.raises(TrainingInterrupted) as ei:
        _trainer(prefetch=False).train(_table(n_ent, k), chunks, should_stop=lambda: True)
    assert ei.value.checkpoint_path is None
    assert ei.value.step == 0


def test_streaming_checkpoints_restore_across_packages(rng, tmp_path):
    """A streaming checkpoint (coefficients and variances) written by either
    package restores in the other, bit for bit, and a corrupt newest
    directory is skipped in both."""
    table = rng.normal(size=(10, 3)).astype(np.float32)
    variances = rng.random((10, 3)).astype(np.float32)
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    StreamingCheckpointManager(CheckpointSpec(directory=str(t_dir))).save(
        j_ckpt.StreamCheckpointState(next_chunk=3, coefficients=torch.from_numpy(table),
                                     variances=torch.from_numpy(variances)))
    j_ckpt.StreamingCheckpointManager(j_ckpt.CheckpointSpec(directory=str(j_dir))).save(
        j_ckpt.StreamCheckpointState(next_chunk=5, coefficients=jnp.asarray(table),
                                     variances=jnp.asarray(variances)))
    for directory, next_chunk in ((t_dir, 3), (j_dir, 5)):
        # a newer, corrupt checkpoint (no manifest) is skipped by both
        (directory / "chunk-00000009").mkdir()
        got_j = j_ckpt.StreamingCheckpointManager.open_for_restore(str(directory)).restore()
        got_t = StreamingCheckpointManager.open_for_restore(str(directory)).restore()
        for got in (got_j, got_t):
            assert got.next_chunk == next_chunk
            np.testing.assert_array_equal(got.coefficients, table)
            np.testing.assert_array_equal(got.variances, variances)
    placed = StreamingCheckpointManager.open_for_restore(str(j_dir)).restore_placed(device=CPU)
    assert torch.equal(placed.coefficients, torch.from_numpy(table))
    assert placed.saved_env["backend"] == jax.default_backend()
    with pytest.raises(Exception, match="read-only"):
        StreamingCheckpointManager.open_for_restore(str(t_dir)).save(
            j_ckpt.StreamCheckpointState(next_chunk=4, coefficients=table))


def test_streaming_checkpoint_retention_and_fresh_start(rng, tmp_path):
    chunks, (n_ent, k), _ = _stream_fit_chunks(rng)
    spec = CheckpointSpec(directory=str(tmp_path / "c"), every=1, keep_last=2)
    _trainer().train(_table(n_ent, k), chunks, checkpointer=StreamingCheckpointManager(spec))
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == [
        "chunk-00000003", "chunk-00000004"]
    fresh = StreamingCheckpointManager(dataclasses.replace(spec, resume=False))
    assert fresh.restore() is None and not list((tmp_path / "c").iterdir())
