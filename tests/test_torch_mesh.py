"""The port's mesh and placement (``photon_ml_tpu_torch/parallel/mesh.py`` and
``sharding.py``) and its entity-sharded streamed table, on ``[cpu] * 8``,
against the JAX package's 8-device CPU mesh (tests/test_multichip.py:103-163,
tests/test_streaming.py:150-195), from the same numpy draws:

- ``make_mesh``: axis views, the device count it refuses, a device list in
  which a device repeats;
- ``shard_rows`` / ``place_batch`` on 403 rows over 8 shards: the shards are
  the rows in order, the padding rows hold nothing and weigh 0, and
  ``pad_batch_rows`` leaves the objective unchanged;
- the ownership arithmetic (``valid_entity_axis_sizes``,
  ``entity_axis_mismatch``, ``member_row_range``, ``owner_of_row``) equal
  to the reference's;
- ``ShardedCoefficientTable(mesh=...)`` and ``StreamingRandomEffectTrainer
  (mesh=...)``: within the reference's mesh-vs-single-device tolerance of the
  unsharded port (rtol 2e-3, atol 2e-4; the final loss to 1e-6, relative,
  tests/test_multichip.py:103-163) and within the cross-package streamed
  tolerance of tests/test_torch_streaming.py (rtol 5e-3, atol 5e-4) of the
  JAX table on its mesh, each device holding an eighth of the table's bytes;
  an indivisible table or chunk refused with the reference's messages;
- a mesh table's streaming checkpoint: one payload file per block, the
  reference's sharding record, restored onto 8, 4 and no shards (``elastic``
  as the reference says it), an indivisible target refused, and checkpoints
  read across the two packages;
- ``parse_mesh_flag`` as the reference's, and ``cli train --mesh
  batch=2,model=4`` in both packages on the same Avro files (models within
  tests/test_torch_cli.py's FIT_TOL; tests/test_cli.py:414-428, 617-631); a
  mesh with a sweep refused.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import train as j_train
from photon_ml_tpu.data import avro as JA
from photon_ml_tpu.data import model_store as JM
from photon_ml_tpu.game import checkpoint as j_ckpt
from photon_ml_tpu.game.streaming import ShardedCoefficientTable as JTable
from photon_ml_tpu.game.streaming import StreamingRandomEffectTrainer as JTrainer
from photon_ml_tpu.ops.dense import DenseBatch as JDense
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu.parallel import make_mesh as j_make_mesh
from photon_ml_tpu.parallel import sharding as j_sharding
from photon_ml_tpu_torch.cli import train as t_train
from photon_ml_tpu_torch.data import model_store as TM
from photon_ml_tpu_torch.game.checkpoint import CheckpointSpec, StreamingCheckpointManager, \
    StreamCheckpointState
from photon_ml_tpu_torch.game.streaming import (
    ShardedCoefficientTable,
    StreamingRandomEffectTrainer,
)
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.parallel import (
    ElasticPlacementError,
    EntityShards,
    entity_axis_mismatch,
    make_mesh,
    member_row_range,
    owner_of_row,
    pad_batch_rows,
    place_batch,
    place_entities,
    shard_rows,
    valid_entity_axis_sizes,
)

CPU = torch.device("cpu")
_CFG = OptimizerConfig(max_iterations=60, tolerance=1e-9,
                       regularization=RegularizationContext(RegularizationType.L2),
                       regularization_weight=0.3)
_JCFG = JOpt(max_iterations=60, tolerance=1e-9, regularization=JReg(JRegType.L2),
             regularization_weight=0.3)
# tests/test_torch_streaming.py's port-vs-JAX streamed-table tolerance
TABLE_TOL = dict(rtol=5e-3, atol=5e-4)


def _cpu_mesh(sizes):
    return make_mesh(sizes, [CPU] * int(np.prod(list(sizes.values()))))


def test_make_mesh_views_and_refusals():
    mesh = make_mesh({"batch": 4, "model": 2}, [torch.device("cpu", i % 3) for i in range(8)])
    assert mesh.shape == {"batch": 4, "model": 2} and mesh.first_device == torch.device("cpu", 0)
    assert [d.index for d in mesh.axis_devices("batch")] == [0, 2, 1, 0]
    assert [d.index for d in mesh.axis_devices("model")] == [0, 1]
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh({"data": 8}, [CPU] * 4)
    if torch.cuda.device_count() < 64:  # the default takes CUDA devices only, never repeats
        with pytest.raises(ValueError, match="needs 64 devices"):
            make_mesh({"data": 64})


def test_shard_rows_pads_403_rows_over_8_inert_shards(rng):
    X = rng.normal(size=(403, 7)) * (rng.random((403, 7)) < 0.4)
    y = (rng.random(403) < 0.5).astype(float)
    wt = rng.random(403) + 0.5
    batch = CSRBatch.from_dense(X, y, weights=wt, device=CPU)
    shards = shard_rows(batch, 8)
    assert [int(s.labels.shape[0]) for s in shards] == [51] * 8
    placed = place_batch(batch, _cpu_mesh({"batch": 8}))
    dense = np.concatenate([b.to_dense() for b in placed.shards])
    np.testing.assert_array_equal(dense[:403], X.astype(np.float32))
    assert not dense[403:].any() and placed.num_rows == 403
    assert not placed.shards[-1].weights[403 - 7 * 51:].any()
    np.testing.assert_array_equal(torch.cat(placed.weights)[:403].numpy(), wt.astype(np.float32))
    obj = make_objective("logistic", l2_weight=0.5)
    w = torch.from_numpy(rng.normal(size=7).astype(np.float32))
    padded = pad_batch_rows(batch, 8)
    assert padded.num_rows == 408
    for a, b in zip(obj.value_and_grad(w, padded), obj.value_and_grad(w, batch)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_ownership_arithmetic_equals_the_reference():
    assert len(jax.devices()) == 8
    for n in (1, 12, 30, 32, 97):
        assert valid_entity_axis_sizes(n, 8) == j_sharding.valid_entity_axis_sizes(n)
        assert str(entity_axis_mismatch(n, "model", 8)) == str(
            j_sharding.entity_axis_mismatch(n, "model", 8))
    for members in (1, 2, 4, 8):
        for m in range(members):
            assert member_row_range(32, m, members) == j_sharding.member_row_range(32, m, members)
        for row in (0, 5, 31):
            assert owner_of_row(32, row, members) == j_sharding.owner_of_row(32, row, members)
    with pytest.raises(ElasticPlacementError, match="valid fleet sizes"):
        member_row_range(30, 0, 4)
    with pytest.raises(ElasticPlacementError, match=r"valid target axis sizes.*\[1, 2, 3\]"):
        place_entities(torch.zeros(6, 2), _cpu_mesh({"model": 4}))


def _entities(rng, n_ent=32, rows=8, k=5):
    X = rng.normal(size=(n_ent, rows, k)).astype(np.float32)
    W = rng.normal(size=(n_ent, k))
    y = (rng.random((n_ent, rows)) < 1 / (1 + np.exp(-np.einsum("erk,ek->er", X, W))))
    return X, y.astype(np.float32)


def _chunk(X, y, lo, hi, dense=DenseBatch):
    rows = X.shape[1]
    return dense(x=X[lo:hi], labels=y[lo:hi], offsets=np.zeros((hi - lo, rows), np.float32),
                 weights=np.ones((hi - lo, rows), np.float32))


def test_sharded_table_matches_the_reference_mesh(rng):
    X, y = _entities(rng)
    n_ent, _, k = X.shape
    jmesh = j_make_mesh({"entity": 8})
    jt = JTable(n_ent, k, mesh=jmesh)
    JTrainer("logistic", _JCFG, mesh=jmesh).train(jt, [(0, _chunk(X, y, 0, 16, JDense)),
                                                        (16, _chunk(X, y, 16, 32, JDense))])
    mesh = _cpu_mesh({"entity": 8})
    table = ShardedCoefficientTable(n_ent, k, mesh=mesh)
    assert table.sharding == {"mesh_axes": {"entity": 8}, "spec": ["entity"]}
    stats = StreamingRandomEffectTrainer("logistic", _CFG, mesh=mesh).train(
        table, [(0, _chunk(X, y, 0, 16)), (16, _chunk(X, y, 16, 32))], with_tracker=True)
    # per-device residency: every device holds an eighth of the table
    assert table.shard_nbytes() == [table.nbytes // 8] * 8
    np.testing.assert_allclose(table.to_numpy(), np.asarray(jt.coefficients), **TABLE_TOL)
    plain = ShardedCoefficientTable(n_ent, k, device=CPU)
    plain_stats = StreamingRandomEffectTrainer("logistic", _CFG, device=CPU).train(
        plain, [(0, _chunk(X, y, 0, 16)), (16, _chunk(X, y, 16, 32))], with_tracker=True)
    # the reference's mesh-vs-single-device tolerance (tests/test_streaming.py:181): a
    # piece's batched products round as the whole chunk's need not, and at tolerance
    # 1e-9 a lane's last steps on its plateau follow the rounding
    np.testing.assert_allclose(table.to_numpy(), plain.to_numpy(), rtol=2e-3, atol=2e-4)
    assert abs(stats.total_final_value - plain_stats.total_final_value) <= 1e-6 * abs(
        plain_stats.total_final_value)


def test_sharded_table_rows_and_refusals(rng):
    mesh = _cpu_mesh({"model": 4})
    with pytest.raises(ValueError, match="must divide over the 4-device 'model' axis"):
        ShardedCoefficientTable(30, 4, mesh=mesh)
    table = ShardedCoefficientTable(8, 2, mesh=mesh)
    table.write_chunk(1, torch.arange(10.0).reshape(5, 2))  # spans three blocks
    assert table.to_numpy()[1:6].ravel().tolist() == list(range(10))
    assert table.read_chunk(3, 3).ravel().tolist() == [4.0, 5.0, 6.0, 7.0, 8.0, 9.0]
    with pytest.raises(ValueError, match="out of bounds"):
        table.read_chunk(6, 3)
    X, y = _entities(rng, n_ent=8, rows=4, k=2)
    trainer = StreamingRandomEffectTrainer("logistic", _CFG, mesh=mesh)
    with pytest.raises(ValueError, match="chunk of 6 entities must divide over the 4-device"):
        trainer.train(table, [(0, _chunk(X, y, 0, 6))])
    wrapped = ShardedCoefficientTable.from_coefficients(table.coefficients)
    assert wrapped.coefficients is table.coefficients and wrapped.mesh is mesh
    again = ShardedCoefficientTable.from_coefficients(torch.from_numpy(table.to_numpy()),
                                                      mesh=_cpu_mesh({"model": 2}))
    assert again.shard_nbytes() == [32, 32]
    np.testing.assert_array_equal(again.to_numpy(), table.to_numpy())


def test_mesh_streaming_checkpoints_restore_elastically_and_across_packages(rng, tmp_path):
    X, y = _entities(rng, n_ent=32, rows=6, k=3)
    mesh = _cpu_mesh({"entity": 8})
    table = ShardedCoefficientTable(32, 3, mesh=mesh)
    mgr = StreamingCheckpointManager(CheckpointSpec(directory=str(tmp_path / "p"), every=1))
    StreamingRandomEffectTrainer("logistic", _CFG, mesh=mesh).train(
        table, [(0, _chunk(X, y, 0, 16)), (16, _chunk(X, y, 16, 32))], checkpointer=mgr)
    newest = tmp_path / "p" / "chunk-00000002"
    manifest = json.loads((newest / "manifest.json").read_text())
    assert manifest["sharding"] == {"mesh_axes": {"entity": 8}, "spec": ["entity"]}
    assert [s["row_start"] for s in manifest["shards"]] == list(range(0, 32, 4))
    assert len([f for f in os.listdir(newest) if f.startswith("coefficients-")]) == 8
    reader = StreamingCheckpointManager.open_for_restore(str(tmp_path / "p"))
    for target, elastic in ((mesh, False), (_cpu_mesh({"entity": 4}), True), (None, True)):
        got = reader.restore_placed(mesh=target, device=CPU)
        assert got.elastic is elastic and got.next_chunk == 2
        coeffs = got.coefficients
        if target is not None:
            assert isinstance(coeffs, EntityShards) and len(coeffs.parts) == target.shape["entity"]
            coeffs = coeffs.numpy()
        np.testing.assert_array_equal(np.asarray(coeffs), table.to_numpy())
    with pytest.raises(ElasticPlacementError, match="valid target axis sizes"):
        reader.restore_placed(mesh=_cpu_mesh({"entity": 3}))
    # the JAX package restores the port's sharded checkpoint onto its mesh, and back
    jgot = j_ckpt.StreamingCheckpointManager.open_for_restore(str(tmp_path / "p")).restore_placed(
        mesh=j_make_mesh({"entity": 4}, jax.devices()[:4]))
    assert jgot.elastic
    np.testing.assert_array_equal(np.asarray(jgot.coefficients), table.to_numpy())
    jtable = JTable(32, 3, mesh=j_make_mesh({"entity": 8}))
    jtable.coefficients = jax.device_put(jnp.asarray(table.to_numpy()), jtable.sharding)
    j_ckpt.StreamingCheckpointManager(j_ckpt.CheckpointSpec(directory=str(tmp_path / "j"))).save(
        j_ckpt.StreamCheckpointState(next_chunk=5, coefficients=jtable.coefficients))
    got = StreamingCheckpointManager.open_for_restore(str(tmp_path / "j")).restore_placed(
        mesh=mesh)
    assert not got.elastic and got.saved_sharding == manifest["sharding"]
    np.testing.assert_array_equal(got.coefficients.numpy(), table.to_numpy())
    resumed = ShardedCoefficientTable.from_coefficients(got.coefficients)
    mgr.save(StreamCheckpointState(next_chunk=9, coefficients=resumed.coefficients))
    assert StreamingCheckpointManager.open_for_restore(str(tmp_path / "p")).restore().next_chunk == 9


def test_parse_mesh_flag_as_the_reference():
    for raw in ("batch=8", "batch=4,model=2", "model=8", "auto", "off", " batch=2 , model=4 "):
        assert t_train.parse_mesh_flag(raw) == j_train.parse_mesh_flag(raw)
    for raw, match in (("batch", "axis=N"), ("batch=many", "integer size"), (" , ", "no axes")):
        with pytest.raises(ValueError, match=match):
            t_train.parse_mesh_flag(raw)


@pytest.fixture(scope="module")
def avro_files(tmp_path_factory):
    rng = np.random.default_rng(21)
    tmp = tmp_path_factory.mktemp("mesh_cli")
    n, d, n_users = 160, 6, 7
    X = rng.normal(size=(n, d))
    users = rng.integers(0, n_users, n)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ rng.normal(size=d)
                                            + rng.normal(size=n_users)[users])))).astype(float)
    path = str(tmp / "train.avro")
    JA.write_avro(path, JA.TRAINING_EXAMPLE_AVRO, (
        {"uid": str(i), "label": float(y[i]),
         "features": [{"name": f"c{j}", "term": "", "value": float(X[i, j])} for j in range(d)],
         "metadataMap": {"userId": str(users[i])}, "weight": None, "offset": None}
        for i in range(n)))
    return tmp, path


def _cli_config(path, out):
    return {"task": "logistic",
            "input": {"format": "avro", "paths": [path], "feature_shards": {"global": ["features"]},
                      "id_columns": ["userId"]},
            "coordinates": {
                "fixed": {"type": "fixed_effect", "shard_name": "global",
                          "optimizer": {"regularization": "l2", "regularization_weight": 0.1}},
                "perUser": {"type": "random_effect", "shard_name": "global", "id_name": "userId",
                            "optimizer": {"regularization": "l2", "regularization_weight": 1.0}}},
            "num_iterations": 1, "output_dir": out, "heartbeat": False}


def test_cli_train_with_mesh_matches_the_reference(avro_files):
    tmp, path = avro_files
    out = {pkg: str(tmp / pkg) for pkg in ("jax", "port")}
    for pkg, main, extra in (("jax", j_train.main, []), ("port", t_train.main,
                                                           ["--device", "cpu"])):
        cfg = tmp / f"{pkg}.json"
        cfg.write_text(json.dumps(_cli_config(path, out[pkg])))
        assert main(["--config", str(cfg), "--mesh", "batch=2,model=4", *extra]) in (0, None)
    jm = JM.load_game_model(os.path.join(out["jax"], "final"))
    tm = TM.load_game_model(os.path.join(out["port"], "final"), device="cpu")
    np.testing.assert_allclose(tm.models["fixed"].coefficients.numpy(),
                               np.asarray(jm.models["fixed"].coefficients), rtol=1e-3, atol=1e-3)
    for tb, jb in zip(tm.models["perUser"].buckets, jm.models["perUser"].buckets):
        np.testing.assert_allclose(tb.coefficients.numpy(), np.asarray(jb.coefficients),
                                   rtol=1e-3, atol=1e-3)
    sweep = {**_cli_config(path, out["port"]), "validation": {"paths": [path]},
             "sweep": {"grid": "lambda=1,2"}, "mesh": {"batch": 2}}
    with pytest.raises(ValueError, match="mesh training is not supported with a GAME sweep"):
        t_train.run(sweep, device="cpu")
