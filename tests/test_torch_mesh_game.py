"""GLMix training on the port's mesh (``GameEstimator.fit(mesh=...)`` and
``fit_grid(mesh=...)``) on ``[cpu] * 8`` against
the JAX package's on its 8-device CPU mesh (tests/test_mesh_game.py:82-228,
tests/test_multichip.py:165-260), from the reference tests' numpy draws:

- a legacy 1-D ``data`` mesh: fixed- and random-effect coefficients within
  rtol 2e-3 / atol 2e-4 and scores within 2e-3, with 13 users (not a
  multiple of 8: the entity padding), also under a standardization;
- random-effect variances and boxes on the mesh: per-entity objective
  values within the reference's 2.5e-2 band, variances positive, the box
  held;
- the named 2-D ``batch`` x ``model`` mesh (rtol/atol 5e-3);
- a 1-shard mesh gives the unsharded fit bit for bit; a mesh fit repeats bit
  for bit, and a checkpointed mesh fit stopped after 2 updates and resumed is
  the uninterrupted one bit for bit; ``fit_grid(mesh=...)`` entries are their
  combinations' mesh fits;
- the refusals: an entity-only mesh leaves the fixed effect unsharded, a
  mesh that names neither axis, a mesh whose first device is not the
  dataset's, ``gspmd_solve`` without a batch axis.

``cli train --mesh`` is tests/test_torch_mesh.py's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.normalization import NormalizationType as JNorm
from photon_ml_tpu.game import FixedEffectConfig as JFEConfig
from photon_ml_tpu.game import GameConfig as JGameConfig
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JREConfig
from photon_ml_tpu.game import build_game_dataset as j_build
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu.parallel import make_mesh as j_make_mesh
from photon_ml_tpu_torch.game import (
    CheckpointSpec,
    FeatureShard,
    FixedEffectConfig,
    GameConfig,
    GameEstimator,
    RandomEffectConfig,
    TrainingInterrupted,
    build_game_dataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.parallel import gspmd_solve, make_mesh

CPU = torch.device("cpu")
MESH_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_mesh_game.py:82-116
MESH_2D_TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_multichip.py:165-215
_OPT = dict(max_iterations=60, tolerance=1e-9, regularization_weight=0.5)
_JOPT = JOpt(regularization=JReg(JRegType.L2), **_OPT)
_TOPT = OptimizerConfig(regularization=RegularizationContext(RegularizationType.L2), **_OPT)


def _cpu_mesh(sizes):
    return make_mesh(sizes, [CPU] * int(np.prod(list(sizes.values()))))


def _glmix(seed, n=300, n_users=13):
    # n_users not a multiple of 8: the entity padding
    rng = np.random.default_rng(seed)
    Xg = rng.normal(size=(n, 6)) * (rng.random((n, 6)) < 0.6)
    Xg[:, 0] = 1.0
    Xu = rng.normal(size=(n, 3))
    users = rng.integers(0, n_users, size=n)
    margin = Xg @ rng.normal(size=6) + np.einsum("ij,ij->i", Xu,
                                                 rng.normal(size=(n_users, 3))[users])
    y = (rng.random(n) < 1 / (1 + np.exp(-margin))).astype(float)
    jds = j_build(response=y, feature_shards={"global": JSparse.from_dense(Xg, y),
                                              "user": JSparse.from_dense(Xu, y)},
                  id_columns={"userId": users})
    tds = build_game_dataset(response=y, feature_shards={"global": FeatureShard.from_dense(Xg),
                                                         "user": FeatureShard.from_dense(Xu)},
                             id_columns={"userId": users}, device="cpu")
    return jds, tds


@pytest.fixture(scope="module")
def data():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return _glmix(12345)  # tests/conftest.py's rng: the reference test's draw


def _configs(re=True, fe=True, num_iterations=2, re_opt=None, variances=False, **fe_extra):
    jre_opt = _JOPT if re_opt is None else re_opt[0]
    tre_opt = _TOPT if re_opt is None else re_opt[1]
    jc, tc = {}, {}
    if fe:
        jc["fixed"] = JFEConfig(shard_name="global", optimizer=_JOPT,
                                **{k: JNorm(v) if k == "normalization" else v
                                   for k, v in fe_extra.items()})
        tc["fixed"] = FixedEffectConfig(shard_name="global", optimizer=_TOPT, **fe_extra)
    if re:
        jc["per-user"] = JREConfig(shard_name="user", id_name="userId", optimizer=jre_opt,
                                   compute_variances=variances)
        tc["per-user"] = RandomEffectConfig(shard_name="user", id_name="userId",
                                            optimizer=tre_opt, compute_variances=variances)
    return (JGameConfig(task="logistic", coordinates=jc, num_iterations=num_iterations),
            GameConfig(task="logistic", coordinates=tc, num_iterations=num_iterations))


def _close(tmodel, jmodel, tol, names=("fixed", "per-user")):
    if "fixed" in names:
        np.testing.assert_allclose(tmodel.models["fixed"].coefficients.numpy(),
                                   np.asarray(jmodel.models["fixed"].coefficients), **tol)
    if "per-user" in names:
        tb, jb = tmodel.models["per-user"].buckets, jmodel.models["per-user"].buckets
        assert len(tb) == len(jb)
        for t, j in zip(tb, jb):
            np.testing.assert_allclose(t.coefficients.numpy(), np.asarray(j.coefficients), **tol)


def _same(a, b):
    """Two GAME models bit for bit."""
    for name, m in a.models.items():
        other = b.models[name]
        if hasattr(m, "buckets"):
            assert all(torch.equal(x.coefficients, y.coefficients)
                       for x, y in zip(m.buckets, other.buckets))
        else:
            assert torch.equal(m.coefficients, other.coefficients)


@pytest.mark.parametrize("norm", [None, "standardization"])
def test_mesh_fit_matches_the_reference_mesh(data, norm):
    jds, tds = data
    fe_extra = {} if norm is None else {"normalization": norm, "intercept_index": 0}
    jcfg, tcfg = _configs(**fe_extra)
    jfit = JEstimator(jcfg).fit(jds, mesh=j_make_mesh({"data": 8}))
    tfit = GameEstimator(tcfg).fit(tds, mesh=_cpu_mesh({"data": 8}))
    _close(tfit.model, jfit.model, MESH_TOL)
    np.testing.assert_allclose(tfit.model.score(tds).numpy(),
                               np.asarray(jfit.model.score(jds))[:tds.num_rows],
                               rtol=2e-3, atol=2e-3)


def test_mesh_re_variances_and_boxes(data):
    """Per-entity boxes and variances over padded entity blocks: the
    objective values within the reference's band of the JAX mesh fit's,
    variances positive, the box held (tests/test_mesh_game.py:174-228)."""
    jds, tds = data
    boxed = ((0, -0.1, 0.1),)
    jcfg, tcfg = _configs(fe=False, num_iterations=1, variances=True, re_opt=(
        dataclasses.replace(_JOPT, box_constraints=boxed),
        dataclasses.replace(_TOPT, box_constraints=boxed)))
    jfit = JEstimator(jcfg).fit(jds, mesh=j_make_mesh({"data": 8}))
    tfit = GameEstimator(tcfg).fit(tds, mesh=_cpu_mesh({"data": 8}))
    obj = make_objective("logistic", l2_weight=0.5)
    red = build_random_effect_dataset(tds, "userId", "user")
    for b, tb, jb in zip(red.buckets, tfit.model.models["per-user"].buckets,
                         jfit.model.models["per-user"].buckets):
        batch = DenseBatch.from_arrays(_dense(b), b.labels, b.offsets, b.weights, device="cpu")
        np.testing.assert_allclose(obj.value(tb.coefficients, batch).numpy(),
                                   obj.value(torch.from_numpy(np.asarray(jb.coefficients)),
                                             batch).numpy(), rtol=2.5e-2, atol=1e-4)
        assert bool((tb.variances > 0).all())
        w, proj = tb.coefficients.numpy(), tb.projection.numpy()
        assert np.all(np.abs(w[proj == 0]) <= 0.1 + 1e-6)


def _dense(b):
    x = np.zeros((b.num_entities, b.rows_per_entity, b.num_local_features), np.float32)
    e = np.broadcast_to(np.arange(b.num_entities)[:, None], b.rows.shape)
    np.add.at(x, (e, b.rows, b.cols), b.values)
    return x


def test_2d_batch_model_mesh_matches_the_reference(data):
    jds, tds = data
    jcfg, tcfg = _configs()
    jfit = JEstimator(jcfg).fit(jds, mesh=j_make_mesh({"batch": 4, "model": 2}))
    tfit = GameEstimator(tcfg).fit(tds, mesh=_cpu_mesh({"batch": 4, "model": 2}))
    _close(tfit.model, jfit.model, MESH_2D_TOL)


def test_one_shard_is_the_unsharded_fit_and_a_mesh_fit_repeats(data, tmp_path):
    _, tds = data
    _, tcfg = _configs()
    plain = GameEstimator(tcfg).fit(tds, device="cpu")
    _same(GameEstimator(tcfg).fit(tds, mesh=_cpu_mesh({"batch": 1, "model": 1})).model,
          plain.model)
    mesh = _cpu_mesh({"batch": 4, "model": 2})
    est = GameEstimator(tcfg)
    first = est.fit(tds, mesh=mesh)
    _same(est.fit(tds, mesh=mesh).model, first.model)  # the cached coordinates again
    # stopped after its second update with a checkpoint a step, then resumed
    spec = CheckpointSpec(directory=str(tmp_path / "ckpt"))
    polls = iter(range(100))
    with pytest.raises(TrainingInterrupted) as stopped:
        GameEstimator(tcfg).fit(tds, mesh=mesh, checkpoint_spec=spec,
                                should_stop=lambda: next(polls) == 1)
    assert stopped.value.step == 1
    resumed = GameEstimator(tcfg).fit(tds, mesh=mesh, checkpoint_spec=spec)
    _same(resumed.model, first.model)
    grid = {"fixed": [_TOPT, dataclasses.replace(_TOPT, regularization_weight=5.0)]}
    tcfg_eval = dataclasses.replace(tcfg, evaluators=["auc"])
    entries = GameEstimator(tcfg_eval).fit_grid(tds, tds, grid, mesh=mesh)
    for e in entries:
        single = dataclasses.replace(tcfg_eval, coordinates={
            **tcfg_eval.coordinates, "fixed": dataclasses.replace(
                tcfg_eval.coordinates["fixed"], optimizer=e.optimizer_configs["fixed"])})
        _same(e.result.model, GameEstimator(single).fit(tds, mesh=mesh).model)


def test_mesh_refusals(data):
    _, tds = data
    _, fe_only = _configs(re=False, num_iterations=1)
    plain = GameEstimator(fe_only).fit(tds, device="cpu")
    # an entity-only mesh has no row axis: the fixed effect runs unsharded
    _same(GameEstimator(fe_only).fit(tds, mesh=_cpu_mesh({"model": 8})).model, plain.model)
    with pytest.raises(ValueError, match="neither a batch/data"):
        GameEstimator(fe_only).fit(tds, mesh=_cpu_mesh({"x": 4, "y": 2}))
    with pytest.raises(ValueError, match="the dataset lives on cpu but the fit runs on cpu:1"):
        GameEstimator(fe_only).fit(tds, mesh=make_mesh({"data": 2}, [torch.device("cpu", 1)] * 2))
    batch = tds.csr_batch("global")
    with pytest.raises(ValueError, match="batch/data axis"):
        gspmd_solve("logistic", batch, _TOPT, torch.zeros(batch.num_features),
                    _cpu_mesh({"model": 8}))


@pytest.mark.parametrize("box", [None, ((0, -0.1, 0.1),)], ids=["free", "boxed"])
def test_coo_buckets_on_an_entity_mesh_are_the_unsharded_lanes(monkeypatch, box):
    """Buckets routed to the block-diagonal layout, padded over 3 owners:
    each lane, its variances included, is the unsharded solve's bit for bit
    (a lane's CSR sweeps do not depend on the other lanes)."""
    from photon_ml_tpu_torch.game import random_effect_data as t_red

    monkeypatch.setattr(t_red, "_bucket_dense_design", lambda b: None)
    rng = np.random.default_rng(5)
    X = rng.normal(size=(400, 30)) * (rng.random((400, 30)) < 0.3)
    tds = build_game_dataset(response=(rng.random(400) < 0.5).astype(float),
                             feature_shards={"global": FeatureShard.from_dense(X)},
                             id_columns={"userId": rng.integers(0, 13, 400)}, device="cpu")
    opt = dataclasses.replace(_TOPT, max_iterations=20, tolerance=1e-7, box_constraints=box)
    cfg = GameConfig(task="logistic", coordinates={"pu": RandomEffectConfig(
        shard_name="global", id_name="userId", optimizer=opt, compute_variances=True)})
    plain = GameEstimator(cfg).fit(tds, device="cpu").model.models["pu"]
    sharded = GameEstimator(cfg).fit(tds, mesh=_cpu_mesh({"model": 3})).model.models["pu"]
    for a, b in zip(sharded.buckets, plain.buckets):
        assert torch.equal(a.coefficients, b.coefficients) and torch.equal(a.variances,
                                                                           b.variances)


def _max_diff(a, b):
    """The largest coefficient difference between two GAME models of one
    structure (fixed effect and every random-effect bucket)."""
    def coefs(m):
        out = [np.asarray(m.models["fixed"].coefficients)]
        out += [np.asarray(b.coefficients) for b in m.models["per-user"].buckets]
        return out

    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return max(float(np.max(np.abs(host(x) - host(y))))
               for x, y in zip(coefs(a), coefs(b)))


def test_seed_3_mesh_difference_is_within_the_references_own():
    """At seed 3 the mesh fit leaves the single-device fit by more than the
    reference test's 2e-3/2e-4 on a plateau element; the JAX package's own
    mesh-vs-single fit does so too. The port's mesh-vs-single difference is
    held to be no larger than the JAX package's."""
    jds, tds = _glmix(3)
    jcfg, tcfg = _configs()
    j_single = JEstimator(jcfg).fit(jds).model
    j_mesh = JEstimator(jcfg).fit(jds, mesh=j_make_mesh({"data": 8})).model
    t_single = GameEstimator(tcfg).fit(tds, device="cpu").model
    t_mesh = GameEstimator(tcfg).fit(tds, mesh=_cpu_mesh({"data": 8})).model
    j_diff, t_diff = _max_diff(j_mesh, j_single), _max_diff(t_mesh, t_single)
    assert t_diff <= j_diff, (t_diff, j_diff)
