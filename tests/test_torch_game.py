"""The port's GLMix training (``photon_ml_tpu_torch.game``) against the JAX
package's, on the CPU: random-effect buckets array for array, a
``GameEstimator.fit`` of a fixed effect (LBFGS) plus a per-user random effect
(batched NEWTON) over two coordinate-descent iterations, GAME models carried
across by ``convert.game_model_from_jax`` and scored on rows of passive and
unseen entities, and every ``NotImplementedError`` branch left (a mesh, the
estimator's incremental fit and a sweep's registry; the random projector, a
factored coordinate, the checkpoint and the stop now fit).

Tolerances: buckets exact (the same numpy build); carried-over scores
rtol 1e-5 (the same float32 products, summed in another order); fitted
scores rtol 1e-3, atol 1e-3 (20 LBFGS iterations then Newton solves
tightened to 1e-7 in float32: the two packages sum in different orders, so
the last iterates differ at the noise level of each solve, as in
tests/test_game.py's per-entity parity); validation metrics after each
coordinate update, the sharded ones over the userId column included, atol
1e-4 (a per-member AUC moves 5.6e-5 with those scores).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.game import FixedEffectConfig as JFEConfig
from photon_ml_tpu.game import GameConfig as JGameConfig
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JREConfig
from photon_ml_tpu.game import build_game_dataset as j_build
from photon_ml_tpu.game import build_random_effect_dataset as j_build_re
from photon_ml_tpu.game.coordinates import _bucket_dense_design as j_dense_design
from photon_ml_tpu.game.random_effect_data import EntityBucket as JBucket
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import OptimizerType as JOptType
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.evaluation.evaluators import auc
from photon_ml_tpu_torch.game import (
    CheckpointSpec,
    FactoredRandomEffectConfig,
    FactoredRandomEffectModel,
    FeatureShard,
    FixedEffectConfig,
    GameConfig,
    GameEstimator,
    RandomEffectConfig,
    RandomEffectCoordinate,
    TrainingInterrupted,
    build_game_dataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game import random_effect_data as t_red
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)

N, D_FE, N_USERS, D_RE = 2000, 200, 50, 4
CAP = 45  # active rows per user: the users above it keep passive rows


def _glmix(seed, n=N, n_users=N_USERS):
    rng = np.random.default_rng(seed)
    Xg = rng.normal(size=(n, D_FE)) * (rng.random((n, D_FE)) < 0.05)
    Xu = rng.normal(size=(n, D_RE)) * (rng.random((n, D_RE)) < 0.9)
    users = rng.integers(0, n_users, size=n)
    wg = rng.normal(size=D_FE) * 0.5
    wu = rng.normal(size=(n_users, D_RE))
    margin = Xg @ wg + np.einsum("ij,ij->i", Xu, wu[users])
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float64)
    return Xg, Xu, np.array([f"u{u:03d}" for u in users]), y


def _datasets(Xg, Xu, ids, y):
    jds = j_build(response=y, feature_shards={"global": JSparse.from_dense(Xg, y),
                                              "user": JSparse.from_dense(Xu, y)},
                  id_columns={"userId": ids})
    tds = build_game_dataset(response=y, feature_shards={"global": FeatureShard.from_dense(Xg),
                                                         "user": FeatureShard.from_dense(Xu)},
                             id_columns={"userId": ids}, device="cpu")
    return jds, tds


@pytest.fixture(scope="module")
def data():
    return _datasets(*_glmix(7))


def _configs(evaluators=("auc",)):
    reg = dict(regularization_weight=1.0, max_iterations=20)
    jfe = JOpt(tolerance=0.0, regularization=JReg(JRegType.L2), **reg)
    tfe = OptimizerConfig(tolerance=0.0, regularization=RegularizationContext(
        RegularizationType.L2), **reg)
    jre = dataclasses.replace(jfe, optimizer_type=JOptType.NEWTON, tolerance=1e-7)
    tre = dataclasses.replace(tfe, optimizer_type=OptimizerType.NEWTON, tolerance=1e-7)
    jcfg = JGameConfig(task="logistic", num_iterations=2, evaluators=list(evaluators), coordinates={
        "fixed": JFEConfig(shard_name="global", optimizer=jfe),
        "per-user": JREConfig(shard_name="user", id_name="userId", optimizer=jre,
                              active_rows_per_entity=CAP)})
    tcfg = GameConfig(task="logistic", num_iterations=2, evaluators=list(evaluators), coordinates={
        "fixed": FixedEffectConfig(shard_name="global", optimizer=tfe),
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId", optimizer=tre,
                                       active_rows_per_entity=CAP)})
    return jcfg, tcfg


@pytest.fixture(scope="module")
def fits(data):
    jds, tds = data
    jcfg, tcfg = _configs()
    return JEstimator(jcfg).fit(jds, validation_data=jds), \
        GameEstimator(tcfg).fit(tds, validation_data=tds, device="cpu")


# -- the random-effect build -------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"active_rows_per_entity": 30},
                                {"min_rows_per_entity": 38, "features_to_samples_ratio": 0.05}],
                         ids=["plain", "capped", "min_rows+pearson"])
def test_buckets_equal_the_reference(data, kw):
    jds, tds = data
    jr = j_build_re(jds, "userId", "user", **kw)
    tr = build_random_effect_dataset(tds, "userId", "user", **kw)
    assert len(tr.buckets) == len(jr.buckets)
    assert kw or len(tr.buckets) > 1  # users of several geometries
    for jb, tb, x in zip(jr.buckets, tr.buckets, tr.dense_designs()):
        for f in dataclasses.fields(tb):
            a, b = getattr(tb, f.name), getattr(jb, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        want = j_dense_design(jb)
        np.testing.assert_array_equal(x.reshape(want.shape), want)
    for f in ("entity_bucket", "entity_pos", "passive_rows"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f), err_msg=f)
    assert (tr.num_entities, tr.num_global_features) == (jr.num_entities, jr.num_global_features)
    assert ("capped" not in str(kw)) or len(tr.passive_rows) > 0


def test_dense_routing_rule_matches_the_reference():
    """A bucket whose dense design is far above the COO footprint routes to
    COO (None) on both sides; a small one is dense."""
    for k, dense in ((2**25, False), (4, True)):
        arrays = dict(values=np.ones((1, 2), np.float32), rows=np.zeros((1, 2), np.int32),
                      cols=np.array([[0, 1]], np.int32), labels=np.ones((1, 1), np.float32),
                      offsets=np.zeros((1, 1), np.float32), weights=np.ones((1, 1), np.float32),
                      projection=np.array([[0, 1] + [5] * (min(k, 4) - 2)], np.int32),
                      entity_codes=np.zeros(1, np.int32), row_index=np.zeros((1, 1), np.int32),
                      num_local_features=k, num_global_features=5)
        got = t_red._bucket_dense_design(t_red.EntityBucket(**arrays))
        want = j_dense_design(JBucket(**arrays))
        assert (got is not None) == (want is not None) == dense


# -- the fit -------------------------------------------------------------------


def test_fit_scores_match_the_reference(data, fits):
    jds, tds = data
    jfit, tfit = fits
    want = np.asarray(jfit.model.score(jds))[:N]
    got = tfit.model.score(tds).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    fe_want = np.asarray(jfit.model.models["fixed"].coefficients)
    np.testing.assert_allclose(tfit.model.models["fixed"].coefficients.numpy(), fe_want,
                               rtol=1e-3, atol=1e-3)
    assert [(h["iteration"], h["coordinate"]) for h in tfit.history] == \
        [(h["iteration"], h["coordinate"]) for h in jfit.history]
    np.testing.assert_allclose(tfit.best_metric, jfit.best_metric, atol=1e-4)


def test_glmix_beats_its_fixed_effect_alone(data, fits):
    _, tds = data
    _, tfit = fits
    labels, weights = tds.per_row(tds.response), tds.per_row(tds.weight)
    fe_scores = tfit.model.models["fixed"].score(tds)
    full = float(auc(tfit.model.score(tds), labels, weights))
    assert full > float(auc(fe_scores, labels, weights)) + 0.02


def test_coordinate_scores_equal_model_scores(data, fits):
    """The coordinate's bucket-slot scatter (active rows) and projection
    lookup (passive rows) give the model's own scores."""
    _, tds = data
    _, tfit = fits
    coord = GameEstimator(_configs()[1])._build_coordinates(tds)["per-user"]
    model = tfit.model.models["per-user"]
    assert len(coord.re_data.passive_rows) > 0
    np.testing.assert_allclose(coord.score(model).numpy(), model.score(tds).numpy(),
                               rtol=1e-5, atol=1e-6)


def _jax_arrays(jmodel):
    out = {}
    for name, m in jmodel.models.items():
        if hasattr(m, "buckets"):
            out[name] = dict(
                id_name=m.id_name, shard_name=m.shard_name, vocab=m.vocab,
                entity_bucket=m.entity_bucket, entity_pos=m.entity_pos,
                buckets=[dict(coefficients=np.asarray(b.coefficients),
                              projection=np.asarray(b.projection),
                              entity_codes=np.asarray(b.entity_codes)) for b in m.buckets])
        else:
            out[name] = dict(shard_name=m.shard_name,
                             coefficients=np.asarray(m.coefficients))
    return out


def test_game_model_from_jax_scores_passive_and_unseen_entities(fits):
    """A JAX-trained model carried across scores new data (users seen in
    training, users never seen, rows of capped users) as the JAX model does."""
    jfit, _ = fits
    Xg, Xu, ids, y = _glmix(8, n=600, n_users=70)  # u050-u069 never trained
    jds, tds = _datasets(Xg, Xu, ids, y)
    tmodel = convert.game_model_from_jax("logistic", _jax_arrays(jfit.model), device="cpu")
    want = np.asarray(jfit.model.score(jds))[:600]
    got = tmodel.score(tds).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    unseen = np.array([int(i[1:]) >= N_USERS for i in ids])
    assert unseen.any()
    fe_only = tmodel.models["fixed"].score(tds).numpy()
    np.testing.assert_array_equal(got[unseen], fe_only[unseen])
    np.testing.assert_allclose(tmodel.predict_mean(tds).numpy(),
                               np.asarray(jfit.model.predict_mean(jds))[:600], rtol=1e-5)


SHARDED = ("auc:userId", "precision@3:userId", "logistic_loss")


@pytest.fixture(scope="module")
def sharded_fits(data):
    jds, tds = data
    jcfg, tcfg = _configs(SHARDED)
    return JEstimator(jcfg).fit(jds, validation_data=jds), \
        GameEstimator(tcfg).fit(tds, validation_data=tds, device="cpu")


@pytest.mark.parametrize("spec", SHARDED)
def test_sharded_validation_metrics_match_the_reference(sharded_fits, spec):
    """Per-member AUC and precision@3 over the userId column, and the mean
    logistic loss, after every coordinate update of both fits."""
    jfit, tfit = sharded_fits
    want = [h["metrics"][spec] for h in jfit.history]
    got = [h["metrics"][spec] for h in tfit.history]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=1e-4)
    if spec == SHARDED[0]:
        np.testing.assert_allclose(tfit.best_metric, jfit.best_metric, atol=1e-4)


def test_sharded_evaluator_without_its_id_column_raises(data, fits):
    _, tds = data
    _, tfit = fits
    from photon_ml_tpu_torch.game.coordinate_descent import ValidationSpec, _evaluate

    with pytest.raises(KeyError, match="needs id column 'queryid'; have \\['userId'\\]"):
        _evaluate(tfit.model, ValidationSpec(data=tds, evaluators=["auc:queryId"]))
    with pytest.raises(ValueError, match="unknown evaluator"):
        _evaluate(tfit.model, ValidationSpec(data=tds, evaluators=["accuracy"]))


# -- what is not ported yet ------------------------------------------------------


def _re_coordinate(tds, **opt):
    cfg = OptimizerConfig(optimizer_type=OptimizerType.NEWTON, regularization=RegularizationContext(
        RegularizationType.L2), regularization_weight=1.0)
    red = build_random_effect_dataset(tds, "userId", "user")
    return lambda **kw: RandomEffectCoordinate("re", tds, red, "logistic",
                                               dataclasses.replace(cfg, **opt), **kw)


def test_random_effect_branches_not_ported_raise(data, monkeypatch):
    """Every branch of a random effect is ported: every optimizer, variances,
    a box, the COO layout and (ROADMAP item 10) the random projector, which
    fits a factored model in a fixed Gaussian space."""
    _, tds = data
    projected = GameConfig(task="logistic", coordinates={"re": RandomEffectConfig(
        shard_name="user", id_name="userId", projector="random", projected_dim=2)})
    model = GameEstimator(projected).fit(tds, device="cpu").model.models["re"]
    assert isinstance(model, FactoredRandomEffectModel)
    assert model.latent_dim == 2 and bool(model.latent.isfinite().all())
    for kind in OptimizerType:
        assert _re_coordinate(tds, optimizer_type=kind)().config.optimizer_type == kind
    boxed = _re_coordinate(tds, box_constraints=((0, -1.0, 1.0),))()
    assert all(c is not None for c in boxed._constraints)
    assert _re_coordinate(tds)(compute_variances=True).compute_variances
    monkeypatch.setattr(t_red, "_bucket_dense_design", lambda b: None)
    assert all(isinstance(b, t_red.CooBucket) for b in _re_coordinate(tds)()._buckets)


def test_estimator_and_descent_branches_not_ported_raise(data, tmp_path):
    """A factored random effect or the random projector on a mesh (ROADMAP
    item 12, in fit_grid too) and fit_incremental (item 14b) still raise,
    fit_sweep's registry needs index maps; the checkpoint and the stop (item
    10) work, and so
    does a factored coordinate and the random projector under NEWTON. (The
    mesh itself is ported: tests/test_torch_mesh_game.py.)"""
    from photon_ml_tpu_torch.parallel import make_mesh

    _, tds = data
    _, tcfg = _configs()
    est = GameEstimator(tcfg)
    mesh = make_mesh({"model": 2}, [torch.device("cpu")] * 2)
    projected = GameConfig(task="logistic", evaluators=["auc"], coordinates={
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId", projector="random",
                                       projected_dim=2,
                                       optimizer=tcfg.coordinates["per-user"].optimizer)})
    with pytest.raises(NotImplementedError, match="mesh.*item 12"):
        GameEstimator(projected).fit(tds, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 12"):
        GameEstimator(projected).fit_grid(tds, tds, {}, mesh=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        est.fit_incremental(tds)
    with pytest.raises(ValueError, match="registry requires index_maps"):
        est.fit_sweep(tds, tds, None, registry_dir=str(tmp_path / "r"), device="cpu")
    with pytest.raises(TrainingInterrupted) as ei:
        est.fit(tds, device="cpu", should_stop=lambda: True)
    assert (ei.value.step, ei.value.checkpoint_path) == (0, None)
    fit = est.fit(tds, device="cpu", checkpoint_spec=CheckpointSpec(directory=str(tmp_path)))
    assert sorted(os.listdir(tmp_path)) == ["step-00000001", "step-00000002", "step-00000003"]
    assert len(fit.history) == 4
    newton = OptimizerConfig(optimizer_type=OptimizerType.NEWTON)
    kinds = GameConfig(task="logistic", coordinates={
        "re": RandomEffectConfig(shard_name="user", id_name="userId", projector="random",
                                 projected_dim=2, optimizer=newton),
        "mf": FactoredRandomEffectConfig(shard_name="user", id_name="userId", latent_dim=2)})
    models = GameEstimator(kinds).fit(tds, device="cpu").model.models
    assert all(isinstance(m, FactoredRandomEffectModel) for m in models.values())
    assert models["mf"].projection.matrix.shape == (2, D_RE)


def test_fit_refuses_a_dataset_on_another_device(data):
    _, tds = data
    elsewhere = dataclasses.replace(tds, device=torch.device("meta"))
    with pytest.raises(ValueError, match="same device"):
        GameEstimator(_configs()[1]).fit(elsewhere, device="cpu")


def test_repeated_fits_reuse_coordinates_and_agree(data):
    _, tds = data
    est = GameEstimator(_configs()[1])
    first = est._build_coordinates(tds)
    again = est._build_coordinates(tds)
    assert all(first[k] is again[k] for k in first)
    a = est.fit(tds, device="cpu").model.score(tds)
    b = est.fit(tds, device="cpu").model.score(tds)
    assert torch.equal(a, b)
