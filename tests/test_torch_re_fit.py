"""A three-coordinate ``GameEstimator.fit`` of the port against the JAX
package's, on the CPU: a fixed effect, a per-user random effect over the
sparse global shard under the default optimizer type (LBFGS; the buckets
of its heaviest users routed to the COO layout in both packages by patching
``_bucket_dense_design``), and a per-user random effect over a dense shard
under NEWTON in a box with variances (its heavy users' buckets on the COO
layout too, whose dense designs NEWTON builds on the device); two
coordinate-descent iterations.
Then the fitted GAME model, variances included, saved by one package and
loaded by the other.

Tolerances: fitted scores rtol 1e-3, atol 1e-3, and the per-user variances
rtol 1e-3 (as tests/test_torch_game.py holds a fitted GLMix: 2 CD
iterations of solves in float32 whose sums run in different orders);
a model carried across by the model store scores within rtol 1e-6, atol
1e-7 of the package that saved it (tests/test_model_store.py:92), and its
variances load bit for bit.
"""

import numpy as np
import pytest

import photon_ml_tpu.game.coordinates as j_coordinates
from photon_ml_tpu.data import model_store as J
from photon_ml_tpu.game import FixedEffectConfig as JFEConfig
from photon_ml_tpu.game import GameConfig as JGameConfig
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JREConfig
from photon_ml_tpu.game import build_game_dataset as j_build
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import OptimizerType as JOptType
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu_torch.data import model_store as T
from photon_ml_tpu_torch.game import (
    FeatureShard,
    FixedEffectConfig,
    GameConfig,
    GameEstimator,
    RandomEffectConfig,
    build_game_dataset,
)
from photon_ml_tpu_torch.game import random_effect_data as t_red
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)

N, D_FE, USERS, D_RE = 1500, 48, 30, 4
LONG = 128  # buckets of at least this many rows an entity go to the COO layout
BOX = ((0, -0.3, 0.3),)
SCORE_TOL = dict(rtol=1e-6, atol=1e-7)


def _data(seed=11):
    rng = np.random.default_rng(seed)
    Xg = rng.normal(size=(N, D_FE)) * (rng.random((N, D_FE)) < 0.12)
    Xu = rng.normal(size=(N, D_RE))
    users = (rng.random(N) ** 2 * USERS).astype(np.int64)  # from ~25 to ~270 rows a user
    wg = rng.normal(size=D_FE) * 0.3
    wi = rng.normal(size=(USERS, D_FE)) * 0.5
    wu = rng.normal(size=(USERS, D_RE))
    margin = Xg @ wg + np.einsum("ij,ij->i", Xg, wi[users]) + np.einsum("ij,ij->i", Xu, wu[users])
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-margin))) * 1.0
    ids = np.array([f"u{u:02d}" for u in users])
    jds = j_build(response=y, feature_shards={"global": JSparse.from_dense(Xg, y),
                                              "user": JSparse.from_dense(Xu, y)},
                  id_columns={"userId": ids})
    tds = build_game_dataset(y, {"global": FeatureShard.from_dense(Xg),
                                 "user": FeatureShard.from_dense(Xu)},
                             id_columns={"userId": ids}, device="cpu")
    return jds, tds


def _configs():
    l2 = dict(regularization_weight=1.0)
    jfe = JOpt(max_iterations=20, tolerance=0.0, regularization=JReg(JRegType.L2), **l2)
    tfe = OptimizerConfig(max_iterations=20, tolerance=0.0,
                          regularization=RegularizationContext(RegularizationType.L2), **l2)
    jit = JOpt(max_iterations=20, tolerance=1e-7, regularization=JReg(JRegType.L2), **l2)
    tit = OptimizerConfig(max_iterations=20, tolerance=1e-7,
                          regularization=RegularizationContext(RegularizationType.L2), **l2)
    jnw = JOpt(optimizer_type=JOptType.NEWTON, max_iterations=10, tolerance=1e-2,
               regularization=JReg(JRegType.L2), box_constraints=BOX, **l2)
    tnw = OptimizerConfig(optimizer_type=OptimizerType.NEWTON, max_iterations=10,
                          tolerance=1e-2,
                          regularization=RegularizationContext(RegularizationType.L2),
                          box_constraints=BOX, **l2)
    jcfg = JGameConfig(task="logistic", num_iterations=2, coordinates={
        "fixed": JFEConfig(shard_name="global", optimizer=jfe),
        "per-user-items": JREConfig(shard_name="global", id_name="userId", optimizer=jit),
        "per-user": JREConfig(shard_name="user", id_name="userId", optimizer=jnw,
                              compute_variances=True)})
    tcfg = GameConfig(task="logistic", num_iterations=2, coordinates={
        "fixed": FixedEffectConfig(shard_name="global", optimizer=tfe),
        "per-user-items": RandomEffectConfig(shard_name="global", id_name="userId",
                                             optimizer=tit),
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId", optimizer=tnw,
                                       compute_variances=True)})
    return jcfg, tcfg


@pytest.fixture(scope="module")
def fits():
    patch = pytest.MonkeyPatch()
    j_rule, t_rule = j_coordinates._bucket_dense_design, t_red._bucket_dense_design
    patch.setattr(j_coordinates, "_bucket_dense_design",
                  lambda b: None if b.rows_per_entity >= LONG else j_rule(b))
    patch.setattr(t_red, "_bucket_dense_design",
                  lambda b: None if b.rows_per_entity >= LONG else t_rule(b))
    jds, tds = _data()
    jcfg, tcfg = _configs()
    try:
        yield jds, tds, JEstimator(jcfg).fit(jds), GameEstimator(tcfg).fit(tds, device="cpu")
    finally:
        patch.undo()


def test_three_coordinate_fit_matches_the_reference(fits):
    jds, tds, jfit, tfit = fits
    n = tds.num_rows
    np.testing.assert_allclose(tfit.model.score(tds).numpy(),
                               np.asarray(jfit.model.score(jds))[:n], rtol=1e-3, atol=1e-3)
    for name in ("per-user-items", "per-user"):
        got = tfit.model.models[name].score(tds).numpy()
        want = np.asarray(jfit.model.models[name].score(jds))[:n]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    for jb, tb in zip(jfit.model.models["per-user"].buckets,
                      tfit.model.models["per-user"].buckets):
        assert bool((tb.variances > 0).all())
        np.testing.assert_allclose(tb.variances.numpy(), np.asarray(jb.variances), rtol=1e-3)
        w = tb.coefficients.numpy()[:, 0]  # the box of global feature 0, seen by every user
        assert np.all(np.abs(w) <= 0.3)


def test_the_fit_routes_the_heavy_users_to_the_coo_layout(fits):
    _, tds, _, tfit = fits
    est = GameEstimator(_configs()[1])
    patch = pytest.MonkeyPatch()
    rule = t_red._bucket_dense_design
    patch.setattr(t_red, "_bucket_dense_design",
                  lambda b: None if b.rows_per_entity >= LONG else rule(b))
    try:
        coords = est._build_coordinates(tds)
    finally:
        patch.undo()
    for name in ("per-user-items", "per-user"):
        kinds = {type(b).__name__ for b in coords[name]._buckets}
        assert kinds == {"CooBucket", "DenseBucket"}
    assert all(e["host_syncs"] > 0 for e in tfit.history)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_a_model_with_variances_loads_in_the_other_package(fits, tmp_path, saver):
    jds, tds, jfit, tfit = fits
    path = str(tmp_path / "game")
    n = tds.num_rows
    if saver == "jax":
        J.save_game_model(jfit.model, path)
        loaded = T.load_game_model(path, device="cpu")
        np.testing.assert_allclose(loaded.score(tds).numpy(),
                                   np.asarray(jfit.model.score(jds))[:n], **SCORE_TOL)
        pairs = [(np.asarray(j.variances), t.variances.numpy()) for j, t in zip(
            jfit.model.models["per-user"].buckets, loaded.models["per-user"].buckets)]
    else:
        T.save_game_model(tfit.model, path)
        loaded = J.load_game_model(path)
        np.testing.assert_allclose(np.asarray(loaded.score(jds))[:n],
                                   tfit.model.score(tds).numpy(), **SCORE_TOL)
        pairs = [(t.variances.numpy(), np.asarray(j.variances)) for t, j in zip(
            tfit.model.models["per-user"].buckets, loaded.models["per-user"].buckets)]
    assert pairs
    for saved, got in pairs:
        np.testing.assert_array_equal(got, saved)
    assert all(b.variances is None for b in loaded.models["per-user-items"].buckets)
