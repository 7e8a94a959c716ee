"""The port's random projector (``photon_ml_tpu_torch.data.projection`` and a
random effect with ``projector="random"``) against the JAX package's, on the
CPU (after ``tests/test_projection.py:114-200``).

Tolerances: the Gaussian matrix is bit-identical (the same float64 draw,
scale, clip and cast); fitted latent coefficients rtol 1e-3, atol 1e-3
(tests/test_torch_game.py's fit comparisons: the two packages sum in
different orders); the reference test's own bounds for the fit quality.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu.data.projection import build_gaussian_projection_matrix as j_gauss
from photon_ml_tpu.game import GameConfig as JGameConfig
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JREConfig
from photon_ml_tpu.game import build_game_dataset as j_build
from photon_ml_tpu.game import build_random_effect_dataset as j_build_re
from photon_ml_tpu.game.factored import FactoredRandomEffectCoordinate as JFactored
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu_torch.data.projection import (
    ProjectionMatrix,
    build_gaussian_projection_matrix,
)
from photon_ml_tpu_torch.game import (
    FactoredRandomEffectCoordinate,
    FeatureShard,
    GameConfig,
    GameEstimator,
    RandomEffectConfig,
    build_game_dataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)


def _opts(lam=1e-3, iters=100, tol=1e-9):
    j = JOpt(regularization=JReg(JRegType.L2), regularization_weight=lam, tolerance=tol,
             max_iterations=iters)
    t = OptimizerConfig(regularization=RegularizationContext(RegularizationType.L2),
                        regularization_weight=lam, tolerance=tol, max_iterations=iters)
    return j, t


def _datasets(X, y, users):
    jds = j_build(response=y, feature_shards={"f": JSparse.from_dense(X, y)},
                  id_columns={"u": users})
    tds = build_game_dataset(response=y, feature_shards={"f": FeatureShard.from_dense(X)},
                             id_columns={"u": users}, device="cpu")
    return jds, tds


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("intercept", [None, 5])
def test_gaussian_matrix_is_bit_identical_to_the_reference(seed, intercept):
    j = np.asarray(j_gauss(8, 40, intercept_index=intercept, seed=seed).matrix)
    t = build_gaussian_projection_matrix(8, 40, intercept_index=intercept, seed=seed,
                                         device="cpu").matrix
    assert t.dtype == torch.float32 and t.shape == j.shape
    np.testing.assert_array_equal(t.numpy().view(np.int32), j.view(np.int32))


def test_projection_matrix_maps_features_and_coefficients():
    pm = build_gaussian_projection_matrix(4, 10, seed=2, device="cpu")
    x = torch.arange(10, dtype=torch.float32)
    torch.testing.assert_close(pm.project_features(x), pm.matrix @ x)
    w = torch.ones(4)
    torch.testing.assert_close(pm.project_coefficients(w), pm.matrix.T @ w)
    ext = pm.extended()
    assert ext.shape == (4, 11) and bool((ext[:, 10] == 0).all())
    assert ProjectionMatrix(matrix=ext).original_dim == 11
    with pytest.raises(ValueError, match="positive"):
        build_gaussian_projection_matrix(0, 10, device="cpu")


def test_random_projection_re_trains_and_generalizes():
    """As the reference test: per-user solves in a 24-dim Gaussian space of a
    60-feature shard keep most of a low-rank fit, unseen users score 0, and
    the latent coefficients agree with the JAX package's."""
    rng = np.random.default_rng(0)
    n_users, rows, d, k = 30, 40, 60, 8
    n = n_users * rows
    users = np.repeat(np.arange(n_users), rows)
    X = rng.normal(size=(n, d))
    B = rng.normal(size=(k, d)) / np.sqrt(d)
    Z = rng.normal(size=(n_users, k)) * 2
    y = np.einsum("nd,nd->n", X, (Z @ B)[users]) + 0.05 * rng.normal(size=n)
    jds, tds = _datasets(X, y, users)
    # stopped at tolerance 1e-5, before float32 noise decides the last steps
    # (at 1e-9 the lanes end ObjectiveNotImproving at points 1e-2 apart)
    jo, to = _opts(tol=1e-5)
    jfit = JEstimator(JGameConfig(task="squared", coordinates={"re": JREConfig(
        shard_name="f", id_name="u", optimizer=jo, projector="random",
        projected_dim=24)})).fit(jds)
    tfit = GameEstimator(GameConfig(task="squared", coordinates={"re": RandomEffectConfig(
        shard_name="f", id_name="u", optimizer=to, projector="random",
        projected_dim=24)})).fit(tds, device="cpu")
    model = tfit.model.models["re"]
    assert model.projection.matrix.shape == (24, d)
    np.testing.assert_array_equal(model.projection.matrix.numpy(),
                                  np.asarray(jfit.model.models["re"].projection.matrix))
    np.testing.assert_allclose(model.latent.numpy(),
                               np.asarray(jfit.model.models["re"].latent),
                               rtol=1e-3, atol=1e-3)
    s = tfit.model.score(tds).numpy()
    assert np.var(y - s) < 0.5 * np.var(y)
    new_X = rng.normal(size=(10, d))
    _, new = _datasets(new_X, np.zeros(10), np.arange(900, 910))
    np.testing.assert_array_equal(model.score(new).numpy(), 0.0)
    # the history's tracker: one step of latent solves, no latent refit
    tracker = tfit.history[0]["tracker"]
    assert "MF iteration 0" in tracker and "entities=30" in tracker
    assert "latent matrix" not in tracker


def test_random_projection_config_validation():
    with pytest.raises(ValueError, match="projected_dim"):
        RandomEffectConfig(shard_name="f", id_name="u", projector="random")
    with pytest.raises(ValueError, match="unknown projector"):
        RandomEffectConfig(shard_name="f", id_name="u", projector="gauss")
    with pytest.raises(ValueError, match="compute_variances"):
        RandomEffectConfig(shard_name="f", id_name="u", projector="random",
                           projected_dim=4, compute_variances=True)
    for kw, match in ((dict(projector="random"), "projected_dim"),
                      (dict(projector="gauss"), "unknown projector"),
                      (dict(projector="random", projected_dim=4, compute_variances=True),
                       "compute_variances")):
        with pytest.raises(ValueError, match=match):
            JREConfig(shard_name="f", id_name="u", **kw)


def test_random_projection_with_intercept_passthrough():
    rng = np.random.default_rng(5)
    n_users, rows, d = 8, 25, 12
    n = n_users * rows
    users = np.repeat(np.arange(n_users), rows)
    X = rng.normal(size=(n, d))
    X[:, d - 1] = 1.0  # the intercept column
    u_bias = rng.normal(size=n_users) * 3
    y = X[:, 0] + u_bias[users] + 0.05 * rng.normal(size=n)
    jds, tds = _datasets(X, y, users)
    jo, to = _opts()
    jc = JFactored(name="re", data=jds, re_data=j_build_re(jds, "u", "f"), loss_name="squared",
                   re_config=jo, latent_config=jo, latent_dim=4, refit_projection=False,
                   projection_intercept_index=d - 1)
    tc = FactoredRandomEffectCoordinate(
        name="re", data=tds, re_data=build_random_effect_dataset(tds, "u", "f"),
        loss_name="squared", re_config=to, latent_config=to, latent_dim=4,
        refit_projection=False, projection_intercept_index=d - 1)
    jm = jc.update_model(jc.initialize_model(), None)
    tm = tc.update_model(tc.initialize_model(), None)
    assert tm.projection.matrix.shape == (5, d)
    np.testing.assert_array_equal(tm.projection.matrix[4, : d - 1].numpy(), 0.0)
    assert float(tm.projection.matrix[4, d - 1]) == 1.0
    s = tc.score(tm).numpy()
    assert np.var(y - s) < 0.3 * np.var(y)
    np.testing.assert_allclose(tm.latent.numpy(), np.asarray(jm.latent), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s, np.asarray(jc.score(jm))[:n], rtol=1e-3, atol=1e-3)
    (re_t, fe_t), = tc.last_tracker.steps
    assert fe_t is None and len(re_t.iterations) == n_users
    with pytest.raises(ValueError, match="refit_projection"):
        FactoredRandomEffectCoordinate(
            name="re", data=tds, re_data=build_random_effect_dataset(tds, "u", "f"),
            loss_name="squared", re_config=to, latent_config=to, latent_dim=4,
            projection_intercept_index=d - 1)
