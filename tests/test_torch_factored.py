"""The port's factored random effects (``photon_ml_tpu_torch.game.factored``)
against the JAX package's, on the CPU (after ``tests/test_factored.py``; its
mesh test waits for the port's multi-device item).

Tolerances: latent tables, projection matrices and fitted scores rtol 1e-3,
atol 1e-3 (tests/test_torch_game.py's fit comparisons; the solves stop at
tolerance 1e-5, before float32 noise decides their last steps); scores of a
model carried across packages rtol 1e-5, atol 1e-6 (the same float32
products summed in another order); ``CSRBatch.with_values`` against a fresh
build bit for bit; the reference tests' own bounds for fit quality.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from photon_ml_tpu.data import model_store as JStore
from photon_ml_tpu.game import FactoredRandomEffectConfig as JFactoredConfig
from photon_ml_tpu.game import FixedEffectConfig as JFEConfig
from photon_ml_tpu.game import GameConfig as JGameConfig
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import MatrixFactorizationModel as JMF
from photon_ml_tpu.game import build_game_dataset as j_build
from photon_ml_tpu.game import build_random_effect_dataset as j_build_re
from photon_ml_tpu.game.factored import FactoredRandomEffectCoordinate as JFactored
from photon_ml_tpu.game.models import GameModel as JGameModel
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.data import model_store as TStore
from photon_ml_tpu_torch.game import (
    FactoredRandomEffectConfig,
    FactoredRandomEffectCoordinate,
    FactoredRandomEffectModel,
    FeatureShard,
    FixedEffectConfig,
    GameConfig,
    GameEstimator,
    MatrixFactorizationModel,
    RandomEffectConfig,
    build_game_dataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game import random_effect_data as t_red
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.trackers import FactoredRandomEffectOptimizationTracker


def _opts(lam=1e-3, iters=100, tol=1e-5):
    j = JOpt(regularization=JReg(JRegType.L2), regularization_weight=lam, tolerance=tol,
             max_iterations=iters)
    t = OptimizerConfig(regularization=RegularizationContext(RegularizationType.L2),
                        regularization_weight=lam, tolerance=tol, max_iterations=iters)
    return j, t


def _datasets(X, y, users, **ids):
    id_cols = {"userId": users, **ids}
    jds = j_build(response=y, feature_shards={"feats": JSparse.from_dense(X, y)},
                  id_columns=id_cols)
    tds = build_game_dataset(response=y, feature_shards={"feats": FeatureShard.from_dense(X)},
                             id_columns=id_cols, device="cpu")
    return jds, tds


def _low_rank(seed, n_users=40, rows_per_user=25, d=30, k_true=2, noise=0.05, sparsity=1.0):
    """Per-user linear responses whose coefficients live in a K-dim subspace
    (the reference test's generator)."""
    rng = np.random.default_rng(seed)
    n = n_users * rows_per_user
    users = np.repeat(np.arange(n_users), rows_per_user)
    X = rng.normal(size=(n, d)) * (rng.random((n, d)) < sparsity)
    B = rng.normal(size=(k_true, d)) / np.sqrt(d)
    W = (rng.normal(size=(n_users, k_true)) * 2.0) @ B
    y = np.einsum("nd,nd->n", X, W[users]) + noise * rng.normal(size=n)
    return X, y, users, W, rng


def _coordinates(jds, tds, mf_iterations, jo, to, cap=None, latent_dim=2):
    jc = JFactored(name="mf", data=jds, re_data=j_build_re(jds, "userId", "feats",
                                                           active_rows_per_entity=cap),
                   loss_name="squared", re_config=jo, latent_config=jo, latent_dim=latent_dim,
                   mf_iterations=mf_iterations)
    tc = FactoredRandomEffectCoordinate(
        name="mf", data=tds, re_data=build_random_effect_dataset(tds, "userId", "feats",
                                                                 active_rows_per_entity=cap),
        loss_name="squared", re_config=to, latent_config=to, latent_dim=latent_dim,
        mf_iterations=mf_iterations)
    return jc, tc


@pytest.mark.parametrize("mf_iterations", [1, 2])
def test_latent_table_and_matrix_agree_with_the_reference(mf_iterations):
    """After one and after two alternations: the latent table, A and the
    training scores (a cap leaves passive rows, scored by the model)."""
    X, y, users, *_ = _low_rank(1, n_users=30, rows_per_user=14, d=16, sparsity=0.5)
    jds, tds = _datasets(X, y, users)
    jo, to = _opts(lam=0.1)
    jc, tc = _coordinates(jds, tds, mf_iterations, jo, to, cap=10)
    jm = jc.update_model(jc.initialize_model(), None)
    tm = tc.update_model(tc.initialize_model(), None)
    np.testing.assert_allclose(tm.latent.numpy(), np.asarray(jm.latent), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tm.projection.matrix.numpy(), np.asarray(jm.projection.matrix),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tc.score(tm).numpy(), np.asarray(jc.score(jm))[: len(y)],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tm.entity_flat, jm.entity_flat)
    # the refit's structure: every live nonzero of the buckets times K
    assert tc.kron_nnz == 2 * sum(int((b.values != 0).sum()) for b in tc.re_data.buckets)
    t = tc.last_tracker
    assert isinstance(t, FactoredRandomEffectOptimizationTracker)
    assert len(t.steps) == mf_iterations
    for (re_t, fe_t), (jre_t, jfe_t) in zip(t.steps, jc.last_tracker.steps):
        assert len(re_t.iterations) == 30 and re_t.final_values is not None
        assert fe_t.iterations >= 1 and fe_t.reason == jfe_t.reason
        assert fe_t.iterations == jfe_t.iterations
    assert "latent matrix" in t.to_summary_string()


def test_coo_buckets_give_the_dense_buckets_latent_designs(monkeypatch):
    """A COO bucket's latent design (K margins launches over its
    block-diagonal batch) equals the dense bucket's bmm, and its update
    agrees with the reference."""
    X, y, users, *_ = _low_rank(2, n_users=20, rows_per_user=12, d=24, sparsity=0.4)
    jds, tds = _datasets(X, y, users)
    jo, to = _opts(lam=0.1)
    jc, dense = _coordinates(jds, tds, 1, jo, to)
    monkeypatch.setattr(t_red, "_bucket_dense_design", lambda b: None)
    _, tds_coo = _datasets(X, y, users)
    _, coo = _coordinates(jds, tds_coo, 1, jo, to)
    assert all(isinstance(b, t_red.CooBucket) for b in coo._buckets)
    a_ext = dense.initialize_model().projection.extended()
    for i in range(len(dense._buckets)):
        torch.testing.assert_close(coo._latent_design(i, a_ext),
                                   dense._latent_design(i, a_ext), rtol=1e-5, atol=1e-6)
    jm = jc.update_model(jc.initialize_model(), None)
    tm = coo.update_model(coo.initialize_model(), None)
    np.testing.assert_allclose(tm.latent.numpy(), np.asarray(jm.latent), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(coo.score(tm).numpy(), np.asarray(jc.score(jm))[: len(y)],
                               rtol=1e-3, atol=1e-3)


def test_alternation_reduces_training_loss():
    X, y, users, *_ = _low_rank(3)
    jds, tds = _datasets(X, y, users)
    jo, to = _opts()
    cfg = GameConfig(task="squared", coordinates={"mf": FactoredRandomEffectConfig(
        shard_name="feats", id_name="userId", latent_dim=2, mf_iterations=3,
        re_optimizer=to, latent_optimizer=to)})
    result = GameEstimator(cfg).fit(tds, device="cpu")
    model = result.model.models["mf"]
    resid = y - result.model.score(tds).numpy()
    assert np.var(resid) < 0.25 * np.var(y)
    assert model.latent_dim == 2 and model.projection.matrix.shape == (2, 30)
    jres = JEstimator(JGameConfig(task="squared", coordinates={"mf": JFactoredConfig(
        shard_name="feats", id_name="userId", latent_dim=2, mf_iterations=3,
        re_optimizer=jo, latent_optimizer=jo)})).fit(jds)
    np.testing.assert_allclose(result.model.score(tds).numpy(),
                               np.asarray(jres.model.score(jds))[: len(y)],
                               rtol=1e-3, atol=1e-3)
    assert "MF iteration 2" in result.history[0]["tracker"]


def test_factored_beats_plain_re_on_holdout():
    X, y, users, W, rng = _low_rank(4, n_users=60, rows_per_user=15, d=40)
    _, tds = _datasets(X, y, users)
    vu = np.repeat(np.arange(60), 10)
    vX = rng.normal(size=(600, 40))
    vy = np.einsum("nd,nd->n", vX, W[vu]) + 0.05 * rng.normal(size=600)
    _, vds = _datasets(vX, vy, vu)
    _, to = _opts()
    mf = GameEstimator(GameConfig(task="squared", coordinates={"re": FactoredRandomEffectConfig(
        shard_name="feats", id_name="userId", latent_dim=2, mf_iterations=10,
        re_optimizer=to, latent_optimizer=to)})).fit(tds, device="cpu").model
    re = GameEstimator(GameConfig(task="squared", coordinates={"re": RandomEffectConfig(
        shard_name="feats", id_name="userId", optimizer=to)})).fit(tds, device="cpu").model

    def rmse(model):
        return float(np.sqrt(np.mean((model.score(vds).numpy() - vy) ** 2)))

    assert rmse(mf) < rmse(re)


def test_factored_in_game_with_fixed_effect():
    X, y0, users, W, rng = _low_rank(5, n_users=30, rows_per_user=20, d=20)
    y = y0 + X @ rng.normal(size=20)
    jds, tds = _datasets(X, y, users)
    jo, to = _opts()
    jfe, tfe = _opts(lam=0.0)[0], OptimizerConfig(tolerance=1e-5)
    both = GameConfig(task="squared", num_iterations=2, coordinates={
        "fixed": FixedEffectConfig(shard_name="feats", optimizer=tfe),
        "mf": FactoredRandomEffectConfig(shard_name="feats", id_name="userId", latent_dim=2,
                                         mf_iterations=2, re_optimizer=to,
                                         latent_optimizer=to)})
    fe_only = GameConfig(task="squared", coordinates={
        "fixed": FixedEffectConfig(shard_name="feats", optimizer=tfe)})
    r_both = GameEstimator(both).fit(tds, device="cpu")
    r_fe = GameEstimator(fe_only).fit(tds, device="cpu")

    def mse(r):
        return float(np.mean((r.model.score(tds).numpy() - y) ** 2))

    assert mse(r_both) < 0.5 * mse(r_fe)
    j_both = JEstimator(JGameConfig(task="squared", num_iterations=2, coordinates={
        "fixed": JFEConfig(shard_name="feats", optimizer=dataclasses.replace(jfe)),
        "mf": JFactoredConfig(shard_name="feats", id_name="userId", latent_dim=2,
                              mf_iterations=2, re_optimizer=jo, latent_optimizer=jo)})).fit(jds)
    np.testing.assert_allclose(r_both.model.score(tds).numpy(),
                               np.asarray(j_both.model.score(jds))[: len(y)],
                               rtol=1e-3, atol=1e-3)


def _fitted(seed=6):
    X, y, users, *_ = _low_rank(seed, n_users=20, rows_per_user=10, d=15)
    jds, tds = _datasets(X, y, users)
    jo, _ = _opts()
    jres = JEstimator(JGameConfig(task="squared", coordinates={"mf": JFactoredConfig(
        shard_name="feats", id_name="userId", latent_dim=2, re_optimizer=jo,
        latent_optimizer=jo)})).fit(jds)
    return jds, tds, jres.model


def test_factored_model_saved_by_either_package_loads_in_the_other(tmp_path):
    jds, tds, jmodel = _fitted()
    jm = jmodel.models["mf"]
    tmodel = convert.game_model_from_jax("squared", {"mf": {
        "id_name": jm.id_name, "shard_name": jm.shard_name,
        "projection": np.asarray(jm.projection.matrix), "latent": np.asarray(jm.latent),
        "entity_flat": jm.entity_flat, "vocab": jm.vocab}}, device="cpu")
    assert isinstance(tmodel.models["mf"], FactoredRandomEffectModel)
    want = np.asarray(jmodel.score(jds))[: tds.num_rows]
    np.testing.assert_allclose(tmodel.score(tds).numpy(), want, rtol=1e-5, atol=1e-6)
    # the JAX package's save loads in the port, and the port's in the JAX package
    JStore.save_game_model(jmodel, str(tmp_path / "j"))
    loaded = TStore.load_game_model(str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(loaded.models["mf"].latent.numpy(), np.asarray(jm.latent))
    np.testing.assert_allclose(loaded.score(tds).numpy(), want, rtol=1e-5, atol=1e-6)
    TStore.save_game_model(tmodel, str(tmp_path / "t"))
    back = JStore.load_game_model(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(back.models["mf"].projection.matrix),
                                  np.asarray(jm.projection.matrix))
    np.testing.assert_allclose(np.asarray(back.score(jds))[: tds.num_rows], want,
                               rtol=1e-5, atol=1e-6)
    meta = json.loads((tmp_path / "t" / "model-metadata.json").read_text())
    assert meta["coordinates"]["mf"] == json.loads(
        (tmp_path / "j" / "model-metadata.json").read_text())["coordinates"]["mf"]
    # the port's round trip scores bit for bit
    again = TStore.load_game_model(str(tmp_path / "t"), device="cpu")
    assert torch.equal(again.score(tds), tmodel.score(tds))


def test_factored_scores_unseen_entities_and_features_zero():
    jds, tds, jmodel = _fitted(7)
    jm = jmodel.models["mf"]
    model = convert.game_model_from_jax("squared", {"mf": {
        "id_name": jm.id_name, "shard_name": jm.shard_name,
        "projection": np.asarray(jm.projection.matrix), "latent": np.asarray(jm.latent),
        "entity_flat": jm.entity_flat, "vocab": jm.vocab}}, device="cpu").models["mf"]
    rng = np.random.default_rng(0)
    _, new = _datasets(rng.normal(size=(30, 15)), np.zeros(30), np.arange(1000, 1030))
    np.testing.assert_array_equal(model.score(new).numpy(), 0.0)
    # a feature past the training dimension scores 0, as in the reference
    wide = np.zeros((4, 20))
    wide[:, 15:] = 1.0
    jw, tw = _datasets(wide, np.zeros(4), np.asarray(jm.vocab[:4]))
    np.testing.assert_array_equal(model.score(tw).numpy(), 0.0)
    np.testing.assert_array_equal(np.asarray(jm.score(jw))[:4], 0.0)
    assert model.effective_coefficients(10_000) is None
    eff = model.effective_coefficients(jm.vocab[0])
    np.testing.assert_allclose(eff.numpy(), np.asarray(jm.effective_coefficients(jm.vocab[0])),
                               rtol=1e-5, atol=1e-6)
    assert model.to_summary_string() == jm.to_summary_string()


def test_matrix_factorization_scores_and_round_trips(tmp_path):
    rng = np.random.default_rng(8)
    n_users, n_items, k, n = 12, 9, 3, 50
    RF = rng.normal(size=(n_users, k)).astype(np.float32)
    CF = rng.normal(size=(n_items, k)).astype(np.float32)
    users, items = rng.integers(0, n_users, n), rng.integers(0, n_items, n)
    X = rng.normal(size=(n, 4))
    jds, tds = _datasets(X, np.zeros(n), users, itemId=items)
    jmf = JMF(row_effect="userId", col_effect="itemId", row_factors=RF, col_factors=CF,
              row_vocab=np.arange(n_users), col_vocab=np.arange(n_items))
    tgame = convert.game_model_from_jax("squared", {"mf": {
        "row_effect": "userId", "col_effect": "itemId", "row_factors": RF, "col_factors": CF,
        "row_vocab": np.arange(n_users), "col_vocab": np.arange(n_items)}}, device="cpu")
    mf = tgame.models["mf"]
    assert isinstance(mf, MatrixFactorizationModel) and mf.num_latent_factors == k
    expected = np.einsum("nk,nk->n", RF[users], CF[items])
    np.testing.assert_allclose(mf.score(tds).numpy(), expected, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mf.score(tds).numpy(), np.asarray(jmf.score(jds))[:n],
                               rtol=1e-5, atol=1e-6)
    TStore.save_game_model(tgame, str(tmp_path / "t"))
    back = JStore.load_game_model(str(tmp_path / "t"))
    np.testing.assert_allclose(np.asarray(back.score(jds))[:n], expected, rtol=1e-5, atol=1e-5)
    JStore.save_game_model(JGameModel(task="squared", models={"mf": jmf}), str(tmp_path / "j"))
    loaded = TStore.load_game_model(str(tmp_path / "j"), device="cpu")
    assert torch.equal(loaded.score(tds), mf.score(tds))
    _, unseen = _datasets(X, np.zeros(n), users + 500, itemId=items)
    np.testing.assert_array_equal(mf.score(unseen).numpy(), 0.0)


def test_with_values_equals_a_fresh_build_bit_for_bit():
    rng = np.random.default_rng(9)
    n, d, nnz = 300, 40, 2000
    rows = np.sort(rng.integers(0, n, nnz))
    cols = rng.integers(0, d, nnz)
    labels = rng.random(n)
    base = CSRBatch.from_coo(np.zeros(nnz, np.float32), rows, cols, labels, d, device="cpu",
                             refreshable=True)
    vals = rng.normal(size=nnz).astype(np.float32)
    fresh = CSRBatch.from_coo(vals, rows, cols, labels, d, device="cpu")
    got = base.with_values(torch.from_numpy(vals))
    for name in ("row_ptr", "cols", "vals", "col_ptr", "csc_rows", "csc_vals"):
        assert torch.equal(getattr(got, name), getattr(fresh, name)), name
    w, r = torch.from_numpy(rng.normal(size=d).astype(np.float32)), torch.rand(n)
    assert torch.equal(got.margins(w), fresh.margins(w))
    assert torch.equal(got.scatter_features(r), fresh.scatter_features(r))
    with pytest.raises(ValueError, match="refreshable"):
        fresh.with_values(torch.from_numpy(vals))
    with pytest.raises(ValueError, match="values must be"):
        base.with_values(torch.zeros(3))


def test_coordinate_validation():
    X, y, users, *_ = _low_rank(10, n_users=6, rows_per_user=8, d=6)
    _, tds = _datasets(X, y, users)
    red = build_random_effect_dataset(tds, "userId", "feats")
    _, to = _opts()
    kw = dict(name="mf", data=tds, re_data=red, loss_name="squared", re_config=to,
              latent_config=to, latent_dim=2)
    for bad, match in ((dict(latent_dim=0), "latent_dim"), (dict(mf_iterations=0),
                                                              "mf_iterations"),
                       (dict(re_config=dataclasses.replace(to, box_constraints=((0, -1, 1),))),
                        "box constraints")):
        with pytest.raises(ValueError, match=match):
            FactoredRandomEffectCoordinate(**{**kw, **bad})
    coord = FactoredRandomEffectCoordinate(**kw)
    assert torch.equal(coord.score(coord.initialize_model()), torch.zeros(len(y)))


def _northstar(seed, n, n_val, n_users, n_movies, fe_space=200, fe_nnz=4, ctx=4):
    """bench_northstar.py's generator (:47-83) at a small size: a planted
    logistic model of movie features, per-user and per-movie context; each
    shard in its own column space."""
    rng = np.random.default_rng(seed)
    movie_cols = rng.integers(0, fe_space, size=(n_movies, fe_nnz))
    movie_vals = rng.normal(size=(n_movies, fe_nnz))
    emb_m, emb_u = rng.normal(size=(n_movies, ctx)) * 0.7, rng.normal(size=(n_users, ctx)) * 0.7
    w_g = rng.normal(size=fe_space) * 0.4
    a_u, b_m = rng.normal(size=(n_users, ctx)) * 0.4, rng.normal(size=(n_movies, ctx)) * 0.4
    out = []
    for rows in (n, n_val):
        users, movies = rng.integers(0, n_users, rows), rng.integers(0, n_movies, rows)
        logit = (np.einsum("ij,ij->i", movie_vals[movies], w_g[movie_cols[movies]])
                 + np.einsum("ij,ij->i", emb_m[movies], a_u[users])
                 + np.einsum("ij,ij->i", emb_u[users], b_m[movies]))
        y = (rng.random(rows) < 1 / (1 + np.exp(-logit))).astype(np.float64)
        fe = np.zeros((rows, fe_space))
        np.add.at(fe, (np.repeat(np.arange(rows), fe_nnz), movie_cols[movies].ravel()),
                  movie_vals[movies].ravel())
        dense = {"movieFeatures": fe, "movieCtx": emb_m[movies], "userCtx": emb_u[users]}
        ids = {"userId": users, "movieId": movies}
        out.append((
            j_build(response=y, feature_shards={k: JSparse.from_dense(v, y)
                                                for k, v in dense.items()}, id_columns=ids),
            build_game_dataset(response=y, feature_shards={
                k: FeatureShard.from_dense(v) for k, v in dense.items()}, id_columns=ids,
                device="cpu")))
    return out


def test_a_northstar_shaped_fit_tracks_the_references_auc_after_each_update():
    """BASELINE config #5's coordinates (bench_northstar.py:186-231) on its
    generator at 12K rows: the validation AUC after each of the four updates
    agrees with the JAX package's within 1e-4, the ``mf`` update's fall
    included (the reference's own behaviour on this data, which path 11 of
    chip_smoke.py shows at full width)."""
    from photon_ml_tpu import config as JConfig
    from photon_ml_tpu_torch import config as TConfig

    def opt(kind, iters):
        return {"type": kind, "max_iterations": iters, "tolerance": 1e-7,
                "regularization": "l2", "regularization_weight": 1.0}

    doc = {"task": "logistic", "num_iterations": 1, "evaluators": ["auc"], "coordinates": {
        "fixed": {"type": "fixed_effect", "shard_name": "movieFeatures",
                  "optimizer": opt("lbfgs", 10)},
        "per-user": {"type": "random_effect", "shard_name": "movieCtx", "id_name": "userId",
                     "optimizer": opt("newton", 8), "active_rows_per_entity": 256},
        "per-movie": {"type": "random_effect", "shard_name": "userCtx", "id_name": "movieId",
                      "optimizer": opt("newton", 8), "active_rows_per_entity": 256},
        "mf": {"type": "factored_random_effect", "shard_name": "movieCtx", "id_name": "userId",
               "latent_dim": 2, "mf_iterations": 1, "optimizer": opt("lbfgs", 8),
               "latent_optimizer": opt("lbfgs", 8), "active_rows_per_entity": 32}}}
    (jtr, ttr), (jva, tva) = _northstar(0, 12_000, 3_000, 200, 100)
    jfit = JEstimator(JConfig.parse_game_config(doc)).fit(jtr, validation_data=jva)
    tfit = GameEstimator(TConfig.parse_game_config(doc)).fit(ttr, validation_data=tva,
                                                             device="cpu")
    j_auc = [e["metrics"]["auc"] for e in jfit.history]
    t_auc = [e["metrics"]["auc"] for e in tfit.history]
    np.testing.assert_allclose(t_auc, j_auc, atol=1e-4)
    assert t_auc[0] < t_auc[1] < t_auc[2]


def _mesh_case():
    """tests/test_factored.py:290-320's shape and draw: 24 users of 12 rows,
    d 16, latent 2, 3 MF iterations, squared loss, its optimizer."""
    rng = np.random.default_rng(12345)
    n_users, rows, d = 24, 12, 16
    users = np.repeat(np.arange(n_users), rows)
    X = rng.normal(size=(n_users * rows, d))
    B = rng.normal(size=(2, d)) / np.sqrt(d)
    W = (rng.normal(size=(n_users, 2)) * 2.0) @ B
    y = np.einsum("nd,nd->n", X, W[users]) + 0.05 * rng.normal(size=n_users * rows)
    return _datasets(X, y, users)


@pytest.mark.parametrize("refit", [True, False], ids=["factored", "projector"])
def test_mesh_fit_matches_the_unsharded_fit_and_the_reference(refit):
    """``FactoredRandomEffectCoordinate(mesh=...)`` on ``[cpu] * 8`` (the
    entity axis: 24 users, 3 an owner) against the port's unsharded fit and
    the JAX package's, projection and scores within 5e-3
    (tests/test_factored.py:310-320). ``refit=False`` is the random
    projector: the same owners' solves, no refit."""
    from photon_ml_tpu_torch.parallel import make_mesh

    jds, tds = _mesh_case()
    j_red, t_red_ = j_build_re(jds, "userId", "feats"), build_random_effect_dataset(
        tds, "userId", "feats")
    jo = JOpt(regularization=JReg(JRegType.L2), regularization_weight=1e-3, max_iterations=100,
              tolerance=1e-9)
    to = OptimizerConfig(regularization=RegularizationContext(RegularizationType.L2),
                         regularization_weight=1e-3, max_iterations=100, tolerance=1e-9)
    kw = dict(name="mf", loss_name="squared", latent_dim=2, mf_iterations=3,
              refit_projection=refit)
    ref = JFactored(data=jds, re_data=j_red, re_config=jo, latent_config=jo, **kw)
    local = FactoredRandomEffectCoordinate(data=tds, re_data=t_red_, re_config=to,
                                           latent_config=to, **kw)
    mesh = make_mesh({"entity": 8}, [torch.device("cpu")] * 8)
    sharded = FactoredRandomEffectCoordinate(data=tds, re_data=t_red_, re_config=to,
                                             latent_config=to, mesh=mesh, **kw)
    assert sharded._axis == "entity" and len(sharded._owners) == 8
    if refit:
        assert len(sharded._kron_blocks) == 8
        assert sum(b.nnz for b, _, _ in sharded._kron_blocks) == local.kron_nnz
    m_ref = ref.update_model(ref.initialize_model(), None)
    m_local = local.update_model(local.initialize_model(), None)
    m_shard = sharded.update_model(sharded.initialize_model(), None)
    tol = dict(rtol=5e-3, atol=5e-3)
    for got in (m_shard, m_local):
        np.testing.assert_allclose(got.projection.matrix.numpy(),
                                   np.asarray(m_ref.projection.matrix), **tol)
    np.testing.assert_allclose(m_shard.projection.matrix.numpy(),
                               m_local.projection.matrix.numpy(), **tol)
    s_shard, s_local = sharded.score(m_shard), local.score(m_local)
    np.testing.assert_allclose(s_shard.numpy(), s_local.numpy(), **tol)
    np.testing.assert_allclose(s_local.numpy(), np.asarray(ref.score(m_ref)), **tol)
    # the model's own scoring agrees with the coordinate's on the training rows
    np.testing.assert_allclose(m_shard.score(tds).numpy(), s_shard.numpy(), rtol=1e-5,
                               atol=1e-5)
