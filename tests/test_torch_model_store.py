"""The port's model store and ``GameEstimator``'s normalization and
``output_dir`` against the JAX package's, on the CPU:

- a GLM and a GAME model (fixed effect + per-user random effect, with
  string ids and with integer ids) saved by the JAX package load in the
  port and score the same, and the reverse: saved by the port, loaded by
  the JAX package;
- unseen entities score the fixed effect alone through
  ``score_game_dataset``;
- load errors are typed and name the path, a factored or
  matrix-factorization coordinate saved by either package loads in the
  other, and a fresh process loads and scores a model without importing JAX;
- ``GameEstimator.fit`` with a normalized fixed effect and with
  ``output_dir`` matches the JAX estimator (the fixed effect's
  coefficients, the best metric), and the JAX package loads the port's
  ``final/`` and ``best/`` and scores them as the port does.

Tolerances: scores of one model in both packages rtol 1e-6 / atol 1e-7
(tests/test_model_store.py:92; the same float32 products summed in another
order); a normalized fixed effect's coefficients rtol 2e-3 / atol 2e-4
(tests/test_estimator.py:156); the best validation AUC within 1e-4, as
tests/test_torch_game.py holds its validation metrics.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import model_store as J
from photon_ml_tpu.game import FixedEffectConfig as JFEConfig
from photon_ml_tpu.game import FixedEffectCoordinate as JFECoordinate
from photon_ml_tpu.game import GameConfig as JGameConfig
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import GameModel as JGameModel
from photon_ml_tpu.game import RandomEffectConfig as JREConfig
from photon_ml_tpu.game import RandomEffectCoordinate as JRECoordinate
from photon_ml_tpu.game import build_game_dataset as j_build
from photon_ml_tpu.game import build_random_effect_dataset as j_build_re
from photon_ml_tpu.models.glm import make_model as j_make_model
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
    GameModel,
    RandomEffectConfig,
    build_game_dataset,
)
from photon_ml_tpu_torch.models.glm import make_model
from photon_ml_tpu_torch.ops.sparse import SparseBatch
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = dict(rtol=1e-6, atol=1e-7)


def _opts(newton=False, **kw):
    base = dict(max_iterations=20, tolerance=1e-7, regularization_weight=1.0)
    base.update(kw)
    j = JOpt(regularization=JReg(JRegType.L2), **base)
    t = OptimizerConfig(regularization=RegularizationContext(RegularizationType.L2), **base)
    if newton:
        j = JOpt(optimizer_type=JOptType.NEWTON, regularization=JReg(JRegType.L2), **base)
        t = OptimizerConfig(optimizer_type=OptimizerType.NEWTON,
                            regularization=RegularizationContext(RegularizationType.L2), **base)
    return j, t


def _arrays(seed, n=300, n_users=12, string_ids=True):
    rng = np.random.default_rng(seed)
    Xg = rng.normal(size=(n, 8)) * (rng.random((n, 8)) < 0.5)
    Xg[:, 0] = 1.0  # the intercept column
    Xu = rng.normal(size=(n, 5)) * (rng.random((n, 5)) < 0.7)
    users = rng.integers(0, n_users, size=n)
    y = (rng.random(n) < 1 / (1 + np.exp(-(Xg @ rng.normal(size=8))))).astype(float)
    ids = np.array([f"u{u:03d}" for u in users]) if string_ids else users * 7 + 100
    return Xg, Xu, ids, y


def _datasets(Xg, Xu, ids, y):
    jds = j_build(response=y, feature_shards={"global": JSparse.from_dense(Xg, y),
                                              "user": JSparse.from_dense(Xu, y)},
                  id_columns={"userId": ids})
    tds = build_game_dataset(y, {"global": FeatureShard.from_dense(Xg),
                                 "user": FeatureShard.from_dense(Xu)},
                             id_columns={"userId": ids}, device="cpu")
    return jds, tds


def _jax_model(jds):
    fe = JFECoordinate("fixed", jds, "global", "logistic", _opts()[0])
    re = JRECoordinate("per-user", jds, j_build_re(jds, "userId", "user"), "logistic",
                       _opts(newton=True)[0])
    model = JGameModel(task="logistic", models={})
    model = model.with_model("fixed", fe.update_model(fe.initialize_model(), None))
    return model.with_model("per-user", re.update_model(re.initialize_model(), None))


def _port_model(tds):
    _, tfe = _opts()
    _, tre = _opts(newton=True)
    config = GameConfig(task="logistic", num_iterations=1, coordinates={
        "fixed": FixedEffectConfig(shard_name="global", optimizer=tfe),
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId", optimizer=tre)})
    return GameEstimator(config).fit(tds, device="cpu").model


def _jax_scores(model, jds):
    return np.asarray(model.score(jds))[: jds.num_rows]


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_glm_loads_in_the_other_package(tmp_path, saver):
    rng = np.random.default_rng(1)
    means, variances = rng.normal(size=9).astype(np.float32), rng.random(9).astype(np.float32)
    path = str(tmp_path / "glm")
    if saver == "jax":
        J.save_glm(j_make_model("poisson", jnp.asarray(means), jnp.asarray(variances)), path)
        m = T.load_glm(path, device="cpu")
        got_means, got_vars = m.coefficients.means.numpy(), m.coefficients.variances.numpy()
    else:
        T.save_glm(make_model("poisson", torch.from_numpy(means), torch.from_numpy(variances)),
                   path)
        m = J.load_glm(path)
        got_means = np.asarray(m.coefficients.means)
        got_vars = np.asarray(m.coefficients.variances)
    assert m.task == "poisson"
    np.testing.assert_array_equal(got_means, means)
    np.testing.assert_array_equal(got_vars, variances)
    X = rng.normal(size=(30, 9))
    want = np.asarray(j_make_model("poisson", jnp.asarray(means)).compute_score(
        JSparse.from_dense(X, np.zeros(30))))[:30]
    got = T.load_glm(path, device="cpu").compute_score(
        SparseBatch.from_dense(X, np.zeros(30), device="cpu")).numpy()
    np.testing.assert_allclose(got, want, **SCORE_TOL)


def test_the_glm_files_are_the_references(tmp_path):
    means = torch.arange(4, dtype=torch.float32)
    T.save_glm(make_model("logistic", means), str(tmp_path / "t"))
    J.save_glm(j_make_model("logistic", jnp.asarray(means.numpy())), str(tmp_path / "j"))
    meta = "model-metadata.json"
    assert (tmp_path / "t" / meta).read_bytes() == (tmp_path / "j" / meta).read_bytes()
    with np.load(tmp_path / "t" / "coefficients.npz") as a, \
            np.load(tmp_path / "j" / "coefficients.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["means"]
        assert a["means"].dtype == b["means"].dtype == np.float32


@pytest.mark.parametrize("string_ids", [True, False], ids=["string_ids", "integer_ids"])
def test_a_jax_game_model_loads_in_the_port_and_scores_the_same(tmp_path, string_ids):
    jds, tds = _datasets(*_arrays(3, string_ids=string_ids))
    model = _jax_model(jds)
    J.save_game_model(model, str(tmp_path / "game"), extra_metadata={"note": "jax"})
    loaded = T.load_game_model(str(tmp_path / "game"), device="cpu")
    assert list(loaded.models) == ["fixed", "per-user"]
    re = loaded.models["per-user"]
    assert all(b.projection.dtype == torch.int64 for b in re.buckets)
    assert all(isinstance(b.entity_codes, np.ndarray) for b in re.buckets)
    np.testing.assert_allclose(loaded.score(tds).numpy(), _jax_scores(model, jds),
                               **SCORE_TOL)
    np.testing.assert_allclose(T.score_game_dataset(str(tmp_path / "game"), tds),
                               _jax_scores(model, jds), **SCORE_TOL)
    assert T.load_game_model_metadata(str(tmp_path / "game"))["extra"] == {"note": "jax"}


@pytest.mark.parametrize("string_ids", [True, False], ids=["string_ids", "integer_ids"])
def test_a_port_game_model_loads_in_the_jax_package_and_scores_the_same(tmp_path, string_ids):
    jds, tds = _datasets(*_arrays(4, string_ids=string_ids))
    model = _port_model(tds)
    T.save_game_model(model, str(tmp_path / "game"))
    with np.load(tmp_path / "game" / "random-effect" / "per-user" / "model.npz",
                 allow_pickle=False) as z:
        assert z["projection_0"].dtype == np.int32 and z["vocab"].dtype != object
    loaded = J.load_game_model(str(tmp_path / "game"))
    np.testing.assert_allclose(_jax_scores(loaded, jds), model.score(tds).numpy(), **SCORE_TOL)
    again = T.load_game_model(str(tmp_path / "game"), device="cpu")
    assert torch.equal(again.score(tds), model.score(tds))


def test_an_object_array_of_ids_saves_without_pickle(tmp_path):
    jds, tds = _datasets(*_arrays(5))
    model = _port_model(tds)
    re = model.models["per-user"]
    as_objects = GameModel(task="logistic", models={"per-user": type(re)(
        **{**re.__dict__, "vocab": re.vocab.astype(object)})})
    T.save_game_model(as_objects, str(tmp_path / "game"))
    loaded = T.load_game_model(str(tmp_path / "game"), device="cpu")
    assert torch.equal(loaded.score(tds), as_objects.score(tds))


def test_unseen_entities_score_the_fixed_effect_alone(tmp_path):
    _, tds = _datasets(*_arrays(6))
    model = _port_model(tds)
    T.save_game_model(model, str(tmp_path / "game"))
    rng = np.random.default_rng(7)
    n = 100
    ids = np.array([f"u{i:03d}" if i % 2 == 0 else f"new{i}" for i in range(n)])
    other = build_game_dataset(np.zeros(n), {
        "global": FeatureShard.from_dense(rng.normal(size=(n, 8))),
        "user": FeatureShard.from_dense(rng.normal(size=(n, 5)))},
        id_columns={"userId": ids}, device="cpu")
    scores = T.score_game_dataset(str(tmp_path / "game"), other)
    fe = model.models["fixed"].score(other).numpy()
    unseen = np.char.startswith(ids, "new")
    np.testing.assert_allclose(scores[unseen], fe[unseen], **SCORE_TOL)
    assert not np.allclose(scores[~unseen], fe[~unseen])


def test_load_errors_are_typed_and_name_the_path(tmp_path):
    m = make_model("logistic", torch.zeros(4))
    with pytest.raises(T.ModelLoadError, match="missing metadata"):
        T.load_glm(str(tmp_path / "nope"), device="cpu")
    T.save_glm(m, str(tmp_path / "trunc"))
    npz = tmp_path / "trunc" / "coefficients.npz"
    npz.write_bytes(npz.read_bytes()[:16])
    with pytest.raises(T.ModelLoadError, match="coefficients.npz"):
        T.load_glm(str(tmp_path / "trunc"), device="cpu")
    T.save_glm(m, str(tmp_path / "nokey"))
    np.savez(tmp_path / "nokey" / "coefficients.npz", other=np.zeros(2))
    with pytest.raises(T.ModelLoadError, match="missing array key 'means'"):
        T.load_glm(str(tmp_path / "nokey"), device="cpu")
    T.save_glm(m, str(tmp_path / "vers"))
    meta_path = tmp_path / "vers" / "model-metadata.json"
    meta = json.loads(meta_path.read_text())
    meta["format_version"] = 999
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(T.ModelLoadError, match="format_version 999"):
        T.load_glm(str(tmp_path / "vers"), device="cpu")
    T.save_glm(m, str(tmp_path / "badjson"))
    (tmp_path / "badjson" / "model-metadata.json").write_text("{ nope")
    with pytest.raises(T.ModelLoadError, match="corrupt metadata"):
        T.load_glm(str(tmp_path / "badjson"), device="cpu")
    T.save_glm(m, str(tmp_path / "glm"))
    with pytest.raises(ValueError, match="GAME"):
        T.load_game_model(str(tmp_path / "glm"), device="cpu")
    assert issubclass(T.ModelLoadError, ValueError)


def test_game_load_errors_are_typed(tmp_path):
    _, tds = _datasets(*_arrays(8))
    T.save_game_model(_port_model(tds), str(tmp_path / "game"))
    npz = tmp_path / "game" / "random-effect" / "per-user" / "model.npz"
    npz.write_bytes(npz.read_bytes()[:32])
    with pytest.raises(T.ModelLoadError, match="model.npz"):
        T.load_game_model(str(tmp_path / "game"), device="cpu")
    T.save_game_model(_port_model(tds), str(tmp_path / "game"))
    meta_path = tmp_path / "game" / "model-metadata.json"
    meta = json.loads(meta_path.read_text())
    meta["coordinate_order"].append("ghost")
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(T.ModelLoadError, match="'ghost' listed but not described"):
        T.load_game_model(str(tmp_path / "game"), device="cpu")
    with pytest.raises(TypeError, match="cannot persist"):
        T.save_game_model(GameModel(task="logistic", models={"x": object()}),
                          str(tmp_path / "bad"))


def _jax_factored(jds, kind):
    """A JAX GAME model of the fixed effect and a coordinate of ``kind``: a
    fitted factored random effect over the user shard, or a matrix
    factorization of random factors over the userId column."""
    from photon_ml_tpu.game import MatrixFactorizationModel as JMF
    from photon_ml_tpu.game.factored import FactoredRandomEffectCoordinate as JFactored

    model = _jax_model(jds)
    if kind == "factored_random_effect":
        opt = _opts()[0]
        coord = JFactored(name="mf", data=jds, re_data=j_build_re(jds, "userId", "user"),
                          loss_name="logistic", re_config=opt, latent_config=opt, latent_dim=2)
        sub = coord.update_model(coord.initialize_model(), None)
    else:
        rng = np.random.default_rng(3)
        vocab = jds.id_columns["userId"].vocab
        sub = JMF(row_effect="userId", col_effect="userId",
                  row_factors=jnp.asarray(rng.normal(size=(len(vocab), 3)), jnp.float32),
                  col_factors=jnp.asarray(rng.normal(size=(len(vocab), 3)), jnp.float32),
                  row_vocab=vocab, col_vocab=vocab)
    return model.with_model("mf", sub)


@pytest.mark.parametrize("kind", ["factored_random_effect", "matrix_factorization"])
def test_a_factored_coordinate_refuses_to_load_naming_item_10(tmp_path, kind):
    """Refused until ROADMAP item 10 was ported; now a factored or
    matrix-factorization coordinate saved by either package loads in the
    other and scores the same, and the port's round trip is bit for bit."""
    jds, tds = _datasets(*_arrays(9))
    jmodel = _jax_factored(jds, kind)
    J.save_game_model(jmodel, str(tmp_path / "j"))
    loaded = T.load_game_model(str(tmp_path / "j"), device="cpu")
    assert list(loaded.models) == ["fixed", "per-user", "mf"]
    want = _jax_scores(jmodel, jds)
    np.testing.assert_allclose(loaded.score(tds).numpy(), want, **SCORE_TOL)
    T.save_game_model(loaded, str(tmp_path / "t"))
    back = J.load_game_model(str(tmp_path / "t"))
    np.testing.assert_allclose(_jax_scores(back, jds), want, **SCORE_TOL)
    metas = [json.loads((tmp_path / d / "model-metadata.json").read_text()) for d in "jt"]
    assert metas[0]["coordinates"]["mf"] == metas[1]["coordinates"]["mf"]
    again = T.load_game_model(str(tmp_path / "t"), device="cpu")
    assert torch.equal(again.score(tds), loaded.score(tds))


def test_a_fresh_process_loads_and_scores_without_jax(tmp_path):
    Xg, Xu, ids, y = _arrays(10, n=150, n_users=6)
    _, tds = _datasets(Xg, Xu, ids, y)
    model = _port_model(tds)
    T.save_game_model(model, str(tmp_path / "game"))
    for name, a in (("xg", Xg), ("xu", Xu), ("y", y), ("ids", ids),
                    ("expected", model.score(tds).numpy())):
        np.save(tmp_path / f"{name}.npy", a)
    script = f"""
import sys
import numpy as np
from photon_ml_tpu_torch.data.model_store import score_game_dataset
from photon_ml_tpu_torch.game import FeatureShard, build_game_dataset
d = {str(tmp_path)!r}
data = build_game_dataset(np.load(d + "/y.npy"), {{
    "global": FeatureShard.from_dense(np.load(d + "/xg.npy")),
    "user": FeatureShard.from_dense(np.load(d + "/xu.npy"))}},
    id_columns={{"userId": np.load(d + "/ids.npy")}}, device="cpu")
scores = score_game_dataset(d + "/game", data)
np.testing.assert_array_equal(scores, np.load(d + "/expected.npy"))
assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "photon_ml_tpu."))
            and not m.startswith("photon_ml_tpu_torch")], "JAX was imported"
print("FRESH-PROCESS-OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FRESH-PROCESS-OK" in out.stdout


def _scaled_data(seed, n=400):
    rng = np.random.default_rng(seed)
    scales = np.array([1, 100, 0.01, 1, 5, 0.5, 10, 2.0])
    X = rng.normal(size=(n, len(scales))) * scales
    X[:, 0] = 1.0  # the intercept
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ (rng.normal(size=len(scales)) / scales))))
         ).astype(float)
    jds = j_build(response=y, feature_shards={"g": JSparse.from_dense(X, y)})
    tds = build_game_dataset(y, {"g": FeatureShard.from_dense(X)}, device="cpu")
    return jds, tds


@pytest.mark.parametrize("norm", ["standardization", "scale_with_standard_deviation",
                                  "scale_with_max_magnitude"])
def test_a_normalized_fixed_effect_matches_the_reference(norm):
    jds, tds = _scaled_data(12)
    jopt, topt = _opts(max_iterations=60, tolerance=1e-9)
    jres = JEstimator(JGameConfig(task="logistic", coordinates={"fixed": JFEConfig(
        shard_name="g", optimizer=jopt, normalization=norm, intercept_index=0)})).fit(jds)
    tres = GameEstimator(GameConfig(task="logistic", coordinates={"fixed": FixedEffectConfig(
        shard_name="g", optimizer=topt, normalization=norm, intercept_index=0)})).fit(
        tds, device="cpu")
    np.testing.assert_allclose(tres.model.models["fixed"].coefficients.numpy(),
                               np.asarray(jres.model.models["fixed"].coefficients),
                               rtol=2e-3, atol=2e-4)


def test_a_normalized_box_keeps_the_intercept_free():
    _, tds = _scaled_data(13)
    _, topt = _opts(box_constraints=((0, -1.0, 1.0),))
    config = GameConfig(task="logistic", coordinates={"fixed": FixedEffectConfig(
        shard_name="g", optimizer=topt, normalization="standardization", intercept_index=0)})
    with pytest.raises(ValueError, match="intercept"):
        GameEstimator(config).fit(tds, device="cpu")


def test_fit_with_output_dir_matches_the_reference_and_loads_in_jax(tmp_path):
    jds, tds = _datasets(*_arrays(14))
    jfe, tfe = _opts(tolerance=0.0)  # 20 iterations in both packages
    jre, tre = _opts(newton=True)
    common = dict(task="logistic", num_iterations=2, evaluators=["auc", "logistic_loss"])
    jcfg = JGameConfig(coordinates={
        "fixed": JFEConfig(shard_name="global", optimizer=jfe, normalization="standardization",
                           intercept_index=0),
        "per-user": JREConfig(shard_name="user", id_name="userId", optimizer=jre)}, **common)
    tcfg = GameConfig(coordinates={
        "fixed": FixedEffectConfig(shard_name="global", optimizer=tfe,
                                   normalization="standardization", intercept_index=0),
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId", optimizer=tre)},
        **common)
    jres = JEstimator(jcfg).fit(jds, validation_data=jds)
    out = str(tmp_path / "out")
    tres = GameEstimator(tcfg).fit(tds, validation_data=tds, output_dir=out, device="cpu")
    # the normalized fixed effect at the reference estimator's tolerance; the
    # random effect's scores follow its Newton's float32 stopping (up to
    # 1.9e-3 here, ROADMAP Queue 3 item 5) and are held in test_torch_game.py
    np.testing.assert_allclose(tres.model.models["fixed"].coefficients.numpy(),
                               np.asarray(jres.model.models["fixed"].coefficients),
                               rtol=2e-3, atol=2e-4)
    assert tres.best_metric == pytest.approx(jres.best_metric, abs=1e-4)
    for sub, model in (("final", tres.model), ("best", tres.best_model)):
        loaded = J.load_game_model(os.path.join(out, sub))
        np.testing.assert_allclose(_jax_scores(loaded, jds), model.score(tds).numpy(),
                                   **SCORE_TOL)
        meta = J.load_game_model_metadata(os.path.join(out, sub))
        cfg = meta["extra"]["config"]["coordinates"]
        assert cfg["fixed"]["normalization"] == "standardization"
        assert cfg["fixed"]["intercept_index"] == 0
        assert cfg["per-user"]["optimizer"]["type"] == "newton"
        assert meta["extra"]["best_metric"] == pytest.approx(tres.best_metric)
    summary = tres.model.to_summary_string().splitlines()
    assert summary[0] == "GameModel(task=logistic, coordinates=2)"
    assert summary[1].startswith("  fixed: FixedEffectModel(shard=global, features=8")
    assert summary[2].startswith("  per-user: RandomEffectModel(id=userId, shard=user")


def test_feature_index_maps_saved_beside_a_model_load_in_the_port(tmp_path):
    from photon_ml_tpu.data import IndexMap as JIndexMap

    model_dir = tmp_path / "model"
    assert T.load_feature_index_maps(str(model_dir)) is None
    maps = {"global": ["a", "b\x01x"], "user": ["u1", "u2", "u3"]}
    for shard, names in maps.items():
        JIndexMap(names).save(str(model_dir / "feature-indexes" / shard))
    loaded = T.load_feature_index_maps(str(model_dir))
    assert {k: v.names for k, v in loaded.items()} == maps
