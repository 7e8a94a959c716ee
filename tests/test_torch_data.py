"""The port's data plane (``photon_ml_tpu_torch.data``, ``ops/sparse.py``'s
helpers, ``models/glm.py``'s methods, ``optim/factory.py``'s ``solve``)
against the JAX package's, on the CPU, from the same seeded numpy inputs:

- ``summarize`` of a ``SparseBatch`` and of a CPU ``CSRBatch`` against the
  reference's, with padded rows, nnz padding that aliases the last row,
  explicit zeros, rows of weight 0 and a feature never observed;
- ``CSRBatch.feature_moment_sums`` (the scatter kernel's plain version)
  against ``TiledBatch.feature_moment_sums`` (Pallas in interpret mode);
- ``build_normalization_context`` for all four types, its errors, and a
  standardized ``train_glm`` against the reference's at the same lambdas;
- ``validate``: the same failures and the same reports, fail-fast and with
  ``collect_all``, in FULL and SAMPLE modes, on both layouts;
- ``to_dense``, ``pad_rows_to``, ``concat_batches``, the GLM model's
  ``dim``, ``norm``, ``predict_class`` and ``with_coefficients``, and
  ``split_reg_weights``, ``build_objective`` and ``solve``.

Tolerances are tests/test_data.py's: mean rtol 1e-4 / atol 1e-5, variance
rtol 1e-3 / atol 1e-5, max and min rtol 1e-5, counts rtol 1e-6, the norms
rtol 1e-4 (:26-47, 198); factors rtol 1e-4 (:94-114); the standardized
sweep's means rtol 1e-2 / atol 1e-3 as tests/test_torch_training.py's;
moment sums rtol 1e-4 / atol 1e-4, tests/test_tiled.py's scatter parity
(:64-77; the Pallas scatter sums bf16 splits).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import DataValidationError as JError
from photon_ml_tpu.data import ValidationMode as JMode
from photon_ml_tpu.data import build_normalization_context as j_build_norm
from photon_ml_tpu.data import summarize as j_summarize
from photon_ml_tpu.data import validate as j_validate
from photon_ml_tpu.models.glm import make_model as j_make_model
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.ops.sparse import concat_batches as j_concat
from photon_ml_tpu.ops.tiled import TiledBatch
from photon_ml_tpu.optim import OptimizerConfig as JCfg
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu.optim.factory import build_objective as j_build_objective
from photon_ml_tpu.optim.factory import solve as j_solve
from photon_ml_tpu.optim.factory import split_reg_weights as j_split
from photon_ml_tpu.training import train_glm as j_train
from photon_ml_tpu_torch.data import (
    DataValidationError,
    ValidationMode,
    build_normalization_context,
    summarize,
    validate,
)
from photon_ml_tpu_torch.models.glm import make_model
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.sparse import SparseBatch, concat_batches
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
    build_objective,
    solve,
    split_reg_weights,
)
from photon_ml_tpu_torch.training import train_glm

SUMMARY_CASES = ["dense_with_zeros", "padded_rows", "explicit_zeros_and_weights",
                 "nnz_padding_aliases_the_last_row", "feature_never_observed"]


def _summary_inputs(case: str):
    """(JAX SparseBatch, COO arrays with labels and weights) for one case."""
    rng = np.random.default_rng(SUMMARY_CASES.index(case))
    if case == "nnz_padding_aliases_the_last_row":
        jb = JSparse.from_coo(np.array([-2.0, -3.0, -1.0]), np.array([0, 1, 2]),
                              np.array([0, 0, 0]), np.zeros(3), num_features=2,
                              nnz_pad_multiple=16)
    elif case == "padded_rows":
        X = rng.normal(size=(30, 5))
        jb = JSparse.from_dense(X, np.zeros(30)).pad_rows_to(40, 200)
    else:
        n, d = 80, 10
        X = rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.6)
        weights = None
        if case == "explicit_zeros_and_weights":
            rows, cols = np.nonzero(rng.random((n, d)) < 0.5)
            vals = X[rows, cols]  # the zeros of X become explicit entries
            weights = rng.random(n) * (rng.random(n) > 0.2)
            jb = JSparse.from_coo(vals, rows, cols, np.zeros(n), d, weights=weights)
        else:
            if case == "feature_never_observed":
                X[:, 3] = 0.0
            jb = JSparse.from_dense(X, np.zeros(n))
    arrays = {k: np.asarray(getattr(jb, k)) for k in
              ("values", "rows", "cols", "labels", "offsets", "weights")}
    return jb, arrays, jb.num_features


def _port_batch(layout: str, a: dict, d: int):
    cls = CSRBatch if layout == "csr" else SparseBatch
    return cls.from_coo(a["values"], a["rows"], a["cols"], a["labels"], d,
                        offsets=a["offsets"], weights=a["weights"], device="cpu")


@pytest.mark.parametrize("layout", ["sparse", "csr"])
@pytest.mark.parametrize("case", SUMMARY_CASES)
def test_summarize_matches_the_reference(case, layout):
    jb, arrays, d = _summary_inputs(case)
    want = j_summarize(jb)
    got = summarize(_port_batch(layout, arrays, d))
    tol = {"mean": dict(rtol=1e-4, atol=1e-5), "variance": dict(rtol=1e-3, atol=1e-5),
           "max": dict(rtol=1e-5), "min": dict(rtol=1e-5),
           "num_nonzeros": dict(rtol=1e-6), "norm_l1": dict(rtol=1e-4),
           "norm_l2": dict(rtol=1e-4), "mean_abs": dict(rtol=1e-4, atol=1e-5),
           "count": dict(rtol=0)}
    for field in dataclasses.fields(got):
        g = getattr(got, field.name)
        assert g.dtype == torch.float32, field.name
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, field.name)),
                                   err_msg=field.name, **tol[field.name])


def test_summaries_of_one_batch_are_bit_identical():
    _, arrays, d = _summary_inputs("explicit_zeros_and_weights")
    batch = _port_batch("csr", arrays, d)
    a, b = summarize(batch), summarize(batch)
    assert all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@pytest.mark.parametrize("weighted", [False, True])
def test_feature_moment_sums_match_the_tiled_batch(weighted):
    rng = np.random.default_rng(7)
    n, d = 700, 40
    X = rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.3)
    X[rng.random((n, d)) < 0.05] = 0.0
    weights = (rng.random(n) > 0.25) * rng.random(n) if weighted else None
    y = np.zeros(n)
    want = TiledBatch.from_dense(X, y, weights=weights).feature_moment_sums()
    got = CSRBatch.from_dense(X, y, weights=weights, device="cpu").feature_moment_sums()
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _norm_world():
    rng = np.random.default_rng(11)
    n, d = 120, 8
    X = rng.normal(size=(n, d)) * np.linspace(0.2, 5.0, d) + 1.5
    X *= rng.random((n, d)) < 0.8
    X[:, -1] = 1.0  # the intercept column
    y = (rng.random(n) < 0.5).astype(float)
    return X, y


@pytest.mark.parametrize("ntype", ["none", "scale_with_max_magnitude",
                                   "scale_with_standard_deviation", "standardization"])
@pytest.mark.parametrize("intercept", [None, 7])
def test_normalization_context_matches_the_reference(ntype, intercept):
    X, y = _norm_world()
    js = j_summarize(JSparse.from_dense(X, y))
    ts = summarize(SparseBatch.from_dense(X, y, device="cpu"))
    if ntype == "standardization" and intercept is None:
        for build, s in ((j_build_norm, js), (build_normalization_context, ts)):
            with pytest.raises(ValueError, match="intercept"):
                build(ntype, s, intercept_index=intercept)
        return
    want = j_build_norm(ntype, js, intercept_index=intercept)
    got = build_normalization_context(ntype, ts, intercept_index=intercept)
    assert got.intercept_index == want.intercept_index
    for name in ("factors", "shifts"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
            if intercept is not None:
                assert float(g[intercept]) == (1.0 if name == "factors" else 0.0)


def test_normalization_needs_a_summary():
    for build in (j_build_norm, build_normalization_context):
        with pytest.raises(ValueError, match="summary"):
            build("standardization", None, intercept_index=0)


def test_standardized_train_glm_matches_the_reference():
    """A standardization context built by each package from its own summary,
    then each package's sweep over the same lambdas."""
    X, y = _norm_world()
    lambdas = [10.0, 1.0]
    jctx = j_build_norm("standardization", j_summarize(JSparse.from_dense(X, y)), 7)
    tb = CSRBatch.from_dense(X, y, device="cpu")
    tctx = build_normalization_context("standardization", summarize(tb), 7)
    je = j_train(TiledBatch.from_dense(X, y), "logistic", lambdas,
                 JCfg(regularization=JReg(JRegType.L2)), normalization=jctx)
    te = train_glm(tb, "logistic", lambdas,
                   OptimizerConfig(regularization=RegularizationContext(RegularizationType.L2)),
                   normalization=tctx, device="cpu")
    for j, t in zip(je, te, strict=True):
        np.testing.assert_allclose(t.model.coefficients.means.numpy(),
                                   np.asarray(j.model.coefficients.means), rtol=1e-2, atol=1e-3)
        np.testing.assert_allclose(float(t.result.value), float(j.result.value), rtol=1e-4)


def _validation_batches(case: str):
    """(JAX batch, port SparseBatch, port CSRBatch) of one validation case."""
    rng = np.random.default_rng(["ok", "bad_labels", "negative_poisson", "nan_feature",
                                 "everything", "nan_weight", "padded",
                                 "large"].index(case))
    n, d = (5000, 6) if case == "large" else (20, 4)
    X = rng.normal(size=(n, d))
    y = (rng.random(n) > 0.5).astype(float)
    weights, offsets = np.ones(n), np.zeros(n)
    if case in ("bad_labels", "everything", "large"):
        y = rng.normal(size=n) * 5
    if case == "negative_poisson":
        y = -np.ones(n)
    if case in ("nan_feature", "everything", "large"):
        X[3, 2] = np.nan
    if case in ("everything", "large"):
        weights[5] = -1.0
        offsets[7] = np.inf
    if case == "nan_weight":
        weights[4] = np.nan
    jb = JSparse.from_dense(X, y, offsets=offsets, weights=weights)
    if case == "padded":  # padded rows of weight 0 with labels out of range
        jb = jb.pad_rows_to(32, 128)
        labels = np.array(jb.labels)
        labels[25] = 7.0
        jb = dataclasses.replace(jb, labels=labels)
    a = {k: np.asarray(getattr(jb, k)) for k in
         ("values", "rows", "cols", "labels", "offsets", "weights")}
    ports = [cls.from_coo(a["values"], a["rows"], a["cols"], a["labels"], d,
                          offsets=a["offsets"], weights=a["weights"], device="cpu")
             for cls in (SparseBatch, CSRBatch)]
    return jb, *ports


def _outcome(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except (JError, DataValidationError) as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("collect_all", [False, True])
@pytest.mark.parametrize("mode", ["validate_full", "validate_sample"])
@pytest.mark.parametrize("task", ["logistic_regression", "linear_regression",
                                  "poisson_regression"])
@pytest.mark.parametrize("case", ["ok", "bad_labels", "negative_poisson", "nan_feature",
                                  "everything", "nan_weight", "padded", "large"])
def test_validate_matches_the_reference(case, task, mode, collect_all):
    jb, sparse, csr = _validation_batches(case)
    want = _outcome(j_validate, jb, task, mode=JMode(mode), seed=3, collect_all=collect_all)
    for batch in (sparse, csr):
        got = _outcome(validate, batch, task, mode=ValidationMode(mode), seed=3,
                       collect_all=collect_all)
        assert got == want, (type(batch).__name__, got, want)


def test_validate_disabled_accepts_anything():
    _, sparse, csr = _validation_batches("everything")
    for batch in (sparse, csr):
        validate(batch, "logistic", mode=ValidationMode.DISABLED)


def test_sparse_batch_helpers_match_the_reference():
    rng = np.random.default_rng(5)
    blocks = []
    for n in (7, 12):
        X = rng.normal(size=(n, 6)) * (rng.random((n, 6)) < 0.5)
        y = rng.random(n)
        blocks.append((JSparse.from_dense(X, y), SparseBatch.from_dense(X, y, device="cpu")))
    jb, tb = blocks[0]
    assert tb.dtype == torch.float32
    np.testing.assert_array_equal(tb.to_dense(), jb.to_dense())
    jp, tp = jb.pad_rows_to(16, 64), tb.pad_rows_to(16, 64)
    for field in ("values", "rows", "cols", "labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                      np.asarray(getattr(jp, field)), err_msg=field)
    with pytest.raises(ValueError, match="smaller"):
        tb.pad_rows_to(3, 64)
    jc = j_concat([b[0] for b in blocks])
    tc = concat_batches([b[1] for b in blocks])
    np.testing.assert_array_equal(tc.to_dense(), jc.to_dense())
    np.testing.assert_array_equal(tc.labels.numpy(), np.asarray(jc.labels))
    with pytest.raises(ValueError, match="mismatch"):
        concat_batches([tb, SparseBatch.from_dense(np.ones((2, 3)), np.ones(2),
                                                   device="cpu")])


@pytest.mark.parametrize("task", ["logistic", "smoothed_hinge", "poisson", "squared"])
def test_glm_model_methods_match_the_reference(task):
    rng = np.random.default_rng(9)
    X = rng.normal(size=(40, 5))
    y = (rng.random(40) > 0.5).astype(float)
    means = rng.normal(size=5).astype(np.float32)
    jm = j_make_model(task, jnp.asarray(means))
    tm = make_model(task, torch.from_numpy(means))
    assert tm.coefficients.dim == jm.coefficients.dim == 5
    for order in (1, 2):
        np.testing.assert_allclose(float(tm.coefficients.norm(order)),
                                   float(jm.coefficients.norm(order)), rtol=1e-6)
    jb, tb = JSparse.from_dense(X, y), SparseBatch.from_dense(X, y, device="cpu")
    if task in ("poisson", "squared"):
        for m in (jm, tm):
            with pytest.raises(ValueError, match="binary"):
                m.predict_class(jb if m is jm else tb)
    else:
        np.testing.assert_array_equal(tm.predict_class(tb, 0.4).numpy(),
                                      np.asarray(jm.predict_class(jb, 0.4)))
    w2 = torch.ones(5)
    swapped = tm.with_coefficients(w2, variances=w2 * 2)
    assert swapped.task == tm.task and torch.equal(swapped.coefficients.means, w2)
    assert torch.equal(swapped.coefficients.variances, w2 * 2)


@pytest.mark.parametrize("reg", ["none", "l1", "l2", "elastic_net"])
def test_factory_matches_the_reference(reg):
    rng = np.random.default_rng(13)
    X = rng.normal(size=(200, 6)) * (rng.random((200, 6)) < 0.7)
    y = (rng.random(200) < 1 / (1 + np.exp(-X @ rng.normal(size=6)))).astype(float)
    jreg = JReg(JRegType(reg), alpha=0.4)
    treg = RegularizationContext(RegularizationType(reg), alpha=0.4)
    for g, w in zip(split_reg_weights(treg, [0.5, 2.0]), j_split(jreg, [0.5, 2.0]),
                    strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7)
    jcfg = JCfg(regularization=jreg, regularization_weight=0.7, max_iterations=50)
    tcfg = OptimizerConfig(regularization=treg, regularization_weight=0.7, max_iterations=50)
    assert build_objective("logistic", tcfg).l2_weight == pytest.approx(
        float(j_build_objective("logistic", jcfg).l2_weight))
    want = j_solve("logistic", JSparse.from_dense(X, y), jcfg, jnp.zeros(6, jnp.float32))
    got = solve("logistic", CSRBatch.from_dense(X, y, device="cpu"), tcfg, torch.zeros(6),
                device="cpu")
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(float(got.value), float(want.value), rtol=1e-4)
