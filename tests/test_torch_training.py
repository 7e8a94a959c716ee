"""The slice as a whole: ``train_glm`` of the port (CSRBatch, plain kernel
versions on the CPU) against ``train_glm`` of the JAX package (TiledBatch,
Pallas kernels in interpret mode): a 3-lambda warm-started L2 sweep with a
normalization context and variances, model selection, and a warm start
carried across from a JAX-trained model by ``convert.model_from_jax``.

Tolerances: means rtol 1e-2, atol 1e-3 (the LBFGS optimum in float32,
tests/test_tiled.py:123-133); variances rtol 1e-3 (1/diag H at that optimum);
validation AUC within 1e-4; carried-over scores within 1e-5 of exact float32
gathers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from photon_ml_tpu.data.normalization import NormalizationContext as JNorm
from photon_ml_tpu.evaluation import auc as j_auc
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.ops.tiled import TiledBatch
from photon_ml_tpu.optim import OptimizerConfig as JCfg
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu.training import select_best_model as j_select
from photon_ml_tpu.training import train_glm as j_train
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.evaluation.evaluators import auc as t_auc
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.optim.factory import OptimizerConfig as TCfg
from photon_ml_tpu_torch.optim.factory import (
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.training import select_best_model as t_select
from photon_ml_tpu_torch.training import train_glm as t_train

N, D = 320, 14
LAMBDAS = [0.3, 10.0, 1.0]


def _data(rng, n):
    X = rng.normal(size=(n, D)) * (rng.random((n, D)) < 0.5) + 0.4
    X[:, 0] = 1.0  # intercept column
    w_true = rng.normal(size=D)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(44)
    X, y = _data(rng, N)
    Xv, yv = _data(rng, 200)
    mean, std = X.mean(0), X.std(0)
    std[0] = 1.0
    factors = (1.0 / std).astype(np.float32)
    shifts = mean.astype(np.float32)
    factors[0], shifts[0] = 1.0, 0.0  # the intercept stays unnormalized
    return {
        "X": (X, y),
        "jax": (TiledBatch.from_dense(X, y), TiledBatch.from_dense(Xv, yv),
                JNorm(factors=jnp.asarray(factors), shifts=jnp.asarray(shifts),
                      intercept_index=0)),
        "torch": (CSRBatch.from_dense(X, y, device="cpu"),
                  CSRBatch.from_dense(Xv, yv, device="cpu"),
                  convert.normalization_from_jax(factors, shifts, 0, device="cpu")),
    }


@pytest.fixture(scope="module")
def sweeps(world):
    jb, _, jn = world["jax"]
    tb, _, tn = world["torch"]
    jcfg = JCfg(regularization=JReg(JRegType.L2))
    tcfg = TCfg(regularization=RegularizationContext(RegularizationType.L2))
    je = j_train(jb, "logistic", LAMBDAS, jcfg, normalization=jn, compute_variances=True)
    te = t_train(tb, "logistic", LAMBDAS, tcfg, normalization=tn, compute_variances=True,
                 device="cpu")
    return je, te


@pytest.mark.parametrize("k", range(len(LAMBDAS)))
def test_sweep_means_and_variances_match_reference(sweeps, k):
    je, te = sweeps
    assert te[k].reg_weight == je[k].reg_weight == LAMBDAS[k]
    jc, tc = je[k].model.coefficients, te[k].model.coefficients
    np.testing.assert_allclose(tc.means.numpy(), np.asarray(jc.means), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(tc.variances.numpy(), np.asarray(jc.variances), rtol=1e-3)
    # both solves stop at float32 noise (default tolerance 1e-7), where the
    # reason may read FunctionValuesConverged on one side and
    # ObjectiveNotImproving on the other; the optimum they reach agrees
    np.testing.assert_allclose(float(te[k].result.value), float(je[k].result.value),
                               rtol=1e-4)


def test_model_selection_matches_reference(world, sweeps):
    je, te = sweeps
    _, jv, _ = world["jax"]
    _, tv, _ = world["torch"]
    j_best, j_val = j_select(je, jv)
    t_best, t_val = t_select(te, tv)
    assert t_best.reg_weight == j_best.reg_weight
    assert abs(t_val - j_val) <= 1e-4
    for jentry, tentry in zip(je, te):
        want = float(j_auc(jentry.model.compute_score(jv), jv.labels, jv.weights))
        got = float(t_auc(tentry.model.compute_score(tv), tv.labels, tv.weights))
        assert abs(got - want) <= 1e-4


def test_warm_start_from_a_jax_model(world, sweeps):
    je, _ = sweeps
    jb, _, jn = world["jax"]
    tb, _, tn = world["torch"]
    jm = je[2].model  # lambda = 1.0
    tm = convert.model_from_jax(
        jm.task, np.asarray(jm.coefficients.means),
        np.asarray(jm.coefficients.variances), device="cpu")
    scores = tm.compute_score(tb).numpy()
    # exact float32 gathers agree to 1e-5; TiledBatch's bf16x2-split one-hot
    # matmuls hold the margins to its own kernel tolerance (test_tiled.py)
    exact = np.asarray(jm.compute_score(JSparse.from_dense(*world["X"])))
    np.testing.assert_allclose(scores, exact, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scores, np.asarray(jm.compute_score(jb))[:N],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm.coefficients.variances.numpy(),
                               np.asarray(jm.coefficients.variances), rtol=1e-6)

    jcfg = JCfg(regularization=JReg(JRegType.L2), max_iterations=5)
    tcfg = TCfg(regularization=RegularizationContext(RegularizationType.L2), max_iterations=5)
    (jw,) = j_train(jb, "logistic", [0.5], jcfg, normalization=jn, initial_model=jm)
    (tw,) = t_train(tb, "logistic", [0.5], tcfg, normalization=tn, initial_model=tm,
                    device="cpu")
    np.testing.assert_allclose(float(tw.result.values[0]), float(jw.result.values[0]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tw.result.value), float(jw.result.value), rtol=1e-5)


def test_train_glm_preserves_caller_order_and_counts_passes(sweeps):
    _, te = sweeps
    assert [e.reg_weight for e in te] == LAMBDAS
    for e in te:
        assert e.result.data_passes == e.result.iterations + 1
        assert e.model.task == "logistic"


def test_unported_optimizers_raise_not_implemented(world):
    tb, _, _ = world["torch"]
    for cfg in (TCfg(optimizer_type=OptimizerType.TRON),
                TCfg(regularization=RegularizationContext(RegularizationType.L1))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_train(tb, "logistic", [1.0], cfg, device="cpu")


def test_variances_refuse_the_smoothed_hinge(world):
    tb, _, _ = world["torch"]
    with pytest.raises(ValueError, match="twice-differentiable"):
        t_train(tb, "smoothed_hinge", [1.0], TCfg(max_iterations=2),
                compute_variances=True, device="cpu")


def test_normalization_round_trip(world):
    _, _, tn = world["torch"]
    w = torch.linspace(-1.0, 1.0, D)
    back = tn.inverse_transform_model_coefficients(tn.transform_model_coefficients(w))
    np.testing.assert_allclose(back.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
