"""The slice as a whole: ``train_glm`` of the port (CSRBatch, plain kernel
versions on the CPU) against ``train_glm`` of the JAX package (TiledBatch,
Pallas kernels in interpret mode): a 3-lambda warm-started L2 sweep with a
normalization context and variances, model selection, a warm start
carried across from a JAX-trained model by ``convert.model_from_jax``, and
sweeps with TRON (normalized, with variances), with elastic net (OWLQN) and
with box-constrained Poisson. TRON, OWLQN and the box path stop within a few
iterations, before float32 noise decides their step counts.

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
from photon_ml_tpu.optim import OptimizerType as JOptType
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


@pytest.mark.parametrize("metric", ["logistic_loss", "squared_loss", "smoothed_hinge_loss"])
def test_model_selection_by_a_mean_loss_matches_reference(world, sweeps, metric):
    je, te = sweeps
    _, jv, _ = world["jax"]
    _, tv, _ = world["torch"]
    j_best, j_val = j_select(je, jv, metric=metric)
    t_best, t_val = t_select(te, tv, metric=metric)
    assert t_best.reg_weight == j_best.reg_weight
    assert abs(t_val - j_val) <= 1e-4


def test_model_selection_refuses_a_sharded_metric_as_the_reference_does(world, sweeps):
    je, te = sweeps
    for select, entries, batch in ((j_select, je, world["jax"][1]),
                                   (t_select, te, world["torch"][1])):
        with pytest.raises(ValueError, match="unknown metric 'auc:userId'"):
            select(entries, batch, metric="auc:userId")


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
    """NEWTON solves dense per-entity buckets; on the CSR layout it is
    refused, as the reference refuses it on TiledBatch (no dense Hessian)."""
    tb, _, _ = world["torch"]
    with pytest.raises(ValueError, match="dense-Hessian"):
        t_train(tb, "logistic", [1.0], TCfg(optimizer_type=OptimizerType.NEWTON),
                device="cpu")


INVALID = {
    "tron_l1": dict(optimizer_type="TRON", reg="L1", task="logistic"),
    "tron_elastic_net": dict(optimizer_type="TRON", reg="ELASTIC_NET", task="squared"),
    "tron_smoothed_hinge": dict(optimizer_type="TRON", reg="L2", task="smoothed_hinge"),
    "newton_l1": dict(optimizer_type="NEWTON", reg="L1", task="logistic"),
    "newton_smoothed_hinge": dict(optimizer_type="NEWTON", reg="L2", task="smoothed_hinge"),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validate_refuses_what_the_reference_refuses(world, case):
    c = INVALID[case]
    jcfg = JCfg(optimizer_type=getattr(JOptType, c["optimizer_type"]),
                regularization=JReg(getattr(JRegType, c["reg"]), alpha=0.5))
    tcfg = TCfg(optimizer_type=getattr(OptimizerType, c["optimizer_type"]),
                regularization=RegularizationContext(getattr(RegularizationType, c["reg"]),
                                                     alpha=0.5))
    with pytest.raises(ValueError) as want:
        jcfg.validate(c["task"])
    with pytest.raises(ValueError) as got:
        tcfg.validate(c["task"])
    assert str(got.value) == str(want.value)
    tb, _, _ = world["torch"]
    with pytest.raises(ValueError):
        t_train(tb, c["task"], [1.0], tcfg, device="cpu")


def _linear(rng, n=N, d=D):
    X = rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.5)
    y = X @ (rng.normal(size=d) * (rng.random(d) < 0.6)) + 0.1 * rng.normal(size=n)
    return X, y


def _assert_same_sweep(je, te, values_rtol=1e-4):
    for j, t in zip(je, te):
        assert t.reg_weight == j.reg_weight
        assert t.result.iterations == int(j.result.iterations)
        assert t.result.reason == int(j.result.reason)
        assert t.result.data_passes == int(j.result.data_passes)
        np.testing.assert_allclose(float(t.result.value), float(j.result.value),
                                   rtol=values_rtol)
        np.testing.assert_allclose(t.model.coefficients.means.numpy(),
                                   np.asarray(j.model.coefficients.means),
                                   rtol=1e-2, atol=1e-3)


def test_tron_sweep_matches_reference(world):
    jb, _, jn = world["jax"]
    tb, _, tn = world["torch"]
    jcfg = JCfg(optimizer_type=JOptType.TRON, regularization=JReg(JRegType.L2),
                max_iterations=3, tolerance=0.0)
    tcfg = TCfg(optimizer_type=OptimizerType.TRON,
                regularization=RegularizationContext(RegularizationType.L2),
                max_iterations=3, tolerance=0.0)
    je = j_train(jb, "logistic", [10.0, 1.0], jcfg, normalization=jn, compute_variances=True)
    te = t_train(tb, "logistic", [10.0, 1.0], tcfg, normalization=tn,
                 compute_variances=True, device="cpu")
    _assert_same_sweep(je, te)
    for j, t in zip(je, te):
        np.testing.assert_allclose(t.model.coefficients.variances.numpy(),
                                   np.asarray(j.model.coefficients.variances), rtol=1e-3)
        assert t.result.data_passes > t.result.iterations + 1


def test_elastic_net_sweep_matches_reference():
    X, y = _linear(np.random.default_rng(45))
    reg = dict(alpha=0.5)
    jcfg = JCfg(regularization=JReg(JRegType.ELASTIC_NET, **reg), max_iterations=5,
                tolerance=0.0)
    tcfg = TCfg(regularization=RegularizationContext(RegularizationType.ELASTIC_NET, **reg),
                max_iterations=5, tolerance=0.0)
    je = j_train(TiledBatch.from_dense(X, y), "linear_regression", [40.0, 10.0], jcfg)
    te = t_train(CSRBatch.from_dense(X, y, device="cpu"), "linear_regression", [40.0, 10.0],
                 tcfg, device="cpu")
    _assert_same_sweep(je, te)
    for j, t in zip(je, te):
        wj, wt = np.asarray(j.model.coefficients.means), t.model.coefficients.means.numpy()
        decided = np.abs(wj) >= 1e-4
        np.testing.assert_array_equal(wt[decided] == 0.0, wj[decided] == 0.0)
        assert t.result.data_passes == t.result.iterations + 1
    assert int(np.sum(te[0].model.coefficients.means.numpy() == 0.0)) > 0


def test_box_constrained_poisson_sweep_matches_reference():
    rng = np.random.default_rng(46)
    X = rng.normal(size=(N, D)) * (rng.random((N, D)) < 0.4)
    off = rng.normal(size=N) * 0.3
    y = rng.poisson(np.exp(np.clip(0.2 * (X @ rng.normal(size=D)) + off, -4, 4)))
    box = tuple((i, -0.2, 0.2) for i in range(D))
    jcfg = JCfg(regularization=JReg(JRegType.L2), max_iterations=8, tolerance=0.0,
                box_constraints=box)
    tcfg = TCfg(regularization=RegularizationContext(RegularizationType.L2),
                max_iterations=8, tolerance=0.0, box_constraints=box)
    je = j_train(TiledBatch.from_dense(X, y, offsets=off), "poisson", [1.0], jcfg)
    te = t_train(CSRBatch.from_dense(X, y, offsets=off, device="cpu"), "poisson", [1.0],
                 tcfg, device="cpu")
    _assert_same_sweep(je, te)
    means = te[0].model.coefficients.means.numpy()
    assert np.abs(means).max() == np.float32(0.2)  # the box binds


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
