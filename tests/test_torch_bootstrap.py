"""The port's bootstraps (``photon_ml_tpu_torch.diagnostics.bootstrap``)
against the JAX package's, on the CPU: the resample weights bit for bit the
reference's (the same seeded numpy draws), the fixed-effect and the
random-effect summaries against the JAX package's, and the determinism
contract: a gathered subset of entity lanes gives bit for bit the full run's
coefficients on those entities, on the dense and on the COO layout.

Tolerances: coefficient summaries atol 1e-3 and holdout metric means atol
1e-4 or rtol 1e-5, whichever is looser (the AIC is ~80: each package's lanes
stop within its solver's tolerance, summed in a different order); the
gathered lanes and the weights exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.diagnostics import bootstrap as jb
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim.factory import OptimizerConfig as JOpt
from photon_ml_tpu.optim.factory import OptimizerType as JOptType
from photon_ml_tpu.optim.factory import RegularizationContext as JReg
from photon_ml_tpu.optim.factory import RegularizationType as JRegType
from photon_ml_tpu.testing import generate_glm_problem
from photon_ml_tpu_torch.diagnostics import bootstrap as tb
from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)

E, R, K = 24, 8, 4


def _configs(kind="lbfgs", iters=50):
    jt = {"lbfgs": JOptType.LBFGS, "newton": JOptType.NEWTON}[kind]
    tt = {"lbfgs": OptimizerType.LBFGS, "newton": OptimizerType.NEWTON}[kind]
    return (JOpt(optimizer_type=jt, max_iterations=iters, tolerance=1e-7,
                 regularization=JReg(JRegType.L2), regularization_weight=1.0),
            OptimizerConfig(optimizer_type=tt, max_iterations=iters, tolerance=1e-7,
                            regularization=RegularizationContext(RegularizationType.L2),
                            regularization_weight=1.0))


@pytest.fixture(scope="module")
def glm():
    p = generate_glm_problem("logistic", n=300, d=8, seed=3)
    return p, CSRBatch.from_dense(p.X, p.y, device="cpu")


def test_fe_resample_weights_are_the_references_bit_for_bit(glm, monkeypatch):
    p, _ = glm
    seen = {}
    orig = jb._bootstrap_solver

    def capture(config, loss):
        solver = orig(config, loss)

        def run(obj, batch, weights, *rest):
            seen["weights"] = np.asarray(weights)
            return solver(obj, batch, weights, *rest)

        return run

    monkeypatch.setattr(jb, "_bootstrap_solver", capture)
    holdouts = []

    def metrics(m, hb):
        holdouts.append(np.asarray(hb.weights) > 0)
        return {}

    jb.bootstrap_train(p.batch, "logistic", _configs()[0], num_samples=6, train_portion=0.7,
                       seed=9, metrics_fn=metrics)
    w, hold = tb.bootstrap_sample_weights(np.asarray(p.batch.weights), 6, 0.7, seed=9)
    np.testing.assert_array_equal(w.astype(np.float32), seen["weights"])
    np.testing.assert_array_equal(hold, np.stack(holdouts))


def test_fe_summaries_match_the_jax_bootstrap(glm):
    p, batch = glm
    jcfg, tcfg = _configs()
    ref = jb.bootstrap_train(p.batch, "logistic", jcfg, num_samples=8)
    got = tb.bootstrap_train(batch, "logistic", tcfg, num_samples=8, keep_models=True,
                             device="cpu")
    assert len(got.coefficient_summaries) == 8 and len(got.models) == 8
    for a, b in zip(got.coefficient_summaries, ref.coefficient_summaries):
        assert a.count == b.count == 8
        np.testing.assert_allclose([a.mean, a.min, a.max, a.median],
                                   [b.mean, b.min, b.max, b.median], atol=1e-3)
    assert set(got.metric_summaries) == set(ref.metric_summaries)
    for k, s in got.metric_summaries.items():
        assert s.mean == pytest.approx(ref.metric_summaries[k].mean, rel=1e-5, abs=1e-4)
    np.testing.assert_array_equal(got.significant_coefficients(),
                                  ref.significant_coefficients())


def test_fe_lanes_are_independent_refits(glm):
    """Each lane of the bootstrap's one solve against that sample's refit
    alone (the same weights, one lane)."""
    _, batch = glm
    _, tcfg = _configs()
    got = tb.bootstrap_train(batch, "logistic", tcfg, num_samples=4, keep_models=True,
                             device="cpu")
    w, _ = tb.bootstrap_sample_weights(batch.weights.numpy(), 4, 0.8, seed=0)
    one = tb.bootstrap_train(batch, "logistic", tcfg, num_samples=2, keep_models=True,
                             device="cpu")  # lanes 0 and 1 of the same draw
    for b in range(2):
        assert torch.equal(one.models[b].coefficients.means, got.models[b].coefficients.means)
    assert w.shape == (4, batch.num_rows)


def test_bootstrap_validates_args(glm):
    _, batch = glm
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="at least 2"):
        tb.bootstrap_train(batch, "logistic", tcfg, num_samples=1, device="cpu")
    with pytest.raises(ValueError, match="train_portion"):
        tb.bootstrap_train(batch, "logistic", tcfg, train_portion=0.0, device="cpu")


def test_bootstrap_ci_covers_true_coefficients():
    p = generate_glm_problem("logistic", n=2000, d=5, seed=1)
    rep = tb.bootstrap_train(CSRBatch.from_dense(p.X, p.y, device="cpu"), "logistic",
                             dataclasses.replace(_configs()[1], regularization_weight=0.0),
                             num_samples=16, device="cpu")
    covered = [s.min - 0.2 <= t <= s.max + 0.2
               for s, t in zip(rep.coefficient_summaries, p.w_true)]
    assert sum(covered) >= 4


# -- the random-effect bootstrap ----------------------------------------------


def _bucket(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, R, K))
    w = rng.normal(size=(E, K))
    y = (rng.random((E, R)) < 1 / (1 + np.exp(-np.einsum("erk,ek->er", x, w)))).astype(float)
    weights = np.ones((E, R))
    weights[3, 5:] = 0.0  # padded rows
    weights[7] = 0.0  # an empty lane
    return x, y, weights


def _jax_bucket(x, y, weights):
    nnz = R * K
    return JSparse(
        values=jnp.asarray(x.reshape(E, nnz), jnp.float32),
        rows=jnp.asarray(np.broadcast_to(np.repeat(np.arange(R, dtype=np.int32), K), (E, nnz))),
        cols=jnp.asarray(np.broadcast_to(np.tile(np.arange(K, dtype=np.int32), R), (E, nnz))),
        labels=jnp.asarray(y, jnp.float32), offsets=jnp.zeros((E, R), jnp.float32),
        weights=jnp.asarray(weights, jnp.float32), num_features=K)


def _port_bucket(layout, x, y, weights):
    if layout == "dense":
        return DenseBatch.from_arrays(x, y, weights=weights, device="cpu")
    n = len(x)
    return BlockDiagonalBatch.from_bucket(
        x.reshape(n, R * K), np.broadcast_to(np.repeat(np.arange(R), K), (n, R * K)),
        np.broadcast_to(np.tile(np.arange(K), R), (n, R * K)), y, np.zeros((n, R)), weights,
        K, device="cpu")


def test_re_resample_weights_are_the_references_bit_for_bit():
    _, _, weights = _bucket()
    np.testing.assert_array_equal(tb.bootstrap_re_weights(16, weights, seed=3),
                                  jb.bootstrap_re_weights(16, weights, seed=3))


@pytest.mark.parametrize("kind", ["newton", "lbfgs"])
def test_re_summaries_match_the_jax_bootstrap(kind):
    x, y, weights = _bucket()
    jcfg, tcfg = _configs(kind, iters=10 if kind == "newton" else 40)
    ref = jb.bootstrap_random_effect(_jax_bucket(x, y, weights), "logistic", jcfg,
                                     jnp.zeros((E, K)), num_samples=8, seed=2)
    got = tb.bootstrap_random_effect(_port_bucket("dense", x, y, weights), "logistic", tcfg,
                                     torch.zeros(E, K), num_samples=8, seed=2, device="cpu")
    np.testing.assert_array_equal(got.live_entities, ref.live_entities)
    for field in ("mean", "median", "ci_low", "ci_high", "std_dev"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field), atol=1e-3)
    assert got.summary()["entities"] == ref.summary()["entities"] == E - 1


@pytest.mark.parametrize("layout", ["dense", "coo"])
@pytest.mark.parametrize("kind", ["newton", "lbfgs"])
def test_gathered_entity_lanes_equal_the_full_run_bit_for_bit(layout, kind):
    """The masked-lane contract: the lanes of a gathered subset of entities,
    with the full run's draws for them, are the full run's lanes exactly."""
    x, y, weights = _bucket(1)
    _, tcfg = _configs(kind, iters=10 if kind == "newton" else 30)
    lw = tb.bootstrap_re_weights(6, weights, seed=4)
    w0 = torch.from_numpy(np.random.default_rng(2).normal(size=(E, K)).astype(np.float32))
    full = tb.bootstrap_random_effect(_port_bucket(layout, x, y, weights), "logistic", tcfg,
                                      w0, lane_weights=lw, device="cpu")
    idx = np.array([0, 3, 7, 11, 20])
    part = tb.bootstrap_random_effect(_port_bucket(layout, x[idx], y[idx], weights[idx]),
                                      "logistic", tcfg, w0[idx], lane_weights=lw[:, idx],
                                      device="cpu")
    np.testing.assert_array_equal(part.samples, full.samples[:, idx])
    for field in ("mean", "std_dev", "q1", "median", "q3", "ci_low", "ci_high"):
        np.testing.assert_array_equal(getattr(part, field), getattr(full, field)[idx])
    np.testing.assert_array_equal(part.live_entities, full.live_entities[idx])


def test_re_bootstrap_validates_args():
    x, y, weights = _bucket()
    with pytest.raises(ValueError, match="at least 2"):
        tb.bootstrap_random_effect(_port_bucket("dense", x, y, weights), "logistic",
                                   _configs()[1], torch.zeros(E, K), num_samples=1, device="cpu")
