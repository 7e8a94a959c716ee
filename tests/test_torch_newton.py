"""The port's batched Newton (one solve over every entity of a bucket, lanes
frozen per entity) against the JAX ``newton_solve`` under ``vmap`` over the
same bucket, for squared, logistic and Poisson losses.

One lane carries negative weights, so its Hessian is not positive definite:
its Cholesky fails on both sides and it steps along -grad. One lane is all
padding (weight 0) and stops at once. Per-entity w within rtol 1e-4, atol
1e-5; reasons and iteration counts equal. The tolerance 1e-3 stops every
lane while its last step still lowers the objective by far more than
float32 noise: at 1e-5 a lane's final damping decision follows rounding, and
the JAX and port sums run in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.dense import DenseBatch as JDense
from photon_ml_tpu.ops.objective import make_objective as j_make
from photon_ml_tpu.optim import glm_adapter as j_adapter
from photon_ml_tpu.optim.newton import NewtonConfig as JNewtonConfig
from photon_ml_tpu.optim.newton import newton_solve as j_newton
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.ops.objective import make_objective as t_make
from photon_ml_tpu_torch.optim import NewtonConfig, glm_adapter, newton_solve
from photon_ml_tpu_torch.optim.common import (
    GRADIENT_CONVERGED,
    BoxConstraints,
    MAX_ITERATIONS,
    NOT_CONVERGED,
    OBJECTIVE_NOT_IMPROVING,
)
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
    dispatch_solve,
)

E, R, K = 16, 12, 4
NOT_SPD, PADDED = 5, 11


def _bucket(loss, seed=21):
    """A bucket of E problems; in the squared one the indefinite lane is
    unbounded below and runs to MAX_ITERATIONS."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, R, K))
    w_true = rng.normal(size=(E, K)) * 0.5
    z = np.einsum("erk,ek->er", x, w_true)
    if loss == "squared":
        y = z + 0.1 * rng.normal(size=(E, R))
    elif loss == "poisson":
        y = rng.poisson(np.exp(np.clip(0.5 * z, -3, 3))).astype(np.float64)
    else:
        y = (rng.random((E, R)) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    off = rng.normal(size=(E, R)) * 0.1
    wgt = rng.random((E, R)) + 0.5
    wgt[:, R - 3:] = 0.0  # padded rows
    wgt[NOT_SPD] = -1.0  # an indefinite Hessian
    wgt[PADDED] = 0.0  # an all-padding lane
    return [a.astype(np.float32) for a in (x, y, off, wgt)]


def _solve_both(loss, l2=1.0, max_iterations=8, tolerance=1e-3, w0=None):
    x, y, off, wgt = _bucket(loss)
    w0 = np.zeros((E, K), np.float32) if w0 is None else w0
    jo = j_make(loss, l2_weight=l2)
    jcfg = JNewtonConfig(max_iterations=max_iterations, tolerance=tolerance)

    def one(xe, ye, oe, we, w0e):
        a = j_adapter(jo, JDense(x=xe, labels=ye, offsets=oe, weights=we))
        return j_newton(a.value_and_grad, a.hessian, w0e, jcfg, ls_prepare=a.ls_prepare,
                        ls_eval=a.ls_eval)

    rj = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (x, y, off, wgt, w0)))
    tb = DenseBatch.from_arrays(x, y, off, wgt, device="cpu")
    a = glm_adapter(t_make(loss, l2_weight=l2), tb)
    tcfg = NewtonConfig(max_iterations=max_iterations, tolerance=tolerance)
    rt = newton_solve(a.value_and_grad, a.hessian, torch.from_numpy(w0), a.ls_prepare,
                      a.ls_eval, tcfg, device="cpu")
    return rj, rt


def _assert_same(rj, rt):
    np.testing.assert_array_equal(rt.reason.numpy(), np.asarray(rj.reason))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rt.value.numpy(), np.asarray(rj.value), rtol=1e-4, atol=1e-5)
    finite = np.isfinite(np.asarray(rj.values))
    np.testing.assert_array_equal(np.isfinite(rt.values.numpy()), finite)
    np.testing.assert_allclose(rt.values.numpy()[finite], np.asarray(rj.values)[finite],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("loss", ["squared", "logistic", "poisson"])
def test_batched_newton_matches_vmapped_reference(loss):
    rj, rt = _solve_both(loss)
    _assert_same(rj, rt)
    x, y, off, wgt = _bucket(loss)
    hess = glm_adapter(t_make(loss, l2_weight=1.0),
                       DenseBatch.from_arrays(x, y, off, wgt, device="cpu")).hessian
    info = torch.linalg.cholesky_ex(hess(torch.zeros(E, K)))[1]
    assert info[NOT_SPD] > 0 and (info[:NOT_SPD] == 0).all()  # the -grad lane
    reasons = rt.reason.numpy()
    assert reasons[PADDED] == OBJECTIVE_NOT_IMPROVING and rt.iterations[PADDED] == 1
    assert loss != "squared" or reasons[NOT_SPD] == MAX_ITERATIONS
    assert (reasons != NOT_CONVERGED).all()
    assert len(set(rt.iterations.tolist())) > 1  # lanes froze at different steps


def test_warm_start_and_gradient_convergence_match_reference():
    w0 = np.random.default_rng(2).normal(size=(E, K)).astype(np.float32) * 0.3
    rj, rt = _solve_both("squared", l2=0.5, max_iterations=5, tolerance=1e-3, w0=w0)
    _assert_same(rj, rt)
    assert GRADIENT_CONVERGED in rt.reason.tolist()


def test_one_host_fetch_per_iteration():
    x, y, off, wgt = _bucket("logistic")
    a = glm_adapter(t_make("logistic", l2_weight=1.0),
                    DenseBatch.from_arrays(x, y, off, wgt, device="cpu"))
    telemetry.reset()
    rt = newton_solve(a.value_and_grad, a.hessian, torch.zeros(E, K), a.ls_prepare,
                      a.ls_eval, NewtonConfig(max_iterations=6), device="cpu")
    assert telemetry.snapshot()["counters"]["host_syncs"] == int(rt.iterations.max())


def test_newton_refuses_a_single_problem():
    x, y, off, wgt = _bucket("squared")
    a = glm_adapter(t_make("squared"), DenseBatch.from_arrays(x, y, off, wgt, device="cpu"))
    with pytest.raises(ValueError, match=r"\[E, K\]"):
        newton_solve(a.value_and_grad, a.hessian, torch.zeros(K), a.ls_prepare, a.ls_eval,
                     device="cpu")


def test_dispatch_routes_newton_and_matches_the_direct_solve():
    x, y, off, wgt = _bucket("logistic")
    obj = t_make("logistic", l2_weight=1.0)
    a = glm_adapter(obj, DenseBatch.from_arrays(x, y, off, wgt, device="cpu"))
    cfg = OptimizerConfig(optimizer_type=OptimizerType.NEWTON, max_iterations=8,
                          tolerance=1e-5,
                          regularization=RegularizationContext(RegularizationType.L2))
    got = dispatch_solve(a, torch.zeros(E, K), cfg, device="cpu")
    want = newton_solve(a.value_and_grad, a.hessian, torch.zeros(E, K), a.ls_prepare,
                        a.ls_eval, NewtonConfig(max_iterations=8, tolerance=1e-5), device="cpu")
    assert torch.equal(got.w, want.w) and torch.equal(got.reason, want.reason)
    no_hessian = a._replace(hessian=None)
    with pytest.raises(ValueError, match="dense-Hessian"):
        dispatch_solve(no_hessian, torch.zeros(E, K), cfg, device="cpu")
    box = BoxConstraints(lower=torch.full((K,), -0.2), upper=torch.full((K,), 0.2))
    boxed = dispatch_solve(a, torch.zeros(E, K), cfg, constraints=box, device="cpu")
    direct = newton_solve(a.value_and_grad, a.hessian, torch.zeros(E, K), a.ls_prepare,
                          a.ls_eval, NewtonConfig(max_iterations=8, tolerance=1e-5),
                          device="cpu", constraints=box, value=a.value)
    assert torch.equal(boxed.w, direct.w) and torch.equal(boxed.reason, direct.reason)
    assert bool((boxed.w.abs() <= 0.2).all()) and not torch.equal(boxed.w, got.w)
