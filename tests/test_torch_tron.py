"""The port's TRON on CSRBatch against the JAX ``tron_solve`` on TiledBatch
(Pallas kernels in interpret mode): the margin-carrying path (``hvp_at`` per
CG step) and the box-constrained path (fused ``hvp``).

Iterations, convergence reason and data passes must be equal: the host
takes the reference's CG and trust-region decisions in the same float32
arithmetic. The solves stop within four steps, before the gradient reaches
float32 noise: beyond it the CG step counts depend on rounding, and the JAX
package's own two layouts (TiledBatch, SparseBatch) then disagree on them.
Final value rtol 1e-4; w rtol 1e-2, atol 1e-3 (tests/test_tiled.py:136-144).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from photon_ml_tpu.ops.objective import make_objective as j_make
from photon_ml_tpu.ops.tiled import TiledBatch
from photon_ml_tpu.optim import BoxConstraints as JBox
from photon_ml_tpu.optim import TRONConfig as JConfig
from photon_ml_tpu.optim import glm_adapter as j_adapter
from photon_ml_tpu.optim import tron_solve as j_tron
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.objective import make_objective as t_make
from photon_ml_tpu_torch.optim import BoxConstraints as TBox
from photon_ml_tpu_torch.optim import TRONConfig as TConfig
from photon_ml_tpu_torch.optim import glm_adapter as t_adapter
from photon_ml_tpu_torch.optim import tron_solve as t_tron
from photon_ml_tpu_torch.optim.common import MAX_ITERATIONS

N, F = 256, 24


def _data(loss, seed=51, n=N, f=F):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)) * (rng.random((n, f)) < 0.35)
    w_true = rng.normal(size=f)
    if loss == "squared":
        y = X @ w_true + 0.1 * rng.normal(size=n)
    else:
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    wgt = rng.random(n) + 0.5
    return X, y, wgt


@pytest.fixture(scope="module", params=["squared", "logistic"])
def problem(request):
    loss = request.param
    X, y, wgt = _data(loss)
    return (loss, X, y, wgt, TiledBatch.from_dense(X, y, weights=wgt),
            CSRBatch.from_dense(X, y, weights=wgt, device="cpu"))


def _box(lo, hi, f=F):
    lower, upper = np.full(f, lo, np.float32), np.full(f, hi, np.float32)
    return (JBox(lower=jnp.asarray(lower), upper=jnp.asarray(upper)),
            TBox(lower=torch.from_numpy(lower), upper=torch.from_numpy(upper)))


def _solve_both(problem, l2, max_iterations, tolerance, box=None, w0=None):
    loss, _, _, _, tb, cb = problem
    w0 = np.zeros(F, np.float32) if w0 is None else w0
    jo, to = j_make(loss, l2_weight=l2), t_make(loss, l2_weight=l2)
    jcfg = JConfig(max_iterations=max_iterations, tolerance=tolerance)
    tcfg = TConfig(max_iterations=max_iterations, tolerance=tolerance)
    jbox, tbox = box if box is not None else (None, None)
    rj = jax.jit(lambda w: j_tron(j_adapter(jo, tb), w, jcfg, constraints=jbox))(
        jnp.asarray(w0))
    rt = t_tron(t_adapter(to, cb), torch.from_numpy(w0), tcfg, constraints=tbox,
                device="cpu")
    return rj, rt


def _assert_same_solve(rj, rt):
    assert rt.iterations == int(rj.iterations)
    assert rt.reason == int(rj.reason)
    assert rt.data_passes == int(rj.data_passes)
    np.testing.assert_allclose(float(rt.value), float(rj.value), rtol=1e-4)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=1e-2, atol=1e-3)
    k = rt.iterations
    np.testing.assert_allclose(rt.values[: k + 1].numpy(), np.asarray(rj.values)[: k + 1],
                               rtol=1e-4)


@pytest.mark.parametrize("l2", [1.0, 0.1])
def test_margin_carrying_path_matches_reference(problem, l2):
    rj, rt = _solve_both(problem, l2, max_iterations=4, tolerance=0.0)
    _assert_same_solve(rj, rt)
    assert rt.data_passes > rt.iterations + 1  # CG Hessian-vector passes count


def test_converged_solve_matches_reference(problem):
    rj, rt = _solve_both(problem, 1.0, max_iterations=30, tolerance=1e-4)
    _assert_same_solve(rj, rt)
    assert rt.reason != MAX_ITERATIONS


def test_warm_start_matches_reference(problem):
    w0 = np.random.default_rng(5).normal(size=F).astype(np.float32) * 0.3
    rj, rt = _solve_both(problem, 0.5, max_iterations=3, tolerance=0.0, w0=w0)
    _assert_same_solve(rj, rt)


@pytest.mark.parametrize("bound", [0.05, 0.5])
def test_box_constrained_path_matches_reference(problem, bound):
    rj, rt = _solve_both(problem, 1.0, max_iterations=4, tolerance=0.0,
                         box=_box(-bound, bound))
    _assert_same_solve(rj, rt)
    assert float(rt.w.abs().max()) <= bound + 1e-7


def test_tron_matches_ridge_closed_form():
    X, y, wgt = _data("squared", seed=52, n=200, f=15)
    cb = CSRBatch.from_dense(X, y, weights=wgt, device="cpu")
    w_star = np.linalg.solve(X.T @ np.diag(wgt) @ X + 2.0 * np.eye(15), X.T @ (wgt * y))
    res = t_tron(t_adapter(t_make("squared", l2_weight=2.0), cb), torch.zeros(15),
                 device="cpu")
    np.testing.assert_allclose(res.w.numpy(), w_star, rtol=2e-3, atol=2e-3)


def test_tron_refuses_a_loss_without_a_hessian(problem):
    *_, cb = problem
    with pytest.raises(ValueError, match="Hessian-vector"):
        t_tron(t_adapter(t_make("smoothed_hinge"), cb), torch.zeros(F), device="cpu")
