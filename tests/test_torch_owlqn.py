"""The port's OWLQN (and ``backtracking``) on CSRBatch against the JAX
``owlqn_solve`` on TiledBatch (Pallas kernels in interpret mode): squared
loss, L1 and elastic net.

Iterations and convergence reason must be equal (the host takes the
reference's orthant and backtracking decisions in the same float32
arithmetic). Against TiledBatch the solves stop within five iterations:
its bf16x2-split gathers move the float32 plateau of a lasso, so beyond it
the last iterations follow rounding. Against the JAX SparseBatch, whose
gathers are exact float32 as the port's are, they run to the plateau.
Final value rtol 1e-4; the zero set of w is the same except
where |w_jax| < 1e-4 (a coordinate that close to zero may land on either
side in float32). KKT as in tests/test_optimizers.py:89-103.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from photon_ml_tpu.ops.objective import make_objective as j_make
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.ops.tiled import TiledBatch
from photon_ml_tpu.optim import LBFGSConfig as JConfig
from photon_ml_tpu.optim import glm_adapter as j_adapter
from photon_ml_tpu.optim import owlqn_solve as j_owlqn
from photon_ml_tpu.optim.linesearch import backtracking as j_backtracking
from photon_ml_tpu.optim.owlqn import pseudo_gradient as j_pseudo
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.objective import make_objective as t_make
from photon_ml_tpu_torch.optim import LBFGSConfig as TConfig
from photon_ml_tpu_torch.optim import glm_adapter as t_adapter
from photon_ml_tpu_torch.optim import owlqn_solve as t_owlqn
from photon_ml_tpu_torch.optim import pseudo_gradient as t_pseudo
from photon_ml_tpu_torch.optim.linesearch import backtracking as t_backtracking

N, F = 240, 20


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(61)
    X = rng.normal(size=(N, F)) * (rng.random((N, F)) < 0.4)
    w_true = rng.normal(size=F) * (rng.random(F) < 0.5)
    y = X @ w_true + 0.1 * rng.normal(size=N)
    wgt = rng.random(N) + 0.5
    ref = {"tiled": TiledBatch.from_dense(X, y, weights=wgt),
           "sparse": JSparse.from_dense(X, y, weights=wgt)}
    return X, y, wgt, ref, CSRBatch.from_dense(X, y, weights=wgt, device="cpu")


def _solve_both(problem, l1, l2, max_iterations, tolerance, ref="tiled"):
    _, _, _, refs, cb = problem
    tb = refs[ref]
    jo, to = j_make("squared", l2_weight=l2), t_make("squared", l2_weight=l2)
    jcfg = JConfig(max_iterations=max_iterations, tolerance=tolerance)
    tcfg = TConfig(max_iterations=max_iterations, tolerance=tolerance)
    w0 = np.zeros(F, np.float32)
    rj = jax.jit(lambda w: j_owlqn(j_adapter(jo, tb), w, jnp.float32(l1), jcfg))(
        jnp.asarray(w0))
    rt = t_owlqn(t_adapter(to, cb), torch.from_numpy(w0), l1, tcfg, device="cpu")
    return rj, rt


def _assert_same_solve(rj, rt):
    assert rt.iterations == int(rj.iterations)
    assert rt.reason == int(rj.reason)
    assert rt.data_passes == int(rj.data_passes) == rt.iterations + 1
    np.testing.assert_allclose(float(rt.value), float(rj.value), rtol=1e-4)
    k = rt.iterations
    np.testing.assert_allclose(rt.values[: k + 1].numpy(), np.asarray(rj.values)[: k + 1],
                               rtol=1e-4)
    wj, wt = np.asarray(rj.w), rt.w.numpy()
    decided = np.abs(wj) >= 1e-4
    np.testing.assert_array_equal(wt[decided] == 0.0, wj[decided] == 0.0)
    assert np.all(np.abs(wt[wj == 0.0]) < 1e-4)
    np.testing.assert_allclose(wt, wj, rtol=1e-2, atol=1e-3)


# (l1, l2): lasso, and elastic net at alpha = 0.5 of lambdas 10 and 40
@pytest.mark.parametrize("ref,max_iterations", [("tiled", 5), ("sparse", 8)])
@pytest.mark.parametrize("l1,l2", [(20.0, 0.0), (5.0, 5.0), (20.0, 20.0)])
def test_fixed_work_matches_reference(problem, l1, l2, ref, max_iterations):
    rj, rt = _solve_both(problem, l1, l2, max_iterations, 0.0, ref)
    _assert_same_solve(rj, rt)
    assert int(np.sum(rt.w.numpy() == 0.0)) > 0  # the L1 term zeroes coordinates


@pytest.mark.parametrize("ref", ["tiled", "sparse"])
def test_converged_solve_matches_reference(problem, ref):
    rj, rt = _solve_both(problem, 5.0, 5.0, 60, 1e-4, ref)
    _assert_same_solve(rj, rt)
    assert rt.iterations < 60


def test_owlqn_lasso_kkt(problem):
    X, y, wgt, _, cb = problem
    obj = t_make("squared")
    ad = t_adapter(obj, cb)
    _, g0 = ad.value_and_grad(torch.zeros(F))
    l1 = float(np.median(np.abs(g0.numpy())))
    res = t_owlqn(ad, torch.zeros(F), l1, device="cpu")
    w = res.w.numpy()
    g = X.T @ (wgt * (X @ w - y))
    # KKT: |g_j| <= l1 where w_j = 0; g_j = -l1*sign(w_j) where w_j != 0
    tol = 5e-2 * max(1.0, np.abs(g).max())
    zero = w == 0.0
    assert np.all(np.abs(g[zero]) <= l1 + tol)
    np.testing.assert_allclose(g[~zero], -l1 * np.sign(w[~zero]), atol=tol)
    assert zero.sum() > 0


def test_pseudo_gradient_matches_reference():
    rng = np.random.default_rng(3)
    w = rng.normal(size=40).astype(np.float32) * (rng.random(40) < 0.5)
    g = rng.normal(size=40).astype(np.float32)
    l1 = np.abs(rng.normal(size=40)).astype(np.float32)
    want = np.asarray(j_pseudo(jnp.asarray(w), jnp.asarray(g), jnp.asarray(l1)))
    got = t_pseudo(torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(l1))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("accept_at,max_evals", [(0, 25), (3, 25), (30, 25), (2, 2)])
def test_backtracking_takes_reference_steps(accept_at, max_evals):
    """The value phi(alpha) = alpha is accepted below a threshold that the
    accept_at-th shrink first reaches; the reference and the port accept the
    same alpha (or both fail)."""
    thresh = np.float32(0.5) ** accept_at * np.float32(1.2)

    def j_value(w):
        return w

    rj = j_backtracking(j_value, jnp.float32(9.0), lambda a, v: v <= thresh,
                        lambda a: a * 1.0, init_step=1.2, max_evals=max_evals)
    rt = t_backtracking(lambda a: (np.float32(a), bool(a <= thresh)), np.float32(9.0),
                        init_step=1.2, max_evals=max_evals)
    assert rt[2] == bool(rj[2])
    assert rt[0] == np.float32(rj[0])
    assert rt[1] == np.float32(rj[1])
