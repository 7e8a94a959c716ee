"""The port's margin-carrying LBFGS on CSRBatch against the JAX solve on
TiledBatch (Pallas kernels in interpret mode).

Final value rtol 1e-4; w rtol 1e-2, atol 1e-3 (tests/test_tiled.py:123-133).
Under fixed work (tolerance 0) the iteration count and the convergence
reason match exactly: the host-driven strong-Wolfe search takes the same
branches in the same float32 arithmetic as the reference's state machine.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from photon_ml_tpu.ops.objective import make_objective as j_make
from photon_ml_tpu.ops.tiled import TiledBatch
from photon_ml_tpu.optim import BoxConstraints as JBox
from photon_ml_tpu.optim import LBFGSConfig as JConfig
from photon_ml_tpu.optim import glm_adapter as j_adapter
from photon_ml_tpu.optim import lbfgs_solve as j_lbfgs
from photon_ml_tpu.optim.linesearch import strong_wolfe as j_wolfe
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.objective import make_objective as t_make
from photon_ml_tpu_torch.optim import LBFGSConfig as TConfig
from photon_ml_tpu_torch.optim import glm_adapter as t_adapter
from photon_ml_tpu_torch.optim import lbfgs_solve as t_lbfgs
from photon_ml_tpu_torch.optim.common import (
    GRADIENT_CONVERGED,
    MAX_ITERATIONS,
    BoxConstraints,
    convergence_reason,
)
from photon_ml_tpu_torch.optim.linesearch import strong_wolfe as t_wolfe

N, F = 220, 24


def _batches(seed=31, n=N, f=F):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)) * (rng.random((n, f)) < 0.35)
    w_true = rng.normal(size=f)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float64)
    return (TiledBatch.from_dense(X, y),
            CSRBatch.from_dense(X, y, device="cpu"), rng)


@pytest.fixture(scope="module")
def batches():
    return _batches()


def _solve_both(batches, l2, max_iterations, tolerance, w0=None):
    tb, cb, _ = batches
    w0 = np.zeros(F, np.float32) if w0 is None else w0
    jo, to = j_make("logistic", l2_weight=l2), t_make("logistic", l2_weight=l2)
    jcfg = JConfig(max_iterations=max_iterations, tolerance=tolerance)
    tcfg = TConfig(max_iterations=max_iterations, tolerance=tolerance)
    rj = jax.jit(lambda w: j_lbfgs(j_adapter(jo, tb), w, jcfg))(jnp.asarray(w0))
    rt = t_lbfgs(t_adapter(to, cb), torch.from_numpy(w0), tcfg, device="cpu")
    return rj, rt


@pytest.mark.parametrize("l2", [1.0, 0.1])
def test_fixed_work_matches_reference(batches, l2):
    rj, rt = _solve_both(batches, l2, max_iterations=6, tolerance=0.0)
    assert rt.iterations == int(rj.iterations) == 6
    assert rt.reason == int(rj.reason) == MAX_ITERATIONS
    assert rt.data_passes == int(rj.data_passes) == 7
    np.testing.assert_allclose(float(rt.value), float(rj.value), rtol=1e-4)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(rt.values[:7].numpy(), np.asarray(rj.values)[:7], rtol=1e-4)
    assert np.all(np.isinf(rt.values[7:].numpy()))


def test_converged_solve_matches_reference(batches):
    rj, rt = _solve_both(batches, 1.0, max_iterations=50, tolerance=1e-6)
    assert rt.reason == int(rj.reason)
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(float(rt.value), float(rj.value), rtol=1e-4)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=1e-2, atol=1e-3)
    k = rt.iterations
    np.testing.assert_allclose(rt.grad_norms[: k + 1].numpy(),
                               np.asarray(rj.grad_norms)[: k + 1], rtol=1e-2, atol=1e-4)


def test_warm_start_matches_reference(batches):
    w0 = batches[2].normal(size=F).astype(np.float32) * 0.3
    rj, rt = _solve_both(batches, 0.5, max_iterations=4, tolerance=0.0, w0=w0)
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(float(rt.value), float(rj.value), rtol=1e-4)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=1e-2, atol=1e-3)


def test_box_constrained_path_projects(batches):
    _, cb, _ = batches
    to = t_make("logistic", l2_weight=0.1)
    lower = torch.full((F,), -0.05)
    upper = torch.full((F,), 0.05)
    res = t_lbfgs(t_adapter(to, cb), torch.zeros(F), TConfig(max_iterations=10),
                  constraints=BoxConstraints(lower, upper), device="cpu")
    assert float(res.w.abs().max()) <= 0.05 + 1e-7
    assert float(res.values[res.iterations]) < float(res.values[0])


def _poisson_batches(seed=33, n=256, f=F):
    """Poisson with exposure offsets (bench_suite.py config #3's shape)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)) * (rng.random((n, f)) < 0.35)
    off = rng.normal(size=n) * 0.3
    y = rng.poisson(np.exp(np.clip(0.2 * (X @ rng.normal(size=f)) + off, -4, 4)))
    y = y.astype(np.float64)
    return (TiledBatch.from_dense(X, y, offsets=off),
            CSRBatch.from_dense(X, y, offsets=off, device="cpu"))


@pytest.mark.parametrize("loss,bound", [("poisson", 0.5), ("poisson", 0.2), ("logistic", 0.5)])
def test_box_constrained_path_matches_reference(batches, loss, bound):
    """The non-margin-carrying path (fused value-and-gradient per iteration,
    the pair kernel per line search) against the JAX solve in a box."""
    tb, cb = _poisson_batches() if loss == "poisson" else batches[:2]
    lower, upper = np.full(F, -bound, np.float32), np.full(F, bound, np.float32)
    jbox = JBox(lower=jnp.asarray(lower), upper=jnp.asarray(upper))
    tbox = BoxConstraints(torch.from_numpy(lower), torch.from_numpy(upper))
    jo, to = j_make(loss, l2_weight=1.0), t_make(loss, l2_weight=1.0)
    cfg = dict(max_iterations=8, tolerance=0.0)
    rj = jax.jit(lambda w: j_lbfgs(j_adapter(jo, tb), w, JConfig(**cfg), constraints=jbox))(
        jnp.zeros(F, jnp.float32))
    rt = t_lbfgs(t_adapter(to, cb), torch.zeros(F), TConfig(**cfg), constraints=tbox,
                 device="cpu")
    assert rt.iterations == int(rj.iterations)
    assert rt.reason == int(rj.reason)
    assert rt.data_passes == int(rj.data_passes)
    np.testing.assert_allclose(float(rt.value), float(rj.value), rtol=1e-4)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=1e-2, atol=1e-3)
    assert float(rt.w.abs().max()) <= np.float32(bound)
    if loss == "logistic" or bound < 0.5:
        assert float(rt.w.abs().max()) == np.float32(bound)  # the box binds


def test_lbfgs_without_device_raises_on_a_machine_without_a_gpu(batches):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    _, cb, _ = batches
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_lbfgs(t_adapter(t_make("logistic"), cb), torch.zeros(F))


def _quadratic_oracle(a0, curv):
    """phi(a) = curv/2 (a - a0)^2 as a directional oracle in both packages."""

    def j_eval(_, a):
        return 0.5 * curv * (a - a0) ** 2, curv * (a - a0)

    def t_eval(_, a):
        a = torch.tensor(a, dtype=torch.float32)
        return 0.5 * curv * (a - a0) ** 2, curv * (a - a0)

    return j_eval, t_eval


@pytest.mark.parametrize("a0,curv,init", [(0.3, 2.0, 1.0), (5.0, 1.0, 1.0),
                                          (1e-3, 10.0, 1.0), (2.5, 0.5, 0.01)])
def test_strong_wolfe_takes_reference_steps(a0, curv, init):
    j_eval, t_eval = _quadratic_oracle(np.float32(a0), np.float32(curv))
    phi0 = np.float32(0.5 * curv * a0 * a0)
    dphi0 = np.float32(-curv * a0)
    rj = j_wolfe(j_eval, None, jnp.float32(phi0), jnp.float32(dphi0), init_step=init)
    rt = t_wolfe(t_eval, None, phi0, dphi0, init_step=init)
    assert rt.num_evals == int(rj.num_evals)
    assert rt.failed == bool(rj.failed)
    np.testing.assert_allclose(rt.alpha, float(rj.alpha), rtol=1e-5)  # a few float32 ulps


def test_convergence_reason_order():
    f32 = np.float32
    assert convergence_reason(5, f32(1), f32(2), f32(1), f32(10), f32(1), 5, 1e-3, True) == MAX_ITERATIONS
    assert convergence_reason(1, f32(1), f32(2), f32(1e-9), f32(10), f32(1), 5, 1e-3,
                              False) == GRADIENT_CONVERGED
