"""The port's GLMObjective on CSRBatch against the JAX GLMObjective on
TiledBatch (Pallas kernels in interpret mode), with and without
normalization factors/shifts.

Tolerances follow tests/test_tiled.py: values rtol 1e-4; gradients,
Hessian-vector products and diagonals rtol 1e-3, atol 1e-4 (float32 sums in
another order, then the normalization back-transform).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from photon_ml_tpu.ops.objective import make_objective as j_make
from photon_ml_tpu.ops.tiled import TiledBatch
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.objective import make_objective as t_make

N, F = 260, 29
VALUE_TOL = dict(rtol=1e-4)
VEC_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    X = rng.normal(size=(N, F)) * (rng.random((N, F)) < 0.3)
    y = (rng.random(N) > 0.5).astype(np.float64)
    off = rng.normal(size=N) * 0.1
    wgt = rng.random(N) + 0.5
    tb = TiledBatch.from_dense(X, y, offsets=off, weights=wgt)
    cb = CSRBatch.from_dense(X, y, offsets=off, weights=wgt, device="cpu")
    norm = {
        "none": (None, None),
        "factors": (rng.random(F) + 0.5, None),
        "shifts": (None, rng.normal(size=F) * 0.2),
        "both": (rng.random(F) + 0.5, rng.normal(size=F) * 0.2),
    }
    vecs = {"w": rng.normal(size=F) * 0.1, "v": rng.normal(size=F)}
    return tb, cb, norm, vecs


def _objectives(loss, l2, factors, shifts):
    def j(a):
        return None if a is None else jnp.asarray(a, jnp.float32)

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a, np.float32))

    return (j_make(loss, l2_weight=l2, factors=j(factors), shifts=j(shifts)),
            t_make(loss, l2_weight=l2, factors=t(factors), shifts=t(shifts)))


def _vec(a):
    return jnp.asarray(a, jnp.float32), torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("norm", ["none", "factors", "shifts", "both"])
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_value_and_grad(data, norm, loss):
    tb, cb, norms, v = data
    jo, to = _objectives(loss, 0.7, *norms[norm])
    wj, wt = _vec(v["w"])
    fj, gj = jo.value_and_grad(wj, tb)
    ft, gt = to.value_and_grad(wt, cb)
    np.testing.assert_allclose(float(ft), float(fj), **VALUE_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **VEC_TOL)
    np.testing.assert_allclose(float(to.value(wt, cb)), float(fj), **VALUE_TOL)


@pytest.mark.parametrize("norm", ["none", "factors", "shifts", "both"])
def test_value_and_grad_at_margins(data, norm):
    tb, cb, norms, v = data
    jo, to = _objectives("logistic", 0.3, *norms[norm])
    wj, wt = _vec(v["w"])
    zj, zt = jo.margins(wj, tb), to.margins(wt, cb)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj)[:N], rtol=1e-4, atol=1e-4)
    fj, gj = jo.value_and_grad_at_margins(wj, zj, tb)
    ft, gt = to.value_and_grad_at_margins(wt, zt, cb)
    np.testing.assert_allclose(float(ft), float(fj), **VALUE_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **VEC_TOL)
    # the margin-carrying path equals the full sweep
    f_full, g_full = to.value_and_grad(wt, cb)
    np.testing.assert_allclose(float(ft), float(f_full), rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), g_full.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("norm", ["none", "factors", "shifts", "both"])
@pytest.mark.parametrize("loss", ["logistic", "poisson"])
def test_hessian_diagonal(data, norm, loss):
    tb, cb, norms, v = data
    jo, to = _objectives(loss, 0.5, *norms[norm])
    wj, wt = _vec(v["w"])
    np.testing.assert_allclose(
        to.hessian_diagonal(wt, cb).numpy(), np.asarray(jo.hessian_diagonal(wj, tb)),
        **VEC_TOL)


@pytest.mark.parametrize("norm", ["none", "both"])
def test_hessian_vector_and_curvature_path(data, norm):
    tb, cb, norms, v = data
    jo, to = _objectives("logistic", 0.5, *norms[norm])
    wj, wt = _vec(v["w"])
    vj, vt = _vec(v["v"])
    want = np.asarray(jo.hessian_vector(wj, vj, tb))
    np.testing.assert_allclose(to.hessian_vector(wt, vt, cb).numpy(), want, **VEC_TOL)
    d2 = to.curvature_at_margins(to.margins(wt, cb), cb)
    np.testing.assert_allclose(
        to.hessian_vector_with_curvature(d2, vt, cb).numpy(), want, **VEC_TOL)


def test_with_l2_and_make_objective_aliases(data):
    tb, cb, _, v = data
    _, wt = _vec(v["w"])
    base = t_make("logistic_regression")
    assert base.loss_name == "logistic"
    f0 = float(base.value(wt, cb))
    f1 = float(base.with_l2(2.0).value(wt, cb))
    np.testing.assert_allclose(f1 - f0, float(torch.dot(wt, wt)), rtol=1e-4)
    with pytest.raises(ValueError):
        t_make("not_a_loss")


def test_normalization_shift_stays_a_tensor(data):
    """The margin shift is a 0-d tensor, never a host float (no sync)."""
    _, _, norms, v = data
    _, to = _objectives("logistic", 0.0, *norms["both"])
    _, wt = _vec(v["w"])
    _, shift = to._effective(wt)
    assert isinstance(shift, torch.Tensor) and shift.dim() == 0
