"""The port's bucketed ``DenseBatch`` ([E, R, K], entity axis written out)
against the JAX ``DenseBatch`` and ``GLMObjective`` under ``vmap`` over the
entities: margins, value and gradient, ``dense_hessian`` (with and without
normalization), the margin-space oracle over a vector of step sizes, and
``SparseBatch.dense_rows``.

Tolerance rtol 1e-5: both sides run the same float32 algebra; only the
order of the short sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.dense import DenseBatch as JDense
from photon_ml_tpu.ops.objective import make_objective as j_make
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import glm_adapter as j_adapter
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.ops.objective import make_objective as t_make
from photon_ml_tpu_torch.ops.sparse import SparseBatch
from photon_ml_tpu_torch.optim import glm_adapter as t_adapter

E, R, K = 7, 9, 5
RTOL, ATOL = 1e-5, 1e-5


def _bucket(loss, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, R, K)) * (rng.random((E, R, K)) < 0.8)
    if loss == "squared":
        y = rng.normal(size=(E, R))
    elif loss == "poisson":
        y = rng.poisson(1.5, size=(E, R)).astype(np.float64)
    else:
        y = (rng.random((E, R)) < 0.5).astype(np.float64)
    off = rng.normal(size=(E, R)) * 0.2
    wgt = rng.random((E, R)) + 0.5
    wgt[:, -2:] = 0.0  # padded rows
    w = rng.normal(size=(E, K)) * 0.4
    p = rng.normal(size=(E, K)) * 0.4
    return [a.astype(np.float32) for a in (x, y, off, wgt, w, p)]


def _norm(kind):
    rng = np.random.default_rng(11)
    factors = (rng.random(K) + 0.5).astype(np.float32)
    shifts = rng.normal(size=K).astype(np.float32) * 0.3
    return {"none": (None, None), "factors": (factors, None),
            "factors+shifts": (factors, shifts)}[kind]


def _objectives(loss, l2, kind):
    f, s = _norm(kind)
    jo = j_make(loss, l2_weight=l2, factors=None if f is None else jnp.asarray(f),
                shifts=None if s is None else jnp.asarray(s))
    to = t_make(loss, l2_weight=l2, factors=None if f is None else torch.from_numpy(f),
                shifts=None if s is None else torch.from_numpy(s))
    return jo, to


def _both(loss):
    x, y, off, wgt, w, p = _bucket(loss)
    tb = DenseBatch.from_arrays(x, y, off, wgt, device="cpu")
    jb = JDense(x=jnp.asarray(x), labels=jnp.asarray(y), offsets=jnp.asarray(off),
                weights=jnp.asarray(wgt))
    return jb, tb, w, p


def _vmap(fn, jb, *per_entity):
    return jax.vmap(fn)(jb, *(jnp.asarray(a) for a in per_entity))


def test_margins_dot_rows_and_scatter_match_reference():
    jb, tb, w, p = _both("logistic")
    shift = np.linspace(-0.3, 0.3, E).astype(np.float32)
    want = _vmap(lambda b, ww, s: b.margins(ww, s), jb, w, shift)
    got = tb.margins(torch.from_numpy(w), torch.from_numpy(shift))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tb.dot_rows(torch.from_numpy(w)).numpy(),
                               np.asarray(_vmap(lambda b, ww: b.dot_rows(ww), jb, w)),
                               rtol=RTOL, atol=ATOL)
    per_row = np.asarray(jb.weights) * 0.5
    want_sc = _vmap(lambda b, r: b.scatter_features(r), jb, per_row)
    np.testing.assert_allclose(tb.scatter_features(torch.from_numpy(per_row)).numpy(),
                               np.asarray(want_sc), rtol=RTOL, atol=ATOL)
    z, u = tb.margins_pair(torch.from_numpy(w), 0.1, torch.from_numpy(p), -0.2)
    jz, ju = _vmap(lambda b, ww, pp: b.margins_pair(ww, 0.1, pp, -0.2), jb, w, p)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm", ["none", "factors", "factors+shifts"])
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_value_and_grad_match_reference(loss, norm):
    jb, tb, w, _ = _both(loss)
    jo, to = _objectives(loss, 0.7, norm)
    jf, jg = _vmap(lambda b, ww: jo.value_and_grad(ww, b), jb, w)
    tf, tg = to.value_and_grad(torch.from_numpy(w), tb)
    assert tf.shape == (E,) and tg.shape == (E, K)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)
    jv = _vmap(lambda b, ww: jo.value(ww, b), jb, w)
    np.testing.assert_allclose(to.value(torch.from_numpy(w), tb).numpy(), np.asarray(jv),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm", ["none", "factors", "factors+shifts"])
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_dense_hessian_matches_reference(loss, norm):
    jb, tb, w, _ = _both(loss)
    jo, to = _objectives(loss, 0.3, norm)
    want = _vmap(lambda b, ww: jo.dense_hessian(ww, b), jb, w)
    got = to.dense_hessian(torch.from_numpy(w), tb)
    assert got.shape == (E, K, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("loss", ["logistic", "poisson"])
def test_margin_space_oracle_matches_reference(loss):
    """ls_eval over a vector of step sizes [A] for every entity, against the
    reference's ls_eval vmapped over the step sizes, then over entities."""
    jb, tb, w, p = _both(loss)
    jo, to = _objectives(loss, 0.5, "factors+shifts")
    alphas = (0.5 ** np.arange(6)).astype(np.float32)

    def j_one(b, ww, pp):
        a = j_adapter(jo, b)
        carry = a.ls_prepare(ww, pp)
        return jax.vmap(lambda al: a.ls_eval(carry, al))(jnp.asarray(alphas))

    jphi, jdphi = _vmap(j_one, jb, w, p)
    ta = t_adapter(to, tb)
    phi, dphi = ta.ls_eval(ta.ls_prepare(torch.from_numpy(w), torch.from_numpy(p)),
                           torch.from_numpy(alphas))
    assert phi.shape == (E, len(alphas))
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dphi.numpy(), np.asarray(jdphi), rtol=RTOL, atol=1e-4)


def test_sparse_dense_rows_matches_reference():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(30, 6)) * (rng.random((30, 6)) < 0.4)
    y = np.zeros(30)
    got = SparseBatch.from_dense(X, y, device="cpu").dense_rows()
    want = JSparse.from_dense(X, y).dense_rows()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_adapter_has_a_hessian_and_sparse_layouts_do_not():
    _, tb, _, _ = _both("squared")
    assert t_adapter(t_make("squared"), tb).hessian is not None
    assert t_adapter(t_make("smoothed_hinge"), tb).hessian is None
    sb = SparseBatch.from_dense(np.eye(3), np.zeros(3), device="cpu")
    assert t_adapter(t_make("squared"), sb).hessian is None
