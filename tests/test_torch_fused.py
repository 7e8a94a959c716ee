"""CSRBatch's four fused passes (the plain versions of the pair, value_grad,
hv and hv_at kernels on the CPU) against TiledBatch's Pallas kernels in
interpret mode, on the same seeded inputs: offsets, nonzero shifts (host
floats and 0-d tensors, as the normalized objective passes them) and
zero-weight rows.

Tolerances as in tests/test_tiled.py:53-120: values rtol 1e-4; vectors
rtol 1e-3, atol 1e-4; the margin pair rtol 1e-5, atol 1e-5. TiledBatch pads
rows to a multiple of 128 with weight 0, so only the first n rows of a
per-row output are compared.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from photon_ml_tpu.ops.tiled import TiledBatch
from photon_ml_tpu_torch.ops.csr import CSRBatch

N, F = 260, 33
VEC = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(71)
    X = rng.normal(size=(N, F)) * (rng.random((N, F)) < 0.25)
    X[3] = 0.0  # an empty row
    y = rng.integers(0, 3, size=N).astype(np.float64)  # y > 0.5 counts as positive
    off = rng.normal(size=N) * 0.2
    wgt = rng.random(N) + 0.5
    wgt[::10] = 0.0  # zero-weight rows add nothing
    vecs = [rng.normal(size=F).astype(np.float32) * 0.3 for _ in range(2)]
    d2 = rng.random(N).astype(np.float32) * wgt.astype(np.float32)
    return (TiledBatch.from_dense(X, y, offsets=off, weights=wgt),
            CSRBatch.from_dense(X, y, offsets=off, weights=wgt, device="cpu"), vecs, d2)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


SHIFTS = {"float": lambda s: (s, s), "tensor": lambda s: (_j(s), torch.tensor(s))}


@pytest.mark.parametrize("shift_kind", sorted(SHIFTS))
def test_margins_pair(both, shift_kind):
    tb, cb, (w, p), _ = both
    (sj, st), (pj, pt) = SHIFTS[shift_kind](0.4), SHIFTS[shift_kind](-0.3)
    zj, uj = tb.margins_pair(_j(w), sj, _j(p), pj)
    zt, ut = cb.margins_pair(_t(w), st, _t(p), pt)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj)[:N], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj)[:N], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shift_kind", sorted(SHIFTS))
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson", "smoothed_hinge"])
def test_fused_value_grad(both, loss, shift_kind):
    tb, cb, (w, _), _ = both
    sj, st = SHIFTS[shift_kind](0.15)
    vj, gj, rj = tb.fused_value_grad(_j(w), sj, loss)
    vt, gt, rt = cb.fused_value_grad(_t(w), st, loss)
    assert vt.shape == rt.shape == () and gt.shape == (F,)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-4)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **VEC)
    np.testing.assert_allclose(float(rt), float(rj), **VEC)


@pytest.mark.parametrize("shift_kind", sorted(SHIFTS))
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_fused_hessian_vector(both, loss, shift_kind):
    tb, cb, (w, v), _ = both
    (sj, st), (vsj, vst) = SHIFTS[shift_kind](-0.1), SHIFTS[shift_kind](0.25)
    hj, qj = tb.fused_hessian_vector(_j(w), sj, _j(v), vsj, loss)
    ht, qt = cb.fused_hessian_vector(_t(w), st, _t(v), vst, loss)
    assert qt.shape == () and ht.shape == (F,)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **VEC)
    np.testing.assert_allclose(float(qt), float(qj), **VEC)


@pytest.mark.parametrize("shift_kind", sorted(SHIFTS))
def test_fused_hv_at(both, shift_kind):
    tb, cb, (_, v), d2 = both
    vsj, vst = SHIFTS[shift_kind](0.3)
    d2_padded = np.pad(d2, (0, tb.num_rows - N))
    hj, qj = tb.fused_hv_at(_j(d2_padded), _j(v), vsj)
    ht, qt = cb.fused_hv_at(_t(d2), _t(v), vst)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **VEC)
    np.testing.assert_allclose(float(qt), float(qj), **VEC)


def test_zero_weight_rows_add_nothing(both):
    """Dropping the zero-weight rows leaves every fused sum unchanged."""
    _, cb, (w, v), _ = both
    keep = (cb.weights > 0).numpy()
    X = cb.to_dense()[keep]
    sub = CSRBatch.from_dense(X, cb.labels.numpy()[keep], offsets=cb.offsets.numpy()[keep],
                              weights=cb.weights.numpy()[keep], device="cpu")
    for loss in ("logistic", "poisson"):
        full = cb.fused_value_grad(_t(w), 0.1, loss)
        part = sub.fused_value_grad(_t(w), 0.1, loss)
        for a, b in zip(full, part):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    full = cb.fused_hessian_vector(_t(w), 0.1, _t(v), 0.2, "logistic")
    part = sub.fused_hessian_vector(_t(w), 0.1, _t(v), 0.2, "logistic")
    for a, b in zip(full, part):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
