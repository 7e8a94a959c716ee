"""The port's batches (CSRBatch, torch SparseBatch) against the JAX package's
TiledBatch (Pallas kernels in interpret mode) and padded-COO SparseBatch.

Inputs are numpy arrays from a seed, handed to both packages. Tolerances are
those of tests/test_tiled.py (rtol/atol 1e-4): float32 sums taken in another
order. TiledBatch pads rows to a multiple of 128, so only the first n rows
are compared.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.ops.sparse import validate_coo_indices as j_validate
from photon_ml_tpu.ops.tiled import TiledBatch
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.sparse import SparseBatch as TSparse
from photon_ml_tpu_torch.ops.sparse import validate_coo_indices as t_validate

N, F = 300, 37
TOL = dict(rtol=1e-4, atol=1e-4)
PORT_LAYOUTS = ["csr", "sparse"]


def _problem(seed=3, n=N, f=F, density=0.3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)) * (rng.random((n, f)) < density)
    X[5] = 0.0  # an empty row
    y = (rng.random(n) > 0.5).astype(np.float64)
    off = rng.normal(size=n) * 0.1
    wgt = rng.random(n) + 0.5
    return rng, X, y, off, wgt


@pytest.fixture(scope="module")
def both():
    rng, X, y, off, wgt = _problem()
    ref = {
        "tiled": TiledBatch.from_dense(X, y, offsets=off, weights=wgt),
        "sparse": JSparse.from_dense(X, y, offsets=off, weights=wgt),
    }
    port = {
        "csr": CSRBatch.from_dense(X, y, offsets=off, weights=wgt, device="cpu"),
        "sparse": TSparse.from_dense(X, y, offsets=off, weights=wgt, device="cpu"),
    }
    vecs = {
        "w": rng.normal(size=F).astype(np.float32),
        "p": rng.normal(size=F).astype(np.float32),
        "per_row": rng.normal(size=N).astype(np.float32),
    }
    return ref, port, vecs, X


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rows(ref_name, a, n=N):
    """First n rows of a reference per-row vector (TiledBatch pads to 128)."""
    return np.asarray(a)[:n]


def _per_row_ref(ref_name, per_row, batch):
    if ref_name == "tiled":
        return _j(np.pad(per_row, (0, batch.num_rows - len(per_row))))
    return _j(per_row)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
@pytest.mark.parametrize("ref_name", ["tiled", "sparse"])
def test_margins_with_offsets_and_shift(both, layout, ref_name):
    ref, port, v, _ = both
    want = _rows(ref_name, ref[ref_name].margins(_j(v["w"]), 0.37))
    got = port[layout].margins(_t(v["w"]), 0.37)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a 0-d tensor shift (what the objective passes) gives the same margins
    got_t = port[layout].margins(_t(v["w"]), torch.tensor(0.37))
    np.testing.assert_allclose(got_t.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
@pytest.mark.parametrize("ref_name", ["tiled", "sparse"])
def test_dot_rows(both, layout, ref_name):
    ref, port, v, X = both
    want = _rows(ref_name, ref[ref_name].dot_rows(_j(v["w"])))
    got = port[layout].dot_rows(_t(v["w"]))
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), X @ v["w"], **TOL)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
@pytest.mark.parametrize("ref_name", ["tiled", "sparse"])
@pytest.mark.parametrize("square", [False, True])
def test_scatter_features(both, layout, ref_name, square):
    ref, port, v, _ = both
    rb = ref[ref_name]
    pr = _per_row_ref(ref_name, v["per_row"], rb)
    if square:
        want, got = rb.scatter_features_sq(pr), port[layout].scatter_features_sq(_t(v["per_row"]))
    else:
        want, got = rb.scatter_features(pr), port[layout].scatter_features(_t(v["per_row"]))
    assert got.shape == (F,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
def test_margins_pair(both, layout):
    ref, port, v, _ = both
    zj, uj = ref["tiled"].margins_pair(_j(v["w"]), 0.5, _j(v["p"]), -0.25)
    zt, ut = port[layout].margins_pair(_t(v["w"]), 0.5, _t(v["p"]), -0.25)
    np.testing.assert_allclose(zt.numpy(), _rows("tiled", zj), **TOL)
    np.testing.assert_allclose(ut.numpy(), _rows("tiled", uj), **TOL)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_fused_value_grad(both, layout, loss):
    ref, port, v, _ = both
    w = v["w"] * 0.1
    vj, gj, sj = ref["tiled"].fused_value_grad(_j(w), 0.1, loss)
    vt, gt, st = port[layout].fused_value_grad(_t(w), 0.1, loss)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-4)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
def test_fused_hessian_vector(both, layout):
    ref, port, v, _ = both
    w, p = v["w"] * 0.1, v["p"]
    hj, qj = ref["tiled"].fused_hessian_vector(_j(w), 0.1, _j(p), -0.2, "logistic")
    ht, qt = port[layout].fused_hessian_vector(_t(w), 0.1, _t(p), -0.2, "logistic")
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(qt), float(qj), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
def test_fused_hv_at(both, layout):
    ref, port, v, _ = both
    d2 = np.abs(v["per_row"])
    hj, qj = ref["tiled"].fused_hv_at(
        _per_row_ref("tiled", d2, ref["tiled"]), _j(v["p"]), 0.3)
    ht, qt = port[layout].fused_hv_at(_t(d2), _t(v["p"]), 0.3)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(qt), float(qj), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
def test_feature_moment_sums(both, layout):
    ref, port, _, _ = both
    for a, b in zip(port[layout].feature_moment_sums(), ref["sparse"].feature_moment_sums()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
def test_with_offsets_flows_into_margins(both, layout):
    ref, port, v, _ = both
    new_off = np.linspace(-1.0, 1.0, N).astype(np.float32)
    got = port[layout].with_offsets(_t(new_off)).margins(_t(v["w"]), 0.0)
    want_ref = ref["sparse"].with_offsets(_j(new_off)).margins(_j(v["w"]), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    base = port[layout].dot_rows(_t(v["w"]))
    np.testing.assert_allclose(got.numpy(), base.numpy() + new_off, **TOL)


def test_csr_layout_matches_dense_and_is_column_sorted():
    _, X, y, off, wgt = _problem(seed=9, n=150, f=20)
    b = CSRBatch.from_dense(X, y, offsets=off, weights=wgt, device="cpu")
    np.testing.assert_allclose(b.to_dense(), X.astype(np.float32), rtol=1e-6)
    assert b.num_rows == 150  # no padding to 128-row tiles
    assert b.row_ptr.dtype == b.cols.dtype == b.col_ptr.dtype == torch.int32
    col_ptr = b.col_ptr.numpy()
    rows = b.csc_rows.numpy()
    for f in range(20):
        seg = rows[col_ptr[f]:col_ptr[f + 1]]
        assert np.all(np.diff(seg) > 0)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
def test_unsorted_coo_is_sorted_by_row(layout):
    rng, X, y, _, _ = _problem(seed=5, n=80, f=12)
    rows, cols = np.nonzero(X)
    perm = rng.permutation(len(rows))
    cls = CSRBatch if layout == "csr" else TSparse
    b = cls.from_coo(X[rows, cols][perm], rows[perm], cols[perm], y, 12, device="cpu")
    w = rng.normal(size=12).astype(np.float32)
    np.testing.assert_allclose(b.dot_rows(_t(w)).numpy(), X @ w, **TOL)


BAD_COO = {
    "negative_col": (np.array([0, 1]), np.array([-1, 2])),
    "col_too_large": (np.array([0, 1]), np.array([0, 5])),
    "row_too_large": (np.array([0, 4]), np.array([0, 1])),
    "negative_row": (np.array([-1, 0]), np.array([0, 1])),
}


@pytest.mark.parametrize("case", sorted(BAD_COO))
def test_validate_coo_indices_refuses_what_reference_refuses(case):
    rows, cols = BAD_COO[case]
    with pytest.raises(ValueError) as want:
        j_validate(rows, cols, 4, 5)
    with pytest.raises(ValueError) as got:
        t_validate(rows, cols, 4, 5)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
@pytest.mark.parametrize("case", sorted(BAD_COO))
def test_from_coo_refuses_bad_indices(layout, case):
    rows, cols = BAD_COO[case]
    cls = CSRBatch if layout == "csr" else TSparse
    with pytest.raises(ValueError):
        cls.from_coo(np.ones(2), rows, cols, np.zeros(4), 5, device="cpu")


def test_validate_coo_indices_accepts_in_range_and_empty():
    t_validate(np.array([0, 3]), np.array([0, 4]), 4, 5)
    t_validate(np.array([], np.int64), np.array([], np.int64), 0, 5)
