"""The block-diagonal batch of a COO bucket (``ops/block_diagonal.py``: one
CSR of [E*R x E*K] whose sweeps are the hand-written kernels, here their
plain versions on the CPU) against the JAX package's per-entity padded-COO
``SparseBatch`` under ``vmap``, as ``EntityBucket.entity_batch`` gives it:
margins, scatter (plain and squared), the fused value and gradient, the
Hessian-vector passes, the objective's Hessian diagonal and the dense
designs; then what the batch refuses.

Tolerance rtol 1e-5 / atol 1e-6: both sides run the same float32 products;
the sums over a row or a feature run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.objective import make_objective as j_make
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch
from photon_ml_tpu_torch.ops.objective import make_objective as t_make

E, R, K, NZ = 9, 8, 7, 24
TOL = dict(rtol=1e-5, atol=1e-6)


def _bucket(seed=1):
    """Per-entity padded COO (rows sorted, padding at row R-1 with value 0;
    one entity repeats a (row, feature) pair), per-row arrays and two
    coefficient tables [E, K]."""
    rng = np.random.default_rng(seed)
    vals = np.zeros((E, NZ), np.float32)
    rows = np.full((E, NZ), R - 1, np.int32)
    cols = np.zeros((E, NZ), np.int32)
    for e in range(E):
        n = rng.integers(NZ // 3, NZ + 1)
        rows[e, :n] = np.sort(rng.integers(0, R - 1, size=n))
        cols[e, :n] = rng.integers(0, K, size=n)
        vals[e, :n] = rng.normal(size=n)
    rows[2, 1], cols[2, 1] = rows[2, 0], cols[2, 0]  # a repeated pair
    y = (rng.random((E, R)) < 0.5).astype(np.float32)
    off = (rng.normal(size=(E, R)) * 0.2).astype(np.float32)
    wgt = (rng.random((E, R)) + 0.5).astype(np.float32)
    wgt[:, -1] = 0.0
    w, v = (rng.normal(size=(E, K)).astype(np.float32) * 0.5 for _ in range(2))
    return vals, rows, cols, y, off, wgt, w, v


def _both(seed=1):
    vals, rows, cols, y, off, wgt, w, v = _bucket(seed)
    tb = BlockDiagonalBatch.from_bucket(vals, rows, cols, y, off, wgt, K, device="cpu")
    jb = JSparse(values=jnp.asarray(vals), rows=jnp.asarray(rows), cols=jnp.asarray(cols),
                 labels=jnp.asarray(y), offsets=jnp.asarray(off), weights=jnp.asarray(wgt),
                 num_features=K)
    return tb, jb, w, v


def _vmap(fn, jb, *per_entity):
    return jax.vmap(fn)(jb, *(jnp.asarray(a) for a in per_entity))


def test_layout_keeps_padded_rows_and_drops_padded_nonzeros():
    vals, rows, cols, y, *_ = _bucket()
    tb = _both()[0]
    assert tb.csr.num_rows == E * R and tb.csr.num_features == E * K
    assert tb.csr.nnz == int((vals != 0).sum())
    assert tb.labels.shape == (E, R) and torch.equal(tb.labels, torch.from_numpy(y))


def test_sweeps_match_the_vmapped_reference():
    tb, jb, w, v = _both()
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    per_row = np.random.default_rng(2).normal(size=(E, R)).astype(np.float32)
    tr = torch.from_numpy(per_row)
    pairs = [
        (tb.margins(tw), _vmap(lambda b, x: b.margins(x), jb, w)),
        (tb.dot_rows(tw), _vmap(lambda b, x: b.dot_rows(x), jb, w)),
        (tb.scatter_features(tr), _vmap(lambda b, r: b.scatter_features(r), jb, per_row)),
        (tb.scatter_features_sq(tr), _vmap(lambda b, r: b.scatter_features_sq(r), jb, per_row)),
        (tb.dense_rows(), _vmap(lambda b: b.dense_rows(), jb)),
    ]
    z, u = tb.margins_pair(tw, 0.0, tv, 0.0)
    jz, ju = _vmap(lambda b, x, p: b.margins_pair(x, 0.0, p, 0.0), jb, w, v)
    pairs += [(z, jz), (u, ju)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("loss", ["logistic", "poisson", "squared"])
def test_objective_terms_match_the_vmapped_reference(loss):
    tb, jb, w, v = _both()
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    to, jo = t_make(loss, l2_weight=0.5), j_make(loss, l2_weight=0.5)
    f, g = to.value_and_grad(tw, tb)
    jf, jg = _vmap(lambda b, x: jo.value_and_grad(x, b), jb, w)
    z = to.margins(tw, tb)
    fz, gz = to.value_and_grad_at_margins(tw, z, tb)
    d2 = to.curvature_at_margins(z, tb)
    hv_at = to.hessian_vector_with_curvature(d2, tv, tb)
    hv = to.hessian_vector(tw, tv, tb)
    jhv = _vmap(lambda b, x, p: jo.hessian_vector(x, p, b), jb, w, v)
    diag = to.hessian_diagonal(tw, tb)
    jdiag = _vmap(lambda b, x: jo.hessian_diagonal(x, b), jb, w)
    for got, want in ((f, jf), (g, jg), (fz, jf), (gz, jg), (hv_at, jhv), (hv, jhv),
                      (diag, jdiag)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert f.shape == (E,) and g.shape == (E, K) and hv.shape == (E, K)


def test_residual_offsets_reshape_per_lane():
    tb, jb, w, _ = _both()
    extra = np.random.default_rng(3).normal(size=(E, R)).astype(np.float32)
    moved = tb.with_offsets(tb.offsets + torch.from_numpy(extra))
    want = _vmap(lambda b, x, o: b.with_offsets(b.offsets + o).margins(x), jb, w, extra)
    np.testing.assert_allclose(moved.margins(torch.from_numpy(w)).numpy(), np.asarray(want),
                               **TOL)


def test_a_bucket_past_the_int32_range_is_refused():
    n_ent = 2**20  # 2^20 entities x 2^12 features: 2^32 columns
    one = np.zeros((n_ent, 1), np.float32)
    with pytest.raises(ValueError, match="int32"):
        BlockDiagonalBatch.from_bucket(one, one.astype(np.int32), one.astype(np.int32), one,
                                       one, one, 2**12, device="cpu")


def test_a_shift_and_misshaped_coefficients_are_refused():
    tb, _, w, _ = _both()
    with pytest.raises(ValueError, match="shift"):
        tb.margins(torch.from_numpy(w), torch.zeros(E))
    with pytest.raises(ValueError, match="coefficients"):
        tb.dot_rows(torch.zeros(E * K))
