"""The slot-ordered CSC mirror of a tiled ``CSRBatch`` (``ops/csr.py``).

A batch with a tile index holds its mirror in the index's slot order (tile,
then feature, then row), with ``start == off``, which is the layout the
tile-fused kernels (``csrc/tile_fused.cuh``) stream on the card. Here, on CPU
tensors and numpy: the layout follows from ``scatter_tiles``, its
column-major view round-trips the original arrays, a scatter that walks the
slots in order gives the column-major scatter's sums, ``with_tiles`` reorders
for other tiles, and the CPU wrappers' plain versions read a tiled batch as
they read an untiled one. The fused passes of a tiled batch also match the
JAX package's TiledBatch (Pallas kernels in interpret mode).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from photon_ml_tpu.ops.tiled import TiledBatch
from photon_ml_tpu_torch.ops.csr import CSRBatch, scatter_tiles, slot_order


def _shape(case):
    """(COO rows, cols, vals, n, f, tile_rows, piece_len) of one layout edge."""
    rng = np.random.default_rng(41)
    n, f, tile_rows, piece_len = 1000, 30, 128, 64
    X = rng.normal(size=(n, f)) * (rng.random((n, f)) < 0.1)
    if case == "ragged":  # n not a multiple of the tile: the last tile is partial
        pass
    elif case == "empty_tile":  # no nonzeros in the second tile
        X[tile_rows:2 * tile_rows] = 0.0
    elif case == "empty_feature":
        X[:, [0, 7, f - 1]] = 0.0
    else:  # "hot_feature": feature 3 in every row, its groups cut into pieces
        X[:, 3] = rng.normal(size=n) + 3.0
        piece_len = 16
    rows, cols = np.nonzero(X)
    return rows, cols, X[rows, cols], n, f, tile_rows, piece_len


CASES = ["ragged", "empty_tile", "empty_feature", "hot_feature"]


def _tiled(case):
    rows, cols, vals, n, f, tile_rows, piece_len = _shape(case)
    b = CSRBatch.from_coo(vals, rows, cols, np.zeros(n), f, device="cpu")
    return b, b.with_tiles(tile_rows, piece_len), tile_rows, piece_len


def _cols(b):
    return np.repeat(np.arange(b.num_features), np.diff(b.col_ptr.numpy()))


@pytest.mark.parametrize("case", CASES)
def test_slot_ordered_mirror_and_start_follow_from_scatter_tiles(case):
    b, t, tile_rows, piece_len = _tiled(case)
    arrays = [a.numpy() for a in scatter_tiles(b.csc_rows, torch.from_numpy(_cols(b)),
                                               b.num_rows, b.num_features, tile_rows,
                                               piece_len)]
    start, off, tile_group = arrays[:3]
    perm = slot_order(torch.from_numpy(start), torch.from_numpy(off)).numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(b.nnz))  # a permutation
    np.testing.assert_array_equal(t.csc_rows.numpy(), b.csc_rows.numpy()[perm])
    np.testing.assert_array_equal(t.csc_vals.numpy(), b.csc_vals.numpy()[perm])
    ix, slots = t.tiles.index.numpy(), t.tiles.n_slots
    np.testing.assert_array_equal(ix[:slots], off[:-1])  # start == off
    np.testing.assert_array_equal(ix[slots:], np.concatenate(arrays[1:]))
    # each slot's span of the mirror: one feature, rows ascending, in its tile
    rows, cols = t.csc_rows.numpy(), _cols(b)[perm]
    for tile in range(len(tile_group) - 1):
        for s in range(32 * tile_group[tile], 32 * tile_group[tile + 1]):
            span = slice(off[s], off[s + 1])
            assert np.all(rows[span] // tile_rows == tile)
            assert np.all(np.diff(rows[span]) > 0)
            assert len(set(cols[span].tolist())) <= 1
    n_groups = len(arrays[3]) - 1
    if case == "hot_feature":
        assert t.tiles.n_pieces > n_groups  # the hot feature's groups are cut
    if case == "empty_tile":
        assert tile_group[1] == tile_group[2]  # the empty tile has no groups


@pytest.mark.parametrize("case", CASES)
def test_column_major_view_round_trips_the_mirror(case):
    b, t, _, _ = _tiled(case)
    assert not torch.equal(t.csc_rows, b.csc_rows)  # reordered
    for got, want in zip(t.column_major(), b._csc, strict=True):
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, want)
    assert all(a is c for a, c in zip(b.column_major(), b._csc))  # no index: as it is


@pytest.mark.parametrize("case", CASES)
def test_slot_order_scatter_matches_the_column_major_scatter(case):
    """The tile-fused kernels' phase B in float64 numpy: slots in order, each
    segment a contiguous span of the mirror summed against per_row and added
    to its feature."""
    b, t, tile_rows, piece_len = _tiled(case)
    r = np.random.default_rng(42).normal(size=b.num_rows)
    ix, slots = t.tiles.index.numpy().astype(np.int64), t.tiles.n_slots
    off = ix[slots:2 * slots + 1]
    rows, vals = t.csc_rows.numpy(), t.csc_vals.numpy().astype(np.float64)
    start, csc_off = scatter_tiles(b.csc_rows, torch.from_numpy(_cols(b)), b.num_rows,
                                   b.num_features, tile_rows, piece_len)[:2]
    cols = _cols(b)[slot_order(start, csc_off).numpy()]  # each slot-order entry's feature
    feat = np.zeros(b.num_features)
    for s in range(slots):
        if off[s] < off[s + 1]:
            span = slice(off[s], off[s + 1])
            feat[cols[off[s]]] += np.sum(vals[span] * r[rows[span]])
    want = np.zeros(b.num_features)
    np.add.at(want, _cols(b), b.csc_vals.numpy().astype(np.float64) * r[b.csc_rows.numpy()])
    np.testing.assert_allclose(feat, want, rtol=1e-12, atol=1e-12)


def test_with_tiles_reorders_for_other_tiles():
    b, t, _, _ = _tiled("hot_feature")
    again = t.with_tiles(256, 8)
    direct = b.with_tiles(256, 8)
    assert (again.tiles.tile_rows, again.tiles.piece_len) == (256, 8)
    assert torch.equal(again.tiles.index, direct.tiles.index)
    assert torch.equal(again.csc_rows, direct.csc_rows)
    assert torch.equal(again.csc_vals, direct.csc_vals)
    assert not torch.equal(again.csc_rows, t.csc_rows)
    for got, want in zip(again.column_major(), b._csc, strict=True):
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_cpu_passes_of_a_tiled_batch_match_the_untiled_ones(case):
    """On the CPU the wrappers run the plain versions on the column-major
    view, so a tiled batch gives the untiled batch's results bit for bit."""
    b, t, _, _ = _tiled(case)
    rng = np.random.default_rng(43)
    f = b.num_features
    w, v = (torch.from_numpy(rng.normal(size=f).astype(np.float32)) for _ in range(2))
    r = torch.from_numpy(rng.random(b.num_rows).astype(np.float32))
    pairs = [
        (t.scatter_features(r), b.scatter_features(r)),
        (t.scatter_features_sq(r), b.scatter_features_sq(r)),
        (t.fused_value_grad(w, 0.2, "logistic"), b.fused_value_grad(w, 0.2, "logistic")),
        (t.fused_hessian_vector(w, 0.2, v, -0.1, "poisson"),
         b.fused_hessian_vector(w, 0.2, v, -0.1, "poisson")),
        (t.fused_hv_at(r, v, 0.3), b.fused_hv_at(r, v, 0.3)),
        (t.feature_moment_sums(), b.feature_moment_sums()),
    ]
    for got, want in pairs:
        for g, e in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,), strict=True):
            assert torch.equal(g, e)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def test_tiled_batch_fused_passes_match_the_jax_package():
    """The fused passes of a slot-ordered batch against TiledBatch's Pallas
    kernels (interpret mode), at tests/test_torch_fused.py's tolerances."""
    rows, cols, vals, n, f, tile_rows, piece_len = _shape("hot_feature")
    rng = np.random.default_rng(44)
    X = np.zeros((n, f))
    X[rows, cols] = vals
    y = rng.integers(0, 2, size=n).astype(np.float64)
    off = rng.normal(size=n) * 0.2
    tb = TiledBatch.from_dense(X, y, offsets=off)
    cb = CSRBatch.from_dense(X, y, offsets=off, device="cpu").with_tiles(tile_rows, piece_len)
    w, v = (rng.normal(size=f).astype(np.float32) * 0.1 for _ in range(2))
    vj, gj, rj = tb.fused_value_grad(_j(w), 0.1, "logistic")
    vt, gt, rt = cb.fused_value_grad(torch.from_numpy(w), 0.1, "logistic")
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-4)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-3, atol=1e-4)
    d2 = rng.random(n).astype(np.float32)
    d2_pad = np.zeros(tb.num_rows, np.float32)
    d2_pad[:n] = d2
    hj, qj = tb.fused_hv_at(_j(d2_pad), _j(v), -0.2)
    ht, qt = cb.fused_hv_at(torch.from_numpy(d2), torch.from_numpy(v), -0.2)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(qt), float(qj), rtol=1e-3, atol=1e-4)
