"""The Hopper kernels' wrappers and plain versions.

On the CPU a wrapper runs its kernel's plain PyTorch version, and the plain
versions are held against dense numpy arithmetic here. The tests marked
``cuda`` build the kernels with nvcc and compare each one with its plain
version on the card (the block-diagonal batch of a COO random-effect bucket
among them); they skip where there is no card. This file imports no JAX, so
it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import os

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import kernels
from photon_ml_tpu_torch.kernels import build, reference
from photon_ml_tpu_torch.ops.csr import (SCATTER_PIECE_LEN, SCATTER_TILE_ROWS, CSRBatch,
                                         scatter_tiles, slot_order)
from photon_ml_tpu_torch.ops.ell import ELLBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _coo(seed, n, f, density, empty_rows=(), empty_cols=()):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)) * (rng.random((n, f)) < density)
    X[list(empty_rows)] = 0.0
    X[:, list(empty_cols)] = 0.0
    return rng, X


def _batch(X, device, offsets=None):
    y = np.zeros(X.shape[0])
    return CSRBatch.from_dense(X, y, offsets=offsets, device=device)


# -- the plain versions ------------------------------------------------------


@pytest.mark.parametrize("use_offsets", [False, True])
@pytest.mark.parametrize("shift", [0.0, -0.4])
def test_plain_margins_match_dense(use_offsets, shift):
    rng, X = _coo(1, 70, 23, 0.3, empty_rows=(0, 9, 69))
    off = rng.normal(size=70)
    b = _batch(X, "cpu", offsets=off)
    w = rng.normal(size=23).astype(np.float32)
    z = reference.csr_margins(b.row_ptr, b.cols, b.vals, torch.from_numpy(w), b.offsets,
                              shift, use_offsets)
    want = X @ w + shift + (off if use_offsets else 0.0)
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("square", [False, True])
def test_plain_scatter_matches_dense(square):
    rng, X = _coo(2, 90, 31, 0.2, empty_cols=(0, 30))
    b = _batch(X, "cpu")
    r = rng.normal(size=90).astype(np.float32)
    g = reference.csc_scatter(b.col_ptr, b.csc_rows, b.csc_vals, torch.from_numpy(r), square)
    want = (X * X if square else X).T @ r
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)


def _np_loss(name, z, y):
    """(l, l', l'') of the four losses in float64 numpy."""
    pos = (y > 0.5).astype(np.float64)
    if name == "logistic":
        s = 1.0 / (1.0 + np.exp(-z))
        return np.logaddexp(0.0, z) - pos * z, s - pos, s * (1.0 - s)
    if name == "squared":
        return 0.5 * (z - y) ** 2, z - y, np.ones_like(z)
    if name == "poisson":
        return np.exp(z) - y * z, np.exp(z) - y, np.exp(z)
    ym = 2.0 * pos - 1.0
    u = ym * z
    l = np.where(u <= 0, 0.5 - u, np.where(u < 1, 0.5 * (1 - u) ** 2, 0.0))
    du = np.where(u < 0, -1.0, np.where(u < 1, u - 1.0, 0.0))
    return l, du * ym, ((u > 0) & (u < 1)).astype(np.float64)


def _fused_problem(seed=8, n=120, f=17):
    rng, X = _coo(seed, n, f, 0.3, empty_rows=(0, 7))
    y = rng.integers(0, 3, size=n).astype(np.float64)
    off = rng.normal(size=n) * 0.2
    wgt = rng.random(n) + 0.5
    wgt[::9] = 0.0  # zero-weight rows add nothing
    b = CSRBatch.from_dense(X, y, offsets=off, weights=wgt, device="cpu")
    w, v = (rng.normal(size=f) * 0.3 for _ in range(2))
    return X, y, off, wgt, w, v, b


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_plain_margins_pair_matches_dense():
    X, _, off, _, w, v, b = _fused_problem()
    z, u = reference.margins_pair((b.row_ptr, b.cols, b.vals), _t(w), _t(v), b.offsets,
                                  0.25, torch.tensor(-0.5))
    np.testing.assert_allclose(z.numpy(), X @ w + 0.25 + off, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u.numpy(), X @ v - 0.5, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson", "smoothed_hinge"])
def test_plain_value_grad_matches_dense(loss):
    X, y, off, wgt, w, _, b = _fused_problem()
    val, grad, total = reference.value_grad(
        (b.row_ptr, b.cols, b.vals), (b.col_ptr, b.csc_rows, b.csc_vals), b.labels,
        b.weights, b.offsets, _t(w), 0.1, loss)
    l, dz, _ = _np_loss(loss, X @ w + 0.1 + off, y)
    np.testing.assert_allclose(float(val), np.sum(wgt * l), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), X.T @ (wgt * dz), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(total), np.sum(wgt * dz), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_plain_hessian_vector_matches_dense(loss):
    X, y, off, wgt, w, v, b = _fused_problem()
    hv, total = reference.hessian_vector(
        (b.row_ptr, b.cols, b.vals), (b.col_ptr, b.csc_rows, b.csc_vals), b.labels,
        b.weights, b.offsets, _t(w), -0.1, _t(v), 0.2, loss)
    _, _, d2 = _np_loss(loss, X @ w - 0.1 + off, y)
    q = wgt * d2 * (X @ v + 0.2)
    np.testing.assert_allclose(hv.numpy(), X.T @ q, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(total), np.sum(q), rtol=1e-4, atol=1e-5)


def test_plain_hv_at_matches_dense():
    X, _, _, wgt, _, v, b = _fused_problem()
    hv, total = reference.hv_at((b.row_ptr, b.cols, b.vals),
                                (b.col_ptr, b.csc_rows, b.csc_vals), _t(wgt), _t(v), 0.3)
    q = wgt * (X @ v + 0.3)
    np.testing.assert_allclose(hv.numpy(), X.T @ q, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(total), np.sum(q), rtol=1e-4, atol=1e-5)


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    rng, X = _coo(3, 40, 11, 0.4)
    b = _batch(X, "cpu", offsets=rng.normal(size=40))
    w = torch.from_numpy(rng.normal(size=11).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=11).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    csr, csc = (b.row_ptr, b.cols, b.vals), (b.col_ptr, b.csc_rows, b.csc_vals)
    per_row = (b.labels, b.weights, b.offsets)
    kernels.reset_launch_counts()
    pairs = [
        (kernels.csr_margins(*csr, w, b.offsets, 0.5, True),
         reference.csr_margins(*csr, w, b.offsets, 0.5, True)),
        (kernels.csc_scatter(*csc, r, False), reference.csc_scatter(*csc, r, False)),
        (kernels.margins_pair(csr, w, v, b.offsets, 0.5, -0.2),
         reference.margins_pair(csr, w, v, b.offsets, 0.5, -0.2)),
        (kernels.value_grad(csr, csc, *per_row, w, 0.1, "logistic"),
         reference.value_grad(csr, csc, *per_row, w, 0.1, "logistic")),
        (kernels.hv(csr, csc, *per_row, w, 0.1, v, -0.2, "poisson"),
         reference.hessian_vector(csr, csc, *per_row, w, 0.1, v, -0.2, "poisson")),
        (kernels.hv_at(csr, csc, r.abs(), v, 0.3), reference.hv_at(csr, csc, r.abs(), v, 0.3)),
    ]
    e = ELLBatch.from_csr(b)
    pairs.append((kernels.ell_margins(e.vals, e.cols, w, e.offsets, 0.5, True),
                  reference.ell_margins(e.vals, e.cols, w, e.offsets, 0.5, True)))
    for got, want in pairs:
        for g, e in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, e)
    assert kernels.LAUNCHES == {k: 0 for k in ("csr_margins", "csc_scatter", "margins_pair",
                                                "value_grad", "hv", "hv_at", "ell_margins",
                                                "csr_margins_lanes", "csc_scatter_lanes")}


def test_wrappers_refuse_other_devices():
    t = torch.zeros(2, dtype=torch.int32, device="meta")
    f = torch.zeros(2, device="meta")
    calls = [
        lambda: kernels.csr_margins(t, t, f, f, f, 0.0, False),
        lambda: kernels.csc_scatter(t, t, f, f, False),
        lambda: kernels.margins_pair((t, t, f), f, f, f, 0.0, 0.0),
        lambda: kernels.value_grad((t, t, f), (t, t, f), f, f, f, f, 0.0, "squared"),
        lambda: kernels.hv((t, t, f), (t, t, f), f, f, f, f, 0.0, f, 0.0, "squared"),
        lambda: kernels.hv_at((t, t, f), (t, t, f), f, f, 0.0),
        lambda: kernels.ell_margins(f, t, f, f, 0.0, False),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_hv_refuses_a_loss_without_a_hessian():
    _, X = _coo(4, 20, 6, 0.5)
    b = _batch(X, "cpu")
    w = torch.zeros(6)
    with pytest.raises(ValueError, match="twice differentiable"):
        kernels.hv((b.row_ptr, b.cols, b.vals), (b.col_ptr, b.csc_rows, b.csc_vals),
                   b.labels, b.weights, b.offsets, w, 0.0, w, 0.0, "smoothed_hinge")


@pytest.mark.parametrize("nnz,segments,group", [
    (0, 5, 1), (5, 5, 1), (20, 1, 32), (20_000_000, 1_000_000, 32),
    (20_000_000, 10_000, 32), (6, 2, 4), (100, 10, 16),
])
def test_group_size(nnz, segments, group):
    assert kernels._group_size(nnz, segments) == group


# -- the scatter's (feature, row tile) index ---------------------------------


def _csc_cols(b):
    """The column of each entry of the column-major mirror (``column_major``)."""
    return np.repeat(np.arange(b.num_features), np.diff(b.col_ptr.cpu().numpy()))


def _plain_tiles(rows, cols, n, f, tile_rows, piece_len):
    """scatter_tiles' seven arrays by loops over tiles and features, from COO
    in any order."""
    n_tiles = -(-n // tile_rows)
    csc = np.lexsort((rows, cols))  # the CSC order: columns, then rows
    c_rows, c_cols = rows[csc], cols[csc]
    start, lengths, tile_group, slot_of = [], [], [0], {}
    for t in range(n_tiles):
        for c in range(f):
            at = np.flatnonzero((c_cols == c) & (c_rows // tile_rows == t))
            if len(at):
                slot_of[c, t] = len(start)
                start.append(int(at[0]))
                lengths.append(len(at))
        while len(start) % 32:
            start.append(0)
            lengths.append(0)
        tile_group.append(len(start) // 32)
    off = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    piece_ptr, piece_group = [0], []
    for g in range(len(start) // 32):
        pieces = -(-int(off[32 * g + 32] - off[32 * g]) // piece_len)
        piece_ptr.append(piece_ptr[-1] + pieces)
        piece_group += [g] * pieces
    n_parts, feat_ptr, part_at = 0, [0], [0] * len(start)
    for c in range(f):
        for t in range(n_tiles):
            if (c, t) in slot_of:
                j = slot_of[c, t]
                part_at[j] = n_parts
                g_lo = off[j // 32 * 32]
                n_parts += len({(q - g_lo) // piece_len for q in range(off[j], off[j + 1])})
        feat_ptr.append(n_parts)
    return tuple(np.array(a, np.int64) for a in (start, off, tile_group, piece_ptr, feat_ptr,
                                                 piece_group, part_at))


def _index_problem(n, f, tile_rows, kind, seed=21):
    """COO of one shape: a random ``X`` with an empty column and an empty
    first tile ("dense"), or a wide, sparse one ("wide"), or power-law
    column popularity ("power_law")."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        X = rng.normal(size=(n, f)) * (rng.random((n, f)) < 0.15)
        X[:, 2] = 0.0              # an empty column
        X[: min(n, tile_rows)] = 0.0  # an empty first tile
        rows, cols = np.nonzero(X)
        return rows, cols, X[rows, cols]
    rows = np.repeat(np.arange(n), rng.integers(0, 4, size=n))
    if kind == "wide":
        cols = rng.integers(0, f, size=len(rows))
    else:
        p = 1.0 / np.arange(1, f + 1)
        cols = rng.choice(f, size=len(rows), p=p / p.sum())
    keep = np.unique(rows * f + cols, return_index=True)[1]  # no duplicate entries
    return rows[keep], cols[keep], rng.normal(size=len(keep))


INDEX_SHAPES = [
    (100, 7, 32, 1024, "dense"),   # n not a multiple of the tile
    (96, 5, 32, 3, "dense"),       # n a multiple of the tile; groups split into pieces
    (40, 6, 64, 1024, "dense"),    # one tile larger than n
    (130, 9, 8, 1, "dense"),       # many tiles, most (tile, feature) segments empty
    (200, 70, 64, 7, "dense"),     # three groups of 32 features, the last one short
    (300, 5000, 64, 16, "wide"),   # wide and sparse: segments of one or two entries
    (500, 40, 128, 8, "power_law"),  # hot columns split over pieces
]


@pytest.mark.parametrize("n,f,tile_rows,piece_len,kind", INDEX_SHAPES)
def test_scatter_tiles_match_plain_construction(n, f, tile_rows, piece_len, kind):
    rows, cols, vals = _index_problem(n, f, tile_rows, kind)
    b = CSRBatch.from_coo(vals, rows, cols, np.zeros(n), f, device="cpu")
    col_ptr, csc_rows = b.col_ptr.numpy(), b.csc_rows.numpy()
    got = scatter_tiles(csc_rows, _csc_cols(b), n, f, tile_rows, piece_len)
    for g, want in zip(got, _plain_tiles(rows, cols, n, f, tile_rows, piece_len), strict=True):
        np.testing.assert_array_equal(g, want)
    start, off, tile_group = got[:3]
    lengths = np.diff(off)
    assert off[-1] == len(rows) and len(start) % 32 == 0
    seen = set()
    for t in range(len(tile_group) - 1):  # every entry of a segment: one column, in its tile
        for slot in range(32 * tile_group[t], 32 * tile_group[t + 1]):
            at = np.arange(start[slot], start[slot] + lengths[slot])
            assert np.all(csc_rows[at] // tile_rows == t)
            c = np.searchsorted(col_ptr, at, side="right") - 1
            assert np.all(c == c[:1])
            seen.update(at.tolist())
    assert seen == set(range(len(rows)))  # and the segments cover every entry once


def _scatter_by_index(b, tiles, r, square):
    """The CUDA scatter's arithmetic in float64 numpy, reading the int32
    index as csrc/scatter.cu does: each piece's lane sums over its slice of
    the group's segments, written to their parts, then each feature's run
    of parts summed in order."""
    ix = tiles.index.numpy().astype(np.int64)
    slots, n_pieces, f = tiles.n_slots, tiles.n_pieces, b.num_features
    n_tiles = -(-b.num_rows // tiles.tile_rows)
    start, off = ix[:slots], ix[slots:2 * slots + 1]
    at = 2 * slots + 1
    tile_group = ix[at:at + n_tiles + 1]
    at += n_tiles + 1
    piece_ptr = ix[at:at + slots // 32 + 1]
    at += slots // 32 + 1
    feat_ptr = ix[at:at + f + 1]
    piece_group = ix[at + f + 1:at + f + 1 + n_pieces]
    part_at = ix[at + f + 1 + n_pieces:]
    assert len(part_at) == slots and feat_ptr[-1] == tiles.n_parts
    rows, vals = b.csc_rows.numpy(), b.csc_vals.numpy().astype(np.float64)
    vals = vals * vals if square else vals
    part = np.full(tiles.n_parts, np.nan)
    for t in range(n_tiles):
        for p in range(piece_ptr[tile_group[t]], piece_ptr[tile_group[t + 1]]):
            g = piece_group[p]
            sub, g_lo = p - piece_ptr[g], off[32 * g]
            c0 = g_lo + sub * tiles.piece_len
            c1 = min(c0 + tiles.piece_len, off[32 * g + 32])
            for lane in range(32):
                j = 32 * g + lane
                lo, hi = np.clip(off[j:j + 2], c0, c1)
                if lo < hi:
                    k = np.arange(lo, hi) - off[j] + start[j]
                    assert np.all(rows[k] // tiles.tile_rows == t)
                    q = part_at[j] + sub - (off[j] - g_lo) // tiles.piece_len
                    assert np.isnan(part[q])  # each part written once
                    part[q] = np.sum(vals[k] * r[rows[k]])
    assert not np.isnan(part).any()
    return np.array([part[feat_ptr[c]:feat_ptr[c + 1]].sum() for c in range(f)])


@pytest.mark.parametrize("n,f,tile_rows,piece_len,kind", INDEX_SHAPES)
@pytest.mark.parametrize("square", [False, True])
def test_scatter_through_the_tile_index_matches_dense(n, f, tile_rows, piece_len, kind, square):
    rows, cols, vals = _index_problem(n, f, tile_rows, kind)
    b = CSRBatch.from_coo(vals, rows, cols, np.zeros(n), f, device="cpu").with_tiles(
        tile_rows, piece_len)
    tiles = b.tiles
    r = np.random.default_rng(25).normal(size=n)
    X = np.zeros((n, f))
    X[rows, cols] = vals
    want = (X * X if square else X).T @ r
    np.testing.assert_allclose(_scatter_by_index(b, tiles, r, square), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,f,tile_rows,piece_len,kind", INDEX_SHAPES)
def test_scatter_tiles_size_is_bounded_by_the_nonzeros(n, f, tile_rows, piece_len, kind):
    """Slots: the non-empty segments (at most the nonzeros) plus at most 31
    of padding a tile; pieces: a group's slice of piece_len nonzeros or one
    group, so at most nnz / piece_len + groups; parts: a segment's one, and
    one more where a piece boundary cuts it."""
    rows, cols, vals = _index_problem(n, f, tile_rows, kind)
    b = CSRBatch.from_coo(vals, rows, cols, np.zeros(n), f, device="cpu").with_tiles(
        tile_rows, piece_len)
    n_tiles, nnz, t = -(-n // tile_rows), len(rows), b.tiles
    assert t.n_slots <= nnz + 31 * n_tiles
    assert t.n_pieces <= nnz // piece_len + t.n_slots // 32
    assert t.n_parts <= min(nnz, t.n_slots + t.n_pieces)
    assert t.index.numel() == 3 * t.n_slots + n_tiles + t.n_slots // 32 + t.n_pieces + f + 4


def test_from_coo_builds_the_tile_pointer_where_it_suits():
    """A CPU batch holds no tile index (its plain scatter reads none);
    ``with_tiles`` builds the one a CUDA batch gets from ``from_coo``, for
    the mirror in its slot order (start == off)."""
    rng = np.random.default_rng(22)
    X = rng.normal(size=(300, 6)) * (rng.random((300, 6)) < 0.5)
    b = CSRBatch.from_dense(X, np.zeros(300), device="cpu")
    assert b.tiles is None
    tiled = b.with_tiles()
    tiles = tiled.tiles
    assert (tiles.tile_rows, tiles.piece_len) == (SCATTER_TILE_ROWS, SCATTER_PIECE_LEN)
    assert tiles.index.dtype == torch.int32 and tiles.index.device == b.device
    arrays = scatter_tiles(b.csc_rows.numpy(), _csc_cols(b), 300, 6, SCATTER_TILE_ROWS,
                           SCATTER_PIECE_LEN)
    np.testing.assert_array_equal(tiles.index.numpy(),
                                  np.concatenate([arrays[1][:-1], *arrays[1:]]))
    perm = slot_order(arrays[0], arrays[1])
    np.testing.assert_array_equal(tiled.csc_rows.numpy(), b.csc_rows.numpy()[perm])
    np.testing.assert_array_equal(tiled.csc_vals.numpy(), b.csc_vals.numpy()[perm])
    assert (tiles.n_slots, tiles.n_pieces, tiles.n_parts) == (len(arrays[0]), len(arrays[5]),
                                                               arrays[4][-1])
    wide = _batch(_coo(23, 50, 400, 0.01)[1], "cpu").with_tiles()  # no switch for wide data
    non_empty = int(np.count_nonzero(np.diff(wide.col_ptr.numpy())))  # one tile: a segment each
    assert wide.tiles.n_slots == 32 * -(-non_empty // 32)


def test_scatter_args_check_the_tile_index():
    """The CUDA wrappers' reading of a tile index (exercised here on CPU
    tensors): its counts give the C arguments and the part scratch, and an
    index that does not fit the batch, or none, is refused."""
    _, X = _coo(26, 200, 70, 0.2)
    b = _batch(X, "cpu").with_tiles(64, 16)
    t = b.tiles
    args, part = kernels._scatter_args("csc_scatter", b.device, t, 200, 70)
    assert args == (t.index.data_ptr(), t.n_slots, t.n_pieces,
                    kernels._group_size(t.n_parts, 70), 64, 16)
    assert part.shape == (t.n_parts,) and part.dtype == torch.float32
    for bad in (t._replace(index=t.index[:-1]), t._replace(tile_rows=32), None):
        with pytest.raises(ValueError, match="tile index"):
            kernels._scatter_args("csc_scatter", b.device, bad, 200, 70)


def test_with_offsets_and_moment_sums_carry_the_tile_pointer():
    rng, X = _coo(24, 200, 8, 0.4, empty_cols=(3,))
    b = _batch(X, "cpu").with_tiles(64, 16)
    arrays = scatter_tiles(b.column_major()[1].numpy(), _csc_cols(b), 200, 8, 64, 16)
    assert b.tiles.index.numel() == sum(len(a) for a in arrays)
    moved = b.with_offsets(torch.ones(200))
    assert moved.tiles is b.tiles
    seen = []
    real = kernels.csc_scatter

    def spy(*args, **kw):
        seen.append(args[5] if len(args) > 5 else kw.get("tiles"))
        return real(*args, **kw)

    kernels.csc_scatter = spy
    try:
        sums = moved.feature_moment_sums()
    finally:
        kernels.csc_scatter = real
    assert len(seen) == 3 and all(t is b.tiles for t in seen)
    valid = np.ones(200)
    np.testing.assert_allclose(sums[0].numpy(), X.T @ valid, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sums[2].numpy(), (X != 0).T @ valid, rtol=1e-6)


def test_compare_outputs_tool_saves_and_compares(tmp_path, capsys):
    """tools/compare_outputs.py on CPU tensors at a tiny size: the same
    checkout against itself reads bit-identical on every output."""
    from photon_ml_tpu_torch.tools import compare_outputs

    saved = str(tmp_path / "out.pt")
    small = ["--device", "cpu", "--rows", "300", "--features", "40", "--nnz-per-row", "3"]
    assert compare_outputs.main(small + ["--save", saved]) == 0
    assert compare_outputs.main(small + ["--against", saved]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 21  # margins 1, pair 2, scatter 1, hv_at 2, value_grad 3 x 3, hv 3 x 2
    assert all("max_abs_diff=0 " in line and "bit_identical=True" in line for line in lines)


# -- the build ---------------------------------------------------------------


def test_build_sources_and_directory():
    names = [os.path.basename(p) for p in build.sources()]
    assert names == ["ell_margins.cu", "hessian_vector.cu", "margins.cu", "margins_lanes.cu",
                     "margins_pair.cu", "scatter.cu", "scatter_lanes.cu", "value_grad.cu"]
    assert [os.path.basename(p) for p in build.headers()] == [
        "losses.cuh", "rowpass.cuh", "segments.cuh", "tile_fused.cuh", "tiles.cuh"]
    assert build.BUILD_DIR == os.path.join(REPO, "build", "kernels")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "build/" in fh.read().split()
    assert "arch=compute_90a,code=sm_90a" in build.ARCH_FLAGS


def test_build_digest_follows_the_sources(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("// one")
    d1 = build._digest([str(a)])
    a.write_text("// two")
    assert build._digest([str(a)]) != d1


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,density", [
    (1000, 300, 0.003),   # ~1 nnz/row: lane groups of 1-2
    (2000, 500, 0.02),    # ~10 nnz/row: groups of 16
    (513, 4000, 0.05),    # ~200 nnz/row: full warps, w staged in shared memory
    (700, 30_000, 0.001), # w staged above the 48 KB default
    (300, 60_000, 0.001), # w too large to stage: read through the cache
])
def test_margins_kernel_matches_plain(cuda, n, f, density):
    rng, X = _coo(5, n, f, density, empty_rows=(0, n - 1))
    b = _batch(X, cuda, offsets=rng.normal(size=n))
    w = torch.from_numpy(rng.normal(size=f).astype(np.float32)).to(cuda)
    shift = torch.tensor(0.3, device=cuda)
    before = kernels.LAUNCHES["csr_margins"]
    for sh, use in ((shift, True), (0.0, False), (-1.5, True)):
        got = kernels.csr_margins(b.row_ptr, b.cols, b.vals, w, b.offsets, sh, use)
        again = kernels.csr_margins(b.row_ptr, b.cols, b.vals, w, b.offsets, sh, use)
        want = reference.csr_margins(b.row_ptr, b.cols, b.vals, w, b.offsets, sh, use)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, again)
    assert kernels.LAUNCHES["csr_margins"] == before + 6


@pytest.mark.cuda
def test_kernels_launch_again_after_a_smaller_shared_memory_size(cuda):
    """A kernel's dynamic shared-memory limit belongs to the kernel: a launch
    with a smaller staged table between two larger ones (all above the 48 KB
    default) must not lower it under the larger size's cached launch."""
    rng = np.random.default_rng(14)
    runs = []
    for f in (30_000, 15_000, 30_000):  # w staged: ~136 KB, ~76 KB, ~136 KB
        b, _ = _lengths_batch(rng.integers(0, 30, size=3000), f, cuda)
        w = torch.from_numpy(rng.normal(size=f).astype(np.float32)).to(cuda)
        runs.append((b, w))
    for b, w in runs:
        _twice("margins", lambda: kernels.csr_margins(*b._csr, w, b.offsets, 0.0, False),
               reference.csr_margins(*b._csr, w, b.offsets, 0.0, False))
        _twice("value_grad",
               lambda: kernels.value_grad(b._csr, b._csc, b.labels, b.weights, b.offsets, w,
                                          0.0, "logistic", b.tiles),
               reference.value_grad(b._csr, b.column_major(), b.labels, b.weights, b.offsets,
                                    w, 0.0, "logistic"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,density", [(3000, 200, 0.05), (500, 2000, 0.002)])
@pytest.mark.parametrize("square", [False, True])
def test_scatter_kernel_matches_plain_and_is_deterministic(cuda, n, f, density, square):
    rng, X = _coo(6, n, f, density, empty_cols=(0, f - 1))
    b = _batch(X, cuda)
    r = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    got = kernels.csc_scatter(b.col_ptr, b.csc_rows, b.csc_vals, r, square, b.tiles)
    again = kernels.csc_scatter(b.col_ptr, b.csc_rows, b.csc_vals, r, square, b.tiles)
    want = reference.csc_scatter(*b.column_major(), r, square)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)  # no atomics: bit-identical run to run


@pytest.mark.cuda
def test_cuda_wrappers_check_their_inputs(cuda):
    _, X = _coo(7, 50, 20, 0.2)
    b = _batch(X, cuda)
    w64 = torch.zeros(20, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        kernels.csr_margins(b.row_ptr, b.cols, b.vals, w64, b.offsets, 0.0, False)
    strided = torch.zeros(100, device=cuda)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        kernels.csc_scatter(b.col_ptr, b.csc_rows, b.csc_vals, strided, False)
    with pytest.raises(ValueError):
        kernels.csr_margins(b.row_ptr, b.cols, b.vals, torch.zeros(20), b.offsets, 0.0, False)
    with pytest.raises(ValueError, match="tile index"):
        kernels.csc_scatter(b.col_ptr, b.csc_rows, b.csc_vals, torch.zeros(50, device=cuda),
                            False)


def _close(name, got, want):
    """Kernel vs plain version: max abs error within 1e-4 of the output's scale
    (float32 sums taken in another order)."""
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    scale = max(1.0, float(want.double().abs().max()))
    assert err <= 1e-4 * scale, f"{name}: max abs err {err} at scale {scale}"


def _cuda_fused(cuda, n, f, density, seed=9):
    rng, X = _coo(seed, n, f, density, empty_rows=(0, n - 1), empty_cols=(0,))
    y = rng.integers(0, 3, size=n).astype(np.float64)
    wgt = rng.random(n) + 0.5
    wgt[::11] = 0.0
    b = CSRBatch.from_dense(X, y, offsets=rng.normal(size=n) * 0.2, weights=wgt,
                            device=cuda)
    w, v = (torch.from_numpy(rng.normal(size=f).astype(np.float32) * 0.3).to(cuda)
            for _ in range(2))
    d2 = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    csr, csc = (b.row_ptr, b.cols, b.vals), (b.col_ptr, b.csc_rows, b.csc_vals)
    return b, csr, csc, w, v, d2


def _plain(args, b):
    """Kernel arguments (csr, csc in slot order, ...) made the plain
    version's: the column-major mirror and no tile index."""
    return (args[0], b.column_major(), *args[2:])


# n, f, density: ~1 nnz/row (lane groups of 1-2); ~20 nnz/row (full warps,
# both tables staged); one table staged but not two; no table staged
FUSED_SHAPES = [(1000, 300, 0.003), (2000, 1000, 0.02), (700, 30_000, 0.001),
                (600, 60_000, 0.0005)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,density", FUSED_SHAPES)
def test_margins_pair_kernel_matches_plain(cuda, n, f, density):
    b, csr, _, w, v, _ = _cuda_fused(cuda, n, f, density)
    shift = torch.tensor(0.3, device=cuda)
    before = kernels.LAUNCHES["margins_pair"]
    got = kernels.margins_pair(csr, w, v, b.offsets, shift, -0.7)
    again = kernels.margins_pair(csr, w, v, b.offsets, shift, -0.7)
    want = reference.margins_pair(csr, w, v, b.offsets, shift, -0.7)
    for g, a, e, name in zip(got, again, want, ("z", "u")):
        _close(name, g, e)
        assert torch.equal(g, a)
    assert kernels.LAUNCHES["margins_pair"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,density", FUSED_SHAPES)
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson", "smoothed_hinge"])
def test_value_grad_kernel_matches_plain_and_is_deterministic(cuda, n, f, density, loss):
    b, csr, csc, w, _, _ = _cuda_fused(cuda, n, f, density)
    args = (csr, csc, b.labels, b.weights, b.offsets, w, torch.tensor(0.1, device=cuda), loss,
            b.tiles)
    got, again, want = kernels.value_grad(*args), kernels.value_grad(*args), \
        reference.value_grad(*_plain(args[:-1], b))
    for g, a, e, name in zip(got, again, want, ("value", "grad", "row_total")):
        _close(name, g, e)
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,density", FUSED_SHAPES)
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_hv_kernel_matches_plain_and_is_deterministic(cuda, n, f, density, loss):
    b, csr, csc, w, v, _ = _cuda_fused(cuda, n, f, density)
    args = (csr, csc, b.labels, b.weights, b.offsets, w, -0.1, v,
            torch.tensor(0.2, device=cuda), loss)
    got, again = kernels.hv(*args, b.tiles), kernels.hv(*args, b.tiles)
    want = reference.hessian_vector(*_plain(args, b))
    for g, a, e, name in zip(got, again, want, ("hv", "q_total")):
        _close(name, g, e)
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,density", FUSED_SHAPES)
def test_hv_at_kernel_matches_plain_and_is_deterministic(cuda, n, f, density):
    b, csr, csc, _, v, d2 = _cuda_fused(cuda, n, f, density)
    shift = torch.tensor(0.3, device=cuda)
    got = kernels.hv_at(csr, csc, d2, v, shift, b.tiles)
    again = kernels.hv_at(csr, csc, d2, v, shift, b.tiles)
    want = reference.hv_at(csr, b.column_major(), d2, v, shift)
    for g, a, e, name in zip(got, again, want, ("hv", "q_total")):
        _close(name, g, e)
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_fused_wrappers_check_their_inputs(cuda):
    b, csr, csc, w, v, d2 = _cuda_fused(cuda, 50, 20, 0.2)
    with pytest.raises(ValueError, match="shape"):
        kernels.hv_at(csr, csc, d2[:-1], v, 0.0)
    with pytest.raises(ValueError, match="shape"):
        kernels.value_grad(csr, csc, b.labels, b.weights, b.offsets, w[:-1], 0.0, "squared")
    with pytest.raises(TypeError):
        kernels.hv(csr, csc, b.labels, b.weights, b.offsets, w, 0.0, v.double(), 0.0,
                   "squared")


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,density", [
    (1000, 300, 0.003),    # ~1 nnz a row, skewed lengths
    (2000, 1000, 0.02),    # ~20 nnz a row
    (777, 30_000, 0.001),  # w staged above the 48 KB default; n not a multiple of 128
    (600, 60_000, 0.0005), # w too large to stage: read through the cache
])
def test_ell_margins_kernel_matches_plain_and_is_deterministic(cuda, n, f, density):
    rng = np.random.default_rng(12)
    X = rng.normal(size=(n, f)) * (rng.random((n, f)) < density * 2 * rng.random((n, 1)))
    X[0] = 0.0
    b = ELLBatch.from_csr(_batch(X, cuda, offsets=rng.normal(size=n)))
    assert b.vals.shape[1] % 128 == 0 and b.vals.shape[1] >= n
    w = torch.from_numpy(rng.normal(size=f).astype(np.float32)).to(cuda)
    before = kernels.LAUNCHES["ell_margins"]
    for sh, use in ((torch.tensor(0.3, device=cuda), True), (0.0, False)):
        got = kernels.ell_margins(b.vals, b.cols, w, b.offsets, sh, use)
        again = kernels.ell_margins(b.vals, b.cols, w, b.offsets, sh, use)
        want = reference.ell_margins(b.vals, b.cols, w, b.offsets, sh, use)
        _close("ell_margins", got, want)
        assert torch.equal(got, again)  # one thread per row, fixed order
    assert kernels.LAUNCHES["ell_margins"] == before + 4


@pytest.mark.cuda
def test_ell_wrapper_checks_its_inputs(cuda):
    _, X = _coo(13, 50, 20, 0.2)
    b = ELLBatch.from_csr(_batch(X, cuda))
    with pytest.raises(TypeError):
        kernels.ell_margins(b.vals, b.cols.long(), torch.zeros(20, device=cuda), b.offsets,
                            0.0, False)
    with pytest.raises(ValueError, match="n_pad"):
        kernels.ell_margins(b.vals[:, :64].contiguous(), b.cols[:, :64].contiguous(),
                            torch.zeros(20, device=cuda), b.offsets, 0.0, False)


# -- on the card: the edges of the row pass and the scatter -------------------


def _lengths_batch(lengths, f, device, seed=30, tile_rows=SCATTER_TILE_ROWS, col_p=None,
                   piece_len=SCATTER_PIECE_LEN):
    """A batch with the given row lengths, columns drawn uniformly (or from
    ``col_p``), N(0, 1) values, offsets, labels in {0, 1, 2} and weights."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    n, nnz = len(lengths), int(lengths.sum())
    rows = np.repeat(np.arange(n), lengths)
    cols = rng.choice(f, size=nnz, p=col_p) if col_p is not None else rng.integers(0, f, nnz)
    wgt = rng.random(n) + 0.5
    wgt[::13] = 0.0
    b = CSRBatch.from_coo(rng.normal(size=nnz), rows, cols, rng.integers(0, 3, n).astype(float),
                          f, offsets=rng.normal(size=n) * 0.2, weights=wgt, device=device)
    if (tile_rows, piece_len) != (SCATTER_TILE_ROWS, SCATTER_PIECE_LEN):
        b = b.with_tiles(tile_rows, piece_len)
    return b, rng


def _row_lengths(case, rng):
    if case == "long_row":  # one row far past the staging chunk among short ones
        lengths = np.full(1000, 20)
        lengths[517] = 5000
    elif case == "empty_rows_at_boundaries":  # n not a multiple of 32
        lengths = rng.integers(0, 40, size=1007)
        lengths[[0, 31, 32, 63, 64, 95, 1006]] = 0
    elif case == "skewed":
        lengths = np.minimum(rng.geometric(0.05, size=3001), 600)
    else:  # "all_long": every row past the long-row threshold
        lengths = np.full(70, 300)
    return lengths


def _twice(name, run, want):
    got, again = run(), run()
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (g, a, e) in enumerate(zip(got, again, want, strict=True)):
        _close(f"{name}[{i}]", g, e)
        assert torch.equal(g, a), f"{name}[{i}]: two launches disagree"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long_row", "empty_rows_at_boundaries", "skewed", "all_long"])
@pytest.mark.parametrize("f", [3000, 60_000])  # tables staged; read through the cache
def test_row_pass_edges_match_plain_and_are_deterministic(cuda, case, f):
    b, rng = _lengths_batch(_row_lengths(case, np.random.default_rng(31)), f, cuda)
    w, v = (torch.from_numpy(rng.normal(size=f).astype(np.float32)).to(cuda) for _ in range(2))
    csr, shift = (b.row_ptr, b.cols, b.vals), torch.tensor(0.3, device=cuda)
    _twice("margins", lambda: kernels.csr_margins(*csr, w, b.offsets, shift, True),
           reference.csr_margins(*csr, w, b.offsets, shift, True))
    _twice("dot_rows", lambda: kernels.csr_margins(*csr, w, b.offsets, 0.0, False),
           reference.csr_margins(*csr, w, b.offsets, 0.0, False))
    _twice("pair", lambda: kernels.margins_pair(csr, w, v, b.offsets, shift, -0.7),
           reference.margins_pair(csr, w, v, b.offsets, shift, -0.7))


def _scatter_case(case, cuda):
    """A batch for a scatter edge case, with its tile index."""
    rng = np.random.default_rng(32)
    if case == "several_tiles":
        return _lengths_batch(rng.integers(5, 15, size=5000), 50, cuda, tile_rows=512)[0]
    if case == "empty_segments":  # rows of most columns fall in a few tiles
        b = _lengths_batch(rng.integers(0, 6, size=4000), 300, cuda, tile_rows=256)[0]
        _, rows, vals = (t.cpu().numpy() for t in b.column_major())
        cols = _csc_cols(b)
        keep = (rows < 1000) | (cols % 7 == 0)
        b = CSRBatch.from_coo(vals[keep], rows[keep], cols[keep], np.zeros(4000), 300,
                              device=cuda)
        return b.with_tiles(256, 64)
    if case == "power_law_columns":  # hot columns: long (feature, tile) segments
        p = 1.0 / np.arange(1, 501)
        return _lengths_batch(rng.integers(10, 30, size=20000), 500, cuda, tile_rows=2048,
                              col_p=p / p.sum(), piece_len=256)[0]
    # "wide_sparse": segments of one or two entries, and one hot column
    b, _ = _lengths_batch(rng.integers(0, 3, size=2000), 20_000, cuda)
    rows = np.concatenate([b.column_major()[1].cpu().numpy(),
                           np.arange(2000)[rng.random(2000) < 0.9]])
    cols = np.concatenate([_csc_cols(b), np.full(len(rows) - b.nnz, 7)])
    vals = rng.normal(size=len(rows))
    return CSRBatch.from_coo(vals, rows, cols, np.zeros(2000), 20_000, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["several_tiles", "empty_segments", "power_law_columns",
                                  "wide_sparse"])
@pytest.mark.parametrize("square", [False, True])
def test_scatter_edges_match_plain_and_are_deterministic(cuda, case, square):
    b = _scatter_case(case, cuda)
    csc = (b.col_ptr, b.csc_rows, b.csc_vals)
    r = torch.from_numpy(np.random.default_rng(33).normal(size=b.num_rows)
                         .astype(np.float32)).to(cuda)
    _twice(case, lambda: kernels.csc_scatter(*csc, r, square, b.tiles),
           reference.csc_scatter(*b.column_major(), r, square))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", [512, 8192])
def test_fused_kernels_with_a_long_row(cuda, tile_rows):
    lengths = np.full(2000, 20)
    lengths[1234] = 5000
    b, rng = _lengths_batch(lengths, 1000, cuda, tile_rows=tile_rows)
    w, v = (torch.from_numpy(rng.normal(size=1000).astype(np.float32) * 0.1).to(cuda)
            for _ in range(2))
    d2 = torch.from_numpy(rng.random(2000).astype(np.float32)).to(cuda)
    csr, csc, rows3, tiles = b._csr, b._csc, (b.labels, b.weights, b.offsets), b.tiles
    plain = b.column_major()
    assert tiles.tile_rows == tile_rows
    _twice("value_grad", lambda: kernels.value_grad(csr, csc, *rows3, w, 0.1, "logistic", tiles),
           reference.value_grad(csr, plain, *rows3, w, 0.1, "logistic"))
    _twice("hv", lambda: kernels.hv(csr, csc, *rows3, w, 0.1, v, -0.2, "logistic", tiles),
           reference.hessian_vector(csr, plain, *rows3, w, 0.1, v, -0.2, "logistic"))
    _twice("hv_at", lambda: kernels.hv_at(csr, csc, d2, v, 0.3, tiles),
           reference.hv_at(csr, plain, d2, v, 0.3))


# -- on the card: the tile-fused passes (value_grad, hv_at) -------------------


def _tile_fused_case(case, cuda):
    """(batch, rng) for an edge of the tile-fused kernels."""
    rng = np.random.default_rng(34)
    if case == "long_rows":  # rows over 128 nonzeros, whole warps in phase A
        lengths = rng.integers(5, 30, size=20_000)
        lengths[::997] = 700
        return _lengths_batch(lengths, 3000, cuda)
    if case == "unstaged_table":  # wide F: the tables far past what the L1 holds
        return _lengths_batch(rng.integers(0, 40, size=9000), 60_000, cuda)
    if case == "few_tiles":  # three tiles, the last one partial: fewer than the clusters
        return _lengths_batch(rng.integers(0, 40, size=2 * SCATTER_TILE_ROWS + 1001), 2000,
                              cuda)
    if case == "one_partial_tile":
        return _lengths_batch(rng.integers(0, 40, size=777), 500, cuda)
    if case == "many_tiles":  # more tiles than resident clusters: each cluster walks several
        return _lengths_batch(rng.integers(0, 12, size=60_000), 800, cuda, tile_rows=256)
    # "power_law_columns": hot features, their groups cut into several pieces
    p = 1.0 / np.arange(1, 501)
    return _lengths_batch(rng.integers(10, 30, size=20_000), 500, cuda, tile_rows=2048,
                          col_p=p / p.sum(), piece_len=256)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long_rows", "unstaged_table", "few_tiles",
                                  "one_partial_tile", "many_tiles", "power_law_columns"])
def test_tile_fused_kernels_match_plain_and_are_deterministic(cuda, case):
    """value_grad (four losses), hv (three losses) and hv_at against their
    plain versions on the column-major mirror, and bit-identical across two
    launches; the scatter reads the same slot-ordered mirror."""
    b, rng = _tile_fused_case(case, cuda)
    f = b.num_features
    w, v = (torch.from_numpy(rng.normal(size=f).astype(np.float32) * 0.1).to(cuda)
            for _ in range(2))
    d2 = torch.from_numpy(rng.random(b.num_rows).astype(np.float32)).to(cuda)
    csr, csc, rows3, tiles = b._csr, b._csc, (b.labels, b.weights, b.offsets), b.tiles
    plain, shift = b.column_major(), torch.tensor(0.1, device=cuda)
    before = dict(kernels.LAUNCHES)
    for loss in ("logistic", "squared", "poisson", "smoothed_hinge"):
        _twice(f"value_grad {loss}",
               lambda: kernels.value_grad(csr, csc, *rows3, w, shift, loss, tiles),
               reference.value_grad(csr, plain, *rows3, w, shift, loss))
    _twice("hv_at", lambda: kernels.hv_at(csr, csc, d2, v, -0.3, tiles),
           reference.hv_at(csr, plain, d2, v, -0.3))
    for loss in ("logistic", "squared", "poisson"):
        _twice(f"hv {loss}",
               lambda: kernels.hv(csr, csc, *rows3, w, shift, v, -0.3, loss, tiles),
               reference.hessian_vector(csr, plain, *rows3, w, shift, v, -0.3, loss))
    _twice("csc_scatter", lambda: kernels.csc_scatter(*csc, d2, False, tiles),
           reference.csc_scatter(*plain, d2, False))
    assert kernels.LAUNCHES["value_grad"] == before["value_grad"] + 8
    assert kernels.LAUNCHES["hv"] == before["hv"] + 6
    assert kernels.LAUNCHES["hv_at"] == before["hv_at"] + 2


# -- the block-diagonal batch of a COO random-effect bucket on the card -------


def _coo_bucket(n_ent, n_rows, k, nnz_per_row, seed=41):
    """A COO bucket's host arrays (values, rows, cols, labels, offsets,
    weights): E entities of R rows, the last two padding, each live row
    ``nnz_per_row`` local features of K."""
    rng = np.random.default_rng(seed)
    live = n_rows - 2
    rows = np.broadcast_to(np.repeat(np.arange(live, dtype=np.int32), nnz_per_row),
                           (n_ent, live * nnz_per_row))
    cols = rng.integers(0, k, size=rows.shape).astype(np.int32)
    vals = rng.normal(size=rows.shape).astype(np.float32)
    y = (rng.random((n_ent, n_rows)) < 0.5).astype(np.float32)
    off = (rng.normal(size=(n_ent, n_rows)) * 0.1).astype(np.float32)
    wgt = np.ones((n_ent, n_rows), np.float32)
    wgt[:, live:] = 0.0
    return vals, rows, cols, y, off, wgt


@pytest.mark.cuda
def test_block_diagonal_batch_matches_plain_and_is_deterministic(cuda):
    """The sweeps of a COO bucket at a real bucket's shape (E = 2,667,
    R = 32, K = 512, the smallest COO bucket of config #4's per-user effect
    over its 10K-feature shard) on the card, against the same batch's plain
    versions on the CPU, and bit-identical across two launches."""
    from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch

    n_ent, n_rows, k = 2667, 32, 512
    arrays = _coo_bucket(n_ent, n_rows, k, 20)
    card = BlockDiagonalBatch.from_bucket(*arrays, k, device=cuda)
    host = BlockDiagonalBatch.from_bucket(*arrays, k, device="cpu")
    assert card.csr.tiles is not None and card.csr.num_features == n_ent * k
    rng = np.random.default_rng(42)
    w = torch.from_numpy(rng.normal(size=(n_ent, k)).astype(np.float32) * 0.1)
    r = torch.from_numpy(rng.normal(size=(n_ent, n_rows)).astype(np.float32))
    d2 = torch.from_numpy(rng.random((n_ent, n_rows)).astype(np.float32))
    sweeps = {
        "margins": lambda b, w, r, d2: b.margins(w),
        "scatter": lambda b, w, r, d2: b.scatter_features(r),
        "scatter_sq": lambda b, w, r, d2: b.scatter_features_sq(d2),
        "hv_at": lambda b, w, r, d2: b.fused_hv_at(d2, w, 0.0)[0],
        "value_grad": lambda b, w, r, d2: b.fused_value_grad(w, 0.0, "logistic"),
    }
    before = dict(kernels.LAUNCHES)
    on_card = [t.to(cuda) for t in (w, r, d2)]
    for name, run in sweeps.items():
        want = run(host, w, r, d2)
        want = tuple(t.to(cuda) for t in want) if isinstance(want, tuple) else want.to(cuda)
        _twice(name, lambda: run(card, *on_card), want)
    assert kernels.LAUNCHES["csr_margins"] == before["csr_margins"] + 4
    assert kernels.LAUNCHES["csc_scatter"] == before["csc_scatter"] + 6
    assert kernels.LAUNCHES["hv_at"] == before["hv_at"] + 2
    assert kernels.LAUNCHES["value_grad"] == before["value_grad"]


@pytest.mark.cuda
def test_block_diagonal_batch_past_the_int32_range_is_refused_on_the_card(cuda):
    from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch

    one = np.zeros((2**20, 1), np.float32)  # 2^20 entities x 2^12 features: 2^32 columns
    with pytest.raises(ValueError, match="int32"):
        BlockDiagonalBatch.from_bucket(one, one.astype(np.int32), one.astype(np.int32), one,
                                       one, one, 2**12, device=cuda)
