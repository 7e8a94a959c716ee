"""The lane kernels' wrappers (``kernels.csr_margins_lanes`` and
``kernels.csc_scatter_lanes``), the written-out ``vmap`` of the margins and
scatter kernels over the lanes of a sweep or a bootstrap.

On the CPU each wrapper runs its plain version, which must be bit for bit
the loop of the single plain versions over the lanes; shapes and refusals
are checked here too. The tests marked ``cuda`` build the kernels and hold
each lane of a launch against the single-vector kernel on that lane's
vector, bit for bit, and the launch against its plain version; they skip
where there is no card. No JAX is imported:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lane_kernels.py -q
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import kernels
from photon_ml_tpu_torch.kernels import reference
from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch
from photon_ml_tpu_torch.ops.csr import CSRBatch

G = 5


def _problem(seed, n=300, f=40, density=0.15, device="cpu"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)) * (rng.random((n, f)) < density)
    X[[0, 7]] = 0.0  # empty rows
    X[:, 3] = 0.0  # an empty column
    b = CSRBatch.from_dense(X, np.zeros(n), offsets=rng.normal(size=n), device=device)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)

    return X, b, t(G, f), t(G, n), t(G, n), t(G)


@pytest.mark.parametrize("offsets", ["per_lane", "shared", "none"])
@pytest.mark.parametrize("shift", ["per_lane", "host"])
def test_plain_margins_lanes_are_the_loop_of_single_plain_versions(offsets, shift):
    X, b, W, off, _, sh = _problem(1)
    use = offsets != "none"
    off_arg = off if offsets == "per_lane" else b.offsets
    sh_arg = sh if shift == "per_lane" else -0.25
    Z = kernels.csr_margins_lanes(*b._csr, W, off_arg, sh_arg, use)
    assert Z.shape == (G, b.num_rows)
    for g in range(G):
        want = reference.csr_margins(*b._csr, W[g], off_arg[g] if offsets == "per_lane"
                                     else off_arg, sh[g] if shift == "per_lane" else -0.25, use)
        assert torch.equal(Z[g], want)
    dense = X @ W.numpy().T.astype(np.float64)
    np.testing.assert_allclose(
        Z.numpy(), dense.T + (sh.numpy()[:, None] if shift == "per_lane" else -0.25)
        + (off_arg.numpy() if use else 0.0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_plain_scatter_lanes_are_the_loop_of_single_plain_versions(square, tiled):
    X, b, _, _, R, _ = _problem(2)
    if tiled:  # a mirror in slot order, read through column_major
        b = b.with_tiles(tile_rows=64, piece_len=16)
    out = kernels.csc_scatter_lanes(*b._csc, R, square, b.tiles)
    assert out.shape == (G, b.num_features)
    plain = b.column_major()
    for g in range(G):
        assert torch.equal(out[g], reference.csc_scatter(*plain, R[g], square))
    x = X * X if square else X
    np.testing.assert_allclose(out.numpy(), R.numpy().astype(np.float64) @ x, rtol=1e-5,
                               atol=1e-5)


def test_lane_wrappers_refuse_bad_shapes():
    _, b, W, off, R, sh = _problem(3)
    with pytest.raises(ValueError, match=r"w must be \[G, F\]"):
        kernels.csr_margins_lanes(*b._csr, W[0], b.offsets, 0.0, False)
    with pytest.raises(ValueError, match="offsets must be"):
        kernels.csr_margins_lanes(*b._csr, W, off[:2], 0.0, True)
    with pytest.raises(ValueError, match="shift must be"):
        kernels.csr_margins_lanes(*b._csr, W, b.offsets, sh[:2], True)
    with pytest.raises(ValueError, match=r"per_row must be \[G, N\]"):
        kernels.csc_scatter_lanes(*b._csc, R[0], False, b.tiles)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.csr_margins_lanes(*(t.to("meta") for t in b._csr), W.to("meta"),
                                  b.offsets.to("meta"), 0.0, False)


def test_lane_launch_counts_stay_at_zero_on_the_cpu():
    _, b, W, _, R, _ = _problem(4)
    kernels.reset_launch_counts()
    kernels.csr_margins_lanes(*b._csr, W, b.offsets, 0.0, False)
    kernels.csc_scatter_lanes(*b._csc, R, False, b.tiles)
    assert kernels.LAUNCHES["csr_margins_lanes"] == kernels.LAUNCHES["csc_scatter_lanes"] == 0


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _design(name, cuda):
    """(CSRBatch on the card, rng) for a named design of the card test:
    uniform rows of 12 nonzeros over 300 features (the lanes' tables staged)
    or 70,000 (W gathered from L2); rows of geometric lengths with every
    97th over 128 nonzeros and feature 0 in every other row (long rows, and
    long segments cut into several pieces a row tile); or a COO bucket's
    block-diagonal batch (3,000 entities x 16 rows x 64 features: 192,000
    columns, the L2 regime)."""
    rng = np.random.default_rng(5)
    if name.startswith("uniform"):
        n, f = (9_000, 70_000) if name == "uniform 70000" else (20_000, 300)
        cols = rng.integers(0, f, size=n * 12)
        rows = np.repeat(np.arange(n), 12)
        return CSRBatch.from_coo(rng.normal(size=n * 12), rows, cols, np.zeros(n), f,
                                 offsets=rng.normal(size=n), device=cuda), rng
    if name == "long rows and segments":
        n, f = 20_000, 300
        lengths = np.minimum(rng.geometric(0.05, size=n), 400)
        lengths[::97] = 300
        rows = np.repeat(np.arange(n), lengths)
        cols = rng.integers(1, f, size=len(rows))
        cols[np.r_[0, np.cumsum(lengths)[:-1]][::2]] = 0
        return CSRBatch.from_coo(rng.normal(size=len(rows)), rows, cols, np.zeros(n), f,
                                 offsets=rng.normal(size=n), device=cuda), rng
    e, r, k, nz = 3_000, 16, 64, 40
    block = BlockDiagonalBatch.from_bucket(
        rng.normal(size=(e, nz)), rng.integers(0, r, size=(e, nz)),
        rng.integers(0, k, size=(e, nz)), np.zeros((e, r)), rng.normal(size=(e, r)),
        np.ones((e, r)), k, device=cuda)
    return block.csr, rng


@pytest.mark.cuda
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("offsets", ["per_lane", "shared"])
@pytest.mark.parametrize("design,lanes", [
    ("uniform 300", 1), ("uniform 300", 7), ("uniform 70000", 9), ("uniform 300", 16),
    ("uniform 300", 17), ("long rows and segments", 16), ("block diagonal", 16)])
def test_lane_kernels_equal_the_single_kernel_per_lane(cuda, design, lanes, offsets, square):
    """Each lane bit for bit the single-vector kernel on its vector, and the
    launch within 1e-4 of its plain version: 1, 7 and 9 lanes take part of a
    chunk, 16 a whole one (a cluster of four lane groups) and 17 two; the
    long rows and segments take the warp's tree; 70,000 features and the
    block-diagonal batch gather W from L2. Offsets per lane with per-lane
    shifts, or one shared vector with a host shift."""
    b, rng = _design(design, cuda)
    n, f = b.num_rows, b.num_features
    W = torch.from_numpy(rng.normal(size=(lanes, f)).astype(np.float32)).to(cuda)
    R = torch.from_numpy(rng.normal(size=(lanes, n)).astype(np.float32)).to(cuda)
    if offsets == "per_lane":
        off = torch.from_numpy(rng.normal(size=(lanes, n)).astype(np.float32)).to(cuda)
        sh = torch.from_numpy(rng.normal(size=lanes).astype(np.float32)).to(cuda)
    else:
        off, sh = b.offsets, -0.25
    Z = kernels.csr_margins_lanes(*b._csr, W, off, sh, True)
    O = kernels.csc_scatter_lanes(*b._csc, R, square, b.tiles)
    for g in range(lanes):
        off_g, sh_g = (off[g], sh[g:g + 1]) if offsets == "per_lane" else (off, sh)
        assert torch.equal(Z[g], kernels.csr_margins(*b._csr, W[g], off_g, sh_g, True))
        assert torch.equal(O[g], kernels.csc_scatter(*b._csc, R[g], square, b.tiles))
    assert torch.equal(Z, kernels.csr_margins_lanes(*b._csr, W, off, sh, True))
    assert torch.equal(O, kernels.csc_scatter_lanes(*b._csc, R, square, b.tiles))
    plain = reference.csr_margins_lanes(*b._csr, W, off, sh, True)
    assert float((Z - plain).abs().max()) <= 1e-4 * max(1.0, float(plain.abs().max()))
    plain = reference.csc_scatter_lanes(*b.column_major(), R, square)
    assert float((O - plain).abs().max()) <= 1e-4 * max(1.0, float(plain.abs().max()))
