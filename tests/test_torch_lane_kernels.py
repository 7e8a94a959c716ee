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


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,lanes", [(20_000, 300, 1), (20_000, 300, 7), (9_000, 70_000, 9)])
def test_lane_kernels_equal_the_single_kernel_per_lane(cuda, n, f, lanes):
    """Each lane bit for bit the single-vector kernel on its vector: 300
    features stage the lanes' tables, 70,000 gather them from L2; 7 and 9
    lanes take two chunks."""
    rng = np.random.default_rng(5)
    cols = rng.integers(0, f, size=n * 12)
    rows = np.repeat(np.arange(n), 12)
    b = CSRBatch.from_coo(rng.normal(size=n * 12), rows, cols, np.zeros(n), f,
                          offsets=rng.normal(size=n), device=cuda)
    W = torch.from_numpy(rng.normal(size=(lanes, f)).astype(np.float32)).to(cuda)
    R = torch.from_numpy(rng.normal(size=(lanes, n)).astype(np.float32)).to(cuda)
    off = torch.from_numpy(rng.normal(size=(lanes, n)).astype(np.float32)).to(cuda)
    sh = torch.from_numpy(rng.normal(size=lanes).astype(np.float32)).to(cuda)
    Z = kernels.csr_margins_lanes(*b._csr, W, off, sh, True)
    O = kernels.csc_scatter_lanes(*b._csc, R, True, b.tiles)
    for g in range(lanes):
        assert torch.equal(Z[g], kernels.csr_margins(*b._csr, W[g], off[g], sh[g:g + 1], True))
        assert torch.equal(O[g], kernels.csc_scatter(*b._csc, R[g], True, b.tiles))
    plain = reference.csr_margins_lanes(*b._csr, W, off, sh, True)
    assert float((Z - plain).abs().max()) <= 1e-4 * max(1.0, float(plain.abs().max()))
    plain = reference.csc_scatter_lanes(*b.column_major(), R, True)
    assert float((O - plain).abs().max()) <= 1e-4 * max(1.0, float(plain.abs().max()))
