"""The Hopper kernels' wrappers and plain versions.

On the CPU a wrapper runs its kernel's plain PyTorch version, and the plain
versions are held against dense numpy arithmetic here. The tests marked
``cuda`` build the kernels with nvcc and compare each one with its plain
version on the card; they skip where there is no card. This file imports no
JAX, so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import os

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import kernels
from photon_ml_tpu_torch.kernels import build, reference
from photon_ml_tpu_torch.ops.csr import CSRBatch

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


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    rng, X = _coo(3, 40, 11, 0.4)
    b = _batch(X, "cpu")
    w = torch.from_numpy(rng.normal(size=11).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    kernels.reset_launch_counts()
    z = kernels.csr_margins(b.row_ptr, b.cols, b.vals, w, b.offsets, 0.5, True)
    g = kernels.csc_scatter(b.col_ptr, b.csc_rows, b.csc_vals, r, False)
    assert torch.equal(z, reference.csr_margins(b.row_ptr, b.cols, b.vals, w, b.offsets,
                                                0.5, True))
    assert torch.equal(g, reference.csc_scatter(b.col_ptr, b.csc_rows, b.csc_vals, r, False))
    assert kernels.LAUNCHES == {"csr_margins": 0, "csc_scatter": 0}


def test_wrappers_refuse_other_devices():
    t = torch.zeros(2, dtype=torch.int32, device="meta")
    f = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.csr_margins(t, t, f, f, f, 0.0, False)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.csc_scatter(t, t, f, f, False)


@pytest.mark.parametrize("nnz,segments,group", [
    (0, 5, 1), (5, 5, 1), (20, 1, 32), (20_000_000, 1_000_000, 32),
    (20_000_000, 10_000, 32), (6, 2, 4), (100, 10, 16),
])
def test_group_size(nnz, segments, group):
    assert kernels._group_size(nnz, segments) == group


# -- the build ---------------------------------------------------------------


def test_build_sources_and_directory():
    names = [os.path.basename(p) for p in build.sources()]
    assert names == ["margins.cu", "scatter.cu"]
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
        want = reference.csr_margins(b.row_ptr, b.cols, b.vals, w, b.offsets, sh, use)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert kernels.LAUNCHES["csr_margins"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,density", [(3000, 200, 0.05), (500, 2000, 0.002)])
@pytest.mark.parametrize("square", [False, True])
def test_scatter_kernel_matches_plain_and_is_deterministic(cuda, n, f, density, square):
    rng, X = _coo(6, n, f, density, empty_cols=(0, f - 1))
    b = _batch(X, cuda)
    r = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    got = kernels.csc_scatter(b.col_ptr, b.csc_rows, b.csc_vals, r, square)
    again = kernels.csc_scatter(b.col_ptr, b.csc_rows, b.csc_vals, r, square)
    want = reference.csc_scatter(b.col_ptr, b.csc_rows, b.csc_vals, r, square)
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
