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
                                                "value_grad", "hv", "hv_at", "ell_margins")}


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


# -- the build ---------------------------------------------------------------


def test_build_sources_and_directory():
    names = [os.path.basename(p) for p in build.sources()]
    assert names == ["ell_margins.cu", "hessian_vector.cu", "margins.cu", "margins_pair.cu",
                     "scatter.cu", "value_grad.cu"]
    assert [os.path.basename(p) for p in build.headers()] == ["losses.cuh", "rowpass.cuh"]
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
    args = (csr, csc, b.labels, b.weights, b.offsets, w, torch.tensor(0.1, device=cuda), loss)
    got, again, want = kernels.value_grad(*args), kernels.value_grad(*args), \
        reference.value_grad(*args)
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
    got, again, want = kernels.hv(*args), kernels.hv(*args), reference.hessian_vector(*args)
    for g, a, e, name in zip(got, again, want, ("hv", "q_total")):
        _close(name, g, e)
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,density", FUSED_SHAPES)
def test_hv_at_kernel_matches_plain_and_is_deterministic(cuda, n, f, density):
    _, csr, csc, _, v, d2 = _cuda_fused(cuda, n, f, density)
    shift = torch.tensor(0.3, device=cuda)
    got, again = kernels.hv_at(csr, csc, d2, v, shift), kernels.hv_at(csr, csc, d2, v, shift)
    want = reference.hv_at(csr, csc, d2, v, shift)
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
