"""The slot-major ELL layout (``ops/ell.py``) and the plain version of its
margins kernel, against the TPU kernel ``_ell_call`` of
``tools/probe_ell.py`` (Pallas in interpret mode) and against the CSR
layout's margins.

Tolerances: against the Pallas kernel rtol = atol = 1e-4, as
tests/test_tiled.py:46 uses, because that kernel gathers through bf16x2
splits; against ``CSRBatch.dot_rows`` rtol 1e-6 (the same float32 products;
on the CPU both layouts even add a row's terms in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.tiled import LANE
from photon_ml_tpu_torch import kernels
from photon_ml_tpu_torch.kernels import reference
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.ell import ELLBatch
from photon_ml_tpu_torch.tools import probe_ell
from tools.probe_ell import _ell_call

N, D, NNZ = 256, 300, 5


def _probe_arrays(seed=0):
    """tools/probe_ell.py's draws and its lane-aligned [T, S, 128] arrays."""
    vals, rows, cols, y, w = probe_ell.probe_data(seed, N, D, NNZ)
    T, B = -(-N // LANE), -(-D // LANE)
    ell_vals = np.zeros((T, NNZ, LANE), np.float32)
    ell_hi = np.full((T, NNZ, LANE), B, np.int32)
    ell_lo = np.zeros((T, NNZ, LANE), np.int32)
    t_idx, j_idx = rows // LANE, rows % LANE
    s_idx = np.tile(np.arange(NNZ), N)
    ell_vals[t_idx, s_idx, j_idx] = vals
    ell_hi[t_idx, s_idx, j_idx] = cols // LANE
    ell_lo[t_idx, s_idx, j_idx] = cols % LANE
    w2 = np.zeros(B * LANE, np.float32)
    w2[:D] = w
    return (vals, rows, cols, y, w), (ell_vals, ell_hi, ell_lo, w2.reshape(B, LANE), T, B)


def test_plain_ell_margins_match_the_tpu_kernel():
    (vals, rows, cols, y, w), (ev, eh, el, w2, T, B) = _probe_arrays()
    want = np.asarray(_ell_call(T, NNZ, B)(jnp.asarray(ev), jnp.asarray(eh), jnp.asarray(el),
                                            jnp.asarray(w2))).reshape(-1)[:N]
    batch = ELLBatch.from_coo(vals, rows, cols, y, D, device="cpu")
    w_t = torch.from_numpy(w)
    got = reference.ell_margins(batch.vals, batch.cols, w_t, batch.offsets, 0.0, False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(batch.dot_rows(w_t).numpy(), want, rtol=1e-4, atol=1e-4)


def _ragged(seed=4, n=300, f=90):
    """Rows of skewed lengths (0 to ~60), an empty row among them."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.geometric(0.08, size=n) - 1, 60)
    lengths[[0, 17, n - 1]] = [0, 60, 1]
    rows = np.repeat(np.arange(n), lengths)
    cols = np.concatenate([rng.choice(f, size=k, replace=False) for k in lengths])
    vals = rng.normal(size=len(rows))
    return rng, vals, rows, cols, n, f


def test_ell_layout_is_slot_major_and_padded():
    rng, vals, rows, cols, n, f = _ragged()
    b = ELLBatch.from_coo(vals, rows, cols, np.zeros(n), f, device="cpu")
    counts = np.bincount(rows, minlength=n)
    assert b.slots_per_row == counts.max() == 60
    assert b.vals.shape == b.cols.shape == (60, 384)  # n rounded up to 128
    assert b.vals.dtype == torch.float32 and b.cols.dtype == torch.int32
    pad = np.arange(60)[:, None] >= np.concatenate([counts, np.zeros(84, np.int64)])[None, :]
    assert (b.vals.numpy()[pad] == 0).all() and (b.cols.numpy()[pad] == 0).all()
    # each row keeps its nonzeros in order, slot by slot
    r = 17
    np.testing.assert_array_equal(b.cols.numpy()[:, r], cols[rows == r])


def test_ell_dot_rows_and_margins_match_csr():
    rng, vals, rows, cols, n, f = _ragged()
    off = rng.normal(size=n)
    csr = CSRBatch.from_coo(vals, rows, cols, np.zeros(n), f, offsets=off, device="cpu")
    for ell in (ELLBatch.from_coo(vals, rows, cols, np.zeros(n), f, offsets=off, device="cpu"),
                ELLBatch.from_csr(csr)):
        w = torch.from_numpy(rng.normal(size=f).astype(np.float32))
        np.testing.assert_allclose(ell.dot_rows(w).numpy(), csr.dot_rows(w).numpy(),
                                   rtol=1e-6, atol=0)
        shift = torch.tensor(-0.25)
        np.testing.assert_allclose(ell.margins(w, shift).numpy(), csr.margins(w, shift).numpy(),
                                   rtol=1e-6, atol=0)
        assert ell.dot_rows(w)[0] == 0.0  # the empty row


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    _, vals, rows, cols, n, f = _ragged()
    b = ELLBatch.from_coo(vals, rows, cols, np.zeros(n), f, device="cpu")
    w = torch.ones(f)
    kernels.reset_launch_counts()
    got = kernels.ell_margins(b.vals, b.cols, w, b.offsets, 0.5, True)
    assert torch.equal(got, reference.ell_margins(b.vals, b.cols, w, b.offsets, 0.5, True))
    assert kernels.LAUNCHES["ell_margins"] == 0
    t = torch.zeros((1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.ell_margins(t.float(), t, torch.zeros(2, device="meta"),
                            torch.zeros(2, device="meta"), 0.0, False)


def test_probe_runs_on_the_cpu_without_times():
    res = probe_ell.run_probe(n=500, d=64, nnz_per_row=7, device="cpu")
    assert res["max_abs_err"] == 0.0 and res["slots_per_row"] == 7 and res["n_pad"] == 512
    assert res["ell_ms"] is None and res["csr_ms"] is None


def test_probe_draws_follow_the_reference_order():
    """Columns, then values, then labels, then w, from one generator."""
    vals, rows, cols, y, w = probe_ell.probe_data(3, 10, 7, 2)
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(cols, rng.integers(0, 7, size=20))
    np.testing.assert_array_equal(vals, rng.normal(size=20))
    np.testing.assert_array_equal(y, rng.integers(0, 2, size=10).astype(float))
    np.testing.assert_array_equal(w, rng.normal(size=7).astype(np.float32))
    np.testing.assert_array_equal(rows, np.repeat(np.arange(10), 2))
