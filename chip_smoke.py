#!/usr/bin/env python3
"""Drive photon_ml_tpu_torch's GLM and GLMix training paths once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--profile] [--json-out PATH]

Phases, in order; any failure exits non-zero before the last line:

  1. print the card (``nvidia-smi --query-gpu=name,power.limit``);
  2. build the Hopper kernels from ``photon_ml_tpu_torch/csrc`` with nvcc
     (into ``build/kernels/``);
  3. at full width (1M rows x 10K features x 20 nnz/row, bench.py config #1's
     data from ``--seed``; the margins and ELL kernels also on skewed row
     lengths, the scatter also on power-law column lengths, value_grad, hv
     and hv_at on both) hold each kernel against its plain PyTorch version on the
     card (and each kernel against itself: two launches must agree bit for
     bit), and time kernel, plain version and the library yardstick where one
     PyTorch call computes the same function (never used by the port); the
     plain versions read the mirror column-major (``CSRBatch.column_major``),
     the kernels in the tile index's slot order; the lane kernels
     (``csr_margins_lanes``, ``csc_scatter_lanes``) at G = 16 vectors, also
     each lane against the single-vector kernel bit for bit, timed beside 16
     single launches;
  4. train at a reduced size (64K x 2K) on the card and on the CPU (plain
     versions) with LBFGS, TRON, OWLQN and box-constrained Poisson LBFGS:
     same convergence reason and iteration count, final loss within rtol 1e-4;
     and update a per-user random effect (2K users over a 2K-feature sparse
     shard, the wide buckets on the COO layout) on both with LBFGS, OWLQN,
     TRON and NEWTON in a box: per lane the same reason, the value within
     rtol 1e-4, the same iterations but on plateau lanes; then a factored
     coordinate (latent_dim 2, 2 MF iterations) and the random projector
     (projected_dim 16) on the same data, each latent matrix refit with the
     same reason and iterations and its value within rtol 1e-4;
  5. the paths, each at full width through the entry point a user calls,
     with the kernels' launch counts zeroed just before it and read just
     after (a kernel of the path that did not launch fails the run):
       5.  bench.py config #1 through ``train_glm``: logistic, lambdas
           [10, 1], LBFGS 20 iterations at tolerance 0, with variances;
       12. bench_sweep.py on config #1 through ``sweep_glm``: 16 lambdas
           ``np.logspace(2, -4, 16)`` as lanes, LBFGS 20 at tolerance 0,
           cold, timed beside one ``train_glm`` fit (``sweep_over_single_
           ratio``); lanes 0, 8 and 15 against independent fits; then the
           warm-started sweep (2 rounds), no lane above the cold sweep;
       12c. ``bootstrap_random_effect`` at bench_diagnostics.py's bucket
           (4096 entities x 64 rows x 16 features, NEWTON 10), B = 64 against
           the one-lane fit (``bootstrap_overhead_ratio``), the same call on
           512 gathered entities bit for bit the full run's lanes, and
           ``bootstrap_train`` at config #1 with B = 8;
       5b. bench_suite.py config #2: squared, TRON, L2 1, 10 iterations;
       5c. its elastic-net half: OWLQN, l1 = l2 = 0.5, 20 iterations;
       5d. config #3: Poisson with offsets, L2 1, box [-0.5, 0.5], LBFGS 20
           iterations;
       5e. TRON with the box [-0.5, 0.5] on config #2's data, 3 iterations;
       8.  the data plane at config #1's width: its draws (and 100K held-out
           rows drawn next) written as LIBSVM, read by the native parser onto
           the card, validated, summarized twice (bit-identical, and within
           the reference test's tolerances of a float64 numpy summary),
           standardized and trained (logistic, lambdas [10, 1], LBFGS 20),
           the best lambda picked by held-out AUC, saved and loaded (means
           and held-out scores bit-identical);
       6.  bench_game.py config #4 through ``GameEstimator.fit``: a 10K-feature
           fixed effect (LBFGS 20 iterations, L2 1) plus a 10-feature
           per-user random effect over 100K users (batched NEWTON, tolerance
           1e-7), 2 coordinate-descent iterations; the first fit saves its
           models (``output_dir``) and the saved final model, loaded back,
           must score bit for bit as the fitted one; the second of two fits
           is timed, as bench_game.py times it; the fitted model is then
           scored and evaluated twice (``auc``, ``auc:userId``,
           ``precision@5:userId``), and each pair must agree bit for bit;
       9.  config #4's dataset again through ``GameEstimator.fit``: its fixed
           effect, a per-user random effect over the sparse 10K-feature
           shard under the default optimizer type (LBFGS: 10 buckets, the 3
           widest on the COO layout, the block-diagonal batch, whose sweeps
           are the margins, scatter and hv_at kernels), and the dense
           per-user effect under NEWTON in a box with variances; the first
           fit saves (the reloaded model must score bit for bit and keep its
           variances), the second is timed; every lane's objective must not
           rise, the box hold, the variances match a plain recomputation on
           1,000 lanes, the train AUC beat path 6's fixed effect alone, two
           scorings and evaluations agree bit for bit; then the largest COO
           bucket's kernels against their plain versions and ``torch.mv``;
       9b. one update of the sparse per-user effect with TRON (hv_at on the
           COO buckets); 9c. the same with OWLQN (elastic net); 11b. the
           same with the random projector (projected_dim 16, LBFGS 20): no
           lane's objective rises, finite scores, two scorings and the
           saved and reloaded ``factored_random_effect`` bit-identical;
       10. the CLI pipeline at config #4's width: path 6's draws written as
           TrainingExampleAvro (4 files, the native encoder), ``cli index``
           (a subprocess), ``cli train`` in process with path 6's config and
           the default guard (the native decoder must read; the dataset must
           equal path 6's draws, the FE loss per CD iteration path 6's within
           rtol 1e-4, the AUC path 6's within 1e-3; no retry, no rollback;
           the models, index maps and feature statistics written), ``cli
           score`` (a subprocess, on the card by default: its scores read
           back bit for bit as the in-process model's plus offsets, its AUC
           equal), and ``cli glm`` in process on path 8's LIBSVM files,
           bit-identical to path 8's sweep (best lambda, metrics, means);
           ``cli train`` takes a checkpoint key (every step, keep the last
           2: steps 2 and 3 must remain) and prints each fixed-effect
           solve's tracker beside path 6's;
       12d. on path 10's files: ``cli glm`` with ``"diagnostics": true``
           (both reports written, the VALIDATED results bit for bit path
           8's), and ``cli sweep`` on the Avro files (three to train, one to
           validate, ``lambda=1e-2:1e2:log4``), selecting as an in-process
           ``fit_sweep`` on the same datasets;
       12b. config #4 (path 6's draws, every tenth row held out) through
           ``GameEstimator.fit_sweep`` over ``lambda=1e-4:1e2:log16``, 2 CD
           iterations, selected on auc: the saved winner reloads bit for
           bit, its validation AUC within 1e-3 of ``fit`` at its lambda;
           ``fit_grid`` over two fixed effects (L2 1 and 10) best-first,
           each entry bit for bit its combination's ``fit``;
       11. BASELINE config #5 (bench_northstar.py: 20M rows, 138,493 users,
           26,744 movies; a fixed effect on movieFeatures, per-user and
           per-movie NEWTON random effects and the factored ``mf``
           coordinate, latent_dim 2, its kron refit on the margins and
           scatter kernels) through ``GameEstimator.fit`` with 1M
           validation rows: fit A (AUC after each update, the ``mf``
           tracker, the saved model scoring bit for bit), fit B stopped
           after its second update with a checkpoint a step, fit C resumed
           from it and bit-identical to A;
       7.  the ELL probe (``photon_ml_tpu_torch.tools.probe_ell``) at 1M x 10K
           x 20: ELL against CSR ``dot_rows``, both timed;
  6. print the ``kernels`` JSON line, the card again, and the result line
     ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result. ``--profile`` adds a torch.profiler window
over one extra solve of each path and prints its device-busy share.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import tempfile
import time
import warnings

import numpy as np

N_ROWS = 1_000_000
N_FEATURES = 10_000
NNZ_PER_ROW = 20
GAME_USERS = 100_000  # bench_game.py config #4: users, RE features, CD iterations
GAME_RE_FEATURES = 10
GAME_CD_ITERATIONS = 2
N_HELDOUT = 100_000  # path 8's held-out rows, drawn after config #1's
SMALL_ROWS = 65_536
SMALL_FEATURES = 2_048
KERNEL_REL_TOL = 1e-4  # max |kernel - plain| / max(1, max |plain|)
LOSS_RTOL = 1e-4
RE_SMALL_USERS = 2_000  # the small card-vs-CPU random effect
RE_SMALL_ROWS = 20_000
RE_SMALL_FEATURES = 2_048
PLATEAU_RTOL = 1e-5
RE_BOX = ((0, -0.5, 0.5),)  # path 9's per-user box, on global feature 0
VARIANCE_LANES = 1_000
VARIANCE_RTOL = 1e-4
NS_ROWS = 20_000_000  # bench_northstar.py (BASELINE config #5): rows, users, movies
NS_VAL = 1_000_000
NS_USERS = 138_493
NS_MOVIES = 26_744
NS_FE_SPACE = 2_000  # movieFeatures: the id space and the features a movie has
NS_FE_NNZ = 4
NS_CTX = 4  # movieCtx and userCtx dims
PROJECTED_DIM = 16  # path 11b: no wider than the widest buckets' 16-32 rows
SWEEP_LANES = 16  # bench_sweep.py's N_CONFIGS: the lambdas of path 12 and the lane rows
GAME_SWEEP_GRID = "lambda=1e-4:1e2:log16"  # path 12b, cli/sweep.py's documented grid
CLI_SWEEP_GRID = "lambda=1e-2:1e2:log4"  # path 12d
BOOT_ENTITIES, BOOT_ROWS, BOOT_FEATURES = 4096, 64, 16  # bench_diagnostics.py's bucket
BOOT_SAMPLES = 64  # bench_diagnostics.py's NUM_SAMPLES
BOOT_GATHERED = 512  # path 12c's gathered entities
GLM_BOOTSTRAP_SAMPLES = 8  # cli glm's default bootstrap_samples

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def make_problem(seed: int, n_rows: int, n_features: int, nnz_per_row: int):
    """bench.py config #1's data: uniform columns, N(0,1) values, labels drawn
    from a planted logistic model (same draws in the same order)."""
    return draw_problem(np.random.default_rng(seed), n_rows, n_features, nnz_per_row)[:4]


def draw_problem(rng, n_rows: int, n_features: int, nnz_per_row: int, w_true=None):
    """``make_problem``'s draws from ``rng``: (values, rows, cols, y, w_true).
    Given ``w_true`` (the planted model), it is not drawn again, so rows drawn
    next from the same generator come from the same model."""
    nnz = n_rows * nnz_per_row
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, n_features, size=nnz)
    values = rng.normal(size=nnz)
    if w_true is None:
        w_true = rng.normal(size=n_features) * 0.5
    margins = np.bincount(rows, weights=values * w_true[cols], minlength=n_rows)
    y = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    return values, rows, cols, y, w_true


def make_suite_problem(rng, n_rows: int, n_features: int, nnz_per_row: int, kind: str):
    """bench_suite.py's ``_sparse_problem`` (configs #2 and #3): the same draws
    in the same order; "linear" labels are the planted margins plus noise,
    "poisson" labels are counts with exposure offsets."""
    nnz = n_rows * nnz_per_row
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, n_features, size=nnz)
    values = rng.normal(size=nnz)
    w_true = rng.normal(size=n_features) * 0.5
    margins = np.bincount(rows, weights=values * w_true[cols], minlength=n_rows)
    if kind == "linear":
        return values, rows, cols, margins + 0.1 * rng.normal(size=n_rows), None
    offsets = rng.normal(size=n_rows) * 0.3
    y = rng.poisson(np.exp(np.clip(0.2 * margins + offsets, -4, 4))).astype(np.float64)
    return values, rows, cols, y, offsets


def skewed_rows(seed: int):
    """COO of 100K rows with geometric lengths (mean ~20, capped at 256), as
    click data has: (values, rows, cols, n_rows)."""
    rng = np.random.default_rng(seed + 2)
    lengths = np.minimum(rng.geometric(0.05, size=N_ROWS // 10), 256)
    rows = np.repeat(np.arange(len(lengths)), lengths)
    return (rng.normal(size=len(rows)), rows, rng.integers(0, N_FEATURES, size=len(rows)),
            len(lengths))


def power_law_columns(seed: int, nnz: int) -> np.ndarray:
    """``nnz`` column ids over N_FEATURES drawn Zipf-like (probability of the
    k-th feature ~ 1/k), as feature frequencies in click data are."""
    p = 1.0 / np.arange(1, N_FEATURES + 1)
    return np.random.default_rng(seed + 3).choice(N_FEATURES, size=nnz, p=p / p.sum())


def device_ms(fn, reps: int = 30) -> float:
    """Median device time of one call, by CUDA events (the probe's timer)."""
    from photon_ml_tpu_torch.tools.probe_ell import device_ms as timed

    return timed(fn, reps)


def compare(name: str, got, want) -> tuple[float, float]:
    got = got.double()
    want = want.double()
    if got.shape != want.shape or not bool(got.isfinite().all()):
        raise RuntimeError(f"{name}: bad output shape {tuple(got.shape)} or non-finite values")
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(1.0, float(want.abs().max()))
    print(f"check {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
          f"limit={KERNEL_REL_TOL:.0e}", flush=True)
    if not rel_err <= KERNEL_REL_TOL:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return abs_err, rel_err


def library_ms(make_matrix, op) -> float | None:
    """Time of one PyTorch sparse call ``op(matrix)`` (the yardstick; unused by
    the port). None when this build of torch cannot run it."""
    import torch

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "sparse CSR is in beta"
            mat = make_matrix()
            op(mat)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"library yardstick unavailable: {exc}", flush=True)
        return None
    return device_ms(lambda: op(mat))


def kernel_row(name, source, replaces, worst, timed, label, nbytes, flops,
               lib_ms, **extra) -> dict:
    """One row of the ``kernels`` line: times measured here, bound computed
    from this run's shapes (bytes over HBM rate vs flops over f32 peak)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": 0,
        "max_abs_err": worst,
        "ms": timed[label][0],
        "plain_ms": timed[label][1],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "timed_variant": label,
        "variants_ms": {k: v[0] for k, v in timed.items()},
        **extra,
    }


def run_variants(name: str, cases) -> tuple[float, dict]:
    """Hold each variant's kernel against its plain version and against a
    second launch bit for bit, then time both.
    Returns (worst abs error, {label: (kernel ms, plain ms)})."""
    import torch

    worst, timed = 0.0, {}
    for label, run_kernel, run_plain in cases:
        got, want, again = run_kernel(), run_plain(), run_kernel()
        if not isinstance(got, tuple):
            got, want, again = (got,), (want,), (again,)
        for i, (g, a, e) in enumerate(zip(got, again, want, strict=True)):
            abs_err, _ = compare(f"{name}[{label}][{i}]", g, e)
            worst = max(worst, abs_err)
            if not torch.equal(g, a):
                raise RuntimeError(f"{name}[{label}][{i}]: two launches disagree")
        timed[label] = (device_ms(run_kernel), device_ms(run_plain))
        print(f"time {name}[{label}]: kernel_ms={timed[label][0]:.4f} "
              f"plain_ms={timed[label][1]:.4f}", flush=True)
    return worst, timed


def check_kernels(batch, w, per_row, d2_row, skewed, power_law) -> list[dict]:
    """Phase 3, the margins and scatter kernels: every variant of the path
    against its plain version and against a second launch, bit for bit;
    margins also on ``skewed`` rows, the scatter also on ``power_law``
    columns."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference

    n, f, nnz = batch.num_rows, batch.num_features, batch.nnz
    shift = torch.tensor(0.25, dtype=torch.float32, device=w.device)
    b_csr, plain_csc = batch._csr, batch.column_major()
    plain_power = power_law.column_major()

    def scatter(label, b, plain, r, square):
        return (label, lambda: kernels.csc_scatter(*b._csc, r, square, b.tiles),
                lambda: reference.csc_scatter(*plain, r, square))

    variants = {
        "csr_margins": [
            ("margins+offsets+shift", lambda: kernels.csr_margins(*b_csr, w, batch.offsets, shift, True),
             lambda: reference.csr_margins(*b_csr, w, batch.offsets, shift, True)),
            ("dot_rows", lambda: kernels.csr_margins(*b_csr, w, batch.offsets, 0.0, False),
             lambda: reference.csr_margins(*b_csr, w, batch.offsets, 0.0, False)),
            ("skewed dot_rows",
             lambda: kernels.csr_margins(*skewed._csr, w, skewed.offsets, 0.0, False),
             lambda: reference.csr_margins(*skewed._csr, w, skewed.offsets, 0.0, False)),
        ],
        "csc_scatter": [
            scatter("scatter", batch, plain_csc, per_row, False),
            scatter("scatter_sq", batch, plain_csc, d2_row, True),
            scatter("power-law scatter", power_law, plain_power, per_row, False),
        ],
    }
    # bytes each function must move (inputs read once, output written once)
    # and its flops; the timed variant of each kernel is the one the LBFGS
    # iteration launches (dot_rows for the gather, the plain scatter)
    margin_bytes = 4 * ((n + 1) + 2 * nnz + f + n)
    scatter_bytes = 4 * ((f + 1) + 2 * nnz + n + f)
    specs = {
        "csr_margins": ("photon_ml_tpu_torch/csrc/margins.cu", "photon_ml_tpu/ops/tiled.py:170",
                        "dot_rows", margin_bytes, 2 * nnz,
                        library_ms(lambda: torch.sparse_csr_tensor(
                            *b_csr, size=(n, f), check_invariants=False),
                            lambda m: torch.mv(m, w))),
        "csc_scatter": ("photon_ml_tpu_torch/csrc/scatter.cu", "photon_ml_tpu/ops/tiled.py:199",
                        "scatter", scatter_bytes, 2 * nnz,
                        library_ms(lambda: torch.sparse_csr_tensor(
                            *plain_csc, size=(f, n), check_invariants=False),
                            lambda m: torch.mv(m, per_row))),
    }
    for label, b in (("config #1", batch), ("power-law", power_law)):
        t = b.tiles
        print(f"scatter tiles, {label}: tile_rows={t.tile_rows} piece_len={t.piece_len} "
              f"slots={t.n_slots} pieces={t.n_pieces} index_bytes={4 * t.index.numel()} "
              f"part_bytes={4 * 32 * t.n_pieces} longest column "
              f"{int(torch.diff(b.col_ptr).max())} nnz", flush=True)
    rows = []
    for name, cases in variants.items():
        worst, timed = run_variants(name, cases)
        src, replaces, label, nbytes, flops, lib = specs[name]
        rows.append(kernel_row(name, src, replaces, worst, timed, label, nbytes, flops, lib))
    return rows


def launches_per_call(fn, want: int, attempts: int = 3) -> int | None:
    """Kernel launches of one call of ``fn``, counted by torch.profiler. A
    trace can lose device events (two traces on the card read 0 and 1 of a
    call's 2 launches), never add them, so a count under ``want`` is taken
    again, up to ``attempts`` traces, and the largest count is returned
    (None when no trace saw device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not ev.name.startswith(("Memcpy", "Memset"))]
        if kernels:
            best = max(best or 0, len(kernels))
        if best is not None and best >= want:
            break
    return best


def check_fused_kernels(batch, w, v, d2_row, skewed, power_law) -> list[dict]:
    """Phase 3, the fused kernels: the variants the paths run (pair with
    offsets and both shifts; value_grad and hv for squared, Poisson and
    logistic; hv_at), value_grad, hv and hv_at also on the ``skewed`` rows
    and the ``power_law`` columns, each against its plain version and
    against a second launch, bit for bit. A tile-fused pass (value_grad, hv,
    hv_at) must make two launches a call, the pair one."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference

    n, f, nnz = batch.num_rows, batch.num_features, batch.nnz
    csr, csc, tiles = batch._csr, batch._csc, batch.tiles
    plain_csc = batch.column_major()
    rows3 = batch.labels, batch.weights, batch.offsets
    shift = torch.tensor(0.25, dtype=torch.float32, device=w.device)  # a 0-d device shift
    v_shift = -0.5  # and a host one

    def vg(loss, b=batch, plain=plain_csc, label=None):
        args = b._csr, b._csc, b.labels, b.weights, b.offsets, w, shift, loss
        return (label or loss, lambda: kernels.value_grad(*args, b.tiles),
                lambda: reference.value_grad(args[0], plain, *args[2:]))

    def hv(loss, b=batch, plain=plain_csc, label=None):
        args = b._csr, b._csc, b.labels, b.weights, b.offsets, w, shift, v, v_shift, loss
        return (label or loss, lambda: kernels.hv(*args, b.tiles),
                lambda: reference.hessian_vector(args[0], plain, *args[2:]))

    def hv_at(label, b=batch, plain=plain_csc, d2=d2_row):
        return (label, lambda: kernels.hv_at(b._csr, b._csc, d2, v, v_shift, b.tiles),
                lambda: reference.hv_at(b._csr, plain, d2, v, v_shift))

    others = {}
    for label, b in (("skewed", skewed), ("power-law", power_law)):
        s = torch.sigmoid(b.dot_rows(w))
        others[label] = b, b.column_major(), s * (1.0 - s)

    variants = {
        "margins_pair": [("pair+offsets+shifts",
                          lambda: kernels.margins_pair(csr, w, v, batch.offsets, shift, v_shift),
                          lambda: reference.margins_pair(csr, w, v, batch.offsets, shift,
                                                         v_shift))],
        "value_grad": [vg("squared"), vg("poisson"), vg("logistic")] + [
            vg("logistic", b, plain, f"{label} logistic")
            for label, (b, plain, _) in others.items()],
        "hv": [hv("squared"), hv("poisson"), hv("logistic")] + [
            hv("logistic", b, plain, f"{label} logistic")
            for label, (b, plain, _) in others.items()],
        "hv_at": [hv_at("hv_at")] + [hv_at(f"{label} hv_at", b, plain, d2)
                                     for label, (b, plain, d2) in others.items()],
    }
    # Bytes the function must move: the CSR slots once (8 per nonzero),
    # row_ptr, the per-row inputs and tables, the outputs. The two-layout
    # designs also read the CSC slots once and the tile index, and write and
    # read one part per segment: their own floor. The tile-fused kernel
    # (value_grad, hv, hv_at) reads the index but its `start`.
    slots = (n + 1) + 2 * nnz
    t = tiles
    tile_fused = 2 * nnz + (t.index.numel() - t.n_slots) + 2 * t.n_parts
    stacked = torch.stack([w, v], 1)
    specs = {
        "margins_pair": ("photon_ml_tpu_torch/csrc/margins_pair.cu",
                         "photon_ml_tpu/ops/tiled.py:194", "pair+offsets+shifts",
                         slots + 2 * f + n + 2 * n, 0, 4 * nnz,
                         library_ms(lambda: torch.sparse_csr_tensor(
                             *csr, size=(n, f), check_invariants=False),
                             lambda m: torch.sparse.mm(m, stacked)),
                         "torch.sparse.mm(X_csr, [w, p]) without offsets and shifts"),
        "value_grad": ("photon_ml_tpu_torch/csrc/value_grad.cu",
                       "photon_ml_tpu/ops/tiled.py:219", "squared",
                       slots + 3 * n + f + f + 2, tile_fused, 4 * nnz, None,
                       "no single PyTorch call computes loss, gradient and sums"),
        "hv": ("photon_ml_tpu_torch/csrc/hessian_vector.cu",
               "photon_ml_tpu/ops/tiled.py:251", "squared",
               slots + 3 * n + 2 * f + f + 1, tile_fused, 6 * nnz, None,
               "no single PyTorch call computes the curvature-weighted X^T D X v"),
        "hv_at": ("photon_ml_tpu_torch/csrc/hessian_vector.cu",
                  "photon_ml_tpu/ops/tiled.py:284", "hv_at",
                  slots + n + f + f + 1, tile_fused, 4 * nnz, None,
                  "X^T (d2 * (X v + s)) takes two sparse products and an elementwise op"),
    }
    want_launches = {"margins_pair": 1, "value_grad": 2, "hv": 2, "hv_at": 2}
    rows = []
    for name, cases in variants.items():
        worst, timed = run_variants(name, cases)
        src, replaces, label, words, extra_words, flops, lib, lib_note = specs[name]
        # not a measurement: the bytes the two layouts make this design move,
        # over the HBM rate, for the kernel table beside the bound
        print(f"design floor {name}: two-layout bytes={4 * (words + extra_words)} "
              f"floor_ms={4 * (words + extra_words) / PEAK_BYTES_PER_S * 1e3:.4f} (computed)",
              flush=True)
        launches = launches_per_call(cases[0][1], want_launches[name])
        print(f"launches per call {name}[{cases[0][0]}]: {launches} (torch.profiler)",
              flush=True)
        if launches != want_launches[name]:
            raise RuntimeError(f"{name}: {launches} launches a call, want "
                               f"{want_launches[name]}")
        rows.append(kernel_row(name, src, replaces, worst, timed, label, 4 * words, flops,
                               lib, library_note=lib_note, launches_per_call=launches))
    return rows


def check_ell_kernel(values, rows, cols, y, w, offsets, skewed, csr_lib_ms) -> dict:
    """Phase 3, the ELL margins kernel: at full width on config #1's arrays,
    and on the skewed rows (``skewed_rows``: mean ~20, up to 256 slots, so
    most slots are padding), against its plain version and a second launch."""
    import dataclasses

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference
    from photon_ml_tpu_torch.ops.ell import ELLBatch

    ell = dataclasses.replace(ELLBatch.from_coo(values, rows, cols, y, N_FEATURES),
                              offsets=offsets)
    s_vals, s_rows, s_cols, s_n = skewed
    skewed = ELLBatch.from_coo(s_vals, s_rows, s_cols, np.zeros(s_n), N_FEATURES)
    shift = 0.25

    def case(label, b, sh, use):
        return (label, lambda: kernels.ell_margins(b.vals, b.cols, w, b.offsets, sh, use),
                lambda: reference.ell_margins(b.vals, b.cols, w, b.offsets, sh, use))

    worst, timed = run_variants("ell_margins", [
        case("margins+offsets+shift", ell, shift, True),
        case("dot_rows", ell, 0.0, False),
        case("skewed dot_rows", skewed, 0.0, False),
    ])
    n_slots, n_pad = ell.vals.shape
    print(f"ell layout: slots_per_row={n_slots} n_pad={n_pad}; skewed: "
          f"slots_per_row={skewed.vals.shape[0]} rows={s_n} nnz={len(s_rows)}",
          flush=True)
    # bytes: the slots (value + column, padding included), w, one output per
    # padded row; the library yardstick is row 1's, torch.mv of the CSR
    return kernel_row("ell_margins", "photon_ml_tpu_torch/csrc/ell_margins.cu",
                      "tools/probe_ell.py:26", worst, timed, "dot_rows",
                      4 * (2 * n_slots * n_pad + N_FEATURES + n_pad), 2 * len(values),
                      csr_lib_ms)


def solver_config(kind: str, max_iterations: int):
    """LBFGS or TRON with L2, or OWLQN with elastic net at alpha 0.5; tolerance 0."""
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )

    if kind == "owlqn":
        reg = RegularizationContext(RegularizationType.ELASTIC_NET, alpha=0.5)
    else:
        reg = RegularizationContext(RegularizationType.L2)
    opt = OptimizerType.TRON if kind == "tron" else OptimizerType.LBFGS
    return OptimizerConfig(optimizer_type=opt, max_iterations=max_iterations, tolerance=0.0,
                           regularization=reg)


def box(n_features: int, device, bound: float = 0.5):
    import torch

    from photon_ml_tpu_torch.optim.common import BoxConstraints

    return BoxConstraints(
        lower=torch.full((n_features,), -bound, dtype=torch.float32, device=device),
        upper=torch.full((n_features,), bound, dtype=torch.float32, device=device),
    )


def check_small_parity(seed: int) -> None:
    """Phase 4: the same reduced problems trained on the card and on the CPU.
    The solves stop after a few iterations, before float32 noise (which the
    card's and the CPU's summation orders make differently) decides a step."""
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.training import train_glm

    logistic = make_problem(seed + 1, SMALL_ROWS, SMALL_FEATURES, NNZ_PER_ROW) + (None,)
    rng = np.random.default_rng(seed + 1)
    linear = make_suite_problem(rng, SMALL_ROWS, SMALL_FEATURES, NNZ_PER_ROW, "linear")
    poisson = make_suite_problem(rng, SMALL_ROWS, SMALL_FEATURES, NNZ_PER_ROW, "poisson")
    runs = [
        ("lbfgs", logistic, "logistic", solver_config("lbfgs", 5), False),
        ("tron", linear, "squared", solver_config("tron", 3), False),
        ("owlqn", linear, "squared", solver_config("owlqn", 5), False),
        ("box_poisson", poisson, "poisson", solver_config("lbfgs", 5), True),
    ]
    for name, (values, rows, cols, y, offsets), task, cfg, boxed in runs:
        out = {}
        for dev in ("cuda", "cpu"):
            batch = CSRBatch.from_coo(values, rows, cols, y, SMALL_FEATURES, offsets=offsets,
                                      device=dev)
            constraints = box(SMALL_FEATURES, dev) if boxed else None
            (entry,) = train_glm(batch, task, [1.0], cfg, constraints=constraints, device=dev)
            res = entry.result
            out[dev] = (res.reason, float(res.value), res.iterations)
            print(f"small {name} {dev}: iterations={res.iterations} "
                  f"reason={CONVERGENCE_REASON_NAMES[res.reason]} loss={float(res.value):.7g}",
                  flush=True)
        (r_gpu, f_gpu, i_gpu), (r_cpu, f_cpu, i_cpu) = out["cuda"], out["cpu"]
        rel = abs(f_gpu - f_cpu) / abs(f_cpu)
        print(f"small {name} parity: loss_rel_diff={rel:.3e} limit={LOSS_RTOL:.0e}", flush=True)
        if r_gpu != r_cpu or i_gpu != i_cpu or not rel <= LOSS_RTOL:
            raise RuntimeError(f"reduced-size {name} training on the card disagrees with the CPU")


def re_optimizer(kind: str, max_iterations: int, tolerance: float, box=None):
    """A random effect's optimizer, regularization weight 1: LBFGS (the
    default type), TRON or NEWTON with L2, or OWLQN with elastic net at alpha
    0.5; ``box`` the (global feature, lower, upper) triples."""
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )

    kw = {"optimizer_type": OptimizerType[kind.upper()]} if kind in ("tron", "newton") else {}
    reg = (RegularizationContext(RegularizationType.ELASTIC_NET, alpha=0.5) if kind == "owlqn"
           else RegularizationContext(RegularizationType.L2))
    return OptimizerConfig(max_iterations=max_iterations, tolerance=tolerance, regularization=reg,
                           regularization_weight=1.0, box_constraints=box, **kw)


def small_re_problem(seed: int):
    """A per-user problem over a sparse shard: RE_SMALL_ROWS rows of
    NNZ_PER_ROW uniform features out of RE_SMALL_FEATURES, RE_SMALL_USERS
    users, labels from a planted per-user logistic model."""
    rng = np.random.default_rng(seed + 4)
    rows = np.repeat(np.arange(RE_SMALL_ROWS, dtype=np.int64), NNZ_PER_ROW)
    cols = rng.integers(0, RE_SMALL_FEATURES, size=len(rows))
    vals = rng.normal(size=len(rows))
    users = rng.integers(0, RE_SMALL_USERS, size=RE_SMALL_ROWS)
    w_user = rng.normal(size=(RE_SMALL_USERS, RE_SMALL_FEATURES)) * 0.5
    margins = np.bincount(rows, weights=vals * w_user[users[rows], cols], minlength=RE_SMALL_ROWS)
    y = (rng.random(RE_SMALL_ROWS) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    return vals, rows, cols, users, y


def check_small_re_parity(seed: int) -> None:
    """Phase 4, the random effect: one update of a per-user coordinate over
    a sparse shard (``small_re_problem``) on the card and on the CPU, with
    the buckets of K >= 128 local features forced to the COO layout, under
    LBFGS, OWLQN, TRON and NEWTON in a box. Per lane: the same reason, the
    value within rtol 1e-4, and the same iteration count except on plateau
    lanes, named here as those whose last step moved the objective by at most
    PLATEAU_RTOL of its start on either side (where a step's fate follows the
    float32 rounding of the sums, which the card and the CPU order
    differently). Then, on the same data, a factored coordinate (latent_dim
    2, 2 MF iterations) and the random projector (projected_dim 16), LBFGS 20
    for both optimizers: their latent solves per lane as above but with the
    plateau lanes excepted from every check (and, in the second MF
    iteration, the lanes excepted in the first, whose warm start a rounding
    decided), and each latent matrix refit with the same reason and
    iterations, its value within rtol 1e-4."""
    from photon_ml_tpu_torch.game import (
        FactoredRandomEffectCoordinate,
        FeatureShard,
        RandomEffectCoordinate,
        build_game_dataset,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.game import random_effect_data
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES

    t0 = time.perf_counter()
    vals, rows, cols, users, y = small_re_problem(seed)
    dense_design = random_effect_data._bucket_dense_design
    random_effect_data._bucket_dense_design = (
        lambda b: None if b.num_local_features >= 128 else dense_design(b))
    try:
        data = {}
        for dev in ("cuda", "cpu"):
            gds = build_game_dataset(y, {"items": FeatureShard.from_coo(
                vals, rows, cols, RE_SMALL_FEATURES)}, id_columns={"userId": users}, device=dev)
            data[dev] = gds, build_random_effect_dataset(gds, "userId", "items")
        red = data["cuda"][1]
        layout = ["dense" if x is not None else "coo" for x in red.dense_designs()]
        print("small re buckets (E,R,K,layout): " + json.dumps(
            [(b.num_entities, b.rows_per_entity, b.num_local_features, lay)
             for b, lay in zip(red.buckets, layout)]), flush=True)
        runs = [("lbfgs", re_optimizer("lbfgs", 10, 1e-3)),
                ("owlqn", re_optimizer("owlqn", 10, 1e-3)),
                ("tron", re_optimizer("tron", 5, 1e-3)),
                ("newton_box", re_optimizer("newton", 10, 1e-3, RE_BOX))]
        for name, cfg in runs:
            out = {}
            for dev, (gds, red) in data.items():
                coord = RandomEffectCoordinate("per-user", gds, red, "logistic", cfg)
                coord.update_model(coord.initialize_model(), None)
                out[dev] = coord.last_results
            _compare_lanes(f"small re {name}", out)
        # the factored coordinate and the random projector on the same data
        lbfgs = re_optimizer("lbfgs", 20, 1e-3)
        for name, kw in (("factored", dict(latent_dim=2, mf_iterations=2)),
                         ("projector", dict(latent_dim=16, refit_projection=False))):
            out, matrix = {}, {}
            for dev, (gds, red) in data.items():
                coord = FactoredRandomEffectCoordinate("per-user", gds, red, "logistic",
                                                       lbfgs, lbfgs, **kw)
                coord.update_model(coord.initialize_model(), None)
                out[dev] = [r for r in coord.last_results if r.value.dim() == 1]
                matrix[dev] = [(r.reason, r.iterations, float(r.value))
                               for r in coord.last_results if r.value.dim() == 0]
            n_buckets = len(red.buckets)
            for step, ((rg, ig, fg), (rc, ic, fc)) in enumerate(zip(matrix["cuda"],
                                                                    matrix["cpu"])):
                rel = abs(fg - fc) / abs(fc)
                print(f"small re {name} latent matrix {step}: reason={CONVERGENCE_REASON_NAMES[rg]} "
                      f"iterations={ig} value={fg:.7g} cpu: reason="
                      f"{CONVERGENCE_REASON_NAMES[rc]} iterations={ic} value={fc:.7g} "
                      f"rel_diff={rel:.3e} limit={LOSS_RTOL:.0e}", flush=True)
                if rg != rc or ig != ic or not rel <= LOSS_RTOL:
                    raise RuntimeError(f"small re {name}: the latent matrix refit {step} on "
                                       "the card disagrees with the CPU")
            carried = []
            for step in range(len(out["cuda"]) // n_buckets):
                part = slice(step * n_buckets, (step + 1) * n_buckets)
                carried = _compare_lanes(f"small re {name} step {step}",
                                         {dev: r[part] for dev, r in out.items()}, carried)
    finally:
        random_effect_data._bucket_dense_design = dense_design
    print(f"small re: {time.perf_counter() - t0:.2f} s", flush=True)


def _compare_lanes(label: str, out: dict, carried=None) -> list:
    """Phase 4's per-lane check of one update's bucket results on the card
    and on the CPU (``out[dev]``, one ``SolveResult`` a bucket): the same
    reason, the value within LOSS_RTOL, the same iterations but on plateau
    lanes. With ``carried`` (per bucket, the lanes excepted in the previous
    MF iteration of a factored coordinate, or ``[]`` for its first) the
    plateau lanes are excepted from all three checks, and so are the lanes
    carried: a plateau lane's last step is decided by float32 rounding, and
    the point it stops at warm-starts its next MF iteration. Returns the
    lanes excepted, per bucket."""
    import torch

    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES

    host = {dev: [tuple(t.cpu() for t in (r.reason, r.value, r.iterations, r.values))
                  for r in results] for dev, results in out.items()}
    worst, plateau, bad, excepted = 0.0, 0, [], []
    for b, ((rg, fg, ig, vg), (rc, fc, ic, vc)) in enumerate(zip(host["cuda"], host["cpu"])):
        rel = ((fg.double() - fc.double()).abs() / fc.double().abs().clamp(min=1e-30))
        flat = _plateau_lanes(vg, ig) | _plateau_lanes(vc, ic)
        if carried:
            flat |= carried[b]
        excepted.append(flat)
        plateau += int(flat.sum())
        held = ~flat if carried is not None else torch.ones_like(flat)
        worst = max(worst, float(rel[held].max()) if bool(held.any()) else 0.0)
        if not torch.equal(rg[held], rc[held]):
            bad.append(f"bucket {b}: reasons differ on {int((rg != rc)[held].sum())} lanes")
        if not bool((rel[held] <= LOSS_RTOL).all()):
            bad.append(f"bucket {b}: values differ beyond rtol {LOSS_RTOL}")
        off = (ig != ic) & ~flat
        if bool(off.any()):
            bad.append(f"bucket {b}: iterations differ on {int(off.sum())} lanes "
                       "that are not plateau lanes")
        wrong = (((rg != rc) | (rel > LOSS_RTOL)) & held) | off
        for lane in torch.nonzero(wrong).flatten()[:3].tolist():
            bad.append({"bucket": b, "lane": lane, "reasons": [int(rg[lane]), int(rc[lane])],
                        "iterations": [int(ig[lane]), int(ic[lane])],
                        "values": [vg[lane, :int(ig[lane]) + 1].tolist(),
                                   vc[lane, :int(ic[lane]) + 1].tolist()]})
    reasons = torch.cat([r for r, *_ in host["cuda"]]).long()
    its = torch.cat([i for _, _, i, _ in host["cuda"]]).long()
    counts = torch.bincount(reasons, minlength=5).tolist()
    print(f"{label}: lanes={len(reasons)} reasons="
          f"{json.dumps({CONVERGENCE_REASON_NAMES[k]: int(c) for k, c in enumerate(counts) if c})} "
          f"iterations={torch.bincount(its).tolist()} plateau_lanes={plateau}"
          f"{' (excepted, with those carried)' if carried is not None else ''} "
          f"value_rel_diff={worst:.3e} limit={LOSS_RTOL:.0e}", flush=True)
    if bad:
        raise RuntimeError(f"{label}: the card disagrees with the CPU: {bad}")
    return excepted


def _plateau_lanes(values, iterations):
    """Lanes whose last recorded step moved the objective by at most
    PLATEAU_RTOL of its start."""
    import torch

    it = iterations.long().clamp(min=1, max=values.shape[1] - 1)
    last = values.gather(1, it[:, None])[:, 0].double()
    before = values.gather(1, (it - 1)[:, None])[:, 0].double()
    start = values[:, 0].double().abs()
    return torch.nan_to_num((last - before).abs(), nan=0.0) <= PLATEAU_RTOL * start


def scatter_memory(batches) -> dict:
    """The device bytes the scatter adds to these batches: their tile
    indexes, held for the batches' lives, and the largest part scratch one
    scatter call allocates (32 floats a piece), freed when it returns."""
    tiles = [b.tiles for b in batches]
    return {"scatter_index_bytes": sum(4 * t.index.numel() for t in tiles),
            "scatter_part_bytes": max(4 * 32 * t.n_pieces for t in tiles)}


def run_path(label, batch, task, lambdas, cfg, required, constraints=None,
             compute_variances=False, min_auc=None) -> tuple[dict, dict]:
    """Phase 5: one path through train_glm as a user calls it (device
    defaults to cuda), with the launch counts zeroed just before it and read
    just after. Fails on a bad result or a kernel of ``required`` that did
    not launch."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.training import train_glm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    entries = train_glm(batch, task, lambdas, cfg, constraints=constraints,
                        compute_variances=compute_variances)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    peak = torch.cuda.max_memory_allocated()

    passes = sum(e.result.data_passes for e in entries)
    iterations = sum(e.result.iterations for e in entries)
    for e in entries:
        res, coef = e.result, e.model.coefficients
        loss0, loss = float(res.values[0]), float(res.value)
        bad = []
        if not bool(coef.means.isfinite().all()) or not np.isfinite(loss):
            bad.append("non-finite")
        if not loss < loss0:
            bad.append("loss did not decrease")
        if compute_variances and not bool((coef.variances > 0).all()):
            bad.append("variances not positive")
        extra = ""
        if constraints is not None:
            if not (bool((coef.means >= constraints.lower).all())
                    and bool((coef.means <= constraints.upper).all())):
                bad.append("box violated")
            # TRON reports the value at its unprojected trial point, as the
            # reference does; hold the returned (projected) w to the start too
            obj = make_objective(task, cfg.regularization.l2_weight(e.reg_weight))
            loss_at_w = float(obj.value(coef.means, batch))
            extra = f" loss_at_w={loss_at_w:.7g}"
            if not loss_at_w < loss0:
                bad.append("loss at the returned w did not decrease")
        if min_auc is not None:
            score_auc = float(auc(e.model.compute_score(batch), batch.labels, batch.weights))
            extra += f" train_auc={score_auc:.6f}"
            if not score_auc > min_auc:
                bad.append(f"auc {score_auc}")
        values = " ".join(f"{float(x):.9g}" for x in res.values[:res.iterations + 1])
        print(f"path {label} lambda={e.reg_weight}: iterations={res.iterations} "
              f"reason={CONVERGENCE_REASON_NAMES[res.reason]} data_passes={res.data_passes} "
              f"loss0={loss0:.7g} loss={loss:.7g}{extra} values=[{values}]", flush=True)
        if bad:
            raise RuntimeError(f"path {label} lambda={e.reg_weight}: bad result: {bad}")
    rows_per_s = batch.num_rows * passes / elapsed
    stats = {"elapsed_s": elapsed, "rows_per_s": rows_per_s, "data_passes": passes,
             "iterations": iterations, "host_syncs": syncs,
             "ms_per_iteration": 1e3 * elapsed / max(iterations, 1),
             "max_memory_allocated": peak, **scatter_memory([batch])}
    print(f"path {label}: rows={batch.num_rows} data_passes={passes} iterations={iterations} "
          f"elapsed_s={elapsed:.4f} rows_per_s={rows_per_s:.1f} host_syncs={syncs} "
          f"ms_per_iteration={stats['ms_per_iteration']:.4f} max_memory_allocated={peak} "
          f"scatter_index_bytes={stats['scatter_index_bytes']} "
          f"scatter_part_bytes={stats['scatter_part_bytes']} "
          f"launches={json.dumps(launches)}", flush=True)
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path {label}: kernels not launched: {missing}")
    return launches, stats


def profile_solve(label, run) -> dict:
    """--profile: device-busy share of one cold solve ``run()``, which returns
    its iteration count (or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iterations = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: an operator's device time repeats its kernels'
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0)
        if dev_us:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    report = {
        "path": label,
        "iterations": iterations,
        "wall_s": wall,
        "device_busy_s": busy_s if busy_s > 0 else None,
        "device_busy_share": busy_s / wall if busy_s > 0 else None,
        "top_device_us": [(name[:80], us) for name, us in top],
    }
    print("profile " + json.dumps(report), flush=True)
    return report


def make_game_problem(seed: int):
    """bench_game.py:49-81's data, the same draws in the same order: a sparse
    fixed-effect shard, dense per-user features over 100K users, and labels
    from a planted logistic model with both effects."""
    rng = np.random.default_rng(seed)
    nnz = N_ROWS * NNZ_PER_ROW
    fe_rows = np.repeat(np.arange(N_ROWS, dtype=np.int64), NNZ_PER_ROW)
    fe_cols = rng.integers(0, N_FEATURES, size=nnz)
    fe_vals = rng.normal(size=nnz)
    w_true = rng.normal(size=N_FEATURES) * 0.5
    users = rng.integers(0, GAME_USERS, size=N_ROWS)
    Xu = rng.normal(size=(N_ROWS, GAME_RE_FEATURES))
    wu_true = rng.normal(size=(GAME_USERS, GAME_RE_FEATURES)) * 0.5
    margins = np.bincount(fe_rows, weights=fe_vals * w_true[fe_cols], minlength=N_ROWS)
    margins += np.einsum("ij,ij->i", Xu, wu_true[users])
    y = (rng.random(N_ROWS) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    return fe_vals, fe_rows, fe_cols, users, Xu, y


def run_suite_paths(seed: int, profile: bool, by_path: dict, train: dict, prof: dict) -> None:
    """Paths 5b-5e: bench_suite.py configs #2 and #3, the linear problem
    first, then the Poisson one, from one generator. Their batches are freed
    on return, so path 6's peak memory holds only its own data."""
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.training import train_glm

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    values, rows, cols, y, _ = make_suite_problem(rng, N_ROWS, N_FEATURES, NNZ_PER_ROW,
                                                  "linear")
    linear = CSRBatch.from_coo(values, rows, cols, y, N_FEATURES)
    values, rows, cols, y, offsets = make_suite_problem(rng, N_ROWS, N_FEATURES,
                                                        NNZ_PER_ROW, "poisson")
    poisson = CSRBatch.from_coo(values, rows, cols, y, N_FEATURES, offsets=offsets)
    del values, rows, cols, y, offsets
    print(f"data: bench_suite linear + poisson {N_ROWS}x{N_FEATURES}, "
          f"setup_s={time.perf_counter() - t0:.2f}", flush=True)

    the_box = box(N_FEATURES, "cuda")
    paths = [
        ("5b", linear, "squared", solver_config("tron", 10), None, ("hv_at", "csr_margins",
                                                                    "csc_scatter")),
        ("5c", linear, "squared", solver_config("owlqn", 20), None, ("value_grad",
                                                                     "csr_margins")),
        ("5d", poisson, "poisson", solver_config("lbfgs", 20), the_box, ("margins_pair",
                                                                         "value_grad")),
        ("5e", linear, "squared", solver_config("tron", 3), the_box, ("hv", "value_grad")),
    ]
    for label, pbatch, task, cfg, constraints, required in paths:
        by_path[label], train[label] = run_path(label, pbatch, task, [1.0], cfg, required,
                                                constraints=constraints)
        if profile:
            prof[label] = profile_solve(label, lambda: train_glm(
                pbatch, task, [1.0], cfg, constraints=constraints)[0].result.iterations)


def run_game_path(seed: int, profile: bool) -> tuple[dict, dict, dict | None, object]:
    """Path 6: GLMix config #4 through ``GameEstimator.fit`` as bench_game.py
    drives it: the random-effect build timed alone, one fit that saves its
    models to ``output_dir``, then the second fit timed with the launch counts
    zeroed just before it. Fails unless the saved final model, loaded back,
    scores the dataset bit for bit as the fitted one, the
    fixed effect's margins and scatter kernels launched, its loss fell in
    every coordinate-descent iteration, every coefficient is finite, the
    GLMix model's train AUC beats its fixed effect's alone, and two scorings
    and evaluations of the model agree bit for bit. Returns the dataset too,
    for path 9."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.data.model_store import load_game_model
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.game import (
        FeatureShard,
        FixedEffectConfig,
        GameConfig,
        GameEstimator,
        RandomEffectConfig,
        build_game_dataset,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.game.coordinate_descent import ValidationSpec, _evaluate
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.optim.factory import OptimizerType

    # the dataset's blocks come from fresh segments, so the fit's peak does
    # not depend on which blocks the earlier paths left cached
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fe_vals, fe_rows, fe_cols, users, Xu, y = make_game_problem(seed)
    ru_rows, ru_cols = np.nonzero(Xu)
    gds = build_game_dataset(y, {
        "global": FeatureShard.from_coo(fe_vals, fe_rows, fe_cols, N_FEATURES),
        "user": FeatureShard.from_coo(Xu[ru_rows, ru_cols], ru_rows, ru_cols, GAME_RE_FEATURES),
    }, id_columns={"userId": users})
    del fe_vals, fe_rows, fe_cols, Xu, ru_rows, ru_cols
    print(f"data: bench_game config #4 {N_ROWS} rows, FE {N_FEATURES} x {NNZ_PER_ROW} nnz/row, "
          f"RE {GAME_RE_FEATURES} dense over {GAME_USERS} users, "
          f"setup_s={time.perf_counter() - t0:.2f}", flush=True)

    opt = dataclasses.replace(solver_config("lbfgs", 20), regularization_weight=1.0)
    re_opt = dataclasses.replace(opt, optimizer_type=OptimizerType.NEWTON, tolerance=1e-7)
    config = GameConfig(task="logistic", num_iterations=GAME_CD_ITERATIONS, coordinates={
        "fixed": FixedEffectConfig(shard_name="global", optimizer=opt),
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId", optimizer=re_opt),
    })
    t0 = time.perf_counter()
    red = build_random_effect_dataset(gds, "userId", "user")
    re_build_s = time.perf_counter() - t0
    buckets = [(b.num_entities, b.rows_per_entity, b.num_local_features) for b in red.buckets]
    total_coeffs = N_FEATURES + sum(e * k for e, _, k in buckets)
    del red

    est = GameEstimator(config)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as out:
        t0 = time.perf_counter()
        first = est.fit(gds, output_dir=out)
        torch.cuda.synchronize()
        first_fit_s = time.perf_counter() - t0
        # the saved final model, loaded back, scores as the fitted one does
        loaded = load_game_model(os.path.join(out, "final"))
        reloaded_same = torch.equal(loaded.score(gds), first.model.score(gds))
    print(f"path 6 saved: first_fit_s={first_fit_s:.4f} (with output_dir) "
          f"final_reloaded_scores_bit_identical={reloaded_same}", flush=True)
    del first, loaded
    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = est.fit(gds)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    peak = torch.cuda.max_memory_allocated()

    bad = [] if reloaded_same else ["the saved final model scores differently when loaded"]
    model = result.model
    fe = model.models["fixed"]
    coeffs = [fe.coefficients] + [b.coefficients for b in model.models["per-user"].buckets]
    if not all(bool(c.isfinite().all()) for c in coeffs):
        bad.append("non-finite coefficients")
    newton, fe_losses, fe_trackers = [], [], []
    for entry in result.history:
        it, name = entry["iteration"], entry["coordinate"]
        if name == "fixed":
            (res,) = entry["results"]
            loss0, loss = float(res.values[0]), float(res.value)
            fe_losses.append(loss)
            fe_trackers.append(entry["tracker"])
            print(f"path 6 cd={it} fixed: iterations={res.iterations} "
                  f"reason={CONVERGENCE_REASON_NAMES[res.reason]} loss0={loss0:.7g} "
                  f"loss={loss:.7g} seconds={entry['seconds']:.4f}", flush=True)
            if not loss < loss0:
                bad.append(f"fixed-effect loss did not fall in CD iteration {it}")
            continue
        for b, res in enumerate(entry["results"]):
            reasons = torch.bincount(res.reason.long(), minlength=5).tolist()
            row = {"cd": it, "bucket": b, "entities_rows_k": buckets[b],
                   "max_iterations": int(res.iterations.max()),
                   "reasons": {CONVERGENCE_REASON_NAMES[r]: c for r, c in enumerate(reasons)
                               if c}}
            newton.append(row)
            print(f"path 6 cd={it} per-user newton {json.dumps(row)}", flush=True)
        print(f"path 6 cd={it} per-user: seconds={entry['seconds']:.4f}", flush=True)
    labels, weights = gds.per_row(gds.response), gds.per_row(gds.weight)
    glmix_auc = float(auc(model.score(gds) + gds.per_row(gds.offset), labels, weights))
    fe_auc = float(auc(fe.score(gds) + gds.per_row(gds.offset), labels, weights))
    if not glmix_auc > fe_auc:
        bad.append(f"GLMix train auc {glmix_auc} <= fixed effect alone {fe_auc}")
    # the fitted model scored twice and evaluated twice, as a validated fit
    # evaluates it: the random effect's scores and the metrics must repeat
    # bit for bit
    specs = ["auc", "auc:userId", "precision@5:userId"]
    scores = [model.score(gds) for _ in range(2)]
    evals = [_evaluate(model, ValidationSpec(data=gds, evaluators=specs)) for _ in range(2)]
    same = {"scores": torch.equal(*scores), **{k: evals[0][k] == evals[1][k] for k in specs}}
    print(f"path 6 twice: {' '.join(f'{k}={v:.9g}' for k, v in evals[0].items())} "
          f"bit_identical={json.dumps(same)}", flush=True)
    if not all(same.values()):
        bad.append(f"scores or metrics differ between two calls: {same}")
    coeffs_per_s = total_coeffs * GAME_CD_ITERATIONS / elapsed
    stats = {"elapsed_s": elapsed, "first_fit_s": first_fit_s, "re_build_s": re_build_s,
             "coeffs_per_s": coeffs_per_s, "total_coeffs": total_coeffs,
             "buckets": buckets, "newton": newton, "host_syncs": syncs,
             "max_memory_allocated": peak, "train_auc": glmix_auc, "fe_only_auc": fe_auc,
             "fe_losses": fe_losses, "fe_trackers": fe_trackers,
             "evaluated": evals[0], "bit_identical_twice": same,
             "final_reloaded_scores_bit_identical": reloaded_same,
             **scatter_memory(gds.__dict__["_csr_batches"].values())}
    print(f"path 6: coeffs_per_s={coeffs_per_s:.1f} total_coeffs={total_coeffs} "
          f"fit_wall_s={elapsed:.4f} first_fit_s={first_fit_s:.4f} re_build_s={re_build_s:.4f} "
          f"buckets(E,R,K)={buckets} host_syncs={syncs} max_memory_allocated={peak} "
          f"scatter_index_bytes={stats['scatter_index_bytes']} "
          f"scatter_part_bytes={stats['scatter_part_bytes']} "
          f"cached_batches={sorted(gds.__dict__['_csr_batches'])} "
          f"train_auc={glmix_auc:.6f} fe_only_auc={fe_auc:.6f} "
          f"launches={json.dumps(launches)}", flush=True)
    if bad:
        raise RuntimeError(f"path 6: bad result: {bad}")
    missing = [k for k in ("csr_margins", "csc_scatter") if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path 6: kernels not launched: {missing}")
    prof = None
    if profile:
        def refit():
            est.fit(gds)

        prof = profile_solve("6", refit)
    return launches, stats, prof, gds


def lane_report(label: str, results, buckets) -> list[dict]:
    """Per bucket of one random-effect update: the histograms of lane
    iterations and reasons, printed; and each lane's objective at the
    returned w held to no more than at its start (a box lane reads both at
    projected points). Returns the rows, each with ``rose``, its count of
    lanes that ended higher."""
    import torch

    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES

    rows = []
    for b, res in enumerate(results):
        reasons = torch.bincount(res.reason.long(), minlength=5).tolist()
        row = {"bucket": b, "entities_rows_k": buckets[b],
               "iterations": torch.bincount(res.iterations.long()).tolist(),
               "reasons": {CONVERGENCE_REASON_NAMES[r]: c for r, c in enumerate(reasons) if c},
               "rose": int((res.value > res.values[:, 0]).sum())}
        rows.append(row)
        print(f"path {label} lanes {json.dumps(row)}", flush=True)
    return rows


def check_coo_bucket_kernels(block, w) -> dict:
    """Path 9's kernels at the shapes of its largest COO bucket (a
    block-diagonal batch): ``csr_margins``, ``csc_scatter`` (plain and
    square) and ``hv_at``, each against its plain version and a second
    launch; ``csr_margins`` and ``csc_scatter`` timed against ``torch.mv`` of
    the same CSR and transposed CSR, beside their bounds."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference

    c = block.csr
    n, f, nnz = c.num_rows, c.num_features, c.nnz
    gen = torch.Generator(device="cuda").manual_seed(7)
    per_row = torch.randn(n, generator=gen, device="cuda")
    d2 = torch.rand(n, generator=gen, device="cuda")
    w = w.reshape(-1).contiguous()
    plain = c.column_major()
    out = {}
    for name, cases in {
        "csr_margins": [("coo dot_rows", lambda: kernels.csr_margins(*c._csr, w, c.offsets, 0.0,
                                                                     False),
                         lambda: reference.csr_margins(*c._csr, w, c.offsets, 0.0, False))],
        "csc_scatter": [("coo scatter", lambda: kernels.csc_scatter(*c._csc, per_row, False,
                                                                    c.tiles),
                         lambda: reference.csc_scatter(*plain, per_row, False)),
                        ("coo scatter_sq", lambda: kernels.csc_scatter(*c._csc, d2, True,
                                                                       c.tiles),
                         lambda: reference.csc_scatter(*plain, d2, True))],
        "hv_at": [("coo hv_at", lambda: kernels.hv_at(c._csr, c._csc, d2, w, 0.0, c.tiles)[0],
                   lambda: reference.hv_at(c._csr, plain, d2, w, 0.0)[0])],
    }.items():
        worst, timed = run_variants(name, cases)
        out[name] = {"max_abs_err": worst, "ms": timed[cases[0][0]][0],
                     "plain_ms": timed[cases[0][0]][1]}
    margin_bytes = 4 * ((n + 1) + 2 * nnz + f + n)
    scatter_bytes = 4 * ((f + 1) + 2 * nnz + n + f)
    out["csr_margins"].update(
        bound_ms=max(margin_bytes / PEAK_BYTES_PER_S, 2 * nnz / PEAK_F32_FLOPS) * 1e3,
        library_ms=library_ms(lambda: torch.sparse_csr_tensor(*c._csr, size=(n, f),
                                                              check_invariants=False),
                              lambda m: torch.mv(m, w)))
    out["csc_scatter"].update(
        bound_ms=max(scatter_bytes / PEAK_BYTES_PER_S, 2 * nnz / PEAK_F32_FLOPS) * 1e3,
        library_ms=library_ms(lambda: torch.sparse_csr_tensor(*plain, size=(f, n),
                                                              check_invariants=False),
                              lambda m: torch.mv(m, per_row)))
    t = c.tiles
    out["shape"] = {"entities": block.num_entities, "rows": n, "columns": f, "nnz": nnz,
                    "tile_slots": t.n_slots, "tile_pieces": t.n_pieces,
                    "index_bytes": 4 * t.index.numel(), "nnz_per_segment": nnz / t.n_slots}
    for name in ("csr_margins", "csc_scatter"):
        r = out[name]
        print(f"path 9 largest coo bucket {name}: kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']:.4f} shape={json.dumps(out['shape'])}", flush=True)
    return out


def check_variances(model, gds, red, opt, n_lanes: int, seed: int) -> float:
    """The per-user variances on ``n_lanes`` lanes drawn from ``seed``,
    against 1 / (diag H + 1e-12) recomputed by plain float64 numpy on the
    host from the bucket's dense design, the final model's other scores as
    the residual, and the lane's coefficients. Returns the largest relative
    difference."""
    import torch

    from photon_ml_tpu_torch.game import random_effect_data

    user = model.models["per-user"]
    residual = (model.models["fixed"].score(gds) + model.models["per-user-items"].score(gds))
    residual = residual.double().cpu().numpy()
    sizes = np.array([b.num_entities for b in red.buckets])
    rng = np.random.default_rng(seed + 5)
    picks = rng.choice(sizes.sum(), size=min(n_lanes, int(sizes.sum())), replace=False)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    l2 = opt.regularization.l2_weight(opt.regularization_weight)
    worst = 0.0
    for bi, (b, bm) in enumerate(zip(red.buckets, user.buckets)):
        lanes = picks[(picks >= starts[bi]) & (picks < starts[bi + 1])] - starts[bi]
        if not len(lanes):
            continue
        x = random_effect_data._bucket_dense_design(b)[lanes].astype(np.float64)
        ri = b.row_index[lanes]
        off = b.offsets[lanes] + np.where(ri >= 0, residual[np.maximum(ri, 0)], 0.0)
        w = bm.coefficients[torch.from_numpy(lanes)].double().cpu().numpy()
        z = np.einsum("erk,ek->er", x, w) + off
        p = 1.0 / (1.0 + np.exp(-z))
        diag = np.einsum("er,erk->ek", b.weights[lanes] * p * (1.0 - p), x * x) + l2
        want = 1.0 / (diag + 1e-12)
        got = bm.variances[torch.from_numpy(lanes)].double().cpu().numpy()
        worst = max(worst, float(np.max(np.abs(got - want) / want)))
    return worst


def run_re_path(gds, seed: int, profile: bool, fe_only_auc: float, card: str):
    """Paths 9, 9b and 9c: the rest of the random-effect coordinate at
    config #4's width, on path 6's dataset. Path 9 is ``GameEstimator.fit``
    (2 CD iterations) of config #4's fixed effect, a per-user random effect
    over the sparse 10K-feature ``global`` shard under the default optimizer
    type (LBFGS 20, L2 1, tolerance 1e-7: its wide buckets go to the COO
    layout, the block-diagonal batch), and config #4's dense per-user effect
    under NEWTON in the box ``RE_BOX`` with variances, updated last so that
    its variances can be recomputed from the final model's scores. The first
    fit saves its models; the second is timed. 9b and 9c are one update of
    the sparse per-user effect from zero with TRON (L2 1, 10 iterations) and
    with OWLQN (elastic net, alpha 0.5, weight 1, 20 iterations). Fails on
    non-finite coefficients or variances, a lane whose objective rose, a box
    that does not hold, variances that are not positive or disagree with
    their plain recomputation, a train AUC not above the fixed effect's
    alone (path 6), the COO buckets' kernels not launched (``csr_margins``
    and ``csc_scatter`` in path 9, ``hv_at`` in 9b), two scorings or
    evaluations that differ, or a reloaded model that scores differently."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.data.model_store import load_game_model
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.game import (
        FixedEffectConfig,
        GameConfig,
        GameEstimator,
        RandomEffectConfig,
    )
    from photon_ml_tpu_torch.game.coordinate_descent import ValidationSpec, _evaluate

    fixed_opt = dataclasses.replace(solver_config("lbfgs", 20), regularization_weight=1.0)
    items_opt = re_optimizer("lbfgs", 20, 1e-7)
    user_opt = re_optimizer("newton", 20, 1e-7, RE_BOX)
    config = GameConfig(task="logistic", num_iterations=GAME_CD_ITERATIONS, coordinates={
        "fixed": FixedEffectConfig(shard_name="global", optimizer=fixed_opt),
        "per-user-items": RandomEffectConfig(shard_name="global", id_name="userId",
                                             optimizer=items_opt),
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId", optimizer=user_opt,
                                       compute_variances=True),
    })
    est = GameEstimator(config)
    bad = []
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    telemetry.reset()
    with tempfile.TemporaryDirectory(dir=build_dir) as out:
        t0 = time.perf_counter()
        first = est.fit(gds, output_dir=out)
        torch.cuda.synchronize()
        first_fit_s = time.perf_counter() - t0
        spans = telemetry.snapshot()["span_seconds"]
        loaded = load_game_model(os.path.join(out, "final"))
        same_scores = torch.equal(loaded.score(gds), first.model.score(gds))
        same_var = all(torch.equal(a.variances, b.variances) for a, b in zip(
            loaded.models["per-user"].buckets, first.model.models["per-user"].buckets))
    re_build_s = spans.get("re_build:userId:global", 0.0)
    coo_layout_s = spans.get("re_coo_layout", 0.0)
    print(f"path 9 saved: first_fit_s={first_fit_s:.4f} (with output_dir, the RE builds "
          f"included) re_build_s={re_build_s:.4f} coo_layout_s={coo_layout_s:.4f} "
          f"re_build_user_s={spans.get('re_build:userId:user', 0.0):.4f} "
          f"final_reloaded_scores_bit_identical={same_scores} "
          f"variances_reloaded_bit_identical={same_var}", flush=True)
    if not (same_scores and same_var):
        bad.append("the saved final model scores differently or loses its variances")
    del first, loaded

    coords = est._build_coordinates(gds)
    items, user = coords["per-user-items"], coords["per-user"]
    shapes = {}
    for name, coord in (("per-user-items", items), ("per-user", user)):
        designs = coord.re_data.dense_designs()
        shapes[name] = [(b.num_entities, b.rows_per_entity, b.num_local_features)
                        for b in coord.re_data.buckets]
        layout = ["dense" if x is not None else "coo" for x in designs]
        print(f"path 9 {name} buckets (E,R,K,layout): " + json.dumps(
            [s + (lay,) for s, lay in zip(shapes[name], layout)]), flush=True)
    n_coo = sum(x is None for x in items.re_data.dense_designs())
    total_coeffs = N_FEATURES + sum(e * k for v in shapes.values() for e, _, k in v)

    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = est.fit(gds)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    peak = torch.cuda.max_memory_allocated()

    model = result.model
    lanes, item_launches = {}, {k: 0 for k in launches}
    for entry in result.history:
        name, it = entry["coordinate"], entry["iteration"]
        print(f"path 9 cd={it} {name}: seconds={entry['seconds']:.4f} "
              f"host_syncs={entry['host_syncs']} launches={json.dumps(entry['launches'])}",
              flush=True)
        if name == "fixed":
            continue
        if name == "per-user-items":
            for k, c in entry["launches"].items():
                item_launches[k] += c
        rows = lane_report(f"9 cd={it} {name}", entry["results"], shapes[name])
        lanes[f"{it}:{name}"] = rows
        if any(r["rose"] for r in rows):
            bad.append(f"cd {it} {name}: a lane's objective rose")
    coeffs = [model.models["fixed"].coefficients] + [
        b.coefficients for n in ("per-user-items", "per-user") for b in model.models[n].buckets]
    variances = [b.variances for b in model.models["per-user"].buckets]
    if not all(bool(c.isfinite().all()) for c in coeffs + variances):
        bad.append("non-finite coefficients or variances")
    if not all(bool((v > 0).all()) for v in variances):
        bad.append("variances not positive")
    lower, upper = user_opt.dense_box_bounds(user.re_data.num_global_features, sentinel=True)
    held, boxed = True, 0
    for b, bm in zip(user.re_data.buckets, model.models["per-user"].buckets):
        w = bm.coefficients.cpu().numpy()
        held &= bool(np.all(w >= lower[b.projection]) and np.all(w <= upper[b.projection]))
        boxed += int((b.projection == RE_BOX[0][0]).sum())
    var_err = check_variances(model, gds, user.re_data, user_opt, VARIANCE_LANES, seed)
    print(f"path 9 checks: box_held={held} entities_with_feature_0={boxed} "
          f"variance_max_rel_err={var_err:.3e} limit={VARIANCE_RTOL:.0e} "
          f"({VARIANCE_LANES} lanes)", flush=True)
    if not held:
        bad.append("the per-user box does not hold")
    if not var_err <= VARIANCE_RTOL:
        bad.append(f"variances disagree with their plain recomputation: {var_err}")
    labels, weights = gds.per_row(gds.response), gds.per_row(gds.weight)
    train_auc = float(auc(model.score(gds) + gds.per_row(gds.offset), labels, weights))
    if not train_auc > fe_only_auc:
        bad.append(f"train auc {train_auc} <= config #4's fixed effect alone {fe_only_auc}")
    missing = [k for k in ("csr_margins", "csc_scatter") if item_launches[k] == 0]
    if missing:
        bad.append(f"the COO buckets did not launch {missing}")
    specs = ["auc", "auc:userId"]
    scores = [model.score(gds) for _ in range(2)]
    evals = [_evaluate(model, ValidationSpec(data=gds, evaluators=specs)) for _ in range(2)]
    same = {"scores": torch.equal(*scores), **{k: evals[0][k] == evals[1][k] for k in specs}}
    print(f"path 9 twice: {' '.join(f'{k}={v:.9g}' for k, v in evals[0].items())} "
          f"bit_identical={json.dumps(same)}", flush=True)
    if not all(same.values()):
        bad.append(f"scores or metrics differ between two calls: {same}")
    coeffs_per_s = total_coeffs * GAME_CD_ITERATIONS / elapsed
    stats = {"elapsed_s": elapsed, "first_fit_s": first_fit_s, "re_build_s": re_build_s,
             "coo_layout_s": coo_layout_s, "coeffs_per_s": coeffs_per_s,
             "total_coeffs": total_coeffs, "buckets": shapes, "coo_buckets": n_coo,
             "lanes": lanes, "host_syncs": syncs, "max_memory_allocated": peak,
             "train_auc": train_auc, "fe_only_auc": fe_only_auc, "evaluated": evals[0],
             "bit_identical_twice": same, "variance_max_rel_err": var_err,
             "item_launches": item_launches}
    print(f"path 9: coeffs_per_s={coeffs_per_s:.1f} total_coeffs={total_coeffs} "
          f"fit_wall_s={elapsed:.4f} host_syncs={syncs} max_memory_allocated={peak} "
          f"coo_buckets={n_coo} train_auc={train_auc:.6f} fe_only_auc={fe_only_auc:.6f} "
          f"launches={json.dumps(launches)} per_user_items_launches="
          f"{json.dumps(item_launches)} card={card}", flush=True)
    prof = None
    if profile:
        def refit():
            est.fit(gds)

        prof = profile_solve("9", refit)

    # the largest COO bucket's kernels, outside the counted window
    coo = [c for c in items.re_data.coo_buckets(gds.device) if c is not None]
    pos = max(range(len(coo)), key=lambda i: coo[i].block.csr.nnz)
    bucket_pos = [i for i, c in enumerate(items.re_data.coo_buckets(gds.device))
                  if c is not None][pos]
    coo_kernels = check_coo_bucket_kernels(
        coo[pos].block, model.models["per-user-items"].buckets[bucket_pos].coefficients)
    stats["largest_coo_bucket"] = coo_kernels
    del result, model, scores

    sub = {"9": launches}
    for label, kind, iters, required in (("9b", "tron", 10, "hv_at"),
                                         ("9c", "owlqn", 20, None)):
        coord = dataclasses.replace(items, config=re_optimizer(kind, iters, 1e-7))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        telemetry.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = coord.update_model(coord.initialize_model(), None)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sub[label] = dict(kernels.LAUNCHES)
        s_syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
        rows = lane_report(label, coord.last_results, shapes["per-user-items"])
        finite = all(bool(b.coefficients.isfinite().all()) for b in m.buckets)
        stats[label] = {"seconds": dt, "host_syncs": s_syncs, "lanes": rows,
                        "max_memory_allocated": torch.cuda.max_memory_allocated(),
                        "launches": sub[label]}
        print(f"path {label}: optimizer={kind} seconds={dt:.4f} host_syncs={s_syncs} "
              f"max_memory_allocated={stats[label]['max_memory_allocated']} "
              f"launches={json.dumps(sub[label])}", flush=True)
        if not finite or any(r["rose"] for r in rows):
            bad.append(f"path {label}: non-finite coefficients or a lane's objective rose")
        if required and sub[label][required] == 0:
            bad.append(f"path {label}: {required} not launched on the COO buckets")
        del m
    sub["11b"], stats["11b"] = run_projector_path(gds, items, shapes["per-user-items"], card,
                                                  bad)
    if bad:
        raise RuntimeError(f"path 9: bad result: {bad}")
    return sub, stats, prof


def run_projector_path(gds, items, shapes, card: str, bad: list) -> tuple[dict, dict]:
    """Path 11b: the random projector on path 9's sparse per-user effect (its
    dataset: 10 buckets over the 10K-feature shard, the 3 widest on COO),
    built as ``GameEstimator`` builds a ``projector: random`` random effect:
    one update from zero in a PROJECTED_DIM-dim Gaussian space, LBFGS 20, L2
    1, tolerance 1e-7. Adds to ``bad`` a lane whose objective rose, a score
    that is not finite, two scorings that differ, or a saved model (type
    ``factored_random_effect``) that reloads to other scores."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.data.model_store import (
        load_game_model,
        load_game_model_metadata,
        save_game_model,
    )
    from photon_ml_tpu_torch.game import FactoredRandomEffectCoordinate, GameModel

    opt = re_optimizer("lbfgs", 20, 1e-7)
    coord = FactoredRandomEffectCoordinate(
        "per-user-projected", gds, items.re_data, "logistic", opt, opt,
        latent_dim=PROJECTED_DIM, refit_projection=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model = coord.update_model(coord.initialize_model(), None)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    rows = lane_report("11b", coord.last_results, shapes)
    scores = [coord.score(model) for _ in range(2)]
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    with tempfile.TemporaryDirectory(dir=build_dir) as out:
        game = GameModel(task="logistic", models={"per-user-projected": model})
        save_game_model(game, out)
        kind = load_game_model_metadata(out)["coordinates"]["per-user-projected"]["type"]
        reloaded = torch.equal(load_game_model(out).score(gds), game.score(gds))
    checks = {"lanes_rose": sum(r["rose"] for r in rows),
              "finite": bool(scores[0].isfinite().all()),
              "twice": torch.equal(*scores), "saved_type": kind, "reloaded": reloaded}
    stats = {"seconds": dt, "host_syncs": syncs, "lanes": rows, "launches": launches,
             "max_memory_allocated": torch.cuda.max_memory_allocated(), **checks}
    print(f"path 11b: projected_dim={PROJECTED_DIM} seconds={dt:.4f} host_syncs={syncs} "
          f"max_memory_allocated={stats['max_memory_allocated']} checks={json.dumps(checks)} "
          f"launches={json.dumps(launches)} card={card}", flush=True)
    if checks["lanes_rose"] or not (checks["finite"] and checks["twice"] and reloaded
                                    and kind == "factored_random_effect"):
        bad.append(f"path 11b: {checks}")
    return launches, stats


def numpy_summary(values, cols, n_rows: int, n_features: int) -> dict:
    """The reference's summary (``photon_ml_tpu/data/stats.py``) in float64
    numpy over the nonzeros as entries: every row valid, zeros counted in the
    mean and variance, max and min over the nonzero entries and 0 where a
    feature has fewer nonzero entries than rows."""
    nz = values != 0
    s1 = np.bincount(cols, weights=values, minlength=n_features)
    s2 = np.bincount(cols, weights=values * values, minlength=n_features)
    count = np.bincount(cols, weights=nz, minlength=n_features)
    order = np.argsort(cols, kind="stable")
    starts = np.searchsorted(cols[order], np.arange(n_features))
    present = values[order]
    hi = np.maximum.reduceat(np.where(nz[order], present, -np.inf), starts)
    lo = np.minimum.reduceat(np.where(nz[order], present, np.inf), starts)
    some_zero = count < n_rows
    hi = np.where(count == 0, 0.0, np.where(some_zero, np.maximum(hi, 0.0), hi))
    lo = np.where(count == 0, 0.0, np.where(some_zero, np.minimum(lo, 0.0), lo))
    mean = s1 / n_rows
    return {"mean": mean, "variance": (s2 - n_rows * mean * mean) / (n_rows - 1),
            "max": hi, "min": lo, "num_nonzeros": count}


def run_data_plane_path(seed: int, card: str, work: str) -> tuple[dict, dict, dict]:
    """Path 8: config #1's draws as LIBSVM files in ``work`` (left there for
    path 10), through the data plane as a user calls it: the native parser,
    ``to_batch`` onto the card, ``validate``, ``summarize`` twice, a
    standardized ``train_glm`` picked by held-out AUC, each lambda's held-out
    metric map (``diagnostics.evaluate``), and ``save_glm`` / ``load_glm``.
    Returns the launches, the stats, and what path 10's ``cli glm`` must
    repeat bit for bit: the files, the best lambda and its AUC, each
    lambda's metrics and means. Fails unless the parsed
    arrays equal the draws as written, the two summaries are bit-identical
    and within the reference test's tolerances of a float64 numpy summary,
    the scatter kernel launched in ``summarize``, the loss fell from the
    sweep's start (and no solve ended above its own start) with finite
    coefficients and train AUC above 0.6, and the loaded model's means and
    held-out scores are bit-identical to the trained one's."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.data import (
        ValidationMode,
        build_normalization_context,
        read_libsvm,
        summarize,
        validate,
    )
    from photon_ml_tpu_torch.data.libsvm import write_libsvm
    from photon_ml_tpu_torch.data.model_store import load_glm, save_glm
    from photon_ml_tpu_torch.diagnostics import evaluate
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.training import select_best_model, train_glm

    stats, bad = {}, []
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    values, rows, cols, y, w_true = draw_problem(rng, N_ROWS, N_FEATURES, NNZ_PER_ROW)
    h_values, h_rows, h_cols, h_y, _ = draw_problem(rng, N_HELDOUT, N_FEATURES,
                                                    NNZ_PER_ROW, w_true)
    stats["draw_s"] = time.perf_counter() - t0
    train_path, heldout_path = os.path.join(work, "train.libsvm"), os.path.join(
        work, "heldout.libsvm")
    t0 = time.perf_counter()
    written = write_libsvm(train_path, values, rows, cols, 2.0 * y - 1.0)
    write_libsvm(heldout_path, h_values, h_rows, h_cols, 2.0 * h_y - 1.0)
    stats["write_s"] = time.perf_counter() - t0
    stats["file_bytes"] = os.path.getsize(train_path) + os.path.getsize(heldout_path)
    del values, h_values
    print(f"path 8 write: rows={N_ROWS}+{N_HELDOUT} bytes={stats['file_bytes']} "
          f"write_s={stats['write_s']:.4f}", flush=True)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    data = read_libsvm(train_path, engine="native")
    heldout_data = read_libsvm(heldout_path, engine="native")
    stats["parse_s"] = time.perf_counter() - t0
    same = (np.array_equal(data.rows, rows) and np.array_equal(data.cols, cols)
            and np.array_equal(data.values, written) and np.array_equal(data.labels, y))
    if not same:
        raise RuntimeError("path 8: the parsed rows, columns or values differ from the "
                           "draws as written")
    t0 = time.perf_counter()
    batch = data.to_batch(num_features=N_FEATURES, add_intercept=True)
    heldout = heldout_data.to_batch(num_features=N_FEATURES, add_intercept=True)
    torch.cuda.synchronize()
    stats["build_s"] = time.perf_counter() - t0
    stats.update(rows=batch.num_rows, nnz=batch.nnz)
    t0 = time.perf_counter()
    validate(batch, "logistic", mode=ValidationMode.FULL)
    stats["validate_s"] = time.perf_counter() - t0
    print(f"path 8 read: rows={batch.num_rows} nnz={batch.nnz} "
          f"parse_s={stats['parse_s']:.4f} build_s={stats['build_s']:.4f} "
          f"validate_s={stats['validate_s']:.4f}", flush=True)

    scatter_before = kernels.LAUNCHES["csc_scatter"]
    summaries = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summaries.append(summarize(batch))
        torch.cuda.synchronize()
        stats.setdefault("summarize_s", []).append(time.perf_counter() - t0)
    stats["summarize_scatter_launches"] = kernels.LAUNCHES["csc_scatter"] - scatter_before
    first, again = (dataclasses.asdict(x) for x in summaries)
    identical = all(torch.equal(first[k], again[k]) for k in first)
    want = numpy_summary(written, cols, N_ROWS, N_FEATURES)
    got = {k: first[k][:N_FEATURES].double().cpu().numpy() for k in want}
    checks = {
        "mean": np.allclose(got["mean"], want["mean"], rtol=1e-4, atol=1e-5),
        "variance": np.allclose(got["variance"], want["variance"], rtol=1e-3, atol=1e-5),
        "max": np.array_equal(got["max"], want["max"].astype(np.float32)),
        "min": np.array_equal(got["min"], want["min"].astype(np.float32)),
        "num_nonzeros": np.array_equal(got["num_nonzeros"], want["num_nonzeros"]),
        "intercept": (float(first["mean"][N_FEATURES]) == 1.0
                      and float(first["variance"][N_FEATURES]) == 0.0),
    }
    errs = {k: float(np.max(np.abs(got[k] - want[k]))) for k in ("mean", "variance")}
    print(f"path 8 summarize: summarize_s={stats['summarize_s']} "
          f"scatter_launches={stats['summarize_scatter_launches']} "
          f"bit_identical={identical} checks={json.dumps(checks)} "
          f"max_abs_err={json.dumps(errs)}", flush=True)
    if not identical:
        bad.append("two summaries differ")
    if not all(checks.values()):
        bad.append(f"summary against float64 numpy: {checks}")
    if stats["summarize_scatter_launches"] == 0:
        bad.append("csc_scatter did not launch in summarize")
    del rows, cols, written

    t0 = time.perf_counter()
    ctx = build_normalization_context("standardization", summaries[0],
                                      data.intercept_index)
    entries = train_glm(batch, "logistic", [10.0, 1.0], solver_config("lbfgs", 20),
                        normalization=ctx)
    best, heldout_auc = select_best_model(entries, heldout)
    torch.cuda.synchronize()
    stats["train_s"] = time.perf_counter() - t0
    model = best.model
    # lambda 1 starts at lambda 10's optimum, which standardization leaves
    # within float32 rounding of its own: each solve must end no higher
    # than it began, and below the sweep's start, the zero model
    sweep_loss0 = max(float(e.result.values[0]) for e in entries)
    for e in entries:
        res = e.result
        loss0, loss = float(res.values[0]), float(res.value)
        train_auc = float(auc(e.model.compute_score(batch), batch.labels, batch.weights))
        print(f"path 8 lambda={e.reg_weight}: iterations={res.iterations} "
              f"reason={CONVERGENCE_REASON_NAMES[res.reason]} loss0={loss0:.7g} "
              f"loss={loss:.7g} train_auc={train_auc:.6f}", flush=True)
        if not (loss <= loss0 and loss < sweep_loss0):
            bad.append(f"lambda {e.reg_weight}: loss did not fall")
        if not bool(e.model.coefficients.means.isfinite().all()):
            bad.append(f"lambda {e.reg_weight}: non-finite coefficients")
        if not train_auc > 0.6:
            bad.append(f"lambda {e.reg_weight}: train auc {train_auc}")
    stats.update(best_lambda=best.reg_weight, heldout_auc=heldout_auc)
    reference = {"train_path": train_path, "heldout_path": heldout_path,
                 "best_lambda": best.reg_weight, "heldout_auc": heldout_auc,
                 "metrics": {e.reg_weight: evaluate(e.model, heldout) for e in entries},
                 "means": {e.reg_weight: e.model.coefficients.means.cpu() for e in entries}}

    t0 = time.perf_counter()
    model_dir = os.path.join(work, "glm")
    save_glm(model, model_dir)
    loaded = load_glm(model_dir)
    stats["save_load_s"] = time.perf_counter() - t0
    same_means = torch.equal(loaded.coefficients.means, model.coefficients.means)
    same_scores = torch.equal(loaded.compute_score(heldout), model.compute_score(heldout))
    torch.cuda.synchronize()
    stats["path_s"] = time.perf_counter() - t_path
    launches = dict(kernels.LAUNCHES)
    print(f"path 8 model: best_lambda={best.reg_weight} heldout_auc={heldout_auc:.6f} "
          f"train_s={stats['train_s']:.4f} save_load_s={stats['save_load_s']:.4f} "
          f"means_bit_identical={same_means} heldout_scores_bit_identical={same_scores}",
          flush=True)
    if not (same_means and same_scores):
        bad.append("the loaded model differs from the saved one")
    print(f"path 8: rows={stats['rows']} nnz={stats['nnz']} write_s={stats['write_s']:.4f} "
          f"parse_s={stats['parse_s']:.4f} build_s={stats['build_s']:.4f} "
          f"validate_s={stats['validate_s']:.4f} "
          f"summarize_s={' '.join(f'{t:.4f}' for t in stats['summarize_s'])} "
          f"train_s={stats['train_s']:.4f} save_load_s={stats['save_load_s']:.4f} "
          f"path_s={stats['path_s']:.4f} launches={json.dumps(launches)} card={card}",
          flush=True)
    if bad:
        raise RuntimeError(f"path 8: bad result: {bad}")
    missing = [k for k in ("csr_margins", "csc_scatter") if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path 8: kernels not launched: {missing}")
    return launches, stats, reference


def _run_cli_in_process(argv: list[str]) -> dict:
    """``photon_ml_tpu_torch.cli.__main__.main(argv)`` in this process; its
    JSON summary (the last line it prints) is returned."""
    import contextlib
    import io

    from photon_ml_tpu_torch.cli.__main__ import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _run_cli_subprocess(argv: list[str], root: str) -> tuple[dict, float]:
    """``python -m photon_ml_tpu_torch.cli <argv>`` from the checkout's root:
    (its JSON summary, its seconds), its timed phases printed. Fails on a
    non-zero exit."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.cli", *argv], cwd=root,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"cli {argv[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    for line in proc.stderr.splitlines():  # the driver's timed phases
        if " INFO photon_ml_tpu_torch: " in line:
            print(f"path 10 {argv[0]} log: {line.split(' INFO ', 1)[1]}", flush=True)
    return json.loads(proc.stdout.strip().splitlines()[-1]), seconds


def _same_or_both_nan(a: float, b: float) -> bool:
    return a == b or (a != a and b != b)


def run_cli_path(seed: int, card: str, work: str, game: dict, glm_ref: dict) -> tuple[dict, dict]:
    """Path 10: the CLI pipeline at config #4's full width, as a user runs it.
    Path 6's draws go out as TrainingExampleAvro in 4 files through the
    native encoder; ``cli index`` (a subprocess) indexes them; ``cli train``
    (in process, the guard on by default) reads them with the native decoder
    and fits path 6's GLMix; ``cli score`` (a subprocess, on the card by
    default) scores the training files with ``final/``; ``cli glm`` (in
    process) repeats path 8's GLM sweep on its LIBSVM files. Fails unless the
    native reader ran, the dataset equals path 6's draws (columns mapped back
    through the saved index map), the fixed effect's loss per CD iteration is
    within rtol 1e-4 of path 6's, the train AUC within 1e-3 of path 6's GLMix
    AUC and above its fixed effect's alone, the guard neither retried nor
    rolled back, ``final/``, ``best/``, the index maps and the feature
    statistics were written, ``csr_margins`` and ``csc_scatter`` launched,
    the scores read back from the scoring output equal the in-process
    model's plus offsets bit for bit (and the AUC), and ``cli glm``'s stages,
    best lambda, metrics and means equal path 8's bit for bit."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.cli import train as cli_train
    from photon_ml_tpu_torch.data.avro import read_scoring_results, write_training_examples_fast
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.data.model_store import load_glm
    from photon_ml_tpu_torch.data.native import load_avro_native
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.game import GameEstimator

    root = os.path.dirname(os.path.abspath(__file__))
    if load_avro_native() is None:
        raise RuntimeError("path 10: the native Avro library (build/native/libphoton_avro.so, "
                           "native/avro_*.cpp with -lz) did not build or load")
    stats, bad = {"card": card}, []

    # 1. path 6's draws as TrainingExampleAvro, 4 files, null codec
    fe_vals, fe_rows, fe_cols, users, Xu, y = make_game_problem(seed)
    data_dir = os.path.join(work, "avro")
    os.makedirs(data_dir)
    names = [f"f{j}" for j in range(N_FEATURES)] + [f"u{k}" for k in range(GAME_RE_FEATURES)]
    vocab = [str(u) for u in range(GAME_USERS)]
    bounds = np.linspace(0, N_ROWS, 5).astype(np.int64)
    t0 = time.perf_counter()
    for part in range(4):
        lo, hi = int(bounds[part]), int(bounds[part + 1])
        m = hi - lo
        bags = {
            "global": (np.arange(m + 1, dtype=np.int64) * NNZ_PER_ROW,
                       fe_cols[lo * NNZ_PER_ROW:hi * NNZ_PER_ROW],
                       fe_vals[lo * NNZ_PER_ROW:hi * NNZ_PER_ROW]),
            "user": (np.arange(m + 1, dtype=np.int64) * GAME_RE_FEATURES,
                     np.tile(np.arange(GAME_RE_FEATURES) + N_FEATURES, m), Xu[lo:hi].ravel()),
        }
        write_training_examples_fast(os.path.join(data_dir, f"part-{part}.avro"), y[lo:hi],
                                     bags, names, {"userId": (users[lo:hi], vocab)})
    stats["write_s"] = time.perf_counter() - t0
    stats["avro_bytes"] = sum(os.path.getsize(os.path.join(data_dir, f))
                              for f in os.listdir(data_dir))
    print(f"path 10 write: rows={N_ROWS} files=4 bytes={stats['avro_bytes']} "
          f"write_s={stats['write_s']:.4f} card={card}", flush=True)

    # 2. cli index, a subprocess
    idx_dir = os.path.join(work, "index")
    index, stats["index_s"] = _run_cli_subprocess(
        ["index", "--input", data_dir, "--output", idx_dir, "--shards", "global:global",
         "user:user", "--no-intercept"], root)
    stats["index_features"] = {k: v["num_features"] for k, v in index.items()}
    print(f"path 10 index: features={json.dumps(stats['index_features'])} "
          f"index_s={stats['index_s']:.4f} card={card}", flush=True)
    if stats["index_features"] != {"global": N_FEATURES, "user": GAME_RE_FEATURES}:
        bad.append(f"cli index wrote {stats['index_features']}")

    # 3. cli train, in process, with path 6's config and the default guard
    out = os.path.join(work, "model")
    inp = {"format": "avro", "paths": [data_dir], "add_intercept": False,
           "feature_shards": {"global": ["global"], "user": ["user"]}, "id_columns": ["userId"]}
    lbfgs = {"type": "lbfgs", "max_iterations": 20, "tolerance": 0.0, "regularization": "l2",
             "regularization_weight": 1.0}
    config = {"task": "logistic", "input": inp, "num_iterations": GAME_CD_ITERATIONS,
              "output_dir": out, "coordinates": {
                  "fixed": {"type": "fixed_effect", "shard_name": "global", "optimizer": lbfgs},
                  "per-user": {"type": "random_effect", "shard_name": "user",
                               "id_name": "userId",
                               "optimizer": {**lbfgs, "type": "newton", "tolerance": 1e-7}}},
              "checkpoint": {"dir": os.path.join(work, "ckpt"), "every": 1, "keep_last": 2}}
    train_cfg = os.path.join(work, "train.json")
    with open(train_cfg, "w") as fh:
        json.dump(config, fh)
    # the driver's dataset and fit result, as it builds them
    seen, read_input, fit = {}, cli_train.read_input, GameEstimator.fit

    def spy_read(*a, **k):
        t = time.perf_counter()
        seen.setdefault("read", read_input(*a, **k))
        stats.setdefault("read_s", time.perf_counter() - t)
        return seen["read"]

    def spy_fit(self, *a, **k):
        t = time.perf_counter()
        seen["fit"] = fit(self, *a, **k)
        torch.cuda.synchronize()
        stats["fit_s"] = time.perf_counter() - t
        return seen["fit"]

    cli_train.read_input, GameEstimator.fit = spy_read, spy_fit
    # with a checkpoint `cli train` installs its SIGTERM/SIGINT handlers; this
    # process keeps its own once it is done
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    torch.cuda.synchronize()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        summary = _run_cli_in_process(["train", "--config", train_cfg])
    finally:
        cli_train.read_input, GameEstimator.fit = read_input, fit
        for s, h in handlers.items():
            signal.signal(s, h)
    torch.cuda.synchronize()
    stats["train_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    counters = telemetry.snapshot()["counters"]
    stats.update(avro_reads={k: v for k, v in counters.items() if k.startswith("avro.")},
                 guard={k: counters.get(k, 0) for k in ("solves.diverged", "solves.retried",
                                                       "solves.rolled_back", "solves.frozen")})
    ds, maps = seen["read"]
    model = seen["fit"].model
    if counters.get("avro.native_reads", 0) < 1 or counters.get("avro.python_reads", 0):
        bad.append(f"the native Avro reader did not read the training data: "
                   f"{stats['avro_reads']}")

    # the dataset against path 6's draws, columns mapped back through the maps
    fe_j = np.asarray([int(k[1:]) for k in maps["global"].names])
    u_k = np.asarray([int(k[1:]) for k in maps["user"].names])
    g, u = ds.shard("global"), ds.shard("user")
    same = {
        "labels": np.array_equal(ds.response, y),
        "global": (np.array_equal(g.rows, fe_rows) and np.array_equal(fe_j[g.cols], fe_cols)
                   and np.array_equal(g.values, fe_vals.astype(np.float32))),
        "user": (np.array_equal(u.rows, np.repeat(np.arange(N_ROWS), GAME_RE_FEATURES))
                 and np.array_equal(u_k[u.cols], np.tile(np.arange(GAME_RE_FEATURES), N_ROWS))
                 and np.array_equal(u.values, Xu.ravel().astype(np.float32))),
        "userId": (set(ds.id_columns["userId"].vocab.tolist()) == {str(v) for v in
                                                                   np.unique(users)}
                   and np.array_equal(ds.id_columns["userId"].vocab[ds.id_columns["userId"]
                                      .codes].astype(np.int64), users)),
        "index_maps": all(maps[s].names == IndexMap.load(os.path.join(idx_dir, s)).names
                          for s in ("global", "user")),
    }
    if not all(same.values()):
        bad.append(f"the CLI's dataset differs from path 6's draws: {same}")
    del fe_vals, fe_rows, fe_cols, Xu

    fe_losses = [float(e["results"][0].value) for e in seen["fit"].history
                 if e["coordinate"] == "fixed"]
    # each FE solve's iterations and reason, from its tracker, beside path 6's
    fe_trackers = [e["tracker"] for e in seen["fit"].history if e["coordinate"] == "fixed"]
    for it, (mine, six) in enumerate(zip(fe_trackers, game["fe_trackers"])):
        print(f"path 10 cd={it} fixed tracker: {mine} | path 6: {six}", flush=True)
    ckpt = os.path.join(work, "ckpt")
    steps = sorted(os.listdir(ckpt))
    kept = {"steps": steps, "manifests": all(
        os.path.exists(os.path.join(ckpt, d, "manifest.json")) for d in steps)}
    loss_ok = len(fe_losses) == len(game["fe_losses"]) and all(
        abs(a - b) <= LOSS_RTOL * abs(b) for a, b in zip(fe_losses, game["fe_losses"]))
    labels, weights = ds.per_row(ds.response), ds.per_row(ds.weight)
    scores = model.score(ds).cpu().numpy() + ds.offset
    train_auc = float(auc(ds.per_row(scores), labels, weights))
    written = {p: os.path.exists(os.path.join(out, p)) for p in (
        "final/model-metadata.json", "best/model-metadata.json", "final/feature-indexes/global",
        "final/feature-indexes/user", "best/feature-indexes/global", "best/feature-indexes/user",
        "feature-stats/global.avro", "feature-stats/user.avro")}
    stats.update(fe_trackers=fe_trackers, path6_fe_trackers=game["fe_trackers"],
                 checkpoints=kept)
    stats.update(fe_losses=fe_losses, path6_fe_losses=game["fe_losses"], train_auc=train_auc,
                 path6_auc=game["train_auc"], same=same, written=written, launches=launches,
                 history=[{k: v for k, v in e.items() if k not in ("results", "launches")}
                          for e in summary["history"]])
    print(f"path 10 train: read_s={stats['read_s']:.4f} fit_s={stats['fit_s']:.4f} "
          f"train_s={stats['train_s']:.4f} avro_reads={json.dumps(stats['avro_reads'])} "
          f"dataset_equal={json.dumps(same)} fe_losses={fe_losses} "
          f"path6_fe_losses={game['fe_losses']} train_auc={train_auc:.6f} "
          f"path6_auc={game['train_auc']:.6f} path6_fe_only_auc={game['fe_only_auc']:.6f} "
          f"guard={json.dumps(stats['guard'])} written={json.dumps(written)} "
          f"checkpoints={json.dumps(kept)} launches={json.dumps(launches)} card={card}",
          flush=True)
    if kept != {"steps": ["step-00000002", "step-00000003"], "manifests": True}:
        bad.append(f"cli train kept other checkpoints than steps 2 and 3: {kept}")
    if not loss_ok:
        bad.append(f"fixed-effect losses {fe_losses} vs path 6's {game['fe_losses']}")
    if not (abs(train_auc - game["train_auc"]) <= 1e-3 and train_auc > game["fe_only_auc"]):
        bad.append(f"train auc {train_auc} vs path 6's {game['train_auc']} (fixed effect "
                   f"alone {game['fe_only_auc']})")
    if stats["guard"]["solves.retried"] or stats["guard"]["solves.rolled_back"]:
        bad.append(f"the guard retried or rolled back: {stats['guard']}")
    if not all(written.values()):
        bad.append(f"missing outputs: {written}")
    missing = [k for k in ("csr_margins", "csc_scatter") if launches[k] == 0]
    if missing:
        bad.append(f"kernels not launched in cli train: {missing}")

    # 4. cli score, a subprocess on the card by default, on the training files
    score_cfg = os.path.join(work, "score.json")
    with open(score_cfg, "w") as fh:
        json.dump({"input": inp}, fh)
    scores_path = os.path.join(work, "scores.avro")
    scored, stats["score_s"] = _run_cli_subprocess(
        ["score", "--model-dir", os.path.join(out, "final"), "--config", score_cfg,
         "--output", scores_path, "--evaluators", "auc"], root)
    t0 = time.perf_counter()
    read_back = np.asarray([r["predictionScore"] for r in read_scoring_results(scores_path)])
    stats["score_read_back_s"] = time.perf_counter() - t0
    score_same = {"scores": np.array_equal(read_back, scores),
                  "auc": scored["metrics"]["auc"] == train_auc,
                  "rows": scored["num_rows"] == N_ROWS}
    stats.update(score_same=score_same, score_auc=scored["metrics"]["auc"])
    print(f"path 10 score: score_s={stats['score_s']:.4f} (a subprocess) "
          f"read_back_s={stats['score_read_back_s']:.4f} auc={scored['metrics']['auc']:.9g} "
          f"bit_identical={json.dumps(score_same)} card={card}", flush=True)
    if not all(score_same.values()):
        bad.append(f"cli score differs from the in-process model: {score_same}")
    del ds, model, seen, scores, read_back
    torch.cuda.empty_cache()

    # 5. cli glm, in process, on path 8's LIBSVM files with path 8's settings
    glm_out = os.path.join(work, "glm_driver")
    glm_cfg = os.path.join(work, "glm.json")
    with open(glm_cfg, "w") as fh:
        json.dump({"task": "logistic", "input": {"format": "libsvm", "num_features": N_FEATURES,
                                                 "paths": [glm_ref["train_path"]]},
                   "validation": {"paths": [glm_ref["heldout_path"]]},
                   "optimizer": {"type": "lbfgs", "max_iterations": 20, "tolerance": 0.0,
                                 "regularization": "l2"},
                   "lambdas": [10.0, 1.0], "normalization": "standardization",
                   "output_dir": glm_out}, fh)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    glm = _run_cli_in_process(["glm", "--config", glm_cfg])
    torch.cuda.synchronize()
    stats["glm_s"] = time.perf_counter() - t0
    for k, n in kernels.LAUNCHES.items():
        launches[k] += n
    glm_same = {
        "stages": glm["stages"] == ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED"],
        "best_lambda": glm["best_lambda"] == glm_ref["best_lambda"],
        "best_metric": glm["best_metric"] == glm_ref["heldout_auc"],
        "metrics": all(
            sorted(glm["metrics"][str(lam)]) == sorted(ref)
            and all(_same_or_both_nan(glm["metrics"][str(lam)][k], v) for k, v in ref.items())
            for lam, ref in glm_ref["metrics"].items()),
        "means": all(torch.equal(load_glm(os.path.join(glm_out, "models", f"lambda-{lam}"))
                                 .coefficients.means.cpu(), ref)
                     for lam, ref in glm_ref["means"].items()),
    }
    stats.update(glm_same=glm_same, glm_best_lambda=glm["best_lambda"],
                 glm_best_metric=glm["best_metric"])
    print(f"path 10 glm: glm_s={stats['glm_s']:.4f} stages={glm['stages']} "
          f"best_lambda={glm['best_lambda']} best_metric={glm['best_metric']:.9g} "
          f"bit_identical_to_path_8={json.dumps(glm_same)} card={card}", flush=True)
    if not all(glm_same.values()):
        bad.append(f"cli glm differs from path 8: {glm_same}")
    print(f"path 10: write_s={stats['write_s']:.4f} index_s={stats['index_s']:.4f} "
          f"train_s={stats['train_s']:.4f} score_s={stats['score_s']:.4f} "
          f"glm_s={stats['glm_s']:.4f} launches={json.dumps(launches)} card={card}",
          flush=True)
    if bad:
        raise RuntimeError(f"path 10: bad result: {bad}")
    return launches, stats


def make_northstar_problem(seed: int, n_rows: int):
    """bench_northstar.py's data (its generator at :47-83 and the planted
    model drawn in ``_run``, the same draws in the same order from
    ``seed``): ``n_rows`` training rows, then NS_VAL validation rows. Each
    split is (users, movies, labels, logits, shards): ``movieFeatures``
    (NS_FE_NNZ of NS_FE_SPACE per movie), ``movieCtx`` (the movie's NS_CTX
    embedding) and ``userCtx`` (the user's), each in its own column space."""
    from photon_ml_tpu_torch.game import FeatureShard

    rng = np.random.default_rng(seed)
    movie_cols = rng.integers(0, NS_FE_SPACE, size=(NS_MOVIES, NS_FE_NNZ)).astype(np.int32)
    movie_vals = rng.normal(size=(NS_MOVIES, NS_FE_NNZ))
    emb_m = rng.normal(size=(NS_MOVIES, NS_CTX)) * 0.7
    emb_u = rng.normal(size=(NS_USERS, NS_CTX)) * 0.7
    w_g = rng.normal(size=NS_FE_SPACE) * 0.4
    a_u = rng.normal(size=(NS_USERS, NS_CTX)) * 0.4
    b_m = rng.normal(size=(NS_MOVIES, NS_CTX)) * 0.4
    splits = []
    for n in (n_rows, NS_VAL):
        users = rng.integers(0, NS_USERS, size=n)
        movies = rng.integers(0, NS_MOVIES, size=n)
        logit = (np.einsum("ij,ij->i", movie_vals[movies], w_g[movie_cols[movies]])
                 + np.einsum("ij,ij->i", emb_m[movies], a_u[users])
                 + np.einsum("ij,ij->i", emb_u[users], b_m[movies]))
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float64)
        rows = np.repeat(np.arange(n, dtype=np.int64), NS_CTX)
        ctx_cols = np.tile(np.arange(NS_CTX, dtype=np.int64), n)
        shards = {
            "movieFeatures": FeatureShard.from_coo(
                movie_vals[movies].ravel(), np.repeat(np.arange(n, dtype=np.int64), NS_FE_NNZ),
                movie_cols[movies].ravel(), NS_FE_SPACE),
            "movieCtx": FeatureShard.from_coo(emb_m[movies].ravel(), rows, ctx_cols, NS_CTX),
            "userCtx": FeatureShard.from_coo(emb_u[users].ravel(), rows, ctx_cols, NS_CTX),
        }
        splits.append((users, movies, y, logit, shards))
    return splits


def planted_auc(logit: np.ndarray, y: np.ndarray) -> float:
    """The planted model's AUC on its own draws (bench_northstar.py's
    ceiling): the rank-sum form over the logits."""
    ranks = np.empty(len(logit))
    ranks[np.argsort(logit)] = np.arange(1, len(logit) + 1)
    pos = y > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def northstar_config() -> dict:
    """bench_northstar.py:186-231's coordinates, evaluators and schedule, as
    the JSON document ``parse_game_config`` reads."""
    def opt(kind: str, iters: int) -> dict:
        return {"type": kind, "max_iterations": iters, "tolerance": 1e-7,
                "regularization": "l2", "regularization_weight": 1.0}

    return {"task": "logistic", "num_iterations": 1, "evaluators": ["auc"], "coordinates": {
        "fixed": {"type": "fixed_effect", "shard_name": "movieFeatures",
                  "optimizer": opt("lbfgs", 10)},
        "per-user": {"type": "random_effect", "shard_name": "movieCtx", "id_name": "userId",
                     "optimizer": opt("newton", 8), "active_rows_per_entity": 256},
        "per-movie": {"type": "random_effect", "shard_name": "userCtx", "id_name": "movieId",
                      "optimizer": opt("newton", 8), "active_rows_per_entity": 256},
        "mf": {"type": "factored_random_effect", "shard_name": "movieCtx", "id_name": "userId",
               "latent_dim": 2, "mf_iterations": 1, "optimizer": opt("lbfgs", 8),
               "latent_optimizer": opt("lbfgs", 8), "active_rows_per_entity": 32},
    }}


def _model_tensors(model) -> dict:
    """Every tensor of a GAME model, by name, for a bit-for-bit comparison."""
    out = {}
    for name, sub in model.models.items():
        if hasattr(sub, "coefficients"):
            out[name] = sub.coefficients
        for i, b in enumerate(getattr(sub, "buckets", ())):
            out[f"{name}/{i}"] = b.coefficients
        if hasattr(sub, "latent"):
            out[f"{name}/latent"] = sub.latent
            out[f"{name}/projection"] = sub.projection.matrix
    return out


def run_northstar_path(seed: int, card: str) -> tuple[dict, dict]:
    """Path 11: BASELINE config #5 (bench_northstar.py: a fixed effect, a
    per-user and a per-movie random effect, and the factored ``mf``
    coordinate) at its full width through ``GameEstimator.fit``, with one
    estimator for three fits that share its random-effect datasets: fit A
    uninterrupted with ``output_dir``; fit B with a checkpoint every step and
    a stop after the second update; fit C resumed from B's checkpoint. Fails
    unless the validation AUC rises from ``fixed`` to ``per-user`` to
    ``per-movie`` (the ``mf`` update's change is printed: it lowers the AUC
    here, as it does in the JAX package); the ``mf`` update launched ``csr_margins`` and ``csc_scatter`` and its
    tracker holds one MF step whose latent solves cover every entity with no
    lane above its value at zero, and whose refit took at least one
    iteration and lowered its value; the saved final model scores the
    validation rows bit for bit as the fitted one, and two scorings agree;
    B stops at step 1 with its manifest on disk; C restores step 1, runs
    steps 2 and 3 only, and ends bit-identical to A, tensor for tensor, with
    A's AUC. Everything it writes goes at the end."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.config import parse_game_config
    from photon_ml_tpu_torch.data.model_store import load_game_model
    from photon_ml_tpu_torch.game import (
        CheckpointSpec,
        GameEstimator,
        TrainingInterrupted,
        build_game_dataset,
    )

    stats, bad = {"card": card, "rows": NS_ROWS}, []
    t0 = time.perf_counter()
    (users, movies, y, _, shards), (v_users, v_movies, v_y, v_logit, v_shards) = \
        make_northstar_problem(seed, NS_ROWS)
    stats["ceiling_auc"] = planted_auc(v_logit, v_y)
    stats["generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gds = build_game_dataset(y, shards, id_columns={"userId": users, "movieId": movies})
    vds = build_game_dataset(v_y, v_shards, id_columns={"userId": v_users, "movieId": v_movies})
    gds.csr_batch("movieFeatures")
    torch.cuda.synchronize()
    stats["dataset_s"] = time.perf_counter() - t0
    del users, movies, y, shards, v_users, v_movies, v_y, v_logit, v_shards
    print(f"path 11 data: rows={NS_ROWS} validation_rows={NS_VAL} users={NS_USERS} "
          f"movies={NS_MOVIES} generate_s={stats['generate_s']:.4f} "
          f"dataset_s={stats['dataset_s']:.4f} ceiling_auc={stats['ceiling_auc']:.6f} "
          f"card={card}", flush=True)

    config = parse_game_config(northstar_config())
    est = GameEstimator(config)
    stats["re_build_s"] = {}
    for name, c in config.coordinates.items():
        if hasattr(c, "id_name"):
            t0 = time.perf_counter()
            red = est._re_dataset(gds, c)
            stats["re_build_s"][name] = time.perf_counter() - t0
            print(f"path 11 re build {name}: seconds={stats['re_build_s'][name]:.4f} "
                  f"entities={sum(b.num_entities for b in red.buckets)} "
                  f"buckets={len(red.buckets)} passive_rows={len(red.passive_rows)} "
                  f"card={card}", flush=True)

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=build_dir)
    try:
        # fit A, uninterrupted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        telemetry.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fit_a = est.fit(gds, validation_data=vds, output_dir=os.path.join(work, "a"))
        torch.cuda.synchronize()
        stats["fit_a_s"] = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        spans = telemetry.snapshot()["span_seconds"]
        stats["kron_structure_s"] = spans.get("factored_kron_structure", 0.0)
        stats["build_coordinates_s"] = spans.get("build_coordinates", 0.0)
        mf = est._coordinates[(id(gds), "mf")][1]
        stats["kron_nnz"] = mf.kron_nnz
        aucs, updates = [], []
        for e in fit_a.history:
            aucs.append(e["metrics"]["auc"])
            updates.append({"coordinate": e["coordinate"], "seconds": e["seconds"],
                            "host_syncs": e["host_syncs"], "auc": e["metrics"]["auc"],
                            "launches": {k: n for k, n in e["launches"].items() if n}})
            print(f"path 11 fit A {e['coordinate']}: auc={e['metrics']['auc']:.6f} "
                  f"seconds={e['seconds']:.4f} host_syncs={e['host_syncs']} "
                  f"launches={json.dumps(updates[-1]['launches'])} card={card}", flush=True)
        stats.update(updates=updates, aucs=aucs, mf_auc_change=aucs[3] - aucs[2])
        # the mf update lowers the validation AUC of this configuration in
        # the JAX package too (tests/test_torch_factored.py holds the port
        # to the reference's AUC after each update), so only the order of
        # the first three updates is checked here, and mf's AUC is printed
        if not (aucs[0] < aucs[1] < aucs[2] and np.isfinite(aucs[3])):
            bad.append(f"the validation AUC does not rise as it should: {aucs}")
        print(f"path 11 mf: validation auc change {aucs[3] - aucs[2]:+.6f} from per-movie "
              f"(the JAX package's change on this generator's data at 40K and 400K rows: "
              f"-0.019824, -0.023000)", flush=True)
        mf_launches = fit_a.history[3]["launches"]
        if not (mf_launches["csr_margins"] and mf_launches["csc_scatter"]):
            bad.append(f"the mf update did not launch csr_margins and csc_scatter: "
                       f"{mf_launches}")
        tracker = mf.last_tracker
        lane_results = [r for r in mf.last_results if r.value.dim() == 1]
        lat_res = mf.last_results[-1]
        (re_t, fe_t), = tracker.steps
        rose = sum(int((r.value > r.values[:, 0]).sum()) for r in lane_results)
        lat_start = float(lat_res.values[0])
        stats["mf_tracker"] = {"entities": len(re_t.iterations), "n_flat": mf._n_flat,
                               "lanes_rose": rose,
                               "reasons": re_t.count_convergence_reasons(),
                               "matrix_iterations": fe_t.iterations,
                               "matrix_reason": fe_t.reason,
                               "matrix_value": fe_t.final_value, "matrix_value0": lat_start}
        print(f"path 11 mf tracker:\n{tracker.to_summary_string()}", flush=True)
        print(f"path 11 mf: kron_nnz={mf.kron_nnz} {json.dumps(stats['mf_tracker'])}",
              flush=True)
        if len(re_t.iterations) != mf._n_flat or rose:
            bad.append(f"the mf latent solves: {len(re_t.iterations)} lanes of {mf._n_flat}, "
                       f"{rose} rose above their value at zero")
        if not (fe_t.iterations >= 1 and fe_t.final_value < lat_start):
            bad.append(f"the mf latent refit: {fe_t.iterations} iterations, value "
                       f"{fe_t.final_value} from {lat_start}")
        loaded = load_game_model(os.path.join(work, "a", "final"))
        scored = [fit_a.model.score(vds) for _ in range(2)]
        same = {"reloaded": torch.equal(loaded.score(vds), scored[0]),
                "twice": torch.equal(*scored)}
        stats["bit_identical"] = same
        if not all(same.values()):
            bad.append(f"validation scores differ: {same}")
        del loaded, scored

        # fit B: a checkpoint every step, stopped after the second update
        ckpt = os.path.join(work, "ckpt")
        spec = CheckpointSpec(directory=ckpt, every=1)
        polls = []

        def stop_after_two() -> bool:
            polls.append(1)
            return len(polls) >= 2

        telemetry.reset()
        t0 = time.perf_counter()
        stopped = None
        try:
            est.fit(gds, validation_data=vds, checkpoint_spec=spec, should_stop=stop_after_two)
        except TrainingInterrupted as e:
            stopped = e
        stats["fit_b_s"] = time.perf_counter() - t0
        stats["fit_b_save_s"] = telemetry.snapshot()["span_seconds"].get("checkpoint:save", 0.0)
        manifest = os.path.join(ckpt, "step-00000001", "manifest.json")
        stats["fit_b"] = {"stopped_at": None if stopped is None else stopped.step,
                          "manifest": os.path.exists(manifest)}
        if stopped is None or stopped.step != 1 or not os.path.exists(manifest):
            bad.append(f"fit B did not stop at step 1 with its manifest: {stats['fit_b']}")

        # fit C: resumed from fit B's checkpoint
        telemetry.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fit_c = est.fit(gds, validation_data=vds, checkpoint_spec=spec)
        torch.cuda.synchronize()
        stats["fit_c_s"] = time.perf_counter() - t0
        counters = telemetry.snapshot()["counters"]
        stats["fit_c_save_s"] = telemetry.snapshot()["span_seconds"].get("checkpoint:save", 0.0)
        ran = [e["coordinate"] for e in fit_c.history if "results" in e]
        a_t, c_t = _model_tensors(fit_a.model), _model_tensors(fit_c.model)
        identical = sorted(a_t) == sorted(c_t) and all(torch.equal(a_t[k], c_t[k]) for k in a_t)
        stats["fit_c"] = {"restores": counters.get("checkpoint.restores", 0), "ran": ran,
                          "bit_identical_to_a": identical,
                          "auc": fit_c.history[-1]["metrics"]["auc"]}
        if not (stats["fit_c"]["restores"] == 1 and ran == ["per-movie", "mf"]):
            bad.append(f"fit C did not resume at step 2: {stats['fit_c']}")
        if not identical or stats["fit_c"]["auc"] != aucs[-1]:
            diff = [k for k in a_t if k in c_t and not torch.equal(a_t[k], c_t[k])]
            bad.append(f"the resumed fit differs from the uninterrupted one: {diff}, auc "
                       f"{stats['fit_c']['auc']} vs {aucs[-1]}")
        print(f"path 11 checkpoints: fit_b={json.dumps(stats['fit_b'])} "
              f"fit_c={json.dumps(stats['fit_c'])} fit_b_s={stats['fit_b_s']:.4f} "
              f"fit_c_s={stats['fit_c_s']:.4f} save_s(b)={stats['fit_b_save_s']:.4f} "
              f"save_s(c)={stats['fit_c_save_s']:.4f} card={card}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"path 11: fit_a_s={stats['fit_a_s']:.4f} "
          f"re_build_s={json.dumps(stats['re_build_s'])} "
          f"kron_structure_s={stats['kron_structure_s']:.4f} kron_nnz={stats['kron_nnz']} "
          f"max_memory_allocated={stats['max_memory_allocated']} aucs={aucs} "
          f"ceiling_auc={stats['ceiling_auc']:.6f} bit_identical={json.dumps(same)} "
          f"launches={json.dumps(launches)} card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 11: bad result: {bad}")
    return launches, stats


def run_probe_path(seed: int) -> tuple[dict, dict]:
    """Path 7: the ELL probe's entry point at bench.py's shape. Fails unless
    the ELL kernel launched and agrees with CSR ``dot_rows``."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.tools import probe_ell

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = probe_ell.run_probe(seed=seed)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"path 7: ell_ms={res['ell_ms']:.4f} csr_ms={res['csr_ms']:.4f} "
          f"csr_over_ell={res['csr_over_ell']:.4f} max_abs_err={res['max_abs_err']:.3e} "
          f"max_rel_err={res['max_rel_err']:.3e} limit={KERNEL_REL_TOL:.0e} "
          f"launches={json.dumps(launches)}", flush=True)
    if launches["ell_margins"] == 0:
        raise RuntimeError("path 7: kernels not launched: ['ell_margins']")
    if not res["max_rel_err"] <= KERNEL_REL_TOL:
        raise RuntimeError("path 7: ELL and CSR dot_rows disagree")
    return launches, res


def check_lane_kernels(batch, w) -> list[dict]:
    """Phase 3, the lane kernels at config #1 with G = SWEEP_LANES vectors:
    each variant against its plain version and against a second launch, and
    every lane against the single-vector kernel on that lane's vector, bit
    for bit; timed beside G launches of the single kernel and the library's
    sparse product."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference

    n, f, nnz, G = batch.num_rows, batch.num_features, batch.nnz, SWEEP_LANES
    gen = torch.Generator(device="cuda").manual_seed(12)
    W = torch.randn(G, f, generator=gen, device="cuda") * 0.1
    W[0] = w
    R = torch.randn(G, n, generator=gen, device="cuda")
    off = torch.randn(G, n, generator=gen, device="cuda") * 0.1
    shift = torch.randn(G, generator=gen, device="cuda")
    csr, csc, tiles = batch._csr, batch._csc, batch.tiles
    plain_csc = batch.column_major()

    def margins(label, off_g, sh, use):
        per_lane = off_g.dim() == 2
        return (label, lambda: kernels.csr_margins_lanes(*csr, W, off_g, sh, use),
                lambda: reference.csr_margins_lanes(*csr, W, off_g, sh, use),
                lambda g: kernels.csr_margins(*csr, W[g], off_g[g] if per_lane else off_g,
                                              sh[g:g + 1] if isinstance(sh, torch.Tensor)
                                              else sh, use))

    def scatter(label, r, square):
        return (label, lambda: kernels.csc_scatter_lanes(*csc, r, square, tiles),
                lambda: reference.csc_scatter_lanes(*plain_csc, r, square),
                lambda g: kernels.csc_scatter(*csc, r[g], square, tiles))

    variants = {
        "csr_margins_lanes": [margins("dot_rows", batch.offsets, 0.0, False),
                              margins("margins+offsets+shift per lane", off, shift, True)],
        "csc_scatter_lanes": [scatter("scatter", R, False), scatter("scatter_sq", R.abs(), True)],
    }
    t_w, t_r = W.t().contiguous(), R.t().contiguous()
    specs = {
        "csr_margins_lanes": (
            "photon_ml_tpu_torch/csrc/margins_lanes.cu", "photon_ml_tpu/ops/tiled.py:170",
            "dot_rows", 4 * ((n + 1) + 2 * nnz + G * f + G * n), 2 * nnz * G,
            library_ms(lambda: torch.sparse_csr_tensor(*csr, size=(n, f),
                                                       check_invariants=False),
                       lambda m: torch.sparse.mm(m, t_w))),
        "csc_scatter_lanes": (
            "photon_ml_tpu_torch/csrc/scatter_lanes.cu", "photon_ml_tpu/ops/tiled.py:199",
            "scatter", 4 * ((f + 1) + 2 * nnz + G * n + G * f), 2 * nnz * G,
            library_ms(lambda: torch.sparse_csr_tensor(*plain_csc, size=(f, n),
                                                       check_invariants=False),
                       lambda m: torch.sparse.mm(m, t_r))),
    }
    rows = []
    for name, cases in variants.items():
        for label, run_lanes, _, run_single in cases:
            got = run_lanes()
            same = all(torch.equal(got[g], run_single(g)) for g in range(G))
            print(f"check {name}[{label}]: each of {G} lanes bit-identical to the single "
                  f"kernel: {same}", flush=True)
            if not same:
                raise RuntimeError(f"{name}[{label}]: a lane differs from the single kernel")
        worst, timed = run_variants(name, [c[:3] for c in cases])
        label = specs[name][2]
        run_single = next(c[3] for c in cases if c[0] == label)
        singles_ms = device_ms(lambda: [run_single(g) for g in range(G)], reps=10)
        print(f"time {name}[{label}]: {G} single launches ms={singles_ms:.4f}", flush=True)
        src, replaces, label, nbytes, flops, lib = specs[name]
        rows.append(kernel_row(name, src, replaces, worst, timed, label, nbytes, flops, lib,
                               lanes=G, singles_ms=singles_ms,
                               vmapped_at="photon_ml_tpu/sweep/runner.py:91-116",
                               lanes_bit_identical_to_single=True))
    return rows


def run_sweep_path(batch, card: str) -> tuple[dict, dict]:
    """Path 12: bench_sweep.py at BASELINE config #1 through ``sweep_glm``: 16
    lambdas ``np.logspace(2, -4, 16)``, LBFGS 20 iterations at tolerance 0,
    cold lanes (``warm_start=False``), timed beside one ``train_glm`` fit at
    the first lambda (each warmed by an untimed call, then timed, as
    bench_sweep.py times them);
    ``sweep_over_single_ratio`` = sweep_s / single_s. Lanes 0, 8 and 15 are
    held against independent fits (the same reason and iterations but on
    plateau lanes, the loss within LOSS_RTOL), then the warm-started sweep (2
    rounds) runs: no lane's value may rise above the cold sweep's. The lane
    kernels must have launched in the cold sweep."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.sweep import sweep_glm
    from photon_ml_tpu_torch.training import train_glm

    cfg = solver_config("lbfgs", 20)
    lams = tuple(float(v) for v in np.logspace(2, -4, SWEEP_LANES))
    train_glm(batch, "logistic", [lams[0]], cfg)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_glm(batch, "logistic", [lams[0]], cfg)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0

    sweep_glm(batch, "logistic", lams, cfg, warm_start=False)  # warm-up
    torch.cuda.synchronize()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cold = sweep_glm(batch, "logistic", lams, cfg, warm_start=False)
    cold_values = cold.values.cpu().numpy()
    sweep_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    ratio = sweep_s / max(single_s, 1e-9)

    bad, parity = [], []
    for g in (0, SWEEP_LANES // 2, SWEEP_LANES - 1):
        ind = train_glm(batch, "logistic", [lams[g]], cfg)[0].result
        values = ind.values.numpy().astype(np.float64)
        it = int(ind.iterations)
        plateau = bool(abs(values[it] - values[it - 1]) <= PLATEAU_RTOL * abs(values[0]))
        rel = abs(float(cold_values[g]) - float(ind.value)) / abs(float(ind.value))
        row = {"lane": g, "lambda": lams[g], "sweep_iterations": int(cold.iterations[g]),
               "fit_iterations": it,
               "sweep_reason": CONVERGENCE_REASON_NAMES[int(cold.reasons[g])],
               "fit_reason": CONVERGENCE_REASON_NAMES[int(ind.reason)],
               "sweep_value": float(cold_values[g]), "fit_value": float(ind.value),
               "rel_err": rel, "plateau": plateau}
        parity.append(row)
        print(f"path 12 lane {json.dumps(row)}", flush=True)
        if not rel <= LOSS_RTOL:
            bad.append(f"lane {g}: loss {cold_values[g]} vs independent fit {float(ind.value)}")
        if not plateau and (row["sweep_iterations"], row["sweep_reason"]) != (
                it, row["fit_reason"]):
            bad.append(f"lane {g}: iterations/reason differ from the independent fit")

    t0 = time.perf_counter()
    warm = sweep_glm(batch, "logistic", lams, cfg, warm_start=True)
    warm_values = warm.values.cpu().numpy()
    warm_s = time.perf_counter() - t0
    rose = [g for g in range(SWEEP_LANES) if warm_values[g] > cold_values[g]]
    if warm.rounds != 2 or rose:
        bad.append(f"the warm-started sweep (rounds {warm.rounds}) rose on lanes {rose}")
    finite = bool(np.isfinite(cold_values).all()) and bool(cold.w.isfinite().all())
    if not finite:
        bad.append("non-finite sweep values or coefficients")
    stats = {"single_s": single_s, "sweep_s": sweep_s, "sweep_over_single_ratio": ratio,
             "warm_s": warm_s, "host_syncs": syncs, "lambdas": list(lams),
             "iterations": cold.iterations.tolist(), "reasons": cold.reason_names(),
             "cold_values": cold_values.tolist(), "warm_values": warm_values.tolist(),
             "parity": parity, "card": card}
    print(f"path 12: sweep_over_single_ratio={ratio:.4f} single_s={single_s:.4f} "
          f"sweep_s={sweep_s:.4f} warm_sweep_s={warm_s:.4f} lanes={SWEEP_LANES} "
          f"host_syncs={syncs} warm_not_above_cold={not rose} launches={json.dumps(launches)} "
          f"card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 12: bad result: {bad}")
    missing = [k for k in ("csr_margins_lanes", "csc_scatter_lanes") if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path 12: kernels not launched: {missing}")
    return launches, stats


def run_bootstrap_path(seed: int, batch, card: str) -> tuple[dict, dict]:
    """Path 12c: ``bootstrap_random_effect`` at bench_diagnostics.py's
    geometry (BOOT_ENTITIES entities x BOOT_ROWS rows x BOOT_FEATURES
    features, its draws, NEWTON 10 iterations, L2 1), B = BOOT_SAMPLES
    against the one-lane fit (identity weights), each warmed and then the
    best of 3 reps with w0 perturbed, as bench_diagnostics.py times them:
    ``bootstrap_overhead_ratio`` = bootstrap_s / single_s; the same call on
    BOOT_GATHERED gathered entities, with the full draw's weights for them,
    must give the full run's coefficients on those entities bit for bit.
    Then ``bootstrap_train`` at config #1 with B = GLM_BOOTSTRAP_SAMPLES (cli
    glm's default): finite coefficient summaries; the lane kernels must have
    launched."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.diagnostics.bootstrap import (
        bootstrap_random_effect,
        bootstrap_re_weights,
        bootstrap_train,
    )
    from photon_ml_tpu_torch.ops.dense import DenseBatch
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )

    rng = np.random.default_rng(seed)
    E, R, K, B = BOOT_ENTITIES, BOOT_ROWS, BOOT_FEATURES, BOOT_SAMPLES
    x = rng.normal(size=(E, R, K))
    w_true = rng.normal(size=(E, K)) * 0.5
    y = rng.random((E, R)) < 1.0 / (1.0 + np.exp(-np.einsum("erk,ek->er", x, w_true)))
    ebatch = DenseBatch.from_arrays(x, y.astype(np.float64))
    w0 = torch.zeros((E, K), dtype=torch.float32, device="cuda")
    config = OptimizerConfig(optimizer_type=OptimizerType.NEWTON, max_iterations=10,
                             tolerance=1e-7,
                             regularization=RegularizationContext(RegularizationType.L2),
                             regularization_weight=1.0)
    single_lanes = np.ones((1, E, R), np.float32)
    boot_lanes = bootstrap_re_weights(B, np.ones((E, R), np.float32), seed=0)

    def timed(lane_weights):
        bootstrap_random_effect(ebatch, "logistic", config, w0, lane_weights=lane_weights)
        best = report = None
        for rep in range(1, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = bootstrap_random_effect(ebatch, "logistic", config, w0 + 1e-6 * rep,
                                             lane_weights=lane_weights)
            elapsed = time.perf_counter() - t0
            best = elapsed if best is None else min(best, elapsed)
        return best, report

    kernels.reset_launch_counts()
    single_s, _ = timed(single_lanes)
    boot_s, full = timed(boot_lanes)
    ratio = boot_s / max(single_s, 1e-9)
    full = bootstrap_random_effect(ebatch, "logistic", config, w0, lane_weights=boot_lanes)
    idx = np.sort(np.random.default_rng(seed + 12).choice(E, BOOT_GATHERED, replace=False))
    t0 = time.perf_counter()
    part = bootstrap_random_effect(
        DenseBatch.from_arrays(x[idx], y[idx].astype(np.float64)), "logistic", config,
        w0[torch.from_numpy(idx).cuda()], lane_weights=boot_lanes[:, idx])
    gathered_s = time.perf_counter() - t0
    gathered_same = bool(np.array_equal(part.samples, full.samples[:, idx]))

    cfg = dataclasses.replace(solver_config("lbfgs", 20), regularization_weight=1.0)
    t0 = time.perf_counter()
    fe = bootstrap_train(batch, "logistic", cfg, num_samples=GLM_BOOTSTRAP_SAMPLES)
    torch.cuda.synchronize()
    fe_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    summaries = fe.coefficient_summaries
    fe_finite = len(summaries) == batch.num_features and all(
        np.isfinite([s.mean, s.std_dev, s.min, s.max]).all() for s in summaries)
    bad = []
    if not gathered_same:
        bad.append("gathered entity lanes differ from the full run")
    if not fe_finite:
        bad.append("non-finite coefficient summaries in bootstrap_train")
    if not np.isfinite(full.samples).all():
        bad.append("non-finite random-effect bootstrap coefficients")
    stats = {"single_s": single_s, "bootstrap_s": boot_s, "bootstrap_overhead_ratio": ratio,
             "gathered_s": gathered_s, "gathered_bit_identical": gathered_same,
             "re_summary": full.summary(), "fe_bootstrap_s": fe_s,
             "fe_significant": int(len(fe.significant_coefficients())),
             "fe_metrics": {k: s.mean for k, s in fe.metric_summaries.items()}, "card": card}
    print(f"path 12c: bootstrap_overhead_ratio={ratio:.4f} single_s={single_s:.4f} "
          f"bootstrap_s={boot_s:.4f} samples={B} entities={E} rows={R} features={K} "
          f"gathered={BOOT_GATHERED} gathered_s={gathered_s:.4f} "
          f"gathered_bit_identical={gathered_same} re_summary={json.dumps(full.summary())} "
          f"fe_bootstrap_s={fe_s:.4f} fe_samples={GLM_BOOTSTRAP_SAMPLES} "
          f"fe_significant={stats['fe_significant']} launches={json.dumps(launches)} "
          f"card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 12c: bad result: {bad}")
    missing = [k for k in ("csr_margins_lanes", "csc_scatter_lanes") if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path 12c: kernels not launched: {missing}")
    return launches, stats


def _game_split(seed: int):
    """Path 6's draws with every tenth row held out: the (train, validation)
    GameDatasets, interleaved as tests/test_sweep.py's split."""
    from photon_ml_tpu_torch.game import FeatureShard, build_game_dataset

    fe_vals, _, fe_cols, users, Xu, y = make_game_problem(seed)
    held = np.arange(N_ROWS) % 10 == 9

    def subset(mask):
        idx = np.flatnonzero(mask)
        m = len(idx)
        rows = np.repeat(np.arange(m, dtype=np.int64), NNZ_PER_ROW)
        xu = Xu[idx]
        ru, cu = np.nonzero(xu)
        return build_game_dataset(y[idx], {
            "global": FeatureShard.from_coo(fe_vals.reshape(N_ROWS, NNZ_PER_ROW)[idx].ravel(),
                                            rows, fe_cols.reshape(N_ROWS, NNZ_PER_ROW)[idx]
                                            .ravel(), N_FEATURES),
            "user": FeatureShard.from_coo(xu[ru, cu], ru, cu, GAME_RE_FEATURES),
        }, id_columns={"userId": users[idx]})

    return subset(~held), subset(held)


def _game_sweep_config(fe_lambda: float = 1.0):
    import dataclasses as dc

    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.optim.factory import OptimizerType

    opt = dc.replace(solver_config("lbfgs", 20), regularization_weight=fe_lambda)
    re_opt = dc.replace(opt, optimizer_type=OptimizerType.NEWTON, tolerance=1e-7,
                        regularization_weight=1.0)
    return GameConfig(task="logistic", num_iterations=GAME_CD_ITERATIONS, evaluators=["auc"],
                      coordinates={
                          "fixed": FixedEffectConfig(shard_name="global", optimizer=opt),
                          "per-user": RandomEffectConfig(shard_name="user", id_name="userId",
                                                         optimizer=re_opt)})


def run_sweep_game_path(seed: int, card: str) -> tuple[dict, dict]:
    """Path 12b: ``GameEstimator.fit_sweep`` at BASELINE config #4 (path 6's
    draws and coordinates, every tenth row held out), the grid
    GAME_SWEEP_GRID for both coordinates, 2 CD iterations, selected on
    ``auc``. Fails unless the winner saved under ``best/`` reloads and
    scores bit for bit, the winning lane's validation AUC is within 1e-3 of
    ``GameEstimator.fit`` at the winning lambda, ``fit_grid`` over two fixed
    effects (L2 1 and 10) returns its entries best-first, each bit for bit
    the ``fit`` of its combination, the lane kernels launched in the sweep
    and the single ones in ``fit_grid``."""
    import dataclasses as dc

    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.data.model_store import load_game_model
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.sweep import parse_sweep_spec

    t0 = time.perf_counter()
    train, val = _game_split(seed)
    setup_s = time.perf_counter() - t0
    grid = parse_sweep_spec(GAME_SWEEP_GRID)
    config = _game_sweep_config()
    bad = []

    def val_auc(model):
        return float(auc(model.score(val) + val.per_row(val.offset), val.per_row(val.response),
                         val.per_row(val.weight)))

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    with tempfile.TemporaryDirectory(dir=build_dir) as out:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fs = GameEstimator(config).fit_sweep(train, val, grid, metric="auc", output_dir=out)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        sweep_launches = dict(kernels.LAUNCHES)
        loaded = load_game_model(os.path.join(out, "best"))
        reloaded_same = torch.equal(loaded.score(val), fs.model.score(val))
    sel = fs.selection
    lam = grid.default[sel.index]
    conv = fs.sweep.convergence()
    print(f"path 12b sweep: sweep_s={sweep_s:.4f} selected_index={sel.index} lambda={lam:.6g} "
          f"auc={sel.best_value:.9g} aucs={json.dumps(sel.to_json()['values'])} "
          f"fe_iterations={conv['fixed']['iterations'].tolist()} "
          f"re_iterations={conv['per-user']['iterations'].tolist()} "
          f"best_reloaded_bit_identical={reloaded_same} launches={json.dumps(sweep_launches)}",
          flush=True)
    if not reloaded_same:
        bad.append("the winner saved under best/ scores differently when loaded")
    t0 = time.perf_counter()
    winner_cfg = dc.replace(config, coordinates={
        name: dc.replace(c, optimizer=dc.replace(c.optimizer, regularization_weight=lam))
        for name, c in config.coordinates.items()})
    donor = GameEstimator(winner_cfg)
    fit_auc = val_auc(donor.fit(train).model)
    fit_s = time.perf_counter() - t0

    def estimator(cfg):
        # the random-effect dataset depends on the data, the id and shard
        # and the caps, never on the optimizer: one host build serves the
        # fits below
        est = GameEstimator(cfg)
        est._re_datasets = dict(donor._re_datasets)
        return est

    print(f"path 12b winner: fit at lambda {lam:.6g} auc={fit_auc:.9g} vs the lane's "
          f"{sel.best_value:.9g} fit_s={fit_s:.4f}", flush=True)
    if not abs(fit_auc - sel.best_value) <= 1e-3:
        bad.append(f"the winning lane's auc {sel.best_value} vs fit {fit_auc}")

    fe_opt = config.coordinates["fixed"].optimizer
    combos = [dc.replace(fe_opt, regularization_weight=v) for v in (1.0, 10.0)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    entries = estimator(config).fit_grid(train, val, {"fixed": combos})
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    grid_launches = dict(kernels.LAUNCHES)
    metrics = [e.result.best_metric for e in entries]
    if metrics != sorted(metrics, reverse=True):
        bad.append(f"fit_grid entries are not best-first: {metrics}")
    same = []
    for e in entries:
        cfg = dc.replace(config, coordinates={**config.coordinates, "fixed": dc.replace(
            config.coordinates["fixed"], optimizer=e.optimizer_configs["fixed"])})
        fit = estimator(cfg).fit(train, validation_data=val)
        same.append(fit.best_metric == e.result.best_metric
                    and torch.equal(fit.model.score(val), e.result.model.score(val)))
    print(f"path 12b grid: grid_s={grid_s:.4f} metrics={metrics} "
          f"lambdas={[e.optimizer_configs['fixed'].regularization_weight for e in entries]} "
          f"entries_bit_identical_to_fit={same} launches={json.dumps(grid_launches)}",
          flush=True)
    if not all(same):
        bad.append(f"fit_grid entries differ from fit: {same}")
    launches = {k: sweep_launches[k] + grid_launches[k] for k in sweep_launches}
    stats = {"setup_s": setup_s, "sweep_s": sweep_s, "selected_index": sel.index,
             "selected_lambda": lam, "selected_auc": sel.best_value, "aucs": sel.to_json(),
             "fit_auc_at_winner": fit_auc, "grid_s": grid_s, "grid_metrics": metrics,
             "best_reloaded_bit_identical": reloaded_same, "grid_bit_identical": same,
             "card": card}
    print(f"path 12b: setup_s={setup_s:.4f} sweep_s={sweep_s:.4f} grid_s={grid_s:.4f} "
          f"card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 12b: bad result: {bad}")
    missing = [k for k in ("csr_margins_lanes", "csc_scatter_lanes")
               if sweep_launches[k] == 0] + [
        k for k in ("csr_margins", "csc_scatter") if grid_launches[k] == 0]
    if missing:
        raise RuntimeError(f"path 12b: kernels not launched: {missing}")
    return launches, stats


def run_sweep_cli_path(card: str, work: str, glm_ref: dict) -> tuple[dict, dict]:
    """Path 12d, after path 10 and on its files: ``cli glm`` in process on
    path 8's LIBSVM files with ``"diagnostics": true`` (both report files
    written, the stages ending DIAGNOSED, the VALIDATED results bit for bit
    path 8's), and ``cli sweep`` in process on path 10's Avro files (the
    first three for training, the fourth for validation, the grid
    CLI_SWEEP_GRID): its selected index and metric must equal an in-process
    ``fit_sweep`` on the datasets the driver read."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.cli import train as cli_train
    from photon_ml_tpu_torch.config import parse_game_config
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.sweep import parse_sweep_spec

    bad, stats = [], {"card": card}
    with open(os.path.join(work, "glm.json")) as fh:
        glm_cfg = json.load(fh)
    glm_out = os.path.join(work, "glm_diagnosed")
    glm_cfg.update(diagnostics=True, output_dir=glm_out)
    cfg_path = os.path.join(work, "glm_diagnosed.json")
    with open(cfg_path, "w") as fh:
        json.dump(glm_cfg, fh)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    glm = _run_cli_in_process(["glm", "--config", cfg_path])
    torch.cuda.synchronize()
    stats["glm_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    glm_same = {
        "stages": glm["stages"] == ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED", "DIAGNOSED"],
        "best_lambda": glm["best_lambda"] == glm_ref["best_lambda"],
        "best_metric": glm["best_metric"] == glm_ref["heldout_auc"],
        "metrics": all(
            sorted(glm["metrics"][str(lam)]) == sorted(ref)
            and all(_same_or_both_nan(glm["metrics"][str(lam)][k], v) for k, v in ref.items())
            for lam, ref in glm_ref["metrics"].items()),
        "reports": all(os.path.getsize(glm["report"][k]) > 0 for k in ("html", "text")),
    }
    stats.update(glm_same=glm_same, glm_report_bytes={
        k: os.path.getsize(p) for k, p in glm["report"].items()})
    print(f"path 12d glm: glm_s={stats['glm_s']:.4f} stages={glm['stages']} "
          f"report_bytes={json.dumps(stats['glm_report_bytes'])} "
          f"bit_identical_to_path_8={json.dumps(glm_same)} launches={json.dumps(launches)} "
          f"card={card}", flush=True)
    if not all(glm_same.values()):
        bad.append(f"cli glm with diagnostics differs from path 8: {glm_same}")

    data_dir = os.path.join(work, "avro")
    parts = [os.path.join(data_dir, f"part-{p}.avro") for p in range(4)]
    lbfgs = {"type": "lbfgs", "max_iterations": 20, "tolerance": 0.0, "regularization": "l2",
             "regularization_weight": 1.0}
    config = {"task": "logistic", "num_iterations": GAME_CD_ITERATIONS, "evaluators": ["auc"],
              "input": {"format": "avro", "paths": parts[:3], "add_intercept": False,
                        "feature_shards": {"global": ["global"], "user": ["user"]},
                        "id_columns": ["userId"]},
              "validation": {"paths": parts[3:]},
              "output_dir": os.path.join(work, "sweep_model"),
              "coordinates": {
                  "fixed": {"type": "fixed_effect", "shard_name": "global", "optimizer": lbfgs},
                  "per-user": {"type": "random_effect", "shard_name": "user",
                               "id_name": "userId",
                               "optimizer": {**lbfgs, "type": "newton", "tolerance": 1e-7}}}}
    cfg_path = os.path.join(work, "sweep.json")
    with open(cfg_path, "w") as fh:
        json.dump(config, fh)
    reads, read_input = [], cli_train.read_input

    def spy_read(*a, **k):
        reads.append(read_input(*a, **k))
        return reads[-1]

    cli_train.read_input = spy_read
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        summary = _run_cli_in_process(["sweep", "--config", cfg_path, "--sweep",
                                       CLI_SWEEP_GRID])["sweep"]
    finally:
        cli_train.read_input = read_input
    torch.cuda.synchronize()
    stats["sweep_cli_s"] = time.perf_counter() - t0
    for k, n in kernels.LAUNCHES.items():
        launches[k] += n
    (train, _), (val, _) = reads
    fs = GameEstimator(parse_game_config(config)).fit_sweep(
        train, val, parse_sweep_spec(CLI_SWEEP_GRID))
    sweep_same = {"selected_index": summary["selected_index"] == fs.selection.index,
                  "selected_metric": summary["selected_metric"] == fs.selection.best_value,
                  "best_written": os.path.exists(os.path.join(config["output_dir"], "best",
                                                              "model-metadata.json"))}
    stats.update(sweep_same=sweep_same, sweep_selected=summary["selected_index"],
                 sweep_metrics=[c["metric"] for c in summary["configs"]])
    print(f"path 12d sweep: sweep_cli_s={stats['sweep_cli_s']:.4f} train_rows={train.num_rows} "
          f"validation_rows={val.num_rows} selected_index={summary['selected_index']} "
          f"selected_metric={summary['selected_metric']:.9g} "
          f"aucs={json.dumps(stats['sweep_metrics'])} "
          f"same_as_fit_sweep={json.dumps(sweep_same)} card={card}", flush=True)
    if not all(sweep_same.values()):
        bad.append(f"cli sweep differs from fit_sweep: {sweep_same}")
    if bad:
        raise RuntimeError(f"path 12d: bad result: {bad}")
    return launches, stats


_T_START = time.perf_counter()


def mark(label: str, train: dict | None = None) -> None:
    """Print (and keep in ``train["elapsed_s"]``) the seconds since the
    script started, at the end of a phase or path."""
    t = time.perf_counter() - _T_START
    print(f"elapsed: {label} ends at {t:.2f} s", flush=True)
    if train is not None:
        train.setdefault("elapsed_s", {})[label] = t


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from photon_ml_tpu_torch.kernels import build
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.tools.probe_ell import card_line
    from photon_ml_tpu_torch.training import train_glm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    build.load_library(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    values, rows, cols, y = make_problem(args.seed, N_ROWS, N_FEATURES, NNZ_PER_ROW)
    batch = CSRBatch.from_coo(values, rows, cols, y, N_FEATURES)
    print(f"data: {N_ROWS}x{N_FEATURES}, nnz={batch.nnz}, "
          f"setup_s={time.perf_counter() - t0:.2f}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    w = torch.randn(N_FEATURES, generator=gen, device="cuda") * 0.1
    v = torch.randn(N_FEATURES, generator=gen, device="cuda")
    offsets = torch.randn(N_ROWS, generator=gen, device="cuda") * 0.1
    probe = batch.with_offsets(offsets)
    z = probe.margins(w)
    s = torch.sigmoid(z)
    d2_row = s * (1.0 - s)
    skewed = skewed_rows(args.seed)
    s_vals, s_rows, s_cols, s_n = skewed
    skewed_csr = CSRBatch.from_coo(s_vals, s_rows, s_cols, np.zeros(s_n), N_FEATURES)
    power_law = CSRBatch.from_coo(values, rows, power_law_columns(args.seed, len(values)), y,
                                  N_FEATURES)
    kernel_rows = check_kernels(probe, w, s - batch.labels, d2_row, skewed_csr, power_law)
    kernel_rows += check_fused_kernels(probe, w, v, d2_row, skewed_csr, power_law)
    kernel_rows.append(check_ell_kernel(values, rows, cols, y, w, offsets, skewed,
                                        kernel_rows[0]["library_ms"]))
    kernel_rows += check_lane_kernels(probe, w)
    mark("phase 3")
    del probe, z, s, d2_row, skewed_csr, power_law
    # Phase 3's temporaries (the column-major views among them) leave cached
    # blocks behind; release them, so that the later paths' peaks depend on
    # the paths' own allocations only, not on which blocks they happen to reuse.
    torch.cuda.empty_cache()

    check_small_parity(args.seed)
    check_small_re_parity(args.seed)
    by_path, train, prof = {}, {}, {}
    mark("phase 4", train)
    by_path["5"], train["5"] = run_path(
        "5", batch, "logistic", [10.0, 1.0], solver_config("lbfgs", 20),
        required=("csr_margins", "csc_scatter"), compute_variances=True, min_auc=0.6)
    if args.profile:
        prof["5"] = profile_solve("5", lambda: train_glm(
            batch, "logistic", [1.0], solver_config("lbfgs", 10))[0].result.iterations)
    mark("path 5", train)
    by_path["12"], train["12"] = run_sweep_path(batch, card)
    mark("path 12", train)
    by_path["12c"], train["12c"] = run_bootstrap_path(args.seed, batch, card)
    mark("path 12c", train)
    del batch
    torch.cuda.empty_cache()

    run_suite_paths(args.seed, args.profile, by_path, train, prof)
    mark("paths 5b-5e", train)

    # paths 8 and 10 share this directory (path 8's LIBSVM files); it goes
    # when the run ends, whatever its outcome
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=build_dir)
    try:
        return _run_paths(args, card, kernel_rows, work, by_path, train, prof)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run_paths(args, card: str, kernel_rows: list, work: str, by_path: dict, train: dict,
               prof: dict) -> int:
    """Paths 8, 6, 9-9c and 11b, 10, 12d, 12b, 11 and 7, then the ``kernels``
    line and the result line; ``work`` holds path 8's files for paths 10 and
    12d, and path 10's for 12d."""
    import torch

    from photon_ml_tpu_torch.tools.probe_ell import card_line

    by_path["8"], train["8"], glm_ref = run_data_plane_path(args.seed, card, work)
    torch.cuda.empty_cache()
    mark("path 8", train)

    by_path["6"], train["6"], game_prof, gds = run_game_path(args.seed, args.profile)
    if game_prof is not None:
        prof["6"] = game_prof
    mark("path 6", train)
    t0 = time.perf_counter()
    re_launches, train["9"], re_prof = run_re_path(gds, args.seed, args.profile,
                                                   train["6"]["fe_only_auc"], card)
    train["9"]["paths_s"] = time.perf_counter() - t0
    print(f"paths 9-9c: {train['9']['paths_s']:.2f} s", flush=True)
    mark("paths 9-9c, 11b", train)
    by_path.update(re_launches)
    if re_prof is not None:
        prof["9"] = re_prof
    del gds
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    by_path["10"], train["10"] = run_cli_path(args.seed, card, work, train["6"], glm_ref)
    train["10"]["path_s"] = time.perf_counter() - t0
    print(f"path 10: {train['10']['path_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    mark("path 10", train)
    t0 = time.perf_counter()
    by_path["12d"], train["12d"] = run_sweep_cli_path(card, work, glm_ref)
    train["12d"]["path_s"] = time.perf_counter() - t0
    print(f"path 12d: {train['12d']['path_s']:.2f} s", flush=True)
    mark("path 12d", train)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    by_path["12b"], train["12b"] = run_sweep_game_path(args.seed, card)
    train["12b"]["path_s"] = time.perf_counter() - t0
    print(f"path 12b: {train['12b']['path_s']:.2f} s", flush=True)
    mark("path 12b", train)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    by_path["11"], train["11"] = run_northstar_path(args.seed, card)
    train["11"]["path_s"] = time.perf_counter() - t0
    print(f"path 11: {train['11']['path_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    mark("path 11", train)
    by_path["7"], train["7"] = run_probe_path(args.seed)
    mark("path 7", train)

    for row in kernel_rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()
                                   if c[row["name"]]}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["name"] in train["9"]["largest_coo_bucket"]:
            row["re_largest_coo_bucket"] = train["9"]["largest_coo_bucket"][row["name"]]
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, "kernels": kernel_rows, "train": train,
                       "profile": prof}, fh, indent=1)

    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
