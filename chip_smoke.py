#!/usr/bin/env python3
"""Drive photon_ml_tpu_torch's GLM training paths once on one NVIDIA card.

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
     the kernels in the tile index's slot order;
  4. train at a reduced size (64K x 2K) on the card and on the CPU (plain
     versions) with LBFGS, TRON, OWLQN and box-constrained Poisson LBFGS:
     same convergence reason and iteration count, final loss within rtol 1e-4;
  5. the paths, each at full width through the entry point a user calls,
     with the kernels' launch counts zeroed just before it and read just
     after (a kernel of the path that did not launch fails the run):
       5.  bench.py config #1 through ``train_glm``: logistic, lambdas
           [10, 1], LBFGS 20 iterations at tolerance 0, with variances;
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
import sys
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


def launches_per_call(fn) -> int | None:
    """Kernel launches of one call of ``fn``, counted by torch.profiler
    (None when the profiler sees no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.name.startswith(("Memcpy", "Memset"))]
    return len(kernels) or None


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
        launches = launches_per_call(cases[0][1])
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


def run_game_path(seed: int, profile: bool) -> tuple[dict, dict, dict | None]:
    """Path 6: GLMix config #4 through ``GameEstimator.fit`` as bench_game.py
    drives it: the random-effect build timed alone, one fit that saves its
    models to ``output_dir``, then the second fit timed with the launch counts
    zeroed just before it. Fails unless the saved final model, loaded back,
    scores the dataset bit for bit as the fitted one, the
    fixed effect's margins and scatter kernels launched, its loss fell in
    every coordinate-descent iteration, every coefficient is finite, the
    GLMix model's train AUC beats its fixed effect's alone, and two scorings
    and evaluations of the model agree bit for bit."""
    import dataclasses
    import os
    import tempfile

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
    newton = []
    for entry in result.history:
        it, name = entry["iteration"], entry["coordinate"]
        if name == "fixed":
            (res,) = entry["results"]
            loss0, loss = float(res.values[0]), float(res.value)
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
    return launches, stats, prof


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


def run_data_plane_path(seed: int, card: str) -> tuple[dict, dict]:
    """Path 8: config #1's draws as LIBSVM files, through the data plane as a
    user calls it: the native parser, ``to_batch`` onto the card,
    ``validate``, ``summarize`` twice, a standardized ``train_glm`` picked by
    held-out AUC, and ``save_glm`` / ``load_glm``. Fails unless the parsed
    arrays equal the draws as written, the two summaries are bit-identical
    and within the reference test's tolerances of a float64 numpy summary,
    the scatter kernel launched in ``summarize``, the loss fell from the
    sweep's start (and no solve ended above its own start) with finite
    coefficients and train AUC above 0.6, and the loaded model's means and
    held-out scores are bit-identical to the trained one's."""
    import dataclasses
    import os
    import tempfile

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
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.training import select_best_model, train_glm

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    stats, bad = {}, []
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        values, rows, cols, y, w_true = draw_problem(rng, N_ROWS, N_FEATURES, NNZ_PER_ROW)
        h_values, h_rows, h_cols, h_y, _ = draw_problem(rng, N_HELDOUT, N_FEATURES,
                                                        NNZ_PER_ROW, w_true)
        stats["draw_s"] = time.perf_counter() - t0
        train_path, heldout_path = os.path.join(tmp, "train.libsvm"), os.path.join(
            tmp, "heldout.libsvm")
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

        t0 = time.perf_counter()
        model_dir = os.path.join(tmp, "glm")
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
    del probe, z, s, d2_row, skewed_csr, power_law
    # Phase 3's temporaries (the column-major views among them) leave cached
    # blocks behind; release them, so that the later paths' peaks depend on
    # the paths' own allocations only, not on which blocks they happen to reuse.
    torch.cuda.empty_cache()

    check_small_parity(args.seed)

    by_path, train, prof = {}, {}, {}
    by_path["5"], train["5"] = run_path(
        "5", batch, "logistic", [10.0, 1.0], solver_config("lbfgs", 20),
        required=("csr_margins", "csc_scatter"), compute_variances=True, min_auc=0.6)
    if args.profile:
        prof["5"] = profile_solve("5", lambda: train_glm(
            batch, "logistic", [1.0], solver_config("lbfgs", 10))[0].result.iterations)
    del batch

    run_suite_paths(args.seed, args.profile, by_path, train, prof)

    by_path["8"], train["8"] = run_data_plane_path(args.seed, card)
    torch.cuda.empty_cache()

    by_path["6"], train["6"], game_prof = run_game_path(args.seed, args.profile)
    if game_prof is not None:
        prof["6"] = game_prof
    by_path["7"], train["7"] = run_probe_path(args.seed)

    for row in kernel_rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()
                                   if c[row["name"]]}
        row["launches"] = sum(row["launches_by_path"].values())
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
