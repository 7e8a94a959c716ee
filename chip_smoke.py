#!/usr/bin/env python3
"""Drive photon_ml_tpu_torch's GLM training paths once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--profile] [--json-out PATH]

Phases, in order; any failure exits non-zero before the last line:

  1. print the card (``nvidia-smi --query-gpu=name,power.limit``);
  2. build the Hopper kernels from ``photon_ml_tpu_torch/csrc`` with nvcc
     (into ``build/kernels/``);
  3. at full width (1M rows x 10K features x 20 nnz/row, bench.py config #1's
     data from ``--seed``) hold each kernel against its plain PyTorch version
     on the card (and each kernel against itself: two launches must agree
     bit for bit), and time kernel, plain version and the library
     yardstick where one PyTorch call computes the same function (never
     used by the port);
  4. train at a reduced size (64K x 2K) on the card and on the CPU (plain
     versions) with LBFGS, TRON, OWLQN and box-constrained Poisson LBFGS:
     same convergence reason and iteration count, final loss within rtol 1e-4;
  5. the paths, each through ``train_glm`` at full width, with the kernels'
     launch counts zeroed just before it and read just after (a kernel of
     the path that did not launch fails the run):
       5.  bench.py config #1: logistic, lambdas [10, 1], LBFGS 20
           iterations at tolerance 0, with variances;
       5b. bench_suite.py config #2: squared, TRON, L2 1, 10 iterations;
       5c. its elastic-net half: OWLQN, l1 = l2 = 0.5, 20 iterations;
       5d. config #3: Poisson with offsets, L2 1, box [-0.5, 0.5], LBFGS 20
           iterations;
       5e. TRON with the box [-0.5, 0.5] on config #2's data, 3 iterations;
  6. print the ``kernels`` JSON line, the card again, and the result line
     ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result. ``--profile`` adds a torch.profiler window
over one extra solve of each path and prints its device-busy share.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings

import numpy as np

N_ROWS = 1_000_000
N_FEATURES = 10_000
NNZ_PER_ROW = 20
SMALL_ROWS = 65_536
SMALL_FEATURES = 2_048
KERNEL_REL_TOL = 1e-4  # max |kernel - plain| / max(1, max |plain|)
LOSS_RTOL = 1e-4

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_problem(seed: int, n_rows: int, n_features: int, nnz_per_row: int):
    """bench.py config #1's data: uniform columns, N(0,1) values, labels drawn
    from a planted logistic model (same draws in the same order)."""
    rng = np.random.default_rng(seed)
    nnz = n_rows * nnz_per_row
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, n_features, size=nnz)
    values = rng.normal(size=nnz)
    w_true = rng.normal(size=n_features) * 0.5
    margins = np.bincount(rows, weights=values * w_true[cols], minlength=n_rows)
    y = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    return values, rows, cols, y


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


def device_ms(fn, reps: int = 30) -> float:
    """Median device time of one call, by CUDA events. A sleep kernel ahead of
    each start event keeps the host's launch cost out of the window."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


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


def check_kernels(batch, w, per_row, d2_row) -> list[dict]:
    """Phase 3, the margins and scatter kernels: every variant of the path
    against its plain version and against a second launch, bit for bit."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference

    n, f, nnz = batch.num_rows, batch.num_features, batch.nnz
    shift = torch.tensor(0.25, dtype=torch.float32, device=w.device)
    b_csr = batch.row_ptr, batch.cols, batch.vals
    b_csc = batch.col_ptr, batch.csc_rows, batch.csc_vals

    variants = {
        "csr_margins": [
            ("margins+offsets+shift", lambda: kernels.csr_margins(*b_csr, w, batch.offsets, shift, True),
             lambda: reference.csr_margins(*b_csr, w, batch.offsets, shift, True)),
            ("dot_rows", lambda: kernels.csr_margins(*b_csr, w, batch.offsets, 0.0, False),
             lambda: reference.csr_margins(*b_csr, w, batch.offsets, 0.0, False)),
        ],
        "csc_scatter": [
            ("scatter", lambda: kernels.csc_scatter(*b_csc, per_row, False),
             lambda: reference.csc_scatter(*b_csc, per_row, False)),
            ("scatter_sq", lambda: kernels.csc_scatter(*b_csc, d2_row, True),
             lambda: reference.csc_scatter(*b_csc, d2_row, True)),
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
                            *b_csc, size=(f, n), check_invariants=False),
                            lambda m: torch.mv(m, per_row))),
    }
    rows = []
    for name, cases in variants.items():
        worst, timed = run_variants(name, cases)
        src, replaces, label, nbytes, flops, lib = specs[name]
        rows.append(kernel_row(name, src, replaces, worst, timed, label, nbytes, flops, lib))
    return rows


def check_fused_kernels(batch, w, v, d2_row) -> list[dict]:
    """Phase 3, the fused kernels: the variants the paths run (pair with
    offsets and both shifts; value_grad for squared, Poisson and logistic;
    hv for squared and logistic; hv_at), each against its plain version and
    against a second launch, bit for bit."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference

    n, f, nnz = batch.num_rows, batch.num_features, batch.nnz
    csr = batch.row_ptr, batch.cols, batch.vals
    csc = batch.col_ptr, batch.csc_rows, batch.csc_vals
    rows3 = batch.labels, batch.weights, batch.offsets
    shift = torch.tensor(0.25, dtype=torch.float32, device=w.device)  # a 0-d device shift
    v_shift = -0.5  # and a host one

    def vg(loss):
        return (loss, lambda: kernels.value_grad(csr, csc, *rows3, w, shift, loss),
                lambda: reference.value_grad(csr, csc, *rows3, w, shift, loss))

    def hv(loss):
        return (loss, lambda: kernels.hv(csr, csc, *rows3, w, shift, v, v_shift, loss),
                lambda: reference.hessian_vector(csr, csc, *rows3, w, shift, v, v_shift, loss))

    variants = {
        "margins_pair": [("pair+offsets+shifts",
                          lambda: kernels.margins_pair(csr, w, v, batch.offsets, shift, v_shift),
                          lambda: reference.margins_pair(csr, w, v, batch.offsets, shift,
                                                         v_shift))],
        "value_grad": [vg("squared"), vg("poisson"), vg("logistic")],
        "hv": [hv("squared"), hv("logistic")],
        "hv_at": [("hv_at", lambda: kernels.hv_at(csr, csc, d2_row, v, v_shift),
                   lambda: reference.hv_at(csr, csc, d2_row, v, v_shift))],
    }
    # Bytes the function must move: the CSR slots once (8 per nonzero),
    # row_ptr, the per-row inputs and tables, the outputs. The two-layout
    # design also reads the CSC slots and col_ptr and writes and reads one
    # per-row vector: its own floor.
    slots = (n + 1) + 2 * nnz
    two_layout = (f + 1) + 2 * nnz + 2 * n
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
                       slots + 3 * n + f + f + 2, two_layout, 4 * nnz, None,
                       "no single PyTorch call computes loss, gradient and sums"),
        "hv": ("photon_ml_tpu_torch/csrc/hessian_vector.cu",
               "photon_ml_tpu/ops/tiled.py:251", "squared",
               slots + 3 * n + 2 * f + f + 1, two_layout, 6 * nnz, None,
               "no single PyTorch call computes the curvature-weighted X^T D X v"),
        "hv_at": ("photon_ml_tpu_torch/csrc/hessian_vector.cu",
                  "photon_ml_tpu/ops/tiled.py:284", "hv_at",
                  slots + n + f + f + 1, two_layout, 4 * nnz, None,
                  "X^T (d2 * (X v + s)) takes two sparse products and an elementwise op"),
    }
    rows = []
    for name, cases in variants.items():
        worst, timed = run_variants(name, cases)
        src, replaces, label, words, extra_words, flops, lib, lib_note = specs[name]
        # not a measurement: the bytes the two layouts make this design move,
        # over the HBM rate, for the kernel table beside the bound
        print(f"design floor {name}: two-layout bytes={4 * (words + extra_words)} "
              f"floor_ms={4 * (words + extra_words) / PEAK_BYTES_PER_S * 1e3:.4f} (computed)",
              flush=True)
        rows.append(kernel_row(name, src, replaces, worst, timed, label, 4 * words, flops,
                               lib, library_note=lib_note))
    return rows


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
        print(f"path {label} lambda={e.reg_weight}: iterations={res.iterations} "
              f"reason={CONVERGENCE_REASON_NAMES[res.reason]} data_passes={res.data_passes} "
              f"loss0={loss0:.7g} loss={loss:.7g}{extra}", flush=True)
        if bad:
            raise RuntimeError(f"path {label} lambda={e.reg_weight}: bad result: {bad}")
    rows_per_s = batch.num_rows * passes / elapsed
    stats = {"elapsed_s": elapsed, "rows_per_s": rows_per_s, "data_passes": passes,
             "iterations": iterations, "host_syncs": syncs,
             "ms_per_iteration": 1e3 * elapsed / max(iterations, 1),
             "max_memory_allocated": peak}
    print(f"path {label}: rows={batch.num_rows} data_passes={passes} iterations={iterations} "
          f"elapsed_s={elapsed:.4f} rows_per_s={rows_per_s:.1f} host_syncs={syncs} "
          f"ms_per_iteration={stats['ms_per_iteration']:.4f} max_memory_allocated={peak} "
          f"launches={json.dumps(launches)}", flush=True)
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path {label}: kernels not launched: {missing}")
    return launches, stats


def profile_solve(label, run) -> dict:
    """--profile: device-busy share of one cold solve ``run()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        (entry,) = run()
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
        "iterations": entry.result.iterations,
        "wall_s": wall,
        "device_busy_s": busy_s if busy_s > 0 else None,
        "device_busy_share": busy_s / wall if busy_s > 0 else None,
        "top_device_us": [(name[:80], us) for name, us in top],
    }
    print("profile " + json.dumps(report), flush=True)
    return report


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
    from photon_ml_tpu_torch.training import train_glm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
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
    kernel_rows = check_kernels(probe, w, s - batch.labels, d2_row)
    kernel_rows += check_fused_kernels(probe, w, v, d2_row)
    del probe, z, s, d2_row

    check_small_parity(args.seed)

    by_path, train, prof = {}, {}, {}
    by_path["5"], train["5"] = run_path(
        "5", batch, "logistic", [10.0, 1.0], solver_config("lbfgs", 20),
        required=("csr_margins", "csc_scatter"), compute_variances=True, min_auc=0.6)
    if args.profile:
        prof["5"] = profile_solve("5", lambda: train_glm(
            batch, "logistic", [1.0], solver_config("lbfgs", 10)))
    del batch

    # bench_suite.py configs #2 and #3: the linear problem first, then the
    # Poisson one, from one generator
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
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
        if args.profile:
            prof[label] = profile_solve(label, lambda: train_glm(
                pbatch, task, [1.0], cfg, constraints=constraints))
    del linear, poisson

    for row in kernel_rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()
                                   if c[row["name"]]}
        row["launches"] = sum(row["launches_by_path"].values())
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, "kernels": kernel_rows, "train": train,
                       "profile": prof}, fh, indent=1)

    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
