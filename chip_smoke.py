#!/usr/bin/env python3
"""Drive photon_ml_tpu_torch's GLM training path once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--profile] [--json-out PATH]

Phases, in order; any failure exits non-zero before the last line:

  1. print the card (``nvidia-smi --query-gpu=name,power.limit``);
  2. build the Hopper kernels from ``photon_ml_tpu_torch/csrc`` with nvcc
     (into ``build/kernels/``);
  3. at full width (1M rows x 10K features x 20 nnz/row, bench.py config #1's
     data from ``--seed``) hold each kernel against its plain PyTorch version
     on the card, and time kernel, plain version and the library yardstick
     (``torch.mv`` of a sparse CSR matrix, never used by the port);
  4. train at a reduced size (64K x 2K) on the card and on the CPU (plain
     versions): same convergence reason, final loss within rtol 1e-4;
  5. the main path: ``train_glm`` at full width, logistic, lambdas [10, 1],
     LBFGS 20 iterations at tolerance 0, with variances. The kernels' launch
     counts are zeroed just before it and read just after; a kernel of the
     path that did not launch fails the run;
  6. print the ``kernels`` JSON line, the card again, and the result line
     ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result. ``--profile`` adds a torch.profiler window
over one extra solve and prints the device-busy share.
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


def library_ms(make_matrix, vec) -> float | None:
    """Time of torch.mv on a sparse CSR matrix (the yardstick; unused by the
    port). None when this build of torch cannot run it."""
    import torch

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "sparse CSR is in beta"
            mat = make_matrix()
        torch.mv(mat, vec)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"library yardstick unavailable: {exc}", flush=True)
        return None
    return device_ms(lambda: torch.mv(mat, vec))


def check_kernels(batch, w, per_row, d2_row) -> list[dict]:
    """Phase 3: every kernel variant of the path against its plain version."""
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
    bounds = {
        "csr_margins": (margin_bytes, 2 * nnz),
        "csc_scatter": (scatter_bytes, 2 * nnz),
    }
    lib = {
        "csr_margins": library_ms(
            lambda: torch.sparse_csr_tensor(*b_csr, size=(n, f), check_invariants=False), w),
        "csc_scatter": library_ms(
            lambda: torch.sparse_csr_tensor(*b_csc, size=(f, n), check_invariants=False),
            per_row),
    }
    sources = {
        "csr_margins": ("photon_ml_tpu_torch/csrc/margins.cu",
                        "photon_ml_tpu/ops/tiled.py:170"),
        "csc_scatter": ("photon_ml_tpu_torch/csrc/scatter.cu",
                        "photon_ml_tpu/ops/tiled.py:199"),
    }
    rows = []
    for name, cases in variants.items():
        worst = 0.0
        timed = {}
        for label, run_kernel, run_plain in cases:
            abs_err, _ = compare(f"{name}[{label}]", run_kernel(), run_plain())
            worst = max(worst, abs_err)
            timed[label] = (device_ms(run_kernel), device_ms(run_plain))
            print(f"time {name}[{label}]: kernel_ms={timed[label][0]:.4f} "
                  f"plain_ms={timed[label][1]:.4f}", flush=True)
        label = "dot_rows" if name == "csr_margins" else "scatter"
        nbytes, flops = bounds[name]
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        src, replaces = sources[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": worst,
            "ms": timed[label][0],
            "plain_ms": timed[label][1],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib[name],
            "timed_variant": label,
            "variants_ms": {k: v[0] for k, v in timed.items()},
        })
    return rows


def lbfgs_config(max_iterations: int):
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )

    return OptimizerConfig(
        max_iterations=max_iterations,
        tolerance=0.0,
        regularization=RegularizationContext(RegularizationType.L2),
    )


def check_small_parity(seed: int) -> None:
    """Phase 4: the same reduced problem trained on the card and on the CPU."""
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.training import train_glm

    values, rows, cols, y = make_problem(seed + 1, SMALL_ROWS, SMALL_FEATURES, NNZ_PER_ROW)
    out = {}
    for dev in ("cuda", "cpu"):
        batch = CSRBatch.from_coo(values, rows, cols, y, SMALL_FEATURES, device=dev)
        (entry,) = train_glm(batch, "logistic", [1.0], lbfgs_config(5), device=dev)
        res = entry.result
        out[dev] = (res.reason, float(res.value), res.iterations)
        print(f"small {dev}: iterations={res.iterations} "
              f"reason={CONVERGENCE_REASON_NAMES[res.reason]} loss={float(res.value):.7g}",
              flush=True)
    (r_gpu, f_gpu, _), (r_cpu, f_cpu, _) = out["cuda"], out["cpu"]
    rel = abs(f_gpu - f_cpu) / abs(f_cpu)
    print(f"small parity: loss_rel_diff={rel:.3e} limit={LOSS_RTOL:.0e}", flush=True)
    if r_gpu != r_cpu or not rel <= LOSS_RTOL:
        raise RuntimeError("reduced-size training on the card disagrees with the CPU")


def train_main_path(batch):
    """Phase 5: train_glm as a user calls it (device defaults to cuda)."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.training import train_glm

    cfg = lbfgs_config(20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    entries = train_glm(batch, "logistic", [10.0, 1.0], cfg, compute_variances=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)

    passes = sum(e.result.data_passes for e in entries)
    iterations = sum(e.result.iterations for e in entries)
    for e in entries:
        res, coef = e.result, e.model.coefficients
        finite = bool(coef.means.isfinite().all()) and bool(coef.variances.isfinite().all())
        positive = bool((coef.variances > 0).all())
        decreased = float(res.values[res.iterations]) < float(res.values[0])
        score_auc = float(auc(e.model.compute_score(batch), batch.labels, batch.weights))
        print(f"train lambda={e.reg_weight}: iterations={res.iterations} "
              f"reason={CONVERGENCE_REASON_NAMES[res.reason]} "
              f"loss0={float(res.values[0]):.7g} loss={float(res.value):.7g} "
              f"train_auc={score_auc:.6f}", flush=True)
        if not (finite and positive and decreased and score_auc > 0.6):
            raise RuntimeError(f"lambda={e.reg_weight}: bad result "
                               f"(finite={finite} positive_var={positive} "
                               f"decreased={decreased} auc={score_auc})")
    rows_per_s = batch.num_rows * passes / elapsed
    print(f"train: rows={batch.num_rows} data_passes={passes} iterations={iterations} "
          f"elapsed_s={elapsed:.4f} rows_per_s={rows_per_s:.1f} "
          f"host_syncs={syncs} ms_per_iteration={1e3 * elapsed / iterations:.4f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"launches={json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    return launches, {"elapsed_s": elapsed, "rows_per_s": rows_per_s,
                      "data_passes": passes, "iterations": iterations,
                      "host_syncs": syncs,
                      "max_memory_allocated": torch.cuda.max_memory_allocated()}


def profile_solve(batch) -> dict:
    """--profile: device-busy share of one cold solve (at most 10 iterations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_tpu_torch.training import train_glm

    cfg = lbfgs_config(10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        (entry,) = train_glm(batch, "logistic", [1.0], cfg)
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
    offsets = torch.randn(N_ROWS, generator=gen, device="cuda") * 0.1
    probe = batch.with_offsets(offsets)
    z = probe.margins(w)
    s = torch.sigmoid(z)
    kernel_rows = check_kernels(probe, w, s - batch.labels, s * (1.0 - s))

    check_small_parity(args.seed)

    launches, train = train_main_path(batch)
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]

    prof = profile_solve(batch) if args.profile else None
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
