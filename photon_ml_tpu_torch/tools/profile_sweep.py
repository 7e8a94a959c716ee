"""Path 12's λ sweep on the card, timed on the wall clock and profiled.

    python photon_ml_tpu_torch/tools/profile_sweep.py --root DIR [--reps 3] [--seed 0]

Draws bench.py config #1's data (1M rows x 10K features x 20 nonzeros a row,
its draws in its order, as chip_smoke.py's paths 5 and 12 draw them), runs
``sweep_glm`` over 16 lambdas (``np.logspace(2, -4, 16)``, LBFGS 20 at
tolerance 0, cold lanes) once to warm up, ``--reps`` times on the wall
clock, then once under torch.profiler. Prints the card's name and power
limit, then one JSON line: the wall seconds of each sweep, and the device
milliseconds of the profiled sweep's kernels, in all and by kernel name.
``--root`` is the checkout whose package runs (``.``, or a parent commit
unpacked with ``git archive``, so that two versions compare on one card);
the file is run by its path, so that no package is imported before it.
Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

N_ROWS, N_FEATURES, NNZ_PER_ROW, LANES = 1_000_000, 10_000, 20, 16


def config1(seed: int):
    """bench.py config #1's draws: (values, rows, cols, labels)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nnz = N_ROWS * NNZ_PER_ROW
    rows = np.repeat(np.arange(N_ROWS, dtype=np.int64), NNZ_PER_ROW)
    cols = rng.integers(0, N_FEATURES, size=nnz)
    values = rng.normal(size=nnz)
    w_true = rng.normal(size=N_FEATURES) * 0.5
    margins = np.bincount(rows, weights=values * w_true[cols], minlength=N_ROWS)
    y = (rng.random(N_ROWS) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    return values, rows, cols, y


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_sweep: needs a CUDA device")
    from photon_ml_tpu_torch.kernels.build import load_library
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )
    from photon_ml_tpu_torch.sweep import sweep_glm
    from photon_ml_tpu_torch.tools.probe_ell import card_line

    load_library()
    values, rows, cols, y = config1(args.seed)
    batch = CSRBatch.from_coo(values, rows, cols, y, N_FEATURES)
    cfg = OptimizerConfig(optimizer_type=OptimizerType.LBFGS, max_iterations=20, tolerance=0.0,
                          regularization=RegularizationContext(RegularizationType.L2))
    lams = tuple(float(v) for v in np.logspace(2, -4, LANES))

    def sweep():
        return sweep_glm(batch, "logistic", lams, cfg, warm_start=False).values.cpu()

    sweep()
    walls = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sweep()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.self_device_time_total / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"card": card, "root": args.root, "walls_s": walls,
                      "device_ms": sum(by_name.values()),
                      "lane_kernels_ms": {k: v for k, v in by_name.items() if "lanes" in k},
                      "top_ms": top}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
