"""The sparse passes' outputs of one checkout against another's, on the same inputs.

    python photon_ml_tpu_torch/tools/compare_outputs.py --root OTHER --save other.pt
    python photon_ml_tpu_torch/tools/compare_outputs.py --against other.pt

Builds a batch of bench.py config #1's shape (1M rows x 10K features x 20
nonzeros a row, uniform columns, N(0, 1) values, labels and tables from
``--seed``) with the ``photon_ml_tpu_torch`` package found under ``--root``
(by default the checkout holding this file), runs every ``CSRBatch`` pass
that launches a kernel (margins, the margin pair, the scatter, value_grad
for three losses, hv for three, hv_at) and saves the outputs on the host.
With ``--against`` it prints, for each output, the max abs difference from
the saved one and whether the two are bit-identical. Only the public
``CSRBatch`` interface is used, so two commits with different kernels and
layouts can be compared. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))


def outputs(device: str, seed: int, n_rows: int, n_features: int, nnz_per_row: int) -> dict:
    """{name: [host tensors]} of the passes on seeded inputs."""
    import torch

    from photon_ml_tpu_torch.ops.csr import CSRBatch

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    cols = rng.integers(0, n_features, size=len(rows))
    vals = rng.normal(size=len(rows))
    labels = (rng.random(n_rows) < 0.5).astype(np.float64)
    batch = CSRBatch.from_coo(vals, rows, cols, labels, n_features,
                              offsets=rng.normal(size=n_rows) * 0.1, device=device)
    w, v = (torch.from_numpy(rng.normal(size=n_features).astype(np.float32) * 0.1).to(device)
            for _ in range(2))
    r = torch.from_numpy(rng.random(n_rows).astype(np.float32)).to(device)
    shift = torch.tensor(0.25, device=device)
    out = {
        "margins": batch.margins(w, shift),
        "margins_pair": batch.margins_pair(w, shift, v, -0.5),
        "scatter": batch.scatter_features(r),
        "hv_at": batch.fused_hv_at(r, v, -0.5),
    }
    for loss in ("squared", "poisson", "logistic"):
        out[f"value_grad {loss}"] = batch.fused_value_grad(w, shift, loss)
    for loss in ("squared", "poisson", "logistic"):
        out[f"hv {loss}"] = batch.fused_hessian_vector(w, shift, v, -0.5, loss)
    return {k: [t.cpu() for t in (o if isinstance(o, tuple) else (o,))]
            for k, o in out.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(_HERE)),
                        help="the checkout whose photon_ml_tpu_torch runs")
    parser.add_argument("--save", help="write the outputs here")
    parser.add_argument("--against", help="compare with the outputs saved here")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--features", type=int, default=10_000)
    parser.add_argument("--nnz-per-row", type=int, default=20)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    got = outputs(args.device, args.seed, args.rows, args.features, args.nnz_per_row)
    if args.save:
        torch.save(got, args.save)
    if args.against:
        want = torch.load(args.against)
        for name, tensors in got.items():
            for i, (g, e) in enumerate(zip(tensors, want[name], strict=True)):
                diff = float((g.double() - e.double()).abs().max()) if g.numel() else 0.0
                scale = float(e.double().abs().max()) if e.numel() else 0.0
                print(f"{name}[{i}]: max_abs_diff={diff:.6g} scale={scale:.6g} "
                      f"bit_identical={torch.equal(g, e)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
