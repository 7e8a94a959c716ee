"""Sweep driver: multi-λ training and best-model selection in one run.

Counterpart of ``photon_ml_tpu/cli/sweep.py``. Two entry points:

- ``cli train --sweep lambda=... --config train.json``: the training driver
  runs the sweep instead of a single fit (``train.py`` delegates to
  ``run_sweep_fit`` here);
- ``cli sweep --config train.json [--sweep ...]``: sweep-only reruns over the
  same config and dataset:

    python -m photon_ml_tpu_torch.cli sweep --config train.json \\
        --sweep lambda=1e-2:1e2:log4 [--device cuda|cpu]

Config object (the ``"sweep"`` key of a train config; every field has a
flag override)::

    "sweep": {
      "grid": "lambda=1e-4:1e2:log16 lambda.perUser=0.1,1",
      "metric": "auc",            # default: task's ModelSelection metric
      "policy": "best",           # or "parsimonious" (+ "rel_tol")
      "warm_start": true,
      "num_iterations": 2,         # CD sweeps; default config num_iterations
      "registry_dir": "registry/"  # publish the winner for live serving
    }

The summary JSON carries a per-config table (λs, iterations, convergence,
validation metric) and the selection; malformed grids are typed config
errors naming the offending token (``sweep.grid.SweepSpecError``).
``registry_dir`` (``--registry-dir``) publishes the winner, with the
input's index maps, as the next version of a serving registry.
``--trace-out``, ``--telemetry-out`` and ``--report-out`` are ``cli
train``'s: the report's "Hyperparameter sweep" section is the per-config
table of the run's ``sweep_config`` spans.
"""

from __future__ import annotations

import argparse
import json
from typing import Mapping, Optional

from photon_ml_tpu_torch.sweep.grid import (
    SweepGrid,
    SweepSpecError,
    parse_range,
    parse_sweep_spec,
)

_SWEEP_KEYS = {"grid", "metric", "policy", "rel_tol", "registry_dir", "warm_start",
               "num_iterations"}


def parse_sweep_config(spec) -> dict:
    """Normalize the config ``"sweep"`` value (a string grid shorthand or an
    object) into ``run_sweep_fit``'s arguments. Typed errors name the
    offending token or key."""
    if isinstance(spec, (str, list, tuple)):
        spec = {"grid": spec}
    spec = dict(spec)
    unknown = set(spec) - _SWEEP_KEYS
    if unknown:
        raise ValueError(f"unknown sweep config keys: {sorted(unknown)}")
    raw_grid = spec.get("grid")
    if not raw_grid:
        raise SweepSpecError("sweep.grid", "no lambda grid given")
    if isinstance(raw_grid, Mapping):
        # the SweepGrid.to_json round-trip form {"lambda": [...], ...}; the
        # values go through the string grammar's validator
        bad = set(raw_grid) - {"lambda"} - {k for k in raw_grid if k.startswith("lambda.")}
        if bad:
            raise SweepSpecError(str(sorted(bad)[0]), "unknown grid key (expected 'lambda' "
                                 "or 'lambda.<coordinate>')")

        def points_of(key, value):
            if not isinstance(value, (list, tuple)) or not value:
                raise SweepSpecError(key, "empty grid (no points)")
            return parse_range(",".join(str(v) for v in value), context=key)

        default = raw_grid.get("lambda")
        grid = SweepGrid(
            default=None if default is None else points_of("lambda", default),
            per_coordinate={k[len("lambda."):]: points_of(k, v)
                            for k, v in raw_grid.items() if k.startswith("lambda.")})
    else:
        grid = parse_sweep_spec(raw_grid)
    return {
        "grid": grid,
        "metric": spec.get("metric"),
        "policy": spec.get("policy", "best"),
        "rel_tol": float(spec.get("rel_tol", 0.01)),
        "registry_dir": spec.get("registry_dir"),
        "warm_start": bool(spec.get("warm_start", True)),
        "num_iterations": spec.get("num_iterations"),
    }


def merge_sweep_flags(config: Mapping, grid=None, metric: Optional[str] = None,
                      policy: Optional[str] = None,
                      registry_dir: Optional[str] = None) -> Optional[dict]:
    """Overlay the sweep flags onto a config's ``"sweep"`` value (a string
    shorthand normalized to an object). Returns the merged object, or None
    when neither the config nor the flags configure a sweep: one merge
    shared by the train and sweep entry points."""
    sweep_cfg = config.get("sweep")
    sweep_cfg = (dict(sweep_cfg) if isinstance(sweep_cfg, Mapping)
                 else ({"grid": sweep_cfg} if sweep_cfg else {}))
    if grid:
        sweep_cfg["grid"] = list(grid)
    if metric:
        sweep_cfg["metric"] = metric
    if policy:
        sweep_cfg["policy"] = policy
    if registry_dir:
        sweep_cfg["registry_dir"] = registry_dir
    return sweep_cfg or None


def run_sweep_fit(estimator, sweep_spec, train_data, validation_data,
                  output_dir: Optional[str], device=None,
                  index_maps: Optional[Mapping] = None) -> dict:
    """Run the sweep for the training driver on ``device`` (default cuda);
    returns the summary's ``"sweep"`` section (per-config table, selection
    and the published version, when the spec names a ``registry_dir``)."""
    from photon_ml_tpu_torch.optim.common import MAX_ITERATIONS, NOT_CONVERGED

    parsed = parse_sweep_config(sweep_spec)
    if validation_data is None:
        raise ValueError('a sweep needs a validation split to select on — add a '
                         '"validation" input to the config')
    result = estimator.fit_sweep(
        train_data, validation_data, parsed["grid"], metric=parsed["metric"],
        policy=parsed["policy"], rel_tol=parsed["rel_tol"],
        num_iterations=parsed["num_iterations"], warm_start=parsed["warm_start"],
        output_dir=output_dir, registry_dir=parsed["registry_dir"], index_maps=index_maps,
        device=device)
    sweep, selection = result.sweep, result.selection
    conv = sweep.convergence()
    lambdas = sweep.lambdas
    configs = []
    for g in range(sweep.size):
        configs.append({
            "index": g,
            "lambdas": {name: lams[g] for name, lams in lambdas.items()},
            "iterations": int(max(c["iterations"][g] for c in conv.values())),
            "converged": all(int(c["reasons"][g]) not in (NOT_CONVERGED, MAX_ITERATIONS)
                             for c in conv.values()),
            "metric": (None if selection.metrics[g] != selection.metrics[g]
                       else float(selection.metrics[g])),
        })
    out = {
        "configs": configs,
        "metric": selection.metric,
        "policy": selection.policy,
        "selected_index": selection.index,
        "selected_metric": selection.best_value,
        "selected_lambdas": configs[selection.index]["lambdas"],
        "history": sweep.history,
    }
    if output_dir:
        out["output_dir"] = output_dir
    if result.published_version:
        out["published_version"] = result.published_version
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli sweep",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="train JSON config")
    parser.add_argument("--sweep", action="append",
                        help="sweep grid token(s), e.g. 'lambda=1e-4:1e2:log16' or "
                        "'lambda.perUser=0.1,1,10' (repeatable; overrides config sweep.grid)")
    parser.add_argument("--sweep-metric",
                        help="validation metric to select on (default: the task's "
                        "ModelSelection metric)")
    parser.add_argument("--sweep-policy", choices=("best", "parsimonious"),
                        help="selection policy (parsimonious prefers the most regularized "
                        "config within rel_tol of the best metric)")
    parser.add_argument("--output-dir", help="save the winner under <dir>/best (overrides "
                        "config output_dir)")
    parser.add_argument("--registry-dir",
                        help="publish the winner as the next version of this serving "
                        "registry (overrides config sweep.registry_dir)")
    parser.add_argument("--device", default="cuda",
                        help="the device that reads, trains and scores (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")
    parser.add_argument("--trace-out", help="span JSONL (see cli train)")
    parser.add_argument("--telemetry-out", help="metrics JSONL")
    parser.add_argument("--report-out", help="run report markdown")
    args = parser.parse_args(argv)

    from photon_ml_tpu_torch.cli.train import run
    from photon_ml_tpu_torch.utils import setup_logging

    setup_logging()
    with open(args.config) as f:
        config = json.load(f)
    sweep_cfg = merge_sweep_flags(config, grid=args.sweep, metric=args.sweep_metric,
                                  policy=args.sweep_policy, registry_dir=args.registry_dir)
    if not sweep_cfg or not sweep_cfg.get("grid"):
        parser.error("no sweep grid: pass --sweep lambda=... or set config sweep.grid")
    config["sweep"] = sweep_cfg
    for key in ("trace_out", "telemetry_out", "report_out"):
        if getattr(args, key):
            config[key] = getattr(args, key)
    summary = run(config, output_dir=args.output_dir, device=args.device)
    print(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
