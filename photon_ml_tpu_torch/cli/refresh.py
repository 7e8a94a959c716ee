"""Freshness driver: ``cli refresh``, an incremental warm-start retrain as a
subcommand of its own.

Counterpart of ``photon_ml_tpu/cli/refresh.py``: the training config
(coordinates, evaluators, input) plus the base artifact and today's delta,
run through ``cli train``'s warm-start branch::

    python -m photon_ml_tpu_torch.cli refresh --config train.json \\
        --warm-start ckpt/ --delta day2/part-0.avro --registry-dir registry/ \\
        [--device cuda|cpu]

The combined input is yesterday's paths and the delta's, only the touched
random-effect lanes solve again, and the refreshed model is published with
its lineage (base checkpoint digest, delta digest) through the quality
gate. A delta the newest version already trained on is refused
(``StaleDeltaError``) unless ``--force``. ``--device`` (default ``cuda``) is
the port's one added argument; ``--report-out`` writes the run report, whose
Freshness section holds the refresh's lineage, touched fraction, lanes
solved and skipped, and time to a fresh model.
"""

from __future__ import annotations

import argparse
import json

from photon_ml_tpu_torch.utils import setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli refresh",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="training JSON config path")
    parser.add_argument("--warm-start", metavar="DIR",
                        help="base artifact (step/streamed checkpoint or saved model dir); "
                        "defaults to config warm_start.dir")
    parser.add_argument("--delta", action="append", metavar="PATH",
                        help="delta shard(s) appended to the input paths (repeatable)")
    parser.add_argument("--registry-dir",
                        help="publish the refreshed model here with lineage metadata")
    parser.add_argument("--output-dir", help="override config output_dir")
    parser.add_argument("--lambda-points", type=int,
                        help="local descending-λ sweep fits around the incumbent "
                        "regularization (needs a validation input)")
    parser.add_argument("--report-out",
                        help="write the run report (markdown + sibling .json) with its "
                        "Freshness section here")
    parser.add_argument("--force", action="store_true",
                        help="republish even when the delta digest matches what the newest "
                        "registry version already trained on (without it an unchanged delta "
                        "is a typed refusal)")
    parser.add_argument("--no-quality-gate", action="store_true",
                        help="bypass the champion/challenger publish gate: the candidate's "
                        "quality stats are still recorded (decision 'bypassed'), but a "
                        "regression no longer quarantines the version")
    parser.add_argument("--bootstrap-samples", type=int,
                        help="bootstrap resamples behind the published error bars (AUC CI "
                        "and the masked-lane coefficient CIs); default 32, 0 disables")
    parser.add_argument("--device", default="cuda",
                        help="the device that reads, trains and scores (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")
    args = parser.parse_args(argv)

    setup_logging()
    with open(args.config) as f:
        config = json.load(f)
    ws = dict(config.get("warm_start") or {})
    if args.warm_start:
        ws["dir"] = args.warm_start
    if args.delta:
        ws["delta_paths"] = list(ws.get("delta_paths") or ()) + list(args.delta)
    if args.registry_dir:
        ws["registry_dir"] = args.registry_dir
    if args.lambda_points is not None:
        ws["lambda_points"] = args.lambda_points
    if args.force:
        ws["force"] = True
    if args.no_quality_gate:
        ws["quality_gate"] = False
    if args.bootstrap_samples is not None:
        ws["bootstrap_samples"] = args.bootstrap_samples
    if "dir" not in ws:
        parser.error("refresh needs --warm-start (or config warm_start.dir)")
    config["warm_start"] = ws
    # a reused train config usually points checkpoint.dir at the base run's
    # directory, the one the warm start reads; a refresh never writes there,
    # so the checkpoint config is dropped (a failed refresh runs again from
    # the base)
    config.pop("checkpoint", None)
    if args.report_out:
        config["report_out"] = args.report_out

    from photon_ml_tpu_torch.cli.train import run

    summary = run(config, output_dir=args.output_dir, device=args.device)
    print(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
