"""Freshness-conductor driver: ``cli pipeline``, the supervised daemon that
tails a delta directory and keeps the serving registry fresh.

Counterpart of ``photon_ml_tpu/cli/pipeline.py``, with its flags::

    python -m photon_ml_tpu_torch.cli pipeline --config train.json \\
        --base ckpt/ --delta-dir deltas/ --registry-dir registry/ \\
        --workdir pipeline-work/ --interval-s 30 \\
        --escalate-touched-fraction 0.5 --escalate-after-cycles 24 \\
        --status-port 8080 [--device cuda|cpu]

Each cycle: ``delta_digest`` detects new or changed shards, ``scan_delta``
finds the touched entities, the masked re-solve refreshes only their lanes,
``publish_incremental`` lands a lineage-linked registry version (with the
nearline-vs-delta reconciliation record), and the live ``ModelRegistry``
hot-swaps it. The touched-fraction and cycle-count thresholds escalate to a
full retrain into a fresh base generation under the workdir.

SIGTERM/SIGINT finish the cycle in flight, then exit 75; a restarted daemon
seeds its digest cursor from the newest published lineage and goes on.
``--status-file``/``--status-port`` expose the fleet-status document with
the cycle facts under ``members["0"].pipeline``. The summary is one JSON
line on stdout. ``--device`` (default ``cuda``) is the port's one added
argument; ``--telemetry-out`` and ``--report-out`` raise
``NotImplementedError`` naming ROADMAP.md Queue 1 item 14d.
"""

from __future__ import annotations

import argparse
import json
import signal

from photon_ml_tpu_torch import faults
from photon_ml_tpu_torch.utils import setup_logging

NOT_PORTED = ("the 'pipeline' flag {flag} is not ported to photon_ml_tpu_torch yet "
              "(ROADMAP.md Queue 1 item 14d)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli pipeline",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="training JSON config path")
    parser.add_argument("--base", "--warm-start", dest="base", required=True, metavar="DIR",
                        help="warm-start base artifact (step checkpoint or saved model dir); "
                        "escalations re-base onto new generations under --workdir")
    parser.add_argument("--delta-dir", required=True, metavar="DIR",
                        help="directory tailed for delta shards (see --delta-glob)")
    parser.add_argument("--registry-dir", required=True, metavar="DIR",
                        help="serving registry: each cycle publishes the next version here "
                        "and hot-swaps the live engine")
    parser.add_argument("--workdir", required=True, metavar="DIR",
                        help="daemon scratch: escalation base generations and the "
                        "fleet-status heartbeat directory live here")
    parser.add_argument("--cycles", type=int, default=0, metavar="N",
                        help="stop after N cycles (default 0 = run until SIGTERM)")
    parser.add_argument("--interval-s", type=float, default=5.0,
                        help="seconds between delta polls (default 5)")
    parser.add_argument("--delta-glob", default="*.avro",
                        help="shard pattern tailed inside --delta-dir (default *.avro)")
    parser.add_argument("--escalate-touched-fraction", type=float, default=0.5,
                        help="escalate to a full retrain when a delta touches at least this "
                        "fraction of any coordinate's entities (default 0.5; >=1 disables)")
    parser.add_argument("--escalate-after-cycles", type=int, default=0,
                        help="escalate to a full retrain after this many incremental cycles "
                        "since the last full one (default 0 = never by count)")
    parser.add_argument("--no-quality-gate", action="store_true",
                        help="bypass the champion/challenger publish gate: candidate quality "
                        "stats are still computed and recorded (decision 'bypassed'), but a "
                        "regression beyond the champion's bootstrap CI no longer quarantines "
                        "the version")
    parser.add_argument("--bootstrap-samples", type=int, default=32,
                        help="bootstrap resamples behind the published error bars (AUC CI + "
                        "masked-lane coefficient CIs); default 32, 0 disables")
    parser.add_argument("--no-serve", action="store_true",
                        help="publish without hot-swapping a live ModelRegistry (staleness "
                        "then measures event->published)")
    parser.add_argument("--status-file", metavar="PATH",
                        help="write the fleet-status JSON document here each cycle")
    parser.add_argument("--status-port", type=int, metavar="PORT",
                        help="serve the live status document over HTTP /statusz "
                        "(0 = ephemeral port)")
    parser.add_argument("--telemetry-out", help=argparse.SUPPRESS)
    parser.add_argument("--report-out", help=argparse.SUPPRESS)
    parser.add_argument("--device", default="cuda",
                        help="the device that reads, trains, scores and serves (default cuda; "
                        "cpu runs the kernels' plain PyTorch versions)")
    args = parser.parse_args(argv)
    for flag, value in (("--telemetry-out", args.telemetry_out),
                        ("--report-out", args.report_out)):
        if value is not None:
            raise NotImplementedError(NOT_PORTED.format(flag=flag))

    setup_logging()
    # an armed PHOTON_FAULT_PLAN is loud: this run fails on purpose
    faults.warn_if_armed()
    with open(args.config) as f:
        config = json.load(f)
    # the conductor owns its checkpoints (escalation generations under the
    # workdir); a train config's checkpoint dir would alias the base
    config.pop("checkpoint", None)

    from photon_ml_tpu_torch.pipeline import FreshnessPipeline, PipelineSpec

    pipe = FreshnessPipeline(PipelineSpec(
        config=config, delta_dir=args.delta_dir, base_dir=args.base,
        registry_dir=args.registry_dir, workdir=args.workdir, interval_s=args.interval_s,
        max_cycles=args.cycles, delta_glob=args.delta_glob,
        escalate_touched_fraction=args.escalate_touched_fraction,
        escalate_after_cycles=args.escalate_after_cycles, serve=not args.no_serve,
        status_file=args.status_file, status_port=args.status_port,
        quality_gate=not args.no_quality_gate, bootstrap_samples=args.bootstrap_samples,
        device=args.device))

    def _on_signal(signum, frame):
        pipe.request_stop()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    summary = pipe.run()
    print(json.dumps(summary, default=float), flush=True)
    # an interrupted daemon is incomplete: 75 tells a scheduler to restart it
    return 75 if summary.get("interrupted") else 0


if __name__ == "__main__":
    raise SystemExit(main())
