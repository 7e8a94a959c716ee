"""Run-report driver: a run's telemetry artifacts as one readable report.

Counterpart of ``photon_ml_tpu/cli/report.py``:

    python -m photon_ml_tpu_torch.cli report \\
        --trace run.trace.jsonl --telemetry run.metrics.jsonl \\
        --checkpoint-dir ckpt/ --out report.md [--json report.json] \\
        [--compare baseline.report.json] [--fail-on-regress] [--threshold 0.2]

Merges a span JSONL (``--trace-out``), a telemetry JSONL (the metrics
snapshot and the heartbeat lines) and a checkpoint directory's manifests into
one markdown report (stdout, or ``--out``): the phase-time tree, the top
spans, the fetch accounting, the memory peaks, per-coordinate convergence and
guard history, the sweep, ingestion, serving, freshness, pipeline, quality
and recovery sections, and heartbeat liveness (``telemetry/report.py``).
It reads either package's artifacts.

``--compare`` takes a baseline report JSON (``--json`` of an earlier run, or
a bare ``{metric: value}`` dict) and appends a comparison table; with
``--fail-on-regress`` the process exits 3 when a key metric moved against its
direction by more than ``--threshold`` (default 20%).

Exit codes: 0 ok, 1 unreadable inputs, 2 usage, 3 regression detected.

``--fleet`` and ``--requests`` (ROADMAP.md Queue 1 item 14d (ii)) and
``--hot`` (14d (iii)) raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

EXIT_OK = 0
EXIT_ERROR = 1
EXIT_REGRESSION = 3

# the reference's flags of later slices, with their ROADMAP.md Queue 1 item
_REFUSED = {"fleet": "14d (ii)", "requests": "14d (ii)", "hot": "14d (iii)"}


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli report",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--trace", help="span JSONL written by --trace-out / PHOTON_TRACE_OUT")
    parser.add_argument("--telemetry", help="metrics/heartbeat JSONL written by --telemetry-out")
    parser.add_argument("--checkpoint-dir",
                        help="checkpoint directory whose step manifests carry convergence and "
                        "guard history")
    parser.add_argument("--out", help="write the markdown report here (default: stdout)")
    parser.add_argument("--json", dest="json_out",
                        help="also write the full report as JSON (the compare-baseline format "
                        "for future runs)")
    parser.add_argument("--compare", help="baseline report JSON to diff key metrics against")
    parser.add_argument("--threshold", type=float, default=0.2,
                        help="fractional regression threshold for --compare (default 0.2)")
    parser.add_argument("--fail-on-regress", action="store_true",
                        help="exit 3 when --compare finds a key metric regressed beyond "
                        "--threshold")
    parser.add_argument("--fleet", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--requests", nargs="?", const=10, type=int, help=argparse.SUPPRESS)
    parser.add_argument("--hot", nargs="?", const=10, type=int, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    for flag, item in _REFUSED.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"the 'report' flag --{flag} is not ported to photon_ml_tpu_torch yet "
                f"(ROADMAP.md Queue 1 item {item})")
    if not (args.trace or args.telemetry or args.checkpoint_dir):
        parser.error("nothing to report on: give --trace, --telemetry and/or --checkpoint-dir")

    from photon_ml_tpu_torch.telemetry.report import RunReport

    try:
        report = RunReport.load(trace=args.trace, telemetry=args.telemetry,
                                checkpoint_dir=args.checkpoint_dir)
    except OSError as e:
        print(f"cannot read telemetry artifacts: {e}", file=sys.stderr)
        return EXIT_ERROR

    deltas = None
    if args.compare:
        try:
            with open(args.compare, encoding="utf-8") as fh:
                baseline = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"cannot read baseline {args.compare}: {e}", file=sys.stderr)
            return EXIT_ERROR
        if not isinstance(baseline, dict):
            print(f"baseline {args.compare} is not a report JSON object", file=sys.stderr)
            return EXIT_ERROR
        deltas = report.compare(baseline, threshold=args.threshold)

    md = report.to_markdown(deltas=deltas)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(md)
        print(f"report written to {args.out}")
    else:
        print(md)
    if args.json_out:
        report.save_json(args.json_out)
        if args.out:
            print(f"report JSON written to {args.json_out}")

    if deltas is not None:
        regressed = [d for d in deltas if d.regressed]
        if regressed:
            print("regressions beyond threshold: "
                  + ", ".join(f"{d.metric} ({d.change:+.1%})" for d in regressed),
                  file=sys.stderr)
            if args.fail_on_regress:
                return EXIT_REGRESSION
    return EXIT_OK


if __name__ == "__main__":
    raise SystemExit(main())
