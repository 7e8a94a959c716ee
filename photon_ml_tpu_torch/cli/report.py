"""Run-report driver: a run's telemetry artifacts as one readable report.

Counterpart of ``photon_ml_tpu/cli/report.py``:

    python -m photon_ml_tpu_torch.cli report \\
        --trace run.trace.jsonl --telemetry run.metrics.jsonl \\
        --checkpoint-dir ckpt/ --out report.md [--json report.json] \\
        [--compare baseline.report.json] [--fail-on-regress] [--threshold 0.2] \\
        [--hot [N]] [--requests [N]]

    python -m photon_ml_tpu_torch.cli report --fleet <dir> [--requests [N]] ...

Merges a span JSONL (``--trace-out``), a telemetry JSONL (the metrics
snapshot and the heartbeat lines) and a checkpoint directory's manifests into
one markdown report (stdout, or ``--out``): the phase-time tree, the top
spans, the fetch accounting, the memory peaks, per-coordinate convergence and
guard history, the sweep, ingestion, serving, freshness, pipeline, quality
and recovery sections, and heartbeat liveness (``telemetry/report.py``).
It reads either package's artifacts.

``--fleet <dir>`` aggregates a fleet directory instead: its per-member
streams (``trace.proc-<i>.jsonl`` / ``telemetry.proc-<i>.jsonl``) merge into
one report with per-member rows, the collective-wait attribution and the
straggler, the clock skew, lost members with their flight records' last
words, and the request traces joined across the router's and the members'
streams (``telemetry/fleet_report.py``). ``--requests [N]`` renders only the
request section: the N slowest persisted request traces (with ``--fleet``,
joined by ``trace_id``).

``--compare`` takes a baseline report JSON (``--json`` of an earlier run, or
a bare ``{metric: value}`` dict) and appends a comparison table; with
``--fail-on-regress`` the process exits 3 when a key metric moved against its
direction by more than ``--threshold`` (default 20%). With ``--fleet`` the
comparison runs over the fleet's key metrics (``fleet_rows_per_sec``,
``fleet_collective_wait_fraction``, ...).

Exit codes: 0 ok, 1 unreadable inputs, 2 usage, 3 regression detected.

``--hot [N]`` renders only the Hot-executables table (the top N by the
profiler's estimated exclusive device seconds, default 10).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

EXIT_OK = 0
EXIT_ERROR = 1
EXIT_REGRESSION = 3


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli report",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--trace", help="span JSONL written by --trace-out / PHOTON_TRACE_OUT")
    parser.add_argument("--telemetry", help="metrics/heartbeat JSONL written by --telemetry-out")
    parser.add_argument("--checkpoint-dir",
                        help="checkpoint directory whose step manifests carry convergence and "
                        "guard history")
    parser.add_argument("--fleet", metavar="DIR",
                        help="aggregate a fleet directory of per-member streams "
                        "(*.proc-<i>.jsonl) into one merged report instead of reading one run's "
                        "--trace/--telemetry artifacts")
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
    parser.add_argument("--requests", nargs="?", const=10, type=int, metavar="N",
                        help="render only the request section (the N slowest persisted request "
                        "traces, default 10); with --fleet joined across the router's and the "
                        "members' streams by trace_id")
    parser.add_argument("--hot", nargs="?", const=10, type=int, metavar="N",
                        help="render only the hot-executables table (the top N by profiled "
                        "exclusive device seconds, default 10) instead of the full report")
    args = parser.parse_args(argv)
    if args.fleet and (args.trace or args.telemetry or args.checkpoint_dir):
        parser.error("--fleet aggregates a member-artifact directory; it cannot be combined "
                     "with --trace/--telemetry/--checkpoint-dir")
    if not (args.fleet or args.trace or args.telemetry or args.checkpoint_dir):
        parser.error("nothing to report on: give --fleet, --trace, --telemetry and/or "
                     "--checkpoint-dir")

    if args.fleet:
        from photon_ml_tpu_torch.telemetry.fleet_report import FleetReport

        if not os.path.isdir(args.fleet):
            print(f"--fleet {args.fleet} is not a directory", file=sys.stderr)
            return EXIT_ERROR
        report = FleetReport.load(args.fleet)
        if not report.members:
            print(f"no member artifact streams (*.proc-<i>.jsonl) found under {args.fleet}",
                  file=sys.stderr)
            return EXIT_ERROR
    else:
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
        # per-executable rows compare only where both sides carry them: a
        # renamed or new executable is noted and skipped
        current_km = report.key_metrics()
        base_km = baseline.get("key_metrics", baseline)
        if isinstance(base_km, dict):
            cur_exec = {k for k in current_km if k.startswith("exec.")}
            base_exec = {k for k in base_km if k.startswith("exec.")}
            for name in sorted(cur_exec - base_exec):
                print(f"note: `{name}` is new (absent from baseline — renamed or newly-profiled "
                      "executable); skipped in the comparison", file=sys.stderr)
            for name in sorted(base_exec - cur_exec):
                print(f"note: `{name}` exists only in the baseline (renamed or "
                      "no-longer-profiled executable); skipped in the comparison",
                      file=sys.stderr)

    if args.requests is not None:
        req_lines = report._requests_markdown(args.requests)
        md = ("\n".join(req_lines).rstrip() + "\n" if req_lines
              else "No request traces (run carried no request.* metrics or persisted "
              "request:* spans).\n")
    elif args.hot is not None:
        hot_lines = report._hot_executables_markdown(args.hot)
        md = ("\n".join(hot_lines).rstrip() + "\n" if hot_lines
              else "No profiled executables (run carried no profile.exec.* gauges).\n")
    else:
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
