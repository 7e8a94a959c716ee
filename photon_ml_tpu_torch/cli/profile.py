"""Profiler capture: run any CLI command inside a ``torch.profiler``
capture.

    python -m photon_ml_tpu_torch.cli profile --profile-dir prof/ -- \
        train --config train.json --trace-out run.trace.jsonl

Counterpart of ``photon_ml_tpu/cli/profile.py``. Everything after ``--`` is
a normal CLI invocation (train, score, glm, serve, report, ...). It runs
inside a ``torch.profiler`` capture of the CPU and, where there is a card,
CUDA activity, written on exit as a Chrome/Perfetto trace
(``profile-<pid>.pt.trace.json``) into ``--profile-dir``: the kernels'
launches and device times (the ``photon_*`` symbols of ``csrc/``), with
every telemetry span mirrored as a ``torch.profiler.record_function`` range,
so the span tree (``fit > cd_iteration > coordinate:<name>``) lines up with
the kernels in Perfetto. ``--no-annotations`` leaves the spans out.

A capture that cannot start warns and runs the command unprofiled; the exit
code is the wrapped command's either way.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

EXIT_USAGE = 2


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # split at the first bare "--": the profile flags, then the wrapped command
    if "--" in argv:
        split = argv.index("--")
        own, wrapped = argv[:split], argv[split + 1:]
    else:
        own, wrapped = argv, []
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli profile",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--profile-dir", required=True,
                        help="directory for the torch.profiler capture (Chrome trace JSON)")
    parser.add_argument("--no-annotations", action="store_true",
                        help="do not mirror telemetry spans as profiler ranges")
    args = parser.parse_args(own)
    if not wrapped:
        parser.error("nothing to profile: pass the wrapped command after `--`, "
                     "e.g. `profile --profile-dir prof/ -- train --config t.json`")

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from photon_ml_tpu_torch.cli.__main__ import main as cli_main
    from photon_ml_tpu_torch.telemetry import trace

    if not args.no_annotations:
        trace.set_annotation_factory(record_function)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=activities)
        prof.start()
    except Exception as e:  # noqa: BLE001 — the capture is best effort
        prof = None
        print(f"warning: profiler capture unavailable ({e}); running unprofiled",
              file=sys.stderr)
    try:
        rc = cli_main(wrapped)
    finally:
        if prof is not None:
            try:
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()  # the last kernels land inside the capture
                prof.stop()
                os.makedirs(args.profile_dir, exist_ok=True)
                out = os.path.join(args.profile_dir, f"profile-{os.getpid()}.pt.trace.json")
                prof.export_chrome_trace(out)
                print(f"profiler capture written to {out} (open with https://ui.perfetto.dev)",
                      file=sys.stderr)
            except Exception as e:  # noqa: BLE001
                print(f"warning: profiler capture failed to finalize: {e}", file=sys.stderr)
        if not args.no_annotations:
            trace.set_annotation_factory(None)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
