"""Readings that the limits of ``correct`` are set from, at a cell's own
size on the card:

    python3 benchmark/calibrate.py --workload <name> --data-seeds 1,2,3 \
        [--fault-seeds 1,2] [--modes control,unchanged,...] [--seed n] [--out file]

A run's ``--seed`` only orients the features (``gen.py``): every seed reads
the same numbers. So the readings vary the rows themselves: for each data
seed, in one process, the cell's set-up on rows drawn from it (whose
warm-up call is a sound call of the program, judged by the cell's check),
and on the fault seeds one call under each mode of ``faults.py``, judged
alike. Prints one JSON line a data seed and mode. The benchmark's own runs
do not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import faults, harness  # noqa: E402


def readings(session) -> dict:
    """The worst value of each number over the session's recorded calls."""
    out: dict = {}
    for _, numbers in session.check():
        for k, v in numbers.items():
            out[k] = max(out.get(k, v), v)
    return out


def calibrate(cell, seed: int, modes: list, devices: list, emit) -> None:
    import torch

    driver = harness.load_module("drivers", cell.driver)
    t = time.perf_counter()
    session = driver.prepare(harness.Bench(cell, seed, devices))
    emit({"seed": seed, "mode": "sound", "numbers": readings(session),
          "setup_s": time.perf_counter() - t})
    for mode in modes:
        if mode == "sound" or mode not in faults.MODES:
            continue
        session.begin_window()
        restore = faults.install(session, mode)
        t = time.perf_counter()
        try:
            session.call()
            call_s = time.perf_counter() - t
            numbers = readings(session)
        finally:
            restore()
        emit({"seed": seed, "mode": mode, "numbers": numbers, "call_s": call_s})
    del session
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()


def main(argv: list) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--data-seeds", required=True, help="the rows' seeds")
    p.add_argument("--fault-seeds", default="", help="data seeds that also run the modes")
    p.add_argument("--seed", type=int, default=2**31 + 11, help="the run's seed")
    p.add_argument("--modes", default=",".join(faults.MODES))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    devices = harness.cuda_devices(harness.load_cell(args.workload, root=os.getcwd()).chips)
    sink = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        rec = {"workload": args.workload, "data_seed": data_seed, **rec}
        print(json.dumps(rec), flush=True)
        if sink is not None:
            sink.write(json.dumps(rec) + "\n")
            sink.flush()

    try:
        fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
        for data_seed in (int(s) for s in args.data_seeds.split(",")):
            cell = harness.load_cell(args.workload, root=os.getcwd(),
                                     overrides={"data_seed": data_seed})
            modes = args.modes.split(",") if data_seed in fault_seeds else []
            calibrate(cell, args.seed, modes, devices, emit)
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
