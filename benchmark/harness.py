"""One run of one cell: set-up, the measured window, the metrics, and the
check that decides ``correct``.

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic; the traffic file names the driver (``drivers/<driver>.py``) whose
``prepare`` makes the inputs from the seed, builds the program's state and
warms every shape up. The window then runs whole calls of the cell's entry
back to back until ``--seconds`` have passed (the call running at the
deadline completes and counts). Once it has closed and the peak memory has
been read, the program's state is freed and the session's ``check`` compares
the answers with the plain reference; each number is held to its limit in
``limits/<workload>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
SPEC_FILE = "BENCHMARK.json"
#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "photon_ml_tpu")
#: the environment variable that arms the program's fault seams
FAULT_PLAN_ENV = "PHOTON_FAULT_PLAN"
GIB = float(1 << 30)


class Refused(Exception):
    """A run that measures nothing: its exit code and why."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


@dataclasses.dataclass
class Cell:
    """One workload of the spec with its configuration, traffic and limits."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, overrides: Optional[dict] = None,
              config_overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root``'s spec; ``overrides`` replace traffic
    parameters and ``config_overrides`` configuration keys (the tests'
    small sizes)."""
    spec_path = os.path.join(root, SPEC_FILE)
    if not os.path.exists(spec_path):
        raise Refused(2, f"no {SPEC_FILE} in {root}")
    spec = _load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise Refused(2, f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench = os.path.join(root, os.path.basename(BENCH_DIR))
    traffic = _load_json(os.path.join(bench, "traffic", w["traffic"] + ".json"))
    traffic.update(overrides or {})
    limits_path = os.path.join(bench, "limits", name + ".json")
    limits = _load_json(limits_path) if os.path.exists(limits_path) else {}
    config = _load_json(os.path.join(root, config["file"]))
    config.update(config_overrides or {})
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module, loaded once (a metric's
    file name may hold dots, so it is loaded by its path)."""
    mod_name = f"benchmark.{kind}.{name.replace('.', '__')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.exists(path):
        raise Refused(2, f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    """What the per-layer readers read of the measured window."""

    calls: int
    seconds: float
    cards: int
    trace: object  # devtrace.TraceSummary or None
    host_syncs: Optional[float]
    session: object


class Bench:
    """What a driver's ``prepare`` gets: the cell, the seed, the devices,
    and the hook that marks the inputs as made (the peak is reset there)."""

    def __init__(self, cell: Cell, seed: int, devices: list):
        self.cell, self.seed, self.devices = cell, int(seed), devices

    def inputs_made(self) -> None:
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)

    def sync(self) -> None:
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def _peak_bytes(devices) -> int:
    import torch

    return max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"),
               default=0)


def _host_syncs() -> Optional[float]:
    from photon_ml_tpu_torch import telemetry

    return telemetry.peek_counter("host_syncs") or 0


def measure(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
            devices: list) -> dict:
    """Set up, run the window and check: the result line as a dict."""
    import torch

    driver = load_module("drivers", cell.driver)
    bench = Bench(cell, seed, devices)
    session = driver.prepare(bench)
    bench.sync()
    setup_s = time.perf_counter() - t0

    session.begin_window()
    syncs0 = _host_syncs()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if devices[0].type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    call_ends = []
    t_start = time.perf_counter()
    while True:
        session.call()
        call_ends.append(time.perf_counter())
        if call_ends[-1] - t_start >= seconds:
            break
    t_end = call_ends[-1]
    calls = len(call_ends)
    call_s = sorted(b - a for a, b in zip([t_start] + call_ends, call_ends))
    print(f"window: {calls} calls in {t_end - t_start:.4f} s; a call's seconds: least "
          f"{call_s[0]:.4f}, median {call_s[calls // 2]:.4f}, most {call_s[-1]:.4f}",
          file=sys.stderr)
    summary = None
    if prof is not None:
        prof.stop()
        from benchmark import devtrace

        summary = devtrace.summarize(devtrace.intervals_of(prof), t_end - t_start)
        del prof
    host_syncs = _host_syncs() - syncs0
    peak = _peak_bytes(devices)
    window = Window(calls=calls, seconds=t_end - t_start, cards=len(devices), trace=summary,
                    host_syncs=host_syncs, session=session)

    builtin = {"fit_s": window.seconds / calls, "peak_mem_gib": peak / GIB,
               "setup_s": setup_s}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = builtin.get(m["name"]) if not trace else None
        if value is None:
            value = load_module("metrics", m["name"]).read(window)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    session.free()
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    answers = session.check()
    checks, failed = judge(answers, cell.limits)
    correct = bool(checks) and all(c["ok"] for c in checks.values()) and failed == 0

    device = {"platform": "gpu" if devices[0].type == "cuda" else devices[0].type,
              "kind": (torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda"
                       else "cpu"),
              "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": calls, "failed": failed, "metrics": metrics,
              "device": device}
    if summary is not None:
        device["busy_s"] = summary.mean_busy_s(len(devices))
        device["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def judge(answers: list, limits: dict) -> tuple[dict, int]:
    """Hold each checked answer's numbers to their limits. ``answers`` is a
    list of (calls it stands for, {number: value}); each number reports its
    worst value. Returns ({number: value, limit, ok}, calls failed)."""
    checks: dict = {}
    failed = 0
    for count, numbers in answers:
        bad = False
        for name, value in numbers.items():
            limit = limits.get(name, {}).get("limit")
            ok = limit is not None and math.isfinite(value) and value <= limit
            bad |= not ok
            prev = checks.get(name)
            if prev is None or not (value <= prev["value"]):
                checks[name] = {"value": float(value), "limit": limit, "ok": ok}
        failed += count if bad else 0
    return checks, failed


def parse_args(argv: list) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cuda_devices(chips: int) -> list:
    import torch

    if not torch.cuda.is_available():
        raise Refused(3, "no CUDA device: this benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(3, f"the cell needs {chips} cards, this machine has "
                         f"{torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(chips)]


def emit(result: dict, out=None, err=None) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in result.get("checks", {}).items():
        print(f"check {name} value={c['value']!r} limit={c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def main(argv: list, t0: float) -> int:
    args = parse_args(argv)
    if os.environ.get(FAULT_PLAN_ENV):
        # numbers made under injected faults compare with nothing
        print(f"benchmark: refusing to measure: fault injection armed ({FAULT_PLAN_ENV} "
              "is set)", file=sys.stderr)
        print(json.dumps({"correct": False, "attempted": 0, "failed": 0, "metrics": {},
                          "device": {"platform": "none", "kind": "none", "count": 0,
                                     "memory_peak_bytes": 0},
                          "refused": "fault injection armed"}))
        return 5
    try:
        cell = load_cell(args.workload, root=os.getcwd())
        os.environ.setdefault("USE_FLAX", "0")
        devices = cuda_devices(cell.chips)
        result = measure(cell, args.seed, args.seconds, bool(args.trace), t0, devices)
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return e.code
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: JAX or the JAX package; no result",
              file=sys.stderr)
        return 4
    emit(result)
    return 0
