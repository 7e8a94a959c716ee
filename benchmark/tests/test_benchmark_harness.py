"""The run's last line, the armed-plan gate, the refusal without a card,
and that nothing the benchmark runs loads JAX or the JAX package."""

import ast
import io
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import harness

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["glm1-lbfgs-32m", "glm1-sweep16-32m"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(small_cell, name, trace):
    cell, devices = small_cell(name)
    res = harness.measure(cell, 2**31 + 3, 0.05, trace, time.perf_counter(), devices)
    out, err = io.StringIO(), io.StringIO()
    harness.emit(res, out, err)
    line = _last_json(out.getvalue())
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if not trace:
        assert set(line["metrics"]) == want
    else:  # a CPU run has no device trace: the trace's readers stay silent
        assert set(line["metrics"]) <= want and "host_syncs_per_fit" in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert line["attempted"] >= 1 and line["correct"] in (True, False)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["device"]["count"] == cell.chips
    # the checks are the last lines of standard error, each with its limit
    tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all("limit=" in t for t in tail)


def test_judge_takes_the_worst_and_counts_failed_calls():
    limits = {"a": {"limit": 1.0}, "b": {"limit": 2.0}}
    checks, failed = harness.judge([(3, {"a": 0.5, "b": 1.0}), (2, {"a": 1.5, "b": 0.1})],
                                   limits)
    assert checks["a"] == {"value": 1.5, "limit": 1.0, "ok": False}
    assert checks["b"]["value"] == 1.0 and checks["b"]["ok"]
    assert failed == 2
    checks, failed = harness.judge([(1, {"a": float("nan")})], limits)
    assert not checks["a"]["ok"] and failed == 1
    checks, failed = harness.judge([(1, {"c": 0.0})], limits)  # a number without a limit
    assert not checks["c"]["ok"] and checks["c"]["limit"] is None


def _run(args, env_extra=None, cwd=ROOT):
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, os.path.join(BENCH, "run.py")] + args, env=env,
                          cwd=cwd, capture_output=True, text=True, timeout=120)


ARGS = ["--workload", "glm1-lbfgs-32m", "--seed", "1", "--seconds", "1", "--trace", "0"]


def test_armed_fault_plan_refuses_to_measure():
    plan = json.dumps({"rules": [{"point": "cd.step.boundary", "action": "raise"}]})
    proc = _run(ARGS, {"PHOTON_FAULT_PLAN": plan})
    assert proc.returncode == 5
    assert "fault injection armed" in proc.stderr
    line = _last_json(proc.stdout)
    assert line["correct"] is False and line["attempted"] == 0 and line["metrics"] == {}


def test_no_card_means_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run(ARGS)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_unknown_workload_is_refused():
    proc = _run(["--workload", "nope", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _py_files(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _py_files(BENCH):
        assert not _top_level_imports(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(BENCH, "reference")):
        names = _top_level_imports(path)
        assert "photon_ml_tpu_torch" not in names and not names & set(harness.FORBIDDEN), path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "photon_ml_tpu_torch.lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    monkeypatch.setitem(sys.modules, "photon_ml_tpu.ops", sys)
    assert harness.forbidden_modules() == ["jaxlib", "photon_ml_tpu"]


DRY_RUN = """
import sys, time, json, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import SMALL, small
from benchmark import harness
for name in SMALL:
    cell, devices = small(name)
    harness.measure(cell, 5, 0.01, False, time.perf_counter(), devices)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_dry_run_of_every_cell_loads_no_jax():
    """Every driver, its program entry and the reference, run on the CPU in
    a fresh process: no module named jax, jaxlib, flax or photon_ml_tpu (a
    whole top-level name: photon_ml_tpu_torch is the program) is loaded."""
    code = DRY_RUN.format(root=ROOT, tests=os.path.dirname(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "photon_ml_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)
