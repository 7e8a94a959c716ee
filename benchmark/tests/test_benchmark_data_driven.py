"""A later cell comes as new files and new entries only: in a copy of the
benchmark, a new configuration, traffic, metric and cell are found by name
and run, and no file that was there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

NEW_METRIC = '''"""Calls a second of the window."""


def read(ctx):
    return ctx.calls / ctx.seconds
'''

RUN = """
import sys, time, json, torch
sys.path.insert(0, {copy!r})
from benchmark import harness
assert harness.ROOT == {copy!r}, harness.ROOT
cell = harness.load_cell("glm2-lbfgs-tiny", root={copy!r})
for trace in (False, True):
    res = harness.measure(cell, 9, 0.05, trace, time.perf_counter(), [torch.device("cpu")])
    print(json.dumps(res))
"""


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_config_traffic_and_metric_are_found_by_name(tmp_path):
    copy = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(copy, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    os.symlink(os.path.join(ROOT, "photon_ml_tpu_torch"),
               os.path.join(copy, "photon_ml_tpu_torch"))
    before = _digests(os.path.join(copy, "benchmark"))

    bench = os.path.join(copy, "benchmark")
    glm1 = json.load(open(os.path.join(bench, "configs", "glm1.json")))
    glm1.update(name="glm2", num_features=300, nnz_per_row=7)
    json.dump(glm1, open(os.path.join(bench, "configs", "glm2.json"), "w"))
    json.dump({"driver": "train_glm", "rows": 2000, "data_seed": 3},
              open(os.path.join(bench, "traffic", "lbfgs_tiny.json"), "w"))
    open(os.path.join(bench, "metrics", "calls_per_s.py"), "w").write(NEW_METRIC)
    json.dump({"loss_gap": {"limit": 1e-3}, "grad_ratio": {"limit": 0.5}},
              open(os.path.join(bench, "limits", "glm2-lbfgs-tiny.json"), "w"))
    spec_path = os.path.join(copy, "BENCHMARK.json")
    spec = json.load(open(spec_path))
    spec["configs"].append({"name": "glm2", "source": "https://github.com/linkedin/photon-ml",
                            "file": "benchmark/configs/glm2.json", "reduced": [],
                            "why": "a narrower GLM"})
    spec["workloads"].append({"name": "glm2-lbfgs-tiny", "config": "glm2",
                              "traffic": "lbfgs_tiny", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                              "source": "host_clock", "layer": "whole step", "moves": "fit_s",
                              "workloads": ["glm2-lbfgs-tiny"]})
    json.dump(spec, open(spec_path, "w"))

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", RUN.format(copy=copy)], capture_output=True,
                          text=True, timeout=300, cwd=copy, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    untraced, traced = (json.loads(x) for x in proc.stdout.strip().splitlines()[-2:])
    assert set(untraced["metrics"]) == {"fit_s", "peak_mem_gib", "setup_s"}
    assert "calls_per_s" in traced["metrics"]
    assert untraced["correct"] is True and traced["correct"] is True
    assert set(untraced["checks"]) == {"loss_gap", "grad_ratio"}

    after = _digests(os.path.join(copy, "benchmark"))
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {"configs/glm2.json", "traffic/lbfgs_tiny.json",
                                        "metrics/calls_per_s.py",
                                        "limits/glm2-lbfgs-tiny.json"}
