"""The port's staged GLM driver against the JAX package's
(tests/test_glm_driver.py), on the CPU:

- the stage sequences (train only, and with validation), the out-of-order
  assertion, normalization, and the validation feature space pinned to
  training's;
- the best lambda equals the JAX ``GLMDriver``'s; each lambda's metric map
  and text model agree at tests/test_torch_game.py's fit tolerances (rtol
  1e-3, atol 1e-3), and each npz model loads in the JAX package;
- ``"diagnostics": true``, ``trace_out`` and ``telemetry_out`` are refused.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from photon_ml_tpu.cli.glm import GLMDriver as JGLMDriver
from photon_ml_tpu.testing import write_libsvm
from photon_ml_tpu_torch.cli.glm import DriverStage, GLMDriver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def libsvm_files(tmp_path_factory):
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("glm")
    w = np.asarray([1.5, -2.0, 0.0, 1.0, 0.5, -1.0, 0.0, 0.8, -0.3, 0.2])

    def write(path, n, d=10):
        X = (rng.random((n, d)) < 0.5) * rng.normal(size=(n, d))
        y = np.sign(X @ w + 0.2 * rng.normal(size=n))
        return write_libsvm(str(path), X, y)

    return tmp, write(tmp / "train.libsvm", 300), write(tmp / "val.libsvm", 150)


def _config(train, val=None, **kw):
    cfg = {"task": "logistic", "input": {"format": "libsvm", "paths": [train]},
           "optimizer": {"regularization": "l2"}, "lambdas": [10.0, 1.0, 0.1], **kw}
    if val:
        cfg["validation"] = {"paths": [val]}
    return cfg


def test_stage_sequence_train_only(libsvm_files):
    _, train, _ = libsvm_files
    summary = GLMDriver(_config(train), device="cpu").run()
    assert summary["stages"] == ["INIT", "PREPROCESSED", "TRAINED"]
    assert summary["best_lambda"] is None
    assert len(summary["lambdas"]) == 3


def test_stage_assertion_rejects_out_of_order(libsvm_files):
    _, train, _ = libsvm_files
    driver = GLMDriver(_config(train), device="cpu")
    with pytest.raises(RuntimeError, match="PREPROCESSED"):
        driver._assert_stage(DriverStage.PREPROCESSED)
    driver.preprocess()
    driver._update_stage(DriverStage.PREPROCESSED)
    driver._assert_stage(DriverStage.PREPROCESSED)


def _text_models(text_dir):
    """{file: {index: value}} of the text models under ``text_dir``."""
    out = {}
    for name in sorted(os.listdir(text_dir)):
        with open(os.path.join(text_dir, name)) as f:
            rows = [line.split("\t") for line in f.read().strip().splitlines()]
        out[name] = {int(r[0]): float(r[1]) for r in rows}
    return out


@pytest.mark.parametrize("normalization", ["none", "standardization",
                                           "scale_with_standard_deviation"])
def test_full_pipeline_agrees_with_the_jax_driver(libsvm_files, normalization):
    from photon_ml_tpu.data.model_store import load_glm as j_load_glm

    tmp, train, val = libsvm_files
    out = {p: str(tmp / f"{p}_{normalization}") for p in ("jax", "port")}
    cfg = _config(train, val, normalization=normalization, compute_variances=True)
    got = {"jax": JGLMDriver(cfg, output_dir=out["jax"]).run(),
           "port": GLMDriver(cfg, output_dir=out["port"], device="cpu").run()}
    t, j = got["port"], got["jax"]
    assert t["stages"] == j["stages"] == ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED"]
    assert t["lambdas"] == j["lambdas"]
    assert t["best_lambda"] == j["best_lambda"]
    assert t["best_metric"] == pytest.approx(j["best_metric"], rel=1e-3, abs=1e-3)
    assert sorted(t["metrics"]) == sorted(j["metrics"]) == ["0.1", "1.0", "10.0"]
    for lam, metrics in j["metrics"].items():
        assert sorted(t["metrics"][lam]) == sorted(metrics)
        for name, v in metrics.items():
            # nan_ok: a mean that saturates to 1.0 in float32 makes the
            # reference's log-likelihood (and AIC) NaN, and the port's too
            assert t["metrics"][lam][name] == pytest.approx(v, rel=1e-3, abs=1e-3,
                                                            nan_ok=True), (lam, name)
    tm, jm = _text_models(t["models_text_dir"]), _text_models(j["models_text_dir"])
    assert sorted(tm) == sorted(jm) == ["lambda-0.1.txt", "lambda-1.0.txt", "lambda-10.0.txt"]
    for name in jm:
        assert sorted(tm[name]) == sorted(jm[name])
        np.testing.assert_allclose([tm[name][k] for k in sorted(jm[name])],
                                   [jm[name][k] for k in sorted(jm[name])], **FIT_TOL)
    first = open(os.path.join(t["models_text_dir"], "lambda-1.0.txt")).readline().split("\t")
    assert len(first) == 3  # the variance column
    m = j_load_glm(os.path.join(out["port"], "models", "lambda-1.0"))
    assert m.task == "logistic" and m.coefficients.variances is not None
    np.testing.assert_allclose(np.asarray(m.coefficients.means),
                               [tm["lambda-1.0.txt"].get(k, 0.0)
                                for k in range(len(m.coefficients.means))], rtol=1e-6)


def test_validation_feature_space_pinned_to_training(tmp_path):
    rng = np.random.default_rng(3)
    d = 12
    w = rng.normal(size=d)
    Xt = (rng.random((200, d)) < 0.5) * rng.normal(size=(200, d))
    Xt[0, d - 1] = 1.0  # training reaches feature id d
    yt = np.sign(Xt @ w + 0.1 * rng.normal(size=200))
    Xv = Xt[:80].copy()
    Xv[:, d - 1] = 0.0  # validation never holds the highest feature id
    yv = np.sign(Xv @ w + 0.1 * rng.normal(size=80))
    train = write_libsvm(str(tmp_path / "t.libsvm"), Xt, yt)
    val = write_libsvm(str(tmp_path / "v.libsvm"), Xv, yv)
    cfg = _config(train, val, normalization="standardization")
    summary = GLMDriver(cfg, device="cpu").run()
    assert summary["stages"][-1] == "VALIDATED"
    assert summary["best_metric"] > 0.8  # the same planted model: a real AUC
    assert summary["best_lambda"] == JGLMDriver(cfg).run()["best_lambda"]


@pytest.mark.parametrize("extra,key", [
    pytest.param({"diagnostics": True, "trace_out": "t.jsonl"}, "trace_out", id="extra0-11"),
    pytest.param({"trace_out": "t.jsonl"}, "trace_out", id="extra1-14"),
    pytest.param({"telemetry_out": "t.jsonl"}, "telemetry_out", id="extra2-14")])
def test_unported_stages_and_keys_are_refused(libsvm_files, extra, key):
    """The diagnostics stage and the ``trace_out``/``telemetry_out`` keys are
    ported: a trace holds every stage's span (the DIAGNOSED stage's too)
    and a Perfetto file beside it; a telemetry file one metrics line."""
    from photon_ml_tpu_torch import telemetry as TT

    tmp, train, val = libsvm_files
    path = tmp / f"{key}-{len(extra)}.jsonl"
    TT.reset()
    summary = GLMDriver(_config(train, val, **{**extra, key: str(path)}), device="cpu").run()
    TT.reset()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    if key == "telemetry_out":
        assert [x["type"] for x in lines] == ["metrics"]
        return
    names = {x.get("name") for x in lines}
    assert {"preprocess", "train", "validate", "write models"} <= names
    assert ("diagnose" in names) == ("diagnostics" in extra) == \
        (summary["stages"][-1] == "DIAGNOSED")
    assert os.path.exists(str(path)[:-len(".jsonl")] + ".perfetto.json")


def test_cli_glm_subprocess(libsvm_files):
    tmp, train, val = libsvm_files
    cfg_path = tmp / "glm.json"
    cfg_path.write_text(json.dumps(_config(train, val, output_dir=str(tmp / "o"))))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.cli", "glm",
                           "--config", str(cfg_path), "--device", "cpu"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["stages"][-1] == "VALIDATED"
    # the trace and telemetry sinks: the stages' spans, a Perfetto file, a
    # metrics line
    from photon_ml_tpu_torch import telemetry as TT
    from photon_ml_tpu_torch.cli.glm import main

    TT.reset()
    trace, tele = tmp / "glm.trace.jsonl", tmp / "glm.metrics.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["--config", str(cfg_path), "--device", "cpu", "--trace-out", str(trace),
                     "--telemetry-out", str(tele)]) == 0
    TT.reset()
    names = {json.loads(x).get("name") for x in trace.read_text().splitlines()}
    assert {"preprocess", "train", "validate", "write models"} <= names
    doc = json.loads((tmp / "glm.trace.perfetto.json").read_text())
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"} >= {"train"}
    (line,) = [json.loads(x) for x in tele.read_text().splitlines()]
    assert line["type"] == "metrics" and "counters" in line["snapshot"]
