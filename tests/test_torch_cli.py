"""The port's CLI drivers against the JAX package's (tests/test_cli.py's
end-to-end and index tests, on its 240-row ``avro_dataset``), on the CPU:

- ``cli train`` in both packages, in process, on the same Avro files (the
  JAX driver with ``"heartbeat": false``);
- each package's saved model loads in the other, and the two fits agree at
  tests/test_torch_game.py's fit tolerances (rtol 1e-3, atol 1e-3), fixed
  effect and per-entity coefficients both;
- the saved index maps are equal key for key, the feature statistics agree
  within rtol 1e-5;
- ``cli score``'s ScoringResultAvro reads in the JAX package: the port's
  and the JAX driver's scores of one model agree within tests/
  test_model_store.py's rtol 1e-6 / atol 1e-7, their metrics within 1e-6;
- ``cli index`` writes equal maps;
- every key, flag and subcommand the port refuses raises
  ``NotImplementedError`` naming its ROADMAP item; the incremental refresh's
  key, flags and ``refresh`` subcommand (ported, tests/test_torch_incremental.py)
  raise what the reference raises for the same argv; the checkpoint key and
  ``--checkpoint-dir``, ``--checkpoint-every`` and ``--resume`` (refused
  until ROADMAP item 10 was ported) write and resume checkpoints, as in the
  reference (tests/test_checkpoint.py's CLI cases); the ``xprof`` key and
  ``--xprof-dir`` train (the CPU refuses the capture window, as the
  reference's CPU backend does), ``--xprof-arm`` alone and ``profile``
  without ``--profile-dir`` are usage errors, as in the reference;
- ``python -m photon_ml_tpu_torch.cli train --device cpu`` runs in a
  subprocess, with a config-loaded event listener, and a SIGTERM in the
  middle of its fit leaves a checkpoint, an ``interrupted`` summary and exit
  code 75;
- ``cli train`` with a ``sweep`` key (and ``--sweep``) against the JAX
  driver's sweep: the same lambdas per config, the same selected config, the
  per-config validation metrics within 1e-3 (the fits agree at FIT_TOL), the
  winner saved under ``best/`` with its index maps; ``cli sweep`` selects as
  an in-process ``fit_sweep`` on the same datasets does; a sweep refuses a
  checkpoint and a missing validation input as the reference does;
- ``cli glm`` with ``"diagnostics": true`` ends DIAGNOSED, writes both report
  files with the fitting curves and the bootstrap chapter, and its VALIDATED
  results are bit for bit those of the run without diagnostics.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import index as j_index
from photon_ml_tpu.cli import score as j_score
from photon_ml_tpu.cli import train as j_train
from photon_ml_tpu.data import avro as JA
from photon_ml_tpu.data import model_store as JM
from photon_ml_tpu_torch.cli import __main__ as t_cli
from photon_ml_tpu_torch.cli import index as t_index
from photon_ml_tpu_torch.cli import score as t_score
from photon_ml_tpu_torch.cli import train as t_train
from photon_ml_tpu_torch.data import avro as TA
from photon_ml_tpu_torch.data import model_store as TM
from photon_ml_tpu_torch.incremental import WarmStartError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_TOL = dict(rtol=1e-3, atol=1e-3)
SCORE_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def avro_dataset(tmp_path_factory):
    rng = np.random.default_rng(99)
    tmp = tmp_path_factory.mktemp("cli")
    n, d, n_users = 240, 8, 6
    X = rng.normal(size=(n, d))
    users = rng.integers(0, n_users, n)
    w = rng.normal(size=d)
    u_eff = rng.normal(size=n_users)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ w + u_eff[users])))).astype(float)

    def recs(lo, hi):
        for i in range(lo, hi):
            yield {"uid": str(i), "label": float(y[i]),
                   "features": [{"name": f"c{j}", "term": "", "value": float(X[i, j])}
                                for j in range(d)],
                   "metadataMap": {"userId": str(users[i])}, "weight": None, "offset": None}

    train_path, score_path = str(tmp / "train.avro"), str(tmp / "holdout.avro")
    JA.write_avro(train_path, JA.TRAINING_EXAMPLE_AVRO, recs(0, 200))
    JA.write_avro(score_path, JA.TRAINING_EXAMPLE_AVRO, recs(200, 240))
    return tmp, train_path, score_path


def _input(path):
    return {"format": "avro", "paths": [path], "feature_shards": {"global": ["features"]},
            "id_columns": ["userId"]}


def _config(train_path, out):
    return {
        "task": "logistic",
        "input": _input(train_path),
        "coordinates": {
            "fixed": {"type": "fixed_effect", "shard_name": "global",
                      "optimizer": {"regularization": "l2", "regularization_weight": 0.1}},
            "perUser": {"type": "random_effect", "shard_name": "global", "id_name": "userId",
                        "optimizer": {"regularization": "l2", "regularization_weight": 1.0}},
        },
        "num_iterations": 1,
        "output_dir": out,
        "heartbeat": False,
    }


@pytest.fixture(scope="module")
def trained(avro_dataset):
    tmp, train_path, _ = avro_dataset
    out = {"jax": str(tmp / "jax_model"), "port": str(tmp / "port_model")}
    summaries = {"jax": j_train.run(_config(train_path, out["jax"])),
                 "port": t_train.run(_config(train_path, out["port"]), device="cpu")}
    return out, summaries


def test_train_summaries_and_artifacts(trained):
    out, summaries = trained
    for pkg in ("jax", "port"):
        s = summaries[pkg]
        assert s["num_rows"] == 200 and s["output_dir"] == out[pkg]
        assert [(e["iteration"], e["coordinate"]) for e in s["history"]] == \
            [(0, "fixed"), (0, "perUser")]
        for sub in ("final", "best"):
            assert os.path.exists(os.path.join(out[pkg], sub, "model-metadata.json"))
            assert os.path.isdir(os.path.join(out[pkg], sub, "feature-indexes", "global"))
        assert os.path.exists(os.path.join(out[pkg], "feature-stats", "global.avro"))
    json.dumps(summaries["port"])  # JSON-safe as the driver prints it
    # the guard ran (on by default) and did nothing on healthy data
    assert not any("solve_retries" in e for e in summaries["port"]["history"])


def _dense_re(model, n_features):
    """A random effect as a dense [entity value -> global coefficients] map."""
    out = {}
    for b in model.buckets:
        coef, proj = np.asarray(b.coefficients), np.asarray(b.projection)
        for e, code in enumerate(np.asarray(b.entity_codes)):
            row = np.zeros(n_features)
            keep = proj[e] < n_features
            row[proj[e][keep]] = coef[e][keep]
            out[str(model.vocab[code])] = row
    return out


def _coefficients(model_dir, loader):
    model = loader(model_dir)
    fe = np.asarray(model.models["fixed"].coefficients)
    return fe, _dense_re(model.models["perUser"], len(fe))


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_models_load_in_the_other_package_and_agree(trained, saved_by):
    out, _ = trained
    final = os.path.join(out[saved_by], "final")
    other = os.path.join(out["port" if saved_by == "jax" else "jax"], "final")
    port_load = lambda p: TM.load_game_model(p, device="cpu")  # noqa: E731
    fe, re = _coefficients(final, port_load if saved_by == "jax" else JM.load_game_model)
    fe_same, re_same = _coefficients(final, port_load if saved_by == "port"
                                     else JM.load_game_model)
    # loaded by either package, one model has one set of coefficients
    np.testing.assert_array_equal(fe, fe_same)
    assert sorted(re) == sorted(re_same)
    for k in re:
        np.testing.assert_array_equal(re[k], re_same[k])
    # and the two packages' fits agree
    fe_o, re_o = _coefficients(other, port_load)
    np.testing.assert_allclose(fe, fe_o, **FIT_TOL)
    assert sorted(re) == sorted(re_o)
    for k in re:
        np.testing.assert_allclose(re[k], re_o[k], **FIT_TOL)


def test_index_maps_and_feature_stats_agree(trained):
    out, _ = trained
    maps = {pkg: TM.load_feature_index_maps(os.path.join(out[pkg], "final"))
            for pkg in ("jax", "port")}
    assert list(maps["port"]["global"].items()) == list(maps["jax"]["global"].items())
    stats = {pkg: JA.read_feature_summary(os.path.join(out[pkg], "feature-stats",
                                                       "global.avro"))
             for pkg in ("jax", "port")}
    assert stats["port"] == TA.read_feature_summary(os.path.join(out["port"], "feature-stats",
                                                                 "global.avro"))
    assert sorted(stats["port"]) == sorted(stats["jax"])
    for key, metrics in stats["jax"].items():
        assert sorted(metrics) == sorted(stats["port"][key])
        for m, v in metrics.items():
            np.testing.assert_allclose(stats["port"][key][m], v, rtol=1e-5, err_msg=(key, m))


def test_score_writes_what_the_jax_package_reads(avro_dataset, trained):
    tmp, _, score_path = avro_dataset
    out, _ = trained
    model_dir = os.path.join(out["port"], "final")
    paths = {pkg: str(tmp / f"scores_{pkg}.avro") for pkg in ("jax", "port")}
    evaluators = ["auc", "logistic_loss"]
    got = {"port": t_score.run(model_dir, _input(score_path), output_path=paths["port"],
                               evaluators=evaluators, model_id="m", device="cpu"),
           "jax": j_score.run(model_dir, _input(score_path), output_path=paths["jax"],
                              evaluators=evaluators, model_id="m")}
    recs = {pkg: JA.read_scoring_results(p) for pkg, p in paths.items()}
    assert got["port"]["num_rows"] == len(recs["port"]) == 40
    assert all(r["modelId"] == "m" for r in recs["port"])
    np.testing.assert_array_equal([r["label"] for r in recs["port"]],
                                  [r["label"] for r in recs["jax"]])
    np.testing.assert_allclose([r["predictionScore"] for r in recs["port"]],
                               [r["predictionScore"] for r in recs["jax"]], **SCORE_TOL)
    for m in evaluators:
        assert got["port"]["metrics"][m] == pytest.approx(got["jax"]["metrics"][m], abs=1e-6)
    assert got["port"]["metrics"]["auc"] > 0.6  # a true holdout


def test_score_refuses_a_model_without_index_maps(avro_dataset, trained, tmp_path):
    import shutil

    _, _, score_path = avro_dataset
    out, _ = trained
    bare = str(tmp_path / "bare")
    shutil.copytree(os.path.join(out["port"], "final"), bare)
    shutil.rmtree(os.path.join(bare, "feature-indexes"))
    with pytest.raises(TM.ModelLoadError, match="allow-index-rebuild"):
        t_score.run(bare, _input(score_path), device="cpu")
    assert t_score.run(bare, _input(score_path), allow_index_rebuild=True,
                       device="cpu")["num_rows"] == 40


def test_index_job_writes_equal_maps(avro_dataset, tmp_path, capsys):
    _, train_path, _ = avro_dataset
    from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap

    args = ["--input", train_path, "--shards", "global:features", "g2:features"]
    assert t_index.main(args + ["--output", str(tmp_path / "t")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["global"]["num_features"] == 9  # 8 features + the intercept
    assert j_index.main(args + ["--output", str(tmp_path / "j")]) == 0
    for shard in ("global", "g2"):
        t, j = (IndexMap.load(str(tmp_path / p / shard)) for p in ("t", "j"))
        assert list(t.items()) == list(j.items()) and INTERCEPT_KEY in t
        for f in ("hashes.npy", "ids.npy", "names.json"):
            assert open(tmp_path / "t" / shard / f, "rb").read() == \
                open(tmp_path / "j" / shard / f, "rb").read()
    assert t_index.main(["--input", train_path, "--output", str(tmp_path / "n"),
                         "--no-intercept"]) == 0
    assert INTERCEPT_KEY not in IndexMap.load(str(tmp_path / "n" / "features"))


REFUSED_KEYS = [
    # the sweep and publishing its winner to a registry are ported: the key
    # reaches the sweep, which needs a validation split
    pytest.param({"sweep": {"grid": ["lambda=1,2"], "registry_dir": "r"}},
                 (ValueError, "validation split"), id='{"sweep": {"grid": ["lambda=1,-11'),
    # the incremental refresh is ported: a base directory that does not exist
    # is the reference's typed error
    pytest.param({"warm_start": {"dir": "x"}}, (WarmStartError, "does not exist"),
                 id='{"warm_start": {"dir": "x"}}-14'),
    # the fleet's key is ported: a fleet of one process trains (None)
    pytest.param({"distributed": {"num_processes": 1}}, None, id='{"mesh": true}-12'),
    # the trace, telemetry and report sinks and the heartbeat are ported: the
    # run trains and writes its file (None); so is the executable profiler's
    # capture window, which the CPU refuses as the reference's CPU backend
    # does: the run trains without it
    *[pytest.param(extra, None, id=f"{json.dumps(extra)[:30]}-14") for extra in [
        {"trace_out": "t.jsonl"}, {"telemetry_out": "t.jsonl"}, {"report_out": "r.md"},
        {"heartbeat": {"every": 5}}, {"heartbeat": 5}]],
    pytest.param({"xprof": "x"}, None, id='{"xprof": "x"}-14'),
]

# the sinks whose relative paths the tests below put under tmp_path
_SINK_KEYS = ("trace_out", "telemetry_out", "report_out")


@pytest.mark.parametrize("extra,item", REFUSED_KEYS, ids=lambda v: json.dumps(v)[:30])
def test_train_refuses_unported_keys(avro_dataset, extra, item, tmp_path):
    _, train_path, _ = avro_dataset
    config = _config(train_path, None)
    for k, v in extra.items():
        config[k] = ({**config[k], **v} if k == "input"
                     else str(tmp_path / v) if k in _SINK_KEYS else v)
    if item is None:  # ported: the run trains
        assert t_train.run(config, device="cpu")["num_rows"] == 200
        for k in _SINK_KEYS:
            if k in config:
                assert os.path.getsize(config[k]) > 0, k
        return
    exc, match = ((NotImplementedError, rf"item {re.escape(str(item))}\)")
                  if isinstance(item, (int, str)) else item)
    with pytest.raises(exc, match=match):
        t_train.run(config, device="cpu")


# a GAME sweep with --mesh is refused as the reference refuses it
_SWEEP_WITH_MESH = (ValueError, "mesh training is not supported with a GAME sweep")

REFUSED_FLAGS = [
    # the sweep and mesh flags are ported; together they are the reference's
    # ValueError, each flag reaching the config through main()
    pytest.param(["--sweep", "lambda=1,2", "--mesh", "auto"], "plain", _SWEEP_WITH_MESH,
                 id="['--sweep', 'lambda=1,2']-11"),
    pytest.param(["--sweep-metric", "auc", "--mesh", "auto"], "sweep", _SWEEP_WITH_MESH,
                 id="['--sweep-metric', 'auc']-11"),
    pytest.param(["--sweep-policy", "best", "--mesh", "batch=2"], "sweep", _SWEEP_WITH_MESH,
                 id="['--sweep-policy', 'best']-11"),
    # publishing the winner is ported: the flag needs a grid (argparse's exit)
    pytest.param(["--sweep-registry-dir", "r"], "plain", (SystemExit, "2"),
                 id="['--sweep-registry-dir', 'r']-11"),
    # a factored random effect on a mesh is ported: it trains (None)
    pytest.param(["--mesh", "auto"], "factored", None, id="['--mesh', 'auto']-12"),
    # the incremental refresh's flags are ported: on a plain config, what the
    # reference raises for the same argv (a base that does not exist; the
    # other three without --warm-start are argparse's error)
    pytest.param(["--warm-start", "d"], "plain", (WarmStartError, "does not exist"),
                 id="['--warm-start', 'd']-14"),
    *[pytest.param(flags, "plain", (SystemExit, "2"), id=f"{flags}-14") for flags in [
        ["--delta", "d.avro"], ["--refresh-registry-dir", "r"], ["--lambda-points", "3"]]],
    # the sinks and the heartbeat's interval are ported: the run trains (None)
    *[pytest.param(flags, "plain", None, id=f"{flags}-14") for flags in [
        ["--trace-out", "t"], ["--telemetry-out", "t"], ["--report-out", "r"],
        ["--heartbeat-every", "5"]]],
    # the capture window's flags are ported: --xprof-dir trains (the CPU
    # refuses the capture, as the reference's CPU backend does), --xprof-arm
    # alone is the reference's usage error
    pytest.param(["--xprof-dir", "x"], "plain", None, id="['--xprof-dir', 'x']-14"),
    pytest.param(["--xprof-arm", "3"], "plain", (SystemExit, "2"),
                 id="['--xprof-arm', '3']-14"),
]


@pytest.mark.parametrize("flags,config,refusal", REFUSED_FLAGS)
def test_train_refuses_unported_flags(avro_dataset, flags, config, refusal, tmp_path):
    """Each flag through main(): an unported flag names its item before the
    config is read; the mesh flag reaches the config's refusals."""
    path = tmp_path / "config.json"
    if config is not None:
        cfg = _config(avro_dataset[1], None)
        if config == "sweep":
            cfg["sweep"] = {"grid": "lambda=1,2"}
        if config == "factored":
            cfg["coordinates"]["perUser"] = {
                "type": "factored_random_effect", "shard_name": "global", "id_name": "userId",
                "latent_dim": 2}
        path.write_text(json.dumps(cfg))
    if flags[0] in ("--trace-out", "--telemetry-out", "--report-out"):
        flags = [flags[0], str(tmp_path / flags[1])]
    if flags[0] == "--xprof-dir":
        flags = [flags[0], str(tmp_path / flags[1])]
    if refusal is None:  # ported: the run trains
        assert t_train.main(["--config", str(path), "--device", "cpu", *flags]) == 0
        if flags[0] == "--xprof-dir":
            assert not os.path.exists(flags[1])  # no capture on the CPU
        elif flags[0] != "--heartbeat-every" and flags[0] != "--mesh":
            assert os.path.getsize(flags[1]) > 0
        return
    exc, match = ((NotImplementedError, rf"item {re.escape(str(refusal))}\)")
                  if isinstance(refusal, (int, str)) else refusal)
    with pytest.raises(exc, match=match):
        t_train.main(["--config", str(path), "--device", "cpu", *flags])


def _phase_paths(node, prefix=()):
    out = set()
    for child in node.children.values():
        path = prefix + (child.name,)
        out |= {path} | _phase_paths(child, path)
    return out


def test_train_trace_telemetry_and_report_match_the_jax_package(avro_dataset, tmp_path):
    """``cli train`` of both packages with ``trace_out``, ``telemetry_out``,
    ``report_out``, a 0.05 s heartbeat and a checkpoint: the same phase-tree
    paths (the port's own ``re_build:*``/``re_coo_layout`` spans besides),
    the same coordinate table (steps, retries, rollbacks, frozen), the same
    key-metric names but the compile counters (on the CPU the port compiles
    nothing: ROADMAP.md Queue 3 item 5) and the reference's MFU keys,
    heartbeat lines, a Perfetto file, and ``cli report`` of the
    port's artifacts equal to the report the run wrote."""
    from photon_ml_tpu import telemetry as JT
    from photon_ml_tpu.telemetry.report import RunReport as JRunReport
    from photon_ml_tpu_torch import telemetry as TT
    from photon_ml_tpu_torch.telemetry.report import RunReport

    _, train_path, _ = avro_dataset
    cfg = {}
    for pkg in ("jax", "port"):
        cfg[pkg] = {**_config(train_path, str(tmp_path / f"{pkg}-model")),
                    "num_iterations": 2, "heartbeat": {"every": 0.05},
                    "checkpoint": {"dir": str(tmp_path / f"{pkg}-ckpt"), "resume": False},
                    "trace_out": str(tmp_path / f"{pkg}.trace.jsonl"),
                    "telemetry_out": str(tmp_path / f"{pkg}.metrics.jsonl"),
                    "report_out": str(tmp_path / f"{pkg}.report.md")}
    JT.reset()
    j_train.run(cfg["jax"])
    JT.reset()
    TT.reset()
    summary = t_train.run(cfg["port"], device="cpu")
    TT.reset()
    assert summary["report"] == cfg["port"]["report_out"]
    assert summary["report_json"] == str(tmp_path / "port.report.json")
    reports = {
        "jax": JRunReport.load(cfg["jax"]["trace_out"],
                               cfg["jax"]["telemetry_out"], cfg["jax"]["checkpoint"]["dir"]),
        "port": RunReport.load(cfg["port"]["trace_out"], cfg["port"]["telemetry_out"],
                               cfg["port"]["checkpoint"]["dir"])}
    j_paths = _phase_paths(reports["jax"].phase_tree())
    t_paths = _phase_paths(reports["port"].phase_tree())
    assert j_paths <= t_paths
    assert {p[-1].split(":")[0] for p in t_paths - j_paths} == {"re_build", "re_coo_layout"}
    assert ("fit", "fit", "cd_iteration", "coordinate:perUser") in t_paths

    def table(report):
        return [(c["coordinate"], c["steps"], c["solve_retries"], c["rollbacks"], c["frozen"])
                for c in report.coordinate_summary()]

    assert table(reports["port"]) == table(reports["jax"]) == [
        ("fixed", 2, 0, 0, False), ("perUser", 2, 0, 0, False)]
    compile_counters = {"jit_compiles", "jit_compile_seconds", "xla_recompiles", "mfu"}
    j_names = {k for k in reports["jax"].key_metrics()
               if k not in compile_counters and not k.startswith("exec.")}
    assert set(reports["port"].key_metrics()) == j_names
    assert {"fit_seconds", "rows_per_sec", "coeffs_per_sec", "device_fetches"} <= j_names
    assert reports["port"].heartbeats and reports["jax"].heartbeats
    assert json.loads((tmp_path / "port.trace.perfetto.json").read_text())["traceEvents"]
    # cli report over the same artifacts renders what the run wrote
    out = tmp_path / "again.md"
    assert t_cli.main(["report", "--trace", cfg["port"]["trace_out"], "--telemetry",
                       cfg["port"]["telemetry_out"], "--checkpoint-dir",
                       cfg["port"]["checkpoint"]["dir"], "--out", str(out)]) == 0
    assert out.read_text() == (tmp_path / "port.report.md").read_text()


def _steps(path):
    return sorted(p for p in os.listdir(path) if p.startswith("step-"))


CHECKPOINT_CASES = [
    ({"checkpoint": {"dir": "ckpt", "every": 1, "keep_last": 2}}, [],
     ["step-00000002", "step-00000003"]),
    ({}, ["--checkpoint-dir", "ckpt"], ["step-00000001", "step-00000002", "step-00000003"]),
    ({"checkpoint": {"dir": "ckpt", "keep_last": 5}}, ["--checkpoint-every", "2"],
     ["step-00000001", "step-00000003"]),
    ({}, ["--checkpoint-dir", "ckpt", "--resume"],
     ["step-00000001", "step-00000002", "step-00000003"]),
]


@pytest.mark.parametrize("extra,flags,steps", CHECKPOINT_CASES,
                         ids=["key", "--checkpoint-dir", "--checkpoint-every", "--resume"])
def test_train_takes_the_checkpoint_key_and_flags(avro_dataset, tmp_path, extra, flags, steps):
    """Four updates (two CD iterations of two coordinates), a checkpoint
    after each as asked; a second run resumes past the last step and trains
    nothing, ending with the same model."""
    _, train_path, _ = avro_dataset
    config = {**_config(train_path, str(tmp_path / "out")), "num_iterations": 2}
    config.update({k: {**v, "dir": str(tmp_path / v["dir"])} for k, v in extra.items()})
    flags = [str(tmp_path / f) if f == "ckpt" else f for f in flags]
    cfg_path = tmp_path / "train.json"
    cfg_path.write_text(json.dumps(config))
    argv = ["--config", str(cfg_path), "--device", "cpu", *flags]
    assert t_train.main(argv) == 0
    assert _steps(tmp_path / "ckpt") == steps
    for step in steps:
        assert os.path.exists(tmp_path / "ckpt" / step / "manifest.json")
    first = TM.load_game_model(str(tmp_path / "out" / "final"), device="cpu")
    assert t_train.main(argv) == 0  # resumes after step 3: nothing left to train
    again = TM.load_game_model(str(tmp_path / "out" / "final"), device="cpu")
    assert torch.equal(first.models["fixed"].coefficients, again.models["fixed"].coefficients)


def test_checkpoint_flags_without_a_directory_are_a_usage_error(capsys, tmp_path):
    cfg_path = tmp_path / "train.json"
    cfg_path.write_text("{}")
    for flags in (["--resume"], ["--checkpoint-every", "2"]):
        with pytest.raises(SystemExit) as e:
            t_train.main(["--config", str(cfg_path), "--device", "cpu", *flags])
        assert e.value.code == 2
        assert "need --checkpoint-dir" in capsys.readouterr().err
    for bad, match in (({"every": 1}, "'dir'"), ({"dir": "x", "often": 1}, "often")):
        with pytest.raises(ValueError, match=match):
            t_train._parse_checkpoint_spec({"checkpoint": bad})
    assert t_train._parse_checkpoint_spec({}) is None


def test_sigterm_mid_fit_leaves_a_checkpoint_and_an_interrupted_summary(avro_dataset, tmp_path):
    """A listener sends the process SIGTERM at the first update's event: the
    driver finishes that step, writes its checkpoint, prints an interrupted
    summary and exits 75; rerun with the same arguments, it resumes."""
    _, train_path, _ = avro_dataset
    (tmp_path / "term_listener.py").write_text(
        "import os, signal\n"
        "def on_event(event):\n"
        "    if type(event).__name__ == 'OptimizationLogEvent' and not os.path.exists('sent'):\n"
        "        open('sent', 'w').close()\n"
        "        os.kill(os.getpid(), signal.SIGTERM)\n")
    config = {**_config(train_path, str(tmp_path / "out")), "num_iterations": 2,
              "checkpoint": {"dir": str(tmp_path / "ckpt")},
              "event_listeners": ["term_listener:on_event"]}
    cfg_path = tmp_path / "train.json"
    cfg_path.write_text(json.dumps(config))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(tmp_path) + os.pathsep + REPO
    argv = [sys.executable, "-m", "photon_ml_tpu_torch.cli", "train", "--config", str(cfg_path),
            "--device", "cpu"]
    proc = subprocess.run(argv, capture_output=True, text=True, cwd=str(tmp_path), env=env,
                          timeout=300)
    assert proc.returncode == 75, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["interrupted"] is True and summary["interrupted_at_step"] == 0
    assert summary["checkpoint"] == str(tmp_path / "ckpt" / "step-00000000")
    assert _steps(tmp_path / "ckpt") == ["step-00000000"]
    proc = subprocess.run(argv, capture_output=True, text=True, cwd=str(tmp_path), env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [e["coordinate"] for e in summary["history"]] == ["fixed", "perUser"] * 2
    assert _steps(tmp_path / "ckpt") == ["step-00000001", "step-00000002", "step-00000003"]


@pytest.mark.parametrize("cmd,item", [
                                      # refresh is ported: the missing config is what
                                      # fails, as for sweep
                                      pytest.param("refresh", (FileNotFoundError, "x.json"),
                                                   id="refresh-14"),
                                      # pipeline is ported: its other required flags
                                      # are what fails
                                      pytest.param("pipeline", (SystemExit, "2"),
                                                   id="pipeline-14"),
                                      # serve is ported: it takes no --config
                                      pytest.param("serve", (SystemExit, "2"), id="serve-14"),
                                      # report is ported: it takes no --config
                                      pytest.param("report", (SystemExit, "2"), id="report-14"),
                                      # profile is ported: it needs --profile-dir
                                      pytest.param("profile", (SystemExit, "2"),
                                                   id="profile-14"),
                                      # the sweep subcommand and its registry flag are
                                      # ported: the missing config is what fails
                                      pytest.param("sweep", (FileNotFoundError, "x.json"),
                                                   id="sweep-11")])
def test_unported_subcommands_raise(cmd, item):
    extra = ["--registry-dir", "r"] if cmd == "sweep" else []
    exc, match = ((NotImplementedError, rf"'{cmd}'.*item {re.escape(item)}\)")
                  if isinstance(item, str) else item)
    with pytest.raises(exc, match=match):
        t_cli.main([cmd, "--config", "x.json", *extra])


def test_dispatcher_usage_and_unknown_command(capsys):
    assert t_cli.main([]) == 2
    assert t_cli.main(["--help"]) == 0
    assert "photon_ml_tpu_torch.cli" in capsys.readouterr().out
    assert t_cli.main(["nope"]) == 2


def test_heartbeat_off_or_default_starts_nothing(avro_dataset, tmp_path):
    _, train_path, _ = avro_dataset
    config = _config(train_path, None)
    config["coordinates"] = {"fixed": config["coordinates"]["fixed"]}
    for hb in (True, False, None, 0):
        config["heartbeat"] = hb
        assert t_train.run(config, device="cpu")["num_rows"] == 200


def test_train_in_a_subprocess_with_an_event_listener(avro_dataset):
    tmp, train_path, _ = avro_dataset
    (tmp / "port_listeners.py").write_text(
        "class Recorder:\n"
        "    def __call__(self, event):\n"
        "        with open('port_events.log', 'a') as f:\n"
        "            f.write(type(event).__name__ + '\\n')\n")
    config = {"task": "logistic", "input": _input(train_path),
              "coordinates": {"fixed": {"type": "fixed_effect", "shard_name": "global",
                                        "optimizer": {"max_iterations": 5}}},
              "event_listeners": ["port_listeners:Recorder"],
              "output_dir": str(tmp / "sub_model")}
    cfg_path = tmp / "sub.json"
    cfg_path.write_text(json.dumps(config))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(tmp) + os.pathsep + REPO
    proc = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.cli", "train",
                           "--config", str(cfg_path), "--device", "cpu"],
                          capture_output=True, text=True, cwd=str(tmp), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["num_rows"] == 200
    log = (tmp / "port_events.log").read_text().splitlines()
    assert log[0] == "SetupEvent" and log[-1] == "TrainingFinishEvent"
    assert {"TrainingStartEvent", "OptimizationLogEvent"} <= set(log)
    model = TM.load_game_model(str(tmp / "sub_model" / "final"), device="cpu")
    assert torch.isfinite(model.models["fixed"].coefficients).all()


# -- sweeps --------------------------------------------------------------------


def _sweep_config(avro_dataset, out, grid="lambda=0.1,1,10"):
    _, train_path, score_path = avro_dataset
    return {**_config(train_path, out), "validation": {"paths": [score_path]},
            "evaluators": ["auc"], "sweep": {"grid": grid, "warm_start": False}}


def test_train_sweep_matches_the_jax_driver(avro_dataset, tmp_path):
    cfg_t = _sweep_config(avro_dataset, str(tmp_path / "t"))
    cfg_j = _sweep_config(avro_dataset, str(tmp_path / "j"))
    got = t_train.run(cfg_t, device="cpu")
    ref = j_train.run(cfg_j)
    sg, sr = got["sweep"], ref["sweep"]
    assert [c["lambdas"] for c in sg["configs"]] == [c["lambdas"] for c in sr["configs"]]
    assert sg["selected_index"] == sr["selected_index"] and sg["metric"] == sr["metric"] == "auc"
    np.testing.assert_allclose([c["metric"] for c in sg["configs"]],
                               [c["metric"] for c in sr["configs"]], atol=1e-3)
    assert got["best_metric"] == sg["selected_metric"]
    best = os.path.join(str(tmp_path / "t"), "best")
    assert os.path.isdir(os.path.join(best, "feature-indexes", "global"))
    port_model = TM.load_game_model(best, device="cpu")
    jax_model = JM.load_game_model(os.path.join(str(tmp_path / "j"), "best"))
    np.testing.assert_allclose(port_model.models["fixed"].coefficients.numpy(),
                               np.asarray(jax_model.models["fixed"].coefficients), **FIT_TOL)
    json.dumps(got)


def test_sweep_subcommand_selects_as_fit_sweep(avro_dataset, tmp_path, capsys):
    """cli sweep (the grid by flag) against an in-process fit_sweep on the
    datasets the driver reads; with ``--trace-out``, ``--telemetry-out``
    and ``--report-out`` its report holds the per-config sweep table."""
    from photon_ml_tpu_torch import telemetry as TT
    from photon_ml_tpu_torch.config import parse_game_config
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.sweep import parse_sweep_spec

    cfg = _sweep_config(avro_dataset, str(tmp_path / "o"))
    del cfg["sweep"]
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    TT.reset()
    assert t_cli.main(["sweep", "--config", str(path), "--sweep", "lambda=0.01:10:log4",
                       "--device", "cpu", "--trace-out", str(tmp_path / "s.trace.jsonl"),
                       "--telemetry-out", str(tmp_path / "s.metrics.jsonl"),
                       "--report-out", str(tmp_path / "s.report.md")]) == 0
    TT.reset()
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sweep"]
    md = (tmp_path / "s.report.md").read_text()
    assert "## Hyperparameter sweep" in md and "4/4 config(s) processed" in md
    assert f"selected config **#{summary['selected_index']}**" in md
    doc = json.loads((tmp_path / "s.report.json").read_text())
    assert [c["index"] for c in doc["sweep"]["configs"]] == [0, 1, 2, 3]
    assert doc["sweep"]["selected_index"] == summary["selected_index"]
    train, maps = t_train.read_input(cfg["input"], device="cpu")
    val, _ = t_train.read_input({**cfg["input"], **cfg["validation"]}, index_maps=maps,
                                device="cpu")
    fit = GameEstimator(parse_game_config(cfg)).fit_sweep(
        train, val, parse_sweep_spec("lambda=0.01:10:log4"), device="cpu")
    assert summary["selected_index"] == fit.selection.index
    assert summary["selected_metric"] == fit.selection.best_value
    assert len(summary["configs"]) == 4 and summary["policy"] == "best"


def test_train_sweep_flags(avro_dataset, tmp_path, capsys):
    cfg = _sweep_config(avro_dataset, str(tmp_path / "o"))
    del cfg["sweep"]
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    assert t_train.main(["--config", str(path), "--sweep", "lambda=0.1,1", "--sweep-policy",
                         "parsimonious", "--sweep-metric", "auc", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["sweep"]["policy"] == "parsimonious"
    assert [c["lambdas"]["fixed"] for c in summary["sweep"]["configs"]] == [1.0, 0.1]
    assert os.path.exists(tmp_path / "o" / "best" / "model-metadata.json")


def test_sweep_refusals_of_the_reference(avro_dataset, tmp_path):
    from photon_ml_tpu_torch.sweep import SweepSpecError

    cfg = _sweep_config(avro_dataset, None)
    with pytest.raises(ValueError, match="checkpointing is not supported with a sweep"):
        t_train.run({**cfg, "checkpoint": {"dir": str(tmp_path / "ck")}}, device="cpu")
    with pytest.raises(ValueError, match="needs a validation split"):
        t_train.run({k: v for k, v in cfg.items() if k != "validation"}, device="cpu")
    with pytest.raises(ValueError, match="unknown sweep config keys"):
        t_train.run({**cfg, "sweep": {"grid": "lambda=1", "nope": 1}}, device="cpu")
    with pytest.raises(SweepSpecError, match="inverted range"):
        t_train.run({**cfg, "sweep": "lambda=10:1:log3"}, device="cpu")
    with pytest.raises(ValueError, match="mesh training is not supported with a GAME sweep"):
        t_train.run({**cfg, "mesh": {"batch": 2}}, device="cpu")


def test_glm_diagnostics_stage(tmp_path):
    from photon_ml_tpu.testing import write_libsvm

    from photon_ml_tpu_torch.cli.glm import GLMDriver

    rng = np.random.default_rng(5)
    w = rng.normal(size=6)

    def write(name, n):
        X = (rng.random((n, 6)) < 0.6) * rng.normal(size=(n, 6))
        return write_libsvm(str(tmp_path / name), X, np.sign(X @ w + 0.2 * rng.normal(size=n)))

    train, val = write("t.libsvm", 300), write("v.libsvm", 120)
    cfg = {"task": "logistic", "input": {"format": "libsvm", "paths": [train]},
           "validation": {"paths": [val]}, "optimizer": {"regularization": "l2"},
           "lambdas": [10.0, 1.0]}
    plain = GLMDriver(cfg, device="cpu").run()
    out = str(tmp_path / "out")
    diag = GLMDriver({**cfg, "diagnostics": True, "bootstrap_samples": 4, "output_dir": out},
                     device="cpu").run()
    assert diag["stages"] == ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED", "DIAGNOSED"]
    # the same numbers bit for bit (json: a NaN metric equals itself)
    assert json.dumps([diag["best_lambda"], diag["best_metric"], diag["metrics"]]) == \
        json.dumps([plain["best_lambda"], plain["best_metric"], plain["metrics"]])
    text = open(diag["report"]["text"]).read()
    for title in ("Model diagnostics", "Hosmer-Lemeshow", "Fitting curves",
                  "Bootstrap confidence intervals", "# samples = [4]"):
        assert title in text
    assert open(diag["report"]["html"]).read().startswith("<!DOCTYPE html>")


def test_sweep_and_train_publish_the_winner_to_a_registry(avro_dataset, tmp_path, capsys):
    """``cli sweep --registry-dir`` and ``cli train --sweep-registry-dir``
    publish the winner with the input's index maps as the next registry
    versions; each loads in the port's registry and in the JAX package's,
    scoring as the saved ``best`` model does."""
    from photon_ml_tpu.serving import ModelRegistry as JRegistry
    from photon_ml_tpu_torch.serving import ModelRegistry

    cfg = _sweep_config(avro_dataset, str(tmp_path / "o"))
    del cfg["sweep"]
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    reg = str(tmp_path / "registry")
    assert t_cli.main(["sweep", "--config", str(path), "--sweep", "lambda=0.1,1",
                       "--registry-dir", reg, "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sweep"]
    assert summary["published_version"].endswith("v-00000001")
    assert t_train.main(["--config", str(path), "--sweep", "lambda=0.1,1",
                         "--sweep-registry-dir", reg, "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sweep"]
    assert summary["published_version"].endswith("v-00000002")
    published = TM.load_game_model(summary["published_version"], device="cpu")
    best = TM.load_game_model(os.path.join(str(tmp_path / "o"), "best"), device="cpu")
    for name, sub in best.models.items():
        other = published.models[name]
        if hasattr(sub, "buckets"):
            assert all(torch.equal(a.coefficients, b.coefficients)
                       for a, b in zip(sub.buckets, other.buckets))
        else:
            assert torch.equal(sub.coefficients, other.coefficients)
    port = ModelRegistry(reg, max_batch=4, warm=False, poll_interval=60, device="cpu").start()
    jax_reg = JRegistry(reg, max_batch=4, warm=False, poll_interval=60).start()
    try:
        assert port.engine.version == jax_reg.engine.version == "v-00000002"
        assert set(port.engine.index_maps) == set(jax_reg.engine.index_maps)
    finally:
        port.stop()
        jax_reg.stop()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_distributed_one_process_fleet_trains(avro_dataset):
    """``distributed`` with an explicit coordinator and one process joins a
    real gloo rendezvous of one and trains; the process group is left
    again afterwards."""
    from photon_ml_tpu_torch.parallel import multihost

    _, train_path, _ = avro_dataset
    config = {**_config(train_path, None), "distributed": {
        "coordinator_address": f"127.0.0.1:{_free_port()}", "num_processes": 1,
        "process_id": 0, "init_retries": 0}}
    try:
        summary = t_train.run(config, device="cpu")
        assert multihost.backend() == "gloo" and multihost.process_count() == 1
    finally:
        multihost.shutdown()
    assert summary["num_rows"] == 200


_TWO_PROCESS_TRAIN = """
import json, sys
from photon_ml_tpu_torch.cli import train
from photon_ml_tpu_torch.parallel import multihost
config = json.loads(sys.argv[1])
try:
    train.run(config, device="cpu")
    print("TRAINED")
except NotImplementedError as e:
    print("REFUSED", e)
finally:
    multihost.shutdown()
"""


def test_train_distributed_across_two_processes_is_refused(avro_dataset, tmp_path):
    """Two processes joining one fleet through ``cli train``'s ``distributed``
    key are each refused with the reference's own reason (the pipeline reads
    the whole input in every process), after the rendezvous succeeded."""
    _, train_path, _ = avro_dataset
    port = _free_port()
    procs = []
    for pid in range(2):
        config = {**_config(train_path, None), "distributed": {
            "coordinator_address": f"127.0.0.1:{port}", "num_processes": 2,
            "process_id": pid, "init_retries": 0}}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _TWO_PROCESS_TRAIN, json.dumps(config)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))}))
    outs = [p.communicate(timeout=120) for p in procs]
    for (out, err), p in zip(outs, procs):
        assert p.returncode == 0, err[-2000:]
        assert "REFUSED" in out and "does not span processes" in out, out + err[-2000:]
        assert "tools/fleet" in out


# ---------------------------------------------------------------------------
# cli pipeline (the freshness conductor's daemon)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipeline_base(avro_dataset):
    """A ``cli train`` base with a step checkpoint in each package; the
    held-out file is the delta shard."""
    tmp, train_path, holdout = avro_dataset
    out = {"holdout": holdout}
    for pkg, run in (("port", lambda c: t_train.run(c, device="cpu")), ("jax", j_train.run)):
        ckpt = str(tmp / f"{pkg}-pipe-ckpt")
        config = {**_config(train_path, str(tmp / f"{pkg}-pipe-model")),
                  "checkpoint": {"dir": ckpt, "resume": False}}
        run(dict(config))
        cfg_path = tmp / f"{pkg}-pipe.json"
        cfg_path.write_text(json.dumps(config))
        out[pkg] = {"cfg": str(cfg_path), "ckpt": ckpt}
    return out


def _pipeline_argv(base, pkg, tmp_path, *extra):
    return ["--config", base[pkg]["cfg"], "--base", base[pkg]["ckpt"],
            "--delta-dir", str(tmp_path / "deltas"), "--registry-dir",
            str(tmp_path / f"{pkg}-registry"), "--workdir", str(tmp_path / f"{pkg}-work"),
            *extra]


def test_pipeline_subcommand_runs_on_the_cpu(pipeline_base, tmp_path, capsys):
    """``cli pipeline --device cpu`` for two cycles: the delta published as
    v-00000001 through the gate, then an idle cycle, the status file
    written; the JAX package's ``cli pipeline`` over the same files publishes a model
    within the fit tolerance, and its summary's counts are the port's."""
    import shutil

    from photon_ml_tpu.cli.pipeline import main as j_pipeline

    (tmp_path / "deltas").mkdir()
    shutil.copy(pipeline_base["holdout"], tmp_path / "deltas" / "delta-0001.avro")
    extra = ["--cycles", "2", "--interval-s", "0", "--bootstrap-samples", "8"]
    status = tmp_path / "status.json"
    rc = t_cli.main(["pipeline", *_pipeline_argv(pipeline_base, "port", tmp_path, *extra),
                     "--status-file", str(status), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert j_pipeline(_pipeline_argv(pipeline_base, "jax", tmp_path, *extra)) == 0
    j_summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("cycles", "idle_cycles", "published_versions", "quarantined_versions",
                "escalations", "reconciliations", "interrupted"):
        assert summary[key] == j_summary[key], key
    assert summary["published_versions"] == ["v-00000001"] and summary["idle_cycles"] == 1
    doc = json.loads(status.read_text())
    assert doc["outcome"] == "completed"
    assert doc["members"]["0"]["pipeline"]["served_version"] == "v-00000001"
    port_load = lambda p: TM.load_game_model(p, device="cpu")  # noqa: E731
    fe, re = _coefficients(str(tmp_path / "port-registry" / "v-00000001"), port_load)
    j_fe, j_re = _coefficients(str(tmp_path / "jax-registry" / "v-00000001"),
                               JM.load_game_model)
    np.testing.assert_allclose(fe, j_fe, **FIT_TOL)
    assert re.keys() == j_re.keys()
    for k in re:
        np.testing.assert_allclose(re[k], j_re[k], **FIT_TOL)


@pytest.mark.parametrize("flag", ["--telemetry-out", "--report-out"])
def test_pipeline_run_report_flags_are_refused_naming_14d(pipeline_base, tmp_path, flag,
                                                          capsys):
    """``--telemetry-out`` and ``--report-out`` are ported: one idle cycle
    writes the metrics snapshot (``pipeline.cycles`` 1) or the run report
    with its Pipeline section, and the summary names the file."""
    from photon_ml_tpu_torch import telemetry as TT

    TT.reset()
    (tmp_path / "deltas").mkdir()
    out = tmp_path / ("run.metrics.jsonl" if flag == "--telemetry-out" else "run.report.md")
    rc = t_cli.main(["pipeline", *_pipeline_argv(pipeline_base, "port", tmp_path, "--cycles",
                                                 "1", "--interval-s", "0"),
                     flag, str(out), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["cycles"] == 1 and summary["idle_cycles"] == 1
    if flag == "--telemetry-out":
        (line,) = [json.loads(x) for x in out.read_text().splitlines()]
        assert line["type"] == "metrics"
        assert line["snapshot"]["counters"]["pipeline.idle_cycles"] == 1
        assert summary["telemetry"]["counters"]["pipeline.cycles"] == 1
    else:
        md = out.read_text()
        assert "## Pipeline" in md and "- 1 conductor cycle(s), 1 idle" in md
        assert summary["report"] == str(out)
        doc = json.loads((tmp_path / "run.report.json").read_text())
        assert doc["pipeline"] == {"cycles": 1, "idle_cycles": 1}


def test_pipeline_sigterm_finishes_the_cycle_and_exits_75(pipeline_base, tmp_path):
    """A daemon waiting between idle cycles takes SIGTERM: it stops, prints
    an interrupted summary and exits 75 (the scheduler's restart code)."""
    import signal
    import time

    (tmp_path / "deltas").mkdir()
    status = tmp_path / "status.json"
    argv = [sys.executable, "-m", "photon_ml_tpu_torch.cli", "pipeline",
            *_pipeline_argv(pipeline_base, "port", tmp_path, "--interval-s", "60"),
            "--status-file", str(status), "--device", "cpu"]
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                if json.loads(status.read_text()).get("generation", 0) >= 1:
                    break  # the first (idle) cycle is done: the daemon waits
            except (OSError, ValueError):
                pass
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 75, err[-3000:]
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["interrupted"] is True
    assert summary["cycles"] == 1 and summary["idle_cycles"] == 1
    assert json.loads(status.read_text())["outcome"] == "interrupted"
