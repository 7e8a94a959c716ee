"""photon_ml_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU.

The package's name starts with ``photon_ml_tpu``, so every check matches the
JAX package's module name exactly (``photon_ml_tpu`` or ``photon_ml_tpu.*``),
never as a prefix.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "photon_ml_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "photon_ml_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_forbidden_matches_exact_module_names_only():
    assert _forbidden("photon_ml_tpu")
    assert _forbidden("photon_ml_tpu.ops.tiled")
    assert _forbidden("jax.numpy")
    assert not _forbidden("photon_ml_tpu_torch")
    assert not _forbidden("photon_ml_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import_in_source(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter: importing every module of the package adds no
    ``jax`` / ``photon_ml_tpu`` module to ``sys.modules``."""
    modules = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        if rel == "chip_smoke.py":
            modules.append("chip_smoke")
            continue
        mod = rel[:-3].replace(os.sep, ".")
        modules.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    added = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "photon_ml_tpu_torch.training" in added
    assert [m for m in added if _forbidden(m)] == []


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")


def _tiny_coo():
    return dict(values=np.ones(3), rows=np.array([0, 1, 2]), cols=np.array([0, 1, 0]),
                labels=np.array([0.0, 1.0, 1.0]), num_features=2)


def test_train_glm_without_device_raises_without_a_gpu():
    _no_gpu()
    from photon_ml_tpu_torch import train_glm
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.optim.factory import OptimizerConfig

    batch = CSRBatch.from_coo(**_tiny_coo(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_glm(batch, "logistic", [1.0], OptimizerConfig(max_iterations=2))


def test_source_walk_covers_the_new_subpackages():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    rel |= {os.path.relpath(os.path.join(root, f), PKG)
            for root, _dirs, files in os.walk(os.path.join(PKG, "csrc")) for f in files}
    for module in ("game/dataset.py", "game/random_effect_data.py", "game/coordinates.py",
                   "game/coordinate_descent.py", "game/estimator.py", "game/models.py",
                   "tools/probe_ell.py", "ops/ell.py", "ops/dense.py", "optim/newton.py",
                   "ops/block_diagonal.py",
                   "data/stats.py", "data/validators.py", "data/native.py", "data/libsvm.py",
                   "data/index_map.py", "data/paths.py", "data/model_store.py",
                   "utils/atomic.py", "utils/timing.py", "utils/events.py", "config.py",
                   "data/avro.py", "data/avro_native.py", "diagnostics/evaluation.py",
                   "optim/guard.py", "cli/__main__.py", "cli/train.py", "cli/score.py",
                   "cli/index.py", "cli/glm.py", "optim/trackers.py", "data/projection.py",
                   "game/factored.py", "game/checkpoint.py", "ops/shared_design.py",
                   "sweep/grid.py", "sweep/runner.py", "sweep/select.py", "cli/sweep.py",
                   "diagnostics/bootstrap.py", "diagnostics/fitting.py", "diagnostics/hl.py",
                   "diagnostics/independence.py", "diagnostics/feature_importance.py",
                   "diagnostics/model_diagnostic.py", "diagnostics/reporting.py",
                   "csrc/margins_lanes.cu", "csrc/scatter_lanes.cu", "ingest/__init__.py",
                   "ingest/errors.py", "ingest/planner.py", "ingest/prefetch.py",
                   "ingest/buffers.py", "ingest/decode.py", "ingest/pipeline.py",
                   "ingest/assemble.py", "game/streaming.py", "faults/__init__.py",
                   "faults/plan.py", "telemetry/__init__.py", "telemetry/metrics.py",
                   "quality/__init__.py", "quality/drift.py", "quality/gate.py",
                   "serving/__init__.py", "serving/engine.py", "serving/batcher.py",
                   "serving/registry.py", "serving/server.py", "serving/aio.py",
                   "serving/nearline.py", "cli/serve.py", "incremental/__init__.py",
                   "incremental/warmstart.py", "incremental/delta.py",
                   "incremental/refit.py", "incremental/publish.py", "cli/refresh.py",
                   "kernels/cost.py", "telemetry/device.py", "telemetry/executables.py",
                   "telemetry/profile.py", "cli/profile.py", "testing.py"):
        assert module in rel


@pytest.mark.parametrize("builder", ["csr", "sparse", "model", "normalization", "ell",
                                     "dense", "game_dataset", "game_model", "game_fit",
                                     "probe", "libsvm_batch", "load_glm",
                                     "load_game_model", "block_diagonal", "lane_solve",
                                     "projection", "factored_fit", "streamed_dataset",
                                     "chunk_stream", "coefficient_table",
                                     "streaming_trainer", "glm_problem", "game_generator",
                                     "low_rank_generator"])
def test_builders_without_device_raise_without_a_gpu(builder, tmp_path):
    _no_gpu()
    from photon_ml_tpu_torch import convert
    from photon_ml_tpu_torch.data.libsvm import LibSVMData
    from photon_ml_tpu_torch.data.projection import build_gaussian_projection_matrix
    from photon_ml_tpu_torch.data.model_store import load_game_model, load_glm
    from photon_ml_tpu_torch.game import (
        FactoredRandomEffectConfig,
        FeatureShard,
        FixedEffectConfig,
        GameConfig,
        GameEstimator,
        build_game_dataset,
    )
    from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.ops.dense import DenseBatch
    from photon_ml_tpu_torch.ops.ell import ELLBatch
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.ops.sparse import SparseBatch
    from photon_ml_tpu_torch.optim import lane_adapter, lbfgs_solve_lanes
    from photon_ml_tpu_torch.tools.probe_ell import run_probe
    from photon_ml_tpu_torch.game.streaming import (
        ShardedCoefficientTable,
        StreamingRandomEffectTrainer,
    )
    from photon_ml_tpu_torch.ingest import ChunkStream, read_game_dataset_streamed
    from photon_ml_tpu_torch.optim.factory import OptimizerConfig
    from photon_ml_tpu_torch.testing import (
        generate_game_dataset,
        generate_glm_problem,
        generate_low_rank_game_dataset,
    )

    coo = _tiny_coo()
    shards = {"g": FeatureShard.from_coo(coo["values"], coo["rows"], coo["cols"], 2)}
    cfg = GameConfig(task="logistic", coordinates={"fe": FixedEffectConfig(shard_name="g")})
    mf = GameConfig(task="logistic", coordinates={"mf": FactoredRandomEffectConfig(
        shard_name="g", id_name="u", latent_dim=2)})
    calls = {
        "csr": lambda: CSRBatch.from_coo(**coo),
        "sparse": lambda: SparseBatch.from_coo(**coo),
        "model": lambda: convert.model_from_jax("logistic", np.zeros(2)),
        "normalization": lambda: convert.normalization_from_jax(np.ones(2), None, None),
        "ell": lambda: ELLBatch.from_coo(**coo),
        "dense": lambda: DenseBatch.from_arrays(np.zeros((1, 2, 2)), np.zeros((1, 2))),
        "game_dataset": lambda: build_game_dataset(coo["labels"], shards),
        "game_model": lambda: convert.game_model_from_jax("logistic", {}),
        "game_fit": lambda: GameEstimator(cfg).fit(
            build_game_dataset(coo["labels"], shards, device="cpu")),
        "probe": lambda: run_probe(n=4, d=3, nnz_per_row=1),
        "libsvm_batch": lambda: LibSVMData(coo["values"], coo["rows"], coo["cols"],
                                           coo["labels"], 2).to_batch(),
        "load_glm": lambda: load_glm(str(tmp_path)),
        "load_game_model": lambda: load_game_model(str(tmp_path)),
        "block_diagonal": lambda: BlockDiagonalBatch.from_bucket(
            np.ones((1, 1)), np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32),
            np.zeros((1, 2)), np.zeros((1, 2)), np.ones((1, 2)), 2),
        "projection": lambda: build_gaussian_projection_matrix(2, 3),
        "factored_fit": lambda: GameEstimator(mf).fit(build_game_dataset(
            coo["labels"], shards, id_columns={"u": [0, 1, 1]}, device="cpu")),
        "streamed_dataset": lambda: read_game_dataset_streamed(str(tmp_path)),
        "chunk_stream": lambda: ChunkStream([str(tmp_path)], index_maps={}),
        "coefficient_table": lambda: ShardedCoefficientTable(4, 2),
        "streaming_trainer": lambda: StreamingRandomEffectTrainer("logistic",
                                                                  OptimizerConfig()),
        "glm_problem": lambda: generate_glm_problem(n=8, d=2),
        "game_generator": lambda: generate_game_dataset(n_users=2, rows_per_user=2),
        "low_rank_generator": lambda: generate_low_rank_game_dataset(n_users=2,
                                                                     rows_per_user=2, d=3),
        "lane_solve": lambda: lbfgs_solve_lanes(lane_adapter(
            make_objective("logistic"), DenseBatch.from_arrays(
                np.zeros((1, 2, 2)), np.zeros((1, 2)), device="cpu")), torch.zeros(1, 2)),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[builder]()


def test_resolve_device():
    from photon_ml_tpu_torch.device import check_on, resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(ValueError, match="same device"):
        check_on(torch.device("cpu"), torch.zeros(1, device="meta"))
    check_on(torch.device("cpu"), torch.zeros(1), None)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device the script exits non-zero and prints no result;
    alone in a directory it cannot find the package either."""
    _no_gpu()
    for cwd, script in ((REPO, "chip_smoke.py"), (str(tmp_path), "chip_smoke.py")):
        if cwd != REPO:
            with open(os.path.join(REPO, "chip_smoke.py")) as src:
                (tmp_path / "chip_smoke.py").write_text(src.read())
        proc = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("entry", ["sweep_glm", "sweep_game", "fit_sweep", "fit_grid",
                                   "bootstrap_train", "bootstrap_random_effect",
                                   "fitting_diagnostic"])
def test_sweep_and_diagnostic_entry_points_raise_without_a_gpu(entry):
    """The sweeps and the diagnostics run on cuda unless asked for the CPU:
    without a card and without ``device="cpu"`` they raise before any work."""
    _no_gpu()
    from photon_ml_tpu_torch.diagnostics.bootstrap import (
        bootstrap_random_effect,
        bootstrap_train,
    )
    from photon_ml_tpu_torch.diagnostics.fitting import fitting_diagnostic
    from photon_ml_tpu_torch.game import (
        FeatureShard,
        FixedEffectConfig,
        GameConfig,
        GameEstimator,
        build_game_dataset,
    )
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.ops.dense import DenseBatch
    from photon_ml_tpu_torch.optim.factory import OptimizerConfig
    from photon_ml_tpu_torch.sweep import SweepGrid, sweep_game, sweep_glm

    coo = _tiny_coo()
    batch = CSRBatch.from_coo(**coo, device="cpu")
    cfg = GameConfig(task="logistic", evaluators=["auc"],
                     coordinates={"fe": FixedEffectConfig(shard_name="g")})
    data = build_game_dataset(coo["labels"], {"g": FeatureShard.from_coo(
        coo["values"], coo["rows"], coo["cols"], 2)}, device="cpu")
    opt = OptimizerConfig(max_iterations=2)
    calls = {
        "sweep_glm": lambda: sweep_glm(batch, "logistic", [1.0], opt),
        "sweep_game": lambda: sweep_game(cfg, data, SweepGrid(default=(1.0,))),
        "fit_sweep": lambda: GameEstimator(cfg).fit_sweep(data, data, SweepGrid(default=(1.0,))),
        "fit_grid": lambda: GameEstimator(cfg).fit_grid(data, data, {"fe": [opt]}),
        "bootstrap_train": lambda: bootstrap_train(batch, "logistic", opt, num_samples=2),
        "bootstrap_random_effect": lambda: bootstrap_random_effect(
            DenseBatch.from_arrays(np.zeros((1, 2, 2)), np.zeros((1, 2)), device="cpu"),
            "logistic", opt, np.zeros((1, 2)), num_samples=2),
        "fitting_diagnostic": lambda: fitting_diagnostic(batch, "logistic", opt),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("command", ["train", "score", "glm", "sweep"])
def test_cli_without_device_raises_without_a_gpu(command, tmp_path):
    """The drivers' ``--device`` defaults to cuda: without a card and without
    ``--device cpu`` they raise the no-CUDA error before any work."""
    _no_gpu()
    from photon_ml_tpu_torch.cli.__main__ import main
    from photon_ml_tpu_torch.data.avro import TRAINING_EXAMPLE_AVRO, write_avro

    avro = str(tmp_path / "d.avro")
    write_avro(avro, TRAINING_EXAMPLE_AVRO, [
        {"uid": str(i), "label": float(i % 2), "features": [{"name": "a", "term": "",
                                                             "value": 1.0}],
         "metadataMap": None, "weight": None, "offset": None} for i in range(4)])
    libsvm = tmp_path / "d.libsvm"
    libsvm.write_text("1 1:1.0\n-1 2:1.0\n")
    inp = {"format": "avro", "paths": [avro]}
    configs = {
        "train": {"task": "logistic", "input": inp,
                  "coordinates": {"f": {"shard_name": "features"}}},
        "score": {"input": inp},
        "glm": {"task": "logistic", "input": {"format": "libsvm", "paths": [str(libsvm)]}},
        "sweep": {"task": "logistic", "input": inp, "validation": {"paths": [avro]},
                  "evaluators": ["auc"], "coordinates": {"f": {"shard_name": "features"}},
                  "sweep": "lambda=1,2"},
    }
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(configs[command]))
    args = {"train": [], "glm": [], "sweep": [],
            "score": ["--model-dir", str(tmp_path / "m"), "--allow-index-rebuild"]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([command, "--config", str(cfg), *args[command]])


def test_importing_the_cli_loads_no_jax():
    code = ("import json, sys\n"
            "import photon_ml_tpu_torch.cli.__main__\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "photon_ml_tpu_torch.cli.__main__" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("entry", ["engine", "engine_load", "registry", "cli_serve"])
def test_serving_entry_points_raise_without_a_gpu(entry, tmp_path):
    """``ScoringEngine``, ``ScoringEngine.load``, ``ModelRegistry`` and ``cli
    serve`` run on cuda unless asked for the CPU: without a card they raise
    the no-CUDA error before any work."""
    _no_gpu()
    import torch as _torch

    from photon_ml_tpu_torch.cli.serve import main as serve_main
    from photon_ml_tpu_torch.game.models import FixedEffectModel, GameModel
    from photon_ml_tpu_torch.serving import ModelRegistry, ScoringEngine

    model = GameModel(task="logistic", models={"fe": FixedEffectModel(
        coefficients=_torch.zeros(2), shard_name="g")})
    calls = {
        "engine": lambda: ScoringEngine(model),
        "engine_load": lambda: ScoringEngine.load(str(tmp_path)),
        "registry": lambda: ModelRegistry(str(tmp_path)),
        "cli_serve": lambda: serve_main(["--registry-dir", str(tmp_path), "--stdio"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["load_warm_start", "fit_incremental", "scan_delta_stream",
                                   "cli_refresh"])
def test_incremental_entry_points_raise_without_a_gpu(entry, tmp_path):
    """``load_warm_start``, ``fit_incremental``, ``scan_delta_stream`` and ``cli
    refresh`` run on cuda unless asked for the CPU: without a card they raise
    the no-CUDA error before any work."""
    _no_gpu()
    from photon_ml_tpu_torch.cli.__main__ import main
    from photon_ml_tpu_torch.data.avro import TRAINING_EXAMPLE_AVRO, write_avro
    from photon_ml_tpu_torch.game import (
        FeatureShard,
        FixedEffectConfig,
        GameConfig,
        GameEstimator,
        build_game_dataset,
    )
    from photon_ml_tpu_torch.game.models import FixedEffectModel, GameModel
    from photon_ml_tpu_torch.incremental import (
        BaseLineage,
        WarmStart,
        load_warm_start,
        scan_delta_stream,
    )

    (tmp_path / "base" / "step-00000000").mkdir(parents=True)
    avro = str(tmp_path / "d.avro")
    write_avro(avro, TRAINING_EXAMPLE_AVRO, [
        {"uid": str(i), "label": float(i % 2), "features": [{"name": "a", "term": "",
                                                             "value": 1.0}],
         "metadataMap": {"u": str(i)}, "weight": None, "offset": None} for i in range(4)])
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"task": "logistic", "input": {"format": "avro", "paths": [avro]},
                               "coordinates": {"f": {"shard_name": "features"}}}))
    coo = _tiny_coo()
    data = build_game_dataset(coo["labels"], {"g": FeatureShard.from_coo(
        coo["values"], coo["rows"], coo["cols"], 2)}, device="cpu")
    est = GameEstimator(GameConfig(task="logistic",
                                   coordinates={"fe": FixedEffectConfig(shard_name="g")}))
    ws = WarmStart(lineage=BaseLineage(checkpoint_dir=str(tmp_path), kind="model"),
                   model=GameModel(task="logistic", models={"fe": FixedEffectModel(
                       coefficients=torch.zeros(2), shard_name="g")}))
    calls = {
        "load_warm_start": lambda: load_warm_start(str(tmp_path / "base")),
        "fit_incremental": lambda: est.fit_incremental(data, ws),
        "scan_delta_stream": lambda: scan_delta_stream([avro], {"u": np.array(["0"])},
                                                       index_maps={}),
        "cli_refresh": lambda: main(["refresh", "--config", str(cfg), "--warm-start",
                                     str(tmp_path / "base")]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
