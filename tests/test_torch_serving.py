"""The port's serving tier (``photon_ml_tpu_torch.serving``) against the JAX
package's, case for case with tests/test_serving.py: the engine against
``predict_mean`` and the JAX engine on the same rows (atol 1e-6, 1e-5 for
the squared task), the unseen-entity fallback, named features, every
``BadRequest`` typed with the reference's message, the micro-batcher,
the registry (corrupt versions, transient IO), the stdio and HTTP front
ends, a hot swap under concurrent HTTP traffic, and ``cli serve --stdio``
in a subprocess. Models are carried across with ``convert.game_model_from_jax``;
rows are the reference test's numpy draws.

The reference's "steady state never recompiles" becomes: after warm-up every
call falls in a bucket warm-up ran (``compile_summary``), and no call counts
``serving.unwarmed_bucket_calls``.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game.dataset import build_game_dataset as j_build
from photon_ml_tpu.game.models import FixedEffectModel as JFE
from photon_ml_tpu.game.models import GameModel as JGame
from photon_ml_tpu.game.models import RandomEffectBucketModel as JBucket
from photon_ml_tpu.game.models import RandomEffectModel as JRE
from photon_ml_tpu.serving import BadRequest as JBadRequest
from photon_ml_tpu.serving import ScoringEngine as JEngine
from photon_ml_tpu.testing import generate_game_dataset
from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.convert import game_model_from_jax
from photon_ml_tpu_torch.data.model_store import ModelLoadError, save_game_model
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.serving import (
    BadRequest,
    MicroBatcher,
    ModelRegistry,
    Overloaded,
    ScoringEngine,
    ScoringServer,
    ScoringService,
    publish_version,
    serve_stdio,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(autouse=True)
def _port_telemetry():
    telemetry.reset()
    yield
    faults.clear_plan()
    telemetry.reset()


def _jmodel(truth, scale=1.0, n_buckets=2, task="logistic"):
    """tests/test_serving.py's FE + per-user RE model from planted coefficients."""
    w_users = truth["w_users"] * scale
    n_users, local_k = w_users.shape
    fe = JFE(coefficients=jnp.asarray(truth["w_global"] * scale, jnp.float32),
             shard_name="global")
    entity_bucket = (np.arange(n_users) % n_buckets).astype(np.int64)
    entity_pos = np.zeros(n_users, np.int64)
    buckets = []
    for b in range(n_buckets):
        codes_b = np.nonzero(entity_bucket == b)[0]
        entity_pos[codes_b] = np.arange(len(codes_b))
        proj = np.tile(np.arange(local_k, dtype=np.int32), (len(codes_b), 1))
        buckets.append(JBucket(coefficients=jnp.asarray(w_users[codes_b], jnp.float32),
                               projection=jnp.asarray(proj),
                               entity_codes=jnp.asarray(codes_b, jnp.int32)))
    re = JRE(id_name="userId", shard_name="user", buckets=tuple(buckets),
             entity_bucket=entity_bucket, entity_pos=entity_pos, vocab=np.arange(n_users))
    return JGame(task=task, models={"fixed": fe, "perUser": re})


def to_port(jmodel) -> GameModel:
    """The JAX GAME model's arrays as the port's model on the CPU."""
    models = {}
    for name, sub in jmodel.models.items():
        if isinstance(sub, JFE):
            models[name] = {"shard_name": sub.shard_name,
                            "coefficients": np.asarray(sub.coefficients)}
        else:
            models[name] = {
                "id_name": sub.id_name, "shard_name": sub.shard_name,
                "entity_bucket": np.asarray(sub.entity_bucket),
                "entity_pos": np.asarray(sub.entity_pos), "vocab": np.asarray(sub.vocab),
                "buckets": [{"coefficients": np.asarray(b.coefficients),
                             "projection": np.asarray(b.projection),
                             "entity_codes": np.asarray(b.entity_codes)} for b in sub.buckets]}
    return game_model_from_jax(jmodel.task, models, device=CPU)


def _request_rows(truth, data, indices):
    """The dataset's rows in the serving request schema."""
    Xg, Xu, users = truth["Xg"], truth["Xu"], truth["users"]
    return [{"features": {"global": [[j, float(Xg[i, j])] for j in range(Xg.shape[1])
                                     if Xg[i, j] != 0],
                          "user": [[j, float(Xu[i, j])] for j in range(Xu.shape[1])
                                   if Xu[i, j] != 0]},
             "ids": {"userId": int(users[i])}, "offset": float(data.offset[i])}
            for i in indices]


@pytest.fixture(scope="module")
def game_world():
    data, truth = generate_game_dataset(n_users=12, rows_per_user=10, fe_dim=6, re_dim=4,
                                        seed=3)
    rng = np.random.default_rng(17)
    data = j_build(response=data.response, feature_shards=data.feature_shards,
                   id_columns=data.id_columns, offset=rng.normal(size=data.num_rows) * 0.3)
    return data, truth


def _mean(jmodel, data, n=None):
    return np.asarray(jmodel.predict_mean(data))[: data.num_rows if n is None else n]


_INDEX_MAPS = {"global": [f"g{j}" for j in range(6)], "user": [f"u{j}" for j in range(4)]}


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def test_engine_matches_predict_mean(game_world):
    data, truth = game_world
    jm = _jmodel(truth)
    expected = _mean(jm, data)
    rows = _request_rows(truth, data, range(data.num_rows))
    engine = ScoringEngine(to_port(jm), max_batch=32, version="t", device=CPU).warmup()
    got = engine.score_rows(rows)
    np.testing.assert_allclose(got, expected, atol=1e-6)
    np.testing.assert_allclose(got, JEngine(jm, max_batch=32).score_rows(rows), atol=1e-6)
    assert engine.warm
    # each row's score depends on its own features only: bit for bit again
    np.testing.assert_array_equal(engine.score_rows(rows[::-1])[::-1], got)


def test_engine_squared_task_is_raw_scores(game_world):
    data, truth = game_world
    jm = _jmodel(truth, task="squared")
    rows = _request_rows(truth, data, range(data.num_rows))
    got = ScoringEngine(to_port(jm), max_batch=16, device=CPU).score_rows(rows)
    np.testing.assert_allclose(got, _mean(jm, data), atol=1e-5)


def test_engine_unseen_entity_falls_back_to_fixed_effect(game_world):
    data, truth = game_world
    jm = _jmodel(truth)
    expected = _mean(JGame(task="logistic", models={"fixed": jm.models["fixed"]}), data, 3)
    rows = _request_rows(truth, data, range(3))
    for r in rows:
        r["ids"] = {"userId": 424242}  # never in the training vocab
    engine = ScoringEngine(to_port(jm), max_batch=8, device=CPU)
    np.testing.assert_allclose(engine.score_rows(rows), expected, atol=1e-6)
    assert telemetry.snapshot()["counters"]["serving.unseen_entities"] == 3
    del rows[0]["ids"]
    np.testing.assert_allclose(engine.score_rows(rows[:1]), expected[:1], atol=1e-6)


def test_engine_named_features_resolve_through_index_maps(game_world):
    data, truth = game_world
    maps = {"global": {f"g{j}": j for j in range(6)}, "user": {f"u{j}": j for j in range(4)}}
    jm = _jmodel(truth)
    engine = ScoringEngine(to_port(jm), index_maps=maps, max_batch=8, device=CPU)
    jengine = JEngine(jm, index_maps=maps, max_batch=8)
    indexed = _request_rows(truth, data, [0, 1])
    named = [{"features": {"global": [["g%d" % c, "", v] for c, v in row["features"]["global"]],
                           "user": [{"name": "u%d" % c, "value": v}
                                    for c, v in row["features"]["user"]]},
              "ids": row["ids"], "offset": row["offset"]} for row in indexed]
    np.testing.assert_allclose(engine.score_rows(named), engine.score_rows(indexed), atol=1e-7)
    np.testing.assert_allclose(engine.score_rows(named), jengine.score_rows(named), atol=1e-6)
    named[0]["features"]["global"].append(["no_such_feature", "", 1.0])
    engine.score_rows(named)
    assert telemetry.snapshot()["counters"]["serving.unknown_features"] == 1


_BAD_REQUESTS = [
    ("max_row_nnz", [{"features": {"global": [[j, 1.0] for j in range(5)]}}]),
    ("must be an object", ["not-a-row"]),
    ("no feature index", [{"features": {"global": [["named", "", 1.0]]}}]),
    ("unknown feature shard", [{"features": {"globl": [[0, 1.0]]}}]),
    ("outside shard", [{"features": {"global": [[100, 1.0]]}}]),
    ("outside shard", [{"features": {"global": [[-1, 1.0]]}}]),
    ("offset", [{"offset": "x"}]),
    ("must be numbers", [{"features": {"global": [[0, "not-a-number"]]}}]),
]


def test_engine_bad_requests_are_typed(game_world):
    """Every malformed request is a BadRequest with the reference's own
    message, case for case."""
    _, truth = game_world
    jm = _jmodel(truth)
    engine = ScoringEngine(to_port(jm), max_batch=4, max_row_nnz=4, device=CPU)
    jengine = JEngine(jm, max_batch=4, max_row_nnz=4)
    for match, rows in _BAD_REQUESTS:
        with pytest.raises(BadRequest, match=match) as got:
            engine.score_rows(rows)
        with pytest.raises(JBadRequest) as want:
            jengine.score_rows(rows)
        assert str(got.value) == str(want.value)


def test_micro_batcher_isolates_bad_unit_from_co_batched(game_world):
    data, truth = game_world
    jm = _jmodel(truth)
    engine = ScoringEngine(to_port(jm), max_batch=8, device=CPU)
    batcher = MicroBatcher(lambda rows: (engine.score_rows(rows), engine.version),
                           max_batch=8, max_delay_ms=50.0, queue_depth=100).start()
    try:
        good = batcher.submit(_request_rows(truth, data, [0, 1]))
        bad = batcher.submit([{"features": {"globl": [[0, 1.0]]}}])
        np.testing.assert_allclose(good.result(timeout=10)["scores"], _mean(jm, data, 2),
                                   atol=1e-6)
        with pytest.raises(BadRequest, match="unknown feature shard"):
            bad.result(timeout=10)
    finally:
        batcher.stop()


def test_engine_load_requires_feature_indexes(tmp_path, game_world):
    _, truth = game_world
    model_dir = str(tmp_path / "model")
    save_game_model(to_port(_jmodel(truth)), model_dir)
    with pytest.raises(ModelLoadError, match="feature-indexes"):
        ScoringEngine.load(model_dir, device=CPU)
    engine = ScoringEngine.load(model_dir, require_feature_indexes=False, device=CPU)
    assert engine.version == "model"


def test_engine_rejects_unservable_coordinates(game_world):
    _, truth = game_world
    bad = to_port(_jmodel(truth)).with_model("weird", object())
    with pytest.raises(TypeError, match="online serving supports"):
        ScoringEngine(bad, device=CPU)


def test_steady_state_never_recompiles(game_world):
    data, truth = game_world
    engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=16, device=CPU).warmup()
    warmed = set(engine.compile_summary())
    assert warmed == {"1", "2", "4", "8", "16"}
    engine.score_rows(_request_rows(truth, data, range(9)))
    for size in (1, 3, 9, 16, 5):
        engine.score_rows(_request_rows(truth, data, range(size)))
    summary = engine.compile_summary()
    assert set(summary) == warmed
    assert {b: s["calls"] for b, s in summary.items()} == {"1": 2, "2": 1, "4": 2, "8": 2,
                                                           "16": 4}
    assert "serving.unwarmed_bucket_calls" not in telemetry.snapshot()["counters"]


# ---------------------------------------------------------------------------
# micro-batcher (pure host threads)
# ---------------------------------------------------------------------------


def test_micro_batcher_coalesces_under_deadline():
    dispatched = []

    def scorer(rows):
        dispatched.append(len(rows))
        time.sleep(0.01)
        return np.arange(len(rows), dtype=np.float32), "v9"

    b = MicroBatcher(scorer, max_batch=8, max_delay_ms=25.0, queue_depth=1000).start()
    try:
        results = [f.result(timeout=10) for f in
                   [b.submit([{"k": i}, {"k": i}]) for i in range(8)]]
    finally:
        b.stop()
    assert all(len(r["scores"]) == 2 and r["model_version"] == "v9" for r in results)
    assert max(dispatched) > 2 and sum(dispatched) == 16
    snap = telemetry.snapshot()
    assert snap["counters"]["serving.requests"] == 8
    assert snap["histograms"]["serving.batch_size"]["count"] == len(dispatched)


def test_micro_batcher_sheds_on_overload():
    release, entered = threading.Event(), threading.Event()

    def scorer(rows):
        entered.set()
        release.wait(timeout=10)
        return np.zeros(len(rows), np.float32), "v"

    b = MicroBatcher(scorer, max_batch=4, max_delay_ms=1.0, queue_depth=4).start()
    try:
        first = b.submit([{}] * 4)
        assert entered.wait(timeout=10)  # the dispatcher holds the first batch
        second = b.submit([{}] * 4)
        with pytest.raises(Overloaded, match="queue at capacity"):
            b.submit([{}])
        assert telemetry.snapshot()["counters"]["serving.shed"] == 1
        release.set()
        assert len(first.result(timeout=10)["scores"]) == 4
        assert len(second.result(timeout=10)["scores"]) == 4
    finally:
        release.set()
        b.stop()


def test_micro_batcher_rejects_unservable_giant_request():
    b = MicroBatcher(lambda rows: (np.zeros(len(rows), np.float32), "v"), max_batch=4,
                     queue_depth=8).start()
    try:
        with pytest.raises(BadRequest, match="queue depth"):
            b.submit([{}] * 9)
        assert len(b.submit([{}] * 8).result(timeout=10)["scores"]) == 8
    finally:
        b.stop()


def test_micro_batcher_drops_cancelled_units():
    calls, gate, entered = [], threading.Event(), threading.Event()

    def scorer(rows):
        calls.append(len(rows))
        entered.set()
        gate.wait(timeout=10)
        return np.zeros(len(rows), np.float32), "v"

    b = MicroBatcher(scorer, max_batch=4, max_delay_ms=1.0).start()
    try:
        first = b.submit([{}])
        assert entered.wait(timeout=10)  # the dispatcher is in the scorer
        doomed = b.submit([{}])
        assert doomed.cancel()
        gate.set()
        assert len(first.result(timeout=10)["scores"]) == 1
    finally:
        gate.set()
        b.stop()
    assert calls == [1]


def test_micro_batcher_propagates_scorer_errors():
    def scorer(rows):
        raise RuntimeError("device fell over")

    b = MicroBatcher(scorer, max_batch=4, max_delay_ms=1.0).start()
    try:
        with pytest.raises(RuntimeError, match="device fell over"):
            b.submit([{}]).result(timeout=10)
    finally:
        b.stop()
    with pytest.raises(RuntimeError, match="not running"):
        b.submit([{}])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_skips_corrupt_and_index_less_versions(tmp_path, game_world):
    _, truth = game_world
    registry_dir = str(tmp_path)
    publish_version(registry_dir, to_port(_jmodel(truth)), _INDEX_MAPS)
    save_game_model(to_port(_jmodel(truth, scale=2.0)), os.path.join(registry_dir, "v-00000002"))
    v3 = os.path.join(registry_dir, "v-00000003")
    os.makedirs(v3)
    with open(os.path.join(v3, "garbage"), "w") as f:
        f.write("x")
    registry = ModelRegistry(registry_dir, max_batch=4, warm=False, poll_interval=60,
                             device=CPU).start()
    try:
        assert registry.engine.version == "v-00000001"
        skipped = telemetry.snapshot()["counters"]["serving.skipped_versions"]
        assert skipped >= 2
        registry.refresh()
        assert telemetry.snapshot()["counters"]["serving.skipped_versions"] == skipped
    finally:
        registry.stop()


def test_registry_with_no_valid_version_raises(tmp_path):
    registry = ModelRegistry(str(tmp_path), warm=False, poll_interval=60, device=CPU)
    with pytest.raises(RuntimeError, match="no valid model version"):
        registry.start()


def test_publish_version_requires_index_maps(tmp_path, game_world):
    _, truth = game_world
    with pytest.raises(ValueError, match="index_maps is required"):
        publish_version(str(tmp_path), to_port(_jmodel(truth)), {})


def test_registry_retries_transient_io_and_does_not_pin_the_version(tmp_path, game_world):
    _, truth = game_world
    registry_dir = str(tmp_path)
    publish_version(registry_dir, to_port(_jmodel(truth)), _INDEX_MAPS)
    telemetry.reset()
    faults.install_plan(faults.FaultPlan([
        faults.FaultRule("serving.registry.load", action="io", nth=1)]))
    registry = ModelRegistry(registry_dir, max_batch=4, warm=False, poll_interval=60,
                             retry_backoff_s=0.01, device=CPU)
    registry.start()
    try:
        assert registry.engine.version == "v-00000001"
        counters = telemetry.snapshot()["counters"]
        assert counters["serving.version_retries"] == 1
        assert counters.get("serving.skipped_versions") is None
        assert registry._skipped == {}
    finally:
        registry.stop()


def test_registry_transient_exhaustion_skips_refresh_not_forever(tmp_path, game_world):
    _, truth = game_world
    registry_dir = str(tmp_path)
    publish_version(registry_dir, to_port(_jmodel(truth)), _INDEX_MAPS)
    telemetry.reset()
    faults.install_plan(faults.FaultPlan([
        faults.FaultRule("serving.registry.load", action="io", probability=1.0)]))
    registry = ModelRegistry(registry_dir, max_batch=4, warm=False, poll_interval=60,
                             load_retries=1, retry_backoff_s=0.01, device=CPU)
    assert registry.refresh() is False
    counters = telemetry.snapshot()["counters"]
    assert counters["serving.version_retries"] == 1
    assert counters["serving.skipped_versions"] == 1
    assert registry._skipped == {}
    faults.clear_plan()
    assert registry.refresh() is True
    assert registry.engine.version == "v-00000001"


# ---------------------------------------------------------------------------
# front ends
# ---------------------------------------------------------------------------


def test_stdio_jsonl_mode(game_world):
    data, truth = game_world
    jm = _jmodel(truth)
    engine = ScoringEngine(to_port(jm), max_batch=8, version="v-test", device=CPU)
    inp = io.StringIO(json.dumps({"rows": _request_rows(truth, data, range(3))}) + "\n"
                      + json.dumps({"op": "health"}) + "\nnot json\n"
                      + json.dumps({"op": "metrics"}) + "\n")
    out = io.StringIO()
    assert serve_stdio(engine, inp, out) == 0
    lines = [json.loads(ln) for ln in out.getvalue().strip().splitlines()]
    np.testing.assert_allclose(lines[0]["scores"], _mean(jm, data, 3), atol=1e-6)
    assert lines[0]["model_version"] == "v-test"
    assert lines[1]["status"] == "serving"
    assert "error" in lines[2]
    assert "counters" in lines[3]


def _post(port, body, timeout=15):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/score",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(port, path, timeout=15):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return json.loads(resp.read())


def test_http_error_codes(game_world):
    _, truth = game_world
    engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=4, max_row_nnz=4, device=CPU)
    server = ScoringServer(ScoringService(engine, max_batch=4, max_delay_ms=1.0),
                           port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.port, {"not_rows": []})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.port, {"rows": [{"features": {"global": [[j, 1.0]
                                                                   for j in range(9)]}}]})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(server.port, "/nope")
        assert ei.value.code == 404
    finally:
        server.stop()


def test_serving_e2e_http_hot_swap(tmp_path, game_world):
    """Concurrent HTTP scoring matches predict_mean, and a registry publish
    mid-run swaps versions with zero failed requests."""
    data, truth = game_world
    j1, j2 = _jmodel(truth), _jmodel(truth, scale=0.5)
    expected = {"v-00000001": _mean(j1, data), "v-00000002": _mean(j2, data)}
    registry_dir = str(tmp_path / "registry")
    publish_version(registry_dir, to_port(j1), _INDEX_MAPS)
    registry = ModelRegistry(registry_dir, max_batch=16, poll_interval=0.2, device=CPU).start()
    service = ScoringService(registry, max_batch=16, max_delay_ms=2.0, queue_depth=10_000)
    server = ScoringServer(service, port=0).start()
    port = server.port
    stop = threading.Event()
    threads = []
    try:
        health = _get(port, "/healthz")
        assert (health["status"], health["model_version"], health["warm"]) == (
            "serving", "v-00000001", True)
        indices = list(range(8))
        rows = _request_rows(truth, data, indices)

        def check(result):
            np.testing.assert_allclose(result["scores"],
                                       expected[result["model_version"]][indices], atol=1e-6)

        for _ in range(4):
            check(_post(port, {"rows": rows}))
        assert "serving.unwarmed_bucket_calls" not in _get(port, "/metricsz")["counters"]
        failures, seen = [], set()

        def client():
            while not stop.is_set():
                try:
                    result = _post(port, {"rows": rows})
                    check(result)
                    seen.add(result["model_version"])
                except Exception as e:  # noqa: BLE001 — recorded, asserted empty
                    failures.append(repr(e))

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        publish_version(registry_dir, to_port(j2), _INDEX_MAPS)
        deadline = time.monotonic() + 30
        while "v-00000002" not in seen and time.monotonic() < deadline:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not failures, failures[:3]
        assert seen == {"v-00000001", "v-00000002"}
        assert _get(port, "/healthz")["model_version"] == "v-00000002"
        metrics = _get(port, "/metricsz")
        assert metrics["counters"]["serving.model_swaps"] == 2
        assert metrics["counters"]["serving.requests"] >= 4
        assert metrics["histograms"]["serving.queue_ms"]["count"] >= 4
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        server.stop()
        registry.stop()


def test_cli_serve_stdio_rejects_ignored_flags(tmp_path, game_world):
    from photon_ml_tpu_torch.cli import serve as serve_cli

    _, truth = game_world
    registry_dir = str(tmp_path / "registry")
    publish_version(registry_dir, to_port(_jmodel(truth)), _INDEX_MAPS)
    with pytest.raises(SystemExit, match="--nearline, --frontend"):
        serve_cli.main(["--registry-dir", registry_dir, "--stdio", "--max-batch", "8",
                        "--nearline", "userId", "--frontend", "asyncio", "--device", CPU])


def test_cli_serve_stdio_subprocess(tmp_path, game_world):
    """``cli serve --registry-dir ... --stdio --device cpu`` drives the whole
    stack (load, warm-up, request schema) from a clean process, and scores
    the JAX package's ``cli serve`` answers."""
    data, truth = game_world
    jm = _jmodel(truth)
    registry_dir = str(tmp_path / "registry")
    publish_version(registry_dir, to_port(jm), _INDEX_MAPS)
    stdin = (json.dumps({"rows": _request_rows(truth, data, range(4))}) + "\n"
             + json.dumps({"op": "health"}) + "\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli", "serve", "--registry-dir",
         registry_dir, "--stdio", "--max-batch", "8", "--device", CPU],
        input=stdin, capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    np.testing.assert_allclose(lines[0]["scores"], _mean(jm, data, 4), atol=1e-6)
    assert lines[0]["model_version"] == "v-00000001"
    health = lines[1]
    compile_state = health.pop("compile")
    assert set(compile_state) == {"1", "2", "4", "8"}
    for entry in compile_state.values():
        assert entry["compile_seconds"] >= 0 and entry["calls"] >= 1
        assert "flops" in entry and "bytes_accessed" in entry
    assert health == {"status": "serving", "model_version": "v-00000001", "warm": True,
                      "buckets": [1, 2, 4, 8]}


# ---------------------------------------------------------------------------
# cli score guard
# ---------------------------------------------------------------------------


def test_score_cli_requires_feature_indexes(tmp_path, game_world):
    from photon_ml_tpu_torch.cli.score import run

    _, truth = game_world
    model_dir = str(tmp_path / "model")
    save_game_model(to_port(_jmodel(truth)), model_dir)
    with pytest.raises(ModelLoadError, match="feature-indexes"):
        run(model_dir, {"format": "avro", "paths": []}, device=CPU)
    with pytest.raises(Exception) as ei:
        run(model_dir, {"format": "avro", "paths": []}, allow_index_rebuild=True, device=CPU)
    assert "feature-indexes" not in str(ei.value)


def test_engine_tables_are_the_models_on_the_device(game_world):
    """The upload: the fixed effect f32[d], each bucket's projection int32
    [E, K] and coefficients f32[E, K], bit for bit the model's."""
    _, truth = game_world
    tm = to_port(_jmodel(truth))
    engine = ScoringEngine(tm, device=CPU)
    assert engine.model_bytes == 4 * 6 + 8 * 12 * 4
    for (proj, coef), bm in zip(engine.re_tables(0), tm.models["perUser"].buckets):
        assert proj.dtype == torch.int32 and coef.dtype == torch.float32
        assert torch.equal(proj.long(), bm.projection) and torch.equal(coef, bm.coefficients)


def test_registry_versions_cross_between_packages(tmp_path, game_world):
    """A version the JAX package's ``publish_version`` wrote is served by the
    port's ``ModelRegistry`` with the JAX engine's scores, and a version the
    port published loads in the JAX package's registry with the port's."""
    from photon_ml_tpu.serving import ModelRegistry as JRegistry
    from photon_ml_tpu.serving import publish_version as j_publish

    data, truth = game_world
    rows = _request_rows(truth, data, range(data.num_rows))
    j1, j2 = _jmodel(truth), _jmodel(truth, scale=0.5)
    reg = str(tmp_path / "registry")
    j_publish(reg, j1, _INDEX_MAPS)
    port = ModelRegistry(reg, max_batch=16, warm=False, poll_interval=60, device=CPU).start()
    try:
        assert port.engine.version == "v-00000001"
        np.testing.assert_allclose(port.engine.score_rows(rows),
                                   JEngine(j1, max_batch=16).score_rows(rows), atol=1e-6)
        publish_version(reg, to_port(j2), _INDEX_MAPS)
        assert port.refresh() is True
        port_scores = port.engine.score_rows(rows)
    finally:
        port.stop()
    jreg = JRegistry(reg, max_batch=16, warm=False, poll_interval=60).start()
    try:
        assert jreg.engine.version == "v-00000002"
        np.testing.assert_allclose(jreg.engine.score_rows(rows), port_scores, atol=1e-6)
    finally:
        jreg.stop()


@pytest.mark.parametrize("flag,item", [(["--member", "1"], "14a \\(ii\\)"),
                                       (["--router"], "14a \\(ii\\)"),
                                       (["--announce-dir", "d"], "14a \\(ii\\)"),
                                       (["--trace-out", "t.jsonl"], "14d"),
                                       (["--telemetry-out", "t.jsonl"], "14d")])
def test_cli_serve_refuses_the_fleet_and_trace_flags(tmp_path, flag, item):
    """The reference's fleet and request-trace flags name their ROADMAP
    item before anything loads."""
    from photon_ml_tpu_torch.cli import serve as serve_cli

    with pytest.raises(NotImplementedError, match=rf"{flag[0]}.*item {item}"):
        serve_cli.main(["--registry-dir", str(tmp_path), "--stdio", "--device", CPU, *flag])


def test_cli_serve_hbm_budget_refuses_a_model_over_it(tmp_path, game_world):
    """``--hbm-budget-mb`` fails start-up when the served tables exceed it;
    a budget that holds them serves."""
    from photon_ml_tpu_torch.cli import serve as serve_cli

    _, truth = game_world
    registry_dir = str(tmp_path / "registry")
    publish_version(registry_dir, to_port(_jmodel(truth)), _INDEX_MAPS)
    with pytest.raises(SystemExit, match="over the --hbm-budget-mb budget"):
        serve_cli.main(["--registry-dir", registry_dir, "--stdio", "--device", CPU,
                        "--hbm-budget-mb", "0.0001"])
    model_dir = os.path.join(registry_dir, "v-00000001")
    stdin, stdout = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = io.StringIO(json.dumps({"op": "health"}) + "\n"), io.StringIO()
    try:
        assert serve_cli.main(["--model-dir", model_dir, "--stdio", "--device", CPU,
                               "--hbm-budget-mb", "1"]) == 0
        out = sys.stdout.getvalue()
    finally:
        sys.stdin, sys.stdout = stdin, stdout
    assert json.loads(out)["model_version"] == "v-00000001"


def test_engine_not_owned_entities_and_margins_match_the_reference(game_world):
    """A model whose random effect owns only some of its known entities (a
    fleet member's slice: bucket -1 for the others) scores those rows from
    the fixed effect alone and counts ``serving.not_owned_entities``; the raw
    margins with a per-row fixed-effect gate equal the JAX engine's."""
    import dataclasses

    data, truth = game_world
    jm = _jmodel(truth)
    jre = jm.models["perUser"]
    owned = np.asarray(jre.entity_bucket).copy()
    owned[::3] = -1  # every third user lives on another member
    jm = jm.with_model("perUser", dataclasses.replace(jre, entity_bucket=owned))
    rows = _request_rows(truth, data, range(data.num_rows))
    engine = ScoringEngine(to_port(jm), max_batch=16, device=CPU)
    jengine = JEngine(jm, max_batch=16)
    np.testing.assert_allclose(engine.score_rows(rows), jengine.score_rows(rows), atol=1e-6)
    not_owned = sum(1 for u in truth["users"][:data.num_rows] if owned[int(u)] < 0)
    assert telemetry.snapshot()["counters"]["serving.not_owned_entities"] == not_owned
    gate = [bool(i % 2) for i in range(len(rows))]
    np.testing.assert_allclose(engine.margin_rows(rows, gate),
                               jengine.margin_rows(rows, gate), atol=1e-6)
    with pytest.raises(BadRequest, match="one boolean per row"):
        engine.margin_rows(rows, gate[:-1])


def test_http_load_tool_drives_the_server_from_its_own_process(tmp_path, game_world):
    """``tools/http_load.py``, the closed-loop client process that path 15
    measures with: it prints ``ready``, one progress line an answer, stops
    on ``stop`` once its minimum has come back, and writes every answer
    (body index, version, seconds, scores) in the order it came back. The
    answers equal ``predict_mean``."""
    data, truth = game_world
    jm = _jmodel(truth)
    expected = _mean(jm, data)
    engine = ScoringEngine(to_port(jm), max_batch=8, device=CPU).warmup()
    server = ScoringServer(ScoringService(engine, max_batch=8, max_delay_ms=1.0),
                           port=0).start()
    indices = [list(range(a, a + n)) for a, n in ((0, 3), (5, 8), (40, 1), (70, 5))]
    bodies = tmp_path / "bodies.jsonl"
    bodies.write_text("".join(json.dumps({"rows": _request_rows(truth, data, idx)}) + "\n"
                              for idx in indices))
    out = tmp_path / "out.json"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "photon_ml_tpu_torch", "tools", "http_load.py"),
         "--port", str(server.port), "--bodies", str(bodies), "--out", str(out),
         "--clients", "2", "--min-requests", "10"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        assert proc.stdout.readline().split() == ["1", engine.version]
        proc.stdin.write("stop\n")
        proc.stdin.flush()
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop()
    assert proc.returncode == 0
    lines = rest.split("\n")
    assert lines[-2] == "end"
    load = json.loads(out.read_text())
    assert load["failures"] == []
    assert len(load["records"]) >= 10
    assert [int(ln.split()[0]) for ln in lines[:-2]] == list(range(2, len(load["records"]) + 1))
    for i, version, seconds, scores in load["records"]:
        assert version == engine.version and seconds > 0
        np.testing.assert_allclose(scores, expected[indices[i]], atol=1e-6)
