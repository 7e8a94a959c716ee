"""The port's entity-sharded engine, continuous batcher, asyncio front end,
nearline updates and fault seams, case for case with
tests/test_serving_sharded.py: the engine over ``[cpu] * 8`` (a ``model``
axis of 8) against the JAX engine on its 8-device CPU mesh and against
``predict_mean`` (atol 1e-6), a streamed checkpoint restored onto the mesh,
the nearline re-solve against a direct warm-started lane solve (atol 1e-6;
against the JAX package's vmapped solve within the lane solvers' parity band,
atol 1e-4), untouched entities bit for bit across a flush, the publish
round trip, the seams ``serving.async_dispatch``, ``serving.nearline_event``
and ``serving.nearline_apply`` (with the hard-kill chaos row in
subprocesses), and a sharded asyncio server through a hot swap and a
nearline update mid-traffic.

``test_serving_report_section_roundtrip``: the RunReport "Serving" section
of the port from the same serving counters, its JSON and markdown the JAX
package's.

Left out, with their subject elsewhere: ``test_serving_slo_smoke``,
``test_gate_skips_serving_slo_metrics_missing_from_baseline`` and
``test_serving_slo_budget_truncation`` (the SLO bench: the port's benchmark
is a PR of its own).
"""

import dataclasses
import http.client
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

from photon_ml_tpu.game.models import FixedEffectModel as JFE
from photon_ml_tpu.game.models import GameModel as JGame
from photon_ml_tpu.game.models import RandomEffectBucketModel as JBucket
from photon_ml_tpu.game.models import RandomEffectModel as JRE
from photon_ml_tpu.optim.factory import OptimizerConfig as JOpt
from photon_ml_tpu.optim.factory import RegularizationContext as JReg
from photon_ml_tpu.optim.factory import RegularizationType as JRegType
from photon_ml_tpu.parallel.mesh import make_mesh as j_make_mesh
from photon_ml_tpu.serving import ScoringEngine as JEngine
from photon_ml_tpu.testing import generate_game_dataset
from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.convert import game_model_from_jax
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.parallel import make_mesh
from photon_ml_tpu_torch.parallel.sharding import ElasticPlacementError, EntityShards
from photon_ml_tpu_torch.serving import (
    AsyncScoringServer,
    BadRequest,
    ContinuousBatcher,
    MicroBatcher,
    ModelRegistry,
    NearlineUpdater,
    Overloaded,
    ScoringEngine,
    ScoringServer,
    ScoringService,
    publish_version,
    scan_versions,
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
    """tests/test_serving_sharded.py's FE + per-user RE model."""
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


def to_port(jmodel):
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
    Xg, Xu, users = truth["Xg"], truth["Xu"], truth["users"]
    return [{"features": {"global": [[j, float(Xg[i, j])] for j in range(Xg.shape[1])
                                     if Xg[i, j] != 0],
                          "user": [[j, float(Xu[i, j])] for j in range(Xu.shape[1])
                                   if Xu[i, j] != 0]},
             "ids": {"userId": int(users[i])}, "offset": float(data.offset[i])}
            for i in indices]


@pytest.fixture(scope="module")
def mesh_world():
    """32 users (16 per geometry bucket, divisible by the 8-way entity axis)."""
    return generate_game_dataset(n_users=32, rows_per_user=6, fe_dim=6, re_dim=4, seed=11)


def _mean(jmodel, data, n=None):
    return np.asarray(jmodel.predict_mean(data))[: data.num_rows if n is None else n]


_INDEX_MAPS = {"global": [f"g{j}" for j in range(6)], "user": [f"u{j}" for j in range(4)]}


def _entity_mesh(n=8):
    return make_mesh({"model": n}, [torch.device(CPU)] * n)


def _post(port, path, body, timeout=15):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(port, path, timeout=15):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return json.loads(resp.read())


def _wedged_service(engine, scorer, batcher_cls, **kw):
    service = ScoringService.__new__(ScoringService)
    service._source = engine
    service.request_timeout_s = 30.0
    service._batcher = batcher_cls(scorer, **kw)
    service._updater = None
    return service


# ---------------------------------------------------------------------------
# entity-sharded engine
# ---------------------------------------------------------------------------


def test_sharded_engine_matches_predict_mean(mesh_world, multichip):
    data, truth = mesh_world
    jm = _jmodel(truth)
    rows = _request_rows(truth, data, range(data.num_rows))
    engine = ScoringEngine(to_port(jm), max_batch=32, version="sharded",
                           mesh=_entity_mesh()).warmup()
    assert engine.entity_axis == "model"
    got = engine.score_rows(rows)
    np.testing.assert_allclose(got, _mean(jm, data), atol=1e-6)
    jengine = JEngine(jm, max_batch=32, mesh=j_make_mesh({"model": 8}))
    np.testing.assert_allclose(got, jengine.score_rows(rows), atol=1e-6)
    # each device holds 1/8 of a bucket's rows, and the sharded engine is
    # the replicated one bit for bit
    table = engine.re_tables(0)[0][1]
    assert isinstance(table, EntityShards)
    assert {tuple(p.shape) for p in table.parts} == {(2, 4)}
    single = ScoringEngine(to_port(jm), max_batch=32, device=CPU)
    np.testing.assert_array_equal(single.score_rows(rows), got)


def test_sharded_engine_rejects_indivisible_axis_with_valid_sizes(mesh_world, multichip):
    _, truth = mesh_world
    with pytest.raises(ElasticPlacementError) as ei:
        ScoringEngine(to_port(_jmodel(truth, n_buckets=3)), mesh=_entity_mesh())
    message = str(ei.value)
    assert "valid target axis sizes" in message and "serving mesh" in message
    assert "[1]" in message


def test_sharded_engine_from_streamed_checkpoint(tmp_path, mesh_world, multichip):
    """load(re_checkpoints=...) restores a streamed checkpoint's table onto
    the serving mesh (restore_placed) and serves the checkpoint's
    coefficients, not the model dir's; the JAX package wrote the
    checkpoint."""
    from photon_ml_tpu.game.checkpoint import CheckpointSpec as JSpec
    from photon_ml_tpu.game.checkpoint import StreamCheckpointState as JState
    from photon_ml_tpu.game.checkpoint import StreamingCheckpointManager as JManager
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.data.model_store import save_game_model
    from photon_ml_tpu_torch.game.checkpoint import (
        CheckpointError,
        StreamCheckpointState,
        StreamingCheckpointManager,
    )

    data, truth = mesh_world
    fresh = _jmodel(truth, n_buckets=1)
    stale = to_port(fresh)
    re_sub = stale.models["perUser"]
    stale = stale.with_model("perUser", dataclasses.replace(re_sub, buckets=(
        dataclasses.replace(re_sub.buckets[0],
                            coefficients=torch.zeros_like(re_sub.buckets[0].coefficients)),)))
    model_dir = str(tmp_path / "model")
    save_game_model(stale, model_dir)
    for shard, names in _INDEX_MAPS.items():
        IndexMap(names).save(os.path.join(model_dir, "feature-indexes", shard))
    ckpt_dir = str(tmp_path / "ckpt")
    JManager(JSpec(directory=ckpt_dir)).save(JState(
        next_chunk=1, coefficients=np.asarray(fresh.models["perUser"].buckets[0].coefficients)))
    engine = ScoringEngine.load(model_dir, max_batch=16, mesh=_entity_mesh(),
                                re_checkpoints={"perUser": ckpt_dir}).warmup()
    got = engine.score_rows(_request_rows(truth, data, range(data.num_rows)))
    np.testing.assert_allclose(got, _mean(fresh, data), atol=1e-6)
    ro = StreamingCheckpointManager.open_for_restore(ckpt_dir)
    with pytest.raises(CheckpointError, match="read-only"):
        ro.save(StreamCheckpointState(next_chunk=2, coefficients=np.zeros((2, 2))))


# ---------------------------------------------------------------------------
# continuous batcher and deadline edges
# ---------------------------------------------------------------------------


def test_continuous_batcher_never_waits_on_a_timer():
    b = ContinuousBatcher(lambda rows: (np.zeros(len(rows), np.float32), "v"), max_batch=8,
                          max_delay_ms=10_000.0).start()
    try:
        t0 = time.monotonic()
        b.submit([{}]).result(timeout=10)
        assert time.monotonic() - t0 < 5.0
    finally:
        b.stop()


def test_continuous_batcher_admits_into_next_bucket_as_capacity_frees():
    dispatched, gate, entered = [], threading.Event(), threading.Event()

    def scorer(rows):
        dispatched.append(len(rows))
        if len(dispatched) == 1:
            entered.set()
            gate.wait(timeout=10)
        return np.zeros(len(rows), np.float32), "v"

    b = ContinuousBatcher(scorer, max_batch=8, queue_depth=100).start()
    try:
        first = b.submit([{}])
        assert entered.wait(timeout=10)  # batch 1 is in flight
        later = [b.submit([{}]) for _ in range(4)]
        gate.set()
        assert len(first.result(timeout=10)["scores"]) == 1
        for f in later:
            f.result(timeout=10)
    finally:
        gate.set()
        b.stop()
    assert dispatched == [1, 4]


def test_batcher_request_arriving_exactly_at_bucket_full():
    dispatched, gate, entered = [], threading.Event(), threading.Event()

    def scorer(rows):
        dispatched.append(len(rows))
        if len(dispatched) == 1:
            entered.set()
            gate.wait(timeout=10)
        return np.zeros(len(rows), np.float32), "v"

    b = ContinuousBatcher(scorer, max_batch=4, queue_depth=100).start()
    try:
        first = b.submit([{}])
        assert entered.wait(timeout=10)  # batch 1 is in flight
        fill = b.submit([{}] * 4)
        extra = b.submit([{}])
        gate.set()
        first.result(timeout=10)
        assert len(fill.result(timeout=10)["scores"]) == 4
        assert len(extra.result(timeout=10)["scores"]) == 1
    finally:
        gate.set()
        b.stop()
    assert dispatched == [1, 4, 1]


def test_batcher_timed_out_future_cancelled_mid_dispatch():
    entered, gate = threading.Event(), threading.Event()

    def scorer(rows):
        entered.set()
        gate.wait(timeout=10)
        return np.zeros(len(rows), np.float32), "v"

    b = MicroBatcher(scorer, max_batch=4, max_delay_ms=1.0).start()
    try:
        doomed = b.submit([{}])
        assert entered.wait(timeout=10)
        doomed.cancel()
        gate.set()
        time.sleep(0.1)
        assert len(b.submit([{}]).result(timeout=10)["scores"]) == 1
    finally:
        gate.set()
        b.stop()


def test_shed_accounting_matches_returned_503s_exactly(mesh_world):
    data, truth = mesh_world
    engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=4, device=CPU).warmup()
    gate = threading.Event()

    def slow_scorer(rows):
        gate.wait(timeout=10)
        return engine.score_rows(rows), engine.version

    service = _wedged_service(engine, slow_scorer, ContinuousBatcher, max_batch=4,
                              queue_depth=4)
    server = ScoringServer(service, port=0).start()
    threads = []
    try:
        rows = _request_rows(truth, data, range(2))
        results, lock = [], threading.Lock()

        def client():
            try:
                _post(server.port, "/v1/score", {"rows": rows})
                code = 200
            except urllib.error.HTTPError as e:
                code = e.code
            with lock:
                results.append(code)

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10  # until the burst overflows the queue
        while (not telemetry.snapshot()["counters"].get("serving.shed")
               and time.monotonic() < deadline):
            time.sleep(0.02)
        gate.set()
        for t in threads:
            t.join(timeout=30)
        got_503 = sum(1 for c in results if c == 503)
        assert got_503 > 0
        assert sum(1 for c in results if c == 200) == len(results) - got_503
        assert telemetry.snapshot()["counters"].get("serving.shed", 0) == got_503
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=30)
        server.stop()


# ---------------------------------------------------------------------------
# asyncio front end
# ---------------------------------------------------------------------------


def test_async_server_scores_and_maps_errors(mesh_world):
    data, truth = mesh_world
    jm = _jmodel(truth)
    engine = ScoringEngine(to_port(jm), max_batch=8, version="v-aio", device=CPU).warmup()
    server = AsyncScoringServer(ScoringService(engine, max_batch=8, batcher="continuous"),
                                port=0).start()
    try:
        rows = _request_rows(truth, data, range(4))
        result = _post(server.port, "/v1/score", {"rows": rows})
        np.testing.assert_allclose(result["scores"], _mean(jm, data, 4), atol=1e-6)
        assert result["model_version"] == "v-aio"
        health = _get(server.port, "/healthz")
        assert health["status"] == "serving" and health["warm"]
        metrics = _get(server.port, "/metricsz")
        assert "counters" in metrics and "histograms" in metrics
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.port, "/v1/score", {"not_rows": []})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(server.port, "/nope")
        assert ei.value.code == 404
        margins = _post(server.port, "/v1/margins", {"rows": rows[:2],
                                                     "include_fixed": [True, False]})
        np.testing.assert_allclose(margins["margins"],
                                   engine.margin_rows(rows[:2], [True, False]), atol=0)
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=15)
        try:
            for _ in range(2):
                conn.request("POST", "/v1/score", body=json.dumps({"rows": rows[:1]}),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                assert resp.status == 200
                resp.read()
        finally:
            conn.close()
    finally:
        server.stop()


def test_health_and_metrics_stay_responsive_while_scoring_is_wedged(mesh_world):
    data, truth = mesh_world
    engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=4, device=CPU).warmup()
    gate = threading.Event()

    def wedged_scorer(rows):
        gate.wait(timeout=30)
        return engine.score_rows(rows), engine.version

    for server_cls, batcher_cls in ((ScoringServer, MicroBatcher),
                                    (AsyncScoringServer, ContinuousBatcher)):
        service = _wedged_service(engine, wedged_scorer, batcher_cls, max_batch=4,
                                  queue_depth=8)
        server = server_cls(service, port=0).start()
        try:
            rows = _request_rows(truth, data, range(2))
            threading.Thread(target=lambda: service._batcher.submit(rows), daemon=True).start()
            time.sleep(0.1)
            for path in ("/healthz", "/metricsz"):
                t0 = time.monotonic()
                assert _get(server.port, path, timeout=5)
                assert time.monotonic() - t0 < 2.0, (server_cls, path)
        finally:
            gate.set()
            server.stop()
            gate.clear()


# ---------------------------------------------------------------------------
# nearline personalization
# ---------------------------------------------------------------------------


_OPT = dict(max_iterations=30, tolerance=1e-8, regularization_weight=0.5)
_NEARLINE_CONFIG = OptimizerConfig(
    regularization=RegularizationContext(RegularizationType.L2), **_OPT)
_J_NEARLINE_CONFIG = JOpt(regularization=JReg(reg_type=JRegType.L2), **_OPT)


def test_nearline_resolve_matches_direct_solve(mesh_world):
    """The nearline row swap equals the same warm-started per-entity problem
    solved directly: the port's lane solve within 1e-6, and
    the JAX package's vmapped solve within the lane solvers' band."""
    from photon_ml_tpu.game.coordinates import _re_solver
    from photon_ml_tpu.ops.dense import DenseBatch as JDense
    from photon_ml_tpu.optim.factory import build_objective as j_objective
    from photon_ml_tpu_torch.ops.dense import DenseBatch
    from photon_ml_tpu_torch.optim.adapter import glm_adapter
    from photon_ml_tpu_torch.optim.factory import build_objective, dispatch_solve

    _, truth = mesh_world
    jm = _jmodel(truth)
    engine = ScoringEngine(to_port(jm), max_batch=8, version="t", device=CPU).warmup()
    updater = NearlineUpdater(engine, id_name="userId", config=_NEARLINE_CONFIG,
                              rows_per_solve=4)
    target = 6
    events = [
        {"ids": {"userId": target},
         "features": {"global": [[0, 1.0], [2, -0.5]], "user": [[0, 1.0], [1, 0.5], [3, -1.0]]},
         "label": 1.0, "offset": 0.2},
        {"ids": {"userId": target}, "features": {"user": [[2, 2.0]]}, "label": 0.0},
    ]
    w_global = np.asarray(jm.models["fixed"].coefficients, np.float64)
    bucket = int(np.asarray(jm.models["perUser"].entity_bucket)[target])
    pos = int(np.asarray(jm.models["perUser"].entity_pos)[target])
    w0 = np.asarray(jm.models["perUser"].buckets[bucket].coefficients)[pos]
    R, K = 4, 4
    x = np.zeros((1, R, K), np.float32)
    x[0, 0, [0, 1, 3]] = [1.0, 0.5, -1.0]
    x[0, 1, 2] = 2.0
    labels = np.zeros((1, R), np.float32)
    labels[0, 0] = 1.0
    offsets = np.zeros((1, R), np.float32)
    offsets[0, 0] = 0.2 + 1.0 * w_global[0] - 0.5 * w_global[2]
    weights = np.zeros((1, R), np.float32)
    weights[0, :2] = 1.0
    direct = dispatch_solve(
        glm_adapter(build_objective("logistic", _NEARLINE_CONFIG),
                    DenseBatch.from_arrays(x, labels, offsets, weights, device=CPU)),
        torch.from_numpy(w0[None, :].copy()), _NEARLINE_CONFIG, 0.0, None, device=CPU)
    jres, _ = _re_solver(_J_NEARLINE_CONFIG, "logistic")(
        j_objective("logistic", _J_NEARLINE_CONFIG),
        JDense(x=jnp.asarray(x), labels=jnp.asarray(labels), offsets=jnp.asarray(offsets),
               weights=jnp.asarray(weights)),
        jnp.asarray(w0[None, :]), jnp.float32(0.0), None)

    assert updater.submit(events) == 2
    assert updater.flush() == {"entities": 1, "rows": 2, "applies": 1}
    got_row = engine.re_tables(0)[bucket][1][pos].numpy()
    np.testing.assert_allclose(got_row, direct.w[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(got_row, np.asarray(jres.w)[0], atol=1e-4)
    assert not np.allclose(got_row, w0)


def test_nearline_event_validation_and_buffer_semantics(mesh_world):
    _, truth = mesh_world
    engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=8, device=CPU)
    updater = NearlineUpdater(engine, id_name="userId", config=_NEARLINE_CONFIG,
                              rows_per_solve=2, queue_depth=4)
    with pytest.raises(BadRequest, match="'ids' must contain"):
        updater.submit([{"features": {}, "label": 1.0}])
    with pytest.raises(BadRequest, match="'label' must be a number"):
        updater.submit([{"ids": {"userId": 1}, "label": "x"}])
    with pytest.raises(BadRequest, match="col, value"):
        updater.submit([{"ids": {"userId": 1}, "label": 1.0,
                         "features": {"user": [["named", "", 1.0]]}}])
    assert updater.submit([{"ids": {"userId": 424242}, "label": 1.0, "features": {}}]) == 0
    assert telemetry.snapshot()["counters"]["serving.nearline.unknown_entities"] == 1
    ev = {"ids": {"userId": 1}, "label": 1.0, "features": {}}
    updater.submit([ev] * 2)
    updater.submit([dict(ev, ids={"userId": 2})] * 2)
    with pytest.raises(Overloaded, match="nearline buffer at capacity"):
        updater.submit([dict(ev, ids={"userId": 3})])
    assert len(updater._buffers["1"]) == 2


def test_nearline_untouched_entities_bit_identical(mesh_world):
    """Replicated and on the 8-way mesh: the updated entity's scores move,
    everyone else's are bit for bit the scores from before the flush."""
    data, truth = mesh_world
    rows = _request_rows(truth, data, range(data.num_rows))
    touched = np.asarray([int(u) == 5 for u in truth["users"][:data.num_rows]])
    assert touched.any()
    afters = []
    for kw in ({"device": CPU}, {"mesh": _entity_mesh()}):
        engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=32, version="t",
                               **kw).warmup()
        before = engine.score_rows(rows).copy()
        updater = NearlineUpdater(engine, id_name="userId", config=_NEARLINE_CONFIG,
                                  rows_per_solve=2)
        updater.submit([{"ids": {"userId": 5}, "label": 1.0,
                         "features": {"user": [[0, 1.0]]}}])
        updater.flush()
        after = engine.score_rows(rows)
        assert not np.allclose(before[touched], after[touched])
        np.testing.assert_array_equal(before[~touched], after[~touched])
        afters.append(after)
    np.testing.assert_array_equal(afters[0], afters[1])


def test_nearline_publish_roundtrip(tmp_path, mesh_world):
    data, truth = mesh_world
    model = to_port(_jmodel(truth))
    registry_dir = str(tmp_path / "registry")
    publish_version(registry_dir, model, _INDEX_MAPS)
    engine = ScoringEngine(model, max_batch=16, version="v-00000001", device=CPU).warmup()
    updater = NearlineUpdater(engine, id_name="userId", config=_NEARLINE_CONFIG,
                              rows_per_solve=2, publish_dir=registry_dir,
                              publish_interval_s=0.0, index_maps=_INDEX_MAPS)
    assert updater.publish() is None
    updater.submit([{"ids": {"userId": 9}, "label": 1.0, "features": {"user": [[1, 1.0]]}}])
    updater.flush()
    path = updater.publish()
    assert path is not None and path.endswith("v-00000002")
    with open(os.path.join(path, "model-metadata.json")) as fh:
        assert json.load(fh)["extra"]["nearline_seq"] == 1
    registry = ModelRegistry(registry_dir, max_batch=16, warm=False, poll_interval=60,
                             device=CPU).start()
    try:
        assert registry.engine.version == "v-00000002"
        rows = _request_rows(truth, data, range(data.num_rows))
        np.testing.assert_allclose(registry.engine.score_rows(rows), engine.score_rows(rows),
                                   atol=1e-6)
    finally:
        registry.stop()


# ---------------------------------------------------------------------------
# fault seams and the chaos row
# ---------------------------------------------------------------------------


def test_async_dispatch_fault_seam_isolated_to_callers():
    b = ContinuousBatcher(lambda rows: (np.zeros(len(rows), np.float32), "v"),
                          max_batch=4).start()
    try:
        faults.install_plan(faults.FaultPlan([
            faults.FaultRule("serving.async_dispatch", action="raise", nth=1)]))
        with pytest.raises(faults.InjectedFault):
            b.submit([{}]).result(timeout=10)
        faults.clear_plan()
        assert len(b.submit([{}]).result(timeout=10)["scores"]) == 1
    finally:
        faults.clear_plan()
        b.stop()


def test_nearline_event_fault_seam(mesh_world):
    _, truth = mesh_world
    engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=8, device=CPU)
    updater = NearlineUpdater(engine, id_name="userId", config=_NEARLINE_CONFIG)
    faults.install_plan(faults.FaultPlan([
        faults.FaultRule("serving.nearline_event", action="raise", nth=1)]))
    try:
        with pytest.raises(faults.InjectedFault):
            updater.submit([{"ids": {"userId": 1}, "label": 1.0, "features": {}}])
    finally:
        faults.clear_plan()
    assert updater.submit([{"ids": {"userId": 1}, "label": 1.0, "features": {}}]) == 1


def test_nearline_apply_fault_leaves_tables_untouched(mesh_world):
    data, truth = mesh_world
    engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=16, device=CPU).warmup()
    rows = _request_rows(truth, data, range(8))
    before = engine.score_rows(rows).copy()
    updater = NearlineUpdater(engine, id_name="userId", config=_NEARLINE_CONFIG,
                              rows_per_solve=2)
    updater.submit([{"ids": {"userId": 3}, "label": 1.0, "features": {"user": [[0, 1.0]]}}])
    faults.install_plan(faults.FaultPlan([
        faults.FaultRule("serving.nearline_apply", action="raise", nth=1)]))
    try:
        with pytest.raises(faults.InjectedFault):
            updater.flush()
    finally:
        faults.clear_plan()
    assert engine.nearline_seq == 0
    np.testing.assert_array_equal(engine.score_rows(rows), before)
    assert updater.flush()["applies"] == 1
    assert engine.nearline_seq == 1


def test_nearline_oov_only_event_leaves_row_untouched(mesh_world):
    data, truth = mesh_world
    engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=32, device=CPU).warmup()
    rows = _request_rows(truth, data, range(data.num_rows))
    before = engine.score_rows(rows).copy()
    updater = NearlineUpdater(engine, id_name="userId", config=_NEARLINE_CONFIG,
                              rows_per_solve=2)
    assert updater.submit([
        {"ids": {"userId": 5}, "label": 1.0, "features": {"user": [[99, 1.0]]}},
        {"ids": {"userId": 6}, "label": 1.0, "features": {}},
        {"ids": {"userId": 7}, "label": 1.0, "weight": 0.0, "features": {"user": [[0, 1.0]]}},
    ]) == 3
    assert updater.flush() == {"entities": 0, "rows": 0, "applies": 0}
    assert engine.nearline_seq == 0
    np.testing.assert_array_equal(engine.score_rows(rows), before)
    assert telemetry.snapshot()["counters"]["serving.nearline.dropped_events"] == 3


def test_nearline_bucket_failure_isolated_and_requeued(mesh_world):
    _, truth = mesh_world
    engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=16, device=CPU).warmup()
    updater = NearlineUpdater(engine, id_name="userId", config=_NEARLINE_CONFIG,
                              rows_per_solve=2)
    updater.submit([
        {"ids": {"userId": 2}, "label": 1.0, "features": {"user": [[0, 1.0]]}},
        {"ids": {"userId": 3}, "label": 0.0, "features": {"user": [[1, 1.0]]}},
    ])
    faults.install_plan(faults.FaultPlan([
        faults.FaultRule("serving.nearline_apply", action="raise", nth=1)]))
    try:
        with pytest.raises(faults.InjectedFault):
            updater.flush()
    finally:
        faults.clear_plan()
    assert engine.nearline_seq == 1
    assert "2" in updater._buffers and "3" not in updater._buffers
    assert updater.flush()["entities"] == 1
    assert engine.nearline_seq == 2


def test_nearline_submit_accepts_new_entities_after_swap(mesh_world):
    _, truth = mesh_world
    small = dict(truth)
    small["w_users"] = truth["w_users"][:16]
    old_engine = ScoringEngine(to_port(_jmodel(small)), max_batch=8, device=CPU)
    new_engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=8, device=CPU)

    class Src:
        def __init__(self, engine):
            self.engine = engine

    src = Src(old_engine)
    updater = NearlineUpdater(src, id_name="userId", config=_NEARLINE_CONFIG, rows_per_solve=2)
    ev = {"ids": {"userId": 20}, "label": 1.0, "features": {"user": [[0, 1.0]]}}
    assert updater.submit([ev]) == 0
    src.engine = new_engine
    assert updater.submit([ev]) == 1
    assert updater.flush()["entities"] == 1
    assert (new_engine.nearline_seq, old_engine.nearline_seq) == (1, 0)


def test_nearline_applied_rows_counts_real_entities(mesh_world):
    _, truth = mesh_world
    engine = ScoringEngine(to_port(_jmodel(truth)), max_batch=16, device=CPU).warmup()
    updater = NearlineUpdater(engine, id_name="userId", config=_NEARLINE_CONFIG,
                              rows_per_solve=2)
    updater.submit([{"ids": {"userId": u}, "label": 1.0, "features": {"user": [[0, 1.0]]}}
                    for u in (0, 2, 4)])
    assert updater.flush()["entities"] == 3
    assert telemetry.snapshot()["counters"]["serving.nearline.applied_rows"] == 3


_CHAOS_WORKER = r"""
import json, sys
from photon_ml_tpu_torch.serving import ModelRegistry, NearlineUpdater
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig, RegularizationContext, RegularizationType)

registry_dir = sys.argv[1]
registry = ModelRegistry(registry_dir, max_batch=8, warm=False, poll_interval=60,
                         device="cpu").start()
try:
    updater = NearlineUpdater(
        registry, id_name="userId",
        config=OptimizerConfig(max_iterations=10, regularization_weight=0.5,
                               regularization=RegularizationContext(RegularizationType.L2)),
        rows_per_solve=2, publish_dir=registry_dir, publish_interval_s=0.0,
        index_maps={"global": [f"g{j}" for j in range(6)],
                    "user": [f"u{j}" for j in range(4)]})
    updater.submit([{"ids": {"userId": 2}, "label": 1.0, "features": {"user": [[0, 1.0]]}}])
    updater.flush()
    path = updater.publish()
    print(json.dumps({"published": path}))
finally:
    registry.stop()
"""


def test_chaos_hard_kill_during_nearline_swap_keeps_registry_consistent(tmp_path, mesh_world):
    """A worker hard-killed (os._exit) at the serving.nearline_apply commit —
    at the table swap and at the registry publish — leaves the registry
    serving the old version; an unarmed rerun publishes cleanly."""
    _, truth = mesh_world
    registry_dir = str(tmp_path / "registry")
    publish_version(registry_dir, to_port(_jmodel(truth)), _INDEX_MAPS)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def run(plan):
        e = dict(env)
        e.pop("PHOTON_FAULT_PLAN", None)
        if plan is not None:
            e["PHOTON_FAULT_PLAN"] = json.dumps(plan)
        return subprocess.run([sys.executable, "-c", _CHAOS_WORKER, registry_dir],
                              capture_output=True, text=True, timeout=300, cwd=REPO, env=e)

    for nth in (1, 2):
        proc = run({"rules": [{"point": "serving.nearline_apply", "action": "exit",
                               "nth": nth}]})
        assert proc.returncode == faults.DEFAULT_EXIT_CODE, proc.stderr[-2000:]
        assert [v for v, _p in scan_versions(registry_dir)] == [1], nth
        registry = ModelRegistry(registry_dir, max_batch=8, warm=False, poll_interval=60,
                                 device=CPU).start()
        try:
            assert registry.engine.version == "v-00000001"
        finally:
            registry.stop()
    proc = run(None)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["published"].endswith("v-00000002")
    assert [v for v, _p in scan_versions(registry_dir)] == [1, 2]


# ---------------------------------------------------------------------------
# sharded + async + hot swap + nearline, mid-traffic
# ---------------------------------------------------------------------------


def test_sharded_async_serving_survives_swap_and_nearline_mid_traffic(tmp_path, mesh_world,
                                                                      multichip):
    """RE tables over the 8-way mesh, concurrent HTTP scores within 1e-6 of
    predict_mean across a registry hot swap and a nearline update applied
    mid-traffic (the updated entity moves, the others stay bit for bit on
    every reply), zero failed requests, and no call outside the warmed
    buckets. A reply is held to the pre-update scores in full only if it
    left before the update was posted: the flush swaps the rows before the
    test can mark it applied, so a reply in between may carry either."""
    data, truth = mesh_world
    j1, j2 = _jmodel(truth), _jmodel(truth, scale=0.5)
    expected = {"v-00000001": _mean(j1, data), "v-00000002": _mean(j2, data)}
    registry_dir = str(tmp_path / "registry")
    publish_version(registry_dir, to_port(j1), _INDEX_MAPS)
    registry = ModelRegistry(registry_dir, max_batch=16, poll_interval=0.2,
                             mesh=_entity_mesh(), entity_axis="model").start()
    updater = NearlineUpdater(registry, id_name="userId", config=_NEARLINE_CONFIG,
                              rows_per_solve=2)
    service = ScoringService(registry, max_batch=16, queue_depth=10_000,
                             batcher="continuous").attach_nearline(updater)
    server = AsyncScoringServer(service, port=0).start()
    port = server.port
    indices = list(range(12))
    target = int(truth["users"][0])
    t_mask = np.asarray([int(truth["users"][i]) == target for i in indices])
    stop = threading.Event()
    threads = []
    try:
        assert _get(port, "/healthz")["entity_axis"] == "model"
        rows = _request_rows(truth, data, indices)
        failures, seen = [], set()
        update_posted = threading.Event()
        nearline_applied = threading.Event()
        post_update, pre = [], {}

        def client():
            while not stop.is_set():
                try:
                    posted = update_posted.is_set()  # before the request leaves
                    got = _post(port, "/v1/score", {"rows": rows})
                    version = got["model_version"]
                    scores = np.asarray(got["scores"])
                    want = expected[version][indices]
                    if posted and version == "v-00000002":
                        # the target rows may carry the update or not yet
                        np.testing.assert_allclose(scores[~t_mask], want[~t_mask], atol=1e-6)
                    else:
                        np.testing.assert_allclose(scores, want, atol=1e-6)
                    if version == "v-00000002" and "scores" in pre:
                        np.testing.assert_array_equal(scores[~t_mask], pre["scores"][~t_mask])
                    seen.add(version)
                    if nearline_applied.is_set():
                        post_update.append(scores)
                except Exception as e:  # noqa: BLE001 — asserted empty
                    failures.append(repr(e))

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        publish_version(registry_dir, to_port(j2), _INDEX_MAPS)
        deadline = time.monotonic() + 60
        while "v-00000002" not in seen and time.monotonic() < deadline:
            time.sleep(0.05)
        assert "v-00000002" in seen
        pre_update = np.asarray(_post(port, "/v1/score", {"rows": rows})["scores"])
        np.testing.assert_allclose(pre_update, expected["v-00000002"][indices], atol=1e-6)
        pre["scores"] = pre_update
        update_posted.set()
        assert _post(port, "/v1/update", {"events": [
            {"ids": {"userId": target}, "label": 1.0,
             "features": {"user": [[0, 1.0], [2, -1.0]]}}]}) == {"accepted": 1}
        updater.flush()
        nearline_applied.set()
        time.sleep(0.4)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not failures, failures[:3]
        final = np.asarray(_post(port, "/v1/score", {"rows": rows})["scores"])
        np.testing.assert_array_equal(final[~t_mask], pre_update[~t_mask])
        assert not np.allclose(final[t_mask], pre_update[t_mask])
        np.testing.assert_allclose(final, registry.engine.score_rows(rows), atol=1e-7)
        if post_update:
            np.testing.assert_allclose(post_update[-1], final, atol=1e-7)
        assert "serving.unwarmed_bucket_calls" not in telemetry.snapshot()["counters"]
        health = _get(port, "/healthz")
        assert health["model_version"] == "v-00000002" and health["nearline_seq"] >= 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        server.stop()
        registry.stop()


def test_nearline_targets_the_first_coordinate_of_its_id(mesh_world):
    """A model with two random effects keyed by one id (path 9's shape):
    the updater re-solves the first one's rows (the slot ``re_slot_for``
    names) and reads the second as part of the residual offset. The JAX
    package pairs the first slot's table with the last coordinate's
    projections instead (ROADMAP Queue 3); the port keeps them one."""
    import dataclasses as dc

    from photon_ml_tpu_torch.ops.dense import DenseBatch
    from photon_ml_tpu_torch.optim.adapter import glm_adapter
    from photon_ml_tpu_torch.optim.factory import build_objective, dispatch_solve

    _, truth = mesh_world
    base = to_port(_jmodel(truth))
    second = base.models["perUser"]
    # the second coordinate: the same users over the global shard, 6 features
    proj = torch.arange(6).repeat(16, 1)
    coefs = torch.linspace(-0.3, 0.3, 16 * 6).reshape(16, 6)
    second = dc.replace(second, shard_name="global", buckets=tuple(
        dc.replace(b, projection=proj, coefficients=coefs * (i + 1))
        for i, b in enumerate(second.buckets)))
    model = base.with_model("perUserGlobal", second)
    engine = ScoringEngine(model, max_batch=8, device=CPU)
    assert engine.re_slot_for("userId") == 0
    updater = NearlineUpdater(engine, id_name="userId", config=_NEARLINE_CONFIG,
                              rows_per_solve=2)
    target = 6
    bucket, pos = int(second.entity_bucket[target]), int(second.entity_pos[target])
    w0 = engine.re_tables(0)[bucket][1][pos].clone()
    other_before = engine.re_tables(1)[bucket][1].clone()
    event = {"ids": {"userId": target}, "label": 1.0,
             "features": {"global": [[1, 2.0]], "user": [[0, 1.0], [3, -1.0]]}}
    assert updater.submit([event]) == 1
    assert updater.flush()["applies"] == 1
    w_fe = model.models["fixed"].coefficients
    offset = float(w_fe[1]) * 2.0 + float(second.buckets[bucket].coefficients[pos, 1]) * 2.0
    x = np.zeros((1, 2, 4), np.float32)
    x[0, 0, [0, 3]] = [1.0, -1.0]
    direct = dispatch_solve(
        glm_adapter(build_objective("logistic", _NEARLINE_CONFIG), DenseBatch.from_arrays(
            x, np.array([[1.0, 0.0]]), np.array([[offset, 0.0]]), np.array([[1.0, 0.0]]),
            device=CPU)), w0[None, :], _NEARLINE_CONFIG, 0.0, None, device=CPU)
    np.testing.assert_allclose(engine.re_tables(0)[bucket][1][pos].numpy(),
                               direct.w[0].numpy(), atol=1e-6)
    assert torch.equal(engine.re_tables(1)[bucket][1], other_before)


def test_serving_report_section_roundtrip():
    """tests/test_serving_sharded.py::test_serving_report_section_roundtrip
    through the port's RunReport, and the section against the JAX
    package's report of the same snapshot."""
    from photon_ml_tpu.telemetry.report import RunReport as JRunReport
    from photon_ml_tpu_torch.telemetry.report import RunReport

    snapshot = {
        "counters": {"serving.requests": 2242, "serving.scored_rows": 8968, "serving.shed": 3,
                     "serving.model_swaps": 2, "serving.nearline.applies": 3,
                     "serving.nearline.applied_rows": 96, "serving.unseen_entities": 1},
        "gauges": {},
        "histograms": {
            "serving.total_ms": {"count": 2242, "mean": 33.5, "p50": 33.4, "p99": 35.1},
            "serving.batch_size": {"count": 600, "mean": 14.8},
            "serving.nearline.update_lag_ms": {"count": 96, "mean": 9.0, "p99": 11.4},
        },
    }
    report = RunReport(snapshot=snapshot, spans=[], sources={})
    doc = report.to_json()
    assert doc["serving"]["requests"] == 2242
    assert doc["serving"]["nearline_lag_p99_ms"] == 11.4
    md = report.to_markdown()
    assert "## Serving" in md
    assert "p99 35.1 ms" in md
    assert "3 nearline apply(ies) covering 96 entity row(s)" in md
    assert "p99 event->applied 11.4 ms" in md
    assert "3 request(s) shed" in md
    j_report = JRunReport(snapshot=snapshot, spans=[], sources={})
    assert doc["serving"] == j_report.to_json()["serving"]
    assert md == j_report.to_markdown()
