"""The port's freshness conductor (``photon_ml_tpu_torch.pipeline``, ``cli
pipeline``) against the JAX package's, case for case with
tests/test_pipeline.py, on one Avro world (JAX on the CPU, the port with
``device="cpu"``):

- the three-cycle supervised run in both packages over the same deltas:
  v1 -> v2 -> v3 chained by ``lineage.base_version``, the idle cycle, the
  escalation re-based under the workdir, the hot swap, the restarted
  conductor seeding its cursor and idling; each published model within the
  refresh's tolerance of the JAX conductor's (tests/test_torch_incremental.py:
  rtol/atol 2e-3), the lineage digests equal;
- the reconciliation (retrain-wins-touched) bit for bit, as the reference's:
  the contested user's row equals a direct ``fit_incremental``'s, untouched
  users keep their base rows, the record round-trips through ``/healthz``;
- the status document and the summary, ``request_stop``;
- the seams firing typed, and the pipeline crash row in tier-1 under a
  budget (the full matrix is marked slow, as the reference marks it);
- the gate across growing data (ROADMAP Queue 3 item 15): both packages
  quarantine a second delta's candidate at 40,000 rows (marked slow: its
  two base fits and four cycles take ~2 minutes).

The reference's RunReport "Pipeline" section is ROADMAP.md Queue 1 item
14d: its counters, gauge and histogram are asserted in
``telemetry.snapshot()`` instead.
"""

from __future__ import annotations

import glob
import json
import os
import warnings

import numpy as np
import pytest
import torch

from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game.checkpoint import CheckpointSpec as JCheckpointSpec
from photon_ml_tpu.pipeline import FreshnessPipeline as JPipeline
from photon_ml_tpu.pipeline import PipelineSpec as JSpec
from photon_ml_tpu_torch import faults, incremental, telemetry
from photon_ml_tpu_torch.faults import (
    FaultPlan,
    FaultRule,
    InjectedFault,
    clear_plan,
    install_plan,
)
from photon_ml_tpu_torch.game import GameEstimator
from photon_ml_tpu_torch.game.checkpoint import CheckpointSpec
from photon_ml_tpu_torch.pipeline import RECONCILE_RULE, FreshnessPipeline, PipelineSpec

FIT_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_torch_incremental.py's refresh tolerance

_D = 6
_N_USERS = 10  # base users "0".."9"; deltas may add the new user "10"


@pytest.fixture(autouse=True)
def _clean_plan():
    clear_plan()
    yield
    clear_plan()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_pipeline.py's world: one Avro base, a base fit with a
    checkpoint a step in each package, and a delta writer."""
    from photon_ml_tpu.cli.train import read_input as j_read
    from photon_ml_tpu.config import parse_game_config as j_parse
    from photon_ml_tpu_torch.cli.train import read_input
    from photon_ml_tpu_torch.config import parse_game_config
    from photon_ml_tpu_torch.data.avro import TRAINING_EXAMPLE_AVRO, write_avro

    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(11)
    n_base = 400
    w = rng.normal(size=_D)
    u_eff = rng.normal(size=_N_USERS + 2)

    def rows(users, seed):
        r = np.random.default_rng(seed)
        X = r.normal(size=(len(users), _D))
        logits = X @ w + u_eff[users]
        y = (r.random(len(users)) < 1 / (1 + np.exp(-logits))).astype(float)
        return X, y

    def recs(X, y, users):
        for i in range(len(users)):
            yield {"uid": str(i), "label": float(y[i]),
                   "features": [{"name": f"c{j}", "term": "", "value": float(X[i, j])}
                                for j in range(_D)],
                   "metadataMap": {"userId": str(users[i])}, "weight": None, "offset": None}

    users = np.concatenate([np.arange(_N_USERS), rng.integers(0, _N_USERS, n_base - _N_USERS)])
    Xb, yb = rows(users, 101)
    train_path = str(tmp / "train.avro")
    write_avro(train_path, TRAINING_EXAMPLE_AVRO, recs(Xb, yb, users))

    def write_delta(path, user_ids, seed):
        du = np.asarray(user_ids)
        Xd, yd = rows(du, seed)
        write_avro(path, TRAINING_EXAMPLE_AVRO, recs(Xd, yd, du))

    config = {
        "task": "logistic",
        "input": {"format": "avro", "paths": [train_path],
                  "feature_shards": {"global": ["features"]}, "id_columns": ["userId"]},
        "coordinates": {
            "fixed": {"type": "fixed_effect", "shard_name": "global",
                      "optimizer": {"regularization": "l2", "regularization_weight": 0.1}},
            "perUser": {"type": "random_effect", "shard_name": "global", "id_name": "userId",
                        "optimizer": {"regularization": "l2", "regularization_weight": 1.0}},
        },
        "num_iterations": 1,
    }
    ckpt = str(tmp / "base-ckpt")
    data, imaps = read_input(config["input"], device="cpu")
    GameEstimator(parse_game_config(config)).fit(
        data, checkpoint_spec=CheckpointSpec(directory=ckpt, resume=False), device="cpu")
    j_ckpt = str(tmp / "j-base-ckpt")
    j_data, _ = j_read(config["input"])
    JEstimator(j_parse(config)).fit(
        j_data, checkpoint_spec=JCheckpointSpec(directory=j_ckpt, resume=False))
    telemetry.reset()
    return dict(tmp=tmp, config=config, ckpt=ckpt, j_ckpt=j_ckpt, train_path=train_path,
                write_delta=write_delta, imaps=imaps)


def _entity_coeffs(model, coord="perUser"):
    """entity value -> {global feature id: coefficient}, for either
    package's model (equal dicts are equal rows bit for bit)."""
    re = model.models[coord]
    out = {}
    for bm in re.buckets:
        P = (bm.projection.cpu().numpy() if isinstance(bm.projection, torch.Tensor)
             else np.asarray(bm.projection))
        W = (bm.coefficients.cpu().numpy() if isinstance(bm.coefficients, torch.Tensor)
             else np.asarray(bm.coefficients))
        for e, code in enumerate(np.asarray(bm.entity_codes)):
            out[re.vocab[code]] = {int(g): float(W[e, k]) for k, g in enumerate(P[e])}
    return out


def _close_models(t_dir, j_dir):
    """A version the port published against the JAX package's: the fixed
    effect and every user's row within the refresh's tolerance."""
    from photon_ml_tpu.data.model_store import load_game_model as j_load
    from photon_ml_tpu_torch.data.model_store import load_game_model

    t, j = load_game_model(t_dir, device="cpu"), j_load(j_dir)
    np.testing.assert_allclose(t.models["fixed"].coefficients.numpy(),
                               np.asarray(j.models["fixed"].coefficients), **FIT_TOL)
    t_map, j_map = _entity_coeffs(t), _entity_coeffs(j)
    assert t_map.keys() == j_map.keys()
    for val in t_map:
        assert t_map[val].keys() == j_map[val].keys(), val
        np.testing.assert_allclose([t_map[val][g] for g in sorted(t_map[val])],
                                   [j_map[val][g] for g in sorted(j_map[val])],
                                   err_msg=str(val), **FIT_TOL)


def _spec(world, tmp_path, delta_dir, **kw):
    base = dict(config=world["config"], delta_dir=str(delta_dir), base_dir=world["ckpt"],
                registry_dir=str(tmp_path / "registry"), workdir=str(tmp_path / "work"),
                interval_s=0.01,
                # the fraction trigger off: the tests escalate by the count
                escalate_touched_fraction=1.1, device="cpu")
    base.update(kw)
    return PipelineSpec(**base)


def _j_spec(world, tmp_path, delta_dir, **kw):
    base = dict(config=world["config"], delta_dir=str(delta_dir), base_dir=world["j_ckpt"],
                registry_dir=str(tmp_path / "j-registry"), workdir=str(tmp_path / "j-work"),
                interval_s=0.01, escalate_touched_fraction=1.1)
    base.update(kw)
    return JSpec(**base)


# ---------------------------------------------------------------------------
# the three-cycle supervised run
# ---------------------------------------------------------------------------


def test_three_cycle_supervised_run(world, tmp_path):
    """Three non-idle cycles publish v1 -> v2 -> v3, an unchanged digest
    idles, the third trips escalate_after_cycles=3 into a full retrain
    re-based under the workdir, the registry hot-swaps, a restarted
    conductor seeds its cursor and idles; the JAX conductor runs the same
    cycles, and every published model agrees within the refresh's
    tolerance."""
    from photon_ml_tpu_torch.data.model_store import load_game_model_metadata

    telemetry.reset()
    delta_dir = tmp_path / "deltas"
    delta_dir.mkdir()
    spec = _spec(world, tmp_path, delta_dir, escalate_after_cycles=3, serve=True)
    reg = spec.registry_dir
    pipe = FreshnessPipeline(spec)
    jpipe = JPipeline(_j_spec(world, tmp_path, delta_dir, escalate_after_cycles=3, serve=False))
    entries = []
    try:
        world["write_delta"](str(delta_dir / "delta-0001.avro"), [1, 2, _N_USERS] * 8, 201)
        e1, j1 = pipe.run_cycle(), jpipe.run_cycle()
        assert e1["idle"] is False
        assert e1["published_version"] == "v-00000001" == j1["published_version"]
        assert e1["escalated"] is False
        assert e1["staleness_p99_s"] >= 0.0
        assert e1["reconciliation"]["rule"] == RECONCILE_RULE
        assert e1["reconciliation"]["nearline_version"] is None
        assert e1["reconciliation"] == j1["reconciliation"]

        # an unchanged digest idles: no read, no fit, no publish
        e2, j2 = pipe.run_cycle(), jpipe.run_cycle()
        assert e2["idle"] is True and e2["published_version"] is None
        assert j2["idle"] is True

        world["write_delta"](str(delta_dir / "delta-0002.avro"), [3, 4] * 10, 202)
        e3, j3 = pipe.run_cycle(), jpipe.run_cycle()
        assert e3["published_version"] == "v-00000002" == j3["published_version"]
        assert e3["escalated"] is False is j3["escalated"]

        world["write_delta"](str(delta_dir / "delta-0003.avro"), [5] * 12, 203)
        e4, j4 = pipe.run_cycle(), jpipe.run_cycle()
        assert e4["published_version"] == "v-00000003" == j4["published_version"]
        assert e4["escalated"] is True is j4["escalated"]  # the 3rd non-idle cycle
        entries = [e1, e2, e3, e4]

        names = ("v-00000001", "v-00000002", "v-00000003")
        metas = {n: load_game_model_metadata(os.path.join(reg, n)) for n in names}
        lin = {n: m["extra"]["lineage"] for n, m in metas.items()}
        assert "base_version" not in lin["v-00000001"]  # an empty registry
        assert lin["v-00000002"]["base_version"] == "v-00000001"
        assert lin["v-00000003"]["base_version"] == "v-00000002"
        j_reg = str(tmp_path / "j-registry")
        for n in names:
            assert lin[n]["delta_digest"]
            assert lin[n]["reconciliation"]["rule"] == RECONCILE_RULE
            with open(os.path.join(j_reg, n, "model-metadata.json")) as fh:
                j_lin = json.load(fh)["extra"]["lineage"]
            assert lin[n]["delta_digest"] == j_lin["delta_digest"], n
            _close_models(os.path.join(reg, n), os.path.join(j_reg, n))
        # the recorded digest is the cursor: the whole glob, so a restart
        # sees nothing new
        paths = sorted(glob.glob(str(delta_dir / "*.avro")))
        assert lin["v-00000003"]["delta_digest"] == incremental.delta_digest(paths)
        assert metas["v-00000003"]["extra"]["pipeline"]["escalated"] is True
        assert metas["v-00000003"]["extra"]["pipeline"]["cycle"] == 4
        assert metas["v-00000002"]["extra"]["pipeline"]["escalated"] is False

        # the escalation re-based the conductor under its workdir
        s = pipe.summary()
        assert s["base_dir"].startswith(str(tmp_path / "work"))
        assert "base-gen-" in s["base_dir"]
        assert s["cycles"] == 4 and s["idle_cycles"] == 1
        assert s["published_versions"] == list(names)
        assert s["escalations"] == 1
        assert s["event_to_served_staleness_p99_s"] >= 0.0
        assert pipe._registry is not None
        assert pipe._registry.current_version == "v-00000003"

        # the counters, gauge and histogram the run report would render
        snap = telemetry.snapshot()
        c = snap["counters"]
        assert c["pipeline.cycles"] == 4 and c["pipeline.idle_cycles"] == 1
        assert c["pipeline.publishes"] == 3 and c["pipeline.escalations"] == 1
        # one sample per delta file of each publishing cycle: 1 + 2 + 3
        assert snap["histograms"]["pipeline.staleness_s"]["count"] == 6
        assert snap["gauges"]["pipeline.event_to_served_staleness_p99_s"] >= 0.0
    finally:
        pipe._close("completed")
        jpipe._close("completed")
    assert entries[0]["lanes_solved"] > 0 and "full_retrain_s" in entries[3]

    # crash-restart idempotence: a new conductor over the same directories
    # seeds its cursor from the newest lineage and idles
    pipe2 = FreshnessPipeline(spec)
    try:
        assert pipe2.run_cycle()["idle"] is True
    finally:
        pipe2._close("completed")


# ---------------------------------------------------------------------------
# nearline-vs-delta reconciliation, bit for bit
# ---------------------------------------------------------------------------


def test_reconciliation_retrain_wins_touched_bit_exact(world, tmp_path):
    """User "1" is nearline-updated (published as v2) and in the next
    delta's touched set: the conductor's v3 carries the masked re-solve's
    row for "1" bit for bit (a direct fit_incremental over the same
    inputs), the nearline row is superseded and stays auditable, untouched
    users keep their base rows bit for bit, and the record round-trips
    through /healthz."""
    from photon_ml_tpu_torch.cli.train import read_input
    from photon_ml_tpu_torch.config import parse_game_config
    from photon_ml_tpu_torch.data.model_store import load_game_model, load_game_model_metadata
    from photon_ml_tpu_torch.serving.engine import ScoringEngine
    from photon_ml_tpu_torch.serving.nearline import NearlineUpdater
    from photon_ml_tpu_torch.serving.registry import publish_version
    from photon_ml_tpu_torch.serving.server import ScoringService

    reg = str(tmp_path / "registry")
    ws = incremental.load_warm_start(world["ckpt"], device="cpu")
    base_map = _entity_coeffs(ws.model)

    publish_version(reg, ws.model, world["imaps"])  # v1: the base as served
    v1 = os.path.join(reg, "v-00000001")
    engine = ScoringEngine.load(v1, max_batch=8, device="cpu").warmup()
    updater = NearlineUpdater(engine, id_name="userId", rows_per_solve=2, publish_dir=reg,
                              index_maps=world["imaps"])
    target = "1"
    updater.submit([
        {"ids": {"userId": target}, "features": {"global": [[0, 1.0], [2, -0.5]]},
         "label": 1.0, "offset": 0.0},
        {"ids": {"userId": target}, "features": {"global": [[1, 0.7], [3, 0.4]]},
         "label": 0.0, "offset": 0.0},
    ])
    flushed = updater.flush()
    assert flushed["applies"] >= 1
    seq = engine.nearline_seq
    assert seq >= 1
    v2 = updater.publish()
    assert os.path.basename(v2) == "v-00000002"
    v2_map = _entity_coeffs(load_game_model(v2, device="cpu"))
    assert v2_map[target] != base_map[target]  # nearline moved the row

    delta_dir = tmp_path / "deltas"
    delta_dir.mkdir()
    delta_path = str(delta_dir / "delta-0001.avro")
    world["write_delta"](delta_path, [1, 5] * 12, 401)

    pipe = FreshnessPipeline(_spec(world, tmp_path, delta_dir, serve=True))
    try:
        entry = pipe.run_cycle()
    finally:
        pipe._close("completed")
    assert entry["published_version"] == "v-00000003"
    dec = entry["reconciliation"]
    assert dec["rule"] == RECONCILE_RULE
    assert dec["nearline_version"] == "v-00000002"
    assert dec["nearline_seq"] == seq
    assert dec["nearline_base_version"] == "v-00000001"
    assert dec["touched_count"] == 2

    # the winner's row, bit for bit: a direct masked re-solve over the same
    # base checkpoint and delta
    cfg = world["config"]
    delta_data, _ = read_input({**cfg["input"], "paths": [delta_path]}, device="cpu")
    scan = incremental.scan_delta(delta_data, {"userId": ws.model.models["perUser"].vocab},
                                  paths=[delta_path])
    comb, _ = read_input({**cfg["input"], "paths": [world["train_path"], delta_path]},
                         device="cpu")
    ref = GameEstimator(parse_game_config(cfg)).fit_incremental(comb, ws, delta=scan,
                                                                device="cpu")
    ref_map = _entity_coeffs(ref.model)
    v3_path = os.path.join(reg, "v-00000003")
    v3_map = _entity_coeffs(load_game_model(v3_path, device="cpu"))
    assert v3_map[target] == ref_map[target]  # the retrain won, exactly
    assert v3_map[target] != v2_map[target]  # the nearline row superseded
    untouched = [v for v in base_map if v not in (target, "5")]
    assert untouched
    for val in untouched:
        assert v3_map[val] == base_map[val], val

    meta2 = load_game_model_metadata(v2)
    assert meta2["extra"]["nearline_seq"] == seq
    assert meta2["extra"]["nearline_base_version"] == "v-00000001"
    lin3 = load_game_model_metadata(v3_path)["extra"]["lineage"]
    assert lin3["reconciliation"] == dec
    assert lin3["base_version"] == "v-00000002"

    health = ScoringService(ScoringEngine.load(v3_path, device="cpu")).health()
    assert health["model_version"] == "v-00000003"
    assert health["lineage"]["reconciliation"]["nearline_version"] == "v-00000002"
    assert health["lineage"]["base_version"] == "v-00000002"


# ---------------------------------------------------------------------------
# status and the daemon loop
# ---------------------------------------------------------------------------


def test_run_loop_writes_statusz_and_summary(world, tmp_path):
    """run() under max_cycles: the conductor's 1-member fleet status carries
    the cycle counters and lands outcome=completed on close."""
    delta_dir = tmp_path / "deltas"
    delta_dir.mkdir()
    world["write_delta"](str(delta_dir / "delta-0001.avro"), [1, 2] * 9, 301)
    status_file = str(tmp_path / "status.json")
    spec = _spec(world, tmp_path, delta_dir, max_cycles=2, serve=False, status_file=status_file)
    summary = FreshnessPipeline(spec).run()
    assert summary["cycles"] == 2 and summary["idle_cycles"] == 1
    assert summary["published_versions"] == ["v-00000001"]
    assert summary["interrupted"] is False
    assert summary["event_to_served_staleness_p99_s"] >= 0.0

    with open(status_file, encoding="utf-8") as fh:
        doc = json.load(fh)
    assert doc["type"] == "fleet_status"
    assert doc["outcome"] == "completed"
    assert doc["generation"] == 2  # the cycle count
    member = doc["members"]["0"]
    assert member["pipeline"]["publishes"] == 1
    assert member["pipeline"]["idle_cycles"] == 1
    assert member["pipeline"]["escalations"] == 0
    assert member["pipeline"]["staleness_p99_s"] >= 0.0
    assert member["pipeline"]["served_version"] is None  # serve=False
    assert member["pipeline"]["base_dir"] == world["ckpt"]


def test_request_stop_interrupts_cleanly(world, tmp_path):
    """A stop request before the loop starts: the interrupted outcome and
    zero cycles (SIGTERM's path without the signal)."""
    delta_dir = tmp_path / "deltas"
    delta_dir.mkdir()
    pipe = FreshnessPipeline(_spec(world, tmp_path, delta_dir, serve=False))
    pipe.request_stop()
    summary = pipe.run()
    assert summary["interrupted"] is True
    assert summary["cycles"] == 0 and summary["published_versions"] == []


def test_pipeline_spec_runs_on_the_card_by_default(world, tmp_path):
    """Without ``device`` the conductor resolves cuda, which a machine
    without a card refuses at construction."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError):
        FreshnessPipeline(_spec(world, tmp_path, tmp_path, device=None))


# ---------------------------------------------------------------------------
# fault seams: typed in process; hard kills through tools/chaos.py
# ---------------------------------------------------------------------------


def test_pipeline_points_enumeration_is_stable():
    """The seams the port's chaos harness matrixes over, and the JAX
    harness's list."""
    import photon_ml_tpu_torch.pipeline  # noqa: F401 (registers the points)
    from photon_ml_tpu_torch.tools import chaos
    from tools import chaos as j_chaos

    assert list(chaos.PIPELINE_POINTS) == ["pipeline.cycle_start", "pipeline.reconcile",
                                           "pipeline.escalate"]
    assert list(chaos.PIPELINE_POINTS) == list(j_chaos.PIPELINE_POINTS)
    assert set(chaos.PIPELINE_POINTS) <= set(faults.registered_points())


def test_pipeline_seams_fire_typed(world, tmp_path):
    """Each pipeline.* seam raises the typed InjectedFault from inside
    run_cycle, and a cycle stopped at any of them publishes nothing."""
    delta_dir = tmp_path / "deltas"
    delta_dir.mkdir()
    world["write_delta"](str(delta_dir / "delta-0001.avro"), [1, 2] * 9, 501)
    rows = (("pipeline.cycle_start", {}), ("pipeline.reconcile", {}),
            # the escalate seam fires only when escalation trips
            ("pipeline.escalate", {"escalate_after_cycles": 1}))
    for point, kw in rows:
        sub = tmp_path / point.replace(".", "_")
        sub.mkdir()
        spec = _spec(world, sub, delta_dir, serve=False, **kw)
        pipe = FreshnessPipeline(spec)
        install_plan(FaultPlan([FaultRule(point, action="raise")]))
        try:
            with pytest.raises(InjectedFault, match=point):
                pipe.run_cycle()
        finally:
            clear_plan()
            pipe._close("failed")
        reg = spec.registry_dir
        assert not os.path.isdir(reg) or not any(
            n.startswith("v-") for n in os.listdir(reg)), point


@pytest.mark.chaos
def test_pipeline_crash_row_tier1(tmp_path):
    """The tier-1 row of the pipeline crash matrix: the ``cli pipeline``
    daemon hard-killed (113) at the top of a cycle leaves the base
    byte-identical and the registry partial-free, and the unarmed rerun
    publishes a lineage-linked version."""
    from photon_ml_tpu_torch.tools import chaos

    budget = float(os.environ.get("PHOTON_CHAOS_BUDGET_S", "300"))
    report = chaos.run_pipeline_matrix(str(tmp_path), points=["pipeline.cycle_start"],
                                       budget_s=budget, device="cpu")
    if report["skipped"]:
        warnings.warn("chaos budget truncated the pipeline matrix; uncovered this run: "
                      f"{report['skipped']} (full matrix: python -m "
                      "photon_ml_tpu_torch.tools.chaos --pipeline)", stacklevel=1)
        return
    assert report["ok"], json.dumps(report, indent=2)
    entry = report["results"]["pipeline.cycle_start"]
    assert entry["armed_rc"] == faults.DEFAULT_EXIT_CODE
    assert entry["published_versions"]
    assert entry["registry_after_resume"]


@pytest.mark.chaos
@pytest.mark.slow
def test_pipeline_crash_matrix_every_seam_recovers(tmp_path):
    """The whole pipeline crash matrix: every pipeline.* seam."""
    from photon_ml_tpu_torch.tools import chaos

    budget = float(os.environ.get("PHOTON_CHAOS_BUDGET_S", "600"))
    report = chaos.run_pipeline_matrix(str(tmp_path), budget_s=budget, device="cpu")
    assert report["ok"], json.dumps(report, indent=2)
    covered = [p for p, e in report["results"].items() if e.get("passed")]
    assert covered, "the budget covered no pipeline point at all"
    for entry in report["results"].values():
        assert entry["armed_rc"] == faults.DEFAULT_EXIT_CODE
        assert entry["published_versions"]
    if report["skipped"]:
        warnings.warn("chaos budget truncated the pipeline matrix; uncovered this run: "
                      f"{report['skipped']}", stacklevel=1)


# ---------------------------------------------------------------------------
# the gate across growing data (ROADMAP Queue 3 item 15)
# ---------------------------------------------------------------------------


def _planted_world(tmp, n_rows=40_000, n_users=2_000, n_features=200, nnz=20, k=10):
    """bench_game.py's generator (a sparse fixed effect, 10 dense per-user
    features, labels from a planted logistic model) as one Avro file, and a
    writer of deltas from the same planted model over 20% of the users."""
    from photon_ml_tpu_torch.data.avro import write_training_examples_fast

    rng = np.random.default_rng(0)
    cols = rng.integers(0, n_features, size=n_rows * nnz)
    vals = rng.normal(size=n_rows * nnz)
    w_true = rng.normal(size=n_features) * 0.5
    users = rng.integers(0, n_users, size=n_rows)
    xu = rng.normal(size=(n_rows, k))
    wu_true = rng.normal(size=(n_users, k)) * 0.5
    names = [f"f{j}" for j in range(n_features)] + [f"u{j}" for j in range(k)]
    vocab = [str(u) for u in range(n_users)]

    def write(path, cols, vals, users, xu, y):
        n = len(users)
        bags = {"global": (np.arange(n + 1, dtype=np.int64) * nnz, cols, vals),
                "user": (np.arange(n + 1, dtype=np.int64) * k,
                         np.tile(np.arange(k) + n_features, n), xu.ravel())}
        write_training_examples_fast(path, y, bags, names, {"userId": (users, vocab)})

    def labels(cols, vals, users, xu, r):
        z = (vals * w_true[cols]).reshape(len(users), nnz).sum(1)
        z += np.einsum("ij,ij->i", xu, wu_true[users])
        return (r.random(len(users)) < 1 / (1 + np.exp(-z))).astype(np.float64)

    base = str(tmp / "base.avro")
    write(base, cols, vals, users, xu, labels(cols, vals, users, xu, rng))

    def write_delta(path, seed):
        r = np.random.default_rng(seed)
        touched = r.choice(n_users, size=n_users // 5, replace=False)
        n = n_rows // 20
        du = touched[r.integers(0, len(touched), n)]
        dc, dv = r.integers(0, n_features, size=n * nnz), r.normal(size=n * nnz)
        dx = r.normal(size=(n, k))
        write(path, dc, dv, du, dx, labels(dc, dv, du, dx, r))

    return base, write_delta


@pytest.mark.slow
def test_gate_quarantines_a_grown_data_candidate_in_both_packages(tmp_path):
    """Each cycle's candidate is scored on that cycle's combined input and
    held to the champion's bootstrap CI on the champion's own, smaller one:
    with ~20 rows a user, a second delta lowers the in-sample AUC below v1's
    CI and both packages quarantine it (the reference's rule, which the port
    keeps; ROADMAP Queue 3 item 15)."""
    from photon_ml_tpu.cli.train import read_input as j_read
    from photon_ml_tpu.config import parse_game_config as j_parse
    from photon_ml_tpu_torch.cli.train import read_input
    from photon_ml_tpu_torch.config import parse_game_config

    base, write_delta = _planted_world(tmp_path)
    lbfgs = {"type": "lbfgs", "max_iterations": 20, "tolerance": 0.0, "regularization": "l2",
             "regularization_weight": 1.0}
    config = {"task": "logistic", "num_iterations": 2, "input": {
        "format": "avro", "paths": [base], "add_intercept": False,
        "feature_shards": {"global": ["global"], "user": ["user"]}, "id_columns": ["userId"]},
        "coordinates": {
            "fixed": {"type": "fixed_effect", "shard_name": "global", "optimizer": lbfgs},
            "per-user": {"type": "random_effect", "shard_name": "user", "id_name": "userId",
                         "optimizer": {**lbfgs, "type": "newton", "tolerance": 1e-7}}}}
    data, _ = read_input(config["input"], device="cpu")
    GameEstimator(parse_game_config(config)).fit(
        data, checkpoint_spec=CheckpointSpec(directory=str(tmp_path / "t-ckpt"), resume=False),
        device="cpu")
    j_data, _ = j_read(config["input"])
    JEstimator(j_parse(config)).fit(
        j_data, checkpoint_spec=JCheckpointSpec(directory=str(tmp_path / "j-ckpt"), resume=False))
    delta_dir = tmp_path / "deltas"
    delta_dir.mkdir()
    kw = dict(config=config, delta_dir=str(delta_dir), interval_s=0.01,
              escalate_touched_fraction=1.1, bootstrap_samples=16)
    pipe = FreshnessPipeline(PipelineSpec(**kw, base_dir=str(tmp_path / "t-ckpt"),
                                          registry_dir=str(tmp_path / "t-reg"),
                                          workdir=str(tmp_path / "t-work"), device="cpu"))
    jpipe = JPipeline(JSpec(**kw, base_dir=str(tmp_path / "j-ckpt"),
                            registry_dir=str(tmp_path / "j-reg"),
                            workdir=str(tmp_path / "j-work")))
    try:
        entries = []
        for i, seed in enumerate((1016, 1019)):
            write_delta(str(delta_dir / f"part-{i}.avro"), seed)
            entries.append((pipe.run_cycle(), jpipe.run_cycle()))
    finally:
        pipe._close("completed")
        jpipe._close("completed")
    (t1, j1), (t2, j2) = entries
    assert t1["published_version"] == "v-00000001" == j1["published_version"]
    for e in (t2, j2):
        gate = e["quality_gate"]
        assert e["published_version"] is None
        assert e["quarantined_version"] == "quarantined-v-00000002"
        assert gate["decision"] == "quarantined" and gate["champion_version"] == "v-00000001"
        assert gate["candidate"]["auc"] < gate["champion"]["auc_ci_low"]
    print("gate across growing data:", json.dumps({
        pkg: {"candidate_auc": e["quality_gate"]["candidate"]["auc"],
              "champion_auc": e["quality_gate"]["champion"]["auc"],
              "champion_ci_low": e["quality_gate"]["champion"]["auc_ci_low"]}
        for pkg, e in (("port", t2), ("jax", j2))}))
