"""The port's quality layer (``photon_ml_tpu_torch.quality``) against the JAX
package's, case for case with tests/test_quality.py: the weighted AUC and
its hand cases, ``QualityStats``' JSON, the gate's decision matrix (each
decision and reason the JAX package's), ``game_quality_stats`` on the same
planted model and rows (AUC and its bootstrap CI within 1e-6 of the JAX
package's, the same H-L p-value band), ``bootstrap_re_weights`` array for
array, the drift sketches (ring eviction, PSI, calibration gaps, the
snapshot provider and its ``quality.drift_flush`` seam), the engine feeding
the drift sketch, and the gated ``publish_version`` (the
``quality.publish_gate`` seam, quarantine, lineage round trip, override).

The incremental refresh's two cases: the masked-lane bootstrap (touched
lanes gathered out of a full draw give the full bootstrap's summaries on
those rows, and the JAX package's within atol 1e-3, the bootstrap tests'
tolerance) and ``cli refresh`` through the gate (a clean delta published
with error bars, a label-shuffled one quarantined, a healthy challenger
published; each decision the JAX package's on the same files), and the
freshness conductor's cycles through the gate
(``test_conductor_cycle_quarantine_and_quality_report``, in both packages;
its RunReport "Quality" rendering is ROADMAP Queue 1 item 14d, so the
counters it reads are asserted instead).
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.diagnostics.bootstrap import bootstrap_re_weights as j_boot_weights
from photon_ml_tpu.game.models import FixedEffectModel as JFE
from photon_ml_tpu.game.models import GameModel as JGame
from photon_ml_tpu.quality import decide_gate as j_decide_gate
from photon_ml_tpu.quality import game_quality_stats as j_quality_stats
from photon_ml_tpu.quality import QualityStats as JStats
from photon_ml_tpu.quality import weighted_auc as j_weighted_auc
from photon_ml_tpu.testing import generate_game_dataset
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.faults import (
    FaultPlan,
    FaultRule,
    InjectedFault,
    clear_plan,
    install_plan,
)
from photon_ml_tpu_torch.game import FeatureShard, build_game_dataset
from photon_ml_tpu_torch.game.models import FixedEffectModel, GameModel
from photon_ml_tpu_torch.quality import (
    GateDecision,
    QualityGateRefused,
    QualityStats,
    decide_gate,
    drift,
    game_quality_stats,
    weighted_auc,
)
from photon_ml_tpu_torch.serving.registry import (
    champion_quality,
    publish_version,
    scan_versions,
)

_D = 5  # fixed-effect dim shared by the in-process worlds


@pytest.fixture(autouse=True)
def _port_telemetry():
    telemetry.reset()
    drift.reset()
    yield
    clear_plan()
    drift.reset()
    telemetry.reset()


# ---------------------------------------------------------------------------
# weighted AUC + stats plumbing
# ---------------------------------------------------------------------------


def _both_auc(s, y, w):
    got, want = weighted_auc(s, y, w), j_weighted_auc(s, y, w)
    assert (math.isnan(got) and math.isnan(want)) or got == want
    return got


def test_weighted_auc_hand_cases():
    y = np.array([0.0, 0.0, 1.0, 1.0])
    w = np.ones(4)
    assert _both_auc(np.array([0.1, 0.2, 0.8, 0.9]), y, w) == 1.0
    assert _both_auc(np.array([0.9, 0.8, 0.2, 0.1]), y, w) == 0.0
    assert _both_auc(np.zeros(4), y, w) == 0.5
    assert _both_auc(np.array([0.5, 0.9, 0.5, 0.9]), y, w) == pytest.approx(2.0 / 4.0)
    assert math.isnan(_both_auc(np.array([0.1, 0.9]), np.ones(2), np.ones(2)))
    assert math.isnan(_both_auc(np.array([0.1, 0.9]), y[:2], np.array([1.0, 0.0])))


def test_weighted_auc_weights_matter():
    s = np.array([0.2, 0.7, 0.5, 0.9])
    y = np.array([0.0, 0.0, 1.0, 1.0])
    assert _both_auc(s, y, np.ones(4)) == pytest.approx(3 / 4)
    assert _both_auc(s, y, np.array([1.0, 3.0, 1.0, 1.0])) == pytest.approx(5 / 8)


def test_quality_stats_json_roundtrip():
    stats = QualityStats(auc=0.8, auc_ci_low=0.75, auc_ci_high=0.85, rows=100,
                         bootstrap_samples=16)
    doc = stats.to_json()
    assert doc == JStats(auc=0.8, auc_ci_low=0.75, auc_ci_high=0.85, rows=100,
                         bootstrap_samples=16).to_json()
    assert "hl_p_value" not in doc
    doc["gate"] = {"decision": "published"}
    doc["bootstrap"] = {"entities": 3}
    back = QualityStats.from_json(doc)
    assert back.auc == 0.8 and back.rows == 100
    assert math.isnan(QualityStats.from_json({}).auc)


def _stats(auc, lo, hi, hl_p=None, cls=QualityStats):
    return cls(auc=auc, auc_ci_low=lo, auc_ci_high=hi, rows=200, bootstrap_samples=8,
               hl_p_value=hl_p)


_NAN = float("nan")
_GATE_CASES = [
    # (candidate, champion, override, decision)
    ((0.10, 0.05, 0.15), (0.80, 0.75, 0.85, 0.4), True, "bypassed"),
    ((0.6, 0.5, 0.7), None, False, "no_champion"),
    ((0.70, 0.65, 0.74), (0.80, 0.75, 0.85, 0.4), False, "quarantined"),
    ((0.76, 0.72, 0.80), (0.80, 0.75, 0.85, 0.4), False, "published"),
    ((0.90, 0.86, 0.93), (0.80, 0.75, 0.85, 0.4), False, "published"),
    ((_NAN, _NAN, _NAN), (0.80, 0.75, 0.85, 0.4), False, "published"),
    ((0.81, 0.78, 0.84, 1e-9), (0.80, 0.75, 0.85, 0.4), False, "quarantined"),
    ((0.81, 0.78, 0.84, 1e-9), (0.80, 0.75, 0.85, 1e-9), False, "published"),
]


def test_decide_gate_matrix():
    """Each case's decision and reason are the JAX package's."""
    for cand, champ, override, want in _GATE_CASES:
        champ_json = None if champ is None else _stats(*champ).to_json()
        version = None if champ is None else "v-1"
        got = decide_gate(_stats(*cand), champ_json, version, override=override)
        ref = j_decide_gate(_stats(*cand, cls=JStats), champ_json, version, override=override)
        assert got.decision == want and got.to_json() == ref.to_json()
    d = decide_gate(_stats(0.70, 0.65, 0.74), _stats(0.80, 0.75, 0.85, 0.4).to_json(), "v-1")
    assert "below champion bootstrap CI" in d.reason and d.champion_version == "v-1"
    d = decide_gate(_stats(0.81, 0.78, 0.84, 1e-9), _stats(0.80, 0.75, 0.85, 0.4).to_json(),
                    "v-1")
    assert "Hosmer-Lemeshow" in d.reason
    assert GateDecision(**d.to_json()).decision == "quarantined"


# ---------------------------------------------------------------------------
# game_quality_stats on a planted model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_world():
    jdata, truth = generate_game_dataset(n_users=8, rows_per_user=12, fe_dim=_D, re_dim=3,
                                         seed=7)
    tdata = build_game_dataset(jdata.response, {"global": FeatureShard.from_dense(truth["Xg"])},
                               id_columns={"userId": truth["users"]}, device="cpu")
    jmodel = JGame(task="logistic", models={"fixed": JFE(
        coefficients=jnp.asarray(truth["w_global"], jnp.float32), shard_name="global")})
    tmodel = GameModel(task="logistic", models={"fixed": FixedEffectModel(
        coefficients=torch.tensor(truth["w_global"], dtype=torch.float32),
        shard_name="global")})
    return jdata, tdata, jmodel, tmodel, truth


def test_game_quality_stats_ci_and_calibration(eval_world):
    jdata, tdata, jmodel, tmodel, _ = eval_world
    stats = game_quality_stats(tmodel, tdata, num_samples=24, seed=3)
    ref = j_quality_stats(jmodel, jdata, num_samples=24, seed=3)
    assert stats.rows == tdata.num_rows and stats.bootstrap_samples == 24
    for field in ("auc", "auc_ci_low", "auc_ci_high"):
        assert getattr(stats, field) == pytest.approx(getattr(ref, field), abs=1e-6)
    assert stats.auc > 0.6
    assert stats.auc_ci_low <= stats.auc <= stats.auc_ci_high
    assert stats.auc_ci_low < stats.auc_ci_high
    assert stats.hl_chi_square is not None and 0.0 <= stats.hl_p_value <= 1.0
    assert stats.hl_p_value == pytest.approx(ref.hl_p_value, rel=1e-4)
    again = game_quality_stats(tmodel, tdata, num_samples=24, seed=3)
    assert (again.auc_ci_low, again.auc_ci_high) == (stats.auc_ci_low, stats.auc_ci_high)


def test_bootstrap_re_weights_deterministic_per_entity():
    from photon_ml_tpu_torch.diagnostics.bootstrap import bootstrap_re_weights

    base = np.ones((5, 6))
    base[3, 4:] = 0.0
    a = bootstrap_re_weights(8, base, seed=5)
    np.testing.assert_array_equal(a, j_boot_weights(8, base, seed=5))
    assert np.array_equal(a, bootstrap_re_weights(8, base, seed=5))
    assert a.shape == (8, 5, 6) and np.all(a[:, 3, 4:] == 0.0)
    assert np.array_equal(a.sum(axis=2)[:, 3], np.full(8, 4.0))
    assert np.all(a.sum(axis=2)[:, :3] == 6.0)
    assert not np.array_equal(a, bootstrap_re_weights(8, base, seed=6))


# ---------------------------------------------------------------------------
# drift telemetry
# ---------------------------------------------------------------------------


def test_drift_ring_eviction_bounded():
    for i in range(drift.MAX_VERSIONS + 3):
        drift.observe_scores(f"v-{i:08d}", np.full(4, 0.5))
    rows = drift.MONITOR.snapshot_rows()["versions"]
    assert len(rows) == drift.MAX_VERSIONS
    assert "v-00000000" not in rows and "v-00000002" not in rows
    assert f"v-{drift.MAX_VERSIONS + 2:08d}" in rows
    snap = telemetry.snapshot()["counters"]
    assert snap["quality.versions_evicted"] == 3
    assert snap["quality.scores_observed"] == 4 * (drift.MAX_VERSIONS + 3)


def test_drift_psi_flags_shifted_distribution():
    from photon_ml_tpu.quality import drift as j_drift

    rng = np.random.default_rng(0)
    draws = [("v-a", rng.uniform(0.2, 0.4, 200)), ("v-b", rng.uniform(0.2, 0.4, 120)),
             ("v-c", rng.uniform(0.6, 0.9, 120))]
    j_drift.reset()
    for v, s in draws:
        drift.observe_scores(v, s)
        j_drift.observe_scores(v, s)
    doc = drift.MONITOR.snapshot_rows()
    assert doc == j_drift.MONITOR.snapshot_rows()
    j_drift.reset()
    assert doc["baseline_version"] == "v-a"
    assert "psi_vs_baseline" not in doc["versions"]["v-a"]
    assert doc["versions"]["v-b"]["psi_vs_baseline"] < 0.1
    assert doc["versions"]["v-c"]["psi_vs_baseline"] > 0.25
    s = doc["versions"]["v-a"]["scores"]
    assert s["count"] == 200 and sum(s["histogram"]) == 200 and 0.2 <= s["mean"] <= 0.4


def test_drift_calibration_gap():
    rng = np.random.default_rng(1)
    p = rng.uniform(0.05, 0.95, 400)
    calibrated = (rng.random(400) < p).astype(np.float64)
    drift.observe_labeled("v-good", p, calibrated)
    drift.observe_labeled("v-bad", p, 1.0 - calibrated)
    doc = drift.MONITOR.snapshot_rows()["versions"]
    good, bad = doc["v-good"]["calibration"], doc["v-bad"]["calibration"]
    assert good["count"] == bad["count"] == 400
    assert good["max_gap"] < 0.25 and bad["max_gap"] > 0.5
    assert len(good["predicted_mean"]) == drift.NUM_BINS


def test_quality_snapshot_provider_and_drift_flush_seam():
    drift.observe_scores("v-seam", np.array([0.3, 0.7]))
    assert telemetry.snapshot()["quality"]["versions"]["v-seam"]["scores"]["count"] == 2
    install_plan(FaultPlan([FaultRule(point="quality.drift_flush", action="raise")]))
    try:
        broken = telemetry.snapshot()
        assert "quality" not in broken and "counters" in broken
    finally:
        clear_plan()
    assert "v-seam" in telemetry.snapshot()["quality"]["versions"]


def test_engine_score_rows_feeds_drift_sketch(eval_world):
    from photon_ml_tpu_torch.serving.engine import ScoringEngine

    _, _, _, tmodel, truth = eval_world
    engine = ScoringEngine(tmodel, max_batch=16, version="v-drift-e2e", device="cpu")
    Xg = np.asarray(truth["Xg"])
    rows = [{"features": {"global": [[j, float(Xg[i, j])] for j in range(_D)
                                     if Xg[i, j] != 0]}} for i in range(40)]
    scores = engine.score_rows(rows)
    sketch = drift.MONITOR.snapshot_rows()["versions"]["v-drift-e2e"]["scores"]
    assert sketch["count"] == 40
    assert sketch["mean"] == pytest.approx(float(np.mean(scores)), abs=1e-5)
    assert sketch["min"] >= 0.0 and sketch["max"] <= 1.0


# ---------------------------------------------------------------------------
# the gated registry publish
# ---------------------------------------------------------------------------


def _fe_model(scale=1.0):
    return GameModel(task="logistic", models={"fixed": FixedEffectModel(
        coefficients=torch.tensor(np.linspace(-0.5, 0.5, _D) * scale, dtype=torch.float32),
        shard_name="global")})


_FE_MAPS = {"global": [f"c{j}" for j in range(_D)]}


def test_publish_gate_seam_leaves_registry_untouched(tmp_path):
    reg = str(tmp_path / "registry")
    publish_version(reg, _fe_model(), _FE_MAPS, quality=_stats(0.80, 0.75, 0.85).to_json())
    before = sorted(os.listdir(reg))
    install_plan(FaultPlan([FaultRule(point="quality.publish_gate", action="raise")]))
    try:
        with pytest.raises(InjectedFault):
            publish_version(reg, _fe_model(0.1), _FE_MAPS,
                            quality=_stats(0.55, 0.50, 0.60).to_json())
    finally:
        clear_plan()
    assert sorted(os.listdir(reg)) == before
    install_plan(FaultPlan([FaultRule(point="quality.publish_gate", action="raise")]))
    try:
        publish_version(reg, _fe_model(), _FE_MAPS)
    finally:
        clear_plan()
    assert len(scan_versions(reg)) == 2


def test_publish_gate_quarantines_and_lineage_roundtrip(tmp_path):
    from photon_ml_tpu_torch.serving.engine import ScoringEngine
    from photon_ml_tpu_torch.serving.server import ScoringService

    reg = str(tmp_path / "registry")
    publish_version(reg, _fe_model(), _FE_MAPS, quality=_stats(0.80, 0.75, 0.85).to_json(),
                    lineage={"base_kind": "test"})
    champ_v, champ_q = champion_quality(reg)
    assert champ_v == "v-00000001" and champ_q["auc"] == pytest.approx(0.80)
    assert champ_q["gate"]["decision"] == "no_champion"
    with pytest.raises(QualityGateRefused) as exc_info:
        publish_version(reg, _fe_model(0.1), _FE_MAPS,
                        quality=_stats(0.55, 0.50, 0.60).to_json(),
                        lineage={"base_kind": "test"})
    exc = exc_info.value
    assert exc.decision.decision == "quarantined"
    assert exc.decision.champion_version == "v-00000001"
    qdir = exc.quarantine_path
    assert os.path.basename(qdir) == "quarantined-v-00000002"
    assert [v for _, v in scan_versions(reg)] == [os.path.join(reg, "v-00000001")]
    with open(os.path.join(qdir, "model-metadata.json")) as fh:
        qmeta = json.load(fh)
    assert qmeta["extra"]["quality"]["gate"]["decision"] == "quarantined"
    assert qmeta["extra"]["lineage"]["quality_gate"]["decision"] == "quarantined"
    path = publish_version(reg, _fe_model(1.1), _FE_MAPS,
                           quality=_stats(0.82, 0.78, 0.86).to_json(),
                           lineage={"base_kind": "test"})
    assert os.path.basename(path) == "v-00000002"
    engine = ScoringEngine.load(path, max_batch=8, device="cpu")
    gate = engine.lineage["quality_gate"]
    assert gate["decision"] == "published" and gate["champion_version"] == "v-00000001"
    assert gate["candidate"]["auc"] == pytest.approx(0.82)
    assert ScoringService(engine).health()["lineage"]["quality_gate"]["decision"] == "published"
    assert champion_quality(reg)[0] == "v-00000002"
    counters = telemetry.snapshot()["counters"]
    assert (counters["quality.gate_quarantined"], counters["quality.gate_published"],
            counters["quality.gate_no_champion"]) == (1, 1, 1)


def test_gate_override_records_bypass(tmp_path):
    reg = str(tmp_path / "registry")
    publish_version(reg, _fe_model(), _FE_MAPS, quality=_stats(0.80, 0.75, 0.85).to_json())
    path = publish_version(reg, _fe_model(0.1), _FE_MAPS,
                           quality=_stats(0.55, 0.50, 0.60).to_json(), gate_override=True)
    with open(os.path.join(path, "model-metadata.json")) as fh:
        assert json.load(fh)["extra"]["quality"]["gate"]["decision"] == "bypassed"
    assert len(scan_versions(reg)) == 2


def test_label_shuffled_candidate_is_quarantined(tmp_path, eval_world):
    """The gate end to end on real stats: a champion published with its
    ``game_quality_stats``, then a candidate whose labels were shuffled
    (its fitted signal gone: the model scored on shuffled labels) is
    quarantined and the registry is left as it was."""
    _, tdata, _, tmodel, truth = eval_world
    reg = str(tmp_path / "registry")
    champ = game_quality_stats(tmodel, tdata, num_samples=32, seed=0)
    publish_version(reg, tmodel, _FE_MAPS, quality=champ.to_json())
    before = sorted(os.listdir(reg))
    rng = np.random.default_rng(5)
    shuffled = build_game_dataset(rng.permutation(tdata.response),
                                  {"global": FeatureShard.from_dense(truth["Xg"])},
                                  device="cpu")
    cand = game_quality_stats(tmodel, shuffled, num_samples=32, seed=0)
    with pytest.raises(QualityGateRefused):
        publish_version(reg, tmodel, _FE_MAPS, quality=cand.to_json())
    assert [v for v, _ in scan_versions(reg)] == [1]
    assert sorted(os.listdir(reg)) == sorted(before + ["quarantined-v-00000002"])


# ---------------------------------------------------------------------------
# the incremental refresh: masked-lane bootstrap, cli refresh through the gate
# ---------------------------------------------------------------------------


def _entity_problem(rng, n_entities, rows, feats):
    """Dense per-entity logistic problems with planted coefficients."""
    x = rng.normal(size=(n_entities, rows, feats))
    w_true = rng.normal(size=(n_entities, feats)) * 0.5
    margins = np.einsum("erk,ek->er", x, w_true)
    y = rng.random((n_entities, rows)) < 1.0 / (1.0 + np.exp(-margins))
    return x, y.astype(np.float64)


def _j_entity_batch(x, y):
    from photon_ml_tpu.ops.sparse import SparseBatch

    e, rows, feats = x.shape
    nnz = rows * feats
    return SparseBatch(
        values=jnp.asarray(x.reshape(e, nnz), jnp.float32),
        rows=jnp.asarray(np.broadcast_to(np.repeat(np.arange(rows, dtype=np.int32), feats),
                                         (e, nnz))),
        cols=jnp.asarray(np.broadcast_to(np.tile(np.arange(feats, dtype=np.int32), rows),
                                         (e, nnz))),
        labels=jnp.asarray(y, jnp.float32), offsets=jnp.zeros((e, rows), jnp.float32),
        weights=jnp.ones((e, rows), jnp.float32), num_features=feats)


def test_masked_lane_bootstrap_matches_full_on_touched_rows():
    """Touched lanes gathered out of the full bucket's seeded draw
    (``counts[:, idx, :]``) see the full bootstrap's resample weights, so
    their summaries are the full run's on those rows (bit for bit in the
    port, whose lanes are independent)."""
    from photon_ml_tpu.diagnostics.bootstrap import bootstrap_random_effect as j_boot_re
    from photon_ml_tpu.optim import OptimizerConfig as JOpt
    from photon_ml_tpu.optim import OptimizerType as JOptType
    from photon_ml_tpu.optim import RegularizationContext as JReg
    from photon_ml_tpu.optim import RegularizationType as JRegType
    from photon_ml_tpu_torch.diagnostics.bootstrap import (
        bootstrap_random_effect,
        bootstrap_re_weights,
    )
    from photon_ml_tpu_torch.ops.dense import DenseBatch
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )

    rng = np.random.default_rng(21)
    n_entities, rows, feats = 6, 12, 3
    x, y = _entity_problem(rng, n_entities, rows, feats)
    opt = dict(max_iterations=12, tolerance=1e-8, regularization_weight=1.0)
    config = OptimizerConfig(optimizer_type=OptimizerType.NEWTON,
                             regularization=RegularizationContext(RegularizationType.L2), **opt)
    jconfig = JOpt(optimizer_type=JOptType.NEWTON, regularization=JReg(JRegType.L2), **opt)
    counts = bootstrap_re_weights(8, np.ones((n_entities, rows)), seed=4)
    full = bootstrap_random_effect(DenseBatch.from_arrays(x, y, device="cpu"), "logistic",
                                   config, torch.zeros(n_entities, feats), lane_weights=counts,
                                   device="cpu")
    idx = np.array([1, 3, 4])  # the touched entity lanes
    masked = bootstrap_random_effect(DenseBatch.from_arrays(x[idx], y[idx], device="cpu"),
                                     "logistic", config, torch.zeros(len(idx), feats),
                                     lane_weights=counts[:, idx, :], device="cpu")
    jfull = j_boot_re(_j_entity_batch(x, y), "logistic", jconfig,
                      jnp.zeros((n_entities, feats), jnp.float32), lane_weights=counts)
    for field in ("mean", "ci_low", "ci_high", "median", "std_dev"):
        got = getattr(masked, field)
        np.testing.assert_allclose(got, getattr(full, field)[idx], rtol=1e-5, atol=1e-6,
                                   err_msg=field)
        np.testing.assert_array_equal(got, getattr(full, field)[idx], err_msg=field)
        np.testing.assert_allclose(got, np.asarray(getattr(jfull, field))[idx], atol=1e-3,
                                   err_msg=field)
    assert masked.num_samples == full.num_samples == 8
    assert bool(np.all(masked.live_entities))
    width = masked.ci_high - masked.ci_low
    assert float(width.max()) > 0.0
    assert np.all(masked.ci_low <= masked.mean + 1e-9)
    assert np.all(masked.mean <= masked.ci_high + 1e-9)


@pytest.fixture(scope="module")
def quality_cli_base(tmp_path_factory):
    """A ``cli train`` base in each package and three deltas: two clean
    (they follow the planted model) and one label-shuffled."""
    from photon_ml_tpu.cli.train import run as j_run
    from photon_ml_tpu_torch.cli.train import run as t_run
    from photon_ml_tpu_torch.data.avro import TRAINING_EXAMPLE_AVRO, write_avro

    rng = np.random.default_rng(42)
    tmp = tmp_path_factory.mktemp("cli_quality")
    d, n_users = 8, 5
    w = rng.normal(size=d)
    u_eff = rng.normal(size=n_users)

    def write_shard(path, n, seed, shuffle_labels=False):
        r = np.random.default_rng(seed)
        users = r.integers(0, n_users, n)
        X = r.normal(size=(n, d))
        y = (r.random(n) < 1 / (1 + np.exp(-(X @ w + u_eff[users])))).astype(float)
        if shuffle_labels:
            y = r.permutation(y)  # the feature-label link broken
        write_avro(path, TRAINING_EXAMPLE_AVRO, (
            {"uid": str(i), "label": float(y[i]),
             "features": [{"name": f"c{j}", "term": "", "value": float(X[i, j])}
                          for j in range(d)],
             "metadataMap": {"userId": str(users[i])}, "weight": None, "offset": None}
            for i in range(n)))

    train_path = str(tmp / "train.avro")
    write_shard(train_path, 220, 1)
    deltas = {}
    for name, n, seed, shuffled in (("clean_delta", 60, 2, False), ("bad_delta", 240, 3, True),
                                    ("clean_delta2", 60, 4, False)):
        deltas[name] = str(tmp / f"{name}.avro")
        write_shard(deltas[name], n, seed, shuffle_labels=shuffled)
    out = {"tmp": tmp, **deltas}
    for pkg, run in (("t", t_run), ("j", j_run)):
        config = {
            "task": "logistic",
            "input": {"format": "avro", "paths": [train_path],
                      "feature_shards": {"global": ["features"]}, "id_columns": ["userId"]},
            "coordinates": {
                "fixed": {"type": "fixed_effect", "shard_name": "global",
                          "optimizer": {"regularization": "l2", "regularization_weight": 0.1}},
                "perUser": {"type": "random_effect", "shard_name": "global",
                            "id_name": "userId",
                            "optimizer": {"regularization": "l2",
                                          "regularization_weight": 1.0}}},
            "num_iterations": 1,
            "heartbeat": False,
            "output_dir": str(tmp / f"{pkg}-base-model"),
            "checkpoint": {"dir": str(tmp / f"{pkg}-base-ckpt"), "resume": False},
        }
        cfg_path = tmp / f"{pkg}-train.json"
        cfg_path.write_text(json.dumps(config))
        run(dict(config), **({"device": "cpu"} if pkg == "t" else {}))
        out[pkg] = {"cfg_path": str(cfg_path), "ckpt": config["checkpoint"]["dir"]}
    return out


def test_cli_refresh_quarantines_label_shuffled_delta(quality_cli_base):
    import contextlib
    import io

    from photon_ml_tpu.cli.refresh import main as j_refresh
    from photon_ml_tpu_torch.cli.refresh import main as t_refresh

    base = quality_cli_base
    tmp = base["tmp"]

    def refresh(pkg, delta, out_name):
        argv = ["--config", base[pkg]["cfg_path"], "--warm-start", base[pkg]["ckpt"],
                "--delta", base[delta], "--registry-dir", str(tmp / f"{pkg}-registry"),
                "--output-dir", str(tmp / f"{pkg}-{out_name}")]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = t_refresh(argv + ["--device", "cpu"]) if pkg == "t" else j_refresh(argv)
        assert rc == 0
        return json.loads(buf.getvalue().strip().splitlines()[-1])["freshness"]

    reg = str(tmp / "t-registry")
    # 1: a clean delta into an empty registry: published with error bars
    f1, j1 = refresh("t", "clean_delta", "fresh-1"), refresh("j", "clean_delta", "fresh-1")
    assert f1["published_version"].endswith("v-00000001")
    q1 = f1["quality"]
    assert q1["auc_ci_low"] <= q1["auc"] <= q1["auc_ci_high"]
    assert q1["bootstrap_samples"] == 32
    assert q1["auc"] == pytest.approx(j1["quality"]["auc"], abs=1e-3)
    assert q1["bootstrap"]["num_samples"] == 32
    buckets = q1["bootstrap"]["coordinates"]["perUser"]
    assert sum(b["touched_lanes"] for b in buckets.values()) >= 1
    assert any(b.get("mean_ci_width", 0) > 0 for b in buckets.values())
    assert "quality_gate" not in f1
    with open(os.path.join(reg, "v-00000001", "model-metadata.json")) as fh:
        meta = json.load(fh)
    assert meta["extra"]["quality"]["gate"]["decision"] == "no_champion"
    assert meta["extra"]["lineage"]["quality_gate"]["decision"] == "no_champion"

    # 2: the label-shuffled delta: the candidate's AUC falls below the
    # champion's CI, so it is quarantined (exit 0: a refusal is a result)
    f2, j2 = refresh("t", "bad_delta", "fresh-2"), refresh("j", "bad_delta", "fresh-2")
    assert "published_version" not in f2
    gate = f2["quality_gate"]
    assert gate["decision"] == "quarantined" == j2["quality_gate"]["decision"]
    assert gate["champion_version"] == "v-00000001"
    assert gate["candidate"]["auc"] < gate["champion"]["auc_ci_low"]
    assert os.path.basename(gate["quarantine_path"]) == "quarantined-v-00000002"
    assert os.path.isdir(gate["quarantine_path"])
    assert [os.path.basename(p) for _, p in scan_versions(reg)] == ["v-00000001"]

    # 3: a healthy challenger publishes into the slot the refusal never took
    f3, j3 = refresh("t", "clean_delta2", "fresh-3"), refresh("j", "clean_delta2", "fresh-3")
    assert f3["published_version"].endswith("v-00000002")
    assert "quality_gate" not in f3 and "quality_gate" not in j3
    with open(os.path.join(reg, "v-00000002", "model-metadata.json")) as fh:
        g3 = json.load(fh)["extra"]["quality"]["gate"]
    assert g3["decision"] == "published" and g3["champion_version"] == "v-00000001"
    for f, j in ((f1, j1), (f2, j2), (f3, j3)):
        for key in ("lanes_solved", "lanes_skipped", "bucket_solves", "buckets_skipped",
                    "new_entities"):
            assert f[key] == j[key], key


def test_conductor_cycle_quarantine_and_quality_report(quality_cli_base, tmp_path):
    """A conductor run over the same world, in both packages: cycle 1
    publishes the champion with error bars, cycle 2's label-shuffled delta
    is quarantined (the champion keeps serving and the cursor moves on),
    cycle 3 publishes a healthy challenger. The counters the reference's
    RunReport "Quality" section renders (ROADMAP.md Queue 1 item 14d) are
    asserted in ``telemetry.snapshot()``."""
    import shutil

    from photon_ml_tpu.pipeline import FreshnessPipeline as JPipeline
    from photon_ml_tpu.pipeline import PipelineSpec as JSpec
    from photon_ml_tpu_torch.pipeline import FreshnessPipeline, PipelineSpec

    telemetry.reset()
    drift.reset()
    base = quality_cli_base
    pipes = {}
    for pkg in ("t", "j"):
        with open(base[pkg]["cfg_path"]) as fh:
            config = json.load(fh)
        config.pop("output_dir", None)
        config.pop("checkpoint", None)
        delta_dir = tmp_path / f"{pkg}-deltas"
        delta_dir.mkdir()
        kw = dict(config=config, delta_dir=str(delta_dir), base_dir=base[pkg]["ckpt"],
                  registry_dir=str(tmp_path / f"{pkg}-registry"),
                  workdir=str(tmp_path / f"{pkg}-work"), interval_s=0.01,
                  escalate_touched_fraction=1.1, bootstrap_samples=16)
        pipes[pkg] = (FreshnessPipeline(PipelineSpec(**kw, device="cpu")) if pkg == "t"
                      else JPipeline(JSpec(**kw)))
    pipe, jpipe = pipes["t"], pipes["j"]
    reg = pipe.spec.registry_dir

    def cycle(name, shard):
        for p in (pipe, jpipe):
            shutil.copy(base[shard], os.path.join(p.spec.delta_dir, name))
        return pipe.run_cycle(), jpipe.run_cycle()

    try:
        e1, j1 = cycle("delta-0001.avro", "clean_delta")
        assert e1["published_version"] == "v-00000001" == j1["published_version"]
        with open(os.path.join(reg, "v-00000001", "model-metadata.json")) as fh:
            q1 = json.load(fh)["extra"]["quality"]
        assert q1["gate"]["decision"] == "no_champion"
        assert q1["auc_ci_low"] <= q1["auc"] <= q1["auc_ci_high"]
        assert q1["bootstrap"]["num_samples"] == 16

        e2, j2 = cycle("delta-0002.avro", "bad_delta")
        assert e2["published_version"] is None is j2["published_version"]
        assert e2["quarantined_version"] == "quarantined-v-00000002" == j2["quarantined_version"]
        assert e2["quality_gate"]["decision"] == "quarantined"
        # the champion keeps serving through the refusal
        assert pipe._registry.current_version == "v-00000001"
        # the cursor moved on: the refused delta is not retried
        assert pipe.run_cycle()["idle"] is True

        # the degraded shard is cleaned out; the next healthy candidate
        # publishes
        for p in (pipe, jpipe):
            os.remove(os.path.join(p.spec.delta_dir, "delta-0002.avro"))
        e4, j4 = cycle("delta-0003.avro", "clean_delta2")
        assert e4["published_version"] == "v-00000002" == j4["published_version"]
        assert pipe._registry.current_version == "v-00000002"
        with open(os.path.join(reg, "v-00000002", "model-metadata.json")) as fh:
            g4 = json.load(fh)["extra"]["quality"]["gate"]
        assert g4["decision"] == "published"
        assert g4["champion_version"] == "v-00000001"

        s = pipe.summary()
        assert s["published_versions"] == ["v-00000001", "v-00000002"]
        assert s["quarantined_versions"] == ["quarantined-v-00000002"]
        c = telemetry.snapshot()["counters"]
        assert c["quality.gate_quarantined"] == 1
        assert c["quality.gate_published"] == 1
        assert c["pipeline.quarantines"] == 1
        assert c["quality.stats_computed"] == 3
    finally:
        pipe._close("completed")
        jpipe._close("completed")
    telemetry.reset()
