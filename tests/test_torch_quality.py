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

Left out, with their subjects elsewhere:
``test_masked_lane_bootstrap_matches_full_on_touched_rows`` and
``test_cli_refresh_quarantines_label_shuffled_delta`` (the incremental
refresh, ROADMAP Queue 1 item 14b) and
``test_conductor_cycle_quarantine_and_quality_report`` (the freshness
conductor, item 14c).
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
