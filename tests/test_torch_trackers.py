"""The port's optimization trackers (``photon_ml_tpu_torch.optim.trackers``)
against the JAX package's, on the CPU (after ``tests/test_factored.py:324-380``
and the ``tracker`` keys of the coordinate-descent history).

Trackers built from the same arrays give the same summary strings, reason
counts, iteration statistics and percentiles (exactly: the same numpy
aggregation). A fixed effect's and a random effect's update in both packages
give the same tracker iteration counts and reasons; the random effect's
NEWTON stops at tolerance 1e-3, as ``tests/test_torch_newton.py``'s parity
tests do, before a lane's last damping decision follows float32 rounding
(ROADMAP.md Queue 3 item 5).
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu.game import build_game_dataset as j_build
from photon_ml_tpu.game import build_random_effect_dataset as j_build_re
from photon_ml_tpu.game.coordinates import FixedEffectCoordinate as JFE
from photon_ml_tpu.game.coordinates import RandomEffectCoordinate as JRE
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import OptimizerType as JOptType
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu.optim import trackers as J
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.game import (
    FeatureShard,
    FixedEffectConfig,
    GameConfig,
    GameEstimator,
    RandomEffectConfig,
    build_game_dataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.optim import trackers as T
from photon_ml_tpu_torch.optim.common import SolveResult
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)


def _arrays(seed, n=100):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 30, n).astype(np.int32), rng.integers(1, 5, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32) * 10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_effect_tracker_aggregates_as_the_reference(seed):
    its, reasons, vals = _arrays(seed)
    j = J.RandomEffectOptimizationTracker(iterations=its, reasons=reasons, final_values=vals)
    t = T.RandomEffectOptimizationTracker(iterations=its, reasons=reasons, final_values=vals)
    assert t.count_convergence_reasons() == j.count_convergence_reasons()
    assert t.iteration_stats() == j.iteration_stats()
    assert t.percentile_summary() == j.percentile_summary()
    assert t.to_summary_string() == j.to_summary_string()
    empty = dict(iterations=np.zeros(0, np.int32), reasons=np.zeros(0, np.int32))
    assert (T.RandomEffectOptimizationTracker(**empty).to_summary_string()
            == J.RandomEffectOptimizationTracker(**empty).to_summary_string())


def test_percentile_summary_as_the_reference_test():
    t = T.RandomEffectOptimizationTracker(
        iterations=np.arange(1, 101, dtype=np.int32), reasons=np.full(100, 3, np.int32),
        final_values=np.linspace(0.1, 1.0, 100).astype(np.float32))
    p = t.percentile_summary()
    assert p["iterations"]["p50"] == pytest.approx(50.5)
    assert p["final_loss"]["p95"] == pytest.approx(
        float(np.percentile(np.linspace(0.1, 1.0, 100), 95)), rel=1e-5)
    assert "p95" in t.to_summary_string()


def test_fixed_effect_and_factored_summaries_as_the_reference():
    kw = dict(iterations=7, reason="FunctionValuesConverged", final_value=123.456789,
              final_grad_norm=0.00123)
    jf, tf = J.FixedEffectOptimizationTracker(**kw), T.FixedEffectOptimizationTracker(**kw)
    assert tf.to_summary_string() == jf.to_summary_string()
    its, reasons, vals = _arrays(4, n=20)
    jr = J.RandomEffectOptimizationTracker(iterations=its, reasons=reasons, final_values=vals)
    tr = T.RandomEffectOptimizationTracker(iterations=its, reasons=reasons, final_values=vals)
    j = J.FactoredRandomEffectOptimizationTracker(steps=((jr, jf), (jr, None)))
    t = T.FactoredRandomEffectOptimizationTracker(steps=((tr, tf), (tr, None)))
    assert t.to_summary_string() == j.to_summary_string()
    assert "MF iteration 1" in t.to_summary_string()


def test_device_parts_cross_in_one_fetch_bit_for_bit():
    its, reasons, vals = _arrays(5, n=30)
    parts = [torch.from_numpy(a) for a in (its, reasons, vals)]
    cut = [(p[:10], p[10:]) for p in parts]
    telemetry.reset()
    t = T.RandomEffectOptimizationTracker.from_device_parts(*[list(c) for c in cut])
    counters = telemetry.snapshot()["counters"]
    assert counters["host_syncs"] == 1 and counters["re_solved_entities"] == 30
    np.testing.assert_array_equal(t.iterations, its)
    np.testing.assert_array_equal(t.reasons, reasons)
    np.testing.assert_array_equal(t.final_values.view(np.int32), vals.view(np.int32))
    none = T.RandomEffectOptimizationTracker.from_device_parts([], [], [])
    assert len(none.iterations) == 0


def test_fixed_effect_tracker_from_a_result_in_one_fetch():
    values = torch.tensor([5.0, 3.0, 2.5, float("inf")])
    gnorms = torch.tensor([4.0, 1.0, 0.25, float("inf")])
    res = SolveResult(w=torch.zeros(2), value=torch.tensor(2.5), grad=torch.zeros(2),
                      iterations=2, reason=3, values=values, grad_norms=gnorms)
    telemetry.reset()
    t = T.FixedEffectOptimizationTracker.from_result(res)
    counters = telemetry.snapshot()["counters"]
    assert counters["host_syncs"] == 1 and counters["fe_solves"] == 1
    assert (t.iterations, t.reason, t.final_value, t.final_grad_norm) == (
        2, "FunctionValuesConverged", 2.5, 0.25)


def _glmix(seed=3, n=1500, n_users=40, d_fe=60, d_re=4):
    rng = np.random.default_rng(seed)
    Xg = rng.normal(size=(n, d_fe)) * (rng.random((n, d_fe)) < 0.1)
    Xu = rng.normal(size=(n, d_re))
    users = rng.integers(0, n_users, size=n)
    margin = Xg @ rng.normal(size=d_fe) * 0.5 + np.einsum(
        "ij,ij->i", Xu, rng.normal(size=(n_users, d_re))[users])
    y = (rng.random(n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    jds = j_build(response=y, feature_shards={"g": JSparse.from_dense(Xg, y),
                                              "u": JSparse.from_dense(Xu, y)},
                  id_columns={"userId": users})
    tds = build_game_dataset(response=y, feature_shards={"g": FeatureShard.from_dense(Xg),
                                                         "u": FeatureShard.from_dense(Xu)},
                             id_columns={"userId": users}, device="cpu")
    return jds, tds


def test_fixed_and_random_effect_updates_track_as_the_reference():
    jds, tds = _glmix()
    reg = dict(regularization_weight=1.0, max_iterations=20, tolerance=1e-5)
    jfe = JOpt(regularization=JReg(JRegType.L2), **reg)
    tfe = OptimizerConfig(regularization=RegularizationContext(RegularizationType.L2), **reg)
    jc, tc = JFE("fixed", jds, "g", "logistic", jfe), FixedEffectCoordinate("fixed", tds, "g",
                                                                           "logistic", tfe)
    jc.update_model(jc.initialize_model(), None)
    tc.update_model(tc.initialize_model(), None)
    jt, tt = jc.last_tracker, tc.last_tracker
    assert (tt.iterations, tt.reason) == (jt.iterations, jt.reason)
    assert tt.final_value == pytest.approx(jt.final_value, rel=1e-5)

    jre = dataclasses.replace(jfe, optimizer_type=JOptType.NEWTON, tolerance=1e-3)
    tre = dataclasses.replace(tfe, optimizer_type=OptimizerType.NEWTON, tolerance=1e-3)
    jr = JRE("per-user", jds, j_build_re(jds, "userId", "u"), "logistic", jre)
    tr = RandomEffectCoordinate("per-user", tds, build_random_effect_dataset(tds, "userId", "u"),
                                "logistic", tre)
    jr.update_model(jr.initialize_model(), None)
    telemetry.reset()
    tr.update_model(tr.initialize_model(), None)
    # one fetch for the tracker, one per Newton round of each bucket
    assert telemetry.snapshot()["counters"]["re_solved_entities"] == 40
    jt, tt = jr.last_tracker, tr.last_tracker
    np.testing.assert_array_equal(tt.iterations, jt.iterations)
    np.testing.assert_array_equal(tt.reasons, jt.reasons)
    np.testing.assert_allclose(tt.final_values, jt.final_values, rtol=1e-5)
    assert tt.count_convergence_reasons() == jt.count_convergence_reasons()


def test_descent_history_carries_each_updates_tracker():
    _, tds = _glmix()
    opt = OptimizerConfig(regularization=RegularizationContext(RegularizationType.L2),
                          regularization_weight=1.0, max_iterations=10)
    cfg = GameConfig(task="logistic", num_iterations=2, coordinates={
        "fixed": FixedEffectConfig(shard_name="g", optimizer=opt),
        "per-user": RandomEffectConfig(shard_name="u", id_name="userId", optimizer=opt)})
    est = GameEstimator(cfg)
    fit = est.fit(tds, device="cpu")
    for e in fit.history:
        assert e["tracker"].startswith("iterations=" if e["coordinate"] == "fixed"
                                       else "entities=40 ")
    # a cached coordinate starts the next fit without its stale tracker
    coords = est._build_coordinates(tds)
    assert all(c.last_tracker is None for c in coords.values())
