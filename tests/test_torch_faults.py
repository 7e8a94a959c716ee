"""The port's fault injection (``photon_ml_tpu_torch.faults``) against the JAX
package's, case for case with tests/test_faults.py:

- the catalog: the reference's ``EXPECTED_POINTS`` less
  ``telemetry.flight_dump`` (ROADMAP.md Queue 1 item 14d) after importing
  every owning module, the write-path and distributed sets, and the JAX
  package's own catalog (less the same point) equal to the port's, both
  computed in one test;
- plan semantics, the JSON round trip, the environment transport, the
  per-point counts;
- ``corrupt_array`` on numpy and torch, ``corrupt_health`` (on the health's
  own device), non-``nan`` actions at the corruption sites;
- a ``nan`` at ``streaming.solve.result`` driving the streamed guard's
  rollback, and a ``raise`` at ``streaming.chunk.boundary`` leaving a
  resumable directory whose resumed table is the uninterrupted one bit for
  bit, and the JAX package's uninterrupted table within
  tests/test_torch_streaming.py's tolerance;
- ``guard.solve_health`` driving coordinate descent's rollback, and
  ``cd.step.boundary`` leaving the last step's checkpoint resumable.

Left out: ``test_bench_suite_gate_refuses_while_armed`` (``bench_suite.py
--gate``: the port's benchmark is a PR of its own; ROADMAP "Held for after
the benchmark PR").
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import faults, telemetry

TOL = dict(rtol=5e-3, atol=5e-4)  # tests/test_torch_streaming.py's streamed-table tolerance

#: tests/test_faults.py:35-106, less telemetry.flight_dump (item 14d)
EXPECTED_POINTS = {
    "checkpoint.save.before_tmp", "checkpoint.save.before_manifest",
    "checkpoint.save.before_rename", "checkpoint.save.after_rename",
    "checkpoint.manifest.read",
    "cd.step.boundary", "guard.solve_health", "streaming.solve.result",
    "streaming.chunk.boundary",
    "ingest.decode.read", "ingest.ring.acquire", "ingest.upload.chunk",
    "serving.dispatch", "serving.async_dispatch", "serving.registry.poll",
    "serving.registry.load", "serving.nearline_event", "serving.nearline_apply",
    "multihost.init", "fleet.heartbeat", "checkpoint.peer_manifest",
    "parallel.collective.entry",
    "serving.member_load", "serving.route_fanout", "serving.resize_swap",
    "fleet.status_write",
    "incremental.warm_restore", "incremental.delta_scan", "incremental.publish",
    "pipeline.cycle_start", "pipeline.reconcile", "pipeline.escalate",
    "quality.publish_gate", "quality.drift_flush",
}

WRITE_PATH_POINTS = ["checkpoint.save.after_rename", "checkpoint.save.before_manifest",
                     "checkpoint.save.before_rename", "checkpoint.save.before_tmp"]

DISTRIBUTED_POINTS = ["checkpoint.peer_manifest", "fleet.heartbeat", "multihost.init",
                      "parallel.collective.entry", "serving.member_load",
                      "serving.resize_swap", "serving.route_fanout"]

#: the modules of each package that own a seam (registration is at import)
_OWNERS = ("game.checkpoint", "game.coordinate_descent", "game.streaming", "ingest.buffers",
           "ingest.decode", "ingest.pipeline", "serving.batcher", "serving.nearline",
           "serving.registry", "serving.router", "serving.shard", "parallel.distributed",
           "parallel.fleet_status", "parallel.multihost", "incremental", "pipeline",
           "quality.drift", "quality.gate", "optim.guard")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test starts with fresh counters and leaves the process
    unarmed."""
    telemetry.reset()
    yield
    faults.clear_plan()


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------


def test_registry_catalog_is_the_reference_catalog_less_flight_dump():
    import importlib

    from photon_ml_tpu import faults as j_faults

    for mod in _OWNERS:
        importlib.import_module(f"photon_ml_tpu_torch.{mod}")
        importlib.import_module(f"photon_ml_tpu.{mod}")
    importlib.import_module("photon_ml_tpu.telemetry.requests")  # the JAX flight_dump owner

    registered = faults.registered_points()
    assert set(registered) == EXPECTED_POINTS
    assert faults.write_path_points() == WRITE_PATH_POINTS
    assert faults.distributed_points() == DISTRIBUTED_POINTS
    for name, info in registered.items():
        assert info.name == name
        assert info.description

    # the JAX package's catalog, computed here, less the one point of 14d
    j_registered = j_faults.registered_points()
    assert set(j_registered) - {"telemetry.flight_dump"} == set(registered)
    assert j_faults.write_path_points() == faults.write_path_points()
    assert j_faults.distributed_points() == faults.distributed_points()
    for name, info in registered.items():
        j_info = j_registered[name]
        assert (info.write_path, info.distributed) == (j_info.write_path,
                                                       j_info.distributed), name


def test_reregistration_is_idempotent_but_write_path_conflicts_raise():
    import photon_ml_tpu_torch.game.checkpoint  # noqa: F401

    assert faults.register_point("checkpoint.manifest.read") == "checkpoint.manifest.read"
    with pytest.raises(ValueError, match="write_path"):
        faults.register_point("checkpoint.manifest.read", write_path=True)
    with pytest.raises(ValueError, match="distributed"):
        faults.register_point("checkpoint.manifest.read", distributed=True)


# ---------------------------------------------------------------------------
# plan semantics
# ---------------------------------------------------------------------------


def test_nth_hit_fires_exactly_once_on_the_nth_call():
    plan = faults.FaultPlan([faults.FaultRule("t.nth", nth=3)])
    faults.install_plan(plan)
    faults.fault_point("t.nth")
    faults.fault_point("t.nth")
    with pytest.raises(faults.InjectedFault, match="t.nth"):
        faults.fault_point("t.nth")
    faults.fault_point("t.nth")
    assert plan.hit_counts() == {"t.nth": 4}


def test_io_action_is_an_oserror():
    faults.install_plan(faults.FaultPlan([faults.FaultRule("t.io", action="io")]))
    with pytest.raises(OSError) as ei:
        faults.fault_point("t.io")
    assert isinstance(ei.value, faults.InjectedFault)
    assert ei.value.point == "t.io"


def test_probability_draws_are_seed_deterministic_and_the_reference_schedule():
    from photon_ml_tpu import faults as j_faults

    def pattern(mod, seed):
        plan = mod.FaultPlan([mod.FaultRule("t.p", action="raise", probability=0.5)],
                             seed=seed)
        return [plan.hit("t.p") is not None for _ in range(64)]

    a = pattern(faults, 7)
    assert a == pattern(faults, 7)
    assert pattern(faults, 8) != a
    assert any(a) and not all(a)
    assert a == pattern(j_faults, 7)  # the same draws as the JAX package's


def test_plan_validation_rejects_malformed_rules():
    with pytest.raises(faults.FaultPlanError, match="unknown fault action"):
        faults.FaultRule("x", action="explode")
    with pytest.raises(faults.FaultPlanError, match="mutually exclusive"):
        faults.FaultRule("x", nth=1, probability=0.5)
    with pytest.raises(faults.FaultPlanError, match="nth must be >= 1"):
        faults.FaultRule("x", nth=0)
    with pytest.raises(faults.FaultPlanError, match="probability"):
        faults.FaultRule("x", probability=1.5)
    with pytest.raises(faults.FaultPlanError, match="duplicate"):
        faults.FaultPlan([faults.FaultRule("x"), faults.FaultRule("x")])
    with pytest.raises(faults.FaultPlanError, match="malformed"):
        faults.FaultPlan.from_json("{nope")
    with pytest.raises(faults.FaultPlanError, match="unknown rule keys"):
        faults.FaultPlan.from_json({"rules": [{"point": "x", "severity": "bad"}]})


def test_plan_roundtrips_through_json_and_names_unregistered_points():
    from photon_ml_tpu import faults as j_faults

    plan = faults.FaultPlan([
        faults.FaultRule("checkpoint.manifest.read", action="io", nth=2),
        faults.FaultRule("no.such.point", action="exit", exit_code=99)], seed=5)
    doc = plan.to_json()
    again = faults.FaultPlan.from_json(json.dumps(doc))
    assert again.to_json() == doc
    assert again.seed == 5
    import photon_ml_tpu_torch.game.checkpoint  # noqa: F401 (registers)

    assert again.unregistered_points() == ["no.such.point"]
    # a plan document either package wrote arms the other
    assert j_faults.FaultPlan.from_json(json.dumps(doc)).to_json() == doc


def test_env_transport_arms_without_code_cooperation(monkeypatch, tmp_path):
    doc = {"rules": [{"point": "t.env", "action": "raise"}]}
    monkeypatch.setenv(faults.ENV_VAR, json.dumps(doc))
    plan = faults.install_from_env()
    assert plan is not None and plan.points == ["t.env"]
    assert faults.warn_if_armed() is True
    with pytest.raises(faults.InjectedFault):
        faults.fault_point("t.env")
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(doc))
    monkeypatch.setenv(faults.ENV_VAR, f"@{p}")
    assert faults.install_from_env().points == ["t.env"]
    monkeypatch.delenv(faults.ENV_VAR)
    assert faults.install_from_env() is None
    assert faults.warn_if_armed() is False


def test_unarmed_fault_point_is_a_noop_and_counts_nothing():
    faults.clear_plan()
    faults.fault_point("t.anything")
    assert telemetry.snapshot()["counters"].get("faults.injected") is None


def test_injections_are_counted_per_point():
    telemetry.reset()
    try:
        faults.install_plan(faults.FaultPlan([faults.FaultRule("t.counted")]))
        with pytest.raises(faults.InjectedFault):
            faults.fault_point("t.counted")
        counters = telemetry.snapshot()["counters"]
        assert counters["faults.injected"] == 1
        assert counters["faults.injected.t.counted"] == 1
    finally:
        telemetry.reset()


# ---------------------------------------------------------------------------
# value-corruption seams
# ---------------------------------------------------------------------------


def test_corrupt_array_poisons_first_element_numpy_and_torch():
    faults.install_plan(faults.FaultPlan([faults.FaultRule("t.nan", action="nan", nth=1)]))
    host = np.ones((2, 3))
    out = faults.corrupt_array("t.nan", host)
    assert np.isnan(out[0, 0]) and not np.isnan(host[0, 0])  # a copy
    assert faults.corrupt_array("t.nan", host) is host  # the second hit passes through

    faults.install_plan(faults.FaultPlan([faults.FaultRule("t.nan2", action="nan")]))
    t = torch.ones(4)
    poisoned = faults.corrupt_array("t.nan2", t)
    assert torch.isnan(poisoned[0]) and not torch.isnan(t[0])
    assert torch.isfinite(poisoned[1:]).all()


def test_corrupt_health_forces_diverged_verdict():
    faults.install_plan(faults.FaultPlan([faults.FaultRule("guard.solve_health",
                                                           action="nan")]))
    assert not bool(faults.corrupt_health("guard.solve_health", torch.tensor(True)))
    # an unarmed point passes the verdict through
    assert bool(faults.corrupt_health("t.other", torch.tensor(True)))


def test_corrupt_health_answers_on_the_health_device():
    """The forced verdict lies where the health it replaces lies, so a loop
    combining it with device tensors sees no device mismatch (a ``meta``
    tensor stands for a device other than the CPU)."""
    faults.install_plan(faults.FaultPlan([faults.FaultRule("guard.solve_health",
                                                           action="nan")]))
    health = torch.ones((), dtype=torch.bool, device="meta")
    out = faults.corrupt_health("guard.solve_health", health)
    assert out.device == health.device and out.dtype == torch.bool and out.shape == ()
    faults.install_plan(faults.FaultPlan([faults.FaultRule("guard.solve_health",
                                                           action="nan")]))
    flag = faults.corrupt_health("guard.solve_health", True)  # a host verdict stays a host one
    assert flag.device.type == "cpu" and not bool(flag)


def test_corrupt_sites_degrade_non_nan_actions_to_their_trigger():
    faults.install_plan(faults.FaultPlan([faults.FaultRule("t.deg", action="io")]))
    with pytest.raises(faults.InjectedIOError):
        faults.corrupt_array("t.deg", np.ones(3))


# ---------------------------------------------------------------------------
# the seams in the training loops
# ---------------------------------------------------------------------------


def _entity_problem(rng, n_ent=8, rows=6, k=3):
    X = rng.normal(size=(n_ent, rows, k))
    y = (rng.random((n_ent, rows)) < 0.5).astype(float)
    return X, y


def _t_chunk(X, y, lo, hi):
    from photon_ml_tpu_torch.ops.dense import DenseBatch

    rows = X.shape[1]
    return DenseBatch.from_arrays(X[lo:hi].astype(np.float32), y[lo:hi].astype(np.float32),
                                  np.zeros((hi - lo, rows), np.float32),
                                  np.ones((hi - lo, rows), np.float32), device="cpu")


def _t_cfg():
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )

    return OptimizerConfig(max_iterations=40, tolerance=1e-8, regularization_weight=0.3,
                           regularization=RegularizationContext(RegularizationType.L2))


def test_nan_injection_at_solve_result_drives_guard_rollback(rng):
    """A ``nan`` rule at ``streaming.solve.result`` makes a healthy chunk
    diverge: the guard retries damped, rolls back, and the run goes on."""
    from photon_ml_tpu_torch.game.streaming import (
        ShardedCoefficientTable,
        StreamingRandomEffectTrainer,
    )
    from photon_ml_tpu_torch.optim.guard import GuardSpec

    n_ent = 8
    X, y = _entity_problem(rng, n_ent)
    telemetry.reset()
    try:
        # every attempt of chunk 0 is poisoned (the solve and its damped
        # retry), so the guard rolls it back; chunk 1 trains
        faults.install_plan(faults.FaultPlan([faults.FaultRule(
            "streaming.solve.result", action="nan", probability=1.0)], seed=1))
        table = ShardedCoefficientTable(n_ent, 3, device="cpu")
        trainer = StreamingRandomEffectTrainer("logistic", _t_cfg(), guard=GuardSpec(max_retries=1),
                                               device="cpu")
        trainer.train(table, [(0, _t_chunk(X, y, 0, 4))])
        faults.clear_plan()
        trainer.train(table, [(4, _t_chunk(X, y, 4, n_ent))], start_chunk=0)
        got = table.to_numpy()
        np.testing.assert_array_equal(got[:4], 0.0)  # rolled back
        assert np.any(np.abs(got[4:]) > 0)
        counters = telemetry.snapshot()["counters"]
        assert counters["solves.rolled_back"] == 1
        assert counters["faults.injected"] >= 2  # the solve and its damped retry
    finally:
        telemetry.reset()


def test_raise_injection_at_chunk_boundary_leaves_resumable_state(rng, tmp_path):
    """An ``InjectedFault`` at ``streaming.chunk.boundary`` surfaces after the
    previous boundary's checkpoint was certified: the rerun resumes from it
    and ends on the uninterrupted table bit for bit, which is the JAX
    package's uninterrupted table within the streamed tolerance."""
    from photon_ml_tpu.game.streaming import ShardedCoefficientTable as JTable
    from photon_ml_tpu.game.streaming import StreamingRandomEffectTrainer as JTrainer
    from photon_ml_tpu.ops.dense import DenseBatch as JDense
    from photon_ml_tpu.optim import OptimizerConfig as JOpt
    from photon_ml_tpu.optim import RegularizationContext as JReg
    from photon_ml_tpu.optim import RegularizationType as JRegType
    from photon_ml_tpu_torch.game.checkpoint import CheckpointSpec, StreamingCheckpointManager
    from photon_ml_tpu_torch.game.streaming import (
        ShardedCoefficientTable,
        StreamingRandomEffectTrainer,
    )

    n_ent, k = 8, 3
    X, y = _entity_problem(rng, n_ent, k=k)
    chunks = [(0, _t_chunk(X, y, 0, 4)), (4, _t_chunk(X, y, 4, n_ent))]
    trainer = StreamingRandomEffectTrainer("logistic", _t_cfg(), prefetch=False, device="cpu")
    ref = ShardedCoefficientTable(n_ent, k, device="cpu")
    trainer.train(ref, chunks)
    expected = ref.to_numpy()

    mgr = StreamingCheckpointManager(CheckpointSpec(directory=str(tmp_path / "ckpt"), every=1))
    table = ShardedCoefficientTable(n_ent, k, device="cpu")
    faults.install_plan(faults.FaultPlan([faults.FaultRule("streaming.chunk.boundary", nth=2)]))
    with pytest.raises(faults.InjectedFault, match="streaming.chunk.boundary"):
        trainer.train(table, chunks, checkpointer=mgr)
    faults.clear_plan()
    state = mgr.restore()
    assert state is not None and state.next_chunk == 1
    table2 = ShardedCoefficientTable(n_ent, k, device="cpu")
    table2.write_chunk(0, torch.as_tensor(np.asarray(state.coefficients)))
    trainer.train(table2, chunks, checkpointer=mgr, start_chunk=state.next_chunk)
    np.testing.assert_array_equal(table2.to_numpy(), expected)

    def j_chunk(lo, hi):
        return JDense(x=X[lo:hi].astype(np.float32), labels=y[lo:hi].astype(np.float32),
                      offsets=np.zeros((hi - lo, X.shape[1]), np.float32),
                      weights=np.ones((hi - lo, X.shape[1]), np.float32))

    jcfg = JOpt(max_iterations=40, tolerance=1e-8, regularization=JReg(JRegType.L2),
                regularization_weight=0.3)
    jtable = JTable(n_ent, k)
    JTrainer("logistic", jcfg, prefetch=False).train(jtable, [(0, j_chunk(0, 4)),
                                                              (4, j_chunk(4, n_ent))])
    np.testing.assert_allclose(table2.to_numpy(), jtable.to_numpy(), **TOL)


def _small_game(seed=3):
    """A small GLMix problem for the coordinate-descent seams."""
    from photon_ml_tpu_torch.game import (
        FeatureShard,
        FixedEffectConfig,
        GameConfig,
        RandomEffectConfig,
        build_game_dataset,
    )
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )

    rng = np.random.default_rng(seed)
    n, d = 300, 4
    X = rng.normal(size=(n, d))
    users = rng.integers(0, 6, n)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ rng.normal(size=d))))).astype(float)
    r, c = np.nonzero(X)
    data = build_game_dataset(response=y, feature_shards={"g": FeatureShard.from_coo(
        X[r, c], r, c, d)}, id_columns={"userId": np.array([str(u) for u in users])},
        device="cpu")
    opt = OptimizerConfig(max_iterations=30, tolerance=1e-7, regularization_weight=1.0,
                          regularization=RegularizationContext(RegularizationType.L2))
    config = GameConfig(task="logistic", num_iterations=2, coordinates={
        "fixed": FixedEffectConfig(shard_name="g", optimizer=opt),
        "perUser": RandomEffectConfig(shard_name="g", id_name="userId", optimizer=opt)})
    return data, config


def test_solve_health_seam_drives_coordinate_descent_rollback():
    """A ``nan`` rule at ``guard.solve_health`` marks solves diverged: the
    guarded fit retries and rolls back on demand, as the JAX package's
    ``corrupt_health`` seam drives it."""
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.optim.guard import GuardSpec

    data, config = _small_game()
    telemetry.reset()
    try:
        faults.install_plan(faults.FaultPlan([faults.FaultRule("guard.solve_health",
                                                               action="nan", nth=1)]))
        res = GameEstimator(config).fit(data, guard=GuardSpec(max_retries=1), device="cpu")
        counters = telemetry.snapshot()["counters"]
        assert counters["faults.injected.guard.solve_health"] == 1
        assert counters["solves.diverged"] == 1 and counters["solves.retried"] == 1
        assert counters.get("solves.rolled_back") is None  # the damped retry was healthy
        assert all(torch.isfinite(m.coefficients).all() for m in [res.model.models["fixed"]])
    finally:
        telemetry.reset()


def test_step_boundary_raise_leaves_the_last_step_resumable(tmp_path):
    """An injected raise at ``cd.step.boundary`` of step 2 (before its save)
    leaves step 1's checkpoint; the resumed fit ends on the uninterrupted
    fit's model bit for bit."""
    from photon_ml_tpu_torch.game import CheckpointSpec, GameEstimator

    data, config = _small_game()
    full = GameEstimator(config).fit(data, device="cpu")
    spec = CheckpointSpec(directory=str(tmp_path / "ckpt"))
    faults.install_plan(faults.FaultPlan([faults.FaultRule("cd.step.boundary", nth=3)]))
    with pytest.raises(faults.InjectedFault, match="cd.step.boundary"):
        GameEstimator(config).fit(data, checkpoint_spec=spec, device="cpu")
    faults.clear_plan()
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step-00000000",
                                                                     "step-00000001"]
    resumed = GameEstimator(config).fit(data, checkpoint_spec=spec, device="cpu")
    assert torch.equal(resumed.model.models["fixed"].coefficients,
                       full.model.models["fixed"].coefficients)
    for a, b in zip(resumed.model.models["perUser"].buckets,
                    full.model.models["perUser"].buckets):
        assert torch.equal(a.coefficients, b.coefficients)


def test_manifest_read_io_is_skipped_as_corrupt(tmp_path):
    """An ``io`` rule at ``checkpoint.manifest.read`` makes restore pass the
    newest checkpoint by (counted corrupt) and fall back to the one before."""
    from photon_ml_tpu_torch.game import CheckpointSpec, GameEstimator
    from photon_ml_tpu_torch.game.checkpoint import CheckpointManager

    data, config = _small_game()
    spec = CheckpointSpec(directory=str(tmp_path / "ckpt"))
    GameEstimator(config).fit(data, checkpoint_spec=spec, device="cpu")
    telemetry.reset()
    try:
        faults.install_plan(faults.FaultPlan([faults.FaultRule("checkpoint.manifest.read",
                                                               action="io", nth=1)]))
        state = CheckpointManager(spec, device="cpu").restore()
        assert state is not None and state.step == 2  # step 3's manifest "failed"
        assert telemetry.snapshot()["counters"]["checkpoint.corrupt"] == 1
    finally:
        telemetry.reset()
