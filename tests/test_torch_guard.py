"""The coordinate-descent guard of the port against the JAX package's
(tests/test_checkpoint.py:211-258), on the CPU:

- ``GuardSpec`` validation and ``damping_for`` agree;
- with a toy coordinate in both packages, a damped retry that recovers, and
  rollback then freeze, give the same models, the same ``solves.*``
  counters and the same guard keys in ``history``;
- a real fit whose fixed effect reads a NaN feature diverges, retries,
  rolls back and freezes in both packages alike, and the other coordinate
  trains on;
- on healthy data a guarded fit is bit-identical to an unguarded one.

The toy models are exact small integers, so they agree exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import telemetry as jtelemetry
from photon_ml_tpu.game import FixedEffectModel as JFEModel
from photon_ml_tpu.game import run_coordinate_descent as j_run
from photon_ml_tpu.optim import GuardSpec as JGuardSpec
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.game import (
    FeatureShard,
    FixedEffectConfig,
    GameConfig,
    GameEstimator,
    RandomEffectConfig,
    build_game_dataset,
)
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.game.models import FixedEffectModel
from photon_ml_tpu_torch.optim import GuardSpec
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.guard import damped_objective, model_is_finite, solve_health

_GUARD_KEYS = ("iteration", "coordinate", "solve_retries", "rolled_back")
_COUNTERS = ("solves.diverged", "solves.retried", "solves.rolled_back", "solves.frozen")


class _Toy:
    """Every update adds 1 to both coefficients. ``mode``: "ok" always
    converges, "nan_until_damped" gives NaNs until damped, "nan" always."""

    def __init__(self, jax: bool, mode="ok", n_rows=6):
        self.jax, self.mode, self.n_rows = jax, mode, n_rows
        self.extra_l2 = 0.0
        self.updates = 0

    def initialize_model(self):
        if self.jax:
            return JFEModel(coefficients=jnp.zeros((2,), jnp.float32), shard_name="f")
        return FixedEffectModel(coefficients=torch.zeros(2), shard_name="f")

    def update_model(self, model, residual_scores):
        self.updates += 1
        if self.mode == "nan" or (self.mode == "nan_until_damped" and not self.extra_l2):
            w = (jnp.full((2,), jnp.nan, jnp.float32) if self.jax
                 else torch.full((2,), float("nan")))
        else:
            w = model.coefficients + 1.0
        return dataclasses.replace(model, coefficients=w)

    def score(self, model):
        if self.jax:
            return jnp.broadcast_to(model.coefficients[0], (self.n_rows,)).astype(jnp.float32)
        return model.coefficients[0].expand(self.n_rows).clone()


def _both(modes: dict, num_iterations: int, **guard_kw):
    """Run the toy coordinates under both packages' guards; returns per
    package (coefficients, counters, guard keys of history, updates)."""
    out = {}
    for pkg, run, spec, tel in (("jax", j_run, JGuardSpec, jtelemetry),
                                ("port", run_coordinate_descent, GuardSpec, telemetry)):
        coords = {n: _Toy(pkg == "jax", m) for n, m in modes.items()}
        tel.reset()
        try:
            res = run(coords, task="logistic", num_iterations=num_iterations,
                      guard=spec(**guard_kw))
            counters = {k: v for k, v in tel.snapshot()["counters"].items() if k in _COUNTERS}
        finally:
            tel.reset()
        out[pkg] = ({n: np.asarray(m.coefficients).tolist() for n, m in res.model.models.items()},
                    counters,
                    [{k: e[k] for k in _GUARD_KEYS if k in e} for e in res.history],
                    {n: c.updates for n, c in coords.items()})
    assert out["port"] == out["jax"]
    return out["port"]


def test_guard_spec_validation_and_damping_agree():
    for bad in (dict(max_retries=-1), dict(damping_factor=0.5), dict(initial_damping=0.0),
                dict(freeze_after=0)):
        with pytest.raises(ValueError):
            JGuardSpec(**bad)
        with pytest.raises(ValueError):
            GuardSpec(**bad)
    for kw in ({}, dict(initial_damping=0.5, damping_factor=3.0)):
        assert [GuardSpec(**kw).damping_for(a) for a in range(5)] == \
            [JGuardSpec(**kw).damping_for(a) for a in range(5)]
    assert GuardSpec().damping_for(0) == 0.0
    assert GuardSpec(initial_damping=1.0, damping_factor=10.0).damping_for(2) == 10.0


def test_damped_retry_recovers_in_both_packages():
    coefs, counters, history, _ = _both({"a": "nan_until_damped"}, 1, max_retries=2)
    assert coefs == {"a": [1.0, 1.0]}
    assert counters == {"solves.diverged": 1, "solves.retried": 1}
    assert history == [{"iteration": 0, "coordinate": "a", "solve_retries": 1,
                        "rolled_back": False}]


def test_rollback_then_freeze_in_both_packages():
    coefs, counters, history, updates = _both({"bad": "nan", "ok": "ok"}, 3, max_retries=1,
                                              freeze_after=2)
    # the bad coordinate keeps its initial model; the healthy one trains on
    assert coefs == {"bad": [0.0, 0.0], "ok": [3.0, 3.0]}
    assert updates == {"bad": 4, "ok": 3}  # 2 rollbacks x (1 + 1 retry), then frozen
    assert counters == {"solves.diverged": 4, "solves.retried": 2, "solves.rolled_back": 2,
                        "solves.frozen": 1}
    assert history[0] == {"iteration": 0, "coordinate": "bad", "solve_retries": 1,
                          "rolled_back": True}
    assert [h["coordinate"] for h in history] == ["bad", "ok", "bad", "ok", "ok"]


def test_health_checks():
    from photon_ml_tpu_torch.optim.common import SolveResult

    def res(value, v0):
        return SolveResult(w=torch.zeros(2), value=torch.tensor(value), grad=torch.zeros(2),
                           iterations=1, reason=0, values=torch.tensor([v0, value]),
                           grad_norms=torch.zeros(2))

    w = torch.zeros(2)
    assert bool(solve_health(res(1.0, 2.0), w))
    assert bool(solve_health(res(2.0 + 1e-3, 2.0), w))  # within the regression slack
    assert not bool(solve_health(res(2.1, 2.0), w))
    assert not bool(solve_health(res(float("nan"), 2.0), w))
    assert not bool(solve_health(res(1.0, 2.0), torch.tensor([0.0, float("inf")])))
    assert bool(model_is_finite(FixedEffectModel(coefficients=torch.ones(2), shard_name="f")))
    obj = type("Obj", (), {"l2_weight": 0.5, "with_l2": lambda self, v: v})()
    assert damped_objective(obj, 0.0) is obj and damped_objective(obj, 2.0) == 2.5


def _opt(kind=OptimizerType.LBFGS, reg=1.0):
    return OptimizerConfig(optimizer_type=kind, max_iterations=15, tolerance=1e-6,
                           regularization=RegularizationContext(RegularizationType.L2),
                           regularization_weight=reg)


def _game_data(seed=0, nan_feature=False):
    rng = np.random.default_rng(seed)
    n, d, n_users, k = 300, 6, 12, 3
    X = rng.normal(size=(n, d))
    if nan_feature:
        X[7, 2] = np.nan
    Xu = rng.normal(size=(n, k))
    users = rng.integers(0, n_users, n)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-np.nan_to_num(X) @ rng.normal(size=d)))).astype(float)
    return n, X, Xu, users, y


def _port_data(seed=0, nan_feature=False):
    n, X, Xu, users, y = _game_data(seed, nan_feature)
    return build_game_dataset(y, {"global": FeatureShard.from_dense(X),
                                  "user": FeatureShard.from_dense(Xu)},
                              id_columns={"userId": users}, device="cpu")


def _port_config():
    return GameConfig(task="logistic", num_iterations=2, coordinates={
        "fixed": FixedEffectConfig(shard_name="global", optimizer=_opt()),
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId",
                                       optimizer=_opt(OptimizerType.NEWTON)),
    })


def test_a_diverging_fixed_effect_rolls_back_and_freezes_in_both_packages():
    from photon_ml_tpu.game import FixedEffectConfig as JFE
    from photon_ml_tpu.game import GameConfig as JGameConfig
    from photon_ml_tpu.game import GameEstimator as JEstimator
    from photon_ml_tpu.game import RandomEffectConfig as JRE
    from photon_ml_tpu.game import build_game_dataset as j_build
    from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
    from photon_ml_tpu.optim import OptimizerConfig as JOpt
    from photon_ml_tpu.optim import OptimizerType as JOptType
    from photon_ml_tpu.optim import RegularizationContext as JReg
    from photon_ml_tpu.optim import RegularizationType as JRegType

    n, X, Xu, users, y = _game_data(nan_feature=True)

    def jopt(kind):
        return JOpt(optimizer_type=kind, max_iterations=15, tolerance=1e-6,
                    regularization=JReg(JRegType.L2), regularization_weight=1.0)

    jds = j_build(y, {"global": JSparse.from_dense(X, y), "user": JSparse.from_dense(Xu, y)},
                  id_columns={"userId": users})
    jcfg = JGameConfig(task="logistic", num_iterations=2, coordinates={
        "fixed": JFE(shard_name="global", optimizer=jopt(JOptType.LBFGS)),
        "per-user": JRE(shard_name="user", id_name="userId", optimizer=jopt(JOptType.NEWTON)),
    })
    spec = dict(max_retries=1, freeze_after=1)
    got = {}
    for pkg, est, ds, guard, tel in (
            ("jax", JEstimator(jcfg), jds, JGuardSpec(**spec), jtelemetry),
            ("port", GameEstimator(_port_config()), _port_data(nan_feature=True),
             GuardSpec(**spec), telemetry)):
        tel.reset()
        try:
            kw = {"device": "cpu"} if pkg == "port" else {}
            fit = est.fit(ds, guard=guard, **kw)
            counters = {k: v for k, v in tel.snapshot()["counters"].items() if k in _COUNTERS}
        finally:
            tel.reset()
        fe = np.asarray(fit.model.models["fixed"].coefficients)
        got[pkg] = (counters, [{k: e[k] for k in _GUARD_KEYS if k in e} for e in fit.history],
                    fe.tolist())
    assert got["port"] == got["jax"]
    counters, history, fe = got["port"]
    assert counters == {"solves.diverged": 2, "solves.retried": 1, "solves.rolled_back": 1,
                        "solves.frozen": 1}
    assert fe == [0.0] * X.shape[1]  # rolled back to the initial model
    assert [h["coordinate"] for h in history] == ["fixed", "per-user", "per-user"]


def test_a_guarded_fit_on_healthy_data_is_bit_identical():
    ds = _port_data()
    telemetry.reset()
    fits = [GameEstimator(_port_config()).fit(ds, guard=g, device="cpu")
            for g in (None, GuardSpec())]
    counters = telemetry.snapshot()["counters"]
    telemetry.reset()
    assert not any(k in counters for k in _COUNTERS)
    plain, guarded = (f.model for f in fits)
    assert torch.equal(plain.models["fixed"].coefficients, guarded.models["fixed"].coefficients)
    for a, b in zip(plain.models["per-user"].buckets, guarded.models["per-user"].buckets):
        assert torch.equal(a.coefficients, b.coefficients)
    assert [set(e) for e in fits[0].history] == [set(e) for e in fits[1].history]
