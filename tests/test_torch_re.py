"""The port's ``RandomEffectCoordinate`` against the JAX package's, on the
CPU, for each optimizer (LBFGS, the default; OWLQN; TRON; NEWTON) on each
layout of a bucket (dense designs, and the COO layout, forced in both
packages by patching ``_bucket_dense_design`` before the datasets are
built: designs are cached per dataset); then variances and box
constraints, NEWTON in a box among them.

A few geometry buckets (users of 12 and of 5 rows), one coordinate update
from zero with residual scores as offsets. Per lane: the same reason (and
iterations for LBFGS and OWLQN), the final value within rtol 1e-4; per
entity the coefficients within atol 1e-3 and the training scores within
atol 1e-3; variances within rtol 1e-4 (tests/test_game.py:309-347). TRON and
NEWTON stop at tolerance 1e-3, as tests/test_torch_newton.py does: at
tighter tolerances a lane's last decision follows float32 rounding, which
the two packages' sums (in different orders) make differently. NEWTON in a
box stops at 1e-2: a lane pinned at a bound gains next to nothing after its
second step, and whether its third step's projected candidates still lower
the value (FunctionValuesConverged) or not (ObjectiveNotImproving) follows
the rounding of the sums.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.game.coordinates as j_coordinates
from photon_ml_tpu.game import build_game_dataset as j_build
from photon_ml_tpu.game import build_random_effect_dataset as j_build_re
from photon_ml_tpu.game.coordinates import RandomEffectCoordinate as JRECoordinate
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import OptimizerType as JOptType
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu_torch.game import (
    FeatureShard,
    RandomEffectCoordinate,
    build_game_dataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game import random_effect_data as t_red
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)

USERS, D = 24, 16
BOX = ((0, -0.2, 0.2), (3, -0.1, 0.3))


def _data(seed=3):
    """Half the users with 12 rows, half with 5; a sparse shard of D
    features; labels from a planted per-user model; residual scores."""
    rng = np.random.default_rng(seed)
    users = np.concatenate([np.repeat(np.arange(USERS // 2), 12),
                            np.repeat(np.arange(USERS // 2, USERS), 5)])
    n = len(users)
    X = rng.normal(size=(n, D)) * (rng.random((n, D)) < 0.35)
    X[:, 0] = 1.0  # every entity sees global feature 0
    w = rng.normal(size=(USERS, D)) * 0.7
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-np.einsum("ij,ij->i", X, w[users])))) * 1.0
    ids = np.array([f"u{u:02d}" for u in users])
    residual = (rng.normal(size=n) * 0.3).astype(np.float32)
    return X, y, ids, residual


def _configs(kind, box=None, **kw):
    """(JAX config, port config) of an optimizer kind, regularization weight 1."""
    name = kind.split("_")[0]
    tol = 1e-2 if kind == "newton_box" else 1e-3 if name in ("tron", "newton") else 1e-5
    base = dict(max_iterations=15, tolerance=tol, regularization_weight=1.0,
                box_constraints=box, **kw)
    reg = "elastic_net" if name == "owlqn" else "l2"
    j_type = {"tron": JOptType.TRON, "newton": JOptType.NEWTON}.get(name, JOptType.LBFGS)
    t_type = {"tron": OptimizerType.TRON, "newton": OptimizerType.NEWTON}.get(
        name, OptimizerType.LBFGS)
    return (JOpt(optimizer_type=j_type, regularization=JReg(JRegType(reg), alpha=0.5), **base),
            OptimizerConfig(optimizer_type=t_type, regularization=RegularizationContext(
                RegularizationType(reg), alpha=0.5), **base))


@pytest.fixture(scope="module", params=["dense", "coo"])
def layout(request):
    """Both packages' datasets, built after routing every bucket to the
    layout (the COO one by patching the routing rule in both)."""
    X, y, ids, residual = _data()
    patch = pytest.MonkeyPatch()
    if request.param == "coo":
        patch.setattr(j_coordinates, "_bucket_dense_design", lambda b: None)
        patch.setattr(t_red, "_bucket_dense_design", lambda b: None)
    jds = j_build(response=y, feature_shards={"s": JSparse.from_dense(X, y)},
                  id_columns={"userId": ids})
    tds = build_game_dataset(y, {"s": FeatureShard.from_dense(X)}, id_columns={"userId": ids},
                             device="cpu")
    jred, tred = j_build_re(jds, "userId", "s"), build_random_effect_dataset(tds, "userId", "s")
    jred.dense_designs(), tred.dense_designs()
    yield request.param, jds, tds, jred, tred, residual
    patch.undo()


def _update_both(layout, kind, compute_variances=False, box=None):
    name, jds, tds, jred, tred, residual = layout
    jcfg, tcfg = _configs(kind, box)
    jc = JRECoordinate("re", jds, jred, "logistic", jcfg, compute_variances=compute_variances)
    tc = RandomEffectCoordinate("re", tds, tred, "logistic", tcfg,
                                compute_variances=compute_variances)
    jm = jc.update_model(jc.initialize_model(), jnp.asarray(residual))
    tm = tc.update_model(tc.initialize_model(), torch.from_numpy(residual))
    want = t_red.CooBucket if name == "coo" else t_red.DenseBucket
    assert all(isinstance(b, want) for b in tc._buckets)
    return jc, tc, jm, tm


def _assert_lanes(jc, tc, jm, tm, same_iterations):
    reasons = np.concatenate([r.reason.numpy() for r in tc.last_results])
    np.testing.assert_array_equal(reasons, np.asarray(jc.last_tracker.reasons))
    if same_iterations:
        iterations = np.concatenate([r.iterations.numpy() for r in tc.last_results])
        np.testing.assert_array_equal(iterations, np.asarray(jc.last_tracker.iterations))
    values = np.concatenate([r.value.numpy() for r in tc.last_results])
    np.testing.assert_allclose(values, np.asarray(jc.last_tracker.final_values), rtol=1e-4)
    for jb, tb in zip(jm.buckets, tm.buckets):
        np.testing.assert_allclose(tb.coefficients.numpy(), np.asarray(jb.coefficients),
                                   atol=1e-3)
    n = tc.data.num_rows
    np.testing.assert_allclose(tc.score(tm).numpy(), np.asarray(jc.score(jm))[:n], atol=1e-3)


@pytest.mark.parametrize("kind", ["lbfgs", "owlqn", "tron", "newton"])
def test_each_optimizer_matches_the_reference(layout, kind):
    jc, tc, jm, tm = _update_both(layout, kind)
    _assert_lanes(jc, tc, jm, tm, same_iterations=kind in ("lbfgs", "owlqn"))


def test_variances_match_the_reference(layout):
    jc, tc, jm, tm = _update_both(layout, "lbfgs", compute_variances=True)
    _assert_lanes(jc, tc, jm, tm, same_iterations=True)
    for jb, tb in zip(jm.buckets, tm.buckets):
        assert bool((tb.variances > 0).all())
        np.testing.assert_allclose(tb.variances.numpy(), np.asarray(jb.variances), rtol=1e-4)


@pytest.mark.parametrize("kind", ["lbfgs_box", "newton_box"])
def test_box_constraints_match_the_reference_and_hold(layout, kind):
    jc, tc, jm, tm = _update_both(layout, kind, box=BOX)
    _assert_lanes(jc, tc, jm, tm, same_iterations=kind == "lbfgs_box")
    lower, upper = tc.config.dense_box_bounds(D, sentinel=True)
    bounded = 0
    for hb, tb in zip(tc.re_data.buckets, tm.buckets):
        w = tb.coefficients.numpy()
        assert np.all(w >= lower[hb.projection]) and np.all(w <= upper[hb.projection])
        bounded += int(np.isfinite(lower[hb.projection]).sum())
    assert bounded >= USERS  # feature 0 of every entity, and feature 3 where seen


def test_variances_need_a_twice_differentiable_loss(layout):
    tds, tred = layout[2], layout[4]
    with pytest.raises(ValueError, match="twice-differentiable"):
        RandomEffectCoordinate("re", tds, tred, "smoothed_hinge", _configs("lbfgs")[1],
                               compute_variances=True)


def test_the_box_bounds_carry_a_sentinel_slot():
    cfg = dataclasses.replace(_configs("lbfgs")[1], box_constraints=BOX)
    lower, upper = cfg.dense_box_bounds(D, sentinel=True)
    assert lower.shape == (D + 1,) and lower[D] == -np.inf and upper[D] == np.inf
    assert (lower[0], upper[3]) == (-0.2, np.float32(0.3))
    assert cfg.dense_box_bounds(D)[0].shape == (D,)
