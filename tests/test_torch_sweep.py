"""The port's sweeps (``photon_ml_tpu_torch.sweep``) against the JAX
package's, on the CPU: the grid grammar through both packages, ``sweep_glm``
against the JAX ``sweep_glm`` (on ``SparseBatch``, and once on a small
``TiledBatch`` whose vmapped Pallas kernels run in interpret mode),
``path_warm_start``, ``sweep_game`` per coordinate and per lane, the
selection policies, ``GameEstimator.fit_sweep`` and ``fit_grid``, and every
``SweepUnsupportedError``.

Tolerances: a 16-lane sweep's values against the JAX sweep's and against
the port's independent fits rtol 1e-6 (60 LBFGS iterations at tolerance
1e-8, as tests/test_sweep.py's lane parity); sweep_game's coefficients per
lane atol 1e-3 and the validation metrics atol 1e-4 (the two packages sum
in different orders, so each solve's last iterates differ at its noise
level); a lane's validation scores and the fit_grid entries against fit bit
for bit (the same code paths on the same device).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.sweep as jsweep
import photon_ml_tpu_torch.sweep as tsweep
from photon_ml_tpu.game.dataset import build_game_dataset as j_build
from photon_ml_tpu.game.estimator import FixedEffectConfig as JFEConfig
from photon_ml_tpu.game.estimator import GameConfig as JGameConfig
from photon_ml_tpu.game.estimator import RandomEffectConfig as JREConfig
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.ops.tiled import TiledBatch
from photon_ml_tpu.optim.factory import OptimizerConfig as JOpt
from photon_ml_tpu.optim.factory import RegularizationContext as JReg
from photon_ml_tpu.optim.factory import RegularizationType as JRegType
from photon_ml_tpu.testing import generate_game_dataset, generate_glm_problem
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.model_store import load_game_model
from photon_ml_tpu_torch.game import (
    FactoredRandomEffectConfig,
    FeatureShard,
    FixedEffectConfig,
    GameConfig,
    GameEstimator,
    RandomEffectConfig,
    build_game_dataset,
)
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
    solve,
    split_reg_weights,
)
from photon_ml_tpu_torch.sweep import (
    SweepGrid,
    SweepSelectionError,
    SweepUnsupportedError,
    parse_sweep_spec,
    path_warm_start,
    run_selection,
    select_best,
    sweep_game,
    sweep_glm,
)
from photon_ml_tpu_torch.utils.events import (
    OptimizationLogEvent,
    SetupEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)

L2 = RegularizationContext(RegularizationType.L2)
JL2 = JReg(JRegType.L2)
PKGS = {"jax": jsweep, "torch": tsweep}


# -- the grid grammar, through both packages -----------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_grid_log_range_descending(pkg):
    grid = PKGS[pkg].parse_sweep_spec("lambda=1e-4:1e2:log16")
    assert grid.size == 16
    lams = grid.default
    assert lams[0] == pytest.approx(100.0) and lams[-1] == pytest.approx(1e-4)
    assert all(a > b for a, b in zip(lams, lams[1:]))


@pytest.mark.parametrize("pkg", PKGS)
def test_grid_lin_range_and_explicit_list(pkg):
    parse = PKGS[pkg].parse_sweep_spec
    assert parse("lambda=0:2:lin3").default == (2.0, 1.0, 0.0)
    assert parse("lambda=0.1,10,1").default == (10.0, 1.0, 0.1)


@pytest.mark.parametrize("pkg", PKGS)
def test_grid_per_coordinate_override_and_broadcast(pkg):
    grid = PKGS[pkg].parse_sweep_spec(["lambda=1:100:log3", "lambda.perUser=5"])
    assert grid.size == 3
    assert grid.for_coordinate("fixed") == grid.default
    assert grid.for_coordinate("perUser") == (5.0, 5.0, 5.0)
    assert grid.to_json() == jsweep.parse_sweep_spec(
        ["lambda=1:100:log3", "lambda.perUser=5"]).to_json()


@pytest.mark.parametrize("pkg", PKGS)
def test_grid_duplicates_removed(pkg):
    assert PKGS[pkg].parse_sweep_spec("lambda=1,1,2").default == (2.0, 1.0)


MALFORMED = [
    ("lambda=", "empty grid"),
    ("lambda", "expected"),
    ("lambda=10:1:log4", "inverted range"),
    ("lambda=1:10:log0", "zero/negative point count"),
    ("lambda=1:10:lin-2", "zero/negative point count"),
    ("lambda=-1,2", "negative regularization"),
    ("lambda=1:10:geo4", "must be 'logN' or 'linN'"),
    ("lambda=a,b", "not a number"),
    ("lambda=0:10:log4", "log spacing needs lo > 0"),
    ("gamma=1,2", "unknown key"),
    ("lambda=1:10", "ranges are"),
    ("lambda=nan", "not finite"),
    ("lambda=inf", "not finite"),
]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("spec, match", MALFORMED)
def test_grid_malformed_specs_are_typed_and_name_the_token(pkg, spec, match):
    with pytest.raises(PKGS[pkg].SweepSpecError, match=match) as err:
        PKGS[pkg].parse_sweep_spec(spec)
    assert spec.split("=")[0] in str(err.value)
    with pytest.raises(jsweep.SweepSpecError) as ref:
        jsweep.parse_sweep_spec(spec)
    assert str(err.value) == str(ref.value)


@pytest.mark.parametrize("pkg", PKGS)
def test_grid_mismatched_lengths_rejected(pkg):
    with pytest.raises(PKGS[pkg].SweepSpecError, match="one config-axis length"):
        PKGS[pkg].parse_sweep_spec(["lambda=1,2,3", "lambda.fixed=1,2"])


@pytest.mark.parametrize("pkg", PKGS)
def test_grid_missing_default_for_coordinate(pkg):
    grid = PKGS[pkg].parse_sweep_spec("lambda.fixed=1,2")
    with pytest.raises(PKGS[pkg].SweepSpecError, match="no default"):
        grid.for_coordinate("perUser")


# -- sweep_glm -----------------------------------------------------------------


@pytest.fixture(scope="module")
def glm_problem():
    p = generate_glm_problem("logistic", n=400, d=10, seed=11)
    return p, CSRBatch.from_dense(p.X, p.y, device="cpu")


def _lbfgs(max_iterations, tolerance=1e-7):
    return (JOpt(max_iterations=max_iterations, tolerance=tolerance, regularization=JL2),
            OptimizerConfig(max_iterations=max_iterations, tolerance=tolerance,
                            regularization=L2))


def test_16_lane_parity_with_the_jax_sweep_and_independent_fits(glm_problem):
    """The 16-lane sweep's values against the JAX sweep_glm's on SparseBatch
    and against 16 independent fits of the port, rtol 1e-6."""
    p, batch = glm_problem
    jcfg, tcfg = _lbfgs(60, 1e-8)
    lams = parse_sweep_spec("lambda=1e-3:1e2:log16").default
    res = sweep_glm(batch, "logistic", lams, tcfg, warm_start=False, device="cpu")
    ref = jsweep.sweep_glm(p.batch.device(), "logistic", lams, jcfg, warm_start=False)
    assert res.lambdas == ref.lambdas and res.rounds == ref.rounds == 1
    np.testing.assert_allclose(res.values.numpy(), np.asarray(ref.values), rtol=1e-6)
    single = [float(solve("logistic", batch, dataclasses.replace(tcfg, regularization_weight=lam),
                          torch.zeros(10), device="cpu").value) for lam in res.lambdas]
    np.testing.assert_allclose(res.values.numpy(), single, rtol=1e-6)
    assert res.w.shape == (16, 10)
    assert list(res.data_passes) == [i + 1 for i in res.iterations]


def test_sweep_against_the_vmapped_pallas_kernels():
    """A small TiledBatch: the JAX sweep runs its margins and scatter
    kernels under vmap in interpret mode."""
    p = generate_glm_problem("logistic", n=200, d=12, density=0.5, seed=4)
    jcfg, tcfg = _lbfgs(40, 1e-8)
    lams = (10.0, 1.0, 0.1, 0.01)
    ref = jsweep.sweep_glm(TiledBatch.from_dense(p.X, p.y), "logistic", lams, jcfg,
                           warm_start=False)
    res = sweep_glm(CSRBatch.from_dense(p.X, p.y, device="cpu"), "logistic", lams, tcfg,
                    warm_start=False, device="cpu")
    np.testing.assert_allclose(res.values.numpy(), np.asarray(ref.values), rtol=1e-6)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), atol=1e-3)


@pytest.mark.parametrize("kind", ["tron", "owlqn"])
def test_sweep_lanes_of_tron_and_owlqn_match_independent_fits(glm_problem, kind):
    _, batch = glm_problem
    if kind == "tron":
        cfg = OptimizerConfig(optimizer_type=OptimizerType.TRON, max_iterations=30,
                              tolerance=1e-8, regularization=L2)
    else:
        cfg = OptimizerConfig(max_iterations=60, tolerance=1e-8, regularization=(
            RegularizationContext(RegularizationType.ELASTIC_NET, alpha=0.5)))
    lams = (3.0, 0.3, 0.03)
    res = sweep_glm(batch, "logistic", lams, cfg, warm_start=False, device="cpu")
    single = [float(solve("logistic", batch, dataclasses.replace(cfg, regularization_weight=lam),
                          torch.zeros(10), device="cpu").value) for lam in res.lambdas]
    np.testing.assert_allclose(res.values.numpy(), single, rtol=1e-5)


def test_warm_start_refinement_never_worse(glm_problem):
    _, batch = glm_problem
    _, cfg = _lbfgs(25, 1e-9)
    lams = parse_sweep_spec("lambda=1e-3:10:log8").default
    cold = sweep_glm(batch, "logistic", lams, cfg, warm_start=False, device="cpu")
    warm = sweep_glm(batch, "logistic", lams, cfg, warm_start=True, device="cpu")
    assert warm.rounds == 2
    assert np.all(warm.values.numpy() <= cold.values.numpy() + 1e-5)


def test_lambdas_sorted_descending_whatever_the_input_order(glm_problem):
    _, batch = glm_problem
    res = sweep_glm(batch, "logistic", (0.1, 10.0, 1.0), _lbfgs(5)[1], device="cpu")
    assert res.lambdas == (10.0, 1.0, 0.1)
    assert res.size == 3 and len(res.reason_names()) == 3


def test_path_warm_start_masks_converged_lanes():
    w = [[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]
    reasons = [1, 3, 1]  # lane 1 converged; lanes 0 and 2 hit MaxIterations
    out = path_warm_start(torch.tensor(w), torch.tensor(reasons, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), [[1.0, 1.0], [2.0, 2.0], [2.0, 2.0]])
    ref = jsweep.path_warm_start(jnp.asarray(w), jnp.asarray(reasons, jnp.int32))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    tables = torch.arange(12.0).reshape(3, 2, 2)  # [G, E, K] tables of a bucket
    out = path_warm_start(tables, torch.tensor([0, 4, 2], dtype=torch.int32))
    assert torch.equal(out[0], tables[0]) and torch.equal(out[2], tables[2])


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_sweep_glm_on_a_mesh_matches_the_meshless_sweep(glm_problem, warm):
    """tests/test_sweep.py:206-235 on the port: G = 3 lanes over a ``model``
    axis of 8 repeated CPU devices (5 pad lanes, dropped), values within
    rtol 1e-5 and w within atol 1e-3 of the meshless sweep and of the JAX
    package's meshless sweep; with the warm start's second round too."""
    from photon_ml_tpu_torch.parallel import make_mesh

    p, batch = glm_problem
    jcfg, cfg = _lbfgs(20, 1e-8)
    lams = (10.0, 1.0, 0.1)
    plain = sweep_glm(batch, "logistic", lams, cfg, warm_start=warm, device="cpu")
    mesh = make_mesh({"model": 8}, [torch.device("cpu")] * 8)
    sharded = sweep_glm(batch, "logistic", lams, cfg, warm_start=warm, mesh=mesh, device="cpu")
    assert sharded.size == 3 and sharded.w.shape == (3, 10) and sharded.rounds == plain.rounds
    assert len(sharded.iterations) == 3 and len(sharded.data_passes) == 3
    np.testing.assert_allclose(sharded.values.numpy(), plain.values.numpy(), rtol=1e-5)
    np.testing.assert_allclose(sharded.w.numpy(), plain.w.numpy(), atol=1e-3)
    ref = jsweep.sweep_glm(p.batch.device(), "logistic", lams, jcfg, warm_start=warm)
    np.testing.assert_allclose(sharded.values.numpy(), np.asarray(ref.values), rtol=1e-5)
    np.testing.assert_allclose(sharded.w.numpy(), np.asarray(ref.w), atol=1e-3)


def test_sweep_glm_refusals(glm_problem):
    p, batch = glm_problem
    cfg = _lbfgs(5)[1]
    with pytest.raises(ValueError, match="non-empty"):
        sweep_glm(batch, "logistic", (), cfg, device="cpu")
    # a mesh is ported (test_sweep_glm_on_a_mesh_matches_the_meshless_sweep);
    # one with neither a model nor a batch axis leaves the lanes on one device
    from photon_ml_tpu_torch.parallel import make_mesh

    other = make_mesh({"x": 2}, [torch.device("cpu")] * 2)
    np.testing.assert_array_equal(
        sweep_glm(batch, "logistic", (1.0,), cfg, mesh=other, device="cpu").w.numpy(),
        sweep_glm(batch, "logistic", (1.0,), cfg, device="cpu").w.numpy())
    with pytest.raises(TypeError, match="CSRBatch"):
        sweep_glm(p.batch, "logistic", (1.0,), cfg, device="cpu")
    with pytest.raises(ValueError, match="rounds"):
        sweep_glm(batch, "logistic", (1.0,), cfg, rounds=0, device="cpu")


def test_split_reg_weights_shapes():
    l2s, l1s = split_reg_weights(L2, (1.0, 0.5))
    np.testing.assert_allclose(l2s.numpy(), [1.0, 0.5])
    np.testing.assert_allclose(l1s.numpy(), [0.0, 0.0])
    l2s, l1s = split_reg_weights(RegularizationContext(RegularizationType.NONE), (1.0, 0.5, 2.0))
    assert l2s.shape == l1s.shape == (3,)


# -- the GAME sweep ----------------------------------------------------------


def _split(n_users=10, rows_per_user=16, fe_dim=6, re_dim=4, seed=5):
    """tests/test_sweep.py's planted GLMix world, every fourth row held out,
    as datasets of both packages."""
    data, truth = generate_game_dataset(n_users=n_users, rows_per_user=rows_per_user,
                                        fe_dim=fe_dim, re_dim=re_dim, seed=seed)
    val_mask = np.arange(data.num_rows) % 4 == 3

    def subsets(mask):
        idx = np.nonzero(mask)[0]
        y, Xg, Xu, users = data.response[idx], truth["Xg"][idx], truth["Xu"][idx], \
            truth["users"][idx]
        j = j_build(response=y, feature_shards={"global": JSparse.from_dense(Xg, y),
                                                "user": JSparse.from_dense(Xu, y)},
                    id_columns={"userId": users})
        t = build_game_dataset(response=y, feature_shards={
            "global": FeatureShard.from_dense(Xg), "user": FeatureShard.from_dense(Xu)},
            id_columns={"userId": users}, device="cpu")
        return j, t

    (jtr, ttr), (jva, tva) = subsets(~val_mask), subsets(val_mask)
    return jtr, ttr, jva, tva


@pytest.fixture(scope="module")
def game_split():
    return _split()


def _game_configs(num_iterations=2, max_iterations=30, tolerance=1e-7):
    def jopt():
        return JOpt(max_iterations=max_iterations, tolerance=tolerance, regularization=JL2)

    def topt():
        return OptimizerConfig(max_iterations=max_iterations, tolerance=tolerance,
                               regularization=L2)

    jcfg = JGameConfig(task="logistic", num_iterations=num_iterations, evaluators=("auc",),
                       coordinates={
                           "fixed": JFEConfig(shard_name="global", optimizer=jopt()),
                           "perUser": JREConfig(shard_name="user", id_name="userId",
                                                optimizer=jopt())})
    tcfg = GameConfig(task="logistic", num_iterations=num_iterations, evaluators=("auc",),
                      coordinates={
                          "fixed": FixedEffectConfig(shard_name="global", optimizer=topt()),
                          "perUser": RandomEffectConfig(shard_name="user", id_name="userId",
                                                        optimizer=topt())})
    return jcfg, tcfg


@pytest.mark.parametrize("warm_start", [False, True])
def test_sweep_game_per_coordinate_and_per_lane_matches_jax(game_split, warm_start):
    jtr, ttr, jva, tva = game_split
    jcfg, tcfg = _game_configs(tolerance=1e-9)
    grid = "lambda=0.03:30:log4"
    ref = jsweep.sweep_game(jcfg, jtr, jsweep.parse_sweep_spec(grid), warm_start=warm_start)
    res = sweep_game(tcfg, ttr, parse_sweep_spec(grid), warm_start=warm_start, device="cpu")
    assert res.size == ref.size == 4 and res.lambdas == ref.lambdas
    for g in range(4):
        jm, tm = ref.model_for(g), res.model_for(g)
        np.testing.assert_allclose(tm.models["fixed"].coefficients.numpy(),
                                   np.asarray(jm.models["fixed"].coefficients), atol=1e-3)
        for jb, tb in zip(jm.models["perUser"].buckets, tm.models["perUser"].buckets):
            np.testing.assert_allclose(tb.coefficients.numpy(), np.asarray(jb.coefficients),
                                       atol=1e-3)
            np.testing.assert_array_equal(tb.projection.numpy(), np.asarray(jb.projection))
    for name in ("fixed", "perUser"):
        np.testing.assert_allclose(res.convergence()[name]["values"],
                                   ref.convergence()[name]["values"], rtol=1e-4)
    np.testing.assert_allclose(run_selection(res, tva).metrics,
                               jsweep.run_selection(ref, jva).metrics, atol=1e-4)


def test_per_coordinate_lambdas_and_convergence(game_split):
    _, ttr, _, _ = game_split
    grid = parse_sweep_spec(["lambda=0.1:10:log3", "lambda.perUser=1"])
    result = sweep_game(_game_configs(num_iterations=1)[1], ttr, grid, device="cpu")
    assert result.size == 3
    assert result.lambdas["fixed"] == grid.default
    assert result.lambdas["perUser"] == (1.0, 1.0, 1.0)
    conv = result.convergence()
    for name in ("fixed", "perUser"):
        assert conv[name]["iterations"].shape == (3,)
        assert np.all(conv[name]["values"] > 0)
    assert [h["coordinate"] for h in result.history] == ["fixed", "perUser"]
    assert result.convergence() is conv  # fetched once and cached


def test_winning_lane_matches_estimator_fit(game_split):
    """A one-lane sweep at λ = 1 against GameEstimator.fit at λ = 1 (the same
    CD schedule, no warm start)."""
    _, ttr, _, _ = game_split
    _, tcfg = _game_configs()
    result = sweep_game(tcfg, ttr, SweepGrid(default=(1.0,)), warm_start=False, device="cpu")
    model = result.model_for(0)
    fit = GameEstimator(_with_lambda(tcfg, 1.0)).fit(ttr, device="cpu")
    np.testing.assert_allclose(model.models["fixed"].coefficients.numpy(),
                               fit.model.models["fixed"].coefficients.numpy(), atol=5e-3)
    np.testing.assert_allclose(model.score(ttr).numpy(), fit.model.score(ttr).numpy(),
                               atol=5e-3)


def _with_lambda(cfg, lam):
    return dataclasses.replace(cfg, coordinates={
        name: dataclasses.replace(c, optimizer=dataclasses.replace(
            c.optimizer, regularization_weight=lam)) for name, c in cfg.coordinates.items()})


def test_validation_scores_match_per_lane_model_score(game_split):
    _, ttr, _, tva = game_split
    result = sweep_game(_game_configs(num_iterations=1)[1], ttr,
                        parse_sweep_spec("lambda=0.1,1,10"), device="cpu")
    scores = result.validation_scores(tva)
    assert scores.shape == (3, tva.num_rows)
    for g in range(3):
        assert torch.equal(scores[g], result.model_for(g).score(tva))


def test_sweep_game_on_coo_buckets(game_split, monkeypatch):
    """Every bucket forced onto the block-diagonal layout: the lane kernels'
    plain versions over the bucket CSR, against the dense layout."""
    from photon_ml_tpu_torch.game import random_effect_data as t_red

    _, ttr, _, tva = game_split
    grid = parse_sweep_spec("lambda=0.3,3")
    dense = sweep_game(_game_configs(num_iterations=1)[1], ttr, grid, device="cpu")
    jtr, ttr2, _, tva2 = _split()  # fresh datasets: the bucket layouts are cached
    monkeypatch.setattr(t_red, "_bucket_dense_design", lambda b: None)
    coo = sweep_game(_game_configs(num_iterations=1)[1], ttr2, grid, device="cpu")
    for g in range(2):
        np.testing.assert_allclose(coo.validation_scores(tva2)[g].numpy(),
                                   dense.validation_scores(tva)[g].numpy(), atol=1e-4)


def _unsupported_configs():
    opt = OptimizerConfig(max_iterations=5, regularization=L2)
    box = dataclasses.replace(opt, box_constraints=((0, -1.0, 1.0),))
    return [
        ("down-sampling", {"fixed": FixedEffectConfig(
            shard_name="global", optimizer=dataclasses.replace(opt, down_sampling_rate=0.5))}),
        ("box constraints under normalization", {"fixed": FixedEffectConfig(
            shard_name="global", optimizer=box, normalization="standardization",
            intercept_index=0)}),
        ("projector 'random'", {"re": RandomEffectConfig(
            shard_name="user", id_name="userId", optimizer=opt, projector="random",
            projected_dim=2)}),
        ("per-entity box constraints", {"re": RandomEffectConfig(
            shard_name="user", id_name="userId", optimizer=box)}),
        ("passive rows", {"re": RandomEffectConfig(
            shard_name="user", id_name="userId", optimizer=opt, active_rows_per_entity=3)}),
        ("FactoredRandomEffectConfig", {"mf": FactoredRandomEffectConfig(
            shard_name="user", id_name="userId", latent_dim=2)}),
    ]


@pytest.mark.parametrize("match,coordinates", _unsupported_configs(),
                         ids=[m for m, _ in _unsupported_configs()])
def test_unsupported_coordinates_are_typed(game_split, match, coordinates):
    _, ttr, _, _ = game_split
    with pytest.raises(SweepUnsupportedError, match=match):
        sweep_game(GameConfig(task="logistic", coordinates=coordinates), ttr,
                   SweepGrid(default=(1.0,)), device="cpu")


def test_sweep_game_checks_the_device(game_split):
    _, ttr, _, _ = game_split
    with pytest.raises(ValueError, match="unsupported device meta"):
        sweep_game(_game_configs()[1], ttr, SweepGrid(default=(1.0,)), device="meta")


# -- selection -----------------------------------------------------------------


def test_best_policy_prefers_more_regularized_on_tie():
    assert select_best(np.asarray([0.7, 0.7, 0.6]), "auc") == 0


def test_minimizing_metrics_select_min():
    assert select_best(np.asarray([3.0, 1.0, 2.0]), "rmse") == 1


def test_nan_lanes_excluded_with_counter():
    before = telemetry.snapshot()["counters"].get("sweep.nan_configs", 0)
    assert select_best(np.asarray([np.nan, 0.8, 0.9]), "auc") == 2
    assert telemetry.snapshot()["counters"]["sweep.nan_configs"] == before + 1


def test_all_nan_is_typed_error_not_silent_argmax():
    with pytest.raises(SweepSelectionError, match="non-finite"):
        select_best(np.asarray([np.nan, np.nan]), "auc")


def test_parsimonious_policy():
    metrics = np.asarray([0.897, 0.899, 0.9])
    assert select_best(metrics, "auc", policy="parsimonious") == 0
    assert select_best(metrics, "auc", policy="parsimonious", rel_tol=1e-5) == 2


def test_unknown_policy_typed():
    with pytest.raises(SweepSelectionError, match="unknown selection"):
        select_best(np.asarray([0.5]), "auc", policy="magic")


def test_sharded_metric_spec_rejected(game_split):
    _, ttr, _, tva = game_split
    result = sweep_game(_game_configs(num_iterations=1)[1], ttr, SweepGrid(default=(1.0,)),
                        device="cpu")
    with pytest.raises(SweepSelectionError, match="auc:queryid"):
        run_selection(result, tva, metric="auc:queryid")


def test_single_class_validation_degrades_to_half_auc(game_split):
    _, ttr, _, tva = game_split
    one_class = build_game_dataset(response=np.ones(tva.num_rows),
                                   feature_shards=dict(tva.feature_shards),
                                   id_columns=dict(tva.id_columns), device="cpu")
    result = sweep_game(_game_configs(num_iterations=1)[1], ttr, SweepGrid(default=(0.5, 5.0)),
                        device="cpu")
    selection = run_selection(result, one_class)
    np.testing.assert_allclose(selection.metrics, 0.5, atol=1e-6)
    assert selection.index == 0


def test_export_winner_names_item_14():
    """Publishing is ported (item 14a): without index maps the registry
    refuses the version."""
    with pytest.raises(ValueError, match="index_maps is required"):
        tsweep.export_winner(None, None, "r")


# -- the estimator -------------------------------------------------------------


def test_fit_sweep_saves_best(game_split, tmp_path):
    _, ttr, _, tva = game_split
    est = GameEstimator(_game_configs(num_iterations=1)[1])
    out = est.fit_sweep(ttr, tva, parse_sweep_spec("lambda=0.1,1"),
                        output_dir=str(tmp_path / "model"), device="cpu")
    assert out.published_version is None and out.selection.metric == "auc"
    loaded = load_game_model(str(tmp_path / "model" / "best"), device="cpu")
    assert torch.equal(loaded.score(tva), out.model.score(tva))
    assert torch.equal(out.model.score(tva), out.sweep.model_for(out.selection.index).score(tva))


def test_fit_sweep_threads_rel_tol_to_parsimonious_policy(game_split):
    _, ttr, _, tva = game_split
    out = GameEstimator(_game_configs(num_iterations=1)[1]).fit_sweep(
        ttr, tva, parse_sweep_spec("lambda=0.01,0.1,1,10"), policy="parsimonious",
        rel_tol=10.0, device="cpu")
    assert out.selection.index == 0 and out.selection.policy == "parsimonious"


def test_fit_sweep_refuses_a_registry(game_split, tmp_path):
    """A registry without index maps: the winner would not pin its feature
    space, so it is refused before the sweep runs."""
    _, ttr, _, tva = game_split
    with pytest.raises(ValueError, match="registry requires index_maps"):
        GameEstimator(_game_configs()[1]).fit_sweep(
            ttr, tva, SweepGrid(default=(1.0,)), registry_dir=str(tmp_path), device="cpu")


def test_fit_grid_is_best_first_and_each_entry_is_the_fit_of_its_combination(game_split):
    _, ttr, _, tva = game_split
    _, tcfg = _game_configs(num_iterations=1)
    fe = tcfg.coordinates["fixed"].optimizer
    combos = [dataclasses.replace(fe, regularization_weight=lam) for lam in (1.0, 10.0)]
    est = GameEstimator(tcfg)
    events = []
    est.events.register(events.append)
    entries = est.fit_grid(ttr, tva, {"fixed": combos}, device="cpu")
    metrics = [e.result.best_metric for e in entries]
    assert metrics == sorted(metrics, reverse=True)  # auc: best first
    kinds = [type(e) for e in events]
    assert kinds.count(SetupEvent) == 1 and kinds.count(TrainingStartEvent) == 2
    assert kinds.count(TrainingFinishEvent) == 2 and kinds.count(OptimizationLogEvent) == 4
    for e in entries:
        cfg = dataclasses.replace(tcfg, coordinates={
            **tcfg.coordinates,
            "fixed": dataclasses.replace(tcfg.coordinates["fixed"],
                                         optimizer=e.optimizer_configs["fixed"])})
        fit = GameEstimator(cfg).fit(ttr, validation_data=tva, device="cpu")
        assert e.result.best_metric == fit.best_metric
        assert torch.equal(e.result.model.score(tva), fit.model.score(tva))


def test_fit_grid_refusals(game_split):
    _, ttr, _, tva = game_split
    _, tcfg = _game_configs(num_iterations=1)
    with pytest.raises(ValueError, match="unknown coordinates"):
        GameEstimator(tcfg).fit_grid(ttr, tva, {"nope": []}, device="cpu")
    with pytest.raises(ValueError, match="needs evaluators"):
        GameEstimator(dataclasses.replace(tcfg, evaluators=())).fit_grid(ttr, tva, {},
                                                                         device="cpu")


def test_fit_sweep_publishes_the_winner_to_a_registry(game_split, tmp_path):
    """``fit_sweep(registry_dir=, index_maps=)`` publishes the winner; the
    version reloads bit for bit and serves through the port's engine."""
    from photon_ml_tpu_torch.serving import ScoringEngine

    _, ttr, _, tva = game_split
    maps = {"global": [f"g{j}" for j in range(6)], "user": [f"u{j}" for j in range(4)]}
    out = GameEstimator(_game_configs(num_iterations=1)[1]).fit_sweep(
        ttr, tva, parse_sweep_spec("lambda=0.1,1"), registry_dir=str(tmp_path / "r"),
        index_maps=maps, device="cpu")
    assert out.published_version == str(tmp_path / "r" / "v-00000001")
    loaded = load_game_model(out.published_version, device="cpu")
    assert torch.equal(loaded.score(tva), out.model.score(tva))
    engine = ScoringEngine.load(out.published_version, device="cpu")
    assert engine.version == "v-00000001"
    assert engine.index_maps["global"].names[:2] == ["g0", "g1"]
