"""The port's incremental refresh (``photon_ml_tpu_torch.incremental``,
``GameEstimator.fit_incremental``, ``cli refresh`` and ``cli train
--warm-start``) against the JAX package's, case for case with
tests/test_incremental.py, from the same numpy draws (JAX on the CPU, the
port with ``device="cpu"``):

- warm-start kinds (step, model, streaming) and their typed errors, the
  lineage (step, digest) the JAX package's;
- the spine: a base fit with a checkpoint a step, a ~5% delta, the
  refresh over the combined data: untouched random-effect rows bit for bit
  the base's, touched and new rows solved again and within the GLMix fit
  tolerance of the JAX package's refresh, the AUC within 0.02 of a fit from
  scratch; lanes solved and skipped, bucket solves and skips,
  ``new_entities``, the touched and new codes and the digest equal to the
  JAX package's;
- the checkpoint-into-base refusal, the local λ sweep (its selection the
  JAX package's) and its typed error without validation data, an entity
  absent from both the base and the delta;
- ``grow_entity_rows``, also over a ``model`` mesh of four CPU devices;
- the streamed delta scan against the JAX package's in-core scan, and the
  streamed loop end to end;
- the masked factored coordinate (touched rows within 1e-3 of a full
  re-solve), the factored dimension mismatch;
- the stale-delta refusal, the fault seams, the publish lineage on
  ``/healthz``, ``cli refresh`` end to end (its lineage the JAX package's,
  less its paths), a crash at publish leaving base and registry intact, the
  stale refusal and ``--force``;
- a COO case: the per-user bucket forced onto the COO layout (LBFGS and
  TRON), untouched rows bit for bit, touched rows against the JAX package's;
- a mesh case: ``fit_incremental(mesh=...)`` over a ``model`` axis of four
  against the unsharded refresh, untouched rows bit for bit, touched rows
  within rtol/atol 5e-3;
- the masked-lane bootstrap's summaries (``bootstrap_samples``) within 1e-3
  of the JAX package's.

- ``test_freshness_report_round_trip``: the refresh's RunReport Freshness
  section, its counts, touched fraction and lineage the JAX package's;
  ``cli refresh --report-out`` in ``test_cli_refresh_end_to_end``.

Left out: ``test_bench_freshness_budget_truncation`` (the port's benchmark is a PR of
its own).

Tolerances: fitted coefficients rtol/atol 2e-3 between the packages (a
GLMix fit's random-effect Newton stopping differs at the noise level of a
float32 solve, as in tests/test_torch_game.py); validation AUCs atol 1e-3.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_ml_tpu import incremental as j_inc
from photon_ml_tpu.game import FixedEffectConfig as JFEConfig
from photon_ml_tpu.game import GameConfig as JGameConfig
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JREConfig
from photon_ml_tpu.game import build_game_dataset as j_build
from photon_ml_tpu.game.checkpoint import CheckpointSpec as JCheckpointSpec
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import OptimizerType as JOptType
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu import telemetry as j_telemetry
from photon_ml_tpu.telemetry.report import RunReport as JRunReport
from photon_ml_tpu_torch import incremental, telemetry
from photon_ml_tpu_torch.telemetry.report import RunReport
from photon_ml_tpu_torch.faults import (
    FaultPlan,
    FaultRule,
    InjectedFault,
    clear_plan,
    install_plan,
)
from photon_ml_tpu_torch.game import (
    CheckpointSpec,
    FeatureShard,
    FixedEffectConfig,
    GameConfig,
    GameEstimator,
    RandomEffectConfig,
    build_game_dataset,
)
from photon_ml_tpu_torch.game import random_effect_data as t_red
from photon_ml_tpu_torch.game.coordinate_descent import ValidationSpec, _evaluate
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FIT_TOL = dict(rtol=2e-3, atol=2e-3)
MESH_TOL = dict(rtol=5e-3, atol=5e-3)  # ROADMAP Queue 3 item 5: a mesh fit's tolerance

_D = 8
_N_USERS = 40
_TOUCHED = (3, 17)  # base users the delta touches; plus one new user


def _build(Xm, us, ys):
    """The same rows as a JAX dataset and a port dataset."""
    ids = np.array([f"u{u:03d}" for u in us])
    r, c = np.nonzero(Xm)
    jds = j_build(response=ys, feature_shards={"g": JSparse.from_coo(
        values=Xm[r, c], rows=r, cols=c, labels=ys, num_features=_D)},
        id_columns={"userId": ids})
    tds = build_game_dataset(response=ys, feature_shards={"g": FeatureShard.from_coo(
        Xm[r, c], r, c, _D)}, id_columns={"userId": ids}, device="cpu")
    return jds, tds


def _opts(**kw):
    base = dict(max_iterations=50, tolerance=1e-8, regularization_weight=1.0)
    base.update(kw)
    kind = base.pop("optimizer_type", None)
    j = JOpt(regularization=JReg(JRegType.L2), **base,
             **({} if kind is None else {"optimizer_type": JOptType[kind]}))
    t = OptimizerConfig(regularization=RegularizationContext(RegularizationType.L2), **base,
                        **({} if kind is None else {"optimizer_type": OptimizerType[kind]}))
    return j, t


def _configs(re_kind=None, **kw):
    jfe, tfe = _opts()
    jre, tre = _opts(**({} if re_kind is None else {"optimizer_type": re_kind}))
    common = dict(task="logistic", num_iterations=2, **{"evaluators": ["auc"], **kw})
    return (JGameConfig(coordinates={
                "fixed": JFEConfig(shard_name="g", optimizer=jfe),
                "perUser": JREConfig(shard_name="g", id_name="userId", optimizer=jre)},
                **common),
            GameConfig(coordinates={
                "fixed": FixedEffectConfig(shard_name="g", optimizer=tfe),
                "perUser": RandomEffectConfig(shard_name="g", id_name="userId",
                                              optimizer=tre)}, **common))


def _entity_coeffs(model, coord="perUser"):
    """entity value -> {global feature id: coefficient}, for either
    package's model (geometry-free: untouched entities keep their geometry,
    so equal dicts are equal rows bit for bit)."""
    re = model.models[coord]
    out = {}
    for bm in re.buckets:
        P = bm.projection.cpu().numpy() if isinstance(bm.projection, torch.Tensor) \
            else np.asarray(bm.projection)
        W = bm.coefficients.cpu().numpy() if isinstance(bm.coefficients, torch.Tensor) \
            else np.asarray(bm.coefficients)
        for e, code in enumerate(np.asarray(bm.entity_codes)):
            out[re.vocab[code]] = {int(g): float(W[e, k]) for k, g in enumerate(P[e])}
    return out


def _close_maps(t_map, j_map, keys, tol=FIT_TOL):
    for val in keys:
        got = np.array([t_map[val][g] for g in sorted(t_map[val])])
        want = np.array([j_map[val][g] for g in sorted(j_map[val])])
        np.testing.assert_allclose(got, want, err_msg=str(val), **tol)


def _counts(res):
    return (res.lanes_solved, res.lanes_skipped, res.bucket_solves, res.buckets_skipped,
            res.new_entities)


@pytest.fixture(autouse=True)
def _clean_plan():
    clear_plan()
    yield
    clear_plan()


def _spine_data(seed=7):
    rng = np.random.default_rng(seed)
    n_base = 2000
    X = rng.normal(size=(n_base, _D))
    users = rng.integers(0, _N_USERS, n_base)
    w = rng.normal(size=_D)
    u_eff = rng.normal(size=_N_USERS + 1) * 0.8

    def make_rows(Xm, us):
        logits = Xm @ w + u_eff[us]
        return (rng.random(len(us)) < 1 / (1 + np.exp(-logits))).astype(float)

    y_base = make_rows(X, users)
    # ~5% delta: 2 touched existing users + 1 new user
    du = np.array(list(_TOUCHED) * 15 + [_N_USERS] * 10)
    Xd = rng.normal(size=(len(du), _D))
    yd = make_rows(Xd, du)
    Xv = rng.normal(size=(800, _D))
    uv = rng.integers(0, _N_USERS, 800)
    yv = make_rows(Xv, uv)
    return dict(base=(X, users, y_base),
                comb=(np.vstack([X, Xd]), np.concatenate([users, du]),
                      np.concatenate([y_base, yd])),
                delta=(Xd, du, yd), val=(Xv, uv, yv))


@pytest.fixture(scope="module")
def glmix(tmp_path_factory):
    """The spine in both packages: base fit with a checkpoint a step, the
    delta scan, the refresh over the combined data, and the fit from
    scratch."""
    tmp = tmp_path_factory.mktemp("incremental")
    arrays = _spine_data()
    (jb, tb), (jc, tc), (jd, td), (jv, tv) = (_build(*arrays[k]) for k in
                                              ("base", "comb", "delta", "val"))
    jcfg, tcfg = _configs()
    out = {"tmp": tmp, "tcfg": tcfg, "jcfg": jcfg, "comb": tc, "delta": td, "val": tv,
           "j_comb": jc, "j_val": jv}
    for pkg in ("j", "t"):
        ckpt = str(tmp / f"{pkg}-ckpt")
        if pkg == "j":
            base_fit = JEstimator(jcfg).fit(jb, validation_data=jv, checkpoint_spec=JCheckpointSpec(
                directory=ckpt, resume=False))
            j_telemetry.reset()
            ws = j_inc.load_warm_start(ckpt)
            scan = j_inc.scan_delta(jd, {"userId": ws.model.models["perUser"].vocab})
            res = JEstimator(jcfg).fit_incremental(jc, ws, delta=scan, validation_data=jv)
            out["j_report"] = JRunReport.from_live()
        else:
            base_fit = GameEstimator(tcfg).fit(tb, validation_data=tv, device="cpu",
                                               checkpoint_spec=CheckpointSpec(directory=ckpt,
                                                                              resume=False))
            telemetry.reset()
            ws = incremental.load_warm_start(ckpt, device="cpu")
            scan = incremental.scan_delta(td, {"userId": ws.model.models["perUser"].vocab})
            res = GameEstimator(tcfg).fit_incremental(tc, ws, delta=scan, validation_data=tv,
                                                      device="cpu")
            out["snap"] = telemetry.snapshot()
            out["report"] = RunReport.from_live()
            out["ref"] = GameEstimator(tcfg).fit(tc, validation_data=tv, device="cpu")
        out.update({f"{pkg}_ckpt": ckpt, f"{pkg}_base": base_fit, f"{pkg}_ws": ws,
                    f"{pkg}_scan": scan, f"{pkg}_res": res})
    return out


# ---------------------------------------------------------------------------
# warm-start loading and lineage
# ---------------------------------------------------------------------------


def test_load_warm_start_step_kind_records_lineage(glmix):
    ws, jws = glmix["t_ws"], glmix["j_ws"]
    assert ws.lineage.kind == "step" == jws.lineage.kind
    assert ws.lineage.step == 3 == jws.lineage.step  # 2 iterations x 2 coordinates - 1
    assert ws.lineage.digest and len(ws.lineage.digest) == 64
    assert ws.model is not None and "perUser" in ws.model.models
    doc = ws.lineage.to_json()
    assert doc["kind"] == "step" and doc["checkpoint_dir"] == os.path.abspath(glmix["t_ckpt"])
    assert set(doc) == set(jws.lineage.to_json())


def test_load_warm_start_model_dir_kind(glmix, tmp_path):
    from photon_ml_tpu.data.model_store import save_game_model as j_save
    from photon_ml_tpu_torch.data.model_store import save_game_model

    save_game_model(glmix["t_base"].model, str(tmp_path / "m"))
    j_save(glmix["j_base"].model, str(tmp_path / "jm"))
    ws = incremental.load_warm_start(str(tmp_path / "m"), device="cpu")
    assert ws.lineage.kind == "model" == j_inc.load_warm_start(str(tmp_path / "jm")).lineage.kind
    assert ws.model.models.keys() == glmix["t_base"].model.models.keys()
    # a model saved by the JAX package warm-starts the port too
    assert incremental.load_warm_start(str(tmp_path / "jm"), device="cpu").model.models.keys() \
        == ws.model.models.keys()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_load_warm_start_bad_dirs_are_typed(tmp_path, pkg):
    load, err = ((lambda d: incremental.load_warm_start(d, device="cpu"),
                  incremental.WarmStartError) if pkg == "torch"
                 else (j_inc.load_warm_start, j_inc.WarmStartError))
    with pytest.raises(err, match="does not exist"):
        load(str(tmp_path / "nope"))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(err, match="nothing to"):
        load(str(empty))


# ---------------------------------------------------------------------------
# the spine
# ---------------------------------------------------------------------------


def test_untouched_lanes_bit_identical_to_base(glmix):
    base_map = _entity_coeffs(glmix["t_base"].model)
    inc_map = _entity_coeffs(glmix["t_res"].model)
    touched_vals = {f"u{u:03d}" for u in _TOUCHED}
    checked = 0
    for val, coeffs in base_map.items():
        if val in touched_vals:
            continue
        checked += 1
        assert inc_map[val] == coeffs, val  # exact: taken, never solved again
    assert checked >= _N_USERS - len(_TOUCHED) - 2
    # the base fits agree across the packages, so the kept rows do too
    _close_maps(base_map, _entity_coeffs(glmix["j_base"].model), base_map)


def test_touched_and_new_lanes_did_resolve(glmix):
    base_map = _entity_coeffs(glmix["t_base"].model)
    inc_map = _entity_coeffs(glmix["t_res"].model)
    j_inc_map = _entity_coeffs(glmix["j_res"].model)
    touched = [f"u{u:03d}" for u in _TOUCHED]
    for val in touched:
        assert any(inc_map[val][g] != wv for g, wv in base_map[val].items()), val
    new_val = f"u{_N_USERS:03d}"
    assert new_val not in base_map
    assert any(abs(v) > 1e-8 for v in inc_map[new_val].values())
    _close_maps(inc_map, j_inc_map, touched + [new_val])
    np.testing.assert_allclose(glmix["t_res"].model.models["fixed"].coefficients.numpy(),
                               np.asarray(glmix["j_res"].model.models["fixed"].coefficients),
                               **FIT_TOL)
    assert glmix["t_res"].new_entities == glmix["j_res"].new_entities >= 1


def test_quality_matches_from_scratch_fit(glmix):
    spec = ValidationSpec(data=glmix["val"], evaluators=["auc"])
    m_inc = _evaluate(glmix["t_res"].model, spec)["auc"]
    m_ref = _evaluate(glmix["ref"].model, spec)["auc"]
    assert abs(m_inc - m_ref) < 0.02, (m_inc, m_ref)
    assert glmix["t_res"].best_metric == pytest.approx(glmix["j_res"].best_metric, abs=1e-3)


def test_structural_speedup_lane_telemetry(glmix):
    res = glmix["t_res"]
    assert res.lanes_solved >= 3
    assert res.lanes_skipped > 10 * res.lanes_solved / 2
    assert res.lanes_solved / (res.lanes_solved + res.lanes_skipped) < 0.2
    assert res.buckets_skipped >= 1 and res.bucket_solves >= 1
    # 2 CD iterations: each pass counts its touched lanes
    assert res.lanes_solved == 2 * 3
    assert _counts(res) == _counts(glmix["j_res"])
    snap = glmix["snap"]["counters"]
    assert snap["incremental.lanes_solved"] == res.lanes_solved
    assert snap["incremental.lanes_skipped"] == res.lanes_skipped
    assert snap["incremental.bucket_solves"] == res.bucket_solves
    assert snap["incremental.buckets_skipped"] == res.buckets_skipped
    assert snap["incremental.warm_restores"] == 1 and snap["incremental.fits"] == 1
    assert glmix["snap"]["gauges"]["incremental.time_to_fresh_s"] == res.seconds > 0
    # the scans agree: touched and new values, digest, rows
    t_cd, j_cd = glmix["t_scan"].for_id("userId"), glmix["j_scan"].for_id("userId")
    np.testing.assert_array_equal(t_cd.touched_values, j_cd.touched_values)
    np.testing.assert_array_equal(t_cd.new_values, j_cd.new_values)
    assert glmix["t_scan"].to_json() == glmix["j_scan"].to_json()


def test_freshness_report_round_trip(glmix):
    """tests/test_incremental.py::test_freshness_report_round_trip, and the
    section's numbers against the JAX package's report of its refresh."""
    report, j_report = glmix["report"], glmix["j_report"]
    fresh = report.freshness_summary()
    assert fresh is not None
    assert fresh["lanes_solved"] >= 3
    assert fresh["lanes_skipped"] > 0
    assert 0 < fresh["lanes_solved_fraction"] < 0.5
    assert fresh["touched_fraction"] == pytest.approx(3 / 41, abs=0.05)
    md = report.to_markdown()
    assert "## Freshness" in md
    assert "kept bit-identical" in md
    doc = report.to_json()
    assert doc["freshness"]["lanes_solved"] == fresh["lanes_solved"]
    assert "time_to_fresh_s" in report.key_metrics()
    j_fresh = j_report.freshness_summary()
    for key in ("lanes_solved", "lanes_skipped", "bucket_solves", "buckets_skipped",
                "touched_entities", "warm_restores", "fits", "touched_fraction",
                "touched_fraction_by_coordinate", "lanes_solved_fraction"):
        assert fresh[key] == j_fresh[key], key
    for key in ("kind", "base_step", "delta_digest", "delta_rows", "touched_fraction"):
        assert fresh["base"][key] == j_fresh["base"][key], key


def test_incremental_refuses_checkpointing_into_its_base(glmix):
    with pytest.raises(incremental.WarmStartError, match="base"):
        GameEstimator(glmix["tcfg"]).fit_incremental(
            glmix["comb"], glmix["t_ws"], delta=glmix["t_scan"], device="cpu",
            checkpoint_spec=CheckpointSpec(directory=glmix["t_ckpt"]))
    with pytest.raises(j_inc.WarmStartError, match="base"):
        JEstimator(glmix["jcfg"]).fit_incremental(
            glmix["j_comb"], glmix["j_ws"], delta=glmix["j_scan"],
            checkpoint_spec=JCheckpointSpec(directory=glmix["j_ckpt"]))


def test_local_lambda_sweep_selects_with_policies(glmix):
    factors = incremental.local_lambda_factors(points=3, span=4.0)
    assert factors == [4.0, 1.0, 0.25] == j_inc.local_lambda_factors(points=3, span=4.0)
    kw = dict(lambda_factors=factors, policy="parsimonious", rel_tol=0.05)
    res = GameEstimator(glmix["tcfg"]).fit_incremental(
        glmix["comb"], glmix["t_ws"], delta=glmix["t_scan"], validation_data=glmix["val"],
        device="cpu", **kw)
    jres = JEstimator(glmix["jcfg"]).fit_incremental(
        glmix["j_comb"], glmix["j_ws"], delta=glmix["j_scan"], validation_data=glmix["j_val"],
        **kw)
    sel, jsel = res.selection, jres.selection
    assert sel is not None and sel.policy == "parsimonious" and sel.metric == "auc"
    assert len(sel.metrics) == 3 and np.isfinite(sel.metrics).all()
    assert sel.index <= int(np.nanargmax(sel.metrics))
    np.testing.assert_allclose(sel.metrics, jsel.metrics, atol=1e-3)
    assert sel.index == jsel.index
    assert _counts(res) == _counts(jres)
    base_map = _entity_coeffs(glmix["t_base"].model)
    inc_map = _entity_coeffs(res.model)
    for u in set(range(_N_USERS)) - set(_TOUCHED):
        val = f"u{u:03d}"
        if val in base_map:
            assert inc_map[val] == base_map[val], val


def test_entity_absent_from_base_and_delta_still_resolves(tmp_path):
    rng = np.random.default_rng(21)
    n = 400
    X = rng.normal(size=(n, _D))
    users = rng.integers(0, 3, n)  # u000..u002
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ rng.normal(size=_D))))).astype(float)
    base_sel = users != 2  # the base window never saw u002
    jb, tb = _build(X[base_sel], users[base_sel], y[base_sel])
    jc, tc = _build(X, users, y)
    delta_sel = users == 1  # the delta only touches u001
    jd, td = _build(X[delta_sel][:20], users[delta_sel][:20], y[delta_sel][:20])
    jcfg, tcfg = _configs()
    GameEstimator(tcfg).fit(tb, device="cpu", checkpoint_spec=CheckpointSpec(
        directory=str(tmp_path / "t"), resume=False))
    JEstimator(jcfg).fit(jb, checkpoint_spec=JCheckpointSpec(directory=str(tmp_path / "j"),
                                                             resume=False))
    ws = incremental.load_warm_start(str(tmp_path / "t"), device="cpu")
    jws = j_inc.load_warm_start(str(tmp_path / "j"))
    res = GameEstimator(tcfg).fit_incremental(tc, ws, delta=incremental.scan_delta(
        td, {"userId": ws.model.models["perUser"].vocab}), device="cpu")
    jres = JEstimator(jcfg).fit_incremental(jc, jws, delta=j_inc.scan_delta(
        jd, {"userId": jws.model.models["perUser"].vocab}))
    inc_map = _entity_coeffs(res.model)
    assert any(abs(v) > 1e-8 for v in inc_map["u002"].values())
    assert res.new_entities == jres.new_entities >= 1
    assert _counts(res) == _counts(jres)
    base_map = _entity_coeffs(incremental.load_warm_start(str(tmp_path / "t"),
                                                          device="cpu").model)
    assert inc_map["u000"] == base_map["u000"]
    _close_maps(inc_map, _entity_coeffs(jres.model), ["u001", "u002"])


def test_lambda_sweep_without_validation_is_typed(glmix):
    with pytest.raises(ValueError, match="validation"):
        GameEstimator(glmix["tcfg"]).fit_incremental(
            glmix["comb"], glmix["t_ws"], delta=glmix["t_scan"], lambda_factors=[4.0, 1.0],
            device="cpu")
    with pytest.raises(ValueError, match="validation"):
        JEstimator(glmix["jcfg"]).fit_incremental(
            glmix["j_comb"], glmix["j_ws"], delta=glmix["j_scan"], lambda_factors=[4.0, 1.0])


# ---------------------------------------------------------------------------
# streaming warm starts and vocabulary growth
# ---------------------------------------------------------------------------


def test_streaming_warm_start_restores_table(tmp_path):
    import jax.numpy as jnp

    from photon_ml_tpu.game.checkpoint import StreamCheckpointState as JState
    from photon_ml_tpu.game.checkpoint import StreamingCheckpointManager as JManager
    from photon_ml_tpu_torch.game.checkpoint import (
        StreamCheckpointState,
        StreamingCheckpointManager,
    )

    table = np.arange(48, dtype=np.float32).reshape(16, 3)
    StreamingCheckpointManager(CheckpointSpec(directory=str(tmp_path / "s"), resume=False)
                               ).save(StreamCheckpointState(next_chunk=5,
                                                            coefficients=torch.from_numpy(table)))
    JManager(JCheckpointSpec(directory=str(tmp_path / "j"), resume=False)).save(
        JState(next_chunk=5, coefficients=jnp.asarray(table)))
    for directory in ("s", "j"):  # the port restores either package's checkpoint
        ws = incremental.load_warm_start(str(tmp_path / directory), device="cpu")
        assert ws.lineage.kind == "streaming"
        assert ws.lineage.next_chunk == 5 and ws.next_chunk == 5
        assert ws.model is None and ws.table is not None
        np.testing.assert_array_equal(ws.table.to_numpy(), table)
    jws = j_inc.load_warm_start(str(tmp_path / "s"))
    assert jws.lineage.to_json().keys() == ws.lineage.to_json().keys()
    _, tcfg = _configs()
    _, tds = _build(np.zeros((4, _D)), [0, 1, 2, 3], np.array([0.0, 1, 0, 1]))
    with pytest.raises(incremental.WarmStartError, match="bare"):
        GameEstimator(tcfg).fit_incremental(tds, ws, device="cpu")


def test_grow_entity_rows_zero_init_and_bit_identical():
    import jax.numpy as jnp

    table = np.arange(30, dtype=np.float32).reshape(10, 3)
    grown = incremental.grow_entity_rows(torch.from_numpy(table), 14)
    assert tuple(grown.shape) == (14, 3)
    np.testing.assert_array_equal(grown.numpy(), np.asarray(
        j_inc.grow_entity_rows(jnp.asarray(table), 14)))
    np.testing.assert_array_equal(grown.numpy()[:10], table)
    assert not grown.numpy()[10:].any()
    with pytest.raises(incremental.WarmStartError, match="shrink"):
        incremental.grow_entity_rows(torch.from_numpy(table), 8)


def test_grow_entity_rows_sharded_elastic(tmp_path):
    """A streamed checkpoint with fewer entities than the vocabulary,
    restored and grown over a ``model`` mesh of four: the old rows bit for
    bit (some move to another owner), the new rows zero, an indivisible
    count the typed error listing the valid sizes."""
    from photon_ml_tpu_torch.game.checkpoint import (
        StreamCheckpointState,
        StreamingCheckpointManager,
    )
    from photon_ml_tpu_torch.game.streaming import ShardedCoefficientTable
    from photon_ml_tpu_torch.parallel import make_mesh
    from photon_ml_tpu_torch.parallel.sharding import ElasticPlacementError, EntityShards

    mesh = make_mesh({"model": 4}, [CPU] * 4)
    table = np.random.default_rng(3).normal(size=(12, 4)).astype(np.float32)
    StreamingCheckpointManager(CheckpointSpec(directory=str(tmp_path / "s"), resume=False)
                               ).save(StreamCheckpointState(next_chunk=1,
                                                            coefficients=torch.from_numpy(table)))
    ws = incremental.load_warm_start(str(tmp_path / "s"), mesh=mesh)
    assert ws.table.mesh is mesh and isinstance(ws.table.coefficients, EntityShards)
    grown = incremental.grow_entity_rows(ws.table.coefficients, 16, mesh=mesh)
    assert [int(p.shape[0]) for p in grown.parts] == [4, 4, 4, 4]
    host = grown.numpy()
    np.testing.assert_array_equal(host[:12], table)
    assert not host[12:].any()
    wrapped = ShardedCoefficientTable.from_coefficients(grown, mesh=mesh)
    assert wrapped.num_entities == 16
    np.testing.assert_array_equal(wrapped.to_numpy(), host)
    with pytest.raises(ElasticPlacementError, match="valid"):
        incremental.grow_entity_rows(ws.table.coefficients, 13, mesh=mesh)


# ---------------------------------------------------------------------------
# delta scans: streamed and in core agree
# ---------------------------------------------------------------------------


def _avro_records(n, users, rng):
    for i in range(n):
        yield {"uid": str(i), "label": float(i % 2),
               "features": [{"name": f"f{rng.integers(0, 10)}", "term": "",
                             "value": float(rng.normal())} for _ in range(4)],
               "metadataMap": {"userId": str(users[i % len(users)])},
               "weight": None, "offset": None}


def test_delta_scan_stream_agrees_with_in_core(tmp_path):
    from photon_ml_tpu.data.avro import build_index_maps_from_avro as j_index_maps
    from photon_ml_tpu.data.avro import read_game_dataset_from_avro as j_read
    from photon_ml_tpu_torch.data.avro import (
        TRAINING_EXAMPLE_AVRO,
        build_index_maps_from_avro,
        read_game_dataset_from_avro,
        write_avro,
    )
    from photon_ml_tpu_torch.ingest import IngestSpec

    delta_path = str(tmp_path / "delta.avro")
    write_avro(delta_path, TRAINING_EXAMPLE_AVRO,
               _avro_records(300, [5, 9, 23, 77], np.random.default_rng(11)), block_records=64)
    # 77 is the new entity
    base_vocabs = {"userId": np.sort(np.array([str(u) for u in range(30)]))}
    shards = {"g": ("features",)}
    imaps = build_index_maps_from_avro([delta_path], feature_shards=shards)
    data, _ = read_game_dataset_from_avro([delta_path], feature_shards=shards,
                                          id_columns=("userId",), index_maps=imaps,
                                          return_index_maps=True, device="cpu")
    telemetry.reset()
    in_core = incremental.scan_delta(data, base_vocabs, paths=[delta_path])
    streamed = incremental.scan_delta_stream([delta_path], base_vocabs, index_maps=imaps,
                                             feature_shards=shards,
                                             spec=IngestSpec(chunk_rows=64, workers=2),
                                             device="cpu")
    # the JAX package's in-core scan (its stream is not relied on with more
    # than one decode worker, ROADMAP Queue 3 item 11)
    jimaps = j_index_maps([delta_path], feature_shards=shards)
    jdata, _ = j_read([delta_path], feature_shards=shards, id_columns=("userId",),
                      index_maps=jimaps, return_index_maps=True)
    j_scan = j_inc.scan_delta(jdata, base_vocabs, paths=[delta_path])
    with open(delta_path, "rb") as fh:
        raw = bytearray(fh.read())
    raw[16] ^= 0xFF
    (tmp_path / "rewrite").mkdir()
    rewritten = str(tmp_path / "rewrite" / "delta.avro")
    with open(rewritten, "wb") as fh:
        fh.write(raw)
    assert incremental.delta_digest([rewritten]) != incremental.delta_digest([delta_path])
    assert incremental.delta_digest([rewritten]) == j_inc.delta_digest([rewritten])
    a, b, j = (s.for_id("userId") for s in (in_core, streamed, j_scan))
    for other in (b, j):
        np.testing.assert_array_equal(a.touched_values, other.touched_values)
        np.testing.assert_array_equal(a.new_values, other.new_values)
    assert a.new_values.tolist() == ["77"]
    assert in_core.digest == streamed.digest == j_scan.digest
    assert streamed.delta_rows == 300 == j_scan.delta_rows
    assert streamed.to_json() == j_scan.to_json()
    snap = telemetry.snapshot()
    assert snap["counters"]["incremental.touched_entities"] == 8
    assert snap["gauges"]["incremental.touched_fraction"] == pytest.approx(4 / 30)


def test_streamed_incremental_end_to_end(tmp_path):
    """The loop out of core: the base assembled through the ChunkStream
    reader, the delta scanned by ``scan_delta_stream``, the combined window
    read streamed with the same index maps, and the masked refresh: the
    untouched rows bit for bit the base fit's, the counts the JAX
    package's in-core run's."""
    from photon_ml_tpu_torch.data.avro import (
        TRAINING_EXAMPLE_AVRO,
        build_index_maps_from_avro,
        write_avro,
    )
    from photon_ml_tpu_torch.ingest import IngestSpec, read_game_dataset_streamed

    rng = np.random.default_rng(17)
    d, n_users, n_base, n_delta = _D, 8, 600, 45
    X = rng.normal(size=(n_base + n_delta, d))
    users = np.concatenate([rng.integers(0, n_users, n_base),
                            np.array([1, 4, n_users] * (n_delta // 3))])
    w = rng.normal(size=d)
    u_eff = rng.normal(size=n_users + 1)
    y = (rng.random(len(users)) < 1 / (1 + np.exp(-(X @ w + u_eff[users])))).astype(float)

    def recs(lo, hi):
        for i in range(lo, hi):
            yield {"uid": str(i), "label": float(y[i]),
                   "features": [{"name": f"c{j}", "term": "", "value": float(X[i, j])}
                                for j in range(d)],
                   "metadataMap": {"userId": f"u{users[i]:03d}"}, "weight": None,
                   "offset": None}

    train_path, delta_path = str(tmp_path / "base.avro"), str(tmp_path / "delta.avro")
    write_avro(train_path, TRAINING_EXAMPLE_AVRO, recs(0, n_base), block_records=64)
    write_avro(delta_path, TRAINING_EXAMPLE_AVRO, recs(n_base, n_base + n_delta),
               block_records=64)
    shards = {"g": ("features",)}
    spec = IngestSpec(chunk_rows=128, workers=2)
    imaps = build_index_maps_from_avro([train_path, delta_path], shards)

    def streamed(paths):
        return read_game_dataset_streamed(paths, feature_shards=shards, index_maps=imaps,
                                          id_columns=("userId",), spec=spec, device="cpu")

    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, evaluators=[])
    ckpt = str(tmp_path / "ckpt")
    base_fit = GameEstimator(tcfg).fit(streamed([train_path]), device="cpu",
                                       checkpoint_spec=CheckpointSpec(directory=ckpt,
                                                                      resume=False))
    ws = incremental.load_warm_start(ckpt, device="cpu")
    scan = incremental.scan_delta_stream([delta_path],
                                         {"userId": ws.model.models["perUser"].vocab},
                                         index_maps=imaps, feature_shards=shards, spec=spec,
                                         device="cpu")
    res = GameEstimator(tcfg).fit_incremental(streamed([train_path, delta_path]), ws,
                                              delta=scan, device="cpu")
    base_map, inc_map = _entity_coeffs(base_fit.model), _entity_coeffs(res.model)
    touched = {"u001", "u004"}
    checked = 0
    for val, coeffs in base_map.items():
        if val not in touched:
            checked += 1
            assert inc_map[val] == coeffs, val
    assert checked >= n_users - len(touched) - 1
    for val in touched:
        assert any(inc_map[val][g] != wv for g, wv in base_map[val].items()), val
    assert any(abs(v) > 1e-8 for v in inc_map[f"u{n_users:03d}"].values())
    assert scan.digest == incremental.delta_digest([delta_path])
    # the JAX package's in-core refresh of the same files
    from photon_ml_tpu.data.avro import build_index_maps_from_avro as j_index_maps
    from photon_ml_tpu.data.avro import read_game_dataset_from_avro as j_read

    jimaps = j_index_maps([train_path, delta_path], shards)

    def in_core(paths):
        return j_read(paths, feature_shards=shards, id_columns=("userId",), index_maps=jimaps)

    jcfg, _ = _configs()
    jcfg = dataclasses.replace(jcfg, evaluators=[])
    jb, jc, jd = in_core([train_path]), in_core([train_path, delta_path]), in_core([delta_path])
    jckpt = str(tmp_path / "jckpt")
    JEstimator(jcfg).fit(jb, checkpoint_spec=JCheckpointSpec(directory=jckpt, resume=False))
    jws = j_inc.load_warm_start(jckpt)
    jres = JEstimator(jcfg).fit_incremental(jc, jws, delta=j_inc.scan_delta(
        jd, {"userId": jws.model.models["perUser"].vocab}))
    assert _counts(res) == _counts(jres)
    np.testing.assert_array_equal(scan.for_id("userId").touched_values,
                                  np.array(["u001", "u004", f"u{n_users:03d}"]))


# ---------------------------------------------------------------------------
# masked solves of factored coordinates (frozen projection)
# ---------------------------------------------------------------------------


def _latent_rows(model, coord="perUser"):
    m = model.models[coord]
    lat = m.latent.cpu().numpy() if isinstance(m.latent, torch.Tensor) else np.asarray(m.latent)
    flat = np.asarray(m.entity_flat)
    return {m.vocab[c]: lat[flat[c]] for c in range(len(m.vocab)) if flat[c] >= 0}


def _projected_configs(k):
    jre, tre = _opts()
    return (JGameConfig(task="logistic", num_iterations=1, coordinates={
                "perUser": JREConfig(shard_name="g", id_name="userId", optimizer=jre,
                                     projector="random", projected_dim=k)}),
            GameConfig(task="logistic", num_iterations=1, coordinates={
                "perUser": RandomEffectConfig(shard_name="g", id_name="userId", optimizer=tre,
                                              projector="random", projected_dim=k)}))


def test_masked_factored_coordinate_parity(tmp_path):
    """Untouched latent rows exactly the transplant's, touched and new rows
    within 1e-3 of a full re-solve under the same frozen projection (and of
    the JAX package's masked re-solve)."""
    rng = np.random.default_rng(23)
    d, k, n_users, n_base, n_delta = _D, 3, 10, 900, 60
    X = rng.normal(size=(n_base + n_delta, d))
    users = np.concatenate([rng.integers(0, n_users, n_base),
                            np.array([2, 7, n_users] * (n_delta // 3))])
    w = rng.normal(size=d)
    u_eff = rng.normal(size=n_users + 1)
    y = (rng.random(len(users)) < 1 / (1 + np.exp(-(X @ w + u_eff[users])))).astype(float)
    jb, tb = _build(X[:n_base], users[:n_base], y[:n_base])
    jc, tc = _build(X, users, y)
    jd, td = _build(X[n_base:], users[n_base:], y[n_base:])
    jcfg, tcfg = _projected_configs(k)
    base_fit = GameEstimator(tcfg).fit(tb, device="cpu", checkpoint_spec=CheckpointSpec(
        directory=str(tmp_path / "t"), resume=False))
    ws = incremental.load_warm_start(str(tmp_path / "t"), device="cpu")
    scan = incremental.scan_delta(td, {"userId": ws.model.models["perUser"].vocab})
    res = GameEstimator(tcfg).fit_incremental(tc, ws, delta=scan, device="cpu")
    ref = GameEstimator(tcfg).fit(tc, device="cpu")
    JEstimator(jcfg).fit(jb, checkpoint_spec=JCheckpointSpec(directory=str(tmp_path / "j"),
                                                             resume=False))
    jws = j_inc.load_warm_start(str(tmp_path / "j"))
    jres = JEstimator(jcfg).fit_incremental(jc, jws, delta=j_inc.scan_delta(
        jd, {"userId": jws.model.models["perUser"].vocab}))

    base_rows, inc_rows, ref_rows = (_latent_rows(m.model) for m in (base_fit, res, ref))
    j_rows = _latent_rows(jres.model)
    touched = {"u002", "u007", f"u{n_users:03d}"}
    checked = 0
    for val, row in base_rows.items():
        if val in touched:
            continue
        checked += 1
        np.testing.assert_array_equal(inc_rows[val], row, err_msg=val)
    assert checked >= n_users - 2
    for val in touched:
        np.testing.assert_allclose(inc_rows[val], ref_rows[val], atol=1e-3, rtol=1e-3,
                                   err_msg=val)
        np.testing.assert_allclose(inc_rows[val], j_rows[val], atol=1e-3, rtol=1e-3,
                                   err_msg=val)
        if val in base_rows:
            assert not np.array_equal(inc_rows[val], base_rows[val]), val
    assert res.lanes_solved >= 3 and res.lanes_skipped >= n_users - 3 and res.bucket_solves >= 1
    assert _counts(res) == _counts(jres)


def test_transplant_factored_dim_mismatch_is_typed(tmp_path):
    rng = np.random.default_rng(29)
    n = 300
    X = rng.normal(size=(n, _D))
    users = rng.integers(0, 4, n)
    y = (rng.random(n) < 0.5).astype(float)
    jdata, tdata = _build(X, users, y)
    GameEstimator(_projected_configs(3)[1]).fit(tdata, device="cpu", checkpoint_spec=(
        CheckpointSpec(directory=str(tmp_path / "t"), resume=False)))
    JEstimator(_projected_configs(3)[0]).fit(jdata, checkpoint_spec=JCheckpointSpec(
        directory=str(tmp_path / "j"), resume=False))
    ws = incremental.load_warm_start(str(tmp_path / "t"), device="cpu")
    with pytest.raises(incremental.WarmStartError, match="latent"):
        GameEstimator(_projected_configs(4)[1]).fit_incremental(tdata, ws, device="cpu")
    with pytest.raises(j_inc.WarmStartError, match="latent"):
        JEstimator(_projected_configs(4)[0]).fit_incremental(
            jdata, j_inc.load_warm_start(str(tmp_path / "j")))


# ---------------------------------------------------------------------------
# the stale-delta refusal, the fault seams, lineage on /healthz
# ---------------------------------------------------------------------------

_IMAPS = {"g": [f"c{j}" for j in range(_D)]}


def test_check_delta_freshness_refuses_matching_digest(glmix, tmp_path):
    reg = str(tmp_path / "registry")
    res = glmix["t_res"]
    incremental.publish_incremental(reg, res.model, _IMAPS, res.lineage, delta=res.delta)
    with pytest.raises(incremental.StaleDeltaError, match="v-00000001"):
        incremental.check_delta_freshness(reg, res.delta.digest)
    # the JAX package reads the port's registry the same way
    with pytest.raises(j_inc.StaleDeltaError, match="v-00000001"):
        j_inc.check_delta_freshness(reg, res.delta.digest)
    incremental.check_delta_freshness(reg, res.delta.digest, force=True)
    incremental.check_delta_freshness(reg, "0" * 64)
    incremental.check_delta_freshness(str(tmp_path / "nope"), res.delta.digest)


def test_incremental_fault_seams_fire_typed(glmix, tmp_path):
    from photon_ml_tpu_torch.faults import registered_points

    for point in ("incremental.warm_restore", "incremental.delta_scan",
                  "incremental.publish"):
        assert point in registered_points()
    install_plan(FaultPlan([FaultRule("incremental.warm_restore", action="raise")]))
    with pytest.raises(InjectedFault):
        incremental.load_warm_start(glmix["t_ckpt"], device="cpu")
    install_plan(FaultPlan([FaultRule("incremental.delta_scan", action="raise")]))
    with pytest.raises(InjectedFault):
        incremental.scan_delta(glmix["delta"],
                               {"userId": glmix["t_ws"].model.models["perUser"].vocab})
    install_plan(FaultPlan([FaultRule("incremental.publish", action="raise")]))
    with pytest.raises(InjectedFault):
        incremental.publish_incremental(str(tmp_path / "reg"), glmix["t_res"].model, _IMAPS,
                                        glmix["t_res"].lineage)
    clear_plan()
    assert not os.path.isdir(tmp_path / "reg") or not any(
        n.startswith("v-") for n in os.listdir(tmp_path / "reg"))


def _without_paths(lineage):
    return {k: v for k, v in lineage.items()
            if k not in ("warm_start_checkpoint", "delta_paths", "base_digest")}


def test_publish_lineage_roundtrip_and_healthz(glmix, tmp_path):
    from photon_ml_tpu_torch.serving.engine import ScoringEngine
    from photon_ml_tpu_torch.serving.server import ScoringService

    reg = str(tmp_path / "registry")
    res = glmix["t_res"]
    path = incremental.publish_incremental(reg, res.model, _IMAPS, res.lineage, delta=res.delta,
                                           base_version="v-00000007")
    with open(os.path.join(path, "model-metadata.json")) as fh:
        lineage = json.load(fh)["extra"]["lineage"]
    assert lineage["base_version"] == "v-00000007"
    assert lineage["warm_start_checkpoint"] == res.lineage.checkpoint_dir
    assert lineage["base_kind"] == "step"
    assert lineage["delta_digest"] == res.delta.digest
    assert lineage["touched_fraction"] == pytest.approx(3 / 40, abs=0.01)
    jres = glmix["j_res"]
    want = j_inc.lineage_record(jres.lineage, delta=jres.delta, base_version="v-00000007")
    assert _without_paths(lineage) == _without_paths(want)
    engine = ScoringEngine.load(path, max_batch=4, device="cpu")
    assert engine.lineage == lineage
    service = ScoringService(engine)
    try:
        health = service.health()
    finally:
        service.stop()
    assert health["lineage"]["warm_start_checkpoint"] == res.lineage.checkpoint_dir
    assert health["lineage"]["delta_digest"] == res.delta.digest


# ---------------------------------------------------------------------------
# the CLI end to end, and the crash row
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_base(tmp_path_factory):
    """One ``cli train`` base with a checkpoint directory and a delta
    shard, in each package."""
    from photon_ml_tpu.cli.train import run as j_run
    from photon_ml_tpu_torch.cli.train import run as t_run
    from photon_ml_tpu_torch.data.avro import TRAINING_EXAMPLE_AVRO, write_avro

    rng = np.random.default_rng(99)
    tmp = tmp_path_factory.mktemp("cli_incremental")
    n, d, n_users = 240, _D, 6
    X = rng.normal(size=(n + 60, d))
    users = np.concatenate([rng.integers(0, n_users, n), np.array([1, 2, n_users] * 20)])
    w = rng.normal(size=d)
    u_eff = rng.normal(size=n_users + 1)
    y = (rng.random(len(users)) < 1 / (1 + np.exp(-(X @ w + u_eff[users])))).astype(float)

    def recs(lo, hi):
        for i in range(lo, hi):
            yield {"uid": str(i), "label": float(y[i]),
                   "features": [{"name": f"c{j}", "term": "", "value": float(X[i, j])}
                                for j in range(d)],
                   "metadataMap": {"userId": str(users[i])}, "weight": None, "offset": None}

    train_path, delta_path = str(tmp / "train.avro"), str(tmp / "delta.avro")
    write_avro(train_path, TRAINING_EXAMPLE_AVRO, recs(0, n))
    write_avro(delta_path, TRAINING_EXAMPLE_AVRO, recs(n, n + 60))
    out = {"tmp": tmp, "delta_path": delta_path}
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
            "output_dir": str(tmp / f"{pkg}-base-model"),
            "checkpoint": {"dir": str(tmp / f"{pkg}-base-ckpt"), "resume": False},
        }
        if pkg == "j":
            config["heartbeat"] = False
        cfg_path = tmp / f"{pkg}-train.json"
        cfg_path.write_text(json.dumps(config))
        run(dict(config), **({"device": "cpu"} if pkg == "t" else {}))
        out[pkg] = dict(config=config, cfg_path=str(cfg_path), ckpt=config["checkpoint"]["dir"])
    return out


def _refresh_argv(cli_base, pkg, reg, out_name, *extra):
    return ["refresh", "--config", cli_base[pkg]["cfg_path"], "--warm-start",
            cli_base[pkg]["ckpt"], "--delta", cli_base["delta_path"], "--registry-dir", reg,
            "--output-dir", str(cli_base["tmp"] / out_name), *extra]


def _refresh_in_process(cli_base, reg, out_name, *extra):
    """``cli refresh`` of the port in this process; its summary."""
    import contextlib
    import io

    from photon_ml_tpu_torch.cli.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(_refresh_argv(cli_base, "t", reg, out_name, *extra, "--device", "cpu")) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _run_cli(args, cwd, env_extra=None, expect_rc=0):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    proc = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.cli", *args,
                           "--device", "cpu"], capture_output=True, text=True, cwd=str(cwd),
                          env=env, timeout=600)
    assert proc.returncode == expect_rc, (proc.returncode, proc.stderr[-3000:])
    return proc


def _tree_digest(root):
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for name in sorted(filenames):
            p = os.path.join(dirpath, name)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def test_cli_refresh_end_to_end(cli_base):
    from photon_ml_tpu.cli.refresh import main as j_refresh
    from photon_ml_tpu_torch.data.model_store import load_game_model

    tmp = cli_base["tmp"]
    reg = str(tmp / "registry")
    telemetry.reset()
    summary = _refresh_in_process(cli_base, reg, "fresh-model", "--report-out",
                                  str(tmp / "r.md"))
    fresh = summary["freshness"]
    assert fresh["base"]["kind"] == "step"
    assert fresh["lanes_solved"] >= 3 and fresh["lanes_skipped"] >= 1
    assert fresh["delta"]["coordinates"]["userId"]["new_entities"] == 1
    assert fresh["time_to_fresh_s"] > 0
    assert fresh["published_version"].endswith("v-00000001")
    base_map = _entity_coeffs(load_game_model(str(tmp / "t-base-model" / "final"),
                                              device="cpu"))
    fresh_map = _entity_coeffs(load_game_model(str(tmp / "fresh-model" / "final"),
                                               device="cpu"))
    untouched = [v for v in base_map if v not in ("1", "2")]
    assert untouched
    for val in untouched:
        assert fresh_map[val] == base_map[val], val
    assert os.path.isdir(tmp / "fresh-model" / "final" / "feature-indexes" / "global")
    assert os.path.exists(tmp / "fresh-model" / "feature-stats" / "global.avro")
    with open(os.path.join(reg, "v-00000001", "model-metadata.json")) as fh:
        lineage = json.load(fh)["extra"]["lineage"]
    assert lineage["base_kind"] == "step" and lineage["delta_digest"]

    # the JAX package's refresh of the same base and delta
    jreg = str(tmp / "j-registry")
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert j_refresh(_refresh_argv(cli_base, "j", jreg, "j-fresh-model")[1:]) == 0
    jfresh = json.loads(buf.getvalue().strip().splitlines()[-1])["freshness"]
    for key in ("lanes_solved", "lanes_skipped", "bucket_solves", "buckets_skipped",
                "new_entities"):
        assert fresh[key] == jfresh[key], key
    assert fresh["delta"] == jfresh["delta"] and fresh["base"]["step"] == jfresh["base"]["step"]
    with open(os.path.join(jreg, "v-00000001", "model-metadata.json")) as fh:
        jlineage = json.load(fh)["extra"]["lineage"]
    assert _without_paths({k: v for k, v in lineage.items() if k != "quality_gate"}) == \
        _without_paths({k: v for k, v in jlineage.items() if k != "quality_gate"})
    assert lineage["quality_gate"]["decision"] == jlineage["quality_gate"]["decision"]
    # --report-out: the run report's Freshness section, from the live registries
    assert summary["report"] == str(tmp / "r.md")
    md = (tmp / "r.md").read_text()
    assert "## Freshness" in md and "kept bit-identical" in md
    doc = json.loads((tmp / "r.json").read_text())
    assert doc["freshness"]["lanes_solved"] == fresh["lanes_solved"]
    assert doc["freshness"]["lanes_skipped"] == fresh["lanes_skipped"]
    assert doc["freshness"]["published_versions"] == 1
    assert doc["freshness"]["base"]["kind"] == "step"


def test_crash_at_publish_preserves_base_and_registry(cli_base):
    """A hard kill (os._exit 113) at the ``incremental.publish`` seam leaves
    the base checkpoint byte for byte and the registry without a version;
    the unarmed rerun publishes v1."""
    tmp = cli_base["tmp"]
    ckpt = cli_base["t"]["ckpt"]
    reg = str(tmp / "crash-registry")
    before = _tree_digest(ckpt)
    plan = json.dumps({"rules": [{"point": "incremental.publish", "action": "exit",
                                  "exit_code": 113}]})
    _run_cli(_refresh_argv(cli_base, "t", reg, "crash-model"), cwd=tmp,
             env_extra={"PHOTON_FAULT_PLAN": plan}, expect_rc=113)
    assert _tree_digest(ckpt) == before
    assert not os.path.isdir(reg) or not any(n.startswith("v-") for n in os.listdir(reg))
    summary = _refresh_in_process(cli_base, reg, "crash-model-2")
    assert summary["freshness"]["published_version"].endswith("v-00000001")
    assert _tree_digest(ckpt) == before


def test_cli_refresh_stale_delta_refusal_and_force(cli_base):
    """``cli refresh`` refuses (typed, non-zero) a delta the newest version
    already trained on and publishes nothing; ``--force`` republishes."""
    tmp = cli_base["tmp"]
    reg = str(tmp / "stale-registry")
    _refresh_in_process(cli_base, reg, "stale-model-1")
    proc = _run_cli(_refresh_argv(cli_base, "t", reg, "stale-model-2"), cwd=tmp, expect_rc=1)
    assert "StaleDeltaError" in proc.stderr and "--force" in proc.stderr
    assert sorted(n for n in os.listdir(reg) if n.startswith("v-")) == ["v-00000001"]
    summary = _refresh_in_process(cli_base, reg, "stale-model-3", "--force")
    assert summary["freshness"]["published_version"].endswith("v-00000002")


def test_cli_train_warm_start_flags(cli_base, tmp_path):
    """``cli train --warm-start --delta --refresh-registry-dir`` is the
    refresh; the delta flags without a warm start are argparse's error, as
    in the JAX package."""
    import contextlib
    import io

    from photon_ml_tpu_torch.cli.train import main as t_train

    reg = str(tmp_path / "reg")
    flags = ["--device", "cpu", "--warm-start", cli_base["t"]["ckpt"], "--delta",
             cli_base["delta_path"], "--refresh-registry-dir", reg,
             "--output-dir", str(tmp_path / "out")]
    # the train config checkpoints into the base the refresh starts from
    with pytest.raises(incremental.WarmStartError, match="base"):
        t_train(["--config", cli_base["t"]["cfg_path"], *flags])
    config = {k: v for k, v in cli_base["t"]["config"].items() if k != "checkpoint"}
    (tmp_path / "train.json").write_text(json.dumps(config))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert t_train(["--config", str(tmp_path / "train.json"), *flags]) == 0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert summary["freshness"]["published_version"].endswith("v-00000001")
    assert summary["num_rows"] == 300  # the base's 240 rows and the delta's 60
    with pytest.raises(SystemExit):
        t_train(["--config", cli_base["t"]["cfg_path"], "--device", "cpu", "--delta", "d"])


# ---------------------------------------------------------------------------
# the COO layout and the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["LBFGS", "TRON"])
def test_masked_coo_buckets(monkeypatch, tmp_path, kind):
    """The per-user buckets forced onto the COO layout in both packages
    (before the datasets are built): the masked refresh solves the touched
    lanes on the gathered block-diagonal batch; untouched rows bit for bit,
    touched rows within the fit tolerance of the JAX package's."""
    from photon_ml_tpu.game import coordinates as j_coords

    monkeypatch.setattr(j_coords, "_bucket_dense_design", lambda b, *a, **k: None)
    monkeypatch.setattr(t_red, "_bucket_dense_design", lambda b: None)
    arrays = _spine_data(seed=5)
    (jb, tb), (jc, tc), (jd, td) = (_build(*arrays[k]) for k in ("base", "comb", "delta"))
    jcfg, tcfg = _configs(re_kind=kind, evaluators=[])
    base = GameEstimator(tcfg).fit(tb, device="cpu", checkpoint_spec=CheckpointSpec(
        directory=str(tmp_path / "t"), resume=False))
    ws = incremental.load_warm_start(str(tmp_path / "t"), device="cpu")
    res = GameEstimator(tcfg).fit_incremental(tc, ws, delta=incremental.scan_delta(
        td, {"userId": ws.model.models["perUser"].vocab}), device="cpu")
    coord = GameEstimator(tcfg)._build_coordinates(tc)["perUser"]
    assert all(isinstance(b, t_red.CooBucket) for b in coord._buckets)
    JEstimator(jcfg).fit(jb, checkpoint_spec=JCheckpointSpec(directory=str(tmp_path / "j"),
                                                             resume=False))
    jws = j_inc.load_warm_start(str(tmp_path / "j"))
    jres = JEstimator(jcfg).fit_incremental(jc, jws, delta=j_inc.scan_delta(
        jd, {"userId": jws.model.models["perUser"].vocab}))
    base_map, inc_map = _entity_coeffs(base.model), _entity_coeffs(res.model)
    touched = [f"u{u:03d}" for u in _TOUCHED] + [f"u{_N_USERS:03d}"]
    for val, coeffs in base_map.items():
        if val not in touched:
            assert inc_map[val] == coeffs, val
    _close_maps(inc_map, _entity_coeffs(jres.model), touched)
    assert _counts(res) == _counts(jres)


def test_masked_refresh_on_a_mesh(glmix):
    """``fit_incremental(mesh=...)`` over a ``model`` axis of four: each owner
    solves its touched lanes of its own block; untouched rows bit for bit,
    touched rows within rtol/atol 5e-3 of the unsharded refresh, the same
    counts."""
    from photon_ml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"model": 4}, [CPU] * 4)
    ws = incremental.load_warm_start(glmix["t_ckpt"], mesh=mesh)
    res = GameEstimator(glmix["tcfg"]).fit_incremental(glmix["comb"], ws, delta=glmix["t_scan"],
                                                       mesh=mesh)
    base_map = _entity_coeffs(glmix["t_base"].model)
    inc_map, ref_map = _entity_coeffs(res.model), _entity_coeffs(glmix["t_res"].model)
    touched = [f"u{u:03d}" for u in _TOUCHED] + [f"u{_N_USERS:03d}"]
    for val, coeffs in base_map.items():
        if val not in touched:
            assert inc_map[val] == coeffs, val
    _close_maps(inc_map, ref_map, touched, tol=MESH_TOL)
    assert _counts(res) == _counts(glmix["t_res"])


def test_masked_bootstrap_summaries_match_the_jax_package(tmp_path):
    """``bootstrap_samples``: the selected fit's masked-lane bootstrap, one
    summary a solved bucket (a single touched lane each here, so the JAX
    package pads none), each within 1e-3 of the JAX package's."""
    arrays = _spine_data()
    (jb, tb), (jc, tc), (jd, td) = (_build(*arrays[k]) for k in ("base", "comb", "delta"))
    jcfg, tcfg = _configs(evaluators=[])
    GameEstimator(tcfg).fit(tb, device="cpu", checkpoint_spec=CheckpointSpec(
        directory=str(tmp_path / "t"), resume=False))
    JEstimator(jcfg).fit(jb, checkpoint_spec=JCheckpointSpec(directory=str(tmp_path / "j"),
                                                             resume=False))
    ws = incremental.load_warm_start(str(tmp_path / "t"), device="cpu")
    jws = j_inc.load_warm_start(str(tmp_path / "j"))
    res = GameEstimator(tcfg).fit_incremental(tc, ws, delta=incremental.scan_delta(
        td, {"userId": ws.model.models["perUser"].vocab}), bootstrap_samples=8, device="cpu")
    jres = JEstimator(jcfg).fit_incremental(jc, jws, delta=j_inc.scan_delta(
        jd, {"userId": jws.model.models["perUser"].vocab}), bootstrap_samples=8)
    got, want = res.bootstrap, jres.bootstrap
    assert got["num_samples"] == want["num_samples"] == 8
    assert got["coordinates"].keys() == want["coordinates"].keys() == {"perUser"}
    buckets, jbuckets = got["coordinates"]["perUser"], want["coordinates"]["perUser"]
    assert buckets.keys() == jbuckets.keys() and len(buckets) == res.bucket_solves // 2
    for b, summ in buckets.items():
        jsumm = jbuckets[b]
        assert {k: summ[k] for k in ("entities", "touched_lanes", "coefficients_per_entity")} \
            == {k: jsumm[k] for k in ("entities", "touched_lanes", "coefficients_per_entity")}
        for key in ("mean_ci_width", "max_ci_width"):
            assert summ[key] == pytest.approx(jsumm[key], abs=1e-3), (b, key)
