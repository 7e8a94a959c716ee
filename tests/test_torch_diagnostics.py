"""The port's host diagnostics (``photon_ml_tpu_torch.diagnostics``)
against the JAX package's, on the CPU: Hosmer-Lemeshow, Kendall tau, feature
importance on the port's ``FeatureSummary``, fitting curves on the port's
``train_glm``, ``diagnose_model``, and the report renderers (one document
rendered by both packages gives the same HTML and text).

Tolerances: the host statistics of identical inputs exactly; feature
importances rtol 1e-5 (the two packages' summaries sum in float32 in
different orders); fitting curves atol 1e-3 (each portion's fit stops
within LBFGS's tolerance); ``diagnose_model``'s metrics rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import photon_ml_tpu.diagnostics as jd
import photon_ml_tpu_torch.diagnostics as td
from photon_ml_tpu.data.stats import summarize as j_summarize
from photon_ml_tpu.diagnostics.fitting import fitting_report_sections as j_sections
from photon_ml_tpu.models.glm import make_model as j_make_model
from photon_ml_tpu.ops.sparse import SparseBatch
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu_torch.data.stats import summarize
from photon_ml_tpu_torch.diagnostics.fitting import fitting_report_sections
from photon_ml_tpu_torch.models.glm import make_model
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)


def _logistic(seed, n=500, d=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    X[:, 0] = 1.0
    w = rng.normal(size=d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ w)))).astype(float)
    return X, y, w, SparseBatch.from_dense(X, y), CSRBatch.from_dense(X, y, device="cpu")


@pytest.mark.parametrize("binning", ["equal_count", "equal_width"])
@pytest.mark.parametrize("expected", ["midpoint", "mean_prob"])
def test_hosmer_lemeshow_matches_the_reference(binning, expected):
    rng = np.random.default_rng(0)
    p = rng.random(400)
    y = (rng.random(400) < p ** 1.5).astype(float)
    w = rng.random(400) * (rng.random(400) < 0.9)
    got = td.hosmer_lemeshow(p, y, w, num_bins=8, binning=binning, expected=expected)
    ref = jd.hosmer_lemeshow(p, y, w, num_bins=8, binning=binning, expected=expected)
    assert got.to_summary_string() == ref.to_summary_string()
    assert (got.chi_square, got.p_value, got.cutoffs) == (ref.chi_square, ref.p_value,
                                                           ref.cutoffs)


@pytest.mark.parametrize("n,max_samples", [(300, 2000), (500, 200)])
def test_kendall_tau_matches_the_reference(n, max_samples):
    rng = np.random.default_rng(1)
    a = rng.normal(size=n)
    b = 0.3 * a + rng.normal(size=n)
    got = td.kendall_tau_analysis(a, b, max_samples=max_samples, seed=4)
    ref = jd.kendall_tau_analysis(a, b, max_samples=max_samples, seed=4)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(td.prediction_error_independence(a, b > 0)) == \
        dataclasses.asdict(jd.prediction_error_independence(a, b > 0))


@pytest.mark.parametrize("with_summary", [False, True])
def test_feature_importance_matches_the_reference(with_summary):
    X, y, w, jbatch, tbatch = _logistic(2, d=8)
    names = [f"f{j}" for j in range(8)]
    tm = make_model("logistic", torch.tensor(w, dtype=torch.float32))
    jm = j_make_model("logistic", np.asarray(w, np.float32))
    ts = summarize(tbatch) if with_summary else None
    js = j_summarize(jbatch) if with_summary else None
    for tf, jf in ((td.expected_magnitude_importance, jd.expected_magnitude_importance),
                   (td.variance_importance, jd.variance_importance)):
        got, ref = tf(tm, ts, names), jf(jm, js, names)
        assert (got.importance_type, got.importance_description) == (
            ref.importance_type, ref.importance_description)
        assert [r[:2] for r in got.ranked] == [r[:2] for r in ref.ranked]
        np.testing.assert_allclose([r[2] for r in got.ranked], [r[2] for r in ref.ranked],
                                   rtol=1e-5)


def test_fitting_curves_match_the_reference():
    X, y, w, jbatch, tbatch = _logistic(3, n=600, d=5)
    jcfg = JOpt(regularization=JReg(JRegType.L2), regularization_weight=1e-2)
    tcfg = OptimizerConfig(regularization=RegularizationContext(RegularizationType.L2),
                           regularization_weight=1e-2)
    ref = jd.fitting_diagnostic(jbatch, "logistic", jcfg, lambdas=[1e-2], seed=3,
                                num_partitions=5)
    got = td.fitting_diagnostic(tbatch, "logistic", tcfg, lambdas=[1e-2], seed=3,
                                num_partitions=5, device="cpu")
    assert got.portions == ref.portions
    for dest in ("train_metrics", "test_metrics"):
        g, r = getattr(got, dest)[1e-2], getattr(ref, dest)[1e-2]
        assert set(g) == set(r)
        for k in g:
            np.testing.assert_allclose(g[k], r[k], atol=1e-3, rtol=1e-4)
    html = td.render_html(td.Document("fit", [td.Chapter("learning",
                                                         fitting_report_sections(got))]))
    assert html.count("<svg") == len(got.test_metrics[1e-2])
    assert len(j_sections(ref)) == len(fitting_report_sections(got))


def test_diagnose_model_matches_the_reference():
    X, y, w, jbatch, tbatch = _logistic(4, n=400)
    names = [f"f{j}" for j in range(X.shape[1])]
    tdoc = td.diagnose_model(make_model("logistic", torch.tensor(w, dtype=torch.float32)),
                             tbatch, summary=summarize(tbatch), feature_names=names)
    jdoc = jd.diagnose_model(j_make_model("logistic", np.asarray(w, np.float32)), jbatch,
                             summary=j_summarize(jbatch), feature_names=names)
    assert [c.title for c in tdoc.chapters] == [c.title for c in jdoc.chapters]
    assert [[s.title for s in c.sections] for c in tdoc.chapters] == \
        [[s.title for s in c.sections] for c in jdoc.chapters]
    metrics = {r[0]: float(r[1]) for r in tdoc.chapters[0].sections[0].items[0].rows}
    ref = {r[0]: float(r[1]) for r in jdoc.chapters[0].sections[0].items[0].rows}
    assert set(metrics) == set(ref)
    for k in metrics:
        assert metrics[k] == pytest.approx(ref[k], rel=1e-5)
    txt = td.render_text(tdoc)
    assert "Model diagnostics" in txt and "Hosmer-Lemeshow" in txt and "Kendall tau" in txt
    html = td.render_html(tdoc)
    assert html.startswith("<!DOCTYPE html>") and "<table>" in html


def _document(pkg):
    return pkg.Document("report <a&b>", [
        pkg.Chapter("one", [pkg.Section("s", [
            pkg.Text("plain & <escaped>"),
            pkg.BulletedList(["a", "b"]),
            pkg.NumberedList(["x", "y"]),
            pkg.Table(header=["k", "v"], rows=[("a", 1), ("bb", 2.5)], caption="cap"),
            pkg.LinePlot(x=[0.1, 0.5, 0.9], series={"train": [1, 2, 3], "test": [1, 1.5, 2]},
                         title="learning curve", x_label="portion", y_label="auc"),
            pkg.Section("nested", [pkg.Text("inner")]),
        ])]),
        pkg.Chapter("two", [pkg.Section("empty plot", [pkg.LinePlot(x=[], series={})])]),
    ])


@pytest.mark.parametrize("render", ["render_html", "render_text"])
def test_renderers_give_the_references_strings(render):
    assert getattr(td, render)(_document(td)) == getattr(jd, render)(_document(jd))


def test_unknown_report_item_raises():
    with pytest.raises(TypeError, match="unknown report item"):
        td.render_text(td.Document("d", [td.Chapter("c", [td.Section("s", [object()])])]))
