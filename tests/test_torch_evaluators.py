"""The port's evaluators (``photon_ml_tpu_torch.evaluation``) against the JAX
package's, on the CPU: the six flat metrics of ``EVALUATORS``,
``sharded_auc``, ``sharded_precision_at_k`` and ``parse_evaluator``, on
seeded inputs with tied scores within and across groups, zero-weight padding
rows, single-class groups, empty groups, k larger than a group, and binned
scores under weights spread over six orders of magnitude.

Tolerances are tests/test_evaluators.py's: AUCs within 1e-5 (float32 ranks
summed in another order), precision@k and the mean losses within 1e-6
(relative above 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation import evaluators as J
from photon_ml_tpu_torch.evaluation import evaluators as T

N_GROUPS = 9
CASES = ["ties", "padding", "single_class", "empty_groups", "continuous",
         "binned_log_weights"]


def _inputs(case: str):
    """(scores, labels, weights, group ids) as float32/int32 numpy arrays."""
    rng = np.random.default_rng(CASES.index(case))
    n = 240
    scores = rng.normal(size=n)
    labels = (rng.random(n) > 0.5).astype(np.float32)
    weights = rng.random(n) + 0.1
    groups = rng.integers(0, N_GROUPS, size=n)
    if case == "ties":  # a few distinct scores: ties within and across groups
        scores = rng.integers(0, 4, size=n) * 0.5
    elif case == "padding":  # weight-0 rows with scores and labels of their own
        weights[rng.random(n) < 0.2] = 0.0
        scores = np.round(scores, 1)
    elif case == "single_class":  # groups 0-2 hold one class only
        labels[groups < 2] = 1.0
        labels[groups == 2] = 0.0
    elif case == "empty_groups":  # groups 1, 4 and the last hold no rows
        groups[np.isin(groups, (1, 4, N_GROUPS - 1))] = 0
    elif case == "binned_log_weights":  # binned scores, importance weights over 1e6
        scores = np.floor(rng.random(n) * 20) / 20
        weights = 10.0 ** rng.uniform(-3, 3, size=n)
    return (scores.astype(np.float32), labels, weights.astype(np.float32),
            groups.astype(np.int32))




def _both(case):
    arrays = _inputs(case)
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", sorted(J.EVALUATORS))
def test_flat_evaluators_match_the_reference(name, case):
    assert sorted(T.EVALUATORS) == sorted(J.EVALUATORS)
    (js, jy, jw, _), (ts, ty, tw, _) = _both(case)
    want = float(J.EVALUATORS[name](js, jy, jw))
    got = T.EVALUATORS[name](ts, ty, tw)
    assert got.dtype == torch.float32 and got.dim() == 0
    atol = 1e-5 if name == "auc" else 1e-6
    assert abs(float(got) - want) <= atol * max(1.0, abs(want)), (name, case, float(got), want)


@pytest.mark.parametrize("case", CASES)
def test_sharded_auc_matches_the_reference(case):
    (js, jy, jw, jg), (ts, ty, tw, tg) = _both(case)
    want = float(J.sharded_auc(js, jy, jw, jg, N_GROUPS))
    got = T.sharded_auc(ts, ty, tw, tg, N_GROUPS)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5, (case, float(got), want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [1, 3, 100])  # 100: more than any group holds
def test_sharded_precision_at_k_matches_the_reference(case, k):
    (js, jy, jw, jg), (ts, ty, tw, tg) = _both(case)
    want = float(J.sharded_precision_at_k(js, jy, jw, jg, N_GROUPS, k))
    got = T.sharded_precision_at_k(ts, ty, tw, tg, N_GROUPS, k)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6, (case, k, float(got), want)


def test_tied_scores_keep_the_input_order_inside_a_top_k():
    """Tied scores straddle the top-2 cut of group 0: the first rows in the
    input order are in (a stable sort by group, then by score)."""
    scores = np.array([0.5, 0.5, 0.5, 0.9, 0.5, 0.1], np.float32)
    labels = np.array([0, 1, 1, 0, 0, 1], np.float32)
    weights = np.ones(6, np.float32)
    groups = np.array([0, 0, 0, 1, 1, 1], np.int32)
    args = (scores, labels, weights, groups)
    want = float(J.sharded_precision_at_k(*map(jnp.asarray, args), 2, 2))
    got = float(T.sharded_precision_at_k(*map(torch.from_numpy, args), 2, 2))
    assert got == pytest.approx(want, abs=1e-6)
    assert got == pytest.approx((0.5 + 0.0) / 2, abs=1e-6)


@pytest.mark.parametrize("spec", ["AUC", "rmse", " logistic_loss ", "Squared_Loss",
                                  "poisson_loss", "smoothed_hinge_loss", "auc:memberId",
                                  "precision@5:queryId", "PRECISION@1:UserId",
                                  "nope", "rmse:userId", "precision@x:userId"])
def test_parse_evaluator_matches_the_reference(spec):
    try:
        want = J.parse_evaluator(spec)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            T.parse_evaluator(spec)
        assert str(got.value) == str(exc)
        return
    assert T.parse_evaluator(spec) == want


@pytest.mark.parametrize("metric,a,b", [("auc", 0.9, 0.8), ("auc:userId", 0.9, 0.8),
                                        ("precision@5:q", 0.9, 0.2), ("rmse", 0.1, 0.2),
                                        ("logistic_loss", 0.3, 0.4),
                                        ("smoothed_hinge_loss", 0.4, 0.3)])
def test_better_than_matches_the_reference(metric, a, b):
    assert T.better_than(metric, a, b) == J.better_than(metric, a, b)
    assert T.better_than(metric, b, a) == J.better_than(metric, b, a)


def test_package_exports_the_references_names():
    import photon_ml_tpu.evaluation as jpkg
    import photon_ml_tpu_torch.evaluation as tpkg

    names = {n for n in dir(jpkg) if not n.startswith("_") and n != "evaluators"}
    assert names <= set(dir(tpkg))
