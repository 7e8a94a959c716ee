"""Batch model evaluation: regression and binary-classification metrics,
the per-datum log-likelihood and AIC of one GLM on one batch.

Counterpart of ``evaluate`` in ``photon_ml_tpu/diagnostics/evaluation.py``
(:71-126) with its two curve metrics (:37-68): MAE, MSE and RMSE for
squared and Poisson tasks; area under ROC, area under precision/recall and
peak F1 for logistic and smoothed hinge; the per-datum log-likelihood
(logistic on eps-clamped means, Poisson with lgamma) and the small-sample
corrected AIC over coefficients with |w| > 1e-9. Everything is computed on
the batch's device; the curves' running sums are the evaluators' float64
Hillis-Steele scan (``_prefix``), so each metric repeats bit for bit.
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.evaluation.evaluators import _prefix
from photon_ml_tpu_torch.evaluation.evaluators import auc as _auc
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.losses import get_loss

Tensor = torch.Tensor

MEAN_ABSOLUTE_ERROR = "Mean absolute error"
MEAN_SQUARE_ERROR = "Mean square error"
ROOT_MEAN_SQUARE_ERROR = "Root mean square error"
AREA_UNDER_PRECISION_RECALL = "Area under precision/recall"
AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS = "Area under ROC"
PEAK_F1_SCORE = "Peak F1 score"
DATA_LOG_LIKELIHOOD = "Per-datum log likelihood"
AKAIKE_INFORMATION_CRITERION = "Akaike information criterion"
_EPS = 1e-9


def _precision_recall(scores: Tensor, labels: Tensor, weights: Tensor):
    """Precision and recall at each threshold, scores descending (ties in
    input order)."""
    order = torch.argsort(-scores, stable=True)
    w = weights[order].double()
    y = torch.where(labels[order] > 0.5, w, 0.0)
    tp, pp = _prefix(y)[1:], _prefix(w)[1:]
    precision = tp / torch.clamp(pp, min=_EPS)
    recall = tp / torch.clamp(tp[-1], min=_EPS)
    return precision, recall


def area_under_pr(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Weighted area under the precision-recall curve (trapezoids from the
    point recall 0, precision 1)."""
    precision, recall = _precision_recall(scores, labels, weights)
    r = torch.cat([recall.new_zeros(1), recall])
    p = torch.cat([precision.new_ones(1), precision])
    return torch.sum((r[1:] - r[:-1]) * 0.5 * (p[1:] + p[:-1]))


def peak_f1(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """The largest F1 over the score thresholds."""
    precision, recall = _precision_recall(scores, labels, weights)
    return torch.max(2.0 * precision * recall / torch.clamp(precision + recall, min=_EPS))


def evaluate(model: GeneralizedLinearModel, batch) -> dict[str, float]:
    """The full metric map of one GLM on one batch; ``compute_score``
    includes the batch's offsets."""
    task = get_loss(model.task).name
    margins = model.compute_score(batch)
    means = model.mean_of(margins)
    labels, weights = batch.labels, batch.weights
    wsum = torch.clamp(torch.sum(weights), min=_EPS)
    metrics: dict[str, float] = {}

    if task in ("squared", "poisson"):
        err = means - labels
        metrics[MEAN_ABSOLUTE_ERROR] = float(torch.sum(weights * torch.abs(err)) / wsum)
        mse = torch.sum(weights * err * err) / wsum
        metrics[MEAN_SQUARE_ERROR] = float(mse)
        metrics[ROOT_MEAN_SQUARE_ERROR] = float(torch.sqrt(mse))

    if task in ("logistic", "smoothed_hinge"):
        metrics[AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS] = float(
            _auc(means, labels, weights))
        metrics[AREA_UNDER_PRECISION_RECALL] = float(area_under_pr(means, labels, weights))
        metrics[PEAK_F1_SCORE] = float(peak_f1(means, labels, weights))

    log_lik = None
    if task == "logistic":
        p = torch.clamp(means, _EPS, 1.0 - _EPS)
        ll = labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p)
        log_lik = float(torch.sum(weights * ll) / wsum)
    elif task == "poisson":
        ll = labels * margins - torch.exp(margins) - torch.lgamma(1.0 + labels)
        log_lik = float(torch.sum(weights * ll) / wsum)
    if log_lik is not None:
        metrics[DATA_LOG_LIKELIHOOD] = log_lik
        n = float(torch.sum(weights > 0))
        k = float(torch.sum(torch.abs(model.coefficients.means) > 1e-9))
        base_aic = 2.0 * (k - n * log_lik)
        metrics[AKAIKE_INFORMATION_CRITERION] = base_aic + 2.0 * k * (k + 1) / max(
            n - k - 1.0, _EPS)
    return metrics
