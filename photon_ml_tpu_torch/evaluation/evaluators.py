"""Weighted evaluation metrics over (scores, labels, weights).

Counterpart of ``auc``, ``rmse``, ``poisson_loss``, ``better_than`` and
``EVALUATORS`` in ``photon_ml_tpu/evaluation/evaluators.py``: the metrics
``select_best_model`` picks by. The other mean losses and the sharded
(per-group) evaluators are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from photon_ml_tpu_torch.ops.losses import get_loss

Tensor = torch.Tensor

_MAXIMIZE = {"auc", "precision@k", "sharded_auc"}


def better_than(metric: str, a: float, b: float) -> bool:
    base = metric.split(":")[0]
    if base.startswith("precision@"):
        base = "precision@k"
    return a > b if base in _MAXIMIZE else a < b


def rmse(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    se = weights * (scores - labels) ** 2
    return torch.sqrt(torch.sum(se) / torch.clamp(torch.sum(weights), min=1e-12))


def poisson_loss(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Weighted mean Poisson loss (the data log-likelihood up to a constant)."""
    loss = get_loss("poisson").loss(scores, labels)
    return torch.sum(weights * loss) / torch.clamp(torch.sum(weights), min=1e-12)


def auc(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Weighted ROC AUC by one sort and sweep over weighted mid-ranks; tied
    scores share their average rank. Returns 0.5 when a class is absent."""
    pos = (labels > 0.5).to(scores.dtype) * weights
    neg = (labels <= 0.5).to(scores.dtype) * weights
    order = torch.argsort(scores, stable=True)
    s, p, n = scores[order], pos[order], neg[order]
    w = p + n
    rank = torch.cumsum(w, 0) - 0.5 * w
    new_group = torch.ones_like(s, dtype=torch.bool)
    new_group[1:] = s[1:] != s[:-1]
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    g_w = torch.zeros_like(w).index_add_(0, gid, w)
    g_rw = torch.zeros_like(w).index_add_(0, gid, rank * w)
    rank_tied = (g_rw / torch.clamp(g_w, min=1e-30))[gid]
    w_pos, w_neg = torch.sum(p), torch.sum(n)
    u = torch.sum(rank_tied * p) - 0.5 * w_pos * w_pos
    denom = w_pos * w_neg
    return torch.where(denom > 0, u / torch.clamp(denom, min=1e-30), 0.5)


EVALUATORS: dict[str, Callable[[Tensor, Tensor, Tensor], Tensor]] = {
    "auc": auc,
    "rmse": rmse,
    "poisson_loss": poisson_loss,
}
