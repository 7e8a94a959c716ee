"""Weighted evaluation metrics over (scores, labels, weights), plus sharded
(per-group) evaluators.

Counterpart of ``photon_ml_tpu/evaluation/evaluators.py``: ``auc``,
``rmse``, the weighted mean losses, ``EVALUATORS`` (the metrics
``select_best_model`` picks by), ``sharded_auc`` and
``sharded_precision_at_k`` over an id column, ``parse_evaluator`` and
``better_than``.

Both AUCs sort (by score, or by group and then score) and give each row the
weighted mid-rank of its run of tied rows: the weight before the run plus
half the run's weight, read off one float64 running sum of the weights.
That running sum (``_prefix``) is a Hillis-Steele scan, log2(n) passes of
elementwise adds, so its order of addition is fixed by the length alone and
never by the device's scan schedule (CUDA's ``cumsum`` is not fixed); the
sharded evaluators take their per-group sums by ``torch.segment_reduce``
over each group's contiguous run. No float atomics (``index_add_``,
``scatter_add_``), so a metric is bit-identical from call to call whatever
its weights and ties.
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


def _mean_loss(loss_name: str):
    loss = get_loss(loss_name)

    def f(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
        l = loss.loss(scores, labels)
        return torch.sum(weights * l) / torch.clamp(torch.sum(weights), min=1e-12)

    return f


logistic_loss = _mean_loss("logistic")
squared_loss = _mean_loss("squared")
poisson_loss = _mean_loss("poisson")
smoothed_hinge_loss = _mean_loss("smoothed_hinge")


def auc(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Weighted ROC AUC by one sort and sweep over weighted mid-ranks; tied
    scores share their average rank. Returns 0.5 when a class is absent."""
    order = torch.argsort(scores, stable=True)
    s = scores[order]
    w = weights[order].double()
    pos = torch.where(labels[order] > 0.5, w, 0.0)
    new_run = torch.ones_like(s, dtype=torch.bool)
    new_run[1:] = s[1:] != s[:-1]
    mid_rank = _mid_ranks(w, new_run, torch.zeros_like(order))
    w_pos, w_neg = torch.sum(pos), torch.sum(w - pos)
    u = torch.sum(mid_rank * pos) - 0.5 * w_pos * w_pos
    denom = w_pos * w_neg
    return torch.where(denom > 0, u / torch.clamp(denom, min=1e-30), 0.5).to(scores.dtype)


EVALUATORS: dict[str, Callable[[Tensor, Tensor, Tensor], Tensor]] = {
    "auc": auc,
    "rmse": rmse,
    "logistic_loss": logistic_loss,
    "squared_loss": squared_loss,
    "poisson_loss": poisson_loss,
    "smoothed_hinge_loss": smoothed_hinge_loss,
}


def _group_runs(keys: Tensor, group_ids: Tensor, num_groups: int):
    """(order, sorted group ids, group lengths, each row's group start): the
    order sorts by group, then by key, and keeps the input order on ties, as
    ``jnp.lexsort((keys, group_ids))`` does."""
    order = torch.argsort(keys, stable=True)
    order = order[torch.argsort(group_ids[order], stable=True)]
    g = group_ids[order].long()
    bounds = torch.searchsorted(g, torch.arange(num_groups + 1, device=g.device))
    return order, g, torch.diff(bounds), bounds[g]


def _prefix(x: Tensor) -> Tensor:
    """[0, x_0, x_0 + x_1, ...]: the running sum with a leading zero, by a
    Hillis-Steele scan (pass k adds the value 2^k places back), whose order
    of addition depends on the length only."""
    out, step = x, 1
    while step < out.numel():
        out = torch.cat([out[:step], out[step:] + out[:-step]])
        step *= 2
    return torch.cat([x.new_zeros(1), out])


def _mid_ranks(w: Tensor, new_run: Tensor, g_start: Tensor) -> Tensor:
    """Each sorted row's weighted mid-rank within its group, shared by its run
    of tied rows (``new_run`` marks where a run begins, ``g_start`` is the
    row's group start): the group's weight before the run plus half the
    run's weight, which is the run's weighted mean of its rows' mid-ranks."""
    idx = torch.arange(w.numel(), device=w.device)
    run_start = torch.cummax(torch.where(new_run, idx, 0), 0).values
    run_id = torch.cumsum(new_run.long(), 0)
    run_end = torch.searchsorted(run_id, run_id, right=True)
    cum = _prefix(w)
    return (cum[run_start] - cum[g_start]) + 0.5 * (cum[run_end] - cum[run_start])


def sharded_auc(scores: Tensor, labels: Tensor, weights: Tensor, group_ids: Tensor,
                num_groups: int) -> Tensor:
    """Mean per-group weighted AUC over the groups that hold both classes.

    The same weighted mid-rank statistic as ``auc``, group-relative: a run of
    equal (group, score) rows shares the average of its mid-ranks, which is
    the group's weight before the run plus half the run's weight. Zero-weight
    (padding) rows are inert."""
    order, g, lengths, g_start = _group_runs(scores, group_ids, num_groups)
    s = scores[order]
    w = weights[order].double()
    pos = torch.where(labels[order] > 0.5, w, 0.0)
    neg = w - pos
    new_run = torch.ones_like(s, dtype=torch.bool)
    new_run[1:] = (s[1:] != s[:-1]) | (g[1:] != g[:-1])
    mid_rank = _mid_ranks(w, new_run, g_start)

    def per_group(x: Tensor) -> Tensor:
        return torch.segment_reduce(x, "sum", lengths=lengths)

    w_pos, w_neg = per_group(pos), per_group(neg)
    u = per_group(mid_rank * pos) - 0.5 * w_pos * w_pos
    pairs = w_pos * w_neg
    has_both = pairs > 0
    auc_g = torch.where(has_both, u / torch.clamp(pairs, min=1e-30), 0.0)
    n_scored = torch.clamp(has_both.sum(), min=1)
    return (auc_g.sum() / n_scored).to(scores.dtype)


def sharded_precision_at_k(scores: Tensor, labels: Tensor, weights: Tensor,
                           group_ids: Tensor, num_groups: int, k: int) -> Tensor:
    """Mean, over the groups with any valid (weight > 0) row, of the share of
    positives among each group's top ``k`` valid rows by score."""
    order, g, lengths, g_start = _group_runs(-scores, group_ids, num_groups)
    valid = weights[order] > 0
    before = _prefix(valid.long())
    in_top_k = valid & (before[:-1] - before[g_start] < k)
    hit = in_top_k & (labels[order] > 0.5)
    hits = torch.segment_reduce(hit.double(), "sum", lengths=lengths)
    counts = torch.segment_reduce(in_top_k.double(), "sum", lengths=lengths)
    has_any = counts > 0
    share = torch.where(has_any, hits / torch.clamp(counts, min=1.0), 0.0)
    return (share.sum() / torch.clamp(has_any.sum(), min=1)).to(scores.dtype)


def parse_evaluator(spec: str):
    """(kind, group column or None, k or None) of an evaluator spec such as
    'auc', 'rmse', 'auc:queryId' or 'precision@5:queryId' (the sharded ones
    name their id column after ':'); the spec is lowercased."""
    spec = spec.strip().lower()
    if ":" in spec:
        metric, group_col = spec.split(":", 1)
        if metric.startswith("precision@"):
            k = int(metric.split("@")[1])
            return ("sharded_precision_at_k", group_col, k)
        if metric == "auc":
            return ("sharded_auc", group_col, None)
        raise ValueError(f"unknown sharded evaluator '{spec}'")
    if spec not in EVALUATORS:
        raise ValueError(f"unknown evaluator '{spec}'. Known: {sorted(EVALUATORS)}")
    return (spec, None, None)
