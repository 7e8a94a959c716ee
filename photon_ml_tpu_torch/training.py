"""Top-level GLM training: warm-started regularization sweeps and model
selection.

Counterpart of ``train_glm``, ``select_best_model`` and ``SweepEntry`` in
``photon_ml_tpu/training.py`` (:81-243): lambdas are trained in descending
order, each warm-started from the previous optimum, and returned in the
caller's order. Variances are 1 / (diag H(w*) + 1e-12) in optimization space,
scaled by factor^2 into original space. The reference's ``mesh``/``axis``
(multi-device) arguments are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.device import check_on, resolve_device
from photon_ml_tpu_torch.evaluation.evaluators import EVALUATORS, better_than
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel, make_model
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.common import BoxConstraints, SolveResult
from photon_ml_tpu_torch.optim.factory import OptimizerConfig, dispatch_solve

Tensor = torch.Tensor

_VARIANCE_EPS = 1e-12


@dataclasses.dataclass
class SweepEntry:
    """One trained model of a regularization sweep."""

    reg_weight: float
    model: GeneralizedLinearModel
    result: SolveResult


def train_glm(
    batch,
    task: str,
    lambdas: Sequence[float],
    config: OptimizerConfig,
    normalization: Optional[NormalizationContext] = None,
    constraints: Optional[BoxConstraints] = None,
    initial_model: Optional[GeneralizedLinearModel] = None,
    compute_variances: bool = False,
    device: torch.device | str | None = None,
) -> list[SweepEntry]:
    """Train one GLM per regularization weight, descending, warm-started.

    ``device`` (default cuda) must be where ``batch`` lives; each value of
    ``lambdas`` is solved in turn.
    """
    dev = resolve_device(device)
    if not lambdas:
        raise ValueError("lambdas must be non-empty")
    config.validate(task)
    task = get_loss(task).name
    n_feat = int(batch.num_features)
    check_on(dev, batch.labels)
    if constraints is None:
        constraints = config.build_box_constraints(n_feat, dev)

    factors = shifts = None
    if normalization is not None:
        factors, shifts = normalization.factors, normalization.shifts
        check_on(dev, factors, shifts)

    if initial_model is not None:
        w_start = initial_model.coefficients.means.to(dev)
        if normalization is not None:
            w_start = normalization.inverse_transform_model_coefficients(w_start)
    else:
        w_start = torch.zeros(n_feat, dtype=torch.float32, device=dev)

    order = sorted(range(len(lambdas)), key=lambda i: -lambdas[i])
    base_obj = make_objective(task, factors=factors, shifts=shifts)
    has_hessian = get_loss(task).has_hessian

    results: dict[int, SweepEntry] = {}
    w_prev = w_start
    with telemetry.span("train_glm", task=task, num_lambdas=len(lambdas)):
        for i in order:
            lam = float(lambdas[i])
            with telemetry.span("lambda_solve", reg_weight=lam):
                obj = base_obj.with_l2(config.regularization.l2_weight(lam))
                res = dispatch_solve(
                    glm_adapter(obj, batch), w_prev, config,
                    config.regularization.l1_weight(lam), constraints, device=dev,
                )
                w_opt = res.w
                w_prev = w_opt
                telemetry.counter("glm_sweep_solves").inc()

                variances = None
                if compute_variances:
                    if not has_hessian:
                        raise ValueError(
                            "variances need a twice-differentiable loss; "
                            f"'{task}' is not"
                        )
                    variances = 1.0 / (obj.hessian_diagonal(w_opt, batch) + _VARIANCE_EPS)

                means = w_opt
                if normalization is not None:
                    means = normalization.transform_model_coefficients(w_opt)
                    # Var(c*X) = c^2 Var(X): factor^2 and no shift term (the
                    # reference's deliberate deviation, training.py:188-196)
                    if variances is not None and normalization.factors is not None:
                        variances = variances * normalization.factors**2
                results[i] = SweepEntry(
                    reg_weight=lam,
                    model=make_model(task, means, variances=variances),
                    result=res,
                )
    return [results[i] for i in range(len(lambdas))]


def _default_selection_metric(task: str) -> str:
    task = get_loss(task).name
    if task in ("logistic", "smoothed_hinge"):
        return "auc"
    if task == "squared":
        return "rmse"
    return "poisson_loss"


def select_best_model(
    entries: Sequence[SweepEntry],
    validation_batch,
    metric: Optional[str] = None,
    scorer: Optional[Callable] = None,
) -> tuple[SweepEntry, float]:
    """Pick the entry with the best validation metric; (entry, value)."""
    if not entries:
        raise ValueError("no models to select from")
    metric = metric or _default_selection_metric(entries[0].model.task)
    fn = EVALUATORS.get(metric)
    if fn is None:
        raise ValueError(f"unknown metric '{metric}'. Known: {sorted(EVALUATORS)}")
    best: Optional[tuple[SweepEntry, float]] = None
    for e in entries:
        scores = scorer(e.model) if scorer is not None else e.model.compute_score(
            validation_batch
        )
        val = float(fn(scores, validation_batch.labels, validation_batch.weights))
        if best is None or better_than(metric, val, best[1]):
            best = (e, val)
    return best
