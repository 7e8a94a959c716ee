"""Fitting (learning-curve) diagnostic: metrics as a function of training
set size, train vs hold-out, with warm-started refits.

Counterpart of ``photon_ml_tpu/diagnostics/fitting.py`` on the port's
``train_glm``. Reference analog: photon-diagnostics
fitting/FittingDiagnostic.scala:30-131: rows are tagged into
NUM_TRAINING_PARTITIONS (10) random splits, the last split is the hold-out,
and models are trained on growing prefixes of the rest with warm starts.
Training on a prefix is a weight mask over the fixed batch, drawn on the
host from the same seeded generator as the reference's, so both packages
train on the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.diagnostics.evaluation import evaluate
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.optim.factory import OptimizerConfig
from photon_ml_tpu_torch.training import train_glm

NUM_TRAINING_PARTITIONS = 10  # FittingDiagnostic.scala


@dataclasses.dataclass
class FittingReport:
    """Learning curves per regularization weight (FittingReport analog):
    metrics[metric][i] at data portion portions[i]."""

    portions: list[float]  # fraction of rows trained on, ascending
    train_metrics: dict[float, dict[str, list[float]]]  # lambda -> metric -> curve
    test_metrics: dict[float, dict[str, list[float]]]

    def fitting_msg(self) -> str:
        lines = []
        for lam, per_metric in self.test_metrics.items():
            for metric, curve in per_metric.items():
                lines.append(f"lambda={lam} {metric}: " + " -> ".join(f"{v:.4f}" for v in curve))
        return "\n".join(lines)


def fitting_diagnostic(
    batch,
    task: str,
    config: OptimizerConfig,
    lambdas: Sequence[float] = (0.0,),
    num_partitions: int = NUM_TRAINING_PARTITIONS,
    seed: int = 0,
    metrics_fn: Optional[Callable] = None,
    normalization=None,
    device: torch.device | str | None = None,
) -> FittingReport:
    """Train on growing prefixes (1/P, 2/P, ... (P-1)/P of the rows) on
    ``device`` (default cuda), with the final 1/P as hold-out; warm-start
    each portion from the previous portion's models (FittingDiagnostic
    scanLeft)."""
    if num_partitions < 3:
        raise ValueError("need at least 3 partitions")
    rng = np.random.default_rng(seed)
    dev = batch.weights.device
    base_w = batch.weights.detach().cpu().numpy().astype(np.float64)
    tags = rng.integers(0, num_partitions, len(base_w))

    def weighted(w: np.ndarray):
        return dataclasses.replace(batch, weights=torch.from_numpy(w.astype(np.float32)).to(dev))

    holdout_batch = weighted(np.where(tags == num_partitions - 1, base_w, 0.0))
    portions: list[float] = []
    train_metrics: dict[float, dict[str, list[float]]] = {float(l): {} for l in lambdas}
    test_metrics: dict[float, dict[str, list[float]]] = {float(l): {} for l in lambdas}

    n_live = max(int((base_w > 0).sum()), 1)
    warm: dict[float, GeneralizedLinearModel] = {}
    for max_tag in range(num_partitions - 1):
        mask = (tags <= max_tag) & (base_w > 0)
        portions.append(float(mask.sum()) / n_live)
        train_batch = weighted(np.where(mask, base_w, 0.0))
        entries = train_glm(train_batch, task, list(lambdas), config,
                            normalization=normalization,
                            initial_model=warm.get(max(lambdas)) if warm else None,
                            device=device)
        for e in entries:
            warm[e.reg_weight] = e.model
            fn = metrics_fn if metrics_fn is not None else evaluate
            for which, dest in ((train_batch, train_metrics), (holdout_batch, test_metrics)):
                for k, v in fn(e.model, which).items():
                    dest[e.reg_weight].setdefault(k, []).append(v)

    return FittingReport(portions=portions, train_metrics=train_metrics,
                         test_metrics=test_metrics)


def fitting_report_sections(report: FittingReport):
    """Learning curves as report sections with line plots
    (FittingToPhysicalReportTransformer analog)."""
    from photon_ml_tpu_torch.diagnostics.reporting import LinePlot, Section

    sections = []
    for lam in report.test_metrics:
        plots = []
        for metric, test_curve in report.test_metrics[lam].items():
            train_curve = report.train_metrics[lam].get(metric)
            series = {"holdout": test_curve}
            if train_curve is not None:
                series["train"] = train_curve
            plots.append(LinePlot(x=report.portions, series=series,
                                  title=f"{metric} (lambda={lam})",
                                  x_label="training data portion", y_label=metric))
        sections.append(Section(f"Learning curves (lambda={lam})", plots))
    return sections
