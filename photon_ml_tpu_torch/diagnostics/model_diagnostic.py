"""Diagnostic interfaces + the full-model diagnostic report composer.

Counterpart of ``photon_ml_tpu/diagnostics/model_diagnostic.py``: the
metrics are the port's ``evaluate`` on the batch's device, the scores,
labels and weights come to the host once, and the rest is the reference's
host code. Reference analog: photon-diagnostics ModelDiagnostic.scala /
TrainingDiagnostic.scala (the trait pair each diagnostic implements) and the
legacy Driver's diagnose stage (Driver.scala:600-627), which runs fitting /
bootstrap / H-L / feature importances / independence analysis and renders
one HTML report per model.
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence

import numpy as np

from photon_ml_tpu_torch.data.stats import FeatureSummary
from photon_ml_tpu_torch.diagnostics.evaluation import evaluate
from photon_ml_tpu_torch.diagnostics.feature_importance import (
    expected_magnitude_importance,
    variance_importance,
)
from photon_ml_tpu_torch.diagnostics.hl import hosmer_lemeshow
from photon_ml_tpu_torch.diagnostics.independence import prediction_error_independence
from photon_ml_tpu_torch.diagnostics.reporting import (
    BulletedList,
    Chapter,
    Document,
    Section,
    Table,
    Text,
)
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.losses import get_loss


class ModelDiagnostic(Protocol):
    """Computes a per-model report from a trained model + data
    (ModelDiagnostic.scala analog)."""

    def diagnose(self, model: GeneralizedLinearModel, data) -> object: ...


class TrainingDiagnostic(Protocol):
    """Computes a report from a model FACTORY + data (learning curves,
    bootstrap; TrainingDiagnostic.scala analog)."""

    def diagnose(self, model_factory, data) -> object: ...


def diagnose_model(
    model: GeneralizedLinearModel,
    batch,
    summary: Optional[FeatureSummary] = None,
    feature_names: Optional[Sequence[str]] = None,
    top_k_features: int = 20,
) -> Document:
    """Compose the standard per-model diagnostic document: metrics, feature
    importances, H-L calibration (logistic only), error independence."""
    task = get_loss(model.task).name
    metrics = evaluate(model, batch)
    sections = [
        Section(
            "Validation metrics",
            [Table(header=["metric", "value"],
                   rows=[(k, f"{v:.6g}") for k, v in sorted(metrics.items())])],
        )
    ]

    imp_rows = []
    for rep in (
        expected_magnitude_importance(model, summary, feature_names),
        variance_importance(model, summary, feature_names),
    ):
        imp_rows.append(
            Section(
                rep.importance_type,
                [
                    Text(rep.importance_description),
                    Table(
                        header=["feature", "index", "importance"],
                        rows=[
                            (n, i, f"{v:.6g}")
                            for n, i, v in rep.top(top_k_features)
                        ],
                    ),
                ],
            )
        )

    chapters = [
        Chapter("Model evaluation", sections),
        Chapter("Feature importance", imp_rows),
    ]

    # compute_score already includes batch.offsets (margins semantics)
    scores, labels, weights = (
        t.detach().cpu().numpy()
        for t in (model.compute_score(batch), batch.labels, batch.weights))

    if task == "logistic":
        probs = 1.0 / (1.0 + np.exp(-scores))
        hl = hosmer_lemeshow(probs, labels, weights)
        chapters.append(
            Chapter(
                "Calibration (Hosmer-Lemeshow)",
                [
                    Section(
                        "Chi-square test",
                        [
                            Text(
                                f"chi^2 = {hl.chi_square:.4f}, "
                                f"dof = {hl.degrees_of_freedom}, "
                                f"p = {hl.p_value:.4g}"
                            ),
                            Table(
                                header=[
                                    "bin", "observed +", "observed -",
                                    "expected +", "expected -",
                                ],
                                rows=[
                                    (
                                        f"[{b.lower_bound:.3f}, {b.upper_bound:.3f})",
                                        f"{b.observed_pos_count:.0f}",
                                        f"{b.observed_neg_count:.0f}",
                                        f"{b.expected_pos_count:.1f}",
                                        f"{b.expected_neg_count:.1f}",
                                    )
                                    for b in hl.bins
                                ],
                            ),
                        ]
                        + ([BulletedList(hl.warnings)] if hl.warnings else []),
                    )
                ],
            )
        )

    live = weights > 0
    kt = prediction_error_independence(scores[live], labels[live])
    chapters.append(
        Chapter(
            "Prediction-error independence",
            [Section("Kendall tau", [Text(kt.to_summary_string())])],
        )
    )
    return Document(title=f"Model diagnostics ({model.task})", chapters=chapters)
