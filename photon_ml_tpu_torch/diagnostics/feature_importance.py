"""Per-feature importance diagnostics.

Counterpart of ``photon_ml_tpu/diagnostics/feature_importance.py``: the
coefficients and the port's ``FeatureSummary`` come to the host once, and
the ranking is the reference's numpy. Reference analog: photon-diagnostics featureimportance/ — expected-magnitude
importance |coef_j| * meanAbs(x_j) (ExpectedMagnitudeFeatureImportance
Diagnostic.scala) and variance importance |coef_j * Var(x_j)|
(VarianceFeatureImportanceDiagnostic.scala); both fall back to |coef_j|
without a feature summary, and report rank-ordered (name, importance).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.data.stats import FeatureSummary
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel


@dataclasses.dataclass
class FeatureImportanceReport:
    """Rank-ordered importances (FeatureImportanceReport analog)."""

    importance_type: str
    importance_description: str
    ranked: list[tuple[str, int, float]]  # (feature key, index, importance)

    def top(self, k: int) -> list[tuple[str, int, float]]:
        return self.ranked[:k]

    def to_summary_string(self, k: int = 20) -> str:
        lines = [f"{self.importance_type} ({self.importance_description}):"]
        for name, idx, imp in self.top(k):
            lines.append(f"  {name} [{idx}]: {imp:.6g}")
        return "\n".join(lines)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _rank(
    importances: np.ndarray, feature_names: Optional[Sequence[str]]
) -> list[tuple[str, int, float]]:
    order = np.argsort(-importances)
    return [
        (
            feature_names[int(i)] if feature_names is not None else str(int(i)),
            int(i),
            float(importances[i]),
        )
        for i in order
    ]


def expected_magnitude_importance(
    model: GeneralizedLinearModel,
    summary: Optional[FeatureSummary] = None,
    feature_names: Optional[Sequence[str]] = None,
) -> FeatureImportanceReport:
    """|coef_j| * E|x_j| (falls back to |coef_j| without a summary)."""
    coefs = _host(model.coefficients.means)
    exp_abs = (
        _host(summary.mean_abs) if summary is not None else np.ones_like(coefs)
    )
    return FeatureImportanceReport(
        importance_type="Inner product expectation",
        importance_description=(
            "Expected magnitude of inner product contribution"
            if summary is not None
            else "Magnitude of feature coefficient"
        ),
        ranked=_rank(np.abs(coefs * exp_abs), feature_names),
    )


def variance_importance(
    model: GeneralizedLinearModel,
    summary: Optional[FeatureSummary] = None,
    feature_names: Optional[Sequence[str]] = None,
) -> FeatureImportanceReport:
    """|coef_j * Var(x_j)| (falls back to |coef_j| without a summary)."""
    coefs = _host(model.coefficients.means)
    var = (
        _host(summary.variance) if summary is not None else np.ones_like(coefs)
    )
    return FeatureImportanceReport(
        importance_type="Inner product variance",
        importance_description=(
            "Expected inner product variance contribution"
            if summary is not None
            else "Magnitude of feature coefficient"
        ),
        ranked=_rank(np.abs(coefs * var), feature_names),
    )
