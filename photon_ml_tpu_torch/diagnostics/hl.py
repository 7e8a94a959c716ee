"""Hosmer-Lemeshow goodness-of-fit test for logistic models.

A host-Python copy of ``photon_ml_tpu/diagnostics/hl.py`` (numpy, scipy).

Reference analog: photon-diagnostics hl/ (HosmerLemeshowDiagnostic.scala:
chi-square over predicted-probability bins with expected-vs-observed
positive/negative counts, dof = bins - 2, cutoffs at the standard
confidence levels, minimum expected count warnings;
DefaultPredictedProbabilityVersusObservedFrequencyBinner = equal-count
bins, Fixed... = equal-width bins).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.stats import chi2 as _chi2

STANDARD_CONFIDENCE_LEVELS = [
    0.000001, 0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5,
    0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 0.999999,
]  # HosmerLemeshowDiagnostic.scala
MINIMUM_EXPECTED_IN_BUCKET = 5


@dataclasses.dataclass(frozen=True)
class HistogramBin:
    """PredictedProbabilityVersusObservedFrequencyHistogramBin analog.

    ``mean_prob`` carries the weighted mean predicted probability of the
    bin's rows; the reference approximates expectation from the bin
    MIDPOINT (HistogramBin.scala:51-60) — ``expected="midpoint"``
    reproduces that, ``"mean_prob"`` is the classical (unbiased) H-L
    expectation."""

    lower_bound: float
    upper_bound: float
    observed_pos_count: float
    observed_neg_count: float
    mean_prob: float = 0.0
    expected: str = "midpoint"

    @property
    def count(self) -> float:
        return self.observed_pos_count + self.observed_neg_count

    @property
    def expected_pos_count(self) -> float:
        p = (
            0.5 * (self.lower_bound + self.upper_bound)
            if self.expected == "midpoint"
            else self.mean_prob
        )
        return p * self.count

    @property
    def expected_neg_count(self) -> float:
        return self.count - self.expected_pos_count


@dataclasses.dataclass
class HosmerLemeshowReport:
    """Chi^2 + per-bin histogram (HosmerLemeshowReport analog)."""

    bins: list[HistogramBin]
    chi_square: float
    degrees_of_freedom: int
    prob_at_chi_square: float  # P(X^2 <= observed) under H0
    cutoffs: list[tuple[float, float]]  # (confidence level, chi2 cutoff)
    warnings: list[str]

    @property
    def p_value(self) -> float:
        """P(X^2 >= observed): small means poor calibration."""
        return 1.0 - self.prob_at_chi_square

    def to_summary_string(self) -> str:
        lines = [
            f"Hosmer-Lemeshow: chi^2 = {self.chi_square:.4f} "
            f"(dof {self.degrees_of_freedom}), "
            f"P(chi^2 as extreme) = {self.p_value:.4g}"
        ]
        for b in self.bins:
            lines.append(
                f"  [{b.lower_bound:.3f}, {b.upper_bound:.3f}): "
                f"observed +{b.observed_pos_count:.0f}/-{b.observed_neg_count:.0f}, "
                f"expected +{b.expected_pos_count:.1f}/-{b.expected_neg_count:.1f}"
            )
        lines.extend(self.warnings)
        return "\n".join(lines)


def _equal_count_bins(probs: np.ndarray, num_bins: int) -> np.ndarray:
    """Decile-style boundaries (Default binner analog)."""
    qs = np.quantile(probs, np.linspace(0, 1, num_bins + 1))
    qs[0], qs[-1] = 0.0, 1.0
    return np.maximum.accumulate(qs)


def hosmer_lemeshow(
    predicted_probs: np.ndarray,
    labels: np.ndarray,
    weights: np.ndarray | None = None,
    num_bins: int = 10,
    binning: str = "equal_count",
    expected: str = "midpoint",
) -> HosmerLemeshowReport:
    """Run the H-L test on predicted probabilities vs binary labels.

    ``expected``: "midpoint" matches the reference's bin-midpoint
    expectation; "mean_prob" uses the weighted mean predicted probability
    per bin (the classical Hosmer-Lemeshow statistic)."""
    if expected not in ("midpoint", "mean_prob"):
        raise ValueError(f"unknown expected mode '{expected}'")
    probs = np.asarray(predicted_probs, np.float64)
    y = np.asarray(labels, np.float64) > 0.5
    w = (
        np.ones_like(probs)
        if weights is None
        else np.asarray(weights, np.float64)
    )
    live = w > 0
    probs, y, w = probs[live], y[live], w[live]
    if len(probs) == 0:
        raise ValueError("no rows with positive weight")

    if binning == "equal_count":
        edges = _equal_count_bins(probs, num_bins)
    elif binning == "equal_width":
        edges = np.linspace(0.0, 1.0, num_bins + 1)
    else:
        raise ValueError(f"unknown binning '{binning}'")

    which = np.clip(np.searchsorted(edges, probs, side="right") - 1, 0, num_bins - 1)
    bins = []
    warnings: list[str] = []
    chi_sq = 0.0
    for i in range(num_bins):
        sel = which == i
        pos = float(np.sum(w[sel] * y[sel]))
        neg = float(np.sum(w[sel] * ~y[sel]))
        wsum = float(np.sum(w[sel]))
        b = HistogramBin(
            lower_bound=float(edges[i]),
            upper_bound=float(edges[i + 1]),
            observed_pos_count=pos,
            observed_neg_count=neg,
            mean_prob=float(np.sum(w[sel] * probs[sel]) / wsum) if wsum else 0.0,
            expected=expected,
        )
        bins.append(b)
        # expected == 0 with observed events means unbounded chi^2; the
        # reference skips the term (HosmerLemeshowDiagnostic.scala deltaNeg
        # guard) — match that but surface a warning so the understated
        # statistic is visible
        for sign, obs, exp in (("positive", pos, b.expected_pos_count),
                               ("negative", neg, b.expected_neg_count)):
            if exp > 0:
                chi_sq += (obs - exp) ** 2 / exp
            elif obs > 0:
                warnings.append(
                    f"bin {i}: observed {sign} events with expected count 0 "
                    "— chi^2 term skipped (statistic is understated)"
                )
            if exp < MINIMUM_EXPECTED_IN_BUCKET:
                warnings.append(
                    f"bin {i}: expected {sign} count {exp:.1f} "
                    "too small for a sound chi^2 estimate"
                )

    dof = max(num_bins - 2, 1)
    dist = _chi2(dof)
    return HosmerLemeshowReport(
        bins=bins,
        chi_square=float(chi_sq),
        degrees_of_freedom=dof,
        prob_at_chi_square=float(dist.cdf(chi_sq)),
        cutoffs=[(c, float(dist.ppf(c))) for c in STANDARD_CONFIDENCE_LEVELS],
        warnings=warnings,
    )
