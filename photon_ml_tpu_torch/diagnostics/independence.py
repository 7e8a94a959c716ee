"""Prediction-error independence analysis via Kendall's tau.

A host-Python copy of ``photon_ml_tpu/diagnostics/independence.py`` (numpy).

Reference analog: photon-diagnostics independence/ (KendallTauAnalysis.scala
:68-88 — concordant/discordant pair counting, tau-alpha =
(C - D)/(C + D), tau-beta = (C - D)/sqrt(noTiesA * noTiesB), z score and
normal-approximation p-value; PredictionErrorIndependenceDiagnostic pairs
(prediction, error)).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class KendallTauReport:
    """KendallTauReport analog."""

    num_samples: int
    num_concordant: int
    num_discordant: int
    effective_pairs: int  # pairs with no tie in either variable
    tau_alpha: float
    tau_beta: float
    z_alpha: float
    p_value: float  # two-sided, normal approximation
    message: str = ""

    def to_summary_string(self) -> str:
        return (
            f"Kendall tau: alpha={self.tau_alpha:.4f} beta={self.tau_beta:.4f} "
            f"z={self.z_alpha:.3f} p={self.p_value:.4g} "
            f"(C={self.num_concordant}, D={self.num_discordant}, "
            f"n={self.num_samples})"
        )


def _pair_counts(a: np.ndarray, b: np.ndarray) -> tuple[int, int, int, int]:
    """Concordant/discordant counts + per-variable untied pair counts.

    O(n^2) on the (possibly subsampled) arrays — exact, like the
    reference's pair enumeration."""
    sa = np.sign(a[:, None] - a[None, :])
    sb = np.sign(b[:, None] - b[None, :])
    upper = np.triu(np.ones((len(a), len(a)), bool), 1)
    prod = sa * sb
    concordant = int(np.sum((prod > 0) & upper))
    discordant = int(np.sum((prod < 0) & upper))
    no_ties_a = int(np.sum((sa != 0) & upper))
    no_ties_b = int(np.sum((sb != 0) & upper))
    return concordant, discordant, no_ties_a, no_ties_b


def kendall_tau_analysis(
    a: np.ndarray,
    b: np.ndarray,
    max_samples: int = 2000,
    seed: int = 0,
) -> KendallTauReport:
    """Test independence of two paired samples via Kendall's tau.

    Pairs beyond ``max_samples`` are uniformly subsampled (pair counting is
    quadratic; the reference operates on collected samples too)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    n_total = len(a)
    if n_total < 2:
        raise ValueError("need at least 2 samples")
    msg = ""
    if n_total > max_samples:
        idx = np.random.default_rng(seed).choice(n_total, max_samples, replace=False)
        a, b = a[idx], b[idx]
        msg = f"subsampled {max_samples} of {n_total} rows"
    n = len(a)

    concordant, discordant, no_ties_a, no_ties_b = _pair_counts(a, b)
    denom = concordant + discordant
    tau_alpha = (concordant - discordant) / denom if denom else 0.0
    tb_denom = math.sqrt(float(no_ties_a) * float(no_ties_b))
    tau_beta = (concordant - discordant) / tb_denom if tb_denom else 0.0

    # var(tau) under H0 ~ 2(2n+5)/(9n(n-1)) (KendallTauAnalysis z score);
    # two-sided p-value from the normal approximation
    d = math.sqrt(2.0 * (2.0 * n + 5.0) / (9.0 * n * (n - 1.0)))
    z_alpha = tau_alpha / d if d else 0.0
    p_value = float(2.0 * (1.0 - _norm_cdf(abs(z_alpha))))
    return KendallTauReport(
        num_samples=n,
        num_concordant=concordant,
        num_discordant=discordant,
        effective_pairs=min(no_ties_a, no_ties_b),
        tau_alpha=tau_alpha,
        tau_beta=tau_beta,
        z_alpha=z_alpha,
        p_value=p_value,
        message=msg,
    )


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def prediction_error_independence(
    predictions: np.ndarray,
    labels: np.ndarray,
    max_samples: int = 2000,
    seed: int = 0,
) -> KendallTauReport:
    """Independence of predictions and errors
    (PredictionErrorIndependenceDiagnostic analog: error = label - score).
    Dependence (small p) indicates structure the model failed to capture."""
    predictions = np.asarray(predictions, np.float64)
    errors = np.asarray(labels, np.float64) - predictions
    return kendall_tau_analysis(
        predictions, errors, max_samples=max_samples, seed=seed
    )
