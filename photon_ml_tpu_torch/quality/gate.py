"""Champion/challenger publish gate: candidate quality stats with
bootstrap error bars, and the no-regression decision.

Counterpart of ``photon_ml_tpu/quality/gate.py``:

- :func:`game_quality_stats` scores a model on an evaluation set through
  the port's ``GameModel.score`` (the fixed effect on the ``csr_margins``
  kernel) and returns :class:`QualityStats` — the weighted AUC with a
  bootstrap confidence interval (the resample counts of
  ``diagnostics.bootstrap.bootstrap_re_weights`` over the rows, one host
  fetch of the margin vector, no extra solves) plus Hosmer–Lemeshow
  calibration (``diagnostics.hl``) for logistic tasks;
- :func:`decide_gate` compares a candidate against the champion's recorded
  stats: a candidate whose AUC falls below the champion's bootstrap CI
  lower bound, or whose H-L calibration collapses while the champion's
  held, is refused. ``serving/registry.py`` turns a refusal into a
  quarantined version directory and raises :class:`QualityGateRefused`.
  ``override=True`` records a ``bypassed`` decision and publishes anyway.

Fault seam: ``quality.publish_gate`` fires in the gated publish path
before any registry write.

AUC is computed on margins (scores + offsets): every supported link is
monotone, so the ranking, hence the AUC, does not depend on it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from photon_ml_tpu_torch import faults, telemetry

__all__ = [
    "FP_PUBLISH_GATE",
    "HL_P_FLOOR",
    "QualityStats",
    "GateDecision",
    "QualityGateRefused",
    "weighted_auc",
    "game_quality_stats",
    "decide_gate",
]

FP_PUBLISH_GATE = faults.register_point(
    "quality.publish_gate",
    description="gated publish_version, after candidate stats are in "
    "hand but before ANY registry write — a kill here must leave the "
    "registry exactly as it was (no partial, no wrong quarantine)",
)

#: A candidate whose Hosmer-Lemeshow p-value drops below this while the
#: champion's held above it is mis-calibrated beyond noise: quarantine.
HL_P_FLOOR = 1e-4


def weighted_auc(
    scores: np.ndarray, labels: np.ndarray, weights: np.ndarray
) -> float:
    """Exact weighted ROC AUC on host arrays (ties count half), the
    probability a random positive outranks a random negative. NaN when
    either class has no weight — degenerate sets cannot gate."""
    s = np.asarray(scores, np.float64).ravel()
    _, inv = np.unique(s, return_inverse=True)
    return _ranked_auc(inv, labels, weights)


def _ranked_auc(inv: np.ndarray, labels: np.ndarray, weights: np.ndarray) -> float:
    """``weighted_auc`` from the scores' tie-group ranks ``inv`` (the
    inverse of ``np.unique``), so resamples of one score vector sort once."""
    y = np.asarray(labels, np.float64).ravel()
    w = np.asarray(weights, np.float64).ravel()
    pos = y > 0.5
    wpos = np.where(pos, w, 0.0)
    wneg = np.where(pos, 0.0, w)
    tot_pos, tot_neg = wpos.sum(), wneg.sum()
    if tot_pos <= 0 or tot_neg <= 0:
        return float("nan")
    pos_per = np.bincount(inv, weights=wpos)
    neg_per = np.bincount(inv, weights=wneg)
    neg_below = np.cumsum(neg_per) - neg_per
    num = (pos_per * (neg_below + 0.5 * neg_per)).sum()
    return (num / (tot_pos * tot_neg)).item()


@dataclasses.dataclass
class QualityStats:
    """One model's gate-relevant quality on one evaluation set; the
    JSON form rides version metadata (``extra.quality``) and lineage."""

    auc: float
    auc_ci_low: float
    auc_ci_high: float
    rows: int
    bootstrap_samples: int
    hl_chi_square: Optional[float] = None
    hl_p_value: Optional[float] = None

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        return {k: v for k, v in out.items() if v is not None}

    @classmethod
    def from_json(cls, payload: dict) -> "QualityStats":
        """Tolerant load from a metadata quality block (extra keys —
        the recorded gate decision, bootstrap summaries — ignored)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in payload.items() if k in fields}
        kept.setdefault("auc", float("nan"))
        kept.setdefault("auc_ci_low", float("nan"))
        kept.setdefault("auc_ci_high", float("nan"))
        kept.setdefault("rows", 0)
        kept.setdefault("bootstrap_samples", 0)
        return cls(**kept)


def game_quality_stats(
    model,
    data,
    num_samples: int = 32,
    seed: int = 0,
) -> QualityStats:
    """Candidate quality on ``data``: AUC with a ``num_samples``-way
    bootstrap CI, plus H-L calibration for logistic tasks. One device
    fetch (the margin vector); resampling is host-side reweighting, so
    B=32 costs milliseconds on top of the score pass. The resample counts
    are ``bootstrap_re_weights`` over the rows as one entity: the
    reference's multinomial draw from the same seed."""
    from photon_ml_tpu_torch.diagnostics.bootstrap import bootstrap_re_weights
    from photon_ml_tpu_torch.ops.losses import get_loss

    scores = model.score(data)
    fetched = telemetry.sync_fetch(scores, label="quality.gate_scores")
    n = int(data.num_rows)
    margins = np.asarray(fetched, np.float64)[:n] + np.asarray(
        data.offset, np.float64
    )[:n]
    labels = np.asarray(data.response, np.float64)[:n]
    weights = np.asarray(data.weight, np.float64)[:n]

    _, inv = np.unique(margins, return_inverse=True)
    auc = _ranked_auc(inv, labels, weights)
    lo = hi = auc
    if num_samples > 0 and n > 1 and not math.isnan(auc):
        counts = bootstrap_re_weights(num_samples, np.ones((1, n)), seed=seed)[:, 0, :]
        resampled = [
            _ranked_auc(inv, labels, weights * counts[b])
            for b in range(num_samples)
        ]
        resampled = [a for a in resampled if not math.isnan(a)]
        if resampled:
            lo, hi = np.percentile(resampled, [2.5, 97.5]).tolist()

    hl_chi = hl_p = None
    if get_loss(model.task).name == "logistic":
        from photon_ml_tpu_torch.diagnostics.hl import hosmer_lemeshow

        probs = 1.0 / (1.0 + np.exp(-margins))
        try:
            report = hosmer_lemeshow(probs, labels, weights)
            hl_chi = round(float(report.chi_square), 6)
            hl_p = float(report.p_value)
        except Exception:  # noqa: BLE001 — calibration is advisory
            pass

    telemetry.counter("quality.stats_computed").inc()
    return QualityStats(
        auc=auc,
        auc_ci_low=lo,
        auc_ci_high=hi,
        rows=n,
        bootstrap_samples=num_samples,
        hl_chi_square=hl_chi,
        hl_p_value=hl_p,
    )


@dataclasses.dataclass
class GateDecision:
    """The recorded outcome of one gated publish attempt."""

    decision: str  # published | quarantined | bypassed | no_champion
    reason: str
    champion_version: Optional[str] = None
    candidate: Optional[dict] = None
    champion: Optional[dict] = None
    metric: str = "auc"

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        return {k: v for k, v in out.items() if v is not None}


class QualityGateRefused(RuntimeError):
    """A gated publish refused the candidate. ``decision`` carries the
    full :class:`GateDecision`; ``quarantine_path`` the directory the
    registry parked the refused version under (invisible to version
    scans), so the evidence survives for offline diagnosis."""

    def __init__(self, decision: GateDecision, quarantine_path=None):
        super().__init__(
            f"quality gate refused candidate vs champion "
            f"{decision.champion_version}: {decision.reason}"
        )
        self.decision = decision
        self.quarantine_path = quarantine_path


def decide_gate(
    candidate: QualityStats,
    champion_quality: Optional[dict],
    champion_version: Optional[str] = None,
    override: bool = False,
    hl_p_floor: float = HL_P_FLOOR,
) -> GateDecision:
    """Champion/challenger comparison. Quarantine iff a champion with
    recorded stats exists AND (the candidate's AUC falls below the
    champion's bootstrap CI lower bound, or the candidate's H-L
    calibration collapsed below ``hl_p_floor`` while the champion's
    held). Everything else publishes, with the reason recorded."""
    cand_json = candidate.to_json()
    if override:
        return GateDecision(
            decision="bypassed",
            reason="gate override requested (--no-quality-gate)",
            champion_version=champion_version,
            candidate=cand_json,
            champion=champion_quality,
        )
    if champion_quality is None:
        return GateDecision(
            decision="no_champion",
            reason="no champion with recorded quality stats in lineage",
            candidate=cand_json,
        )
    champ = QualityStats.from_json(champion_quality)
    if math.isnan(candidate.auc) or math.isnan(champ.auc_ci_low):
        return GateDecision(
            decision="published",
            reason="AUC undefined on one side (degenerate eval set); "
            "gate cannot compare — publishing",
            champion_version=champion_version,
            candidate=cand_json,
            champion=champion_quality,
        )
    if candidate.auc < champ.auc_ci_low:
        return GateDecision(
            decision="quarantined",
            reason=(
                f"candidate auc {candidate.auc:.6f} below champion "
                f"bootstrap CI lower bound {champ.auc_ci_low:.6f} "
                f"(champion auc {champ.auc:.6f})"
            ),
            champion_version=champion_version,
            candidate=cand_json,
            champion=champion_quality,
        )
    if (
        candidate.hl_p_value is not None
        and candidate.hl_p_value < hl_p_floor
        and (champ.hl_p_value is None or champ.hl_p_value >= hl_p_floor)
    ):
        return GateDecision(
            decision="quarantined",
            reason=(
                f"candidate Hosmer-Lemeshow p {candidate.hl_p_value:.2e} "
                f"below floor {hl_p_floor:.0e} while champion held "
                f"(champion p "
                f"{'n/a' if champ.hl_p_value is None else format(champ.hl_p_value, '.2e')})"
            ),
            champion_version=champion_version,
            candidate=cand_json,
            champion=champion_quality,
        )
    return GateDecision(
        decision="published",
        reason=(
            f"candidate auc {candidate.auc:.6f} within champion CI "
            f"[{champ.auc_ci_low:.6f}, {champ.auc_ci_high:.6f}]"
        ),
        champion_version=champion_version,
        candidate=cand_json,
        champion=champion_quality,
    )
