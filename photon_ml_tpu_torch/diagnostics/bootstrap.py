"""Bootstrap training: per-coefficient confidence intervals and metric
distributions from resampled refits.

Counterpart of ``photon_ml_tpu/diagnostics/bootstrap.py``. Reference analog:
photon-diagnostics BootstrapTraining.scala:30-181 and
supervised/model/CoefficientSummary.scala. Each sample is a weight vector
(multinomial resample counts over the training portion, 0 on the holdout),
drawn on the host from the same seeded generator as the reference's, so the
port's weights are the reference's bit for bit. The B refits run as B lanes
over one design: a GLM's over its ``CSRBatch`` (``SharedDesign``, the lane
margins and scatter kernels), a random-effect bucket's as B*E lanes over
the bucket's design (``sweep.runner.re_bootstrap_solve``). A lane's solve
does not depend on the other lanes, so the lanes of a gathered subset of
entities come out bit for bit as the full run's on those entities.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.device import check_on, resolve_device
from photon_ml_tpu_torch.diagnostics.evaluation import evaluate
from photon_ml_tpu_torch.models.glm import make_model
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.shared_design import SharedDesign
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.factory import OptimizerConfig, dispatch_solve
from photon_ml_tpu_torch.telemetry.executables import instrumented

Tensor = torch.Tensor


# the B resamples' solve over the shared design, as an accounted executable
_bootstrap_glm_solve = instrumented(dispatch_solve, name="bootstrap_glm_solve")


def _host(t: Tensor, label: str) -> np.ndarray:
    """One counted device-to-host fetch."""
    telemetry.counter("host_syncs").inc()
    with telemetry.span(f"fetch:{label}"):
        return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class CoefficientSummary:
    """Per-scalar accumulation summary (CoefficientSummary.scala analog:
    count/mean/stddev/min/max + quartile estimates)."""

    count: int
    mean: float
    std_dev: float
    min: float
    max: float
    q1: float
    median: float
    q3: float

    @staticmethod
    def of(samples: np.ndarray) -> "CoefficientSummary":
        s = np.asarray(samples, np.float64)
        q1, med, q3 = np.percentile(s, [25, 50, 75])
        return CoefficientSummary(
            count=int(s.size),
            mean=float(s.mean()),
            std_dev=float(s.std(ddof=1)) if s.size > 1 else 0.0,
            min=float(s.min()),
            max=float(s.max()),
            q1=float(q1),
            median=float(med),
            q3=float(q3),
        )

    def contains_zero(self) -> bool:
        return self.min <= 0.0 <= self.max

    def to_summary_string(self) -> str:
        return (
            f"Range: [Min: {self.min:.3f}, Q1: {self.q1:.3f}, "
            f"Med: {self.median:.3f}, Q3: {self.q3:.3f}, Max: {self.max:.3f}) "
            f"Mean: [{self.mean:.3f}], Std. Dev.[{self.std_dev:.3f}], "
            f"# samples = [{self.count}]"
        )


@dataclasses.dataclass
class BootstrapReport:
    """Aggregates over bootstrap refits (BootstrapReport analog)."""

    coefficient_summaries: list[CoefficientSummary]  # 1:1 with coefficients
    metric_summaries: dict[str, CoefficientSummary]
    models: Optional[list] = None  # per-sample GLMs when keep_models

    def significant_coefficients(self) -> np.ndarray:
        """Indices whose bootstrap CI (min..max) excludes zero."""
        return np.asarray([i for i, s in enumerate(self.coefficient_summaries)
                           if not s.contains_zero()], np.int64)


def bootstrap_sample_weights(base_w: np.ndarray, num_samples: int, train_portion: float,
                             seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(sample weights [B, n], holdout masks [B, n]) of ``bootstrap_train``:
    per sample a permutation of the live (weight > 0) rows splits them at
    ``train_portion`` and multinomial counts resample the training part, in
    the reference's order of draws from one seeded generator."""
    rng = np.random.default_rng(seed)
    n_pad = len(base_w)
    live = base_w > 0
    n_live = int(live.sum())
    sample_weights = np.zeros((num_samples, n_pad))
    holdout_masks = np.zeros((num_samples, n_pad), bool)
    live_idx = np.nonzero(live)[0]
    n_train = max(int(round(train_portion * n_live)), 1)
    for b in range(num_samples):
        perm = rng.permutation(n_live)
        train_rows = live_idx[perm[:n_train]]
        holdout_rows = live_idx[perm[n_train:]]
        counts = rng.multinomial(n_train, np.full(n_train, 1.0 / n_train))
        sample_weights[b, train_rows] = base_w[train_rows] * counts
        holdout_masks[b, holdout_rows] = True
    return sample_weights, holdout_masks


def bootstrap_train(
    batch,
    task: str,
    config: OptimizerConfig,
    num_samples: int = 16,
    train_portion: float = 0.8,
    seed: int = 0,
    keep_models: bool = False,
    metrics_fn: Optional[Callable] = None,
    normalization=None,
    device: torch.device | str | None = None,
) -> BootstrapReport:
    """Train ``num_samples`` bootstrap refits of a GLM over a ``CSRBatch`` on
    ``device`` (default cuda) and aggregate.

    Each sample: rows are split train/holdout at ``train_portion`` (capped
    at 0.9 like the reference's 900/1000 splits), the training rows receive
    multinomial resample counts as weight multipliers (sampling with
    replacement), and the model refits from zero; the B refits are B lanes
    of one solve. Holdout metrics (``diagnostics.evaluate`` per model) feed
    the metric distributions."""
    dev = resolve_device(device)
    check_on(dev, batch.labels)
    if num_samples < 2:
        raise ValueError("num_samples must be at least 2")
    if not 0.0 < train_portion <= 1.0:
        raise ValueError(f"train_portion must be in (0, 1], got {train_portion}")
    train_portion = min(train_portion, 0.9)
    config.validate(task)

    base_w = _host(batch.weights, "bootstrap_base_weights")
    sample_weights, holdout_masks = bootstrap_sample_weights(base_w, num_samples,
                                                             train_portion, seed)
    factors = shifts = None
    if normalization is not None:
        factors, shifts = normalization.factors, normalization.shifts
    obj = make_objective(
        task, l2_weight=config.regularization.l2_weight(config.regularization_weight),
        factors=factors, shifts=shifts)
    l1 = config.regularization.l1_weight(config.regularization_weight)
    design = SharedDesign.of(batch, num_samples,
                             weights=torch.from_numpy(sample_weights.astype(np.float32)).to(dev))
    w0 = torch.zeros((num_samples, batch.num_features), dtype=torch.float32, device=dev)
    constraints = config.build_box_constraints(int(batch.num_features), dev)
    res = _bootstrap_glm_solve(glm_adapter(obj, design), w0, config, l1, constraints,
                               device=dev)
    W_dev = res.w
    if normalization is not None:
        # models live in the original space (createModel parity)
        W_dev = torch.stack([normalization.transform_model_coefficients(w) for w in res.w])
    W = _host(W_dev, "bootstrap_coefficients")  # [B, d], one fetch

    coef_summaries = [CoefficientSummary.of(W[:, j]) for j in range(W.shape[1])]
    metric_samples: dict[str, list[float]] = {}
    models = []
    for b in range(num_samples):
        m = make_model(task, W_dev[b].clone())
        models.append(m)
        hold_w = torch.from_numpy(np.where(holdout_masks[b], base_w, 0.0).astype(np.float32))
        hb = dataclasses.replace(batch, weights=hold_w.to(dev))
        mm = metrics_fn(m, hb) if metrics_fn is not None else evaluate(m, hb)
        for k, v in mm.items():
            metric_samples.setdefault(k, []).append(v)

    return BootstrapReport(
        coefficient_summaries=coef_summaries,
        metric_summaries={k: CoefficientSummary.of(np.asarray(v))
                          for k, v in metric_samples.items()},
        models=models if keep_models else None,
    )


# ---------------------------------------------------------------------------
# GLMix (random-effect) bootstrap: B resamples as lanes of the bucket solve
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReBootstrapReport:
    """Per-entity-coefficient bootstrap aggregates for one RE bucket: every
    array is [E, K] over the bucket's entity x coefficient grid. The CI
    bounds are the 2.5/97.5 bootstrap percentiles. ``samples`` keeps the
    lanes' coefficients themselves (the port's addition: the determinism
    check holds them lane for lane)."""

    num_samples: int
    mean: np.ndarray
    std_dev: np.ndarray
    q1: np.ndarray
    median: np.ndarray
    q3: np.ndarray
    ci_low: np.ndarray
    ci_high: np.ndarray
    live_entities: np.ndarray  # bool [E]; False = padding / empty lane
    samples: Optional[np.ndarray] = None  # f32 [B, E, K]: each lane's coefficients

    def contains_zero(self) -> np.ndarray:
        """bool [E, K]: CI straddles zero (not significant)."""
        return (self.ci_low <= 0.0) & (0.0 <= self.ci_high)

    def summary(self) -> dict:
        """JSON-safe rollup: how wide the error bars are and how much of the
        grid is distinguishable from zero, over live entity lanes."""
        live = np.asarray(self.live_entities, bool)
        width = (self.ci_high - self.ci_low)[live]
        cz = self.contains_zero()[live]
        if width.size == 0:
            return {"entities": 0, "num_samples": self.num_samples}
        return {
            "entities": int(live.sum()),
            "coefficients_per_entity": int(self.mean.shape[1]),
            "num_samples": self.num_samples,
            "mean_ci_width": round(float(width.mean()), 6),
            "max_ci_width": round(float(width.max()), 6),
            "contains_zero_fraction": round(float(cz.mean()), 6),
        }


def bootstrap_re_weights(num_samples: int, base_weights: np.ndarray,
                         seed: int = 0) -> np.ndarray:
    """[B, E, R] multinomial resample-count multipliers, drawn per entity
    over its live (weight > 0) rows; padding rows stay zero.

    Entity draws are independent and consumed in entity order from one
    seeded generator, so gathering entity lanes out of the full array sees
    exactly the draws the full-lane bootstrap used for those entities."""
    bw = np.asarray(base_weights, np.float64)
    B, (E, R) = num_samples, bw.shape
    rng = np.random.default_rng(seed)
    out = np.zeros((B, E, R))
    for e in range(E):
        live = np.nonzero(bw[e] > 0)[0]
        n = live.size
        if n == 0:
            continue
        counts = rng.multinomial(n, np.full(n, 1.0 / n), size=B)
        out[:, e, live] = counts
    return out


def bootstrap_random_effect(
    ebatch,
    task: str,
    config: OptimizerConfig,
    w0,
    num_samples: int = 32,
    seed: int = 0,
    lane_weights: Optional[np.ndarray] = None,
    normalization=None,
    device: torch.device | str | None = None,
) -> ReBootstrapReport:
    """Bootstrap one random-effect bucket on ``device`` (default cuda): B
    weight-resample groups of its E entities solve as B*E lanes
    (``sweep.runner.re_bootstrap_solve``), every lane warm-started from the
    point estimate ``w0 [E, K]``. ``ebatch`` is the bucket's batch, a
    ``DenseBatch`` or a ``BlockDiagonalBatch``.

    ``lane_weights [B, E, R]`` overrides the drawn multipliers (a gathered
    slice of a full-bucket draw gives that draw's entities exactly)."""
    from photon_ml_tpu_torch.sweep.runner import re_bootstrap_solve

    dev = resolve_device(device)
    check_on(dev, ebatch.labels)
    if num_samples < 2:
        raise ValueError("num_samples must be at least 2")
    config.validate(task)
    if lane_weights is None:
        base_w = _host(ebatch.weights, "bootstrap_re_base_weights")
        lane_weights = bootstrap_re_weights(num_samples, base_w, seed)
    else:
        lane_weights = np.asarray(lane_weights)
    live_entities = lane_weights.sum(axis=(0, 2)) > 0

    factors = shifts = None
    if normalization is not None:
        factors, shifts = normalization.factors, normalization.shifts
    obj = make_objective(
        task, l2_weight=config.regularization.l2_weight(config.regularization_weight),
        factors=factors, shifts=shifts)
    l1 = config.regularization.l1_weight(config.regularization_weight)
    w0 = torch.as_tensor(np.asarray(w0, np.float32) if not isinstance(w0, Tensor) else w0,
                         dtype=torch.float32).to(dev)
    res = re_bootstrap_solve(config, obj, ebatch,
                             torch.from_numpy(lane_weights.astype(np.float32)).to(dev), w0, l1,
                             device=dev)
    B = lane_weights.shape[0]
    # [B, E, K], fetched once
    samples = _host(res.w, "bootstrap_re_coefficients").reshape(B, *w0.shape)
    W = samples.astype(np.float64)

    q1, med, q3 = np.percentile(W, [25, 50, 75], axis=0)
    lo, hi = np.percentile(W, [2.5, 97.5], axis=0)
    return ReBootstrapReport(
        num_samples=int(W.shape[0]),
        mean=W.mean(axis=0),
        std_dev=W.std(axis=0, ddof=1) if W.shape[0] > 1 else np.zeros(W.shape[1:], np.float64),
        q1=q1,
        median=med,
        q3=q3,
        ci_low=lo,
        ci_high=hi,
        live_entities=live_entities,
        samples=samples,
    )
