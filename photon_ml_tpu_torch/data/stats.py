"""Per-feature statistical summaries of a batch, computed on its device.

Counterpart of ``photon_ml_tpu/data/stats.py`` (``FeatureSummary`` and
``summarize``, :26-88), with the same semantics: only valid (weight > 0)
rows count; zeros count toward the mean and variance (features are dense
with zeros); the variance is the unbiased N-1 estimator; max and min take
the implicit zeros into account whenever a feature has fewer nonzeros than
rows, and a feature with no observations has max = min = 0.

On a ``CSRBatch``, sum x and sum x^2 are ``feature_moment_sums``, the CSC
scatter kernel (``csrc/scatter.cu``) plain and ``square``, and so is the
nonzero count. The L1 norm, the maxima and the minima are segment
reductions (``torch.segment_reduce``) over the column-major view, one
feature's run each, in a fixed order. Nothing reduces through float atomics,
so two summaries of one batch are bit-identical. A ``SparseBatch`` takes
its moment sums from its own ``feature_moment_sums`` and the rest from the
same segment reductions over its nonzeros sorted by feature.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.ops.csr import CSRBatch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FeatureSummary:
    mean: Tensor
    variance: Tensor  # unbiased (N-1)
    count: Tensor  # scalar: the number of valid rows
    num_nonzeros: Tensor
    max: Tensor
    min: Tensor
    norm_l1: Tensor
    norm_l2: Tensor
    mean_abs: Tensor


def _column_major(batch) -> tuple[Tensor, Tensor, Tensor]:
    """(lengths i64[F], rows i64, vals): each feature's nonzeros as one
    contiguous run, features ascending."""
    if isinstance(batch, CSRBatch):
        col_ptr, rows, vals = batch.column_major()
        return torch.diff(col_ptr.long()), rows.long(), vals
    order = torch.argsort(batch.cols, stable=True)
    lengths = torch.bincount(batch.cols, minlength=batch.num_features)
    return lengths, batch.rows[order], batch.values[order]


def summarize(batch) -> FeatureSummary:
    """Per-feature statistics over the valid (weight > 0) rows of a
    ``SparseBatch`` or a ``CSRBatch``."""
    dtype = batch.dtype
    valid_row = (batch.weights > 0).to(dtype)
    n = torch.sum(valid_row)
    s1, s2, nnz = batch.feature_moment_sums()
    lengths, rows, vals = _column_major(batch)
    valid_nnz = valid_row.index_select(0, rows)

    def per_feature(x: Tensor, reduce: str, initial: float) -> Tensor:
        return torch.segment_reduce(x, reduce, lengths=lengths, initial=initial)

    sabs = per_feature(torch.abs(vals * valid_nnz), "sum", 0.0)
    # zero entries (explicit zeros and the reference's nnz padding) stay out
    # of the max and min; the has_zero correction folds them back in
    big = torch.finfo(dtype).max
    present = (valid_nnz > 0) & (vals != 0)
    maxv = per_feature(torch.where(present, vals, -big), "max", -big)
    minv = per_feature(torch.where(present, vals, big), "min", big)
    has_zero = nnz < n
    maxv = torch.where(has_zero, torch.clamp(maxv, min=0.0), maxv)
    minv = torch.where(has_zero, torch.clamp(minv, max=0.0), minv)
    maxv = torch.where(nnz == 0, 0.0, maxv)
    minv = torch.where(nnz == 0, 0.0, minv)

    n1 = torch.clamp(n, min=1.0)
    mean = s1 / n1
    var = torch.clamp((s2 - n * mean * mean) / torch.clamp(n - 1.0, min=1.0), min=0.0)
    return FeatureSummary(
        mean=mean,
        variance=var,
        count=n,
        num_nonzeros=nnz,
        max=maxv,
        min=minv,
        norm_l1=sabs,
        norm_l2=torch.sqrt(s2),
        mean_abs=sabs / n1,
    )
