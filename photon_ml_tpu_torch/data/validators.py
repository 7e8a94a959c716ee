"""Row-level data sanity checks per task type.

Counterpart of ``photon_ml_tpu/data/validators.py`` (:18-113): finite
feature values, labels, offsets and weights; non-negative weights; binary
labels for logistic and hinge tasks; non-negative labels for Poisson. Modes
FULL, SAMPLE and DISABLED. The checks run on the host over the batch's
arrays (a ``SparseBatch`` or a ``CSRBatch``; the values in row order, as
both hold them), and SAMPLE draws its rows and values from
``np.random.default_rng(seed)`` in the reference's order, so both packages
check the same entries.
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from photon_ml_tpu_torch.ops.csr import CSRBatch


class ValidationMode(str, Enum):
    FULL = "validate_full"
    SAMPLE = "validate_sample"
    DISABLED = "validate_disabled"


class DataValidationError(ValueError):
    pass


def _sample_mask(n: int, mode: ValidationMode, rng: np.random.Generator) -> np.ndarray:
    if mode == ValidationMode.SAMPLE:
        return rng.random(n) < max(0.01, min(1.0, 1000.0 / max(n, 1)))
    return np.ones(n, dtype=bool)


def _sample_indices(n: int, rng: np.random.Generator) -> np.ndarray:
    """A subsample of [0, n) of about max(1%, 1000) entries, drawn with
    replacement in O(k) memory."""
    if n == 0:
        return np.zeros(0, np.int64)
    k = max(10, min(n, int(n * max(0.01, min(1.0, 1000.0 / n)))))
    return rng.integers(0, n, size=min(k, n))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def validate(
    batch,
    task: str,
    mode: ValidationMode = ValidationMode.FULL,
    seed: int = 0,
    collect_all: bool = False,
) -> None:
    """Raise ``DataValidationError`` on the first failed check, or, with
    ``collect_all``, run every check and raise one error that lists every
    failure."""
    mode = ValidationMode(mode)
    if mode == ValidationMode.DISABLED:
        return
    rng = np.random.default_rng(seed)
    failures: list[str] = []

    def fail(message: str) -> None:
        if not collect_all:
            raise DataValidationError(message)
        failures.append(message)

    labels = _host(batch.labels)
    offsets = _host(batch.offsets)
    weights = _host(batch.weights)
    values = _host(batch.vals if isinstance(batch, CSRBatch) else batch.values)
    valid_rows = weights > 0

    # SAMPLE subsamples every scan (rows and values); FULL scans everything,
    # without copying the values. Weights are sampled by the row mask alone:
    # a NaN weight fails > 0, so filtering by valid rows would hide it.
    sampling = mode == ValidationMode.SAMPLE
    row_mask = _sample_mask(len(labels), mode, rng)
    mask = row_mask & valid_rows
    vals = values[_sample_indices(len(values), rng)] if sampling else values

    def samp(arr: np.ndarray) -> np.ndarray:
        return arr[row_mask] if sampling else arr

    if not np.all(np.isfinite(vals)):
        fail("non-finite feature values")
    for name, arr in (("labels", labels), ("offsets", offsets)):
        if not np.all(np.isfinite(arr[mask] if sampling else arr[valid_rows])):
            fail(f"non-finite {name}")
    if not np.all(np.isfinite(samp(weights))):
        fail("non-finite weights")
    if np.any(samp(weights) < 0):
        fail("negative weights")

    task_l = task.lower()
    if "logistic" in task_l or "hinge" in task_l or "svm" in task_l:
        lab = labels[mask]
        lab = lab[np.isfinite(lab)]  # non-finite labels are reported above
        ok = np.isin(lab, (0.0, 1.0)) | np.isin(lab, (-1.0, 1.0))
        if not np.all(ok):
            fail(f"binary task requires labels in {{0,1}} or {{-1,1}}; "
                 f"found {np.unique(lab[~ok])[:5]}")
    if "poisson" in task_l and np.any(labels[mask] < 0):
        fail("poisson task requires non-negative labels")

    if failures:
        raise DataValidationError(
            f"{len(failures)} validation check(s) failed: " + "; ".join(failures))
