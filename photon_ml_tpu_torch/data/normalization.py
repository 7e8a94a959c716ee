"""Feature normalization contexts.

Counterpart of ``NormalizationType``/``NormalizationContext`` in
``photon_ml_tpu/data/normalization.py``: x' = (x - shift) * factor is applied
algebraically inside the objective, and trained coefficients map back by
w = w' * factor; intercept -= w . shift. ``build_normalization_context`` and
the feature statistics it needs (``data/stats.py``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

import torch

Tensor = torch.Tensor


class NormalizationType(str, Enum):
    NONE = "none"
    SCALE_WITH_MAX_MAGNITUDE = "scale_with_max_magnitude"
    SCALE_WITH_STANDARD_DEVIATION = "scale_with_standard_deviation"
    STANDARDIZATION = "standardization"


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """factors/shifts may be None (identity). The intercept column must be
    left unnormalized (factor 1, shift 0) for the inverse to be exact."""

    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    intercept_index: Optional[int] = None

    def _intercept(self) -> int:
        if self.intercept_index is None:
            raise ValueError("shifts require an intercept column")
        return self.intercept_index

    def transform_model_coefficients(self, w: Tensor) -> Tensor:
        """Normalized-space coefficients -> original space."""
        out = w if self.factors is None else w * self.factors
        if self.shifts is not None:
            i = self._intercept()
            delta = torch.dot(out, self.shifts)
            out = out.clone()
            out[i] = out[i] - delta
        return out

    def inverse_transform_model_coefficients(self, w: Tensor) -> Tensor:
        """Original space -> normalized space (exact inverse of the above)."""
        out = w
        if self.shifts is not None:
            i = self._intercept()
            delta = torch.dot(out, self.shifts)
            out = out.clone()
            out[i] = out[i] + delta
        if self.factors is not None:
            out = out / self.factors
        return out
