"""The data plane (counterpart of ``photon_ml_tpu/data``): the LIBSVM
reader, index maps, feature summaries, normalization contexts, validators,
date-range paths and the model store."""

from photon_ml_tpu_torch.data.index_map import (  # noqa: F401
    INTERCEPT_KEY,
    IndexMap,
    MmapIndexMap,
    feature_key,
)
from photon_ml_tpu_torch.data.libsvm import LibSVMData, read_libsvm  # noqa: F401
from photon_ml_tpu_torch.data.normalization import (  # noqa: F401
    NormalizationContext,
    NormalizationType,
    build_normalization_context,
)
from photon_ml_tpu_torch.data.stats import FeatureSummary, summarize  # noqa: F401
from photon_ml_tpu_torch.data.validators import (  # noqa: F401
    DataValidationError,
    ValidationMode,
    validate,
)
