"""Model diagnostics (counterpart of ``photon_ml_tpu/diagnostics``):
bootstrap CIs, batch evaluation metrics + AIC, fitting curves,
Hosmer-Lemeshow, feature importance, Kendall-tau independence, and the
report rendering pipeline. The bootstraps solve their resamples as lanes of
one solve on the card; the rest is the reference's host code."""

from photon_ml_tpu_torch.diagnostics.bootstrap import (  # noqa: F401
    BootstrapReport,
    CoefficientSummary,
    bootstrap_train,
)
from photon_ml_tpu_torch.diagnostics.evaluation import (  # noqa: F401
    AKAIKE_INFORMATION_CRITERION,
    AREA_UNDER_PRECISION_RECALL,
    AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS,
    DATA_LOG_LIKELIHOOD,
    MEAN_ABSOLUTE_ERROR,
    MEAN_SQUARE_ERROR,
    PEAK_F1_SCORE,
    ROOT_MEAN_SQUARE_ERROR,
    area_under_pr,
    evaluate,
    peak_f1,
)
from photon_ml_tpu_torch.diagnostics.feature_importance import (  # noqa: F401
    FeatureImportanceReport,
    expected_magnitude_importance,
    variance_importance,
)
from photon_ml_tpu_torch.diagnostics.fitting import (  # noqa: F401
    FittingReport,
    fitting_diagnostic,
)
from photon_ml_tpu_torch.diagnostics.hl import (  # noqa: F401
    HistogramBin,
    HosmerLemeshowReport,
    hosmer_lemeshow,
)
from photon_ml_tpu_torch.diagnostics.independence import (  # noqa: F401
    KendallTauReport,
    kendall_tau_analysis,
    prediction_error_independence,
)
from photon_ml_tpu_torch.diagnostics.model_diagnostic import (  # noqa: F401
    ModelDiagnostic,
    TrainingDiagnostic,
    diagnose_model,
)
from photon_ml_tpu_torch.diagnostics.reporting import (  # noqa: F401
    BulletedList,
    Chapter,
    Document,
    LinePlot,
    NumberedList,
    Section,
    Table,
    Text,
    render_html,
    render_text,
)
