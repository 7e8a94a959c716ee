"""Evaluation metrics (counterpart of ``photon_ml_tpu/evaluation``)."""

from photon_ml_tpu_torch.evaluation.evaluators import (  # noqa: F401
    EVALUATORS,
    auc,
    better_than,
    logistic_loss,
    parse_evaluator,
    poisson_loss,
    rmse,
    sharded_auc,
    sharded_precision_at_k,
    smoothed_hinge_loss,
    squared_loss,
)
