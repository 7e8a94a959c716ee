"""Evaluation metrics (counterpart of ``photon_ml_tpu/evaluation``)."""
