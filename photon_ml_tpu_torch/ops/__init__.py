"""Sparse batches, losses and the GLM objective (counterpart of
``photon_ml_tpu/ops``)."""
