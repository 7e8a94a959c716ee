"""Batch layouts (COO, CSR, dense entity buckets, ELL), losses and the GLM
objective (counterpart of ``photon_ml_tpu/ops``)."""
