"""The command-line drivers (counterpart of ``photon_ml_tpu/cli``): train,
score, glm and index, run as ``python -m photon_ml_tpu_torch.cli``."""
