"""Host-side helpers (counterpart of ``photon_ml_tpu/utils``)."""

from photon_ml_tpu_torch.utils.timing import Timer, logger, setup_logging, timed  # noqa: F401
