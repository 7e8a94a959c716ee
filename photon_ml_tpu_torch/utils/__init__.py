"""Host-side helpers (counterpart of ``photon_ml_tpu/utils``)."""
