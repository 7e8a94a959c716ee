"""Model classes (counterpart of ``photon_ml_tpu/models``)."""
