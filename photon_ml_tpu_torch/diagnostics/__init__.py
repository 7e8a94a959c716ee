"""Model diagnostics (counterpart of ``photon_ml_tpu/diagnostics``). Only
``evaluate``, the per-lambda metric map of the GLM driver, is ported; the
rest is ROADMAP.md Queue 1 item 11."""

from photon_ml_tpu_torch.diagnostics.evaluation import evaluate  # noqa: F401
