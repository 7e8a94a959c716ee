"""photon_ml_tpu_torch: the PyTorch/CUDA port of ``photon_ml_tpu``.

The JAX package beside it is the reference; each module here names its
counterpart there. This package imports ``torch`` and numpy only (never JAX,
never ``photon_ml_tpu``). The sparse gather (margins) and scatter of the GLM
training loop run as hand-written CUDA kernels (``csrc/``), built with
``nvcc`` at first use into ``build/kernels/``; on CPU tensors their plain
PyTorch versions run instead (``kernels/reference.py``).

Entry points default to ``device=None`` = CUDA and raise when no card is
present unless the caller passes ``device="cpu"``.
"""

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.training import SweepEntry, select_best_model, train_glm

__all__ = ["SweepEntry", "resolve_device", "select_best_model", "train_glm"]
