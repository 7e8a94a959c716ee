"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. There is
no silent fallback: without a card the caller must ask for ``"cpu"``
explicitly (the tests do), and then the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "photon_ml_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_on(device: torch.device, *tensors: torch.Tensor | None) -> None:
    """Raise unless every given tensor lives on ``device`` (type and index)."""
    for t in tensors:
        if t is None:
            continue
        if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index
        ):
            raise ValueError(
                f"tensor on {t.device} but the solve runs on {device}; build "
                "the batch and model with the same device"
            )
