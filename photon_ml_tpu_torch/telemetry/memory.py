"""Device-memory accounting: memory stats as metrics, per-phase peak gauges,
table-size estimates, and a headroom check before an allocation.

Counterpart of ``photon_ml_tpu/telemetry/memory.py``, with its gauge names.
The probes read the CUDA caching allocator's host-side counters
(``torch.cuda.memory_allocated`` / ``max_memory_allocated`` /
``memory_reserved``) and the device's total memory: no probe synchronizes
with the device or copies from it. A probe reads a device only once CUDA is
initialized in this process (it never initializes CUDA itself), and a CPU
device has no stats: every probe then returns None, and callers treat None
as "unknown", never as zero. Tests inject stats through
:func:`set_stats_provider`.

- :func:`hbm_stats` / :func:`record_device_memory`: per-device bytes in use
  and limit, published as ``memory.device.<id>.*`` gauges;
- :func:`record_phase_memory`: ``memory.phase.<name>.bytes_in_use`` and a
  max-tracked ``memory.phase.<name>.peak_bytes`` (the run report's memory
  profile of ``fit > cd_iteration > coordinate:<name>``);
- :func:`estimate_table_bytes` / :func:`estimate_batch_bytes`: predicted
  residency of a coefficient table / a batch before it is uploaded;
- :func:`check_headroom`: warn (log + ``memory.headroom_warnings``) before
  a predicted allocation exceeds the free device memory.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.telemetry import metrics

__all__ = [
    "hbm_stats",
    "set_stats_provider",
    "record_device_memory",
    "record_device_watermarks",
    "device_spread_bytes",
    "record_phase_memory",
    "estimate_table_bytes",
    "estimate_batch_bytes",
    "check_headroom",
    "reset",
]

logger = logging.getLogger("photon_ml_tpu_torch.telemetry.memory")

#: Fraction of the device's memory the headroom check treats as usable: the
#: allocator's fragmentation and the kernels' workspaces need the rest.
DEFAULT_SAFETY_FRACTION = 0.92

# a zero-argument callable returning a hbm_stats()-shaped mapping (or None);
# overrides the device probe when set
_stats_provider: Optional[Callable[[], Optional[Mapping[str, Any]]]] = None


def set_stats_provider(provider: Optional[Callable[[], Optional[Mapping[str, Any]]]]) -> None:
    """Override the device probe (deterministic tests); ``None`` restores
    the allocator probe."""
    global _stats_provider
    _stats_provider = provider


def _cuda():
    """``torch.cuda`` when CUDA is already initialized in this process."""
    import torch

    try:
        return torch.cuda if torch.cuda.is_initialized() else None
    except Exception:  # noqa: BLE001 — accounting never fails a caller
        return None


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index of ``device`` (None: the current device), or
    None for a device that is not CUDA or while CUDA is not initialized."""
    import torch

    cuda = _cuda()
    if cuda is None:
        return None
    if device is None:
        return int(cuda.current_device())
    device = torch.device(device) if not isinstance(device, torch.device) else device
    if device.type != "cuda":
        return None
    return int(device.index if device.index is not None else cuda.current_device())


def hbm_stats(device=None) -> Optional[dict[str, int]]:
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "bytes_reserved"}`` of ``device`` (default: the current CUDA device)
    from the caching allocator, or None on the CPU or before CUDA is
    initialized — "unknown", not zero."""
    if _stats_provider is not None and device is None:
        raw = _stats_provider()
        return dict(raw) if raw else None
    idx = _cuda_index(device)
    if idx is None:
        return None
    cuda = _cuda()
    try:
        return {
            "bytes_in_use": int(cuda.memory_allocated(idx)),
            "peak_bytes_in_use": int(cuda.max_memory_allocated(idx)),
            "bytes_limit": int(cuda.get_device_properties(idx).total_memory),
            "bytes_reserved": int(cuda.memory_reserved(idx)),
        }
    except Exception:  # noqa: BLE001
        return None


def _all_devices() -> list:
    import torch

    cuda = _cuda()
    if cuda is None:
        return []
    return [torch.device("cuda", i) for i in range(cuda.device_count())]


def record_device_memory(devices: Optional[Sequence] = None) -> dict[str, int]:
    """Publish ``memory.device.<id>.bytes_in_use`` / ``.bytes_limit`` for
    every device with stats (default: every CUDA device); returns the bytes
    in use per device id (empty without stats)."""
    if devices is None:
        devices = _all_devices()
    out: dict[str, int] = {}
    for d in devices:
        stats = hbm_stats(d)
        if not stats:
            continue
        did = getattr(d, "index", None)
        did = len(out) if did is None else did
        in_use = int(stats.get("bytes_in_use", 0))
        metrics.gauge(f"memory.device.{did}.bytes_in_use").set(in_use)
        if "bytes_limit" in stats:
            metrics.gauge(f"memory.device.{did}.bytes_limit").set(int(stats["bytes_limit"]))
        out[str(did)] = in_use
    return out


def record_device_watermarks(devices: Optional[Sequence] = None,
                             phase: Optional[str] = None) -> dict[str, int]:
    """Sample every device's bytes in use and max-track the high-watermark
    gauges ``memory.device.<id>.peak_bytes`` (and, with ``phase``,
    ``memory.phase.<phase>.device.<id>.peak_bytes``)."""
    per_device = record_device_memory(devices)
    for did, in_use in per_device.items():
        peak = metrics.gauge(f"memory.device.{did}.peak_bytes")
        if peak.value is None or in_use > peak.value:
            peak.set(in_use)
        if phase:
            phase_peak = metrics.gauge(f"memory.phase.{phase}.device.{did}.peak_bytes")
            if phase_peak.value is None or in_use > phase_peak.value:
                phase_peak.set(in_use)
    return per_device


def device_spread_bytes() -> Optional[int]:
    """Bytes-in-use spread (max - min) across the devices with stats, or
    None with fewer than two. Refreshes the per-device gauges from the
    probe, falls back to the gauges already published, and publishes
    ``memory.device_spread_bytes``."""
    per_device = record_device_memory()
    if len(per_device) < 2:
        prefix, suffix = "memory.device.", ".bytes_in_use"
        per_device = {
            name[len(prefix):-len(suffix)]: value
            for name, value in metrics.snapshot()["gauges"].items()
            if name.startswith(prefix) and name.endswith(suffix) and value is not None
        }
    if len(per_device) < 2:
        return None
    spread = max(per_device.values()) - min(per_device.values())
    metrics.gauge("memory.device_spread_bytes").set(spread)
    return int(spread)


def record_phase_memory(phase: str, device=None) -> Optional[int]:
    """Sample the bytes in use under ``phase`` and max-track its peak:
    gauges ``memory.phase.<phase>.bytes_in_use`` (last sample) and
    ``memory.phase.<phase>.peak_bytes``, plus ``memory.bytes_in_use`` and
    ``memory.bytes_limit``. Returns the sample, or None without stats."""
    stats = hbm_stats(device)
    if not stats or "bytes_in_use" not in stats:
        return None
    in_use = int(stats["bytes_in_use"])
    metrics.gauge(f"memory.phase.{phase}.bytes_in_use").set(in_use)
    peak = metrics.gauge(f"memory.phase.{phase}.peak_bytes")
    if peak.value is None or in_use > peak.value:
        peak.set(in_use)
    metrics.gauge("memory.bytes_in_use").set(in_use)
    if "bytes_limit" in stats:
        metrics.gauge("memory.bytes_limit").set(int(stats["bytes_limit"]))
    return in_use


def estimate_table_bytes(num_entities: int, dim: int, itemsize: int = 4) -> int:
    """Predicted residency of a [num_entities, dim] coefficient table."""
    return int(num_entities) * int(dim) * int(itemsize)


def _nbytes(x: Any) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return int(x.numel()) * int(x.element_size())
    if isinstance(x, np.ndarray):
        return int(x.nbytes)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return sum(_nbytes(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, Mapping):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def estimate_batch_bytes(batch: Any) -> int:
    """Predicted device residency of a batch: the bytes of its tensors and
    arrays, through dataclass fields (``DenseBatch``, ``CSRBatch``,
    ``BlockDiagonalBatch``), mappings and sequences. Host arrays count what
    the upload will cost; device tensors what is already resident."""
    return _nbytes(batch)


def check_headroom(predicted_bytes: int, label: str = "", device=None,
                   safety_fraction: float = DEFAULT_SAFETY_FRACTION) -> Optional[bool]:
    """Will ``predicted_bytes`` more fit in the free device memory? True
    (fits), False (a warning is logged and ``memory.headroom_warnings``
    counted before the allocation is tried), or None (no stats: nothing to
    check). Publishes ``memory.free_bytes`` whenever stats exist."""
    stats = hbm_stats(device)
    if not stats or "bytes_limit" not in stats:
        return None
    in_use = int(stats.get("bytes_in_use", 0))
    limit = int(stats["bytes_limit"])
    free = int(limit * safety_fraction) - in_use
    metrics.gauge("memory.free_bytes").set(max(free, 0))
    if predicted_bytes <= free:
        return True
    metrics.counter("memory.headroom_warnings").inc()
    logger.warning(
        "device memory headroom: %s predicts %.2f GB but only %.2f GB free "
        "(%.2f/%.2f GB in use; safety %.0f%%) — expect an out-of-memory error",
        label or "allocation", predicted_bytes / 2**30, max(free, 0) / 2**30,
        in_use / 2**30, limit / 2**30, safety_fraction * 100)
    return False


def reset() -> None:
    """Drop any injected stats provider (the gauges live in the metrics
    registry, which ``metrics.reset()`` clears)."""
    set_stats_provider(None)
