"""Executable accounting: every hot function of the port is an accounted
executable.

Counterpart of ``photon_ml_tpu/telemetry/xla.py``, named for what it holds
in a PyTorch package: there is no ``jax.jit`` here, so no compiled program
and no XLA cost analysis. Its metric names stay the reference's
(``xla.exec.<name>.*``, ``xla.flops_total``, ``xla.bytes_total``,
``comms.*``, ``device.peak_*``), so a run's artifacts render alike in both
packages' ``cli report``.

- :func:`instrumented` wraps a plain function as an executable. Each call
  is recorded under ``(name, shape signature)`` in the process-wide
  :data:`EXECUTABLE_REGISTRY` (tensors give dtype, shape and device; Python
  scalars give their type only, so values do not fragment a signature) and
  counted (``xla.calls``, ``xla.exec.<name>.calls``). When the telemetry
  package is imported, every call goes through the sampling profiler
  (``telemetry/profile.py``).
- **Modelled cost.** The kernel wrappers (``kernels/__init__.py``) and the
  dense contractions (``ops/dense.py``) report the work of each launch
  through :func:`account`, from ``kernels/cost.py``: it is counted once in
  ``xla.flops_total`` / ``xla.bytes_total`` and accumulated onto the open
  span as ``xla_flops`` / ``xla_bytes`` (the run report's per-phase
  roofline). An executable's cost is the sum of what it launched: its
  record keeps the last call's, and ``xla.exec.<name>.flops_total`` /
  ``bytes_total`` its running total (inclusive of nested executables). It
  is a lower bound: the solvers' vector arithmetic is not counted. An
  executable that launched nothing modelled has the cost ``None``
  ("unknown"), never 0.
- **Roofline peaks.** :func:`device_peaks` resolves the card's peak
  float32 FLOP/s and memory rate (the kernels compute in float32 on CUDA
  cores) from ``torch.cuda.get_device_name``, the ``PHOTON_PEAK_FLOPS`` /
  ``PHOTON_PEAK_HBM_GBPS`` overrides, or :func:`set_peaks`, and publishes
  ``device.peak_*`` gauges. It never initializes CUDA: on the CPU, or
  before the process has used the card, the peaks are unknown.
- **Collective estimates.** :func:`record_collective` turns a collective's
  payload and axis size into estimated wire bytes (a ring all-reduce moves
  ``2(n-1)/n`` of the payload per device, an all-gather ``(n-1)/n``):
  ``comms.*`` counters and the span's ``comms_bytes``.

PyTorch's eager mode compiles nothing per shape, so there is no recompile
attribution here; the kernels' one build is counted by
``telemetry/device.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import threading
from typing import Any, Callable, Optional

import torch

from photon_ml_tpu_torch.telemetry import metrics, trace

__all__ = [
    "ExecutableRecord",
    "ExecutableRegistry",
    "EXECUTABLE_REGISTRY",
    "InstrumentedFunction",
    "instrumented",
    "account",
    "shape_signature",
    "set_dispatch_profiler",
    "set_peaks",
    "device_peaks",
    "collective_bytes",
    "record_collective",
    "reset",
]

logger = logging.getLogger("photon_ml_tpu_torch.telemetry.executables")

# Peak float32 FLOP/s (CUDA cores, no tensor cores: the kernels compute in
# float32) and memory bytes/s by device-name substring, from NVIDIA's data
# sheet of the SXM part at its full 700 W limit; unknown names give None.
_PEAK_TABLE: tuple[tuple[str, float, float], ...] = (
    ("H100 80GB HBM3", 67e12, 3.35e12),
    ("H100 SXM", 67e12, 3.35e12),
)

_peaks_override: Optional[tuple[Optional[float], Optional[float]]] = None

# the per-dispatch profiler hook (telemetry.profile installs its sampler
# here at import); not cleared by reset()
_dispatch_profiler: Optional[Callable] = None


def set_dispatch_profiler(hook: Optional[Callable]) -> None:
    """Install the per-dispatch profiler hook: every instrumented call then
    runs as ``hook(record, target, args, kwargs)``, which must call
    ``target(*args, **kwargs)`` once, return its result and let its
    exceptions through. ``None`` disarms."""
    global _dispatch_profiler
    _dispatch_profiler = hook


# ---------------------------------------------------------------------------
# roofline peaks
# ---------------------------------------------------------------------------


def set_peaks(peak_flops: Optional[float], peak_hbm_bytes_per_sec: Optional[float]) -> None:
    """Pin the peaks (tests; cards the table does not know). ``set_peaks(None,
    None)`` pins "unknown"; :func:`reset` restores probing."""
    global _peaks_override
    _peaks_override = (peak_flops, peak_hbm_bytes_per_sec)
    _publish_peaks(peak_flops, peak_hbm_bytes_per_sec)


def _publish_peaks(peak_flops: Optional[float], peak_bw: Optional[float]) -> None:
    if peak_flops is not None:
        metrics.gauge("device.peak_flops").set(peak_flops)
    if peak_bw is not None:
        metrics.gauge("device.peak_hbm_bytes_per_sec").set(peak_bw)


def _device_name() -> str:
    """The name of the current CUDA device, or "" when CUDA is not
    initialized in this process (the probe never initializes it)."""
    try:
        if torch.cuda.is_initialized():
            return str(torch.cuda.get_device_name())
    except Exception:  # noqa: BLE001 — accounting never fails a caller
        pass
    return ""


def device_peaks() -> tuple[Optional[float], Optional[float]]:
    """``(peak_flops, peak_hbm_bytes_per_sec)`` of the current device, or
    ``None``s when unknown. Resolution order: :func:`set_peaks`, the
    ``PHOTON_PEAK_FLOPS`` / ``PHOTON_PEAK_HBM_GBPS`` environment, the table
    by ``torch.cuda.get_device_name``. Publishes ``device.peak_*`` gauges
    when known, so reports loaded from a metrics JSONL compute MFU."""
    if _peaks_override is not None:
        return _peaks_override

    def _env_float(name: str, scale: float = 1.0) -> Optional[float]:
        raw = os.environ.get(name)
        if not raw:
            return None
        try:
            return float(raw) * scale
        except ValueError:  # a malformed override is unknown, never a crash
            logger.warning("ignoring malformed %s=%r", name, raw)
            return None

    flops = _env_float("PHOTON_PEAK_FLOPS")
    bw = _env_float("PHOTON_PEAK_HBM_GBPS", scale=1e9)
    if flops is None or bw is None:
        kind = _device_name().lower()
        for sub, table_flops, table_bw in _PEAK_TABLE:
            if kind and sub.lower() in kind:
                flops = table_flops if flops is None else flops
                bw = table_bw if bw is None else bw
                break
    _publish_peaks(flops, bw)
    return flops, bw


# ---------------------------------------------------------------------------
# shape signatures
# ---------------------------------------------------------------------------

_DTYPE_SHORT = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int32: "i32", torch.int64: "i64",
    torch.int16: "i16", torch.int8: "i8", torch.uint8: "u8", torch.bool: "b1",
}

_SCALARS = (bool, int, float, complex)


_MAX_OPENED = 16


def _flatten(x: Any, out: list, depth: int = 0) -> None:
    """The leaves of an argument list: tuples, lists and dicts of at most
    16 items opened two levels deep (an argument ``csr = (row_ptr, cols,
    vals)``, a ``ScatterTiles``), anything else a leaf."""
    if depth < 2 and isinstance(x, (tuple, list)) and len(x) <= _MAX_OPENED:
        for y in x:
            _flatten(y, out, depth + 1)
    elif depth < 2 and isinstance(x, dict) and len(x) <= _MAX_OPENED:
        for k in sorted(x, key=str):
            _flatten(x[k], out, depth + 1)
    else:
        out.append(x)


def _object_device(x: Any) -> Optional[torch.device]:
    if isinstance(x, torch.device):
        return x
    dev = getattr(x, "device", None)
    return dev if isinstance(dev, torch.device) else None


def _leaf_key(x: Any):
    """Cheap hashable key of one leaf (no string building per call)."""
    if isinstance(x, torch.Tensor):
        return (x.dtype, tuple(x.shape), x.device)
    if x is None or isinstance(x, str):
        return ("=", x)
    if isinstance(x, _SCALARS):
        return type(x)
    if isinstance(x, (tuple, list, dict)):
        return (type(x), len(x))
    return (type(x), _object_device(x))


def _device_suffix(dev: Optional[torch.device]) -> str:
    return "" if dev is None or dev.type == "cpu" else f"@{dev}"


def _leaf_sig(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        dt = _DTYPE_SHORT.get(x.dtype, str(x.dtype).replace("torch.", ""))
        return f"{dt}[{','.join(str(int(d)) for d in x.shape)}]{_device_suffix(x.device)}"
    if isinstance(x, bool):
        return "pybool"
    if isinstance(x, int):
        return "pyint"
    if isinstance(x, float):
        return "pyfloat"
    if isinstance(x, complex):
        return "pycomplex"
    if x is None or isinstance(x, str):
        return f"={x!r}"
    if isinstance(x, (tuple, list, dict)):
        return f"<{type(x).__name__}:{len(x)}>"
    return f"<{type(x).__name__}>{_device_suffix(_object_device(x))}"


def _leaves(args: tuple, kwargs: dict) -> list:
    out: list = []
    for a in args:
        _flatten(a, out, 1)
    for k in sorted(kwargs):
        _flatten(kwargs[k], out, 1)
    return out


def shape_signature(args: tuple, kwargs: Optional[dict] = None) -> tuple[str, ...]:
    """The per-leaf signature of a call's arguments, the registry's key: a
    tensor gives ``dtype[shape]`` (``@device`` when not on the CPU), a
    Python scalar its type only, ``None`` or a string its value, any other
    object its type name (and device)."""
    return tuple(_leaf_sig(x) for x in _leaves(args, kwargs or {}))


def _first_device(leaves: list) -> Optional[torch.device]:
    """The first non-CPU device among the leaves: where the call's work
    runs, and so what the profiler times it on."""
    for x in leaves:
        dev = x.device if isinstance(x, torch.Tensor) else _object_device(x)
        if dev is not None and dev.type != "cpu":
            return dev
    return None


# ---------------------------------------------------------------------------
# executable registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExecutableRecord:
    """One ``(name, signature)`` executable's accounted state.

    ``flops`` / ``bytes_accessed`` are the modelled cost of its last call
    (the kernels and contractions it launched); ``None`` means it launched
    nothing modelled ("unknown"), never zero. ``device`` is the first
    non-CPU device of its arguments (None: the host clock times it). The
    reference's compile and memory-analysis fields have no counterpart:
    nothing is compiled per shape here."""

    name: str
    signature: tuple[str, ...]
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    calls: int = 0
    device: Optional[str] = None

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["signature"] = list(self.signature)
        return d


class ExecutableRegistry:
    """Process-wide registry of accounted executables keyed by ``(name,
    shape signature)``, with each name's signatures in order of arrival."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: dict[tuple[str, tuple], ExecutableRecord] = {}
        self._history: dict[str, list[tuple[str, ...]]] = {}

    def register(self, name: str, signature: tuple[str, ...],
                 device: Optional[str] = None) -> ExecutableRecord:
        """The record of ``(name, signature)``, made on first sight."""
        with self._lock:
            rec = self._records.get((name, signature))
            if rec is None:
                rec = self._records[(name, signature)] = ExecutableRecord(
                    name=name, signature=signature, device=device)
                self._history.setdefault(name, []).append(signature)
        return rec

    def record_call(self, rec: ExecutableRecord, flops: Optional[float],
                    nbytes: Optional[float]) -> None:
        """Account one call of ``rec`` with its modelled cost: the call
        counters, the per-executable totals and per-call gauges. The global
        totals and the span attributes come from :func:`account`, once per
        launch, so nested executables are not counted twice."""
        with self._lock:
            rec.calls += 1
            rec.flops, rec.bytes_accessed = flops, nbytes
            # re-attach a record orphaned by reset() (live wrappers keep theirs)
            self._records.setdefault((rec.name, rec.signature), rec)
            self._history.setdefault(rec.name, [rec.signature])
        metrics.counter("xla.calls").inc()
        metrics.counter(f"xla.exec.{rec.name}.calls").inc()
        if flops is not None:
            metrics.counter(f"xla.exec.{rec.name}.flops_total").inc(flops)
            metrics.gauge(f"xla.exec.{rec.name}.flops_per_call").set(flops)
        if nbytes is not None:
            metrics.counter(f"xla.exec.{rec.name}.bytes_total").inc(nbytes)
            metrics.gauge(f"xla.exec.{rec.name}.bytes_per_call").set(nbytes)

    def executables(self, name: Optional[str] = None) -> list[ExecutableRecord]:
        with self._lock:
            recs = list(self._records.values())
        if name is not None:
            recs = [r for r in recs if r.name == name]
        return recs

    def signature_history(self, name: str) -> list[tuple[str, ...]]:
        with self._lock:
            return list(self._history.get(name, ()))

    def snapshot(self) -> list[dict[str, Any]]:
        """JSON-safe record list, the largest total cost first (last call's
        FLOPs times calls where known)."""

        def rank(r: ExecutableRecord) -> float:
            return (r.flops or 0.0) * max(r.calls, 1)

        return [r.to_dict() for r in sorted(self.executables(), key=rank, reverse=True)]

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._history.clear()


#: Process-wide executable registry.
EXECUTABLE_REGISTRY = ExecutableRegistry()


# ---------------------------------------------------------------------------
# modelled cost
# ---------------------------------------------------------------------------

_tls = threading.local()


def _cost_stack() -> list:
    st = getattr(_tls, "cost", None)
    if st is None:
        st = _tls.cost = []
    return st


def _accumulate_span_attr(key: str, value: Optional[float]) -> None:
    if value is None:
        return
    cur = trace.current_span()
    if cur is not None:
        cur.attrs[key] = float(cur.attrs.get(key, 0.0)) + float(value)


def account(flops: float, nbytes: float) -> None:
    """Report one launch's modelled work (``kernels/cost.py``): onto the
    innermost open executable of this thread, the global totals
    ``xla.flops_total`` / ``xla.bytes_total``, and the open span's
    ``xla_flops`` / ``xla_bytes``."""
    stack = _cost_stack()
    if stack:
        frame = stack[-1]
        frame[0] += flops
        frame[1] += nbytes
        frame[2] = True
    metrics.counter("xla.flops_total").inc(flops)
    metrics.counter("xla.bytes_total").inc(nbytes)
    _accumulate_span_attr("xla_flops", flops)
    _accumulate_span_attr("xla_bytes", nbytes)


def _run_accounted(fn: Callable, rec: ExecutableRecord, *args, **kwargs):
    """Run ``fn`` under a cost frame, then record the call with what it
    launched (and add that to the enclosing executable's frame)."""
    stack = _cost_stack()
    frame = [0.0, 0.0, False]
    stack.append(frame)
    try:
        return fn(*args, **kwargs)
    finally:
        while stack and stack[-1] is not frame:
            stack.pop()
        if stack:
            stack.pop()
        if frame[2] and stack:
            parent = stack[-1]
            parent[0] += frame[0]
            parent[1] += frame[1]
            parent[2] = True
        if frame[2]:
            EXECUTABLE_REGISTRY.record_call(rec, frame[0], frame[1])
        else:
            EXECUTABLE_REGISTRY.record_call(rec, None, None)


class InstrumentedFunction:
    """A plain function as an accounted executable (module docstring).
    Thread-safe; each argument signature's record is cached on the
    instance."""

    def __init__(self, fn: Callable, name: str):
        self._fn = fn
        self.name = name
        self._records: dict[tuple, ExecutableRecord] = {}
        self._lock = threading.Lock()
        functools.update_wrapper(self, fn)

    def _record(self, args: tuple, kwargs: dict) -> ExecutableRecord:
        leaves = _leaves(args, kwargs)
        key = (len(args), tuple(kwargs), tuple(_leaf_key(x) for x in leaves))
        rec = self._records.get(key)
        if rec is None:
            with self._lock:
                rec = self._records.get(key)
                if rec is None:
                    dev = _first_device(leaves)
                    rec = EXECUTABLE_REGISTRY.register(
                        self.name, shape_signature(args, kwargs),
                        None if dev is None else str(dev))
                    self._records[key] = rec
        return rec

    def __call__(self, *args, **kwargs):
        rec = self._record(args, kwargs)
        target = functools.partial(_run_accounted, self._fn, rec)
        prof = _dispatch_profiler
        if prof is not None:
            return prof(rec, target, args, kwargs)
        return target(*args, **kwargs)

    def __get__(self, obj, objtype=None):
        # as a method: bind like a function
        if obj is None:
            return self
        return functools.partial(self.__call__, obj)


def instrumented(fn: Optional[Callable] = None, *, name: Optional[str] = None) -> Any:
    """Account ``fn`` as an executable: ``instrumented(f, name=...)`` or the
    decorator ``@instrumented(name=...)``. Every signature set is expected
    here (nothing is compiled per shape), so none is a recompile: the
    reference's ``multi_shape`` has no counterpart."""
    if fn is None:
        return lambda f: instrumented(f, name=name)
    return InstrumentedFunction(fn, name or getattr(fn, "__name__", "fn"))


# ---------------------------------------------------------------------------
# collective estimates
# ---------------------------------------------------------------------------


def collective_bytes(op: str, n_devices: int, payload_bytes: int) -> int:
    """Estimated per-device wire bytes of one collective over an
    ``n_devices`` axis: a ring ``psum`` (all-reduce) moves ``2(n-1)/n`` of
    the payload, ``all_gather`` / ``reduce_scatter`` ``(n-1)/n``; 0 on one
    device."""
    n = int(n_devices)
    if n <= 1 or payload_bytes <= 0:
        return 0
    if op == "psum":
        frac = 2.0 * (n - 1) / n
    elif op in ("all_gather", "reduce_scatter"):
        frac = (n - 1) / n
    else:
        raise ValueError(f"unknown collective op '{op}'")
    return int(frac * payload_bytes)


def record_collective(label: str, op: str, n_devices: int, payload_bytes: int,
                      count: int = 1) -> int:
    """Account ``count`` collectives of ``payload_bytes`` each under
    ``label``: ``comms.bytes_total`` / ``comms.<label>.bytes`` counters, a
    per-call gauge, and the span's ``comms_bytes``. Returns the estimated
    bytes: a static estimate from the payload and the axis size."""
    per_call = collective_bytes(op, n_devices, payload_bytes)
    total = per_call * max(int(count), 0)
    if total <= 0:
        return 0
    metrics.counter("comms.bytes_total").inc(total)
    metrics.counter(f"comms.{label}.bytes").inc(total)
    metrics.gauge(f"comms.{label}.bytes_per_call").set(per_call)
    _accumulate_span_attr("comms_bytes", total)
    return total


def reset() -> None:
    """Restore import-time defaults: clear the registry and the pinned
    peaks. Live wrappers keep their records and re-attach them on their
    next call."""
    global _peaks_override
    EXECUTABLE_REGISTRY.reset()
    _peaks_override = None
