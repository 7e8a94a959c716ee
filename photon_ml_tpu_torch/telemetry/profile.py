"""Executable-level roofline profiler: sampled device time per executable,
bound classes, and device-memory high-watermarks.

Counterpart of ``photon_ml_tpu/telemetry/profile.py``. Every call of an
instrumented executable (``telemetry/executables.py``) goes through
:func:`profile_dispatch`, armed at ``telemetry`` import:

- every call is counted per ``(name, signature)`` entry; every Nth call of
  an entry (``PHOTON_PROFILE_SAMPLE_EVERY``, default
  :data:`DEFAULT_SAMPLE_EVERY`; the first call of every entry is always
  sampled, so short runs still profile) is timed;
- **the timing adds no host sync.** On a CUDA device a sampled call is
  bracketed by a pair of ``torch.cuda.Event(enable_timing=True)`` recorded
  on the current stream. The pair is read only once it has completed:
  ``Event.query()`` when the next sample is taken, and
  ``Event.elapsed_time`` in :func:`publish_metrics` (report or flush time,
  off the path), which waits for the last pairs. The sampler makes no
  ``sync_fetch`` and no other device-to-host copy, so ``host_syncs`` is the
  same armed as disarmed. On the CPU (an executable whose arguments hold no
  CUDA tensor) the host clock times the call, as the reference does on its
  CPU backend. The stream time of a call includes the card's idle gaps
  while the host enqueues it: a call whose modelled work is far below its
  stream time is dispatch-bound;
- nested sampled calls are subtracted from their sampled parent once they
  resolve, giving per-executable *exclusive* seconds;
- against :func:`executables.device_peaks`: MFU, arithmetic intensity, and
  a roofline **bound class** (:func:`bound_class`): compute-bound,
  compute at under 5% of the float32 peak, memory-bound (``HBM-bound``)
  or dispatch-bound. The codes and rules are the reference's; codes 1 and
  2 carry the card's names (the reference's MXU and VPU are TPU units);
- a measured rate above the peak is physically impossible and flags
  ``timing_suspect`` instead of reporting a fake number;
- device-memory high-watermarks (``memory.record_device_watermarks``) on
  the sampling cadence, attributed to the open span;
- optionally a ``torch.profiler`` capture window around the Kth call
  (:func:`configure_xprof`; ``cli train``'s ``xprof``), refused on the CPU
  unless forced.

Everything is published as ``profile.exec.<name>.<field>`` gauges, so a
report rebuilt from a metrics JSONL renders the Hot-executables table.
``profile.overhead_seconds`` counts the sampler's own bookkeeping.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from time import monotonic as _monotonic
from typing import Any, Callable, Optional

import torch

from photon_ml_tpu_torch.telemetry import executables, memory, metrics, trace

__all__ = [
    "ProfileEntry",
    "ProfileRegistry",
    "PROFILE_REGISTRY",
    "DEFAULT_SAMPLE_EVERY",
    "BOUND_UNKNOWN",
    "BOUND_COMPUTE",
    "BOUND_LOW_COMPUTE",
    "BOUND_HBM",
    "BOUND_DISPATCH",
    "BOUND_CLASS_NAMES",
    "bound_class",
    "bound_class_name",
    "profile_dispatch",
    "launch_window",
    "install",
    "resolve_pending",
    "publish_metrics",
    "merged_profiles",
    "exclusive_seconds_by_name",
    "set_sample_every",
    "set_clock",
    "configure_xprof",
    "stop_xprof",
    "set_xprof_hooks",
    "reset",
]

logger = logging.getLogger("photon_ml_tpu_torch.telemetry.profile")

#: Time one call in this many of an entry (its first call always).
DEFAULT_SAMPLE_EVERY = 64

#: Roofline bound classes (numeric codes survive a metrics round trip as
#: gauges; 0 stays "unknown"). The reference's codes and rules.
BOUND_UNKNOWN = 0
BOUND_COMPUTE = 1
BOUND_LOW_COMPUTE = 2
BOUND_HBM = 3
BOUND_DISPATCH = 4

BOUND_CLASS_NAMES = {
    BOUND_UNKNOWN: "unknown",
    BOUND_COMPUTE: "compute-bound",
    BOUND_LOW_COMPUTE: "low-compute-bound",
    BOUND_HBM: "HBM-bound",
    BOUND_DISPATCH: "dispatch-bound",
}

#: An executable whose roofline time is under this fraction of its measured
#: time is dominated by launch and host overhead, not by the device.
DISPATCH_BOUND_RATIO = 0.1

#: A compute-side executable under this MFU runs at under 5% of the f32 peak.
LOW_COMPUTE_MFU_THRESHOLD = 0.05

_clock: Callable[[], float] = _monotonic
_sample_every: Optional[int] = None
_sample_every_env_cache: Optional[int] = None


def set_clock(clock: Optional[Callable[[], float]]) -> None:
    """Override the host clock of CPU samples (forged-clock tests); ``None``
    restores ``time.monotonic``."""
    global _clock
    _clock = _monotonic if clock is None else clock


def set_sample_every(n: Optional[int]) -> None:
    """Override the sampling period (at least 1); ``None`` restores the
    ``PHOTON_PROFILE_SAMPLE_EVERY`` / default chain."""
    global _sample_every
    _sample_every = None if n is None else max(1, int(n))


def _resolve_sample_every() -> int:
    if _sample_every is not None:
        return _sample_every
    global _sample_every_env_cache
    if _sample_every_env_cache is None:
        n = DEFAULT_SAMPLE_EVERY
        raw = os.environ.get("PHOTON_PROFILE_SAMPLE_EVERY")
        if raw:
            try:
                n = max(1, int(raw))
            except ValueError:
                logger.warning("ignoring malformed PHOTON_PROFILE_SAMPLE_EVERY=%r", raw)
        _sample_every_env_cache = n
    return _sample_every_env_cache


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProfileEntry:
    """Profiled state of one ``(name, signature)`` entry.

    ``sampled_seconds`` are inclusive device seconds (host seconds on the
    CPU) over the resolved samples; ``est_exclusive_seconds`` extrapolates
    the exclusive seconds to every call. ``flops`` / ``bytes_accessed`` are
    the last sample's modelled cost; ``None`` means unknown, never zero.
    ``fetch_seconds`` stays 0: the sampler fetches nothing."""

    name: str
    signature: tuple
    dispatches: int = 0
    sampled: int = 0
    sampled_seconds: float = 0.0
    sampled_exclusive_seconds: float = 0.0
    fetch_seconds: float = 0.0
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None

    @property
    def est_exclusive_seconds(self) -> float:
        if self.sampled <= 0:
            return 0.0
        return self.sampled_exclusive_seconds / self.sampled * self.dispatches

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["signature"] = list(self.signature)
        d["est_exclusive_seconds"] = self.est_exclusive_seconds
        return d


class ProfileRegistry:
    """Process-wide per-executable profile store, keyed like the executable
    registry by ``(name, signature)``; entries merge per name for reports."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, tuple], ProfileEntry] = {}
        self._suspect_warned: set[str] = set()
        self.total_dispatches = 0

    def count_dispatch(self, name: str, signature: tuple, every: int) -> bool:
        """Count one call; True when it is the entry's first or Nth (a
        deterministic counter, so runs sample alike)."""
        with self._lock:
            key = (name, signature)
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = ProfileEntry(name, signature)
            e.dispatches += 1
            self.total_dispatches += 1
            return (e.dispatches - 1) % every == 0

    def record_sample(self, name: str, signature: tuple, seconds: float,
                      exclusive_seconds: float, fetch_seconds: float,
                      flops: Optional[float], bytes_accessed: Optional[float]) -> None:
        with self._lock:
            key = (name, signature)
            e = self._entries.get(key)
            if e is None:  # reset() came between the call and its sample
                e = self._entries[key] = ProfileEntry(name, signature, dispatches=1)
            e.sampled += 1
            e.sampled_seconds += seconds
            e.sampled_exclusive_seconds += exclusive_seconds
            e.fetch_seconds += fetch_seconds
            if flops is not None:
                e.flops = flops
            if bytes_accessed is not None:
                e.bytes_accessed = bytes_accessed

    def entries(self, name: Optional[str] = None) -> list[ProfileEntry]:
        with self._lock:
            out = list(self._entries.values())
        if name is not None:
            out = [e for e in out if e.name == name]
        return out

    def first_suspect_warning(self, name: str) -> bool:
        """True exactly once per name."""
        with self._lock:
            if name in self._suspect_warned:
                return False
            self._suspect_warned.add(name)
            return True

    def snapshot(self) -> list[dict[str, Any]]:
        """JSON-safe entries, the most estimated exclusive time first."""
        return [e.to_dict() for e in sorted(self.entries(),
                                            key=lambda e: e.est_exclusive_seconds,
                                            reverse=True)]

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._suspect_warned.clear()
            self.total_dispatches = 0


#: Process-wide profile registry.
PROFILE_REGISTRY = ProfileRegistry()


# ---------------------------------------------------------------------------
# derived roofline numbers
# ---------------------------------------------------------------------------


def bound_class(mean_dispatch_seconds: Optional[float], flops: Optional[float],
                bytes_accessed: Optional[float], peak_flops: Optional[float],
                peak_bw: Optional[float], mfu: Optional[float]) -> int:
    """Roofline bound class of one executable (the reference's rules):

    - dispatch-bound: the roofline time (the larger of the compute and
      memory legs) is under :data:`DISPATCH_BOUND_RATIO` of the measured;
    - HBM-bound: intensity below the card's balance point (peak FLOP/s
      over peak bytes/s);
    - compute-bound, or low-compute-bound under
      :data:`LOW_COMPUTE_MFU_THRESHOLD` MFU;
    - unknown whenever the cost or the peaks are missing."""
    if (mean_dispatch_seconds is None or mean_dispatch_seconds <= 0 or flops is None
            or bytes_accessed is None or not bytes_accessed or peak_flops is None
            or peak_bw is None or not peak_flops or not peak_bw):
        return BOUND_UNKNOWN
    roofline_seconds = max(flops / peak_flops, bytes_accessed / peak_bw)
    if roofline_seconds < DISPATCH_BOUND_RATIO * mean_dispatch_seconds:
        return BOUND_DISPATCH
    if flops / bytes_accessed < peak_flops / peak_bw:
        return BOUND_HBM
    if mfu is not None and mfu < LOW_COMPUTE_MFU_THRESHOLD:
        return BOUND_LOW_COMPUTE
    return BOUND_COMPUTE


def bound_class_name(code: Any) -> str:
    try:
        return BOUND_CLASS_NAMES[int(code)]
    except (KeyError, TypeError, ValueError):
        return "unknown"


def merged_profiles(names: Optional[Any] = None) -> dict[str, dict[str, Any]]:
    """Per-name merge of the entries with the derived roofline numbers
    against the resolved peaks (resolving the pending samples first). Keys:
    dispatches, sampled, sampled_seconds, est_exclusive_seconds,
    mean_dispatch_seconds, flops_per_dispatch, bytes_per_dispatch, mfu,
    intensity, bound_code, timing_suspect; derived fields are ``None`` when
    unknown."""
    resolve_pending(wait=True)
    peak_flops, peak_bw = executables.device_peaks()
    by_name: dict[str, list[ProfileEntry]] = {}
    for e in PROFILE_REGISTRY.entries():
        if names is not None and e.name not in names:
            continue
        by_name.setdefault(e.name, []).append(e)
    out: dict[str, dict[str, Any]] = {}
    for name, entries in by_name.items():
        dispatches = sum(e.dispatches for e in entries)
        sampled = sum(e.sampled for e in entries)
        sampled_seconds = sum(e.sampled_seconds for e in entries)
        est_exclusive = sum(e.est_exclusive_seconds for e in entries)
        mean = sampled_seconds / sampled if sampled else None
        # per-call cost weighted by each entry's samples, so a rarely run
        # signature does not skew the merged intensity
        fl_known = [e for e in entries if e.flops is not None and e.sampled]
        by_known = [e for e in entries if e.bytes_accessed is not None and e.sampled]
        flops = None
        if fl_known:
            w = sum(e.sampled for e in fl_known)
            flops = sum(e.flops * e.sampled for e in fl_known) / w
        nbytes = None
        if by_known:
            w = sum(e.sampled for e in by_known)
            nbytes = sum(e.bytes_accessed * e.sampled for e in by_known) / w
        mfu = intensity = None
        suspect = False
        if flops is not None and nbytes:
            intensity = flops / nbytes
        if mean is not None and mean > 0:
            if flops is not None and peak_flops:
                mfu = flops / mean / peak_flops
                suspect = suspect or flops / mean > peak_flops
            if nbytes is not None and peak_bw:
                suspect = suspect or nbytes / mean > peak_bw
        elif sampled and mean == 0 and (peak_flops or peak_bw):
            # zero measured seconds with work attributed: the clock lies
            suspect = flops is not None or nbytes is not None
        out[name] = {
            "dispatches": dispatches,
            "sampled": sampled,
            "sampled_seconds": sampled_seconds,
            "est_exclusive_seconds": est_exclusive,
            "mean_dispatch_seconds": mean,
            "flops_per_dispatch": flops,
            "bytes_per_dispatch": nbytes,
            "mfu": mfu,
            "intensity": intensity,
            "bound_code": bound_class(mean, flops, nbytes, peak_flops, peak_bw, mfu),
            "timing_suspect": suspect,
        }
    return out


def exclusive_seconds_by_name() -> dict[str, float]:
    """``{name: estimated exclusive seconds}`` over the resolved samples (the
    heartbeat's ``hot_exec``): a pure registry read that waits for nothing
    and registers no metric."""
    out: dict[str, float] = {}
    for e in PROFILE_REGISTRY.entries():
        out[e.name] = out.get(e.name, 0.0) + e.est_exclusive_seconds
    return out


def publish_metrics(names: Optional[Any] = None) -> None:
    """Publish ``profile.exec.<name>.<field>`` gauges for every profiled
    name (or ``names``), waiting for the samples still in flight. Runs at
    report build and metrics flush, not per sample."""
    for name, m in merged_profiles(names).items():
        prefix = f"profile.exec.{name}"
        metrics.gauge(f"{prefix}.dispatches").set(m["dispatches"])
        metrics.gauge(f"{prefix}.sampled").set(m["sampled"])
        metrics.gauge(f"{prefix}.sampled_seconds").set(m["sampled_seconds"])
        metrics.gauge(f"{prefix}.est_exclusive_seconds").set(m["est_exclusive_seconds"])
        if m["mean_dispatch_seconds"] is not None:
            metrics.gauge(f"{prefix}.mean_dispatch_seconds").set(m["mean_dispatch_seconds"])
        if m["mfu"] is not None:
            metrics.gauge(f"{prefix}.mfu").set(m["mfu"])
        if m["intensity"] is not None:
            metrics.gauge(f"{prefix}.intensity").set(m["intensity"])
        metrics.gauge(f"{prefix}.bound_code").set(m["bound_code"])
        if m["timing_suspect"]:
            metrics.gauge(f"{prefix}.timing_suspect").set(1)
            metrics.counter("profile.timing_suspect_total").inc()
            if PROFILE_REGISTRY.first_suspect_warning(name):
                logger.warning(
                    "timing suspect: executable '%s' measures above the resolved "
                    "device peak; treat its rates as fake until the measurement "
                    "path is fixed", name)


# ---------------------------------------------------------------------------
# the sampler (the executables.set_dispatch_profiler hook)
# ---------------------------------------------------------------------------


class _Frame:
    """One sampled call in flight on the thread's stack: its host-timed
    children's seconds, its event-timed children, and for an event-timed
    call its name, event pair and stream (``launch_window`` narrows them to
    a kernel's launch)."""

    __slots__ = ("child_seconds", "children", "name", "start", "end", "stream", "bracketed")

    def __init__(self, name=None, start=None, end=None, stream=None):
        self.child_seconds = 0.0
        self.children: list[_Pending] = []
        self.name, self.start, self.end, self.stream = name, start, end, stream
        self.bracketed = False


class launch_window:
    """``with launch_window(name):`` around a kernel wrapper's launch: when
    this call of the executable ``name`` is being timed on the stream, its
    event pair is recorded again right around the launch, so the sample
    reads the kernel's time on the stream and not the wrapper's host work
    before and after it (an idle card would count that as elapsed time).
    A call that is not sampled pays one thread-local read."""

    __slots__ = ("name", "frame")

    def __init__(self, name: str):
        self.name = name
        self.frame = None

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        frame = stack[-1] if stack else None
        if frame is not None and frame.name == self.name and frame.start is not None:
            self.frame = frame
            frame.start.record(frame.stream)
        return self

    def __exit__(self, *exc):
        frame = self.frame
        if frame is not None:
            frame.end.record(frame.stream)
            frame.bracketed = True
        return False


class _Pending:
    """An event-timed sample waiting for its end event to complete."""

    __slots__ = ("name", "signature", "start", "end", "children", "flops", "nbytes",
                 "seconds", "done")

    def __init__(self, name, signature, start, end, children, flops, nbytes):
        self.name, self.signature = name, signature
        self.start, self.end = start, end
        self.children = children
        self.flops, self.nbytes = flops, nbytes
        self.seconds: Optional[float] = None
        self.done = False


_tls = threading.local()
_pending_lock = threading.Lock()
_pending: list[_Pending] = []


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _resolve(p: _Pending) -> None:
    """Record ``p``'s sample (its end has completed): inclusive stream
    seconds, less its resolved event-timed children."""
    children = 0.0
    for c in p.children:
        if not c.done and c.end.query():
            _resolve(c)
        if c.done:
            children += c.seconds
    p.seconds = p.start.elapsed_time(p.end) / 1e3
    p.done = True
    PROFILE_REGISTRY.record_sample(p.name, p.signature, p.seconds,
                                   max(p.seconds - children, 0.0), 0.0, p.flops, p.nbytes)


def resolve_pending(wait: bool = False) -> int:
    """Record every event-timed sample whose end event has completed (with
    ``wait``, every one, waiting on its end event: report time only).
    Returns how many remain in flight."""
    with _pending_lock:
        todo = list(_pending)
    if not todo:
        return 0
    left = []
    for p in todo:
        if p.done:
            continue
        if wait:
            p.end.synchronize()
        if p.end.query():
            _resolve(p)
        else:
            left.append(p)
    with _pending_lock:
        _pending[:] = [p for p in _pending if not p.done]
        return len(left)


def profile_dispatch(rec, target, args, kwargs):
    """Route one instrumented call: count it, and time every Nth of its
    entry (module docstring). The target's exceptions pass through with
    no sample."""
    sampled = PROFILE_REGISTRY.count_dispatch(rec.name, rec.signature, _resolve_sample_every())
    if _xprof_config is not None:
        _xprof_tick()
    if not sampled:
        return target(*args, **kwargs)
    device = getattr(rec, "device", None)
    if device is not None and str(device).startswith("cuda"):
        return _sample_on_stream(rec, torch.device(device), target, args, kwargs)
    clock = _clock
    stack = _stack()
    frame = _Frame()
    stack.append(frame)
    t0 = clock()
    try:
        out = target(*args, **kwargs)
    except BaseException:
        stack.pop()
        raise
    dt = clock() - t0
    stack.pop()
    exclusive = max(dt - frame.child_seconds, 0.0)
    if stack:
        stack[-1].child_seconds += dt
    t_book = clock()
    PROFILE_REGISTRY.record_sample(rec.name, rec.signature, dt, exclusive, 0.0, rec.flops,
                                   rec.bytes_accessed)
    _after_sample(clock() - t_book, clock)
    return out


def _sample_on_stream(rec, device: torch.device, target, args, kwargs):
    """Time one call on ``device``'s current stream with an event pair; the
    pair is read later, once it has completed."""
    t_book = _monotonic()
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    stack = _stack()
    frame = _Frame(rec.name, start, end, stream)
    stack.append(frame)
    own = _monotonic() - t_book
    try:
        out = target(*args, **kwargs)
    except BaseException:
        stack.pop()
        raise
    t_book = _monotonic()
    if not frame.bracketed:
        end.record(stream)
    stack.pop()
    p = _Pending(rec.name, rec.signature, start, end, frame.children, rec.flops,
                 rec.bytes_accessed)
    if stack:
        stack[-1].children.append(p)
    with _pending_lock:
        _pending.append(p)
    resolve_pending(wait=False)
    _after_sample(own + (_monotonic() - t_book), _monotonic)
    return out


def _after_sample(seconds_so_far: float, clock: Callable[[], float]) -> None:
    """The watermarks on the sampling cadence, attributed to the open
    span's phase, and the sampler's own cost."""
    t0 = clock()
    span = trace.current_span()
    memory.record_device_watermarks(phase=None if span is None else span.name)
    metrics.counter("profile.sampled").inc()
    metrics.counter("profile.overhead_seconds").inc(seconds_so_far + (clock() - t0))


def install() -> None:
    """Arm the sampler on every instrumented call (idempotent; done at
    ``telemetry`` import and again by :func:`reset`)."""
    executables.set_dispatch_profiler(profile_dispatch)


# ---------------------------------------------------------------------------
# optional torch.profiler capture window
# ---------------------------------------------------------------------------

_xprof_lock = threading.Lock()
_xprof_config: Optional[dict[str, Any]] = None
_xprof_active = False
_xprof_profiler = None
_xprof_start_hook: Optional[Callable[[str], None]] = None
_xprof_stop_hook: Optional[Callable[[], None]] = None


def set_xprof_hooks(start: Optional[Callable[[str], None]],
                    stop: Optional[Callable[[], None]]) -> None:
    """Inject the capture's start and stop (tests); ``None`` restores the
    ``torch.profiler`` capture."""
    global _xprof_start_hook, _xprof_stop_hook
    _xprof_start_hook = start
    _xprof_stop_hook = stop


def configure_xprof(out_dir: str, arm_at: int = 20, capture: int = 8, force: bool = False,
                    device: Optional[Any] = None) -> bool:
    """Arm a ``torch.profiler`` capture window: it starts when the count of
    profiled calls reaches ``arm_at`` (past the warm-up) and stops
    ``capture`` calls later, writing a Chrome/Perfetto trace into
    ``out_dir``. On a CPU device (``device``, default cuda when there is a
    card) it is refused (returns False) unless ``force`` or
    ``PHOTON_XPROF_FORCE=1``: a CPU trace answers no roofline question. A
    window still open at :func:`reset` is stopped there."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cpu" and not force and os.environ.get("PHOTON_XPROF_FORCE") != "1":
        logger.info("xprof capture skipped on the cpu device (force=True or "
                    "PHOTON_XPROF_FORCE=1 to override)")
        return False
    global _xprof_config
    with _xprof_lock:
        _xprof_config = {"dir": out_dir, "arm_at": max(int(arm_at), 0),
                         "stop_at": max(int(arm_at), 0) + max(int(capture), 1)}
    logger.info("xprof capture armed: dir=%s calls [%d, %d)", out_dir,
                _xprof_config["arm_at"], _xprof_config["stop_at"])
    metrics.gauge("profile.xprof_armed").set(1)
    return True


def _xprof_start(out_dir: str) -> None:
    if _xprof_start_hook is not None:
        _xprof_start_hook(out_dir)
        return
    global _xprof_profiler
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _xprof_profiler = (prof, out_dir)


def _xprof_stop() -> None:
    if _xprof_stop_hook is not None:
        _xprof_stop_hook()
        return
    global _xprof_profiler
    held, _xprof_profiler = _xprof_profiler, None
    if held is None:
        return
    prof, out_dir = held
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()  # the window's kernels finish inside it
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"xprof-{os.getpid()}.pt.trace.json"))


def _xprof_tick() -> None:
    """Advance the capture window from the call stream. A capture that
    fails logs and disarms: profiling never takes the run down."""
    global _xprof_config, _xprof_active
    with _xprof_lock:
        cfg = _xprof_config
        if cfg is None:
            return
        n = PROFILE_REGISTRY.total_dispatches
        start = not _xprof_active and n >= cfg["arm_at"]
        stop = _xprof_active and n >= cfg["stop_at"]
    if start:
        try:
            _xprof_start(cfg["dir"])
        except Exception:  # noqa: BLE001
            logger.warning("xprof capture failed to start; disarmed", exc_info=True)
            with _xprof_lock:
                _xprof_config = None
            metrics.counter("profile.xprof_failures").inc()
            return
        with _xprof_lock:
            _xprof_active = True
        trace.add_event("xprof_start", dir=cfg["dir"])
        logger.info("xprof capture started -> %s", cfg["dir"])
    elif stop:
        stop_xprof()


def stop_xprof() -> None:
    """Stop an open capture window and disarm (idempotent)."""
    global _xprof_config, _xprof_active
    with _xprof_lock:
        was_active = _xprof_active
        _xprof_active = False
        cfg = _xprof_config
        _xprof_config = None
    if not was_active:
        return
    try:
        _xprof_stop()
    except Exception:  # noqa: BLE001
        logger.warning("xprof capture failed to stop", exc_info=True)
        metrics.counter("profile.xprof_failures").inc()
        return
    trace.add_event("xprof_stop", dir=None if cfg is None else cfg.get("dir"))
    logger.info("xprof capture stopped")


def reset() -> None:
    """Restore import-time defaults: stop any capture, drop the pending
    samples, clear the registry and the clock and sampling overrides, and
    arm the sampler again (a reset never leaves profiling off)."""
    global _sample_every, _sample_every_env_cache, _clock
    stop_xprof()
    set_xprof_hooks(None, None)
    with _pending_lock:
        _pending.clear()
    PROFILE_REGISTRY.reset()
    _sample_every = None
    _sample_every_env_cache = None
    _clock = _monotonic
    install()
