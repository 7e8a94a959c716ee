"""The port's sampled executable profiler (``photon_ml_tpu_torch.telemetry.
profile``) against the JAX package's, case for case with
tests/test_profile.py, on the CPU:

- sampling: the first call of every entry and then every Nth, a
  deterministic per-entry counter, the ``PHOTON_PROFILE_SAMPLE_EVERY``
  override; distinct signatures merging per name, the merged cost weighted
  by samples; nested samples subtracted (a forged clock); a raising target
  leaving no sample;
- the overhead budget: the sampler's own seconds (the
  ``profile.overhead_seconds`` counter's delta) under 2% of a steady window
  of host work, the reference's bound;
- bound classes (the reference's codes and rules; codes 1 and 2 carry the
  card's names, compute-bound and low-compute-bound, where the reference
  names the TPU's MXU and VPU: the one named difference), the
  timing-suspect check, unknown peaks, the gauges' round trip through a
  metrics JSONL, the heartbeat's read registering nothing;
- device-memory high-watermarks per device and phase;
- the ``torch.profiler`` capture window: armed and stopped through hooks,
  refused on the CPU unless forced, closed by a reset, a failing start
  disarming without failing the call, a forced capture on the CPU writing a
  Chrome trace; ``reset`` arming the sampler again;
- the timing on the card's stream, with stand-ins for ``torch.cuda``'s
  events: a sample is recorded only once its end event has completed
  (``query``), resolved at the next sample or at publish time, nested event
  samples subtracted; no ``sync_fetch`` and no host sync is added, and a
  fit makes the same host syncs with the sampler armed as disarmed.

Tolerances: the reference test's (``pytest.approx`` where it uses it).
"""

import json
import logging
import time
import types

import numpy as np
import pytest
import torch

from photon_ml_tpu.telemetry import profile as j_profile
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.telemetry import executables, memory, metrics, profile, trace


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _rec(name, signature=("f32[4]",), flops=None, bytes_accessed=None, device=None):
    """An ExecutableRecord stand-in for driving profile_dispatch directly."""
    return types.SimpleNamespace(name=name, signature=signature, flops=flops,
                                 bytes_accessed=bytes_accessed, device=device)


def _fetch_counters():
    c = telemetry.snapshot()["counters"]
    return {k: c.get(k) for k in ("host_syncs", "device_fetches")}


# -- sampling determinism ------------------------------------------------------


def test_sampling_is_deterministic_every_nth_and_first():
    profile.set_sample_every(4)
    f = telemetry.instrumented(lambda x: x + 1.0, name="det")
    x = torch.zeros(4)
    for _ in range(10):
        f(x)
    (entry,) = profile.PROFILE_REGISTRY.entries("det")
    assert entry.dispatches == 10
    assert entry.sampled == 3  # calls 1, 5, 9
    assert metrics.counter("profile.sampled").value == 3
    # the samples fetched nothing: no crossing counted
    assert _fetch_counters() == {"host_syncs": None, "device_fetches": None}
    assert entry.fetch_seconds == 0.0


def test_single_dispatch_still_profiles():
    f = telemetry.instrumented(lambda x: x * 2.0, name="once")
    f(torch.ones(4))
    (entry,) = profile.PROFILE_REGISTRY.entries("once")
    assert entry.dispatches == 1 and entry.sampled == 1
    assert entry.sampled_seconds > 0


def test_sample_every_env_override(monkeypatch):
    monkeypatch.setenv("PHOTON_PROFILE_SAMPLE_EVERY", "2")
    profile.reset()
    f = telemetry.instrumented(lambda x: x + 1.0, name="env")
    for _ in range(4):
        f(torch.zeros(2))
    (entry,) = profile.PROFILE_REGISTRY.entries("env")
    assert entry.sampled == 2  # calls 1 and 3


def test_default_cadence_is_the_references():
    assert profile.DEFAULT_SAMPLE_EVERY == j_profile.DEFAULT_SAMPLE_EVERY == 64
    profile.set_sample_every(0)  # never below 1
    assert profile._resolve_sample_every() == 1


# -- per-name merging ------------------------------------------------------------


def test_distinct_signatures_merge_per_name():
    profile.set_sample_every(1)
    f = telemetry.instrumented(lambda x: x + 1.0, name="shapes")
    for _ in range(3):
        f(torch.zeros(4))
    for _ in range(2):
        f(torch.zeros(8))
    entries = profile.PROFILE_REGISTRY.entries("shapes")
    assert len(entries) == 2
    assert {e.dispatches for e in entries} == {3, 2}
    merged = profile.merged_profiles()["shapes"]
    assert merged["dispatches"] == 5 and merged["sampled"] == 5


def test_merged_cost_is_sample_weighted():
    reg, jreg = profile.PROFILE_REGISTRY, j_profile.PROFILE_REGISTRY
    for r in (reg, jreg):
        r.count_dispatch("w", ("f32[8]@x",), 1)
        r.record_sample("w", ("f32[8]@x",), 1.0, 1.0, 0.0, 100.0, 10.0)
        for _ in range(3):
            r.count_dispatch("w", ("f32[8]@y",), 1)
            r.record_sample("w", ("f32[8]@y",), 1.0, 1.0, 0.0, 500.0, 50.0)
    merged, jmerged = profile.merged_profiles()["w"], j_profile.merged_profiles()["w"]
    j_profile.reset()
    assert merged["flops_per_dispatch"] == pytest.approx(400.0)
    assert merged["bytes_per_dispatch"] == pytest.approx(40.0)
    assert merged["intensity"] == pytest.approx(10.0)
    assert merged == jmerged


# -- exclusive time under nesting (forged clock) ------------------------------------


def test_exclusive_time_subtracts_nested_sampled_dispatches():
    profile.set_sample_every(1)
    now = [0.0]
    profile.set_clock(lambda: now[0])

    def inner_target(*a, **k):
        now[0] += 2.0
        return 7

    def outer_target(*a, **k):
        profile.profile_dispatch(_rec("inner"), inner_target, (), {})
        now[0] += 3.0
        return 7

    profile.profile_dispatch(_rec("outer"), outer_target, (), {})
    (inner,) = profile.PROFILE_REGISTRY.entries("inner")
    (outer,) = profile.PROFILE_REGISTRY.entries("outer")
    assert inner.sampled_seconds == pytest.approx(2.0)
    assert inner.sampled_exclusive_seconds == pytest.approx(2.0)
    assert outer.sampled_seconds == pytest.approx(5.0)
    assert outer.sampled_exclusive_seconds == pytest.approx(3.0)
    excl = profile.exclusive_seconds_by_name()
    assert excl["outer"] == pytest.approx(3.0) and excl["inner"] == pytest.approx(2.0)


def test_target_exception_propagates_without_a_sample():
    profile.set_sample_every(1)

    def boom(*a, **k):
        raise ValueError("no result, no sample")

    with pytest.raises(ValueError):
        profile.profile_dispatch(_rec("boom"), boom, (), {})
    (entry,) = profile.PROFILE_REGISTRY.entries("boom")
    assert entry.dispatches == 1 and entry.sampled == 0
    profile.profile_dispatch(_rec("ok"), lambda: 1, (), {})
    assert profile.PROFILE_REGISTRY.entries("ok")[0].sampled == 1


# -- overhead budget --------------------------------------------------------------


def test_steady_state_overhead_under_two_percent():
    """The reference's 2% bound on the sampler's own seconds, read as the
    counter's delta over a steady window: 640 calls between steps of host
    work, the first call (and its first sample) outside the window."""
    profile.set_sample_every(64)
    f = telemetry.instrumented(lambda x: x @ x + 1.0, name="overhead")
    x = torch.ones((64, 64))
    host = np.ones((256, 256), np.float32)
    f(x)  # the entry's first sample, outside the window
    overhead0 = metrics.counter("profile.overhead_seconds").value
    sampled0 = metrics.counter("profile.sampled").value
    t0 = time.perf_counter()
    for _ in range(640):
        float(np.sin(host).sum())
        f(x)
    elapsed = time.perf_counter() - t0
    overhead = metrics.counter("profile.overhead_seconds").value - overhead0
    assert metrics.counter("profile.sampled").value - sampled0 >= 9
    assert overhead / elapsed < 0.02, (
        f"profiler overhead {overhead:.4f}s of {elapsed:.4f}s ({overhead / elapsed:.1%}) "
        "blows the 2% budget")


# -- bound classes ------------------------------------------------------------------


def test_bound_class_attribution():
    peak_flops, peak_bw = 1e12, 1e11
    cases = [((1.0, 2e11, 1e11, peak_flops, peak_bw, 0.2), profile.BOUND_HBM),
             ((1.0, 9e11, 1e9, peak_flops, peak_bw, 0.9), profile.BOUND_COMPUTE),
             ((0.5, 4e11, 1e9, peak_flops, peak_bw, 0.04), profile.BOUND_LOW_COMPUTE),
             ((1.0, 1e9, 1e6, peak_flops, peak_bw, 0.001), profile.BOUND_DISPATCH),
             ((1.0, None, 1e9, peak_flops, peak_bw, None), profile.BOUND_UNKNOWN),
             ((1.0, 1e9, 1e6, None, None, None), profile.BOUND_UNKNOWN)]
    for args, code in cases:
        assert profile.bound_class(*args) == code == j_profile.bound_class(*args), args
    assert profile.bound_class_name(profile.BOUND_HBM) == "HBM-bound"
    assert profile.bound_class_name(profile.BOUND_DISPATCH) == "dispatch-bound"
    assert profile.bound_class_name(None) == "unknown"
    assert profile.bound_class_name(99) == "unknown"
    # the named difference: codes 1 and 2 are the card's compute classes
    assert profile.bound_class_name(1) == "compute-bound"
    assert profile.bound_class_name(2) == "low-compute-bound"
    assert (j_profile.bound_class_name(1), j_profile.bound_class_name(2)) == ("MXU-bound",
                                                                              "VPU-bound")


def test_timing_suspect_flags_rates_above_device_peak(caplog):
    executables.set_peaks(1e12, 1e11)
    reg = profile.PROFILE_REGISTRY
    reg.count_dispatch("liar", ("f32[4]",), 1)
    reg.record_sample("liar", ("f32[4]",), 1e-9, 1e-9, 0.0, 1e9, 1e6)
    assert profile.merged_profiles()["liar"]["timing_suspect"] is True
    with caplog.at_level(logging.WARNING, logger="photon_ml_tpu_torch.telemetry.profile"):
        profile.publish_metrics()
        profile.publish_metrics()
    snap = telemetry.snapshot()
    assert snap["gauges"]["profile.exec.liar.timing_suspect"] == 1
    assert snap["counters"]["profile.timing_suspect_total"] >= 1
    warnings = [r for r in caplog.records if "timing suspect" in r.getMessage()]
    assert len(warnings) == 1 and "liar" in warnings[0].getMessage()


def test_honest_rate_is_not_suspect():
    executables.set_peaks(1e12, 1e11)
    reg = profile.PROFILE_REGISTRY
    reg.count_dispatch("honest", ("f32[4]",), 1)
    reg.record_sample("honest", ("f32[4]",), 1.0, 1.0, 0.0, 1e9, 1e6)
    merged = profile.merged_profiles()["honest"]
    assert merged["timing_suspect"] is False
    assert merged["mfu"] == pytest.approx(1e-3)
    profile.publish_metrics()
    assert "profile.exec.honest.timing_suspect" not in telemetry.snapshot()["gauges"]


def test_unknown_peaks_mean_unknown_not_suspect():
    reg = profile.PROFILE_REGISTRY
    reg.count_dispatch("nopeaks", ("f32[4]",), 1)
    reg.record_sample("nopeaks", ("f32[4]",), 1e-9, 1e-9, 0.0, 1e9, 1e6)
    merged = profile.merged_profiles()["nopeaks"]
    assert executables.device_peaks() == (None, None)  # the CPU
    assert merged["timing_suspect"] is False and merged["mfu"] is None
    assert merged["bound_code"] == profile.BOUND_UNKNOWN


# -- publish / metrics round trip ----------------------------------------------------


def test_publish_metrics_gauges_round_trip(tmp_path):
    executables.set_peaks(1e12, 1e11)
    reg = profile.PROFILE_REGISTRY
    for _ in range(4):
        reg.count_dispatch("hot", ("f32[8]",), 1)
        reg.record_sample("hot", ("f32[8]",), 0.5, 0.4, 0.0, 1e10, 8e9)
    path = str(tmp_path / "telemetry.jsonl")
    telemetry.flush_metrics(path)
    with open(path, encoding="utf-8") as fh:
        g = json.loads(fh.readline())["snapshot"]["gauges"]
    assert g["profile.exec.hot.dispatches"] == 4
    assert g["profile.exec.hot.sampled"] == 4
    assert g["profile.exec.hot.est_exclusive_seconds"] == pytest.approx(1.6)
    assert g["profile.exec.hot.mean_dispatch_seconds"] == pytest.approx(0.5)
    assert g["profile.exec.hot.mfu"] == pytest.approx(0.02)
    assert g["profile.exec.hot.intensity"] == pytest.approx(1.25)
    assert g["profile.exec.hot.bound_code"] == profile.BOUND_HBM


def test_exclusive_seconds_by_name_registers_nothing():
    before = set(telemetry.snapshot()["gauges"])
    assert profile.exclusive_seconds_by_name() == {}
    assert set(telemetry.snapshot()["gauges"]) == before


# -- device-memory high-watermarks ------------------------------------------------------


def _fake_devices(monkeypatch, in_use: dict):
    """Devices with allocator stats from ``in_use`` (by index)."""
    monkeypatch.setattr(memory, "hbm_stats", lambda d=None: (
        {"bytes_in_use": in_use[d.index], "bytes_limit": 16 * 2**30}
        if d is not None and d.index in in_use else None))
    return [types.SimpleNamespace(index=i) for i in sorted(in_use)]


def test_watermarks_max_track_per_device_and_phase(monkeypatch):
    in_use = {0: 100, 1: 700}
    devices = _fake_devices(monkeypatch, in_use)
    memory.record_device_watermarks(devices, phase="fit")
    in_use[0], in_use[1] = 500, 300  # device 1 dips: its peak must not follow
    memory.record_device_watermarks(devices, phase="fit")
    g = telemetry.snapshot()["gauges"]
    assert g["memory.device.0.peak_bytes"] == 500
    assert g["memory.device.1.peak_bytes"] == 700
    assert g["memory.phase.fit.device.0.peak_bytes"] == 500
    assert g["memory.phase.fit.device.1.peak_bytes"] == 700
    assert g["memory.device.1.bytes_in_use"] == 300


def test_watermarks_absent_on_statless_backends():
    assert memory.record_device_watermarks([torch.device("cpu")]) == {}
    assert not any(".peak_bytes" in name for name in telemetry.snapshot()["gauges"])


def test_sampler_records_watermarks_under_open_span(monkeypatch):
    """The sampler probes every device on its cadence, attributed to the
    open span's phase (the stats stand-in plays the card)."""
    profile.set_sample_every(1)
    devices = _fake_devices(monkeypatch, {3: 4096})
    monkeypatch.setattr(memory, "_all_devices", lambda: devices)
    f = telemetry.instrumented(lambda x: x + 1, name="wm")
    with trace.span("fit"):
        f(torch.zeros(2))
    assert telemetry.snapshot()["gauges"]["memory.phase.fit.device.3.peak_bytes"] == 4096


# -- the capture window ----------------------------------------------------------------


def test_xprof_window_arms_and_stops_via_hooks():
    calls = []
    profile.set_xprof_hooks(lambda d: calls.append(("start", d)),
                            lambda: calls.append(("stop",)))
    assert profile.configure_xprof("/tmp/xp", arm_at=3, capture=2, force=True)
    f = telemetry.instrumented(lambda x: x + 1.0, name="xp")
    for _ in range(6):
        f(torch.zeros(2))
    assert ("start", "/tmp/xp") in calls and ("stop",) in calls
    assert calls.index(("start", "/tmp/xp")) < calls.index(("stop",))
    assert telemetry.snapshot()["gauges"]["profile.xprof_armed"] == 1


def test_xprof_refuses_cpu_backend_without_force():
    assert profile.configure_xprof("/tmp/xp") is False
    assert profile.configure_xprof("/tmp/xp", device="cpu") is False


def test_xprof_reset_closes_open_window():
    calls = []
    profile.set_xprof_hooks(lambda d: calls.append("start"), lambda: calls.append("stop"))
    profile.configure_xprof("/tmp/xp", arm_at=0, capture=100, force=True)
    telemetry.instrumented(lambda x: x + 1.0, name="xpreset")(torch.zeros(2))
    assert "start" in calls and "stop" not in calls
    profile.reset()
    assert "stop" in calls


def test_xprof_start_failure_disarms_without_killing_dispatch():
    def broken(d):
        raise RuntimeError("capture machinery wedged")

    profile.set_xprof_hooks(broken, lambda: None)
    profile.configure_xprof("/tmp/xp", arm_at=0, capture=2, force=True)
    out = telemetry.instrumented(lambda x: x * 3.0, name="xpfail")(torch.ones(2))
    np.testing.assert_allclose(out.numpy(), 3.0)
    assert profile._xprof_config is None


def test_xprof_forced_capture_on_the_cpu_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "xp"
    assert profile.configure_xprof(str(out), arm_at=1, capture=2, force=True)
    f = telemetry.instrumented(lambda x: x @ x, name="xpreal")
    with trace.span("window"):
        for _ in range(5):
            f(torch.ones(8, 8))
    (path,) = list(out.iterdir())
    assert path.name.endswith(".pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# -- lifecycle -------------------------------------------------------------------------


def test_reset_rearms_the_sampler():
    executables.set_dispatch_profiler(None)
    telemetry.reset()
    telemetry.instrumented(lambda x: x + 1.0, name="rearmed")(torch.zeros(2))
    (entry,) = profile.PROFILE_REGISTRY.entries("rearmed")
    assert entry.sampled == 1


# -- the timing on the card's stream -----------------------------------------------------


class _Clock:
    now = 0.0


class _FakeEvent:
    """``torch.cuda.Event`` stand-in: records the stream clock, completes
    when the test says so (``query``), waits by completing."""

    made: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        self.done = False
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        self.t = _Clock.now

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        # on one stream the end's completion implies the start's
        assert end.done and self.t is not None, "read before completion"
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_stream(monkeypatch):
    _FakeEvent.made = []
    _Clock.now = 0.0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: object())
    return _FakeEvent


def _complete_all():
    for e in _FakeEvent.made:
        e.done = True


def test_stream_samples_resolve_only_once_complete(fake_stream):
    profile.set_sample_every(1)
    rec = _rec("k", device="cuda:0", flops=2e9, bytes_accessed=1e9)

    def work():
        _Clock.now += 0.004
        return 1

    profile.profile_dispatch(rec, work, (), {})
    (entry,) = profile.PROFILE_REGISTRY.entries("k")
    assert entry.dispatches == 1 and entry.sampled == 0  # in flight, not read
    _complete_all()
    profile.profile_dispatch(rec, work, (), {})  # the next sample resolves the first
    assert entry.sampled == 1 and entry.sampled_seconds == pytest.approx(0.004)
    # publish time waits for what is still in flight
    profile.publish_metrics()
    assert entry.sampled == 2
    assert telemetry.snapshot()["gauges"]["profile.exec.k.mean_dispatch_seconds"] == \
        pytest.approx(0.004)
    assert _fetch_counters() == {"host_syncs": None, "device_fetches": None}


def test_stream_samples_subtract_nested_samples(fake_stream):
    profile.set_sample_every(1)

    def inner():
        _Clock.now += 2.0
        return 1

    def outer():
        profile.profile_dispatch(_rec("inner", device="cuda:0"), inner, (), {})
        _Clock.now += 3.0
        return 1

    profile.profile_dispatch(_rec("outer", device="cuda:0"), outer, (), {})
    profile.resolve_pending(wait=True)
    (o,), (i,) = profile.PROFILE_REGISTRY.entries("outer"), profile.PROFILE_REGISTRY.entries(
        "inner")
    assert o.sampled_seconds == pytest.approx(5.0)
    assert o.sampled_exclusive_seconds == pytest.approx(3.0)
    assert i.sampled_exclusive_seconds == pytest.approx(2.0)


def test_a_call_on_a_cuda_device_is_timed_on_its_stream(fake_stream, monkeypatch):
    """The record's device decides the clock: a call whose arguments hold a
    CUDA tensor is timed by an event pair, not by the host clock."""
    rec = _rec("dev", device="cuda:0")
    host_clock = []
    profile.set_clock(lambda: host_clock.append(1) or 0.0)
    profile.profile_dispatch(rec, lambda: 1, (), {})
    assert len(fake_stream.made) == 2 and not host_clock
    profile.reset()
    profile.profile_dispatch(_rec("host"), lambda: 1, (), {})
    assert len(fake_stream.made) == 2  # the host clock timed this one


def test_the_sampler_adds_no_host_sync_to_a_fit():
    """The same small GLM fit with the sampler armed (every call sampled) and
    disarmed: the same host syncs and bit-identical coefficients."""
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.optim.factory import OptimizerConfig
    from photon_ml_tpu_torch.training import train_glm

    rng = np.random.default_rng(4)
    X = rng.normal(size=(200, 8)) * (rng.random((200, 8)) < 0.5)
    y = (rng.random(200) < 1 / (1 + np.exp(-X @ rng.normal(size=8)))).astype(np.float32)
    r, c = np.nonzero(X)
    batch = CSRBatch.from_coo(X[r, c].astype(np.float32), r, c, y, 8, device="cpu")

    def fit():
        before = telemetry.peek_counter("host_syncs") or 0
        (entry,) = train_glm(batch, "logistic", [1.0], OptimizerConfig(max_iterations=10),
                             device="cpu")
        return (telemetry.peek_counter("host_syncs") or 0) - before, entry.model.coefficients

    profile.set_sample_every(1)
    armed_syncs, armed_w = fit()
    assert profile.PROFILE_REGISTRY.entries("glm_sweep_solve")[0].sampled == 1
    executables.set_dispatch_profiler(None)
    try:
        syncs, w = fit()
    finally:
        profile.install()
    assert armed_syncs == syncs > 0
    assert torch.equal(armed_w.means, w.means)


def test_launch_window_narrows_a_kernel_sample_to_its_launch(fake_stream):
    """A kernel wrapper's ``launch_window`` records the sample's events again
    around the launch: the wrapper's host work before and after it is not
    read as stream time; an outer sampled call is not narrowed by a kernel
    launched inside it."""
    profile.set_sample_every(1)

    def kernel():
        _Clock.now += 1.0  # checks and allocations on the host
        with profile.launch_window("k"):
            _Clock.now += 0.5  # the launch
        _Clock.now += 1.0
        return 1

    def solve():
        profile.profile_dispatch(_rec("k", device="cuda:0"), kernel, (), {})
        with profile.launch_window("k"):  # not the solve's own window
            _Clock.now += 4.0
        return 1

    profile.profile_dispatch(_rec("solve", device="cuda:0"), solve, (), {})
    profile.resolve_pending(wait=True)
    (k,), (s,) = profile.PROFILE_REGISTRY.entries("k"), profile.PROFILE_REGISTRY.entries("solve")
    assert k.sampled_seconds == pytest.approx(0.5)
    assert s.sampled_seconds == pytest.approx(6.5)
    assert s.sampled_exclusive_seconds == pytest.approx(6.0)
