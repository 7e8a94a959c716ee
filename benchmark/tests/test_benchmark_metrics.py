"""The metric arithmetic: the window's rate, idle from intervals, the
rooflines, and the readers' silence where there is nothing to read."""

import types

import numpy as np
import pytest

from benchmark import devtrace, harness
from benchmark.yardstick import cost, peaks


def _reader(name):
    return harness.load_module("metrics", name)


def test_union_length_and_gaps():
    s = np.array([0, 5, 20, 22, 40], np.int64)
    e = np.array([10, 12, 25, 30, 41], np.int64)
    total, gs, ge = devtrace.union_length(s, e)
    assert total == 12 + 10 + 1
    assert gs.tolist() == [12, 30] and ge.tolist() == [20, 40]


def test_summary_idle_and_gap_names():
    ivs = [devtrace.Interval("k1", 0, 0, 10_000_000),
           devtrace.Interval("row_pass_kernel", 0, 30_000_000, 40_000_000),
           devtrace.Interval("aten::item", -1, 9_000_000, 31_000_000),
           devtrace.Interval("bench.call", -1, 0, 100_000_000)]
    s = devtrace.summarize(ivs, window_s=0.1)
    assert s.busy_s == {0: pytest.approx(0.02)}
    assert s.kernels == {"row_pass_kernel": [1, pytest.approx(0.01)]}
    assert s.idle_gaps == [["aten::item", pytest.approx(0.02)]]
    w = types.SimpleNamespace(trace=s, cards=1)
    assert _reader("device_idle").read(w) == pytest.approx(80.0)
    # a second card with no interval counts as idle
    assert _reader("device_idle").read(types.SimpleNamespace(trace=s, cards=2)) == \
        pytest.approx(90.0)


def test_gap_spanned_by_no_host_op_is_host_python():
    ivs = [devtrace.Interval("k", 0, 0, 10), devtrace.Interval("k", 0, 50, 60),
           devtrace.Interval("short", -1, 20, 30)]
    assert devtrace.summarize(ivs, 1e-7).idle_gaps == [["host_python", pytest.approx(4e-8)]]


class _Session:
    build_s = 1.5

    def __init__(self, work=(0.0, 0.0), shapes=None):
        self._work, self._shapes = work, shapes or {}

    def window_work(self):
        return self._work

    def kernel_shapes(self):
        return self._shapes


def _window(**kw):
    base = dict(calls=4, seconds=2.0, cards=1, trace=None, host_syncs=100,
                session=_Session())
    base.update(kw)
    return harness.Window(**base)


def test_fit_mfu_is_the_bound_over_the_wall():
    w = _window(session=_Session(work=(0.0, 3.35e12 * 0.5)))
    assert _reader("fit_mfu").read(w) == pytest.approx(25.0)
    w = _window(cards=4, session=_Session(work=(67e12 * 4, 0.0)))
    assert _reader("fit_mfu").read(w) == pytest.approx(50.0)
    assert _reader("fit_mfu").read(_window()) is None


def test_kernels_roofline_sums_bounds_over_device_time():
    shape = dict(n_rows=1000, nnz=20000, n_features=100)
    bound = peaks.bound_seconds(*cost.csc_scatter(**shape))
    trace = devtrace.TraceSummary(window_s=1.0, busy_s={0: 0.5},
                                  kernels={"csc_scatter_tiled_kernel": [3, 6 * bound],
                                           "finish_tiled_kernel": [3, 6 * bound]},
                                  device_ops=[], idle_gaps=[])
    w = _window(trace=trace, session=_Session(shapes={"csc_scatter": shape}))
    assert _reader("kernels_roofline").read(w) == pytest.approx(100.0 * 3 / 12)
    # no shape for the kernel's wrapper, or no trace: nothing to read
    assert _reader("kernels_roofline").read(_window(trace=trace)) is None
    assert _reader("kernels_roofline").read(_window()) is None


def test_counter_and_span_readers():
    assert _reader("host_syncs_per_fit").read(_window()) == 25.0
    assert _reader("setup.build_s").read(_window()) == 1.5


class _SleepSession(_Session):
    def __init__(self, step):
        super().__init__()
        self.step, self.calls = step, 0

    def call(self):
        import time

        time.sleep(self.step)
        self.calls += 1

    def begin_window(self):
        self.calls = 0

    def free(self):
        pass

    def check(self):
        return [(self.calls, {"n": 0.0})]


def test_rate_is_the_whole_window_over_its_calls(monkeypatch):
    """``fit_s`` is the window's seconds, to the end of the call running at
    the deadline, over every call it completed."""
    import time

    import torch

    session = _SleepSession(0.07)
    real = harness.load_module
    monkeypatch.setattr(harness, "load_module", lambda kind, name: (
        types.SimpleNamespace(prepare=lambda bench: session) if kind == "drivers"
        else real(kind, name)))
    cell = harness.Cell(name="x", chips=1, config={}, traffic={"driver": "x"},
                        limits={"n": {"limit": 0.0}},
                        end_to_end=[{"name": "fit_s", "unit": "s"}], per_layer=[])
    t0 = time.perf_counter()
    res = harness.measure(cell, 1, 0.3, False, t0, [torch.device("cpu")])
    assert res["attempted"] == session.calls >= 5
    fit_s = res["metrics"]["fit_s"]["value"]
    assert 0.07 <= fit_s < 0.085
    assert fit_s * res["attempted"] >= 0.3
