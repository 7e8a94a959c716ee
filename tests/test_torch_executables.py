"""The port's executable accounting (``photon_ml_tpu_torch.telemetry.
executables``, ``kernels/cost.py``, the compile counters of
``telemetry/device.py``), the run report's Device utilization, the
heartbeat's device fields and ``cli profile``, against the JAX package's
``telemetry.xla``, case for case with tests/test_xla.py, on the CPU:

- the registry: calls, the modelled cost of each call, the metric names
  (``xla.calls``, ``xla.flops_total``, ``xla.exec.<name>.*``) equal to the
  reference's for the same work; "unknown" (never 0) without modelled work;
  signatures in arrival order, Python scalars not fragmenting them, a
  signature set by design never counted as a recompile;
- the cost model: every kernel wrapper and dense contraction reports the
  work of ``kernels/cost.py`` for its shapes (on the CPU, through the plain
  versions); at config #1's shapes the bytes give the bounds of the kernel
  table in PERF.md §6 at 3.35e12 B/s;
- the peaks (CPU unknown, the environment, pinned, the card's table),
  collective estimates (the reference's formulas), the distributed solve's
  estimate, the heartbeat's ``mfu`` and ``comms_fraction``;
- the report's Device utilization (none, unknown, full) and an end-to-end
  fit through ``cli report`` rendered by both packages with peaks pinned:
  the same section structure;
- the kernels' ``nvcc`` build counted as a compile (``jit_compiles``), a
  reused library not;
- ``cli profile`` wrapping a train run (a Chrome trace in
  ``--profile-dir``, the span mirror torn down) and requiring a command;
- the synthetic generators of ``photon_ml_tpu_torch.testing`` give the
  reference's arrays bit for bit.

Cases of tests/test_xla.py with no torch subject (ROADMAP.md Queue 3 item
5): ``test_real_cost_analysis_on_default_backend`` (XLA's cost analysis;
the port models its kernels' cost instead),
``test_recompile_attributed_to_signature_delta`` (recompile attribution and
the storm warning: eager PyTorch compiles nothing per shape),
``test_aot_failure_falls_back_to_plain_jit`` (the AOT fallback),
``test_engine_compile_summary_per_bucket`` (the engine's per-bucket XLA
compile records). ``test_budget_deadline_reserves_flush_margin`` and
``test_bench_headline_truncates_when_budget_spent`` import ``bench_suite``
and ``bench``: they go to the port's benchmark.

Tolerances: the reference test's (exact, or ``pytest.approx`` where it
uses it); generators bit for bit.
"""

import json
import logging
import os
import stat

import numpy as np
import pytest
import torch

from photon_ml_tpu import telemetry as j_telemetry
from photon_ml_tpu.telemetry import xla
from photon_ml_tpu.telemetry.report import RunReport as JRunReport
from photon_ml_tpu_torch import kernels, telemetry
from photon_ml_tpu_torch.kernels import cost
from photon_ml_tpu_torch.telemetry import executables
from photon_ml_tpu_torch.telemetry.report import RunReport

FAKE_COST = {"flops": 1000.0, "bytes accessed": 640.0}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture
def fake_analysis():
    """The JAX side's injected cost (tests/test_xla.py's fixture)."""
    xla.set_analysis_provider(lambda compiled: (FAKE_COST, None))
    yield
    xla.set_analysis_provider(None)


def _modelled(fn, flops=FAKE_COST["flops"], nbytes=FAKE_COST["bytes accessed"]):
    """``fn`` launching one modelled piece of work of the fake cost."""

    def run(*args):
        executables.account(flops, nbytes)
        return fn(*args)

    return run


def _counters(pkg):
    return pkg.snapshot()["counters"]


# -- registry round trip -------------------------------------------------------


def test_registry_round_trip_with_modelled_cost(fake_analysis):
    f = executables.instrumented(_modelled(lambda x: x * 2.0), name="double")
    jf = xla.instrumented_jit(lambda x: x * 2.0, name="double")
    x = torch.ones(8)
    for _ in range(2):
        np.testing.assert_allclose(f(x).numpy(), 2.0)
        np.testing.assert_allclose(np.asarray(jf(np.ones((8,), np.float32))), 2.0)
    (rec,) = executables.EXECUTABLE_REGISTRY.executables("double")
    (jrec,) = xla.XLA_REGISTRY.executables("double")
    for r in (rec, jrec):
        assert r.calls == 2
        assert r.flops == 1000.0 and r.bytes_accessed == 640.0
        assert r.signature == ("f32[8]",)
    snap, jsnap = _counters(telemetry), _counters(j_telemetry)
    for key in ("xla.calls", "xla.flops_total", "xla.bytes_total", "xla.exec.double.calls"):
        assert snap[key] == jsnap[key], key
    assert snap["xla.flops_total"] == 2000.0 and snap["xla.bytes_total"] == 1280.0
    assert "xla.recompiles" not in snap and "xla.recompiles" not in jsnap
    assert "xla.compiles" not in snap  # nothing is compiled per shape here
    json.dumps(executables.EXECUTABLE_REGISTRY.snapshot())


def test_unknown_degradation_without_modelled_work():
    # an executable that launched nothing modelled: "unknown", never zero,
    # as the reference's without cost analysis
    xla.set_analysis_provider(lambda compiled: (None, None))
    try:
        executables.instrumented(lambda x: x + 1.0, name="nocost")(torch.zeros(4))
        xla.instrumented_jit(lambda x: x + 1.0, name="nocost")(np.zeros((4,), np.float32))
    finally:
        xla.set_analysis_provider(None)
    for rec in (executables.EXECUTABLE_REGISTRY.executables("nocost")[0],
                xla.XLA_REGISTRY.executables("nocost")[0]):
        assert rec.flops is None and rec.bytes_accessed is None
    assert "xla.flops_total" not in _counters(telemetry)
    assert "xla.flops_total" not in _counters(j_telemetry)
    assert _counters(telemetry)["xla.calls"] == 1


def test_nested_executables_count_the_work_once():
    """An executable's cost includes what it launched inside others; the
    global totals and the span see each launch once."""
    inner = executables.instrumented(_modelled(lambda x: x), name="inner")
    outer = executables.instrumented(lambda x: inner(inner(x)), name="outer")
    with telemetry.span("phase"):
        outer(torch.zeros(3))
    assert executables.EXECUTABLE_REGISTRY.executables("outer")[0].flops == 2000.0
    assert executables.EXECUTABLE_REGISTRY.executables("inner")[0].flops == 1000.0
    snap = _counters(telemetry)
    assert snap["xla.flops_total"] == 2000.0
    assert snap["xla.exec.outer.flops_total"] == 2000.0
    assert snap["xla.exec.inner.flops_total"] == 2000.0
    assert telemetry.finished_spans("phase")[0].attrs["xla_flops"] == 2000.0


def _small_batch(seed=0, n=40, f=6):
    from photon_ml_tpu_torch.ops.csr import CSRBatch

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)) * (rng.random((n, f)) < 0.5)
    y = (rng.random(n) < 0.5).astype(np.float32)
    r, c = np.nonzero(X)
    return CSRBatch.from_coo(X[r, c].astype(np.float32), r, c, y, f, device="cpu")


def _kernel_calls():
    """Each wrapper's call on a small CPU batch and the cost its shapes give."""
    from photon_ml_tpu_torch.ops.ell import ELLBatch

    b = _small_batch()
    n, f, nnz = b.num_rows, b.num_features, b.nnz
    g = torch.Generator().manual_seed(1)
    w, v = torch.randn(f, generator=g), torch.randn(f, generator=g)
    per_row, d2 = torch.randn(n, generator=g), torch.rand(n, generator=g)
    W, R = torch.randn(3, f, generator=g), torch.randn(3, n, generator=g)
    rows = np.repeat(np.arange(n), np.diff(b.row_ptr.numpy()))
    ell = ELLBatch.from_coo(b.vals.numpy(), rows, b.cols.numpy(), np.zeros(n), f,
                            device="cpu")
    rest = (b.labels, b.weights, b.offsets)
    return {
        "csr_margins": (lambda: kernels.csr_margins(*b._csr, w, b.offsets, 0.0, True),
                        cost.csr_margins(n, nnz, f, use_offsets=True)),
        "csc_scatter": (lambda: kernels.csc_scatter(*b._csc, per_row, False, b.tiles),
                        cost.csc_scatter(n, nnz, f)),
        "margins_pair": (lambda: kernels.margins_pair(b._csr, w, v, b.offsets, 0.0, 0.0),
                         cost.margins_pair(n, nnz, f)),
        "value_grad": (lambda: kernels.value_grad(b._csr, b._csc, *rest, w, 0.0, "logistic",
                                                  b.tiles),
                       cost.value_grad(n, nnz, f)),
        "hv": (lambda: kernels.hv(b._csr, b._csc, *rest, w, 0.0, v, 0.0, "logistic", b.tiles),
               cost.hv(n, nnz, f)),
        "hv_at": (lambda: kernels.hv_at(b._csr, b._csc, d2, v, 0.0, b.tiles),
                  cost.hv_at(n, nnz, f)),
        "ell_margins": (lambda: kernels.ell_margins(ell.vals, ell.cols, w, ell.offsets, 0.0,
                                                    False),
                        cost.ell_margins(*ell.vals.shape, f, n)),
        "csr_margins_lanes": (lambda: kernels.csr_margins_lanes(*b._csr, W, b.offsets, 0.0,
                                                                False),
                              cost.csr_margins_lanes(n, nnz, f, 3)),
        "csc_scatter_lanes": (lambda: kernels.csc_scatter_lanes(*b._csc, R, False, b.tiles),
                              cost.csc_scatter_lanes(n, nnz, f, 3)),
    }


@pytest.mark.parametrize("name", list(kernels.LAUNCHES))
def test_kernel_wrappers_report_their_modelled_cost(name):
    """Each wrapper is an executable under its launch-count name whose call
    reports ``kernels/cost.py``'s work for its shapes, on the CPU (the plain
    version) as on the card: the cost is the function's."""
    call, (flops, nbytes) = _kernel_calls()[name]
    launches = dict(kernels.LAUNCHES)
    with telemetry.span("k"):
        call()
    assert kernels.LAUNCHES == launches  # the plain version launches nothing
    (rec,) = executables.EXECUTABLE_REGISTRY.executables(name)
    assert (rec.calls, rec.flops, rec.bytes_accessed) == (1, flops, nbytes)
    snap = _counters(telemetry)
    assert (snap["xla.flops_total"], snap["xla.bytes_total"]) == (flops, nbytes)
    attrs = telemetry.finished_spans("k")[0].attrs
    assert (attrs["xla_flops"], attrs["xla_bytes"]) == (flops, nbytes)
    assert all(s.endswith(("]", ">")) or s.startswith(("py", "=")) for s in rec.signature)


def test_dense_contractions_report_their_modelled_cost():
    from photon_ml_tpu_torch.ops.dense import DenseBatch

    rng = np.random.default_rng(2)
    E, R, K = 3, 5, 4
    b = DenseBatch.from_arrays(rng.normal(size=(E, R, K)), np.zeros((E, R)), device="cpu")
    w = torch.randn(E, K)
    expected = {"dot_rows": cost.dense_rows(E, R, K),
                "margins_pair": cost.dense_rows(E, R, K, vectors=2),
                "scatter_features": cost.dense_scatter(E, R, K),
                "scatter_features_sq": cost.dense_scatter(E, R, K, square=True)}
    for name, (flops, nbytes) in expected.items():
        telemetry.reset()
        if name == "margins_pair":
            b.margins_pair(w, 0.0, w, 0.0)
        elif name == "dot_rows":
            b.dot_rows(w)
        else:
            getattr(b, name)(torch.randn(E, R))
        snap = _counters(telemetry)
        assert (snap["xla.flops_total"], snap["xla.bytes_total"]) == (flops, nbytes), name
    assert cost.dense_rows(E, R, K) == (2 * E * R * K, 4 * (E * R * K + E * K + E * R))


# config #1 (bench.py:63-113): 1M rows, 10K features, 20 nonzeros a row;
# the ELL layout pads the rows to a multiple of 128
_N, _F, _NNZ = 1_000_000, 10_000, 20_000_000
_ELL_PAD = -(-_N // 128) * 128
#: PERF.md §6's kernel table: the bound column, ms at 3.35e12 B/s
KERNEL_TABLE_BOUNDS = [
    ("csr_margins", cost.csr_margins(_N, _NNZ, _F), 0.0502),
    ("csc_scatter", cost.csc_scatter(_N, _NNZ, _F), 0.0490),
    ("margins_pair", cost.margins_pair(_N, _NNZ, _F), 0.0526),
    ("value_grad", cost.value_grad(_N, _NNZ, _F), 0.0526),
    ("hv_at", cost.hv_at(_N, _NNZ, _F), 0.0502),
    ("hv", cost.hv(_N, _NNZ, _F), 0.0526),
    ("ell_margins", cost.ell_margins(20, _ELL_PAD, _F, _N, nnz=_NNZ), 0.0490),
    ("csr_margins_lanes G=16", cost.csr_margins_lanes(_N, _NNZ, _F, 16), 0.0683),
    ("csr_margins_lanes G=8", cost.csr_margins_lanes(_N, _NNZ, _F, 8), 0.0586),
    ("csc_scatter_lanes G=16", cost.csc_scatter_lanes(_N, _NNZ, _F, 16), 0.0671),
    ("csc_scatter_lanes G=8", cost.csc_scatter_lanes(_N, _NNZ, _F, 8), 0.0574),
]


@pytest.mark.parametrize("name,work,bound_ms", KERNEL_TABLE_BOUNDS,
                         ids=[row[0] for row in KERNEL_TABLE_BOUNDS])
def test_cost_model_gives_the_bounds_of_the_kernel_table(name, work, bound_ms):
    """The bound is the larger of bytes over 3.35e12 B/s and flops over
    67e12 FLOP/s (the card's f32 peak); every row is bound by its bytes."""
    flops, nbytes = work
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / 67e12 * 1e3
    assert t_bytes > t_ops
    assert round(max(t_bytes, t_ops), 4) == bound_ms


def test_csr_margins_bytes_at_config_1():
    # row pointer, the slots, w, the margins, 4 bytes each: the 0.0502 ms
    flops, nbytes = cost.csr_margins(_N, _NNZ, _F)
    assert nbytes == 4 * ((_N + 1) + 2 * _NNZ + _F + _N) == 168_040_004
    assert flops == 2 * _NNZ
    assert cost.csr_margins(_N, _NNZ, _F, use_offsets=True)[1] == nbytes + 4 * _N


def test_python_scalars_do_not_fragment_signatures(fake_analysis):
    f = executables.instrumented(lambda x, s: x * s, name="scale")
    f(torch.ones(3), 2.0)
    f(torch.ones(3), 7.0)
    jf = xla.instrumented_jit(lambda x, s: x * s, name="scale")
    jf(np.ones((3,), np.float32), 2.0)
    jf(np.ones((3,), np.float32), 7.0)
    assert len(executables.EXECUTABLE_REGISTRY.executables("scale")) == 1
    assert _counters(j_telemetry)["xla.compiles"] == 1
    assert (executables.EXECUTABLE_REGISTRY.signature_history("scale")
            == xla.XLA_REGISTRY.signature_history("scale") == [("f32[3]", "pyfloat")])


def test_signatures_arrive_in_order_without_recompiles(fake_analysis, caplog):
    """Shape and dtype changes register new signatures, in the reference's
    strings and order; none is a recompile (nothing compiles per shape)."""
    f = executables.instrumented(lambda x: x.sum(), name="sum_it")
    jf = xla.instrumented_jit(lambda x: x.sum(), name="sum_it")
    with caplog.at_level(logging.WARNING):
        for shape, t_dtype, np_dtype in ((4, torch.float32, np.float32),
                                         (4, torch.float32, np.float32),
                                         (9, torch.float32, np.float32),
                                         (17, torch.float32, np.float32),
                                         (17, torch.int32, np.int32)):
            f(torch.zeros(shape, dtype=t_dtype))
            jf(np.zeros((shape,), np_dtype))
    history = executables.EXECUTABLE_REGISTRY.signature_history("sum_it")
    assert history == xla.XLA_REGISTRY.signature_history("sum_it")
    assert history == [("f32[4]",), ("f32[9]",), ("f32[17]",), ("i32[17]",)]
    assert "xla.recompiles" not in _counters(telemetry)
    assert not any("photon_ml_tpu_torch" in r.name and "recompile" in r.message
                   for r in caplog.records)


def test_multi_shape_executables_are_not_recompile_storms(fake_analysis, caplog):
    f = executables.instrumented(lambda x: x.sum(), name="bucketed")  # any set is expected
    jf = xla.instrumented_jit(lambda x: x.sum(), name="bucketed", multi_shape=True)
    with caplog.at_level(logging.WARNING):
        for n in (1, 2, 4, 8):
            f(torch.zeros(n))
            jf(np.zeros((n,), np.float32))
    assert (len(executables.EXECUTABLE_REGISTRY.executables("bucketed"))
            == len(xla.XLA_REGISTRY.executables("bucketed")) == 4)
    assert "xla.recompiles" not in _counters(telemetry)
    assert not any("recompile storm" in r.message for r in caplog.records)


def test_engine_warmup_counts_no_recompiles():
    from photon_ml_tpu_torch.convert import game_model_from_jax
    from photon_ml_tpu_torch.serving import ScoringEngine

    model = game_model_from_jax("logistic", {"fixed": {
        "shard_name": "global", "coefficients": np.asarray([0.1, 0.2])}}, device=CPU)
    engine = ScoringEngine(model, max_batch=8, version="v-w", device=CPU).warmup()
    counters = _counters(telemetry)
    assert "xla.recompiles" not in counters
    # every bucket ran once through the accounted score and its kernel
    assert counters["xla.exec.serving_score.calls"] == len(engine.bucket_sizes)
    assert counters["xla.exec.csr_margins.calls"] == len(engine.bucket_sizes)


# -- peaks / collectives -------------------------------------------------------


def test_device_peaks_injection_and_env(monkeypatch):
    assert executables.device_peaks() == (None, None)  # CPU: unknown
    monkeypatch.setenv("PHOTON_PEAK_FLOPS", "2e12")
    monkeypatch.setenv("PHOTON_PEAK_HBM_GBPS", "100")
    flops, bw = executables.device_peaks()
    assert flops == 2e12 and bw == 100e9
    assert executables.device_peaks() == xla.device_peaks()
    g = telemetry.snapshot()["gauges"]
    assert g["device.peak_flops"] == 2e12
    assert g["device.peak_hbm_bytes_per_sec"] == 100e9
    executables.set_peaks(1e12, 5e10)
    assert executables.device_peaks() == (1e12, 5e10)
    executables.reset()
    monkeypatch.setenv("PHOTON_PEAK_FLOPS", "not-a-number")
    monkeypatch.setenv("PHOTON_PEAK_HBM_GBPS", "819GB")
    assert executables.device_peaks() == (None, None)


@pytest.mark.parametrize("name,peaks", [("NVIDIA H100 80GB HBM3", (67e12, 3.35e12)),
                                        ("NVIDIA H100 SXM5 80GB", (67e12, 3.35e12)),
                                        ("NVIDIA A100-SXM4-40GB", (None, None))])
def test_device_peaks_from_the_cards_name(monkeypatch, name, peaks):
    """The card's own entry: float32 on CUDA cores and HBM3 (the kernels
    compute in float32); a card the table does not know is unknown."""
    monkeypatch.setattr(executables, "_device_name", lambda: name)
    assert executables.device_peaks() == peaks


def test_collective_bytes_math():
    for args in (("psum", 1, 1000), ("psum", 4, 1000), ("all_gather", 4, 1000),
                 ("reduce_scatter", 8, 4096)):
        assert executables.collective_bytes(*args) == xla.collective_bytes(*args)
    assert executables.collective_bytes("psum", 4, 1000) == 1500
    with pytest.raises(ValueError):
        executables.collective_bytes("all_to_all", 4, 1000)


def test_record_collective_gauges_and_span():
    with telemetry.span("solve"):
        n = executables.record_collective("fe", "psum", 8, 4000, count=10)
    assert n == xla.collective_bytes("psum", 8, 4000) * 10
    snap = telemetry.snapshot()
    assert snap["counters"]["comms.bytes_total"] == n
    assert snap["counters"]["comms.fe.bytes"] == n
    assert snap["gauges"]["comms.fe.bytes_per_call"] == xla.collective_bytes("psum", 8, 4000)
    assert telemetry.finished_spans("solve")[0].attrs["comms_bytes"] == n
    assert executables.record_collective("fe1", "psum", 1, 4000) == 0
    assert "comms.fe1.bytes" not in telemetry.snapshot()["counters"]


def test_distributed_solve_records_comms_estimate():
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.optim.factory import OptimizerConfig
    from photon_ml_tpu_torch.parallel import distributed_solve, make_mesh, shard_rows

    rng = np.random.default_rng(12345)
    n, d = 64, 5
    vals = rng.normal(size=n * 3)
    rows = np.repeat(np.arange(n), 3)
    cols = rng.integers(0, d, n * 3)
    y = (rng.random(n) > 0.5).astype(float)
    batch = CSRBatch.from_coo(vals, rows, cols, y, d, device="cpu")
    mesh = make_mesh({"data": 8}, [CPU] * 8)
    distributed_solve("logistic", shard_rows(batch, 8), OptimizerConfig(max_iterations=3),
                      torch.zeros(d), mesh)
    counters = _counters(telemetry)
    expected = xla.collective_bytes("psum", 8, d * 4 + 4) * 3
    assert counters["comms.distributed_solve.bytes"] == expected
    assert counters["xla.exec.distributed_solve.calls"] == 1
    assert counters["xla.exec.distributed_solve.flops_total"] > 0


# -- heartbeat fields -----------------------------------------------------------


def test_heartbeat_gains_mfu_and_comms_fraction():
    from photon_ml_tpu_torch.telemetry.progress import Heartbeat

    executables.set_peaks(1e9, None)
    hb = Heartbeat(interval=60.0)
    line = hb.beat()
    assert "mfu" not in line and "comms_fraction" not in line  # no work yet
    # probing registers nothing: absent stays unknown
    assert "xla.flops_total" not in _counters(telemetry)
    assert "comms.bytes_total" not in _counters(telemetry)
    executables.instrumented(_modelled(lambda x: x + 1), name="hb_work")(torch.zeros(4))
    executables.record_collective("hb", "psum", 4, 1000)
    line = hb.beat()
    assert line["mfu"] > 0
    comms = xla.collective_bytes("psum", 4, 1000)
    assert line["comms_fraction"] == pytest.approx(comms / (comms + FAKE_COST["bytes accessed"]))
    executables.reset()  # peaks unknown: the field is left out, not zero
    executables.instrumented(_modelled(lambda x: x + 2), name="hb_work2")(torch.zeros(4))
    assert "mfu" not in hb.beat()


# -- run report: Device utilization ---------------------------------------------


def test_device_utilization_none_without_accounting():
    report = RunReport.from_live()
    assert report.device_utilization() is None
    assert "Device utilization" not in report.to_markdown()


def test_device_utilization_unknown_rendering():
    f = executables.instrumented(_modelled(lambda x: x * 2), name="phase_work")
    with telemetry.span("fit"):
        f(torch.ones(4))
    report = RunReport.from_live()
    du = report.device_utilization()
    assert du["mfu"] is None and du["flops_total"] == FAKE_COST["flops"]
    assert du["phases"][0]["phase"] == "fit"
    assert du["phases"][0]["flops"] == FAKE_COST["flops"]
    md = report.to_markdown()
    assert "## Device utilization" in md
    assert "- MFU: unknown" in md
    assert "device peak FLOP/s unknown" in md


def test_comms_fraction_unknown_without_hbm_bytes():
    f = executables.instrumented(lambda x: x + 1, name="nk")
    with telemetry.span("fit"):
        f(torch.zeros(2))
        executables.record_collective("s", "psum", 4, 1000)
    du = RunReport.from_live().device_utilization()
    assert du["comms_bytes_total"] > 0
    assert du["comms_fraction"] is None
    assert "comms fraction unknown" in RunReport.from_live().to_markdown()


def test_device_utilization_full(fake_analysis):
    """The same work and collectives in both packages: equal Device
    utilization (phases, MFU, bandwidth, comms) but the compile fields."""
    for pkg, peaks, instrument, collective in (
            (telemetry, executables.set_peaks,
             lambda: executables.instrumented(_modelled(lambda x: x * 2), name="work"),
             executables.record_collective),
            (j_telemetry, xla.set_peaks,
             lambda: xla.instrumented_jit(lambda x: x * 2, name="work"),
             xla.record_collective)):
        peaks(1e12, 1e11)
        f = instrument()
        x = torch.ones(4) if pkg is telemetry else np.ones((4,), np.float32)
        with pkg.span("fit"):
            with pkg.span("coordinate:fixed"):
                f(x)
                collective("solve", "psum", 8, 4000)
    report, j_report = RunReport.from_live(), JRunReport.from_live()
    du, jdu = report.device_utilization(), j_report.device_utilization()
    assert du["mfu"] > 0 and du["bandwidth_utilization"] > 0
    assert du["comms_bytes_total"] == xla.collective_bytes("psum", 8, 4000)
    assert 0 < du["comms_fraction"] < 1
    phases = {p["phase"]: p for p in du["phases"]}
    assert phases["fit"]["flops"] == FAKE_COST["flops"]
    assert phases["fit > coordinate:fixed"]["flops"] == FAKE_COST["flops"]
    for key in ("flops_total", "bytes_accessed_total", "comms_bytes_total", "comms_fraction",
                "peak_flops", "peak_hbm_bytes_per_sec"):
        assert du[key] == jdu[key], key
    assert [p["phase"] for p in du["phases"]] == [p["phase"] for p in jdu["phases"]]
    top = du["top_executables"]
    assert top and top[0]["name"] == "work" and top[0]["flops_total"] == FAKE_COST["flops"]
    md = report.to_markdown(deltas=None)
    assert "## Device utilization" in md
    assert "Top executables by cost" in md and "`work`" in md
    assert report.key_metrics()["mfu"] == pytest.approx(du["mfu"])
    assert report.to_json()["device_utilization"]["mfu"] == pytest.approx(du["mfu"])


# -- e2e: fit -> report with a finite MFU -----------------------------------------


def _sections(md):
    return [line for line in md.splitlines() if line.startswith("## ")]


def test_e2e_fit_report_device_utilization(tmp_path):
    """A fit through ``cli report`` in both packages on the same generated
    dataset with the peaks pinned: a Device utilization section with a
    finite MFU and per-phase FLOPs in both, the same section headings (but
    the named one below), and ``fe_solve`` among the executables. The
    port's compile share is unknown on the CPU (no kernel build), the
    reference's is not."""
    from photon_ml_tpu.cli.report import main as j_report_main
    from photon_ml_tpu.game.estimator import FixedEffectConfig as JFixed
    from photon_ml_tpu.game.estimator import GameConfig as JGameConfig
    from photon_ml_tpu.game.estimator import GameEstimator as JEstimator
    from photon_ml_tpu.optim.factory import OptimizerConfig as JOpt
    from photon_ml_tpu.testing import generate_game_dataset as j_generate
    from photon_ml_tpu_torch.cli.report import main as report_main
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, GameEstimator
    from photon_ml_tpu_torch.optim.factory import OptimizerConfig
    from photon_ml_tpu_torch.testing import generate_game_dataset

    kw = dict(task="logistic", n_users=4, rows_per_user=8, fe_dim=4, re_dim=2)
    runs = {}
    for side in ("torch", "jax"):
        pkg = telemetry if side == "torch" else j_telemetry
        (executables.set_peaks if side == "torch" else xla.set_peaks)(1e12, 1e11)
        trace_out, tele_out = tmp_path / f"{side}.trace.jsonl", tmp_path / f"{side}.metrics.jsonl"
        pkg.configure(trace_out=str(trace_out))
        if side == "torch":
            data, _ = generate_game_dataset(device="cpu", **kw)
            GameEstimator(GameConfig(task="logistic", num_iterations=1, coordinates={
                "fixed": FixedEffectConfig(shard_name="global",
                                           optimizer=OptimizerConfig(max_iterations=3))})
            ).fit(data, device="cpu")
        else:
            data, _ = j_generate(**kw)
            JEstimator(JGameConfig(task="logistic", num_iterations=1, coordinates={
                "fixed": JFixed(shard_name="global", optimizer=JOpt(max_iterations=3))})
            ).fit(data)
        pkg.flush_metrics(str(tele_out))
        live = (RunReport if side == "torch" else JRunReport).from_live()
        du = live.device_utilization()
        assert du["flops_total"] > 0, side
        assert np.isfinite(du["mfu"]) and du["mfu"] > 0, side
        assert np.isfinite(du["bandwidth_utilization"]), side
        assert any("coordinate:fixed" in p["phase"] for p in du["phases"]), side
        runs[side] = du
        md_path = tmp_path / f"{side}.report.md"
        main = report_main if side == "torch" else j_report_main
        assert main(["--trace", str(trace_out), "--telemetry", str(tele_out),
                     "--out", str(md_path)]) == 0
        runs[side + "_md"] = md_path.read_text()
    assert runs["torch"]["compile_time_share"] is None
    assert runs["jax"]["compile_time_share"] is not None
    for side in ("torch", "jax"):
        md = runs[side + "_md"]
        assert "## Device utilization" in md and "- MFU: unknown" not in md
        assert "Top executables by cost" in md and "`fe_solve`" in md
    # the one named difference of structure: on the CPU the port compiles
    # nothing and counts its solvers' fetches as host_syncs, so it has no
    # "Fetch / compile accounting" rows
    named = "## Fetch / compile accounting"
    assert named in _sections(runs["jax_md"]) and named not in _sections(runs["torch_md"])
    assert {"## Device utilization", "## Hot executables"} <= set(_sections(runs["torch_md"]))
    assert _sections(runs["torch_md"]) == [s for s in _sections(runs["jax_md"]) if s != named]
    # the port's kernels appear beside its solve
    assert "`value_grad`" in runs["torch_md"] or "`csr_margins`" in runs["torch_md"]


# -- the kernels' build is the compile -----------------------------------------------


def test_compile_hook_counts_nvcc_builds(tmp_path, monkeypatch):
    """A build that runs ``nvcc`` counts one ``jit_compiles`` (and its
    seconds, histogram and a ``compile`` event); a reused library none."""
    from photon_ml_tpu_torch.kernels import build

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; '
                    "shift; done\nexit 0\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    assert telemetry.install_compile_hooks()
    with telemetry.span("host"):
        path = build.build()
        assert build.build() == path  # reused
    snap = telemetry.snapshot()
    assert snap["counters"]["jit_compiles"] == 1
    assert snap["counters"]["jit_compile_seconds"] >= 0
    assert snap["histograms"]["jit_compile_seconds"]["count"] == 1
    events = [e for e in telemetry.finished_spans("host")[0].events if e["name"] == "compile"]
    assert len(events) == 1
    assert os.path.exists(path)


# -- cli profile ---------------------------------------------------------------


def test_cli_profile_wraps_a_train_run(tmp_path):
    """``cli profile -- train ...`` writes a Chrome trace into
    ``--profile-dir`` beside the span trace, mirrors the spans as profiler
    ranges, and returns the wrapped command's exit code."""
    from photon_ml_tpu_torch.cli.__main__ import main as cli_main
    from photon_ml_tpu_torch.telemetry import trace as trace_mod

    rng = np.random.default_rng(7)
    lib = tmp_path / "train.libsvm"
    lines = []
    for _ in range(64):
        x = rng.normal(size=3)
        label = 1 if x.sum() + 0.1 * rng.normal() > 0 else 0
        lines.append(f"{label} " + " ".join(f"{j + 1}:{x[j]:.4f}" for j in range(3)))
    lib.write_text("\n".join(lines) + "\n")
    config = {"task": "logistic",
              "input": {"format": "libsvm", "paths": [str(lib)], "shard_name": "features"},
              "coordinates": {"fixed": {"type": "fixed_effect", "shard_name": "features",
                                        "optimizer": {"max_iterations": 3}}},
              "num_iterations": 1, "heartbeat": False}
    cfg_path = tmp_path / "t.json"
    cfg_path.write_text(json.dumps(config))
    prof_dir, trace_out = tmp_path / "prof", tmp_path / "run.trace.jsonl"
    rc = cli_main(["profile", "--profile-dir", str(prof_dir), "--", "train", "--config",
                   str(cfg_path), "--trace-out", str(trace_out), "--device", "cpu"])
    assert rc == 0
    captured = [os.path.join(r, f) for r, _d, files in os.walk(prof_dir) for f in files]
    assert captured, "profiler capture dir is empty"
    with open(captured[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "fit" in names  # a span mirrored as a profiler range
    assert trace_out.exists()
    assert trace_mod.TRACER._annotation_factory is None


def test_cli_profile_requires_wrapped_command(tmp_path):
    from photon_ml_tpu_torch.cli.profile import main as profile_main

    with pytest.raises(SystemExit):
        profile_main(["--profile-dir", str(tmp_path / "p")])


# -- the synthetic generators ---------------------------------------------------


@pytest.mark.parametrize("task,density,intercept", [("logistic", 1.0, False),
                                                    ("squared", 0.4, True),
                                                    ("poisson", 1.0, False),
                                                    ("smoothed_hinge", 0.7, False)])
def test_generate_glm_problem_matches_the_reference(task, density, intercept):
    from photon_ml_tpu.testing import generate_glm_problem as j_generate
    from photon_ml_tpu_torch.testing import generate_glm_problem

    kw = dict(task=task, n=60, d=5, density=density, intercept=intercept, seed=3)
    got, want = generate_glm_problem(device="cpu", **kw), j_generate(**kw)
    for field in ("X", "y", "w_true"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.batch.to_dense(), np.asarray(want.batch.dense_rows()))
    np.testing.assert_array_equal(got.batch.labels.numpy(), np.asarray(want.batch.labels))


@pytest.mark.parametrize("task", ["logistic", "squared"])
def test_generate_game_dataset_matches_the_reference(task):
    from photon_ml_tpu.testing import generate_game_dataset as j_generate
    from photon_ml_tpu_torch.testing import generate_game_dataset

    kw = dict(task=task, n_users=5, rows_per_user=4, fe_dim=3, re_dim=2, seed=9)
    (data, truth), (jdata, jtruth) = generate_game_dataset(device="cpu", **kw), j_generate(**kw)
    assert truth.keys() == jtruth.keys()
    for k in truth:
        np.testing.assert_array_equal(truth[k], jtruth[k])
    np.testing.assert_array_equal(data.response, np.asarray(jdata.response))
    for shard in ("global", "user"):
        np.testing.assert_array_equal(data.csr_batch(shard).to_dense(),
                                      np.asarray(jdata.feature_shards[shard].dense_rows()))


def test_generate_low_rank_game_dataset_matches_the_reference():
    from photon_ml_tpu.testing import generate_low_rank_game_dataset as j_generate
    from photon_ml_tpu_torch.testing import generate_low_rank_game_dataset

    kw = dict(n_users=6, rows_per_user=5, d=7, latent_dim=2, seed=4)
    (data, truth), (jdata, jtruth) = generate_low_rank_game_dataset(device="cpu", **kw), \
        j_generate(**kw)
    for k in truth:
        np.testing.assert_array_equal(truth[k], jtruth[k])
    np.testing.assert_array_equal(data.response, np.asarray(jdata.response))
    np.testing.assert_array_equal(data.csr_batch("feats").to_dense(),
                                  np.asarray(jdata.feature_shards["feats"].dense_rows()))


def test_write_libsvm_matches_the_reference(tmp_path):
    from photon_ml_tpu.testing import write_libsvm as j_write
    from photon_ml_tpu_torch.testing import write_libsvm

    rng = np.random.default_rng(1)
    X = rng.normal(size=(6, 4)) * (rng.random((6, 4)) < 0.6)
    y = (rng.random(6) < 0.5).astype(float)
    a, b = write_libsvm(str(tmp_path / "a.txt"), X, y), j_write(str(tmp_path / "b.txt"), X, y)
    assert open(a).read() == open(b).read()
