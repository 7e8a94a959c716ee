"""The port's streamed ingest (``photon_ml_tpu_torch/ingest``) against the
JAX package's (tests/test_ingest.py, case for case), on the CPU:

- the planner: deterministic, block-aligned, stable when the file list
  grows, its plans field for field the JAX planner's on the same files;
  ``plans_for_host`` as the reference;
- the streamed dataset bit for bit the port's in-core read (every shard's
  CSR and the column-major mirror of its ``CSRBatch`` too) and the JAX
  streamed dataset's arrays; the same through the pure-Python decode
  workers, through a buffer growth, and from a resumed stream;
- ``CSRBatch.from_device_csr`` on CPU tensors against ``from_coo`` at
  the layout's edge cases (the tile index itself is held against a plain
  construction in tests/test_torch_kernels.py);
- the spec's validation, the resident budget, the typed stall, decode
  errors, and transient reads retried (an ``io`` rule at the read seam
  ``ingest.decode.read``, as tests/test_ingest.py injects it);
- ``double_buffered``'s order, lookahead bound and error position;
- ``cli train`` with ``input.ingest``: bit for bit the port's in-core
  ``cli train``, and within the reference test's 1e-6 of the JAX fit.

No test depends on timing, or on telemetry another test left behind.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.data.avro import TRAINING_EXAMPLE_AVRO, write_avro
from photon_ml_tpu.ingest import (
    IngestSpec as JIngestSpec,
    plan_chunks as j_plan_chunks,
    plans_for_host as j_plans_for_host,
    read_game_dataset_streamed as j_read_streamed,
)
from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.data.avro import read_game_dataset_from_avro
from photon_ml_tpu_torch.ingest import (
    ChunkDecodeError,
    ChunkPlan,
    ChunkStream,
    IngestConfigError,
    IngestSpec,
    IngestStall,
    double_buffered,
    plan_chunks,
    plans_for_host,
    read_game_dataset_streamed,
)
from photon_ml_tpu_torch.ingest.pipeline import ChunkCSR
from photon_ml_tpu_torch.ops.csr import CSRBatch

CPU = "cpu"


@pytest.fixture(autouse=True)
def _port_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _write_shards(tmp_path, rng, n_rows=1200, n_files=2, d=40, k=5, block_records=128,
                  codec="deflate"):
    """TrainingExampleAvro files with ids, weights and offsets (the
    reference test's fixture)."""
    paths = []
    per = n_rows // n_files
    row = 0
    for s in range(n_files):
        rows = per if s < n_files - 1 else n_rows - per * (n_files - 1)

        def recs(rows=rows):
            nonlocal row
            for _ in range(rows):
                yield {
                    "uid": str(row),
                    "label": float(row % 2),
                    "features": [{"name": f"f{rng.integers(0, d)}", "term": "",
                                  "value": float(rng.normal())} for _ in range(k)],
                    "metadataMap": {"userId": str(row % 29)},
                    "weight": float(1.0 + (row % 3)),
                    "offset": float(row % 5) * 0.1,
                }
                row += 1

        p = str(tmp_path / f"shard-{s:02d}.avro")
        write_avro(p, TRAINING_EXAMPLE_AVRO, recs(), block_records=block_records, codec=codec)
        paths.append(p)
    return paths


def _assert_datasets_equal(ds_a, ds_b):
    """Port datasets, array for array: the row scalars, each shard's host
    COO and device batch (CSR, column-major mirror, row vectors), the id
    columns."""
    for leaf in ("response", "offset", "weight"):
        np.testing.assert_array_equal(getattr(ds_a, leaf), getattr(ds_b, leaf), err_msg=leaf)
    assert list(ds_a.feature_shards) == list(ds_b.feature_shards)
    for name in ds_b.feature_shards:
        a, b = ds_a.shard(name), ds_b.shard(name)
        assert a.num_features == b.num_features
        for leaf in ("values", "rows", "cols"):
            x, y = getattr(a, leaf), getattr(b, leaf)
            assert x.dtype == y.dtype, f"{name}.{leaf}"
            np.testing.assert_array_equal(x, y, err_msg=f"{name}.{leaf}")
        ba, bb = ds_a.csr_batch(name), ds_b.csr_batch(name)
        for leaf in ("row_ptr", "cols", "vals", "col_ptr", "csc_rows", "csc_vals", "labels",
                     "offsets", "weights"):
            x, y = getattr(ba, leaf), getattr(bb, leaf)
            assert x.dtype == y.dtype and torch.equal(x, y), f"{name}.{leaf}"
    assert set(ds_a.id_columns) == set(ds_b.id_columns)
    for c in ds_b.id_columns:
        np.testing.assert_array_equal(ds_a.id_columns[c].codes, ds_b.id_columns[c].codes)
        np.testing.assert_array_equal(ds_a.id_columns[c].vocab, ds_b.id_columns[c].vocab)


def _assert_matches_jax(ds_t, ds_j):
    """The port's streamed dataset against the JAX streamed dataset's arrays."""
    for leaf in ("response", "offset", "weight"):
        np.testing.assert_array_equal(getattr(ds_t, leaf), getattr(ds_j, leaf), err_msg=leaf)
    for name in ds_j.feature_shards:
        t, j = ds_t.shard(name), ds_j.shard(name)
        assert t.num_features == j.num_features
        np.testing.assert_array_equal(t.values, np.asarray(j.values))
        np.testing.assert_array_equal(t.rows, np.asarray(j.rows))
        np.testing.assert_array_equal(t.cols, np.asarray(j.cols))
    for c in ds_j.id_columns:
        np.testing.assert_array_equal(ds_t.id_columns[c].codes, ds_j.id_columns[c].codes)
        np.testing.assert_array_equal(ds_t.id_columns[c].vocab, ds_j.id_columns[c].vocab)


def _fields(plans):
    return [dataclasses.astuple(p) for p in plans]


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def test_planner_deterministic_and_block_aligned(tmp_path, rng):
    paths = _write_shards(tmp_path, rng, n_rows=900, n_files=2, block_records=100)
    metas, plans = plan_chunks(paths, chunk_rows=250)
    _, plans2 = plan_chunks(paths, chunk_rows=250)
    assert plans == plans2
    # field for field the JAX planner's plans and file metas
    j_metas, j_plans = j_plan_chunks(paths, chunk_rows=250)
    assert _fields(plans) == _fields(j_plans)
    assert [dataclasses.astuple(m) for m in metas] == [dataclasses.astuple(m) for m in j_metas]
    assert [p.index for p in plans] == list(range(len(plans)))
    assert sum(p.n_rows for p in plans) == 900
    off = 0
    for p in plans:
        assert p.row_start == off
        off += p.n_rows
    by_path = {}
    for p in plans:
        by_path.setdefault(p.path, []).append(p)
    for file_plans in by_path.values():
        for p in file_plans[:-1]:
            assert p.n_rows >= 250
    for meta in metas:
        file_plans = by_path[meta.path]
        assert file_plans[0].byte_start == meta.header_end
        for a, b in zip(file_plans, file_plans[1:]):
            assert a.byte_end == b.byte_start
        assert file_plans[-1].byte_end == meta.file_bytes


def test_planner_stable_when_shard_list_grows(tmp_path, rng):
    paths = _write_shards(tmp_path, rng, n_rows=900, n_files=2, block_records=100)
    _, plans_old = plan_chunks(paths, chunk_rows=250)
    (tmp_path / "delta").mkdir()
    delta = _write_shards(tmp_path / "delta", rng, n_rows=300, n_files=1, block_records=100)
    _, plans_new = plan_chunks(paths + delta, chunk_rows=250)
    assert _fields(plans_new) == _fields(j_plan_chunks(paths + delta, chunk_rows=250)[1])
    assert len(plans_new) > len(plans_old)
    assert plans_new[: len(plans_old)] == plans_old
    off = sum(p.n_rows for p in plans_old)
    for i, p in enumerate(plans_new[len(plans_old):]):
        assert p.index == len(plans_old) + i
        assert p.row_start == off
        off += p.n_rows
    for nproc in (2, 3):
        for pid in range(nproc):
            old_split = plans_for_host(plans_old, pid, nproc)
            new_split = [p for p in plans_for_host(plans_new, pid, nproc)
                         if p.index < len(plans_old)]
            assert new_split == old_split


def test_planner_rejects_corrupt_sync(tmp_path, rng):
    [path] = _write_shards(tmp_path, rng, n_rows=300, n_files=1)
    data = bytearray(open(path, "rb").read())
    data[-8] ^= 0xFF  # corrupt the final sync marker
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="sync marker"):
        plan_chunks([path], chunk_rows=100)


def test_plans_for_host_partitions_deterministically():
    plans = [ChunkPlan(index=i, path=f"f{i % 2}.avro", byte_start=0, byte_end=10, n_rows=5,
                       row_start=5 * i, n_blocks=1) for i in range(7)]
    split = [plans_for_host(plans, pid, 3) for pid in range(3)]
    assert sorted(p.index for host in split for p in host) == list(range(7))
    assert [p.index for p in split[0]] == [0, 3, 6]
    assert [p.index for p in split[1]] == [1, 4]
    assert [p.index for p in split[2]] == [2, 5]
    assert max(map(len, split)) - min(map(len, split)) <= 1
    survivors = [plans_for_host(plans, pid, 2) for pid in range(2)]
    assert sorted(p.index for host in survivors for p in host) == list(range(7))
    assert plans_for_host(plans, 0, 1) == plans
    for pid in range(3):
        assert ([p.index for p in split[pid]]
                == [p.index for p in j_plans_for_host(plans, pid, 3)])


def test_plans_for_host_validates_ids():
    with pytest.raises(ValueError, match="num_processes"):
        plans_for_host([], 0, 0)
    with pytest.raises(ValueError, match="out of range"):
        plans_for_host([], 2, 2)
    with pytest.raises(ValueError, match="out of range"):
        plans_for_host([], -1, 2)


# ---------------------------------------------------------------------------
# streamed dataset == in-core dataset, bit for bit
# ---------------------------------------------------------------------------


def test_streamed_dataset_matches_incore_exactly(tmp_path, rng):
    paths = _write_shards(tmp_path, rng, n_rows=1100, n_files=3)
    spec = dict(workers=2, chunk_rows=200, nnz_per_row_hint=8)
    ds_in, maps = read_game_dataset_from_avro(paths, id_columns=("userId",),
                                              return_index_maps=True, device=CPU)
    ds_st, maps_st = read_game_dataset_streamed(paths, id_columns=("userId",),
                                                spec=IngestSpec(**spec),
                                                return_index_maps=True, device=CPU)
    assert set(maps_st) == set(maps)
    assert all(maps_st[s].names == maps[s].names for s in maps)
    counters = telemetry.snapshot()["counters"]
    assert counters["ingest.native_decodes"] == counters["ingest.chunks"] > 1
    assert "ingest.python_decodes" not in counters
    _assert_datasets_equal(ds_st, ds_in)
    ds_j = j_read_streamed(paths, id_columns=("userId",), spec=JIngestSpec(**spec))
    _assert_matches_jax(ds_st, ds_j)


def test_streamed_dataset_with_two_shards_and_no_intercept(tmp_path, rng):
    """Two shards over the same bag and ``add_intercept=False`` (path 10's
    shape of input): still the in-core read, array for array."""
    paths = _write_shards(tmp_path, rng, n_rows=700, n_files=2, k=4)
    shards = {"global": ("features",), "other": ("features",)}
    ds_in = read_game_dataset_from_avro(paths, feature_shards=shards, id_columns=("userId",),
                                        add_intercept=False, device=CPU)
    ds_st = read_game_dataset_streamed(paths, feature_shards=shards, id_columns=("userId",),
                                       add_intercept=False,
                                       spec=IngestSpec(workers=3, chunk_rows=128,
                                                       nnz_per_row_hint=4),
                                       device=CPU)
    _assert_datasets_equal(ds_st, ds_in)


def test_python_fallback_pipeline_matches_and_degrades(tmp_path, rng, monkeypatch):
    paths = _write_shards(tmp_path, rng, n_rows=600, n_files=2)
    ds_native, maps = read_game_dataset_from_avro(paths, id_columns=("userId",),
                                                  return_index_maps=True, device=CPU)
    monkeypatch.setenv("PHOTON_NO_NATIVE", "1")
    spec = IngestSpec(workers=2, chunk_rows=150, nnz_per_row_hint=8)
    stream = ChunkStream(paths, index_maps=maps, id_columns=("userId",), spec=spec,
                         device=CPU)
    try:
        assert not stream.using_native_decoder
    finally:
        stream.close()
    telemetry.reset()  # the closed stream's workers may have decoded chunks
    ds_py = read_game_dataset_streamed(paths, index_maps=maps, id_columns=("userId",),
                                       spec=spec, device=CPU)
    _assert_datasets_equal(ds_py, ds_native)
    counters = telemetry.snapshot()["counters"]
    assert counters["ingest.python_decodes"] == counters["ingest.chunks"] > 1
    assert "ingest.native_decodes" not in counters


def test_buffer_growth_keeps_arrays_exact(tmp_path, rng):
    """A hopeless nonzero hint grows the slots (counted, and the staging
    gauge follows the ring), never corrupts or refuses the stream."""
    paths = _write_shards(tmp_path, rng, n_rows=500, n_files=1, k=7)
    ds_in, maps = read_game_dataset_from_avro(paths, id_columns=("userId",),
                                              return_index_maps=True, device=CPU)
    spec = IngestSpec(workers=2, chunk_rows=120, nnz_per_row_hint=1)
    with ChunkStream(paths, index_maps=maps, id_columns=("userId",), spec=spec,
                     device=CPU) as stream:
        chunks = list(stream)
        stats = stream.stats()
    assert stats.buffer_growths > 0 and len(chunks) == len(stream.plans)
    assert telemetry.peek_gauge("ingest.staging_bytes") == stream._ring.nbytes
    assert stats.staging_bytes == stream._ring.peak_bytes >= stream._ring.nbytes
    ds_st = read_game_dataset_streamed(paths, index_maps=maps, id_columns=("userId",),
                                       spec=spec, device=CPU)
    assert telemetry.snapshot()["counters"]["ingest.buffer_growths"] > 0
    _assert_datasets_equal(ds_st, ds_in)


def test_stream_resume_replays_suffix(tmp_path, rng):
    paths = _write_shards(tmp_path, rng, n_rows=800, n_files=2)
    _, maps = read_game_dataset_from_avro(paths, id_columns=("userId",),
                                          return_index_maps=True, device=CPU)
    spec = IngestSpec(workers=1, chunk_rows=150, nnz_per_row_hint=8)
    with ChunkStream(paths, index_maps=maps, id_columns=("userId",), spec=spec,
                     device=CPU) as full:
        chunks = list(full)
        vocab = full.id_vocabulary("userId")
    start = 3
    with ChunkStream(paths, index_maps=maps, id_columns=("userId",), spec=spec,
                     start_chunk=start, id_vocabularies={"userId": list(vocab)},
                     device=CPU) as resumed:
        tail = list(resumed)
    assert [c.index for c in tail] == [c.index for c in chunks[start:]]
    for a, b in zip(tail, chunks[start:]):
        assert a.row_start == b.row_start and a.rows == b.rows
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.id_codes["userId"], b.id_codes["userId"])
        for x, y in zip(a.batch[:3], b.batch[:3]):
            assert torch.equal(x, y)


def test_chunks_do_not_alias_the_recycled_staging_ring(tmp_path, rng):
    """On the CPU the uploader clones each slot: a two-slot ring recycled
    many times (four workers sharing it) leaves every chunk held by the
    consumer intact."""
    paths = _write_shards(tmp_path, rng, n_rows=1000, n_files=1, block_records=50)
    ds_in, maps = read_game_dataset_from_avro(paths, return_index_maps=True, device=CPU)
    with ChunkStream(paths, index_maps=maps, spec=IngestSpec(workers=4, chunk_rows=50,
                                                             nnz_per_row_hint=6,
                                                             ring_slots=2,
                                                             stall_timeout_s=60),
                     device=CPU) as stream:
        chunks = list(stream)
    assert stream._ring.capacity == 2 and len(chunks) == 20
    assert len(stream._threads) == 2 + 1  # no more decode workers than slots, and the uploader
    batch = ds_in.csr_batch("features")
    vals = torch.cat([c.batch.vals for c in chunks])
    cols = torch.cat([c.batch.cols for c in chunks])
    assert torch.equal(vals, batch.vals) and torch.equal(cols, batch.cols)


# ---------------------------------------------------------------------------
# the batch built from a CSR on its device
# ---------------------------------------------------------------------------


def _layout_case(name):
    """(rows, cols, n_rows, n_features) of an edge case, rows unsorted."""
    r = np.random.default_rng(7)
    if name == "empty shard":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 40, 6
    if name == "no rows":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 0, 3
    if name == "one column":
        rows = np.arange(0, 200, 2)[::-1]
        return rows, np.zeros_like(rows), 200, 4
    if name == "features without nonzeros":
        return r.integers(0, 90, 120), r.choice([1, 5, 9], 120), 90, 12
    return r.integers(0, 1000, 6000), r.integers(0, 50, 6000), 1000, 50  # repeated entries


LAYOUT_CASES = ["empty shard", "no rows", "one column", "features without nonzeros",
                "many entries"]


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_from_device_csr_matches_from_coo(case):
    """``from_coo`` (host COO, row-sorted there) and ``from_device_csr`` (the
    same nonzeros as a CSR tensor) give the same batch, whose mirror is the
    stable column order of the row-sorted nonzeros."""
    rows, cols, n, f = _layout_case(case)
    vals = np.random.default_rng(3).normal(size=len(rows))
    labels = np.random.default_rng(4).random(n)
    offsets = np.linspace(-1, 1, n)
    want = CSRBatch.from_coo(vals, rows, cols, labels, f, offsets=offsets, device=CPU,
                             refreshable=True)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order].astype(np.float32)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    got = CSRBatch.from_device_csr(torch.from_numpy(row_ptr), torch.from_numpy(cols),
                                   torch.from_numpy(vals), labels, f, offsets=offsets,
                                   refreshable=True)
    corder = np.argsort(cols, kind="stable")
    np.testing.assert_array_equal(got.col_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=f))]))
    np.testing.assert_array_equal(got.csc_rows.numpy(), rows[corder])
    np.testing.assert_array_equal(got.csc_vals.numpy(), vals[corder])
    np.testing.assert_array_equal(got.value_order.numpy(), corder)
    for leaf in ("row_ptr", "cols", "vals", "col_ptr", "csc_rows", "csc_vals", "labels",
                 "offsets", "weights", "value_order"):
        x, y = getattr(got, leaf), getattr(want, leaf)
        assert x.dtype == y.dtype and torch.equal(x, y), leaf
    assert got.tiles is None and got.num_features == f


def test_from_device_csr_refuses_bad_structure_and_int32_overflow(monkeypatch):
    from photon_ml_tpu_torch.ingest import assemble
    from photon_ml_tpu_torch.ops import csr as t_csr

    row_ptr = torch.tensor([0, 1, 3], dtype=torch.int32)
    cols = torch.tensor([0, 2, 1], dtype=torch.int32)
    vals = torch.ones(3)
    with pytest.raises(ValueError, match=r"feature indices must be in \[0, 2\)"):
        CSRBatch.from_device_csr(row_ptr, cols, vals, np.zeros(2), 2)
    with pytest.raises(ValueError, match="row_ptr must rise"):
        CSRBatch.from_device_csr(torch.tensor([0, 2, 1], dtype=torch.int32), cols, vals,
                                 np.zeros(2), 3)
    # capacity doubling may pass 2^31 before the data does: the refusal is
    # at the real count
    monkeypatch.setattr(t_csr, "_INT32_MAX", 2)
    with pytest.raises(ValueError, match="int32 index range"):
        CSRBatch.from_device_csr(row_ptr, cols, vals, np.zeros(2), 3)
    monkeypatch.setattr(assemble, "_INT32_MAX", 2)
    asm = assemble.ShardAssembler(3, 2, 8, torch.device(CPU))
    asm.add(ChunkCSR(row_ptr, cols, vals, 3), 0)
    assert asm._v.shape[0] == 8
    with pytest.raises(ValueError, match="int32 index range"):
        asm.finish(np.zeros(2), np.zeros(2), np.ones(2))


# ---------------------------------------------------------------------------
# spec validation, budget sizing, stall protocol, errors, retries
# ---------------------------------------------------------------------------


def test_ingest_spec_validation():
    with pytest.raises(IngestConfigError):
        IngestSpec(prefetch_depth=0)
    with pytest.raises(IngestConfigError):
        IngestSpec(chunk_rows=0)
    with pytest.raises(IngestConfigError):
        IngestSpec(resident_budget_mb=-1)
    with pytest.raises(IngestConfigError, match="unknown ingest config"):
        IngestSpec.from_config({"wrokers": 2})
    assert IngestSpec.from_config(True) == IngestSpec()
    assert IngestSpec.from_config({"workers": 3}).workers == 3
    # the same fields and defaults as the reference's spec
    assert ([(f.name, f.default) for f in dataclasses.fields(IngestSpec)]
            == [(f.name, f.default) for f in dataclasses.fields(JIngestSpec)])


def test_resident_budget_bounds_staging(tmp_path, rng):
    paths = _write_shards(tmp_path, rng, n_rows=900, n_files=1)
    _, maps = read_game_dataset_from_avro(paths, id_columns=("userId",),
                                          return_index_maps=True, device=CPU)
    budget_mb = 0.2
    with ChunkStream(paths, index_maps=maps,
                     spec=IngestSpec(workers=2, chunk_rows=200, nnz_per_row_hint=8,
                                     resident_budget_mb=budget_mb),
                     device=CPU) as stream:
        rows = sum(c.rows for c in stream)
        stats = stream.stats()
    assert rows == 900
    assert 2 <= stream._ring.capacity < 2 + 2 + 1  # shrunk below workers + depth + 1
    assert stats.staging_bytes <= budget_mb * 2**20
    # the budget and the gauge count each slot's decoder scratch
    assert stats.staging_bytes == stream._ring.nbytes == telemetry.peek_gauge(
        "ingest.staging_bytes")
    assert all(len(b.scratch) == 1 and b.scratch[0].cap == stream.rows_cap * 8 for b in stream._ring._all)
    assert all(b.nbytes > b.scratch[0].nbytes > 0 for b in stream._ring._all)
    with pytest.raises(IngestConfigError, match="staging slot"):
        ChunkStream(paths, index_maps=maps,
                    spec=IngestSpec(chunk_rows=400, nnz_per_row_hint=64,
                                    resident_budget_mb=0.05),
                    device=CPU)


def test_backpressure_bounds_queue_and_stall_is_typed(tmp_path, rng):
    """Never consumed, decode and upload fill the bounded queue and ring;
    a stage's wait then ends in a typed stall (the decode workers' or the
    uploader's, whichever times out first), which the next read raises (no
    hang)."""
    paths = _write_shards(tmp_path, rng, n_rows=1000, n_files=1)
    _, maps = read_game_dataset_from_avro(paths, id_columns=("userId",),
                                          return_index_maps=True, device=CPU)
    stream = ChunkStream(paths, index_maps=maps,
                         spec=IngestSpec(workers=1, chunk_rows=100, prefetch_depth=1,
                                         nnz_per_row_hint=8, stall_timeout_s=0.3),
                         device=CPU)
    try:
        assert stream._stop.wait(120)  # a stage's wait ended the pipeline
        assert stream._out.qsize() == 1  # bounded by prefetch_depth
        assert telemetry.snapshot()["counters"]["ingest.stalls"] >= 1
        with pytest.raises(IngestStall, match="after 0.3s"):
            next(stream)
    finally:
        stream.close()


def test_decode_error_names_file_and_chunk(tmp_path, rng):
    [path] = _write_shards(tmp_path, rng, n_rows=200, n_files=1)
    _, maps = read_game_dataset_from_avro(path, id_columns=("userId",),
                                          return_index_maps=True, device=CPU)
    with pytest.raises(ChunkDecodeError, match=r"shard-00.avro \(chunk 0\).*memberId"):
        read_game_dataset_streamed([path], index_maps=maps, id_columns=("memberId",),
                                   spec=IngestSpec(workers=1, chunk_rows=100,
                                                   nnz_per_row_hint=8),
                                   device=CPU)


def test_transient_read_failure_is_retried_not_fatal(tmp_path, rng):
    """A flaky read of one chunk's byte range (an ``io`` rule at the real
    read seam, ``ingest.decode.read``) is retried: the dataset comes out bit
    for bit, and the absorbed flake is counted."""
    paths = _write_shards(tmp_path, rng, n_rows=400, n_files=1)
    ds_ref, maps = read_game_dataset_from_avro(paths[0], id_columns=("userId",),
                                               return_index_maps=True, device=CPU)
    spec = IngestSpec(workers=1, chunk_rows=100, nnz_per_row_hint=8, read_retries=2,
                      retry_backoff_s=0.0)
    telemetry.reset()
    try:
        faults.install_plan(faults.FaultPlan([
            faults.FaultRule("ingest.decode.read", action="io", nth=2)]))
        ds = read_game_dataset_streamed(paths, index_maps=maps, id_columns=("userId",),
                                        spec=spec, device=CPU)
        _assert_datasets_equal(ds, ds_ref)
        counters = telemetry.snapshot()["counters"]
        assert counters["ingest.read_retries"] == 1
        assert counters["faults.injected"] == 1
    finally:
        faults.clear_plan()
        telemetry.reset()

    # the absorbed flake is on the stream's own stats too
    try:
        faults.install_plan(faults.FaultPlan([
            faults.FaultRule("ingest.decode.read", action="io", nth=1)]))
        stream = ChunkStream(paths, index_maps=maps, id_columns=("userId",), spec=spec,
                             device=CPU)
        for _ in stream:
            pass
        assert stream.stats().read_retries == 1
    finally:
        faults.clear_plan()
        telemetry.reset()


def test_read_retries_exhausted_propagates_and_deterministic_skips_retry(tmp_path, rng):
    """A read that fails at every attempt propagates after the retry budget;
    a deterministic ``ChunkDecodeError`` never takes a retry."""
    paths = _write_shards(tmp_path, rng, n_rows=200, n_files=1)
    _, maps = read_game_dataset_from_avro(paths[0], id_columns=("userId",),
                                          return_index_maps=True, device=CPU)
    spec = IngestSpec(workers=1, chunk_rows=100, nnz_per_row_hint=8, read_retries=1,
                      retry_backoff_s=0.0)
    telemetry.reset()
    try:
        faults.install_plan(faults.FaultPlan([
            faults.FaultRule("ingest.decode.read", action="io", probability=1.0)]))
        with pytest.raises(OSError, match="ingest.decode.read"):
            list(ChunkStream(paths, index_maps=maps, id_columns=("userId",), spec=spec,
                             device=CPU))
        # attempts = retries + 1 per chunk; only the retry is counted
        counters = telemetry.snapshot()["counters"]
        assert counters["ingest.read_retries"] >= 1
        assert counters["faults.injected.ingest.decode.read"] >= 2
    finally:
        faults.clear_plan()
    telemetry.reset()
    with pytest.raises(ChunkDecodeError):
        read_game_dataset_streamed(paths, index_maps=maps, id_columns=("memberId",),
                                   spec=spec, device=CPU)
    assert telemetry.snapshot()["counters"].get("ingest.read_retries") is None


# ---------------------------------------------------------------------------
# double_buffered (the game/streaming feeding facility)
# ---------------------------------------------------------------------------


def test_double_buffered_preserves_order_and_items():
    items = list(range(12))
    assert list(double_buffered(items, lambda x: x * 10, depth=3)) == [(x, x * 10)
                                                                       for x in items]


def test_double_buffered_bounded_lookahead():
    """Whenever item x is fed, at most ``depth`` fed items wait in the
    queue and one more has been taken by the consumer but not yet counted:
    x <= consumed + depth + 1, whatever the threads' timing."""
    depth, consumed, worst = 2, [0], [0]

    def feed(x):
        worst[0] = max(worst[0], x - consumed[0])
        return x

    gen = double_buffered(range(100), feed, depth=depth)
    for item, fed in gen:
        assert item == fed
        consumed[0] += 1
    assert consumed[0] == 100
    assert worst[0] <= depth + 1


def test_double_buffered_propagates_feed_errors():
    def feed(x):
        if x == 3:
            raise RuntimeError("boom at 3")
        return x

    got = []
    with pytest.raises(RuntimeError, match="boom at 3"):
        for item, _fed in double_buffered(range(6), feed, depth=1):
            got.append(item)
    assert got == [0, 1, 2]


# ---------------------------------------------------------------------------
# the out-of-core acceptance path: `cli train` from the files
# ---------------------------------------------------------------------------


def test_out_of_core_cli_train_matches_incore_fit(tmp_path, rng):
    """``cli train`` through the ingest (a file set larger than the staging
    budget) is bit for bit the port's in-core ``cli train`` (the same
    arrays, so the same solves), and within the reference test's 1e-6 of
    the JAX package's ``cli train`` best metric."""
    from photon_ml_tpu.cli.train import run as j_run
    from photon_ml_tpu_torch.cli.train import run
    from photon_ml_tpu_torch.data.model_store import load_game_model

    data_dir = tmp_path / "train"
    data_dir.mkdir()
    paths = _write_shards(data_dir, rng, n_rows=4000, n_files=3, d=30, k=6, codec="null")
    total_bytes = sum(os.path.getsize(p) for p in paths)
    budget_mb = 0.35
    base = {
        "task": "logistic",
        "input": {"format": "avro", "paths": [str(data_dir)], "id_columns": ["userId"]},
        "coordinates": {"fixed": {"type": "fixed_effect", "shard_name": "features",
                                  "optimizer": {"regularization": "l2",
                                                "regularization_weight": 1.0}}},
        "num_iterations": 1,
        "evaluators": ["auc"],
        "heartbeat": False,
        "validation": {"paths": [str(data_dir)]},
    }
    s_in = run({**base, "output_dir": str(tmp_path / "in")}, device=CPU)
    ooc = {**base, "output_dir": str(tmp_path / "ooc"), "input": {
        **base["input"], "ingest": {"workers": 2, "chunk_rows": 250, "nnz_per_row_hint": 8,
                                    "resident_budget_mb": budget_mb}}}
    telemetry.reset()
    s_st = run(ooc, device=CPU)
    assert total_bytes > budget_mb * 2**20
    staging = telemetry.peek_gauge("ingest.staging_bytes")
    assert staging is not None and staging <= budget_mb * 2**20
    assert s_in["best_metric"] is not None
    assert s_st["best_metric"] == s_in["best_metric"]
    for sub in ("final", "best"):
        a = load_game_model(str(tmp_path / "in" / sub), device=CPU)
        b = load_game_model(str(tmp_path / "ooc" / sub), device=CPU)
        assert torch.equal(a.models["fixed"].coefficients, b.models["fixed"].coefficients)
    s_j = j_run(dict(base))
    assert s_st["best_metric"] == pytest.approx(s_j["best_metric"], abs=1e-6)


def test_cli_ingest_flags_set_the_ingest_config(tmp_path, rng, capsys):
    """``--ingest-workers`` and ``--prefetch-depth`` turn the streamed ingest
    on (``input.ingest``) and train as the in-core driver does."""
    import json

    from photon_ml_tpu_torch.cli import train as t_train

    data_dir = tmp_path / "train"
    data_dir.mkdir()
    _write_shards(data_dir, rng, n_rows=600, n_files=2, codec="null")
    cfg = {"task": "logistic",
           "input": {"format": "avro", "paths": [str(data_dir)], "id_columns": ["userId"]},
           "coordinates": {"fixed": {"type": "fixed_effect", "shard_name": "features",
                                     "optimizer": {"regularization": "l2",
                                                   "regularization_weight": 1.0}}},
           "num_iterations": 1, "heartbeat": False}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    summaries = []
    for flags, out in (([], "in"), (["--ingest-workers", "2", "--prefetch-depth", "1"], "st")):
        telemetry.reset()
        assert t_train.main(["--config", str(path), "--device", "cpu", "--output-dir",
                             str(tmp_path / out), *flags]) == 0
        summaries.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
        counters = telemetry.snapshot()["counters"]
        assert ("ingest.chunks" in counters) == bool(flags)
    # the same fit (each step's wall seconds aside)
    assert ([{k: v for k, v in e.items() if k != "seconds"} for e in summaries[0]["history"]]
            == [{k: v for k, v in e.items() if k != "seconds"} for e in summaries[1]["history"]])
    with pytest.raises(SystemExit):
        t_train.main(["--help"])
    usage = capsys.readouterr().out
    assert "--ingest-workers" in usage and "--prefetch-depth" in usage
