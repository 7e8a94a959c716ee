"""Per-chunk block-range decoding into staging buffers.

Counterpart of ``photon_ml_tpu/ingest/decode.py``. One chunk is a run of
whole Avro blocks inside one file (``ChunkPlan``). The worker reads exactly
those bytes and decodes them with the native C++ interpreter
(``native/avro_decode.cpp`` through ``data/avro_native.py``), or with the
pure-Python schema walker when the native program cannot be built for the
schema (or ``PHOTON_NO_NATIVE=1``): both give the same arrays, and the
fallback is host code that stands in for no device work.

The decoder's float64/int64 COO goes into the slot's scratch
(``DecodeScratch``); each chunk counts ``ingest.native_decodes`` or
``ingest.python_decodes``. The finalize step writes it into the slot as the
chunk's CSR: values cast to float32, the columns, the row pointer, and one
intercept nonzero after each row's features (the in-core reader's sorted
interleave, ``data/avro.py`` ``_interleave_intercept_sorted``), so a
streamed dataset is byte for byte the in-core one.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, feature_key
from photon_ml_tpu_torch.ingest.buffers import DecodeScratch, ShardStage, StagingBuffer
from photon_ml_tpu_torch.ingest.errors import ChunkDecodeError
from photon_ml_tpu_torch.ingest.planner import ChunkPlan, FileMeta

_INT32_MAX = 2**31 - 1

#: called after a slot's scratch or shard stage grew, to account for it
GrewFn = Callable[[], None]


@dataclasses.dataclass
class DecodeContext:
    """Everything a decode worker needs, built once per stream.

    ``use_native`` is decided up front for the whole stream (native library
    present, every file's schema compiles to a program, index maps
    enumerable), so a chunk's decode does not branch."""

    metas: Mapping[str, FileMeta]
    shard_names: tuple[str, ...]
    feature_shards: Mapping[str, tuple[str, ...]]
    index_maps: Mapping[str, Mapping[str, int]]
    id_columns: tuple[str, ...]
    is_response_required: bool
    intercept_cols: tuple[int, ...]  # per shard; -1 = no intercept slot
    use_native: bool
    # native-path artifacts (None on the python path)
    programs: Optional[Mapping[str, np.ndarray]] = None  # path -> program
    feat_bytes: Optional[np.ndarray] = None
    feat_offs: Optional[np.ndarray] = None
    feat_ids: Optional[np.ndarray] = None
    shard_key_counts: Optional[np.ndarray] = None
    id_blob: Optional[np.ndarray] = None
    id_offs: Optional[np.ndarray] = None
    # python-path artifacts
    schemas: Optional[Mapping[str, dict]] = None  # path -> parsed schema
    named: Optional[Mapping[str, dict]] = None  # path -> named-type table


def build_decode_context(
    metas: Sequence[FileMeta],
    feature_shards: Mapping[str, Sequence[str]],
    index_maps: Mapping[str, Mapping[str, int]],
    id_columns: Sequence[str] = (),
    add_intercept: bool = True,
    is_response_required: bool = True,
) -> DecodeContext:
    from photon_ml_tpu_torch.data.avro_native import (
        _concat_strs,
        _lib,
        compile_program,
        index_map_blobs,
    )

    shard_names = tuple(feature_shards)
    feature_shards = {s: tuple(feature_shards[s]) for s in shard_names}
    intercept_cols = tuple(
        index_maps[s].get(INTERCEPT_KEY) if add_intercept else -1 for s in shard_names)
    ctx = DecodeContext(
        metas={m.path: m for m in metas},
        shard_names=shard_names,
        feature_shards=feature_shards,
        index_maps=dict(index_maps),
        id_columns=tuple(id_columns),
        is_response_required=bool(is_response_required),
        intercept_cols=intercept_cols,
        use_native=False,
    )

    lib = _lib()
    blobs = index_map_blobs(list(shard_names), index_maps) if lib else None
    programs: dict[str, np.ndarray] = {}
    if lib is not None and blobs is not None:
        prog_cache: dict[str, Optional[np.ndarray]] = {}
        for m in metas:
            prog = prog_cache.get(m.schema_json)
            if prog is None and m.schema_json not in prog_cache:
                prog = compile_program(json.loads(m.schema_json), feature_shards, id_columns)
                prog_cache[m.schema_json] = prog
            if prog is None:
                programs = {}
                break
            programs[m.path] = prog
    if programs:
        id_blob, id_offs = _concat_strs(list(id_columns))
        ctx.use_native = True
        ctx.programs = programs
        ctx.feat_bytes, ctx.feat_offs, ctx.feat_ids, ctx.shard_key_counts = blobs
        ctx.id_blob, ctx.id_offs = id_blob, id_offs
    else:
        from photon_ml_tpu_torch.data.avro import _collect_named

        schemas: dict[str, dict] = {}
        named: dict[str, dict] = {}
        for m in metas:
            schema = json.loads(m.schema_json)
            schemas[m.path] = schema
            table: dict = {}
            _collect_named(schema, table)
            named[m.path] = table
        ctx.schemas = schemas
        ctx.named = named
    return ctx


def read_range(plan: ChunkPlan) -> bytes:
    """The plan's byte range of its file (an ``OSError`` is a transient read
    failure the pipeline retries)."""
    with open(plan.path, "rb") as f:
        f.seek(plan.byte_start)
        raw = f.read(plan.nbytes)
    if len(raw) != plan.nbytes:
        raise ChunkDecodeError(plan.path, plan.index,
                               f"short read ({len(raw)}/{plan.nbytes} bytes) — file changed "
                               "since planning?")
    return raw


def scratch_count(ctx: DecodeContext) -> int:
    """Scratches a slot needs: the native path fills one shard at a time,
    the Python walker every shard at once."""
    return 1 if ctx.use_native else len(ctx.shard_names)


def decode_chunk(ctx: DecodeContext, plan: ChunkPlan, buf: StagingBuffer,
                 grew: GrewFn) -> None:
    """Decode ``plan``'s byte range into ``buf`` through its scratch."""
    raw = read_range(plan)
    if ctx.use_native:
        _decode_native(ctx, plan, raw, buf, grew)
        telemetry.counter("ingest.native_decodes").inc()
    else:
        _decode_python(ctx, plan, raw, buf, grew)
        telemetry.counter("ingest.python_decodes").inc()
    if ctx.is_response_required:
        missing = buf.label_seen[:plan.n_rows] == 0
        if np.any(missing):
            bad = int(np.argmax(missing))
            raise ChunkDecodeError(plan.path, plan.index,
                                   f"record {bad} of the chunk (global row "
                                   f"{plan.row_start + bad}) has no label")
    buf.plan = plan


# ---------------------------------------------------------------------------
# native path
# ---------------------------------------------------------------------------


def _decode_native(ctx: DecodeContext, plan: ChunkPlan, raw: bytes, buf: StagingBuffer,
                   grew: GrewFn) -> None:
    from photon_ml_tpu_torch.data.avro_native import _decode_vocab, _lib

    lib = _lib()
    meta = ctx.metas[plan.path]
    data = np.frombuffer(raw, np.uint8)
    sync = np.frombuffer(meta.sync, np.uint8)
    handle = lib.avro_parse(
        data, len(data), 0, sync, 1 if meta.codec == "deflate" else 0,
        ctx.programs[plan.path], len(ctx.programs[plan.path]), len(ctx.shard_names),
        ctx.feat_bytes, ctx.feat_offs, ctx.feat_ids, ctx.shard_key_counts,
        len(ctx.id_columns), ctx.id_blob, ctx.id_offs,
        1,  # parallelism lives across workers; one thread per chunk
    )
    if not handle:
        raise ChunkDecodeError(plan.path, plan.index, lib.avro_last_error().decode())
    try:
        n = int(lib.avro_rows(handle))
        if n != plan.n_rows:
            raise ChunkDecodeError(plan.path, plan.index,
                                   f"decoded {n} rows but the plan promised {plan.n_rows}")
        lib.avro_fill_scalars(handle, buf.labels, buf.offsets, buf.weights, buf.label_seen)
        # one shard at a time through the one scratch: fill, then finalize
        scratch = buf.scratch[0]
        for si in range(len(ctx.shard_names)):
            nnz = int(lib.avro_shard_nnz(handle, si))
            if scratch.ensure(nnz):
                grew()
            lib.avro_fill_coo(handle, si, scratch.vals[:nnz], scratch.rows[:nnz],
                              scratch.cols[:nnz])
            _finalize_shard(scratch, nnz, n, ctx.intercept_cols[si], buf, si, grew, plan)
        buf.id_vocabs = []
        for ci in range(len(ctx.id_columns)):
            codes = buf.id_codes[ci][:n]
            nb = lib.avro_id_vocab_bytes(handle, ci)
            nv = lib.avro_id_vocab_size(handle, ci)
            blob = np.empty(nb, np.uint8)
            offs = np.empty(nv + 1, np.int64)
            lib.avro_fill_ids(handle, ci, codes, blob, offs)
            if np.any(codes < 0):
                bad = int(np.argmax(codes < 0))
                raise ChunkDecodeError(plan.path, plan.index,
                                       f"record {bad} lacks id column '{ctx.id_columns[ci]}' "
                                       "(top-level field or metadataMap entry)")
            buf.id_vocabs.append(_decode_vocab(blob, offs))
    finally:
        lib.avro_free(handle)


# ---------------------------------------------------------------------------
# pure-python fallback path
# ---------------------------------------------------------------------------


def _decode_python(ctx: DecodeContext, plan: ChunkPlan, raw: bytes, buf: StagingBuffer,
                   grew: GrewFn) -> None:
    from photon_ml_tpu_torch.data.avro import _decode, _Reader

    meta = ctx.metas[plan.path]
    schema = ctx.schemas[plan.path]
    named = ctx.named[plan.path]
    imaps = [ctx.index_maps[s] for s in ctx.shard_names]
    bags = [ctx.feature_shards[s] for s in ctx.shard_names]

    cursors = [0] * len(ctx.shard_names)
    interns: list[dict] = [{} for _ in ctx.id_columns]
    row = 0
    r = _Reader(raw)
    while r.pos < len(raw):
        n_block = r.read_long()
        size = r.read_long()
        payload = r.read_fixed(size)
        if meta.codec == "deflate":
            payload = zlib.decompress(payload, -15)
        if r.read_fixed(16) != meta.sync:
            raise ChunkDecodeError(plan.path, plan.index, "sync marker mismatch (corrupt block)")
        br = _Reader(payload)
        for _ in range(n_block):
            if row >= plan.n_rows:
                raise ChunkDecodeError(plan.path, plan.index,
                                       f"more rows than the plan's {plan.n_rows}")
            rec = _decode(br, schema, named)
            label = rec.get("label")
            buf.label_seen[row] = 0 if label is None else 1
            buf.labels[row] = 0.0 if label is None else float(label)
            off = rec.get("offset")
            buf.offsets[row] = 0.0 if off is None else float(off)
            wgt = rec.get("weight")  # explicit 0.0 weights must survive
            buf.weights[row] = 1.0 if wgt is None else float(wgt)
            meta_map = rec.get("metadataMap") or {}
            for ci, c in enumerate(ctx.id_columns):
                v = rec.get(c)
                if v is None:  # absent/null top-level field -> metadataMap
                    v = meta_map.get(c)
                if v is None:
                    raise ChunkDecodeError(plan.path, plan.index,
                                           f"record {row} lacks id column '{c}' (top-level "
                                           "field or metadataMap entry)")
                table = interns[ci]
                code = table.get(v)
                if code is None:
                    code = len(table)
                    table[v] = code
                buf.id_codes[ci, row] = code
            for si, shard_bags in enumerate(bags):
                sc = buf.scratch[si]
                cur = cursors[si]
                imap = imaps[si]
                for bag in shard_bags:
                    for f in rec.get(bag) or ():
                        idx = imap.get(feature_key(f["name"], f["term"]))
                        if idx >= 0:
                            if cur >= sc.cap and sc.ensure(cur + 1, preserve=cur):
                                grew()
                            sc.vals[cur] = float(f["value"])
                            sc.rows[cur] = row
                            sc.cols[cur] = idx
                            cur += 1
                cursors[si] = cur
            row += 1
    if row != plan.n_rows:
        raise ChunkDecodeError(plan.path, plan.index,
                               f"decoded {row} rows but the plan promised {plan.n_rows}")
    for si, nnz in enumerate(cursors):
        _finalize_shard(buf.scratch[si], nnz, row, ctx.intercept_cols[si], buf, si, grew, plan)
    buf.id_vocabs = [np.asarray(list(table)) for table in interns]


# ---------------------------------------------------------------------------
# shared finalize: the chunk's CSR, with the intercept interleaved
# ---------------------------------------------------------------------------


def _finalize_shard(sc: DecodeScratch, nnz: int, n: int, icept: int, buf: StagingBuffer,
                    si: int, grew: GrewFn, plan: ChunkPlan) -> None:
    """Write ``nnz`` row-sorted scratch entries of ``n`` rows into slot
    shard ``si`` as CSR: values cast to float32 (as the in-core reader casts
    them) and, with an intercept column, one intercept nonzero right after
    each row's features, so the result stays row-sorted."""
    used = nnz + (n if icept >= 0 else 0)
    if used > _INT32_MAX:
        raise ChunkDecodeError(plan.path, plan.index,
                               f"{used} nonzeros in one chunk exceed the int32 index range")
    st: ShardStage = buf.shards[si]
    if st.grow(used):
        grew()
    vals, cols, row_ptr = st.values.numpy(), st.cols.numpy(), st.row_ptr.numpy()
    rws = sc.rows[:nnz]
    raw_ptr = np.searchsorted(rws, np.arange(n + 1), side="left")
    if icept >= 0:
        # each decoded nonzero shifts right by the intercepts placed before
        # it (its row index); row r's intercept lands after its features
        dest = np.arange(nnz) + rws
        vals[dest] = sc.vals[:nnz]
        cols[dest] = sc.cols[:nnz]
        idest = raw_ptr[1:] + np.arange(n)
        vals[idest] = 1.0
        cols[idest] = icept
        row_ptr[:n + 1] = raw_ptr + np.arange(n + 1)
    else:
        vals[:nnz] = sc.vals[:nnz]
        cols[:nnz] = sc.cols[:nnz]
        row_ptr[:n + 1] = raw_ptr
    st.nnz_used = used
