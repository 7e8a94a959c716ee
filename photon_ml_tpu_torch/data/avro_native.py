"""The native Avro decoder and encoder: schema -> program compiler and the
ctypes driver.

Counterpart of ``photon_ml_tpu/data/avro_native.py``, whose host-side code
this is. ``read_game_arrays_native`` is the fast path behind
``data/avro.py``'s ``read_game_dataset_from_avro``: it compiles the record
schema into a compact i32 program (opcodes mirrored in
``native/avro_decode.cpp``), hands the container's blocks to the C++
interpreter, which decodes them block-parallel on ``threads`` host threads
(``PHOTON_AVRO_THREADS`` overrides), and gets back columnar numpy arrays:
labels, offsets and weights, per-shard COO triples, interned id columns.
``_merge_parts`` joins the files in file order (each file's rows in block
order). ``write_training_blocks_native`` appends TrainingExampleAvro blocks
through ``native/avro_encode.cpp``.

The library is the port's own ``build/native/libphoton_avro.so``
(``data/native.py``'s ``load_avro_native``). Every function returns None
when the library is unavailable or the schema unsupported, and the caller
keeps its pure-Python path.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.data.native import load_avro_native

# opcodes — keep in sync with native/avro_decode.cpp
OP_SKIP_LONG = 1
OP_SKIP_FLOAT = 2
OP_SKIP_DOUBLE = 3
OP_SKIP_BYTES = 4
OP_SKIP_BOOL = 5
OP_SKIP_FIXED = 6
OP_SCALAR_D = 7
OP_SCALAR_F = 8
OP_SCALAR_L = 9
OP_SCALAR_B = 10
OP_UNION = 11
OP_FEATURE_BAG = 12
OP_FNAME = 13
OP_FTERM = 14
OP_FVALUE_D = 15
OP_FVALUE_F = 16
OP_ID_FIELD = 17
OP_ID_MAP = 18
OP_ARRAY_SKIP = 19
OP_MAP_SKIP = 20

_DEST = {"label": 0, "offset": 1, "weight": 2}


class _Unsupported(Exception):
    pass


def _resolve(schema, named):
    if isinstance(schema, str) and schema in named:
        return named[schema]
    return schema


def _skip_ops(schema, named) -> list[int]:
    """Program that SKIPS one value of ``schema``."""
    schema = _resolve(schema, named)
    if isinstance(schema, str):
        return {
            "null": [],
            "boolean": [OP_SKIP_BOOL],
            "int": [OP_SKIP_LONG],
            "long": [OP_SKIP_LONG],
            "float": [OP_SKIP_FLOAT],
            "double": [OP_SKIP_DOUBLE],
            "string": [OP_SKIP_BYTES],
            "bytes": [OP_SKIP_BYTES],
        }[schema]
    if isinstance(schema, list):
        branches = [_skip_ops(s, named) for s in schema]
        out = [OP_UNION, len(branches)] + [len(b) for b in branches]
        for b in branches:
            out.extend(b)
        return out
    t = schema["type"]
    if t == "record":
        out = []
        for f in schema["fields"]:
            out.extend(_skip_ops(f["type"], named))
        return out
    if t == "array":
        item = _skip_ops(schema["items"], named)
        return [OP_ARRAY_SKIP, len(item)] + item
    if t == "map":
        val = _skip_ops(schema["values"], named)
        return [OP_MAP_SKIP, len(val)] + val
    if t == "enum":
        return [OP_SKIP_LONG]
    if t == "fixed":
        return [OP_SKIP_FIXED, int(schema["size"])]
    if isinstance(t, (str, dict, list)):
        return _skip_ops(t, named)
    raise _Unsupported(f"skip {schema}")


def _scalar_ops(schema, named, op_by_type: dict) -> list[int]:
    """Program reading one numeric/union-null scalar into a channel."""
    schema = _resolve(schema, named)
    if isinstance(schema, str):
        if schema not in op_by_type:
            raise _Unsupported(f"scalar type {schema}")
        return list(op_by_type[schema])
    if isinstance(schema, list):
        branches = [_scalar_ops(s, named, op_by_type) for s in schema]
        out = [OP_UNION, len(branches)] + [len(b) for b in branches]
        for b in branches:
            out.extend(b)
        return out
    raise _Unsupported(f"scalar {schema}")


def _feature_item_ops(schema, named) -> list[int]:
    """Program for one feature-bag item (name/term/value record)."""
    schema = _resolve(schema, named)
    if not (isinstance(schema, dict) and schema.get("type") == "record"):
        raise _Unsupported("feature item is not a record")
    out = []
    seen_name = seen_value = False
    for f in schema["fields"]:
        ft = _resolve(f["type"], named)
        if f["name"] == "name" and ft == "string":
            out.append(OP_FNAME)
            seen_name = True
        elif f["name"] == "term":
            if ft != "string":
                # skipping a mistyped term would silently collapse distinct
                # name+term keys into one feature — refuse, fall back
                raise _Unsupported("feature term is not a plain string")
            out.append(OP_FTERM)
        elif f["name"] == "value" and ft in ("double", "float"):
            out.append(OP_FVALUE_D if ft == "double" else OP_FVALUE_F)
            seen_value = True
        else:
            out.extend(_skip_ops(f["type"], named))
    if not (seen_name and seen_value):
        raise _Unsupported("feature item lacks name/value")
    return out


def compile_program(
    schema: dict,
    feature_shards: Mapping[str, Sequence[str]],
    id_columns: Sequence[str],
) -> Optional[np.ndarray]:
    """Schema -> i32 program, or None if the shape is unsupported."""
    named: dict = {}

    def collect(s):
        if isinstance(s, dict):
            t = s.get("type")
            if t in ("record", "enum", "fixed") and "name" in s:
                named[s["name"]] = s
            if t == "record":
                for f in s["fields"]:
                    collect(f["type"])
            elif t == "array":
                collect(s["items"])
            elif t == "map":
                collect(s["values"])
        elif isinstance(s, list):
            for x in s:
                collect(x)

    collect(schema)
    bag_to_shard = {}
    for si, (_, bags) in enumerate(feature_shards.items()):
        for b in bags:
            if b in bag_to_shard:
                # one bag feeding MULTIPLE shards is legal (shard merging);
                # the program format emits a bag into one shard only, so
                # fall back to the pure-Python reader
                return None
            bag_to_shard[b] = si
    id_pos = {c: i for i, c in enumerate(id_columns)}

    scal = {
        "double": [OP_SCALAR_D],
        "float": [OP_SCALAR_F],
        "int": [OP_SCALAR_L],
        "long": [OP_SCALAR_L],
        "boolean": [OP_SCALAR_B],
        "null": [],
    }
    try:
        if not (isinstance(schema, dict) and schema.get("type") == "record"):
            raise _Unsupported("top level is not a record")
        out: list[int] = []
        for f in schema["fields"]:
            name = f["name"]
            ft = _resolve(f["type"], named)
            if name in _DEST:
                dest = _DEST[name]
                ops = _scalar_ops(
                    f["type"], named,
                    {k: (v + [dest] if v else v) for k, v in scal.items()},
                )
                out.extend(ops)
            elif name in bag_to_shard:
                if not (isinstance(ft, dict) and ft.get("type") == "array"):
                    raise _Unsupported(f"feature bag '{name}' is not an array")
                item = _feature_item_ops(ft["items"], named)
                out.extend(
                    [OP_FEATURE_BAG, bag_to_shard[name], len(item)] + item
                )
            elif name in id_pos:
                ops = None
                if ft == "string":
                    ops = [OP_ID_FIELD, id_pos[name]]
                elif isinstance(ft, list):
                    branches = []
                    for s in ft:
                        s_r = _resolve(s, named)
                        if s_r == "string":
                            branches.append([OP_ID_FIELD, id_pos[name]])
                        elif s_r == "null":
                            branches.append([])
                        else:
                            raise _Unsupported("id field union branch")
                    ops = [OP_UNION, len(branches)] + [
                        len(b) for b in branches
                    ]
                    for b in branches:
                        ops.extend(b)
                else:
                    raise _Unsupported("id field is not a string")
                out.extend(ops)
            elif name == "metadataMap":
                mt = ft
                if isinstance(mt, list):  # union-null metadataMap
                    branches = []
                    for s in mt:
                        s_r = _resolve(s, named)
                        if s_r == "null":
                            branches.append([])
                        elif (
                            isinstance(s_r, dict)
                            and s_r.get("type") == "map"
                            and _resolve(s_r["values"], named) == "string"
                        ):
                            branches.append([OP_ID_MAP])
                        else:
                            raise _Unsupported("metadataMap union branch")
                    out.extend(
                        [OP_UNION, len(branches)]
                        + [len(b) for b in branches]
                    )
                    for b in branches:
                        out.extend(b)
                elif (
                    isinstance(mt, dict)
                    and mt.get("type") == "map"
                    and _resolve(mt["values"], named) == "string"
                ):
                    out.append(OP_ID_MAP)
                else:
                    raise _Unsupported("metadataMap shape")
            else:
                out.extend(_skip_ops(f["type"], named))
        return np.asarray(out, np.int32)
    except (_Unsupported, KeyError):
        return None


def _concat_strs(strs: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    enc = [s.encode("utf-8") for s in strs]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offs[1:])
    blob = np.frombuffer(b"".join(enc), np.uint8).copy() if enc else np.zeros(
        0, np.uint8
    )
    return blob, offs


def index_map_blobs(
    shard_names: Sequence[str],
    index_maps: Optional[Mapping[str, Mapping[str, int]]],
):
    """Index maps -> the flat (feat_bytes, feat_offs, feat_ids,
    shard_key_counts) arrays ``avro_parse`` consumes, or None when a map
    is duck-typed (no ``.keys()``; the pure-Python reader handles those).
    The reference's ingest pipeline shares it with the one-shot reader
    below."""
    if index_maps is None:
        return (
            np.zeros(0, np.uint8),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.full(len(shard_names), -1, np.int64),
        )
    key_blobs, key_offs, key_ids, key_counts = [], [], [], []
    byte_base = 0
    for s in shard_names:
        imap = index_maps[s]
        try:
            keys = list(imap.keys())
        except (AttributeError, TypeError):
            # duck-typed maps (e.g. MmapIndexMap) expose only get/len
            return None
        blob, offs = _concat_strs(keys)
        key_blobs.append(blob)
        # offsets address the CONCATENATED byte blob across shards
        key_offs.append(offs + byte_base)
        byte_base += len(blob)
        key_ids.append(np.asarray([imap[k] for k in keys], np.int64))
        key_counts.append(len(keys))
    feat_bytes = np.concatenate(key_blobs) if key_blobs else np.zeros(
        0, np.uint8
    )
    # per-shard offset runs are stored contiguously incl. +1 slots
    feat_offs = np.concatenate(key_offs)
    feat_ids = np.concatenate(key_ids) if key_ids else np.zeros(0, np.int64)
    return feat_bytes, feat_offs, feat_ids, np.asarray(key_counts, np.int64)


_proto_ready = False


def _lib():
    global _proto_ready
    lib = load_avro_native()
    if lib is None or not hasattr(lib, "avro_parse"):
        return None
    if not _proto_ready:
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.avro_parse.restype = ctypes.c_void_p
        lib.avro_parse.argtypes = [
            u8, ctypes.c_int64, ctypes.c_int64, u8, ctypes.c_int32,
            i32, ctypes.c_int64, ctypes.c_int32,
            u8, i64, i64, i64,
            ctypes.c_int32, u8, i64, ctypes.c_int32,
        ]
        lib.avro_last_error.restype = ctypes.c_char_p
        lib.avro_rows.restype = ctypes.c_int64
        lib.avro_rows.argtypes = [ctypes.c_void_p]
        lib.avro_fill_scalars.argtypes = [ctypes.c_void_p, f64, f64, f64, u8]
        lib.avro_shard_nnz.restype = ctypes.c_int64
        lib.avro_shard_nnz.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.avro_fill_coo.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, f64, i64, i64,
        ]
        for fn in ("avro_shard_vocab_size", "avro_shard_vocab_bytes"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.avro_fill_shard_vocab.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, u8, i64,
        ]
        for fn in ("avro_id_vocab_size", "avro_id_vocab_bytes"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.avro_fill_ids.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i64, u8, i64,
        ]
        lib.avro_free.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "avro_write_training_blocks"):
            lib.avro_write_training_blocks.restype = ctypes.c_int64
            lib.avro_write_training_blocks.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, f64,
                ctypes.c_int32, i64, i32, f64, u8, i64,
                ctypes.c_int32, u8, i64, i64, u8, i64, i64,
                ctypes.c_int64, u8,
            ]
            lib.avro_encode_last_error.restype = ctypes.c_char_p
        _proto_ready = True
    return lib


def write_training_blocks_native(
    path: str,
    labels: np.ndarray,
    bags: Sequence[tuple[np.ndarray, np.ndarray, np.ndarray]],
    feature_names: Sequence[str],
    id_columns: Mapping[str, tuple[np.ndarray, Sequence[str]]],
    block_records: int,
    sync: bytes,
) -> Optional[int]:
    """Append TrainingExampleAvro-shaped record blocks via
    native/avro_encode.cpp; None when the native library is unavailable
    (caller falls back to the pure-Python writer). ``bags`` is the ordered
    feature arrays, each (starts[n+1], name_id, vals); ``id_columns`` maps
    metadataMap key -> (codes[n], vocab strings)."""
    lib = _lib()
    if lib is None or not hasattr(lib, "avro_write_training_blocks"):
        return None
    name_blob, name_offs = _concat_strs(list(feature_names))
    keys = list(id_columns)
    key_blob, key_offs = _concat_strs(keys)
    n = len(labels)
    # flatten bags: starts become absolute into the concatenated arrays
    starts_flat = np.empty(len(bags) * (n + 1), np.int64)
    nid_parts, val_parts = [], []
    base = 0
    for b, (starts, nid, vals) in enumerate(bags):
        starts_flat[b * (n + 1):(b + 1) * (n + 1)] = (
            np.asarray(starts, np.int64) + base
        )
        nid_parts.append(np.asarray(nid, np.int32))
        val_parts.append(np.asarray(vals, np.float64))
        base += len(nid_parts[-1])
    codes_flat = np.empty(len(keys) * n, np.int64)
    vocab_blobs, vocab_offs, vocab_counts = [], [], []
    byte_base = 0
    for ci, k in enumerate(keys):
        codes, vocab = id_columns[k]
        codes_flat[ci * n:(ci + 1) * n] = np.asarray(codes, np.int64)
        blob, offs = _concat_strs([str(v) for v in vocab])
        vocab_blobs.append(blob)
        vocab_offs.append(offs + byte_base)
        byte_base += len(blob)
        vocab_counts.append(len(vocab))
    rc = lib.avro_write_training_blocks(
        path.encode(), n,
        np.ascontiguousarray(labels, np.float64),
        len(bags), starts_flat,
        np.concatenate(nid_parts) if nid_parts else np.zeros(0, np.int32),
        np.concatenate(val_parts) if val_parts else np.zeros(0, np.float64),
        name_blob, name_offs,
        len(keys), key_blob, key_offs, codes_flat,
        np.concatenate(vocab_blobs) if vocab_blobs else np.zeros(0, np.uint8),
        np.concatenate(vocab_offs) if vocab_offs else np.zeros(0, np.int64),
        np.asarray(vocab_counts, np.int64),
        block_records, np.frombuffer(sync, np.uint8),
    )
    if rc < 0:
        raise ValueError(
            "native avro write failed: "
            + lib.avro_encode_last_error().decode()
        )
    return int(rc)


def _decode_vocab(blob: np.ndarray, offs: np.ndarray) -> np.ndarray:
    raw = blob.tobytes()
    # native '<U' dtype (NOT object): downstream np.savez of id vocabularies
    # must stay pickle-free
    return np.asarray(
        [raw[offs[i]:offs[i + 1]].decode("utf-8")
         for i in range(len(offs) - 1)]
    )


def read_game_arrays_native(
    paths: Sequence[str],
    feature_shards: Mapping[str, Sequence[str]],
    index_maps: Optional[Mapping[str, Mapping[str, int]]],
    id_columns: Sequence[str],
    threads: int = 0,
    vocab_only: bool = False,
):
    """Parse files into columnar arrays, or None if unsupported.

    Returns ``(labels, offsets, weights, coo_per_shard, id_cols,
    shard_vocabs, label_seen, file_rows)`` where ``coo_per_shard[shard] =
    (vals, rows, cols)``, ``id_cols[ci] = (codes, vocab)`` (dense interned
    codes + first-seen vocabulary — never materialized per-row strings),
    ``label_seen`` marks rows whose label field was PRESENT (a genuine
    NaN label stays distinguishable from absent), and ``file_rows[i]`` is
    the row count contributed by ``paths[i]`` (diagnostics map merged row
    indices back to a path + local record); with ``index_maps`` given,
    cols are final dense ids and unknown features are dropped; without,
    cols index ``shard_vocabs[shard]`` (first-seen interning order) for
    the caller to remap.

    ``threads``: parallel block-decode workers (0 = one per host core;
    env ``PHOTON_AVRO_THREADS`` overrides) — Avro blocks are
    sync-delimited and independent, so the file decodes block-parallel
    the way the reference decodes per-partition on executors
    (AvroDataReader.scala:87-237).
    """
    lib = _lib()
    if lib is None:
        return None
    if threads <= 0:
        threads = int(os.environ.get("PHOTON_AVRO_THREADS", "0") or 0)

    shard_names = list(feature_shards)
    blobs = index_map_blobs(shard_names, index_maps)
    if blobs is None:
        return None  # duck-typed maps: fall back to the Python reader
    feat_bytes, feat_offs, feat_ids, shard_key_counts = blobs

    id_blob, id_offs = _concat_strs(list(id_columns))

    all_parts = []
    from photon_ml_tpu_torch.data.avro import _MAGIC, _Reader, _decode

    prog_cache: dict[str, np.ndarray] = {}
    for path in paths:
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] != _MAGIC:
            return None
        data = np.frombuffer(raw, np.uint8)
        r = _Reader(raw)
        r.pos = 4
        meta = _decode(r, {"type": "map", "values": "bytes"}, {})
        schema_json = meta["avro.schema"].decode()
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            return None
        prog_f = prog_cache.get(schema_json)
        if prog_f is None:  # schemas may differ across daily files
            prog_f = compile_program(
                json.loads(schema_json), feature_shards, id_columns
            )
            if prog_f is None:
                return None
            prog_cache[schema_json] = prog_f
        sync = np.frombuffer(r.buf[r.pos:r.pos + 16], np.uint8).copy()
        block_start = r.pos + 16

        handle = lib.avro_parse(
            data, len(data), block_start, sync,
            1 if codec == "deflate" else 0,
            prog_f, len(prog_f), len(shard_names),
            feat_bytes, feat_offs, feat_ids, shard_key_counts,
            len(id_columns), id_blob, id_offs, threads,
        )
        if not handle:
            err = lib.avro_last_error().decode()
            raise ValueError(f"{path}: {err}")
        try:
            n = lib.avro_rows(handle)
            if vocab_only:
                # index-building wants only the interned key vocabularies:
                # skip the COO/scalar numpy materialization (the C-side
                # buffers are freed with the handle)
                labels = np.zeros(0, np.float64)
                offsets = weights = labels
                label_seen = np.zeros(0, np.uint8)
            else:
                labels = np.empty(n, np.float64)
                offsets = np.empty(n, np.float64)
                weights = np.empty(n, np.float64)
                label_seen = np.empty(n, np.uint8)
                lib.avro_fill_scalars(handle, labels, offsets, weights,
                                      label_seen)
            coo = []
            vocabs = []
            for si in range(len(shard_names)):
                if vocab_only:
                    coo.append((np.zeros(0), np.zeros(0, np.int64),
                                np.zeros(0, np.int64)))
                else:
                    nnz = lib.avro_shard_nnz(handle, si)
                    v = np.empty(nnz, np.float64)
                    rw = np.empty(nnz, np.int64)
                    cl = np.empty(nnz, np.int64)
                    lib.avro_fill_coo(handle, si, v, rw, cl)
                    coo.append((v, rw, cl))
                if index_maps is None:
                    nv = lib.avro_shard_vocab_size(handle, si)
                    nb = lib.avro_shard_vocab_bytes(handle, si)
                    blob = np.empty(nb, np.uint8)
                    offs = np.empty(nv + 1, np.int64)
                    lib.avro_fill_shard_vocab(handle, si, blob, offs)
                    vocabs.append(_decode_vocab(blob, offs))
                else:
                    vocabs.append(None)
            idvals = []
            for ci in range(len(id_columns)):
                codes = np.empty(n, np.int64)
                nb = lib.avro_id_vocab_bytes(handle, ci)
                nv = lib.avro_id_vocab_size(handle, ci)
                blob = np.empty(nb, np.uint8)
                offs = np.empty(nv + 1, np.int64)
                lib.avro_fill_ids(handle, ci, codes, blob, offs)
                if np.any(codes < 0):
                    bad = int(np.argmax(codes < 0))
                    raise KeyError(
                        f"{path}: record {bad} lacks id column "
                        f"'{id_columns[ci]}' (top-level field or "
                        "metadataMap entry)"
                    )
                idvals.append((codes, _decode_vocab(blob, offs)))
        finally:
            lib.avro_free(handle)
        all_parts.append(
            (labels, offsets, weights, coo, idvals, vocabs, label_seen)
        )

    return _merge_parts(all_parts, len(shard_names), len(id_columns))


def _merge_parts(parts, n_shards: int, n_ids: int):
    """Concatenate per-file results, re-basing row indices and re-mapping
    per-file intern vocabularies onto a merged first-seen vocabulary.
    Appends per-file row counts so callers can name the source file of a
    merged row in diagnostics."""
    file_rows = [len(p[0]) for p in parts]
    if len(parts) == 1:
        return (*parts[0], file_rows)
    labels = np.concatenate([p[0] for p in parts])
    label_seen = np.concatenate([p[6] for p in parts])
    offsets = np.concatenate([p[1] for p in parts])
    weights = np.concatenate([p[2] for p in parts])
    row_bases = np.cumsum([0] + [len(p[0]) for p in parts[:-1]])
    coo = []
    vocabs = []
    for si in range(n_shards):
        vals = np.concatenate([p[3][si][0] for p in parts])
        rows = np.concatenate(
            [p[3][si][1] + base for p, base in zip(parts, row_bases)]
        )
        if parts[0][5][si] is None:
            cols = np.concatenate([p[3][si][2] for p in parts])
            vocabs.append(None)
        else:
            merged: dict[str, int] = {}
            col_parts = []
            for p in parts:
                vocab = p[5][si]
                remap = np.empty(len(vocab), np.int64)
                for i, k in enumerate(vocab):
                    if k not in merged:
                        merged[k] = len(merged)
                    remap[i] = merged[k]
                col_parts.append(remap[p[3][si][2]])
            cols = np.concatenate(col_parts)
            vocabs.append(np.asarray(list(merged)))
        coo.append((vals, rows, cols))
    idvals = []
    for ci in range(n_ids):
        merged_ids: dict[str, int] = {}
        code_parts = []
        for p in parts:
            codes, vocab = p[4][ci]
            remap = np.empty(len(vocab), np.int64)
            for i, k in enumerate(vocab):
                if k not in merged_ids:
                    merged_ids[k] = len(merged_ids)
                remap[i] = merged_ids[k]
            code_parts.append(remap[codes] if len(codes) else codes)
        idvals.append(
            (np.concatenate(code_parts), np.asarray(list(merged_ids)))
        )
    return (
        labels, offsets, weights, coo, idvals, vocabs, label_seen, file_rows
    )
