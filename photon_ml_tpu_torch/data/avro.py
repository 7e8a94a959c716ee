"""Avro in and out: a dependency-free Avro binary codec and the Photon wire
formats (TrainingExampleAvro, BayesianLinearModelAvro, ScoringResultAvro,
FeatureSummarizationResultAvro).

Counterpart of ``photon_ml_tpu/data/avro.py``, whose host-side code this is:
the object-container format (magic ``Obj\\x01``, a metadata map, a 16-byte
sync marker, then blocks of [count, byte size, payload, sync], codec null
or deflate) with zigzag varints; the schemas re-authored from the
reference's ``.avsc`` files; the readers and the writers. A file written by
either package reads the same in the other.

Reader semantics: features are (name, term, value) records keyed
name + '\\x01' + term; a feature shard merges one or more feature-bag
fields; each shard gets an intercept column; response, offset, weight and
the id columns come from top-level fields or the ``metadataMap``. The
native decoder (``data/avro_native.py``) reads when its library loads and
the schema compiles; the pure-Python decoder otherwise, with the same
result. The reader returns the port's ``GameDataset``: host-side
``FeatureShard`` COO in float32 and ``IdColumn``s with a sorted
vocabulary, solved on ``device`` (default cuda). Telemetry counts each
read as ``avro.native_reads`` or ``avro.python_reads``.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Iterable, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap, feature_key
from photon_ml_tpu_torch.game.dataset import (
    FeatureShard,
    GameDataset,
    IdColumn,
    build_game_dataset,
)

_MAGIC = b"Obj\x01"


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

# ---------------------------------------------------------------------------
# binary encoding primitives (Avro spec section "Binary Encoding")
# ---------------------------------------------------------------------------


def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _write_long(out: io.BytesIO, n: int) -> None:
    n = _zigzag_encode(n)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                return _zigzag_decode(acc)
            shift += 7

    def read_bytes(self) -> bytes:
        n = self.read_long()
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_fixed(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out


# ---------------------------------------------------------------------------
# schema-driven encode/decode (generic records as Python dicts)
# ---------------------------------------------------------------------------


def _encode(out: io.BytesIO, schema, value, named: dict) -> None:
    if isinstance(schema, str):
        t = schema
        if t in named:
            _encode(out, named[t], value, named)
        elif t == "null":
            pass
        elif t == "boolean":
            out.write(b"\x01" if value else b"\x00")
        elif t in ("int", "long"):
            _write_long(out, int(value))
        elif t == "float":
            out.write(struct.pack("<f", float(value)))
        elif t == "double":
            out.write(struct.pack("<d", float(value)))
        elif t == "string":
            raw = str(value).encode("utf-8")
            _write_long(out, len(raw))
            out.write(raw)
        elif t == "bytes":
            _write_long(out, len(value))
            out.write(value)
        else:
            raise ValueError(f"unknown schema type '{t}'")
    elif isinstance(schema, list):  # union: index + value
        idx = _union_branch(schema, value)
        _write_long(out, idx)
        _encode(out, schema[idx], value, named)
    else:
        t = schema["type"]
        if t == "record":
            for f in schema["fields"]:
                _encode(out, f["type"], value[f["name"]], named)
        elif t == "array":
            items = list(value)
            if items:
                _write_long(out, len(items))
                for it in items:
                    _encode(out, schema["items"], it, named)
            _write_long(out, 0)
        elif t == "map":
            entries = dict(value)
            if entries:
                _write_long(out, len(entries))
                for k, v in entries.items():
                    _encode(out, "string", k, named)
                    _encode(out, schema["values"], v, named)
            _write_long(out, 0)
        elif t == "enum":
            _write_long(out, schema["symbols"].index(value))
        elif t == "fixed":
            out.write(value)
        else:
            _encode(out, t, value, named)  # e.g. {"type": "string"}


def _union_branch(union: list, value) -> int:
    def kind(s):
        return s if isinstance(s, str) else s.get("type")

    if value is None:
        for i, s in enumerate(union):
            if kind(s) == "null":
                return i
        raise ValueError("union has no null branch for None value")
    for i, s in enumerate(union):
        if kind(s) != "null":
            return i
    raise ValueError("union has only null branches")


def _decode(r: _Reader, schema, named: dict):
    if isinstance(schema, str):
        t = schema
        if t in named:
            return _decode(r, named[t], named)
        if t == "null":
            return None
        if t == "boolean":
            return r.read_fixed(1) == b"\x01"
        if t in ("int", "long"):
            return r.read_long()
        if t == "float":
            return struct.unpack("<f", r.read_fixed(4))[0]
        if t == "double":
            return struct.unpack("<d", r.read_fixed(8))[0]
        if t == "string":
            return r.read_bytes().decode("utf-8")
        if t == "bytes":
            return r.read_bytes()
        raise ValueError(f"unknown schema type '{t}'")
    if isinstance(schema, list):
        return _decode(r, schema[r.read_long()], named)
    t = schema["type"]
    if t == "record":
        return {f["name"]: _decode(r, f["type"], named) for f in schema["fields"]}
    if t == "array":
        out = []
        while True:
            n = r.read_long()
            if n == 0:
                return out
            if n < 0:  # block with byte size prefix
                n = -n
                r.read_long()
            for _ in range(n):
                out.append(_decode(r, schema["items"], named))
    if t == "map":
        out = {}
        while True:
            n = r.read_long()
            if n == 0:
                return out
            if n < 0:
                n = -n
                r.read_long()
            for _ in range(n):
                k = r.read_bytes().decode("utf-8")
                out[k] = _decode(r, schema["values"], named)
    if t == "enum":
        return schema["symbols"][r.read_long()]
    if t == "fixed":
        return r.read_fixed(schema["size"])
    return _decode(r, t, named)


def _collect_named(schema, named: dict) -> None:
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed") and "name" in schema:
            named[schema["name"]] = schema
        if t == "record":
            for f in schema["fields"]:
                _collect_named(f["type"], named)
        elif t == "array":
            _collect_named(schema["items"], named)
        elif t == "map":
            _collect_named(schema["values"], named)
    elif isinstance(schema, list):
        for s in schema:
            _collect_named(s, named)


# ---------------------------------------------------------------------------
# object container files
# ---------------------------------------------------------------------------


def write_avro(
    path: str,
    schema: dict,
    records: Iterable[Mapping],
    codec: str = "deflate",
    block_records: int = 4096,
    sync: bytes = b"photon-ml-tpu-s!",
) -> int:
    """Write an Avro object-container file; returns the record count."""
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec '{codec}'")
    named: dict = {}
    _collect_named(schema, named)
    count_total = 0
    with open(path + ".tmp", "wb") as f:
        f.write(_MAGIC)
        meta = io.BytesIO()
        _encode(
            meta,
            {"type": "map", "values": "bytes"},
            {
                "avro.schema": json.dumps(schema).encode(),
                "avro.codec": codec.encode(),
            },
            {},
        )
        f.write(meta.getvalue())
        f.write(sync)

        block = io.BytesIO()
        n_in_block = 0

        def flush():
            nonlocal n_in_block
            if n_in_block == 0:
                return
            payload = block.getvalue()
            if codec == "deflate":
                payload = zlib.compress(payload)[2:-4]  # raw deflate
            head = io.BytesIO()
            _write_long(head, n_in_block)
            _write_long(head, len(payload))
            f.write(head.getvalue())
            f.write(payload)
            f.write(sync)
            block.seek(0)
            block.truncate()
            n_in_block = 0

        for rec in records:
            _encode(block, schema, rec, named)
            n_in_block += 1
            count_total += 1
            if n_in_block >= block_records:
                flush()
        flush()
    os.replace(path + ".tmp", path)
    return count_total


def training_example_schema(bag_names: "Sequence[str]" = ("features",)) -> dict:
    """TrainingExampleAvro generalized to several feature bags (the
    multi-shard featureShardContainer analog): one array<FeatureAvro>
    field per bag, in order, between label and metadataMap."""
    if tuple(bag_names) == ("features",):
        return TRAINING_EXAMPLE_AVRO
    fields = [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
    ]
    for i, b in enumerate(bag_names):
        item = FEATURE_AVRO if i == 0 else "FeatureAvro"
        fields.append({"name": b, "type": {"type": "array", "items": item}})
    fields += [
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ]
    return {
        "name": "TrainingExampleAvro", "type": "record", "fields": fields
    }


def write_training_examples_fast(
    path: str,
    labels: np.ndarray,
    bags: "Mapping[str, tuple[np.ndarray, np.ndarray, np.ndarray]]",
    feature_names: "Sequence[str]",
    id_columns: "Mapping[str, tuple[np.ndarray, Sequence[str]]]",
    block_records: int = 65536,
    sync: bytes = b"photon-ml-tpu-s!",
) -> int:
    """Columnar TrainingExampleAvro writer (~100x the per-record python
    path). ``bags`` maps feature-bag field name -> (starts[n+1], name_id,
    vals): row r of bag carries features name_id/vals[starts[r]:
    starts[r+1]] (term always ""); ``id_columns`` maps metadataMap key ->
    (codes, vocab). Python writes the container header (schema from
    :func:`training_example_schema`); native/avro_encode.cpp appends the
    record blocks (codec null). Falls back to the per-record python
    writer when the native library is unavailable."""
    from photon_ml_tpu_torch.data.avro_native import write_training_blocks_native

    schema = training_example_schema(list(bags))
    with open(path + ".tmp", "wb") as f:
        f.write(_MAGIC)
        meta = io.BytesIO()
        _encode(
            meta,
            {"type": "map", "values": "bytes"},
            {
                "avro.schema": json.dumps(schema).encode(),
                "avro.codec": b"null",
            },
            {},
        )
        f.write(meta.getvalue())
        f.write(sync)
    try:
        rc = write_training_blocks_native(
            path + ".tmp", labels, list(bags.values()), feature_names,
            id_columns, block_records, sync,
        )
    except Exception:
        os.remove(path + ".tmp")
        raise
    if rc is None:
        os.remove(path + ".tmp")  # header-only stub; fallback rewrites
        names = list(feature_names)
        id_items = [
            (k, np.asarray(codes), [str(v) for v in vocab])
            for k, (codes, vocab) in id_columns.items()
        ]

        def recs():
            for r in range(len(labels)):
                rec = {
                    "uid": None,
                    "label": float(labels[r]),
                    "metadataMap": {
                        k: vocab[int(codes[r])]
                        for k, codes, vocab in id_items
                    },
                    "weight": None,
                    "offset": None,
                }
                for bname, (starts, nid, vals) in bags.items():
                    lo, hi = int(starts[r]), int(starts[r + 1])
                    rec[bname] = [
                        {
                            "name": names[int(nid[k])],
                            "term": "",
                            "value": float(vals[k]),
                        }
                        for k in range(lo, hi)
                    ]
                yield rec

        return write_avro(
            path, schema, recs(), codec="null",
            block_records=block_records, sync=sync,
        )
    os.replace(path + ".tmp", path)
    return rc


def read_avro(path: str) -> Iterator[dict]:
    """Stream records from an Avro object-container file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path} is not an Avro container file")
    r = _Reader(data)
    r.pos = 4
    meta = _decode(r, {"type": "map", "values": "bytes"}, {})
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec '{codec}'")
    named: dict = {}
    _collect_named(schema, named)
    sync = r.read_fixed(16)
    while r.pos < len(data):
        n = r.read_long()
        size = r.read_long()
        payload = r.read_fixed(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        br = _Reader(payload)
        for _ in range(n):
            yield _decode(br, schema, named)
        if r.read_fixed(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch (corrupt block)")


# ---------------------------------------------------------------------------
# photon schemas (re-authored from photon-avro-schemas/src/main/avro/*.avsc)
# ---------------------------------------------------------------------------

FEATURE_AVRO = {
    "name": "FeatureAvro",
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE_AVRO = {
    "name": "TrainingExampleAvro",
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE_AVRO}},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}

NAME_TERM_VALUE_AVRO = {
    "name": "NameTermValueAvro",
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

BAYESIAN_LINEAR_MODEL_AVRO = {
    "name": "BayesianLinearModelAvro",
    "type": "record",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {
            "name": "means",
            "type": {"type": "array", "items": NAME_TERM_VALUE_AVRO},
        },
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}

SCORING_RESULT_AVRO = {
    "name": "ScoringResultAvro",
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}


# ---------------------------------------------------------------------------
# training-data reader (AvroDataReader analog)
# ---------------------------------------------------------------------------


def _as_paths(paths: str | Sequence[str]) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p))
                if f.endswith(".avro")
            )
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no .avro files under {paths}")
    return out


def build_index_maps_from_avro(
    paths: str | Sequence[str],
    feature_shards: Mapping[str, Sequence[str]],
    add_intercept: bool = True,
) -> dict[str, IndexMap]:
    """ONE scan builds the index maps for EVERY shard (the generate-by-scan
    path of AvroDataReader.scala:208-237 / FeatureIndexingJob). Uses the
    native decoder's interning pass when available (the vocab keys ARE the
    composed feature keys); pure-Python record walk otherwise."""
    from photon_ml_tpu_torch.data.avro_native import read_game_arrays_native

    names = list(feature_shards)
    try:
        fast = read_game_arrays_native(
            _as_paths(paths),
            {s: tuple(feature_shards[s]) for s in names},
            None,
            (),
            vocab_only=True,  # skip the COO/scalar materialization
        )
    except ValueError:
        fast = None  # corrupt-for-native input: let the python walk report
    if fast is not None:
        return {
            s: IndexMap.build(iter(fast[5][si]),
                              add_intercept=add_intercept)
            for si, s in enumerate(names)
        }

    keysets: dict[str, dict] = {s: {} for s in names}
    for path in _as_paths(paths):
        for rec in read_avro(path):
            for s in names:
                ks = keysets[s]
                for bag in feature_shards[s]:
                    for f in rec.get(bag) or ():
                        ks.setdefault(feature_key(f["name"], f["term"]))
    return {
        s: IndexMap.build(iter(keysets[s]), add_intercept=add_intercept)
        for s in names
    }


def build_index_map_from_avro(
    paths: str | Sequence[str],
    feature_bags: Sequence[str] = ("features",),
    add_intercept: bool = True,
) -> IndexMap:
    """Single-shard convenience wrapper over build_index_maps_from_avro."""
    return build_index_maps_from_avro(
        paths, {"shard": tuple(feature_bags)}, add_intercept=add_intercept
    )["shard"]


def _read_game_dataset_native(
    file_list: list[str],
    feature_shards: Mapping[str, Sequence[str]],
    index_maps: Optional[Mapping[str, IndexMap]],
    id_columns: Sequence[str],
    add_intercept: bool,
    is_response_required: bool,
    device,
):
    """Native-decoder fast path (``data/avro_native.py``); returns
    ``(GameDataset, index_maps)`` or None when the native path is
    unavailable/unsupported (the pure-Python decoder below then runs —
    identical semantics). One scan builds BOTH the dataset and, when
    ``index_maps`` is None, the feature index maps."""
    from photon_ml_tpu_torch.data.avro_native import read_game_arrays_native

    fast = read_game_arrays_native(
        file_list, feature_shards, index_maps, id_columns
    )
    if fast is None:
        return None
    labels, offsets, weights, coo, idvals, vocabs, label_seen, file_rows = fast
    n = len(labels)
    if n == 0:
        raise ValueError(f"no records in {file_list}")
    missing = label_seen == 0
    if np.any(missing) and is_response_required:
        # report the specific file + per-file record index, matching the
        # pure-Python fallback's diagnostics
        merged_idx = int(np.argmax(missing))
        bases = np.concatenate([[0], np.cumsum(file_rows)])
        fi = int(np.searchsorted(bases, merged_idx, side="right")) - 1
        raise ValueError(
            f"record {merged_idx - int(bases[fi])} of {file_list[fi]} "
            "has no label"
        )

    if index_maps is None:
        # ONE pass built both the COO (interned ids) and the vocabularies;
        # materialize the IndexMaps and remap interned -> final dense ids
        built = {}
        remapped = []
        for si, (shard, _) in enumerate(feature_shards.items()):
            imap = IndexMap.build(
                iter(vocabs[si]), add_intercept=add_intercept
            )
            built[shard] = imap
            vals, rws, cls = coo[si]
            remap = np.asarray(
                [imap.get(k) for k in vocabs[si]], np.int64
            )
            remapped.append(
                (vals, rws, remap[cls] if len(cls) else cls)
            )
        index_maps = built
        coo = remapped

    shards = {}
    for si, shard in enumerate(feature_shards):
        vals, rws, cls = coo[si]
        imap = index_maps[shard]
        if add_intercept:
            icept = imap.get(INTERCEPT_KEY)
            if icept >= 0:
                # decode emits rows in order; interleave the per-row
                # intercept arithmetically so the result STAYS row-sorted
                # (from_coo then skips its argsort over the nnz)
                vals, rws, cls = _interleave_intercept_sorted(
                    vals, rws, cls, n, icept
                )
        shards[shard] = FeatureShard.from_coo(vals, rws, cls, len(imap))
    # native id columns arrive as (interned codes, first-seen vocab):
    # sort the vocab and remap codes (models score via searchsorted over a
    # SORTED vocab) — no per-row strings are ever materialized
    id_cols = {}
    for ci, c in enumerate(id_columns):
        codes, vocab = idvals[ci]
        order = np.argsort(vocab)
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        id_cols[c] = IdColumn(
            codes=rank[codes] if len(codes) else codes, vocab=vocab[order]
        )
    return (
        build_game_dataset(
            response=labels,
            feature_shards=shards,
            id_columns=id_cols,
            offset=offsets,
            weight=weights,
            device=device,
        ),
        index_maps,
    )


def _interleave_intercept_sorted(
    vals: np.ndarray, rws: np.ndarray, cls: np.ndarray, n: int, icept: int
):
    """Insert one intercept nnz after each row's features, preserving row
    order, in O(nnz) — the sorted-merge of a row-sorted COO with the
    per-row intercept diagonal."""
    nnz = len(vals)
    out_v = np.empty(nnz + n)
    out_r = np.empty(nnz + n, np.int64)
    out_c = np.empty(nnz + n, np.int64)
    # each decode nnz shifts right by the number of intercepts already
    # placed (= its row index); the intercept of row r lands right after
    # row r's features
    dest = np.arange(nnz) + rws
    out_v[dest] = vals
    out_r[dest] = rws
    out_c[dest] = cls
    idest = np.searchsorted(rws, np.arange(n), side="right") + np.arange(n)
    out_v[idest] = 1.0
    out_r[idest] = np.arange(n)
    out_c[idest] = icept
    return out_v, out_r, out_c


def read_game_dataset_from_avro(
    paths: str | Sequence[str],
    feature_shards: Optional[Mapping[str, Sequence[str]]] = None,
    index_maps: Optional[Mapping[str, IndexMap]] = None,
    id_columns: Sequence[str] = (),
    add_intercept: bool = True,
    is_response_required: bool = True,
    return_index_maps: bool = False,
    device: torch.device | str | None = None,
) -> GameDataset:
    """Read TrainingExampleAvro-shaped records into a GameDataset solved
    on ``device`` (default cuda).

    ``feature_shards`` maps shard name -> record feature-bag field names to
    MERGE into that shard's column (featureColumnMap semantics,
    AvroDataReader.readMerged); default one shard "features" from the
    ``features`` bag. ``index_maps`` (per shard) translate name+term keys to
    dense ids — built IN THE SAME SCAN when absent (one pass interns keys
    and emits the COO; a separate index-build pass would double-decode the
    input). Unknown features are DROPPED (reference: index-map misses are
    skipped). ``id_columns`` are taken from top-level record fields or the
    metadataMap (GameConverters:38-110). ``return_index_maps``: return
    ``(dataset, index_maps)`` so training drivers can persist the scanned
    feature space without re-scanning.
    """
    feature_shards = dict(feature_shards or {"features": ("features",)})
    file_list = _as_paths(paths)

    fast = _read_game_dataset_native(
        file_list, feature_shards, index_maps, id_columns,
        add_intercept, is_response_required, device,
    )
    if fast is not None:
        telemetry.counter("avro.native_reads").inc()
        ds, maps = fast
        return (ds, maps) if return_index_maps else ds
    telemetry.counter("avro.python_reads").inc()

    if index_maps is None:
        index_maps = {
            shard: build_index_map_from_avro(
                file_list, bags, add_intercept=add_intercept
            )
            for shard, bags in feature_shards.items()
        }

    labels: list[float] = []
    offsets: list[float] = []
    weights: list[float] = []
    ids: dict[str, list] = {c: [] for c in id_columns}
    coo: dict[str, tuple[list, list, list]] = {
        s: ([], [], []) for s in feature_shards
    }

    row = 0
    for path in file_list:
        for rec in read_avro(path):
            label = rec.get("label")
            if label is None:
                if is_response_required:
                    raise ValueError(f"{path}: record {row} has no label")
                label = 0.0
            labels.append(float(label))
            off = rec.get("offset")
            offsets.append(0.0 if off is None else float(off))
            wgt = rec.get("weight")  # explicit 0.0 weights must survive
            weights.append(1.0 if wgt is None else float(wgt))
            meta = rec.get("metadataMap") or {}
            for c in id_columns:
                v = rec.get(c)
                if v is None:  # absent OR null top-level field -> metadataMap
                    v = meta.get(c)
                if v is None:
                    raise KeyError(
                        f"{path}: record {row} lacks id column '{c}' "
                        "(top-level field or metadataMap entry)"
                    )
                ids[c].append(v)
            for shard, bags in feature_shards.items():
                imap = index_maps[shard]
                vals, rws, cls = coo[shard]
                for bag in bags:
                    for f in rec.get(bag) or ():
                        idx = imap.get(feature_key(f["name"], f["term"]))
                        if idx >= 0:
                            vals.append(float(f["value"]))
                            rws.append(row)
                            cls.append(idx)
                if add_intercept:
                    icept = imap.get(INTERCEPT_KEY)
                    if icept >= 0:
                        vals.append(1.0)
                        rws.append(row)
                        cls.append(icept)
            row += 1

    if row == 0:
        raise ValueError(f"no records in {file_list}")

    shards = {}
    for shard in feature_shards:
        vals, rws, cls = coo[shard]
        shards[shard] = FeatureShard.from_coo(
            np.asarray(vals), np.asarray(rws, np.int64), np.asarray(cls, np.int64),
            len(index_maps[shard]),
        )
    ds = build_game_dataset(
        response=np.asarray(labels),
        feature_shards=shards,
        id_columns={c: np.asarray(v) for c, v in ids.items()},
        offset=np.asarray(offsets),
        weight=np.asarray(weights),
        device=device,
    )
    return (ds, index_maps) if return_index_maps else ds


def write_training_examples(
    path: str,
    data: GameDataset,
    shard_name: str,
    index_map: IndexMap,
    id_columns: Sequence[str] = (),
    codec: str = "deflate",
) -> int:
    """Export a GameDataset shard as TrainingExampleAvro records (the
    inverse of the reader; used for fixtures and interop)."""
    shard = data.shard(shard_name)
    n = data.num_rows
    vals, rows, cols = shard.values, shard.rows, shard.cols
    live = vals != 0
    order = np.argsort(rows[live], kind="stable")
    v, rw, cl = vals[live][order], rows[live][order], cols[live][order]
    starts = np.searchsorted(rw, np.arange(n))
    ends = np.searchsorted(rw, np.arange(n), side="right")

    def records():
        for i in range(n):
            feats = []
            for j in range(int(starts[i]), int(ends[i])):
                key = index_map.name_of(int(cl[j]))
                if key == INTERCEPT_KEY:
                    continue  # intercept is re-injected at read time
                name, _, term = key.partition("\x01")
                feats.append({"name": name, "term": term, "value": float(v[j])})
            meta = {
                c: str(data.id_columns[c].vocab[data.id_columns[c].codes[i]])
                for c in id_columns
            }
            yield {
                "uid": str(i),
                "label": float(data.response[i]),
                "features": feats,
                "metadataMap": meta or None,
                "weight": float(data.weight[i]),
                "offset": float(data.offset[i]),
            }

    return write_avro(path, TRAINING_EXAMPLE_AVRO, records(), codec=codec)


# ---------------------------------------------------------------------------
# model + score egress (ModelProcessingUtils / ScoreProcessingUtils analogs)
# ---------------------------------------------------------------------------


def write_bayesian_linear_model(
    path: str,
    coefficients: np.ndarray,
    index_map: IndexMap,
    model_id: str = "",
    variances: Optional[np.ndarray] = None,
    model_class: Optional[str] = None,
    loss_function: Optional[str] = None,
) -> None:
    """Export dense coefficients as one BayesianLinearModelAvro record
    (ModelProcessingUtils.saveGameModelsToHDFS coefficient layout). Zero
    coefficients are skipped, matching the sparse Avro representation."""
    means = _host(coefficients)

    def ntv(arr):
        out = []
        for i in np.nonzero(arr)[0]:
            key = index_map.name_of(int(i))
            name, _, term = key.partition("\x01")
            out.append({"name": name, "term": term, "value": float(arr[i])})
        return out

    rec = {
        "modelId": model_id,
        "modelClass": model_class,
        "means": ntv(means),
        "variances": ntv(_host(variances)) if variances is not None else None,
        "lossFunction": loss_function,
    }
    write_avro(path, BAYESIAN_LINEAR_MODEL_AVRO, [rec])


def read_bayesian_linear_model(
    path: str, index_map: IndexMap
) -> tuple[np.ndarray, Optional[np.ndarray], dict]:
    """Load (means, variances, metadata) from a BayesianLinearModelAvro file;
    features missing from the index map are dropped."""
    recs = list(read_avro(path))
    if len(recs) != 1:
        raise ValueError(f"{path}: expected 1 model record, got {len(recs)}")
    rec = recs[0]

    def dense(items):
        out = np.zeros(len(index_map))
        for f in items:
            idx = index_map.get(feature_key(f["name"], f["term"]))
            if idx >= 0:
                out[idx] = f["value"]
        return out

    means = dense(rec["means"])
    variances = dense(rec["variances"]) if rec.get("variances") else None
    meta = {
        "modelId": rec["modelId"],
        "modelClass": rec.get("modelClass"),
        "lossFunction": rec.get("lossFunction"),
    }
    return means, variances, meta


FEATURE_SUMMARIZATION_RESULT_AVRO = {
    "name": "FeatureSummarizationResultAvro",
    "type": "record",
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}


def write_feature_summary(
    path: str,
    summary,
    index_map: IndexMap,
    codec: str = "deflate",
) -> int:
    """Persist per-feature statistics as FeatureSummarizationResultAvro
    records (ModelProcessingUtils.writeBasicStatistics:559-608 analog:
    max/min/mean/normL1/normL2/numNonzeros/variance per name+term)."""
    metrics_arrays = {
        "max": _host(summary.max),
        "min": _host(summary.min),
        "mean": _host(summary.mean),
        "normL1": _host(summary.norm_l1),
        "normL2": _host(summary.norm_l2),
        "numNonzeros": _host(summary.num_nonzeros),
        "variance": _host(summary.variance),
    }

    def records():
        for i in range(len(index_map)):
            key = index_map.name_of(i)
            name, _, term = key.partition("\x01")
            yield {
                "featureName": name,
                "featureTerm": term,
                "metrics": {k: float(v[i]) for k, v in metrics_arrays.items()},
            }

    return write_avro(path, FEATURE_SUMMARIZATION_RESULT_AVRO, records(), codec=codec)


def read_feature_summary(path: str) -> dict[str, dict[str, float]]:
    """Load a feature-summary file as {feature key: {metric: value}}."""
    out = {}
    for rec in read_avro(path):
        out[feature_key(rec["featureName"], rec["featureTerm"])] = rec["metrics"]
    return out


def write_scoring_results(
    path: str,
    scores: np.ndarray,
    model_id: str = "",
    labels: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    uids: Optional[Sequence[str]] = None,
    codec: str = "deflate",
) -> int:
    """Persist scores as ScoringResultAvro (ScoreProcessingUtils analog)."""
    scores = _host(scores)

    def records():
        for i in range(len(scores)):
            yield {
                "uid": str(uids[i]) if uids is not None else str(i),
                "label": float(labels[i]) if labels is not None else None,
                "modelId": model_id,
                "predictionScore": float(scores[i]),
                "weight": float(weights[i]) if weights is not None else None,
                "metadataMap": None,
            }

    return write_avro(path, SCORING_RESULT_AVRO, records(), codec=codec)


def read_scoring_results(path: str) -> list[dict]:
    return list(read_avro(path))
