"""Delta detection: which entities did today's data touch?

Counterpart of ``photon_ml_tpu/incremental/delta.py``. The interned
entity-id columns of the delta become a touched-entity set per id column,
by either of two paths with the same answer:

- :func:`scan_delta`, in core: a delta ``GameDataset``'s ``IdColumn`` codes
  are the interned ids, and one ``np.unique`` per column is the scan;
- :func:`scan_delta_stream`, out of core: a ``ChunkStream`` over the delta
  shards, the touched codes gathered chunk by chunk from
  ``DeviceChunk.id_codes`` (the stream-global interning) and mapped back to
  id values through the stream's first-seen vocabulary at the end. Host set
  work only; the delta never has to fit in memory at once.

Touched sets hold raw id values (an entity is its value; vocabulary growth
moves codes) and map into any vocabulary through
:meth:`CoordinateDelta.touched_mask`. Telemetry: the counter
``incremental.touched_entities`` and the gauges
``incremental.touched_fraction`` and ``incremental.touched_fraction.<id>``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.game.models import map_vocab_codes

# the delta scan's entry: an `io` rule is a flaky read of the delta shards;
# a raise surfaces before any fit state exists (the scan only reads)
FP_DELTA_SCAN = faults.register_point(
    "incremental.delta_scan",
    description="entry of a touched-entity delta scan (pure read of the "
    "delta stream's interned id columns)",
)


@dataclasses.dataclass(frozen=True)
class CoordinateDelta:
    """The touched set of one id column: ``touched_values`` the sorted
    unique id values of the delta, ``new_values`` those absent from the base
    vocabulary (no warm-start row), ``base_entities`` the base vocabulary's
    size, which the fraction is measured against."""

    id_name: str
    touched_values: np.ndarray
    new_values: np.ndarray
    base_entities: int

    @property
    def touched_count(self) -> int:
        return int(len(self.touched_values))

    @property
    def new_count(self) -> int:
        return int(len(self.new_values))

    @property
    def touched_fraction(self) -> float:
        return self.touched_count / max(self.base_entities, 1)

    def touched_mask(self, vocab: np.ndarray) -> np.ndarray:
        """A boolean mask over ``vocab`` (the base's or the combined run's
        grown one) marking the touched entities."""
        mask = np.zeros(len(vocab), bool)
        codes = map_vocab_codes(np.asarray(vocab), np.asarray(self.touched_values))
        mask[codes[codes >= 0]] = True
        return mask

    def to_json(self) -> dict:
        return {
            "id_name": self.id_name,
            "touched_entities": self.touched_count,
            "new_entities": self.new_count,
            "base_entities": int(self.base_entities),
            "touched_fraction": round(self.touched_fraction, 6),
        }


@dataclasses.dataclass(frozen=True)
class DeltaScan:
    """Every id column's touched set of one delta, and the delta's identity
    (``digest``, the fingerprint publishing records)."""

    coordinates: Mapping[str, CoordinateDelta]  # keyed by id column name
    delta_rows: int
    digest: str
    paths: tuple[str, ...] = ()

    def for_id(self, id_name: str) -> Optional[CoordinateDelta]:
        return self.coordinates.get(id_name)

    def to_json(self) -> dict:
        return {
            "delta_rows": int(self.delta_rows),
            "digest": self.digest,
            "paths": list(self.paths),
            "coordinates": {k: v.to_json() for k, v in self.coordinates.items()},
        }


# the head and the tail of each file hashed into the digest: a same-size
# rewrite shows, and no shard is read past 128 KiB
_DIGEST_SAMPLE_BYTES = 1 << 16


def delta_digest(paths: Sequence[str]) -> str:
    """The fingerprint of a delta's file set: per file its basename, byte
    size and a sha256 of its head and tail, the records sorted, so the
    digest depends on the set of files only (not on their order or
    directories). A file added, dropped or rewritten, at the same size
    too, changes it."""
    records = []
    for p in paths:
        fh_hash = hashlib.sha256()
        try:
            size = os.path.getsize(p)
            with open(p, "rb") as fh:
                fh_hash.update(fh.read(_DIGEST_SAMPLE_BYTES))
                if size > 2 * _DIGEST_SAMPLE_BYTES:
                    fh.seek(-_DIGEST_SAMPLE_BYTES, os.SEEK_END)
                    fh_hash.update(fh.read(_DIGEST_SAMPLE_BYTES))
        except OSError:
            size = -1
        records.append(f"{os.path.basename(p)}:{size}:{fh_hash.hexdigest()};")
    h = hashlib.sha256()
    for record in sorted(records):
        h.update(record.encode())
    return h.hexdigest()


def _coordinate_delta(id_name: str, touched: np.ndarray, base_vocab) -> CoordinateDelta:
    base_vocab = np.asarray(base_vocab)
    codes = map_vocab_codes(base_vocab, touched)
    return CoordinateDelta(id_name=id_name, touched_values=np.sort(touched),
                           new_values=np.sort(touched[codes < 0]),
                           base_entities=len(base_vocab))


def _record_telemetry(coords: Mapping[str, CoordinateDelta]) -> None:
    total_touched = 0
    worst = 0.0
    for name, cd in coords.items():
        total_touched += cd.touched_count
        worst = max(worst, cd.touched_fraction)
        telemetry.gauge(f"incremental.touched_fraction.{name}").set(cd.touched_fraction)
    if total_touched:
        telemetry.counter("incremental.touched_entities").inc(total_touched)
    telemetry.gauge("incremental.touched_fraction").set(worst)


def scan_delta(delta_data, base_vocabs: Mapping[str, np.ndarray],
               paths: Sequence[str] = ()) -> DeltaScan:
    """The touched sets of a delta ``GameDataset``'s interned id columns.
    ``base_vocabs`` maps an id column to the base model's vocabulary
    (``RandomEffectModel.vocab``); only the columns named there are scanned
    (a column no coordinate trains on gates no lane). Host work only."""
    faults.fault_point(FP_DELTA_SCAN)
    with telemetry.span("incremental:delta_scan", rows=delta_data.num_rows):
        coords: dict[str, CoordinateDelta] = {}
        for id_name, base_vocab in base_vocabs.items():
            idc = delta_data.id_columns.get(id_name)
            if idc is None:
                raise KeyError(f"delta data lacks id column '{id_name}'; have "
                               f"{sorted(delta_data.id_columns)}")
            coords[id_name] = _coordinate_delta(id_name, idc.vocab[np.unique(idc.codes)],
                                                base_vocab)
        _record_telemetry(coords)
        return DeltaScan(coordinates=coords, delta_rows=int(delta_data.num_rows),
                         digest=delta_digest(paths), paths=tuple(paths))


def scan_delta_stream(paths: Sequence[str], base_vocabs: Mapping[str, np.ndarray],
                      index_maps: Mapping,
                      feature_shards: Optional[Mapping[str, Sequence[str]]] = None,
                      spec=None, device: torch.device | str | None = None) -> DeltaScan:
    """The touched sets of the delta shards at ``paths``, streamed through a
    ``ChunkStream`` on ``device`` (default cuda): the host holds one staging
    ring whatever the delta's size, and the touched sets equal the in-core
    scan's bit for bit."""
    from photon_ml_tpu_torch.ingest import ChunkStream

    faults.fault_point(FP_DELTA_SCAN)
    id_columns = tuple(base_vocabs)
    with telemetry.span("incremental:delta_scan", streamed=True):
        touched_codes: dict[str, set] = {c: set() for c in id_columns}
        rows = 0
        with ChunkStream(paths, feature_shards=feature_shards, index_maps=index_maps,
                         id_columns=id_columns, spec=spec, device=device) as stream:
            for chunk in stream:
                rows += int(chunk.rows)
                for col in id_columns:
                    touched_codes[col].update(np.unique(chunk.id_codes[col]).tolist())
            coords: dict[str, CoordinateDelta] = {}
            for col in id_columns:
                vocab = stream.id_vocabulary(col)
                code_arr = np.fromiter(sorted(touched_codes[col]), dtype=np.int64,
                                       count=len(touched_codes[col]))
                coords[col] = _coordinate_delta(col, np.asarray(vocab[code_arr]),
                                                base_vocabs[col])
        _record_telemetry(coords)
        return DeltaScan(coordinates=coords, delta_rows=rows, digest=delta_digest(paths),
                         paths=tuple(paths))
