"""File-split planner: Avro container files -> deterministic chunk plans.

Counterpart of ``photon_ml_tpu/ingest/planner.py``, host code copied: the
same plans, field for field, from the same files.

Avro object-container blocks are sync-delimited and self-describing
(``[count varint, byte-size varint, payload, 16-byte sync]``), so a file
splits into independently decodable byte ranges without reading any
payload — the scan below touches only the two varints per block and
seeks past the rest. The reference reads per-partition on executors
(AvroDataReader.scala:87-237); here the same split boundaries feed a
thread pool on one host.

Determinism contract: ``plan_chunks`` over the same file list with the
same ``chunk_rows`` always yields the same chunk sequence — same indices,
same byte ranges, same global row offsets. Checkpoint resume relies on
this: replaying a stream from chunk K re-decodes exactly the rows the
interrupted run would have, in the same order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import BinaryIO, Iterator, Sequence

_MAGIC = b"Obj\x01"
_SYNC_LEN = 16


@dataclasses.dataclass(frozen=True)
class FileMeta:
    """Header facts of one Avro container file (no payload read)."""

    path: str
    schema_json: str
    codec: str  # "null" | "deflate"
    sync: bytes  # the file's 16-byte block delimiter
    header_end: int  # byte offset of the first block
    file_bytes: int


@dataclasses.dataclass(frozen=True)
class BlockInfo:
    """One sync-delimited block: ``[offset, offset + nbytes)`` holds the
    count/size varints, the payload, and the trailing sync marker."""

    offset: int
    n_records: int
    nbytes: int


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """One unit of decode work: a run of whole blocks inside one file.

    ``index`` is the chunk's position in the global deterministic order;
    ``row_start`` its global row offset (rows of all earlier chunks, in
    order). Chunks never span files — a decode worker reads exactly
    ``[byte_start, byte_end)`` of ``path``.
    """

    index: int
    path: str
    byte_start: int
    byte_end: int
    n_rows: int
    row_start: int
    n_blocks: int

    @property
    def nbytes(self) -> int:
        return self.byte_end - self.byte_start


def _read_varint_long(f: BinaryIO, path: str) -> int:
    """One zigzag varint from the file cursor (raises on EOF)."""
    shift = 0
    acc = 0
    while True:
        b = f.read(1)
        if not b:
            raise ValueError(f"{path}: truncated varint (unexpected EOF)")
        v = b[0]
        acc |= (v & 0x7F) << shift
        if not v & 0x80:
            return (acc >> 1) ^ -(acc & 1)
        shift += 7


def _read_exact(f: BinaryIO, n: int, path: str) -> bytes:
    out = f.read(n)
    if len(out) != n:
        raise ValueError(f"{path}: truncated read ({len(out)}/{n} bytes)")
    return out


def read_file_meta(path: str) -> FileMeta:
    """Parse the container header only: magic, metadata map, sync marker.

    Reads exactly the header bytes — an out-of-core planner must not pull
    whole multi-GB shards through host RAM just to learn their schema.
    """
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if _read_exact(f, 4, path) != _MAGIC:
            raise ValueError(f"{path} is not an Avro container file")
        meta: dict[str, bytes] = {}
        while True:
            n = _read_varint_long(f, path)
            if n == 0:
                break
            if n < 0:  # block with byte-size prefix
                n = -n
                _read_varint_long(f, path)
            for _ in range(n):
                klen = _read_varint_long(f, path)
                key = _read_exact(f, klen, path).decode("utf-8")
                vlen = _read_varint_long(f, path)
                meta[key] = _read_exact(f, vlen, path)
        sync = _read_exact(f, _SYNC_LEN, path)
        header_end = f.tell()
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"{path}: unsupported codec '{codec}'")
    if "avro.schema" not in meta:
        raise ValueError(f"{path}: header lacks avro.schema")
    return FileMeta(
        path=path,
        schema_json=meta["avro.schema"].decode(),
        codec=codec,
        sync=sync,
        header_end=header_end,
        file_bytes=size,
    )


def scan_blocks(meta: FileMeta) -> Iterator[BlockInfo]:
    """Walk the block index of one file: two varints + a seek per block.

    Verifies every trailing sync marker — a corrupt block surfaces at
    PLAN time with its byte offset, not as garbage rows mid-stream.
    """
    with open(meta.path, "rb") as f:
        f.seek(meta.header_end)
        pos = meta.header_end
        while pos < meta.file_bytes:
            n_records = _read_varint_long(f, meta.path)
            payload = _read_varint_long(f, meta.path)
            if n_records < 0 or payload < 0:
                raise ValueError(
                    f"{meta.path}: negative block header at byte {pos}"
                )
            f.seek(payload, os.SEEK_CUR)
            if _read_exact(f, _SYNC_LEN, meta.path) != meta.sync:
                raise ValueError(
                    f"{meta.path}: sync marker mismatch after block at "
                    f"byte {pos} (corrupt block)"
                )
            end = f.tell()
            yield BlockInfo(offset=pos, n_records=n_records,
                            nbytes=end - pos)
            pos = end


def plan_chunks(
    paths: Sequence[str], chunk_rows: int
) -> tuple[list[FileMeta], list[ChunkPlan]]:
    """Assign whole-block runs of ``paths`` (in order) to chunks of at
    least ``chunk_rows`` rows (the last chunk of each file may be
    smaller). Returns ``(file metas, plans)``; plan order IS the stream
    order and is a pure function of the inputs.
    """
    if chunk_rows < 1:
        raise ValueError("chunk_rows must be >= 1")
    metas: list[FileMeta] = []
    plans: list[ChunkPlan] = []
    row_start = 0
    for path in paths:
        meta = read_file_meta(path)
        metas.append(meta)
        start = None
        rows = 0
        blocks = 0
        end = meta.header_end
        for blk in scan_blocks(meta):
            if blk.n_records == 0:
                continue  # empty block: nothing to decode, skip entirely
            if start is None:
                start = blk.offset
            rows += blk.n_records
            blocks += 1
            end = blk.offset + blk.nbytes
            if rows >= chunk_rows:
                plans.append(
                    ChunkPlan(
                        index=len(plans),
                        path=path,
                        byte_start=start,
                        byte_end=end,
                        n_rows=rows,
                        row_start=row_start,
                        n_blocks=blocks,
                    )
                )
                row_start += rows
                start, rows, blocks = None, 0, 0
        if start is not None:
            plans.append(
                ChunkPlan(
                    index=len(plans),
                    path=path,
                    byte_start=start,
                    byte_end=end,
                    n_rows=rows,
                    row_start=row_start,
                    n_blocks=blocks,
                )
            )
            row_start += rows
    return metas, plans


def total_rows(plans: Sequence[ChunkPlan]) -> int:
    return sum(p.n_rows for p in plans)


def plans_for_host(
    plans: Sequence[ChunkPlan], process_id: int, num_processes: int
) -> list[ChunkPlan]:
    """The deterministic per-host slice of a global chunk plan: chunk
    ``i`` belongs to host ``i % num_processes`` (round-robin over the
    global order, so host loads stay balanced whatever the file sizes).

    This is a pure function of ``(plans, num_processes)`` — no
    coordination state — which is what makes SURVIVOR-ELASTIC resume
    work: when a fleet member dies and the fit relaunches on fewer
    hosts, every survivor recomputes the split for the new fleet size
    and the dead host's chunks land on survivors automatically. Replay
    from a checkpoint's ``next_chunk`` then re-decodes exactly the rows
    the old fleet would have, in the same global order.
    """
    if num_processes < 1:
        raise ValueError("num_processes must be >= 1")
    if not (0 <= process_id < num_processes):
        raise ValueError(
            f"process_id {process_id} out of range for "
            f"{num_processes} host(s)"
        )
    return [p for p in plans if p.index % num_processes == process_id]
