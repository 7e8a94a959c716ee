"""Typed ingest-pipeline errors: the stall/backpressure protocol.

Counterpart of ``photon_ml_tpu/ingest/errors.py``, the same types. Every failure mode the pipeline can hit has a distinct type, so callers
(and tests) can tell a configuration problem from corrupt input from a
wedged stage — a generic ``queue.Empty`` deep inside a worker thread
tells an operator nothing.
"""

from __future__ import annotations


class IngestError(RuntimeError):
    """Base class for ingest-pipeline failures."""


class IngestConfigError(IngestError, ValueError):
    """An :class:`~photon_ml_tpu_torch.ingest.pipeline.IngestSpec` that cannot
    work: zero/negative depths, a resident budget too small for even a
    minimal ring, a staging capacity the data overflows."""


class IngestStall(IngestError):
    """A pipeline stage waited longer than ``stall_timeout_s`` for its
    neighbor — the typed form of "the pipeline is wedged".

    ``stage`` names the waiting side: ``"decode"`` (no free staging
    buffer — the consumer stopped draining), ``"upload"`` (the bounded
    output queue stayed full), ``"consume"`` (the solve waited on data
    past the timeout — decode cannot keep up, or a worker died silently).
    """

    def __init__(self, stage: str, waited_s: float, detail: str = ""):
        self.stage = stage
        self.waited_s = waited_s
        msg = f"ingest pipeline stalled in stage '{stage}' after {waited_s:.1f}s"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class PipelineClosed(IngestError):
    """The stream was consumed after :meth:`ChunkStream.close` (or after a
    prior error already tore the pipeline down)."""


class ChunkDecodeError(IngestError):
    """A chunk's bytes could not be decoded (corrupt block, record
    missing a required label or id column). Carries the file path and
    chunk index so the bad shard is nameable."""

    def __init__(self, path: str, chunk_index: int, reason: str):
        self.path = path
        self.chunk_index = chunk_index
        super().__init__(f"{path} (chunk {chunk_index}): {reason}")
