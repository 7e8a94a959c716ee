"""Warm-start loading: yesterday's checkpoint becomes today's starting
table, on whatever mesh today's run has.

Counterpart of ``photon_ml_tpu/incremental/warmstart.py``. Three base
artifacts are recognized (:func:`detect_warm_start_kind`):

- ``"step"``: a coordinate-descent checkpoint directory (``step-NNNNNNNN/``
  from ``game.checkpoint.CheckpointManager``); the full GAME model restores
  through the manager's newest-valid walk.
- ``"streaming"``: a streamed-table checkpoint (``chunk-NNNNNNNN/`` from
  ``StreamingCheckpointManager``); the coefficient table is read block by
  block straight onto the training mesh (``restore_placed``) and wrapped
  by ``ShardedCoefficientTable.from_coefficients``.
- ``"model"``: a saved model directory (``model-metadata.json``), the
  ``final/`` / ``best/`` layout the training driver writes.

Tensors land on ``device`` (default cuda), or on ``mesh``'s devices. A
load only reads: nothing under the directory is created or rewritten.

Vocabulary growth: a delta can bring entities the base never saw, so the
current vocabulary may hold more entities than the checkpoint.
:func:`grow_entity_rows` appends zero rows and copies the old ones bit for
bit; on a mesh each owner's block is assembled on its device from the old
rows it now holds, and an entity count that does not divide the model axis
raises the typed ``ElasticPlacementError`` with the sizes that can hold it.

Every load records a :class:`BaseLineage` (directory, kind, cursor and a
sha256 of the certifying manifest or metadata file), which publishing puts
into the registry version's metadata.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from typing import Optional

import torch

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.parallel.sharding import (
    EntityShards,
    entity_axis_mismatch,
    model_axis,
)
from photon_ml_tpu_torch.telemetry.executables import instrumented

Tensor = torch.Tensor

logger = logging.getLogger("photon_ml_tpu_torch.incremental")

# the warm-start restore's entry: an `io` rule is a flaky read of shared
# storage; a kill here leaves the base untouched, since a restore only reads
FP_WARM_RESTORE = faults.register_point(
    "incremental.warm_restore",
    description="entry of a warm-start checkpoint restore (read-only: "
    "the base checkpoint is never written)",
)


class WarmStartError(RuntimeError):
    """The warm-start directory is unusable for an incremental fit; the
    message names the directory and what was expected there."""


@dataclasses.dataclass(frozen=True)
class BaseLineage:
    """Identity of the base artifact an incremental fit started from;
    ``digest`` is the sha256 of the newest restored state's manifest (or
    the model's metadata), which proves later that the base was not
    changed and makes two publishes from one base recognizable."""

    checkpoint_dir: str
    kind: str  # "step" | "streaming" | "model"
    step: Optional[int] = None
    next_chunk: Optional[int] = None
    digest: Optional[str] = None

    def to_json(self) -> dict:
        out = {"checkpoint_dir": self.checkpoint_dir, "kind": self.kind}
        if self.step is not None:
            out["step"] = int(self.step)
        if self.next_chunk is not None:
            out["next_chunk"] = int(self.next_chunk)
        if self.digest is not None:
            out["digest"] = self.digest
        return out


@dataclasses.dataclass
class WarmStart:
    """A loaded base artifact: ``model`` (a ``GameModel``) for the ``step``
    and ``model`` kinds, ``table`` (a ``ShardedCoefficientTable``) and its
    ``variances`` for the ``streaming`` kind."""

    lineage: BaseLineage
    model: Optional[object] = None
    table: Optional[object] = None
    variances: Optional[object] = None
    next_chunk: int = 0


def _digest_file(path: str) -> Optional[str]:
    try:
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()
    except OSError:
        return None


def detect_warm_start_kind(directory: str) -> str:
    """Classify a warm-start directory by its certifying artifacts."""
    if not os.path.isdir(directory):
        raise WarmStartError(f"warm-start directory does not exist: {directory}")
    if os.path.exists(os.path.join(directory, "model-metadata.json")):
        return "model"
    names = os.listdir(directory)
    if any(n.startswith("step-") for n in names):
        return "step"
    if any(n.startswith("chunk-") for n in names):
        return "streaming"
    raise WarmStartError(
        f"{directory} holds neither a saved model (model-metadata.json), "
        "a step checkpoint (step-*/), nor a streamed-table checkpoint "
        "(chunk-*/) — nothing to warm-start from")


def load_warm_start(directory: str, mesh=None, axis: Optional[str] = None,
                    device: torch.device | str | None = None) -> WarmStart:
    """The base artifact under ``directory``, on ``device`` (default cuda;
    with ``mesh``, its first device). A streamed table is placed over
    ``mesh``'s model axis (``axis``) whatever mesh wrote it; the step and
    model kinds give the full GAME model, past corrupt newest states as
    their restores do."""
    if mesh is not None and device is None:
        device = mesh.first_device
    dev = resolve_device(device)
    faults.fault_point(FP_WARM_RESTORE)
    kind = detect_warm_start_kind(directory)
    with telemetry.span("incremental:warm_restore", kind=kind):
        if kind == "streaming":
            return _load_streaming(directory, mesh, axis, dev)
        if kind == "step":
            return _load_step(directory, dev)
        return _load_model_dir(directory, dev)


def _load_streaming(directory: str, mesh, axis, dev: torch.device) -> WarmStart:
    from photon_ml_tpu_torch.game.checkpoint import StreamingCheckpointManager
    from photon_ml_tpu_torch.game.streaming import ShardedCoefficientTable

    mgr = StreamingCheckpointManager.open_for_restore(directory)
    restored = mgr.restore_placed(mesh=mesh, axis=axis, device=dev)
    if restored is None:
        raise WarmStartError(f"{directory}: no valid streamed checkpoint to warm-start from")
    table = ShardedCoefficientTable.from_coefficients(restored.coefficients, mesh=mesh,
                                                      axis=axis)
    # the manifest of the newest valid chunk, the one the restore used
    digest = _digest_file(os.path.join(directory, f"chunk-{restored.next_chunk:08d}",
                                       "manifest.json"))
    telemetry.counter("incremental.warm_restores").inc()
    return WarmStart(
        lineage=BaseLineage(checkpoint_dir=os.path.abspath(directory), kind="streaming",
                            next_chunk=int(restored.next_chunk), digest=digest),
        table=table, variances=restored.variances, next_chunk=int(restored.next_chunk))


def _load_step(directory: str, dev: torch.device) -> WarmStart:
    from photon_ml_tpu_torch.game.checkpoint import (
        CheckpointManager,
        CheckpointSpec,
        _step_dirname,
    )

    state = CheckpointManager(CheckpointSpec(directory=directory), device=dev).restore()
    if state is None:
        raise WarmStartError(f"{directory}: no valid step checkpoint to warm-start from")
    digest = _digest_file(os.path.join(directory, _step_dirname(state.step), "manifest.json"))
    telemetry.counter("incremental.warm_restores").inc()
    return WarmStart(
        lineage=BaseLineage(checkpoint_dir=os.path.abspath(directory), kind="step",
                            step=int(state.step), digest=digest),
        model=state.model)


def _load_model_dir(directory: str, dev: torch.device) -> WarmStart:
    from photon_ml_tpu_torch.data.model_store import ModelLoadError, load_game_model

    try:
        model = load_game_model(directory, device=dev)
    except ModelLoadError as e:
        raise WarmStartError(f"{directory}: unloadable saved model ({e})") from e
    digest = _digest_file(os.path.join(directory, "model-metadata.json"))
    telemetry.counter("incremental.warm_restores").inc()
    return WarmStart(
        lineage=BaseLineage(checkpoint_dir=os.path.abspath(directory), kind="model",
                            digest=digest),
        model=model)


@instrumented(name="incremental_grow_rows")
def _grown_block(pieces: list, rows: int, dtype: torch.dtype, device) -> Tensor:
    """``rows`` rows on ``device``: the old rows in ``pieces``, then zeros."""
    have = sum(int(p.shape[0]) for p in pieces)
    if have < rows:
        pieces = pieces + [torch.zeros((rows - have, int(pieces[0].shape[1])), dtype=dtype,
                                       device=device)]
    return torch.cat(pieces) if len(pieces) > 1 else pieces[0].clone()


def grow_entity_rows(coefficients, num_entities: int, mesh=None, axis: Optional[str] = None):
    """An ``[N_old, K]`` table grown to ``[num_entities, K]``: rows
    ``[0, N_old)`` copied bit for bit, the new rows zero (a never-seen
    entity's init). With ``mesh`` the result is an ``EntityShards`` over its
    model axis (``axis``): each owner's block is assembled on its device
    from the old rows it holds now, which may come from other blocks, and
    zeros. Shrinking is refused: dropping trained rows would lose them."""
    n_old, k = (int(d) for d in coefficients.shape)
    num_entities = int(num_entities)
    if num_entities < n_old:
        raise WarmStartError(
            f"cannot shrink a warm-start table from {n_old} to {num_entities} entities — "
            "the vocabulary may only grow")
    grow = num_entities - n_old
    if mesh is None:
        if isinstance(coefficients, EntityShards):
            raise ValueError("an entity-sharded table grows on a mesh: pass mesh=")
        if grow == 0:
            return coefficients
        return _grown_block([coefficients], num_entities, coefficients.dtype,
                            coefficients.device)
    resolved = axis or model_axis(mesh)
    if resolved is None:
        raise ValueError(f"mesh {mesh.shape} has no model/entity axis to grow entities over")
    devices = mesh.axis_devices(resolved)
    if num_entities % len(devices):
        raise entity_axis_mismatch(num_entities, resolved, len(devices),
                                   what="hold the grown vocabulary")
    if isinstance(coefficients, EntityShards):
        old = list(zip(coefficients.row_starts(), coefficients.parts))
    else:
        old = [(0, coefficients)]
    per = num_entities // len(devices)
    parts = []
    for i, dev in enumerate(devices):
        lo, hi = i * per, (i + 1) * per
        pieces = [part[max(lo - start, 0):min(hi, start + part.shape[0]) - start].to(dev)
                  for start, part in old if start < hi and start + part.shape[0] > lo]
        if not pieces:
            pieces = [torch.zeros((0, k), dtype=old[0][1].dtype, device=dev)]
        parts.append(_grown_block(pieces, per, old[0][1].dtype, dev))
    if grow:
        telemetry.counter("incremental.grown_entities").inc(grow)
    return EntityShards(parts=tuple(parts), mesh=mesh, axis=resolved)
