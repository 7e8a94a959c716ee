"""Checkpoint and resume for coordinate descent: atomic step snapshots,
fallback past corrupt checkpoints, and the graceful-stop handshake.

Counterpart of ``photon_ml_tpu/game/checkpoint.py:91-378``, with its
layout, manifest keys and ``format_version``, so a checkpoint written by
either package restores in the other::

    <checkpoint_dir>/
      step-00000007/
        manifest.json        step, coordinate order, best metric, history,
                             frozen coordinates, consecutive rollbacks
        model/               the GAME model (the model store's layout)
        best/                the best model so far (when validation ran)

A checkpoint is assembled in a ``.tmp-step-*`` sibling with its manifest
written last, then renamed into place and the directory fsynced, so a
directory without a manifest is incomplete by definition. ``restore`` walks
the steps newest first and skips corrupt or partial ones (counter
``checkpoint.corrupt``); retention keeps the newest ``keep_last``.
``GracefulStop`` turns SIGTERM/SIGINT into "finish this step, write a final
checkpoint, raise ``TrainingInterrupted``"; a second signal exits at once
with code 75.

Restored models are loaded onto ``device`` (the fit's). The streaming
manager (item 13), the fault points (item 14c) and the telemetry gauges
(item 14d) are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import signal
from typing import Optional

import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.utils.atomic import atomic_write_json, fsync_dir

logger = logging.getLogger("photon_ml_tpu_torch.game.checkpoint")

_MANIFEST_FILE = "manifest.json"
_FORMAT_VERSION = 1
_STEP_RE = re.compile(r"^step-(\d{8})$")


class CheckpointError(RuntimeError):
    """A checkpoint directory is unusable: corrupt, partial, or written by
    another fit."""


class TrainingInterrupted(RuntimeError):
    """Raised after a graceful stop once the final checkpoint is on disk."""

    def __init__(self, step: int, checkpoint_path: Optional[str]):
        super().__init__(f"training interrupted after step {step}"
                         + (f"; checkpoint at {checkpoint_path}" if checkpoint_path else ""))
        self.step = step
        self.checkpoint_path = checkpoint_path


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """Save after every ``every`` completed (iteration, coordinate) steps (a
    stop always saves); keep the newest ``keep_last``. ``resume=False`` is a
    fresh fit into the directory: its checkpoints are cleared. The
    reference's ``quorum_timeout_s`` (coordinated multi-process saves) is
    kept for its validation only."""

    directory: str
    every: int = 1
    keep_last: int = 3
    resume: bool = True
    quorum_timeout_s: float = 60.0

    def __post_init__(self):
        if self.every < 1:
            raise ValueError("checkpoint every must be >= 1")
        if self.keep_last < 1:
            raise ValueError("checkpoint keep_last must be >= 1")
        if self.quorum_timeout_s <= 0:
            raise ValueError("checkpoint quorum_timeout_s must be > 0")


@dataclasses.dataclass
class CheckpointState:
    """What coordinate descent needs to go on: the last completed global
    step, the models, the best model so far, the JSON-safe history and the
    guard's bookkeeping."""

    step: int
    model: GameModel
    best_model: Optional[GameModel]
    best_metric: Optional[float]
    history: list
    frozen: list = dataclasses.field(default_factory=list)
    consecutive_rollbacks: Optional[dict] = None


def _step_dirname(step: int) -> str:
    return f"step-{step:08d}"


class CheckpointManager:
    """Atomic save, newest-valid restore and retention over one directory;
    restored models land on ``device`` (default cuda)."""

    def __init__(self, spec: CheckpointSpec, device: torch.device | str | None = None):
        self.spec = spec
        self.device = device
        os.makedirs(spec.directory, exist_ok=True)
        if not spec.resume:
            stale = self._step_dirs()
            if stale:
                logger.warning("resume=False: clearing %d existing checkpoint(s) under %s "
                               "for a fresh fit", len(stale), spec.directory)
            for _step, path in stale:
                shutil.rmtree(path, ignore_errors=True)

    def should_save(self, step: int) -> bool:
        return (step + 1) % self.spec.every == 0

    def save(self, state: CheckpointState) -> str:
        """Write ``state`` as ``step-<step>`` and return its path."""
        from photon_ml_tpu_torch.data.model_store import save_game_model

        final = os.path.join(self.spec.directory, _step_dirname(state.step))
        tmp = os.path.join(self.spec.directory, f".tmp-{_step_dirname(state.step)}")
        with telemetry.span("checkpoint:save", step=state.step):
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            save_game_model(state.model, os.path.join(tmp, "model"))
            if state.best_model is not None:
                save_game_model(state.best_model, os.path.join(tmp, "best"))
            # the manifest lands last: its presence certifies the checkpoint
            atomic_write_json(os.path.join(tmp, _MANIFEST_FILE), {
                "format_version": _FORMAT_VERSION,
                "step": state.step,
                "coordinate_order": list(state.model.models),
                "best_metric": state.best_metric,
                "has_best": state.best_model is not None,
                "history": state.history,
                "frozen": list(state.frozen),
                "consecutive_rollbacks": state.consecutive_rollbacks or {},
            }, indent=2, sort_keys=True)
            if os.path.exists(final):  # a step saved again (a resume's overlap)
                shutil.rmtree(final)
            os.rename(tmp, final)
            fsync_dir(self.spec.directory)
        telemetry.counter("checkpoint.saves").inc()
        self._apply_retention()
        return final

    def _apply_retention(self) -> None:
        for _step, path in self._step_dirs()[: -self.spec.keep_last]:
            shutil.rmtree(path, ignore_errors=True)
        for name in os.listdir(self.spec.directory):
            if name.startswith(".tmp-step-"):  # abandoned by a crashed save
                shutil.rmtree(os.path.join(self.spec.directory, name), ignore_errors=True)

    def _step_dirs(self) -> list[tuple[int, str]]:
        """(step, path) of every step directory, oldest first."""
        out = []
        for name in os.listdir(self.spec.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.spec.directory, name)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self._step_dirs()
        return steps[-1][0] if steps else None

    def _load(self, path: str) -> CheckpointState:
        from photon_ml_tpu_torch.data.model_store import load_game_model

        manifest_path = os.path.join(path, _MANIFEST_FILE)
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise CheckpointError(f"{path}: incomplete checkpoint (no manifest)") from None
        except ValueError as e:
            raise CheckpointError(f"{manifest_path}: corrupt manifest ({e})") from None
        if manifest.get("format_version") != _FORMAT_VERSION:
            raise CheckpointError(f"{manifest_path}: unsupported format_version "
                                  f"{manifest.get('format_version')!r}")
        model = load_game_model(os.path.join(path, "model"), device=self.device)
        best_model = None
        if manifest.get("has_best"):
            best_model = load_game_model(os.path.join(path, "best"), device=self.device)
        return CheckpointState(
            step=int(manifest["step"]), model=model, best_model=best_model,
            best_metric=manifest.get("best_metric"),
            history=list(manifest.get("history", ())),
            frozen=list(manifest.get("frozen", ())),
            consecutive_rollbacks=dict(manifest.get("consecutive_rollbacks") or {}))

    def restore(self) -> Optional[CheckpointState]:
        """The newest valid checkpoint, or None; a corrupt or partial one is
        skipped with a warning and counted."""
        if not self.spec.resume:
            return None
        with telemetry.span("checkpoint:restore"):
            for _step, path in reversed(self._step_dirs()):
                try:
                    state = self._load(path)
                except (CheckpointError, ValueError, OSError) as e:
                    # ModelLoadError is a ValueError; OSError covers a
                    # half-deleted directory
                    telemetry.counter("checkpoint.corrupt").inc()
                    logger.warning("skipping corrupt checkpoint %s: %s", path, e)
                    continue
                telemetry.counter("checkpoint.restores").inc()
                logger.info("resuming from checkpoint %s (step %d)", path, state.step)
                return state
        return None


class GracefulStop:
    """SIGTERM/SIGINT -> a cooperative stop flag. The first signal asks the
    loop to finish its step, write a final checkpoint and raise
    ``TrainingInterrupted``; a second one exits at once with
    ``hard_exit_code`` (75), abandoning the checkpoint being written (its
    ``.tmp-`` directory is skipped on restore). Handlers install only in the
    main thread."""

    def __init__(self, hard_exit_code: int = 75):
        self.requested = False
        self.signum: Optional[int] = None
        self.hard_exit_code = hard_exit_code
        self._installed = False

    def install(self, signums=(signal.SIGTERM, signal.SIGINT)) -> "GracefulStop":
        for s in signums:
            signal.signal(s, self._handle)
        self._installed = True
        return self

    def _handle(self, signum, frame):
        if self.requested:
            # async-signal-safe only: a raw write and _exit, no logging
            try:
                os.write(2, b"second signal during graceful stop: hard exit "
                         + str(self.hard_exit_code).encode()
                         + b" (in-flight checkpoint write abandoned; its .tmp directory is "
                         b"skipped on restore)\n")
            except OSError:
                pass
            os._exit(self.hard_exit_code)
        self.requested = True
        self.signum = signum
        logger.warning("received signal %d: finishing current step, then writing a final "
                       "checkpoint and exiting", signum)

    def __call__(self) -> bool:
        """The stop predicate, passed as ``should_stop=``."""
        return self.requested
