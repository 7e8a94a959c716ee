"""Checkpoint and resume for coordinate descent and for streamed random
effects: atomic snapshots, fallback past corrupt checkpoints, and the
graceful-stop handshake.

Counterpart of ``photon_ml_tpu/game/checkpoint.py``, with its layouts,
manifest keys and format versions, so a checkpoint written by either
package restores in the other::

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

Restored models are loaded onto ``device`` (the fit's).

A streamed fit (``game/streaming.py``) checkpoints at chunk boundaries
(``StreamingCheckpointManager``, :478-1184): ``chunk-<next chunk>/`` holds
the coefficient table as ``coefficients-NNNN.npy`` (and the variances as
``variances-NNNN.npy``), one file per device block of a mesh table, and a
manifest of ``"kind": "streaming"``, with each payload file's row range,
the writing run's sharding (the mesh axes and spec, :396-412; none on one
device) and environment (``backend`` "cuda" or "cpu", the device count).
The same atomic assembly, keep-last-K retention and restore past corrupt
directories apply; ``open_for_restore`` opens a directory read-only.
``restore_placed`` puts the table on one device or re-slices it over the
caller's mesh (:461-494), whatever mesh wrote it; ``elastic`` says the two
differ. ``restore_row_range`` reads one block of rows off the shard files
(:1098-1141, a serving-fleet member's slice). A coordinate-descent fit on a
mesh gathers its owners' tables only to save them, so its step checkpoints
restore onto the caller's mesh. In a fleet of processes the streaming save
is coordinated (:645-830): each member writes the blocks it holds
(``coefficients-p<pid>-NNNN.npy``) and its own manifest, and process 0
certifies the checkpoint with the quorum manifest once every member's has
landed and the blocks cover the table; ``restore_placed`` re-slices the
newest certified checkpoint onto whatever fleet restores it.

The atomic protocol's phases are fault points (``checkpoint.save.before_tmp``,
``.before_manifest``, ``.before_rename``, ``.after_rename``: the write-path set
the crash matrix kills at), as are the manifest read on restore and a member's
manifest in a coordinated save (``checkpoint.peer_manifest``). Each save sets
the reference's gauges: ``checkpoint.last_save_ts`` (on the tracer's
timebase, which the heartbeat turns into the checkpoint's age), a step
checkpoint's ``checkpoint.last_step``, and a streamed one's
``checkpoint.max_shard_fetch_bytes`` (the largest single block fetched to
the host: a sharded table is never gathered whole).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import signal
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.parallel.sharding import EntityShards
from photon_ml_tpu_torch.utils.atomic import atomic_write_json, fsync_dir

logger = logging.getLogger("photon_ml_tpu_torch.game.checkpoint")

_MANIFEST_FILE = "manifest.json"
_FORMAT_VERSION = 1
#: streaming manifests: 2 = payload files by row range + sharding and
#: environment records; 1 = the legacy single coefficients.npy
_STREAM_FORMAT_VERSION = 2
_STEP_RE = re.compile(r"^step-(\d{8})$")
_CHUNK_RE = re.compile(r"^chunk-(\d{8})$")

# The atomic-write protocol's crash seams, one per phase: the crash matrix
# (tools/chaos.py) kills a fit at each and checks that the resumed fit ends
# on the uninterrupted one's bits. The step and streaming managers share
# them: the protocol is the same.
_FP_SAVE_BEFORE_TMP = faults.register_point(
    "checkpoint.save.before_tmp", write_path=True,
    description="before the .tmp- sibling is assembled (no trace on disk)",
)
_FP_SAVE_BEFORE_MANIFEST = faults.register_point(
    "checkpoint.save.before_manifest", write_path=True,
    description="payload written, manifest absent (tmp dir incomplete)",
)
_FP_SAVE_BEFORE_RENAME = faults.register_point(
    "checkpoint.save.before_rename", write_path=True,
    description="tmp dir complete but not yet renamed into place",
)
_FP_SAVE_AFTER_RENAME = faults.register_point(
    "checkpoint.save.after_rename", write_path=True,
    description="checkpoint durable; retention/fsync not yet run",
)
_FP_MANIFEST_READ = faults.register_point(
    "checkpoint.manifest.read",
    description="manifest open/parse during restore (corrupt-skip path)",
)
# a coordinated (multi-process) save adds one seam: a member dying between
# its shard payloads and its per-process manifest leaves the quorum
# incomplete, and process 0 must abandon the checkpoint uncertified
_FP_PEER_MANIFEST = faults.register_point(
    "checkpoint.peer_manifest", distributed=True,
    description="before a member writes its per-process shard manifest "
    "during a coordinated save",
)


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


class _RowRangeError(CheckpointError):
    """A member row range outside a streamed checkpoint's table."""


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """Save after every ``every`` completed (iteration, coordinate) steps (a
    stop always saves); keep the newest ``keep_last``. ``resume=False`` is a
    fresh fit into the directory: its checkpoints are cleared. The
    ``quorum_timeout_s`` bounds every wait of a coordinated (multi-process)
    streaming save."""

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
            faults.fault_point(_FP_SAVE_BEFORE_TMP)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            # a mesh fit's owner-kept tables are joined only here, to be saved
            save_game_model(state.model.gathered(), os.path.join(tmp, "model"))
            if state.best_model is not None:
                save_game_model(state.best_model.gathered(), os.path.join(tmp, "best"))
            faults.fault_point(_FP_SAVE_BEFORE_MANIFEST)
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
            faults.fault_point(_FP_SAVE_BEFORE_RENAME)
            if os.path.exists(final):  # a step saved again (a resume's overlap)
                shutil.rmtree(final)
            os.rename(tmp, final)
            faults.fault_point(_FP_SAVE_AFTER_RENAME)
            fsync_dir(self.spec.directory)
        telemetry.counter("checkpoint.saves").inc()
        telemetry.gauge("checkpoint.last_step").set(state.step)
        telemetry.gauge("checkpoint.last_save_ts").set(telemetry.trace.TRACER.now())
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
            faults.fault_point(_FP_MANIFEST_READ)
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


# ---------------------------------------------------------------------------
# streamed-fit checkpoints (chunk-boundary granularity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamCheckpointState:
    """What a streamed random-effect fit needs to go on: the next chunk to
    solve (the deterministic chunk order replays the stream from there) and
    the tables so far, ``[N, K]`` tensors or numpy arrays."""

    next_chunk: int
    coefficients: "object"
    variances: Optional["object"] = None


@dataclasses.dataclass
class ElasticRestore:
    """A streaming checkpoint placed for this run: tensors on one device, or
    ``EntityShards`` over the caller's mesh. ``elastic`` is True when the
    writing run split the table over another number of shards."""

    next_chunk: int
    coefficients: object
    variances: Optional[object]
    saved_sharding: Optional[dict]
    saved_env: Optional[dict]
    elastic: bool


def _environment_record(device: Optional[torch.device] = None) -> dict:
    """The decode and device environment a streaming checkpoint was written
    under, so a restore under another can report the difference."""
    backend = "cuda" if device is None or device.type == "cuda" else "cpu"
    count = torch.cuda.device_count() if backend == "cuda" else 1
    return {"no_native": os.environ.get("PHOTON_NO_NATIVE") == "1", "backend": backend,
            "device_count": int(count)}


def _wait_until(predicate, timeout_s: float, poll_s: float = 0.05) -> bool:
    """Poll ``predicate`` until it holds or ``timeout_s`` passes: the
    filesystem rendezvous's barrier, bounded so a dead peer never hangs a
    save."""
    deadline = time.monotonic() + timeout_s
    while True:
        if predicate():
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(poll_s)


class StreamingCheckpointManager:
    """Atomic chunk-boundary checkpoints of a streamed table fit: assembled
    in a ``.tmp-`` sibling with the manifest written last, renamed into
    place, newest-valid restore past corrupt directories, keep-last-K
    retention. ``read_only`` (``open_for_restore``) never creates, clears or
    writes."""

    def __init__(self, spec: CheckpointSpec, read_only: bool = False):
        self.spec = spec
        self.read_only = read_only
        if read_only:
            # a typo'd directory is an error, not a fresh empty one
            if not os.path.isdir(spec.directory):
                raise CheckpointError(f"no streamed checkpoint directory at {spec.directory}")
            return
        os.makedirs(spec.directory, exist_ok=True)
        if not spec.resume:
            stale = self._chunk_dirs()
            if stale:
                logger.warning("resume=False: clearing %d existing streaming checkpoint(s) "
                               "under %s", len(stale), spec.directory)
            for _c, path in stale:
                shutil.rmtree(path, ignore_errors=True)

    @classmethod
    def open_for_restore(cls, directory: str) -> "StreamingCheckpointManager":
        """A read-only manager over an existing directory (the path to
        serving): ``save`` refuses."""
        return cls(CheckpointSpec(directory=directory), read_only=True)

    def should_save(self, chunk_index: int) -> bool:
        return (chunk_index + 1) % self.spec.every == 0

    @staticmethod
    def _write_table(tmp: str, prefix: str, array) -> list[dict]:
        """``array`` as one payload file per device block this process holds
        (one for a table on one device), fetched one block at a time."""
        blocks = [(0, array)] if not isinstance(array, EntityShards) else array.local_blocks()
        out = []
        max_bytes = 0
        for i, (row_start, part) in enumerate(blocks):
            data = (part.detach().cpu().numpy() if isinstance(part, torch.Tensor)
                    else np.asarray(part))
            fname = f"{prefix}-{i:04d}.npy"
            np.save(os.path.join(tmp, fname), data)
            telemetry.counter("checkpoint.shard_saves").inc()
            max_bytes = max(max_bytes, int(data.nbytes))
            out.append({"file": fname, "row_start": int(row_start), "rows": int(data.shape[0])})
        telemetry.gauge("checkpoint.max_shard_fetch_bytes").set(max_bytes)
        return out

    def save(self, state: StreamCheckpointState) -> Optional[str]:
        """Write ``state`` as ``chunk-<next_chunk>`` and return its path. In a
        fleet of processes this is the coordinated save (every member calls
        it at the same boundary), which returns None when the quorum never
        formed: the directory stays uncertified and restore passes it by."""
        if self.read_only:
            raise CheckpointError(
                f"checkpoint manager over {self.spec.directory} is read-only "
                "(open_for_restore): serving must not write into a training run's "
                "checkpoint history")
        from photon_ml_tpu_torch.parallel import multihost

        if multihost.is_multiprocess():
            return self._save_coordinated(state, multihost.process_index(),
                                          multihost.process_count())
        name = f"chunk-{state.next_chunk:08d}"
        final = os.path.join(self.spec.directory, name)
        tmp = os.path.join(self.spec.directory, f".tmp-{name}")
        coeffs = state.coefficients
        num_entities, dim = (int(d) for d in coeffs.shape)
        sharded = isinstance(coeffs, EntityShards)
        first = coeffs.parts[0] if sharded else coeffs
        device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")
        with telemetry.span("checkpoint:save", next_chunk=state.next_chunk):
            faults.fault_point(_FP_SAVE_BEFORE_TMP)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            shard_files = self._write_table(tmp, "coefficients", coeffs)
            variance_files = None
            if state.variances is not None:
                variance_files = self._write_table(tmp, "variances", state.variances)
            faults.fault_point(_FP_SAVE_BEFORE_MANIFEST)
            # the manifest lands last: its presence certifies the directory
            atomic_write_json(os.path.join(tmp, _MANIFEST_FILE), {
                "format_version": _STREAM_FORMAT_VERSION,
                "kind": "streaming",
                "next_chunk": int(state.next_chunk),
                "num_entities": num_entities,
                "dim": dim,
                "dtype": str(np.dtype(str(coeffs.dtype).replace("torch.", ""))),
                "shards": shard_files,
                "variance_shards": variance_files,
                "sharding": coeffs.sharding_record() if sharded else None,
                "env": _environment_record(device),
            }, indent=2, sort_keys=True)
            faults.fault_point(_FP_SAVE_BEFORE_RENAME)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            faults.fault_point(_FP_SAVE_AFTER_RENAME)
            fsync_dir(self.spec.directory)
        telemetry.counter("checkpoint.saves").inc()
        telemetry.gauge("checkpoint.last_save_ts").set(telemetry.trace.TRACER.now())
        self._apply_retention()
        return final

    @staticmethod
    def _peer_manifest_name(pid: int) -> str:
        return f"manifest.proc-{pid:04d}.json"

    def _save_coordinated(self, state: StreamCheckpointState, pid: int,
                          nproc: int) -> Optional[str]:
        """The multi-process save (:645-830): every member writes the blocks
        it holds and its own manifest into a shared ``.tmp-`` directory;
        process 0 writes the quorum manifest (``manifest.json``) only after
        every peer's manifest has landed, checks that the merged blocks cover
        [0, N) once and that every payload named is on disk, then renames the
        directory into place. A member lost mid-save leaves the directory
        uncertified (``checkpoint.quorum_timeouts``). The rendezvous is the
        shared filesystem alone, and every wait is bounded by
        ``spec.quorum_timeout_s``."""
        name = f"chunk-{state.next_chunk:08d}"
        final = os.path.join(self.spec.directory, name)
        tmp = os.path.join(self.spec.directory, f".tmp-{name}")
        rendezvous = os.path.join(tmp, "rendezvous.json")
        timeout = self.spec.quorum_timeout_s
        coeffs = state.coefficients
        dim = int(coeffs.shape[1])
        with telemetry.span("checkpoint:save", next_chunk=state.next_chunk, coordinated=True):
            faults.fault_point(_FP_SAVE_BEFORE_TMP)
            if pid == 0:
                if os.path.exists(tmp):
                    # debris of a crashed earlier save of this chunk: moved
                    # aside in one rename, so a peer never takes it for this
                    # rendezvous
                    trash = os.path.join(self.spec.directory, f".trash-{name}")
                    shutil.rmtree(trash, ignore_errors=True)
                    os.rename(tmp, trash)
                    shutil.rmtree(trash, ignore_errors=True)
                os.makedirs(tmp)
                atomic_write_json(rendezvous, {"num_processes": nproc,
                                               "next_chunk": int(state.next_chunk)})
            else:
                def rendezvous_matches() -> bool:
                    # its content, not its existence: a stale rendezvous of an
                    # abandoned save (or of another fleet size replaying this
                    # chunk) must not lure a member into a directory process 0
                    # is about to remove
                    try:
                        with open(rendezvous, encoding="utf-8") as fh:
                            doc = json.load(fh)
                    except (OSError, ValueError):
                        return False
                    return (doc.get("num_processes") == nproc
                            and doc.get("next_chunk") == int(state.next_chunk))

                if not _wait_until(rendezvous_matches, timeout):
                    telemetry.counter("checkpoint.quorum_timeouts").inc()
                    logger.warning("coordinated save %s: no matching rendezvous from process 0 "
                                   "within %.1fs; abandoning (uncertified)", name, timeout)
                    return None
            shard_files = self._write_table(tmp, f"coefficients-p{pid:04d}", coeffs)
            variance_files = None
            if state.variances is not None:
                variance_files = self._write_table(tmp, f"variances-p{pid:04d}",
                                                   state.variances)
            faults.fault_point(_FP_PEER_MANIFEST)
            # this member's manifest lands last: it certifies its blocks
            atomic_write_json(os.path.join(tmp, self._peer_manifest_name(pid)), {
                "process_id": pid, "num_processes": nproc,
                "next_chunk": int(state.next_chunk), "shards": shard_files,
                "variance_shards": variance_files})
            telemetry.counter("checkpoint.peer_manifests").inc()
            if pid != 0:
                # certified (renamed) or abandoned: process 0 decides
                _wait_until(lambda: os.path.exists(final) or not os.path.exists(tmp), timeout)
                if os.path.exists(final):
                    telemetry.counter("checkpoint.saves").inc()
                    return final
                telemetry.counter("checkpoint.quorum_timeouts").inc()
                logger.warning("coordinated save %s was never certified by process 0", name)
                return None
            peer_paths = [os.path.join(tmp, self._peer_manifest_name(p)) for p in range(nproc)]
            if not _wait_until(lambda: all(os.path.exists(p) for p in peer_paths), timeout):
                missing = [p for p, path in enumerate(peer_paths) if not os.path.exists(path)]
                telemetry.counter("checkpoint.quorum_timeouts").inc()
                logger.warning("coordinated save %s: peer manifest(s) of process(es) %s never "
                               "landed within %.1fs; abandoning uncertified (restore passes "
                               "it by)", name, missing, timeout)
                return None
            merged, merged_var = [], []
            for path in peer_paths:
                with open(path, encoding="utf-8") as fh:
                    peer = json.load(fh)
                merged.extend(peer["shards"])
                merged_var.extend(peer.get("variance_shards") or ())
            merged.sort(key=lambda d: int(d["row_start"]))
            merged_var.sort(key=lambda d: int(d["row_start"]))
            # the merged blocks define the table: certify only a cover of
            # [0, N) without gap or overlap
            num_entities = 0
            for d in merged:
                if int(d["row_start"]) != num_entities:
                    telemetry.counter("checkpoint.quorum_cover_violations").inc()
                    logger.warning("coordinated save %s: the merged blocks do not cover the "
                                   "entities contiguously (gap or overlap at row %d); "
                                   "abandoning uncertified", name, num_entities)
                    return None
                num_entities += int(d["rows"])
            # every payload a peer names must be on disk (a peer that raced
            # into a stale directory lost its blocks with it)
            missing_payload = [d["file"] for d in (*merged, *merged_var)
                               if not os.path.exists(os.path.join(tmp, d["file"]))]
            if missing_payload:
                telemetry.counter("checkpoint.quorum_cover_violations").inc()
                logger.warning("coordinated save %s: peer manifest(s) name payload file(s) "
                               "missing from the save directory (%s); abandoning uncertified",
                               name, missing_payload)
                return None
            first = coeffs.local_blocks()[0][1] if isinstance(coeffs, EntityShards) else coeffs
            device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")
            faults.fault_point(_FP_SAVE_BEFORE_MANIFEST)
            # the quorum manifest: the only certification restore reads
            atomic_write_json(os.path.join(tmp, _MANIFEST_FILE), {
                "format_version": _STREAM_FORMAT_VERSION,
                "kind": "streaming",
                "next_chunk": int(state.next_chunk),
                "num_entities": num_entities,
                "dim": dim,
                "dtype": str(np.dtype(str(coeffs.dtype).replace("torch.", ""))),
                "shards": merged,
                "variance_shards": merged_var or None,
                "sharding": (coeffs.sharding_record() if isinstance(coeffs, EntityShards)
                             else None),
                "env": _environment_record(device),
                "quorum": {"num_processes": nproc},
            }, indent=2, sort_keys=True)
            faults.fault_point(_FP_SAVE_BEFORE_RENAME)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            faults.fault_point(_FP_SAVE_AFTER_RENAME)
            fsync_dir(self.spec.directory)
        telemetry.counter("checkpoint.saves").inc()
        telemetry.gauge("checkpoint.last_save_ts").set(telemetry.trace.TRACER.now())
        self._apply_retention()
        return final

    def _apply_retention(self) -> None:
        for _c, path in self._chunk_dirs()[: -self.spec.keep_last]:
            shutil.rmtree(path, ignore_errors=True)
        for name in os.listdir(self.spec.directory):
            if name.startswith((".tmp-chunk-", ".trash-chunk-")):
                shutil.rmtree(os.path.join(self.spec.directory, name), ignore_errors=True)

    def _chunk_dirs(self) -> list[tuple[int, str]]:
        """(next chunk, path) of every chunk directory, oldest first."""
        out = []
        for name in os.listdir(self.spec.directory):
            m = _CHUNK_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.spec.directory, name)))
        return sorted(out)

    @staticmethod
    def _read_manifest(path: str) -> dict:
        manifest_path = os.path.join(path, _MANIFEST_FILE)
        try:
            faults.fault_point(_FP_MANIFEST_READ)
            with open(manifest_path) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise CheckpointError(f"{path}: incomplete checkpoint (no manifest)") from None
        except ValueError as e:
            raise CheckpointError(f"{manifest_path}: corrupt manifest ({e})") from None
        version = manifest.get("format_version")
        if version not in (1, _STREAM_FORMAT_VERSION):
            raise CheckpointError(f"{manifest_path}: unsupported format_version {version!r}")
        if manifest.get("kind") != "streaming":
            raise CheckpointError(f"{manifest_path}: not a streaming checkpoint "
                                  f"(kind={manifest.get('kind')!r})")
        return manifest

    @classmethod
    def _read_table(cls, path: str, manifest: dict, prefix: str) -> Optional[np.ndarray]:
        """The table of ``prefix`` as an owned host array; None when the
        manifest lists no variances."""
        read_rows = cls._row_reader(path, manifest, prefix)
        if read_rows is None:
            return None
        rows = read_rows(0, int(manifest["num_entities"]))
        # an owned array, never a view of the memory map
        return np.array(rows) if isinstance(rows, np.memmap) else rows

    @staticmethod
    def _row_reader(path: str, manifest: dict, prefix: str):
        """``read_rows(lo, hi)`` over the memory-mapped payload files of
        ``prefix``, which must cover [0, num_entities) in order (checked up
        front, so a corrupt directory is skipped before anything is read);
        None when the manifest lists no variances."""
        n, dim = int(manifest["num_entities"]), int(manifest["dim"])
        if manifest.get("format_version") == 1:
            if prefix == "variances" and not manifest.get("has_variances"):
                return None
            descriptors = [{"file": f"{prefix}.npy", "row_start": 0, "rows": n}]
        else:
            descriptors = manifest.get("shards" if prefix == "coefficients"
                                       else "variance_shards")
            if descriptors is None:
                if prefix == "variances":
                    return None
                raise CheckpointError(f"{path}: manifest lists no shards")
        files, cursor = [], 0
        for d in descriptors:
            if int(d["row_start"]) != cursor:
                raise CheckpointError(f"{path}: shard rows are not contiguous at "
                                      f"{d['row_start']} (expected {cursor})")
            fpath = os.path.join(path, d["file"])
            try:
                arr = np.load(fpath, mmap_mode="r")
            except (OSError, ValueError) as e:
                raise CheckpointError(f"{fpath}: unreadable shard ({e})") from None
            if arr.shape != (int(d["rows"]), dim):
                raise CheckpointError(f"{fpath}: shard shape {arr.shape} does not match its "
                                      f"manifest entry ({d['rows']}, {dim})")
            files.append((cursor, arr))
            cursor += int(d["rows"])
        if cursor != n:
            raise CheckpointError(f"{path}: shards cover {cursor} rows but the manifest "
                                  f"promises {n} entities")

        def read_rows(lo: int, hi: int) -> np.ndarray:
            pieces = [arr[max(lo - start, 0):hi - start] for start, arr in files
                      if start < hi and start + arr.shape[0] > lo]
            if not pieces:
                return np.zeros((0, dim), files[0][1].dtype if files else np.float32)
            return np.concatenate(pieces, axis=0) if len(pieces) != 1 else pieces[0]

        return read_rows

    def _newest(self, load):
        """``load(path, manifest)`` of the newest valid checkpoint, skipping
        corrupt ones (``checkpoint.corrupt``); (path, result) or None."""
        if not self.spec.resume:
            return None
        with telemetry.span("checkpoint:restore"):
            for _c, path in reversed(self._chunk_dirs()):
                try:
                    got = load(path, self._read_manifest(path))
                except _RowRangeError:
                    raise  # a fleet-sizing error, not corruption
                except (CheckpointError, ValueError, OSError) as e:
                    telemetry.counter("checkpoint.corrupt").inc()
                    logger.warning("skipping corrupt checkpoint %s: %s", path, e)
                    continue
                telemetry.counter("checkpoint.restores").inc()
                logger.info("resuming streamed fit from %s", path)
                return path, got
        return None

    def restore(self) -> Optional[StreamCheckpointState]:
        """The newest valid checkpoint with its tables as host arrays, or
        None."""
        def load(path, manifest):
            return StreamCheckpointState(
                next_chunk=int(manifest["next_chunk"]),
                coefficients=self._read_table(path, manifest, "coefficients"),
                variances=self._read_table(path, manifest, "variances"))

        found = self._newest(load)
        return None if found is None else found[1]

    def restore_row_range(self, lo: int, hi: int) -> Optional[np.ndarray]:
        """Entity rows ``[lo, hi)`` of the newest valid checkpoint's
        coefficient table as an owned host array, read off the memory-mapped
        shard files alone: a serving-fleet member reads exactly its slice.
        A range outside the table raises (a fleet-sizing error, which every
        older checkpoint would repeat); None when no valid checkpoint
        exists."""
        lo, hi = int(lo), int(hi)

        def load(path, manifest):
            n = int(manifest["num_entities"])
            if not 0 <= lo <= hi <= n:
                raise _RowRangeError(f"{path}: member row range [{lo}, {hi}) outside the "
                                     f"{n}-entity table")
            # an owned copy, never a view of the memory map
            return np.array(self._row_reader(path, manifest, "coefficients")(lo, hi), copy=True)

        found = self._newest(load)
        return None if found is None else found[1]

    def restore_placed(self, mesh=None, axis: Optional[str] = None,
                       device: torch.device | str | None = None) -> Optional[ElasticRestore]:
        """The newest valid checkpoint with its tables on ``device`` (default
        cuda), or with ``mesh`` split over its model axis (``axis``), one
        block per device, whatever mesh wrote it. A table that does not
        divide over the target axis raises ``ElasticPlacementError`` (a
        configuration error, so no older checkpoint is tried)."""
        from photon_ml_tpu_torch.device import resolve_device
        from photon_ml_tpu_torch.parallel.sharding import model_axis, place_entity_rows

        dev = None if mesh is not None else resolve_device(device)

        def load(path, manifest):
            # the payload files' readers, checked up front: each device's
            # block (a fleet member's blocks only) is read off them alone
            return (manifest, self._row_reader(path, manifest, "coefficients"),
                    self._row_reader(path, manifest, "variances"))

        found = self._newest(load)
        if found is None:
            return None
        path, (manifest, coeffs, variances) = found
        saved_sharding, saved_env = manifest.get("sharding"), manifest.get("env")
        saved_shards = 1
        spec = [a for a in ((saved_sharding or {}).get("spec") or []) if a]
        if spec:
            saved_shards = int(((saved_sharding or {}).get("mesh_axes") or {}).get(spec[0], 1))
        target_shards = 1
        if mesh is not None:
            resolved = axis or model_axis(mesh)
            target_shards = int(mesh.shape[resolved]) if resolved else 1

        dtype = np.dtype(manifest.get("dtype", "float32"))

        def placed(read_rows):
            if read_rows is None:
                return None
            return place_entity_rows(read_rows, int(manifest["num_entities"]),
                                     (int(manifest["dim"]),), dtype, mesh=mesh, axis=axis,
                                     device=dev)

        coefficients, variances = placed(coeffs), placed(variances)
        elastic = saved_shards != target_shards
        if elastic:
            telemetry.counter("recovery.elastic_resumes").inc()
            logger.warning("elastic resume: %s was written across %d shard(s), restoring "
                           "across %d", path, saved_shards, target_shards)
        return ElasticRestore(
            next_chunk=int(manifest["next_chunk"]), coefficients=coefficients,
            variances=variances, saved_sharding=saved_sharding, saved_env=saved_env,
            elastic=elastic)
