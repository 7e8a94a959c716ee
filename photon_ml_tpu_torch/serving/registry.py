"""Hot-swappable model registry: watch a versioned models directory, swap
to the newest valid version in the background, never downgrade, never
serve a partial write.

Counterpart of ``photon_ml_tpu/serving/registry.py``, with the same layout,
so a version either package publishes loads in the other. Versions load
through the port's ``data/model_store.py`` onto ``device`` (default cuda).

Layout (one directory per published version)::

    <registry_dir>/
      v-00000001/
        model-metadata.json         written LAST (completeness certificate)
        feature-indexes/<shard>/    REQUIRED: the pinned training feature
                                    space (versions without it are refused
                                    outright — the silent-wrong-scores
                                    hazard of rebuilding indices at serve
                                    time)
        fixed-effect/... random-effect/...
      v-00000002/
      .tmp-v-00000003/              in-flight publish (ignored by scans)

Atomicity follows ``game/checkpoint.py``: :func:`publish_version`
assembles a ``.tmp-v-*`` sibling (index maps first, then the model store
save, whose metadata lands last) and ``os.rename``s it into place, so a
scanner never observes a partial version. :meth:`ModelRegistry.refresh`
walks versions NEWEST-first, skips corrupt/partial/unloadable ones with a
warning + ``serving.skipped_versions`` counter (exactly the checkpoint
restore fallback), builds + warms the engine OFF the request path, and
only then swaps the engine reference — in-flight requests finish on the
old engine, which the swap never mutates.

Telemetry: ``serving.model_swaps`` counter, ``serving.model_version``
gauge, ``serving.skipped_versions`` and ``serving.version_retries``
counters (the latter = transient-IO load retries; see
:meth:`ModelRegistry._load_version` for the transient/deterministic
failure split).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
from typing import Mapping, Optional

import torch

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.serving.engine import ScoringEngine
from photon_ml_tpu_torch.utils.atomic import fsync_dir

logger = logging.getLogger("photon_ml_tpu_torch.serving.registry")

# Injection seams: the background poll tick and the version load itself.
# An `io` rule at the load point is exactly the transient flaky-read shape
# the bounded retry absorbs (InjectedIOError IS an OSError).
_FP_REGISTRY_POLL = faults.register_point(
    "serving.registry.poll",
    description="background registry poll tick (refresh entry)",
)
_FP_REGISTRY_LOAD = faults.register_point(
    "serving.registry.load",
    description="one version's engine load (io action = transient read)",
)

_VERSION_RE = re.compile(r"^v-(\d{8})$")
_METADATA_FILE = "model-metadata.json"


def version_dirname(version: int) -> str:
    return f"v-{version:08d}"


def scan_versions(directory: str) -> list[tuple[int, str]]:
    """(version, path) for every published version, oldest first; tmp
    dirs and foreign names are ignored."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        m = _VERSION_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def champion_quality(directory: str) -> tuple[Optional[str], Optional[dict]]:
    """(version dirname, quality block) of the newest published version
    carrying recorded quality stats — the gate's champion. Versions
    without a quality block (pre-gate publishes, ungated nearline
    snapshots) are skipped, not treated as champions: a gate can only
    compare against error bars that were actually recorded."""
    from photon_ml_tpu_torch.data.model_store import load_game_model_metadata

    for v, path in reversed(scan_versions(directory)):
        try:
            meta = load_game_model_metadata(path) or {}
        except (OSError, ValueError):
            continue
        quality = (meta.get("extra") or {}).get("quality")
        if quality:
            return version_dirname(v), quality
    return None, None


def _assemble_version(
    directory: str, name: str, model, index_maps: Mapping, extra_metadata
) -> str:
    """Assemble a complete version directory under a ``.tmp-`` sibling
    and rename it to ``name`` — the atomic-publish protocol shared by
    accepted and quarantined versions."""
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.data.model_store import save_game_model

    final = os.path.join(directory, name)
    tmp = os.path.join(directory, ".tmp-" + name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for shard, imap in index_maps.items():
        if not isinstance(imap, IndexMap):
            imap = IndexMap(list(imap))
        imap.save(os.path.join(tmp, "feature-indexes", shard))
    # model-metadata.json lands last inside tmp (save_game_model order)
    save_game_model(model, tmp, extra_metadata=extra_metadata)
    os.rename(tmp, final)
    fsync_dir(directory)
    return final


def publish_version(
    directory: str,
    model,
    index_maps: Mapping,
    version: Optional[int] = None,
    extra_metadata: Optional[dict] = None,
    lineage: Optional[dict] = None,
    quality: Optional[dict] = None,
    gate_override: bool = False,
) -> str:
    """Atomically publish ``model`` as the next registry version.

    ``index_maps`` (shard name -> IndexMap or sequence of feature names)
    is REQUIRED: the registry refuses versions without a pinned feature
    space. The version directory is assembled in a ``.tmp-v-*`` sibling
    and renamed into place — watchers see the complete version or nothing.

    ``lineage`` (optional): a JSON-safe training-ancestry record
    (``base_version``, ``warm_start_checkpoint``, delta digest) stored
    under the metadata
    ``"lineage"`` key; the loaded engine carries it and ``/healthz``
    serves it, so a running version is traceable to the checkpoint and
    delta that produced it.

    ``quality`` (optional) arms the champion/challenger gate: a JSON
    block with the candidate's :class:`photon_ml_tpu_torch.quality.gate
    .QualityStats` fields (plus any bootstrap summaries). The candidate
    is compared against the newest published version with recorded
    stats; a candidate that regresses beyond the champion's bootstrap
    CI is assembled under ``quarantined-v-*`` (invisible to version
    scans, evidence preserved) and :class:`QualityGateRefused` is
    raised. The decision — publish, quarantine, or ``gate_override``
    bypass — is recorded in the metadata quality block AND in lineage
    (``quality_gate``), so ``/healthz`` serves it. ``quality=None``
    publishes ungated (back-compat; the nearline snapshot path).
    """
    if not index_maps:
        raise ValueError(
            "index_maps is required: a served version must pin the training "
            "feature space next to its coefficients"
        )
    decision = None
    if quality is not None:
        from photon_ml_tpu_torch.quality.gate import (
            FP_PUBLISH_GATE,
            QualityGateRefused,
            QualityStats,
            decide_gate,
        )

        champ_version, champ_quality = champion_quality(directory)
        # the seam sits AFTER candidate stats and champion lookup but
        # BEFORE any write: a hard kill here must leave the registry
        # exactly as it was
        faults.fault_point(FP_PUBLISH_GATE)
        decision = decide_gate(
            QualityStats.from_json(quality),
            champ_quality,
            champ_version,
            override=gate_override,
        )
        telemetry.counter(f"quality.gate_{decision.decision}").inc()
        extra_metadata = dict(extra_metadata or {})
        extra_metadata["quality"] = {
            **dict(quality), "gate": decision.to_json(),
        }
        if lineage is not None:
            lineage = dict(lineage)
            lineage["quality_gate"] = decision.to_json()
    if lineage is not None:
        extra_metadata = dict(extra_metadata or {})
        extra_metadata["lineage"] = dict(lineage)
    os.makedirs(directory, exist_ok=True)
    if version is None:
        existing = scan_versions(directory)
        version = existing[-1][0] + 1 if existing else 1
    final = os.path.join(directory, version_dirname(version))
    if os.path.exists(final):
        raise FileExistsError(f"version already published: {final}")
    if decision is not None and decision.decision == "quarantined":
        # park the refused candidate under a name version scans ignore:
        # the evidence (model + stats + decision) survives for offline
        # diagnosis, but no server will ever load it; repeated refusals
        # of the same slot keep the latest evidence
        stale = os.path.join(
            directory, "quarantined-" + version_dirname(version)
        )
        if os.path.exists(stale):
            shutil.rmtree(stale)
        qpath = _assemble_version(
            directory,
            "quarantined-" + version_dirname(version),
            model,
            index_maps,
            extra_metadata,
        )
        logger.warning(
            "quality gate quarantined candidate version %d: %s",
            version,
            decision.reason,
        )
        raise QualityGateRefused(decision, quarantine_path=qpath)
    return _assemble_version(
        directory, version_dirname(version), model, index_maps,
        extra_metadata,
    )


class ModelRegistry:
    """Background-refreshed source of the current :class:`ScoringEngine`."""

    def __init__(
        self,
        directory: str,
        max_batch: int = 64,
        max_row_nnz: int = 128,
        poll_interval: float = 2.0,
        warm: bool = True,
        load_retries: int = 2,
        retry_backoff_s: float = 0.1,
        mesh=None,
        entity_axis: Optional[str] = None,
        device: torch.device | str | None = None,
    ):
        self.directory = directory
        # every version loads onto this device (default cuda), or over mesh
        self.device = mesh.first_device if mesh is not None else resolve_device(device)
        self.max_batch = max_batch
        self.max_row_nnz = max_row_nnz
        self.poll_interval = poll_interval
        self.warm = warm
        # serve every loaded version ENTITY-SHARDED over this mesh (the
        # engine's mesh= path); hot swaps re-place the new version's
        # tables with the same sharding, so a swap never degrades a
        # sharded deployment to replicated
        self.mesh = mesh
        self.entity_axis = entity_axis
        # transient-IO retry budget per version load (a half-synced NFS
        # dir, a flaky read): retries back off retry_backoff_s * 2**k and
        # count serving.version_retries
        self.load_retries = load_retries
        self.retry_backoff_s = retry_backoff_s
        self._engine: Optional[ScoringEngine] = None
        self._version = -1
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (path -> mtime) of versions that failed DETERMINISTIC validation
        # (bad metadata, unservable model type): a persistently corrupt
        # newest version is skipped silently on later polls instead of
        # re-reading/re-warning every interval; retried when it changes.
        # Transient IO errors are deliberately NOT recorded here — one
        # flaky read must not mark a good version skipped forever.
        self._skipped: dict[str, float] = {}

    @property
    def engine(self) -> ScoringEngine:
        with self._lock:
            if self._engine is None:
                raise RuntimeError(
                    f"no valid model version loaded from {self.directory}"
                )
            return self._engine

    @property
    def current_version(self) -> Optional[str]:
        with self._lock:
            return self._engine.version if self._engine is not None else None

    # -- refresh -------------------------------------------------------------

    def refresh(self) -> bool:
        """Load the newest valid version newer than the current one.

        Walks newest-first and falls back past corrupt/partial/unloadable
        versions (missing metadata or feature-indexes, truncated npz,
        unsupported sub-model types) — the checkpoint-restore fallback.
        Returns True when a swap happened."""
        with self._lock:
            current = self._version
        for version, path in reversed(scan_versions(self.directory)):
            if version <= current:
                return False
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                mtime = -1.0
            if self._skipped.get(path) == mtime:
                continue  # known-bad and unchanged since the last attempt
            engine = self._load_version(version, path, mtime)
            if engine is None:
                continue
            with self._lock:
                self._skipped.pop(path, None)
                if version <= self._version:  # raced with another refresh
                    return False
                old = self._engine
                self._engine = engine
                self._version = version
            telemetry.counter("serving.model_swaps").inc()
            telemetry.gauge("serving.model_version").set(version)
            logger.info(
                "serving model version %s%s", engine.version,
                f" (replacing {old.version})" if old is not None else "",
            )
            return True
        return False

    def _load_version(
        self, version: int, path: str, mtime: float
    ) -> Optional[ScoringEngine]:
        """Load + warm one version, or None when it must be skipped.

        Failure handling distinguishes the two shapes a read can fail:

        - **transient IO** (``OSError``: a half-synced network dir, a
          flaky read) — retried up to ``load_retries`` times with
          exponential backoff (``serving.version_retries``); if it STILL
          fails, the version is skipped for this refresh only — the next
          poll retries from scratch, because one bad read must not pin a
          good version as skipped-by-mtime forever.
        - **deterministic validation** (``ValueError``/``TypeError``/
          ``KeyError``: corrupt metadata, unservable model type) — pinned
          in ``_skipped`` by mtime so later polls stop re-reading it
          until the directory changes.
        """
        last_transient: Optional[OSError] = None
        for attempt in range(self.load_retries + 1):
            try:
                faults.fault_point(_FP_REGISTRY_LOAD)
                engine = ScoringEngine.load(
                    path,
                    max_batch=self.max_batch,
                    max_row_nnz=self.max_row_nnz,
                    version=version_dirname(version),
                    mesh=self.mesh,
                    entity_axis=self.entity_axis,
                    device=None if self.mesh is not None else self.device,
                )
                if self.warm:
                    engine.warmup()
                return engine
            except OSError as e:
                last_transient = e
                if attempt < self.load_retries:
                    delay = self.retry_backoff_s * (2 ** attempt)
                    telemetry.counter("serving.version_retries").inc()
                    logger.warning(
                        "transient error loading model version %s "
                        "(attempt %d/%d, retrying in %.2fs): %s", path,
                        attempt + 1, self.load_retries + 1, delay, e,
                    )
                    if self._stop.wait(delay):
                        return None  # shutting down mid-backoff
            except (ValueError, TypeError, KeyError) as e:
                # ModelLoadError is a ValueError; TypeError an unservable
                # model. _skipped is shared with concurrent refresh()
                # callers (start() on the main thread vs the poll loop),
                # so its writes take the lock like every other registry
                # mutation
                with self._lock:
                    self._skipped[path] = mtime
                telemetry.counter("serving.skipped_versions").inc()
                logger.warning(
                    "skipping unusable model version %s: %s", path, e
                )
                return None
        telemetry.counter("serving.skipped_versions").inc()
        logger.warning(
            "model version %s still unreadable after %d attempt(s) — "
            "skipped for THIS refresh, retried next poll: %s", path,
            self.load_retries + 1, last_transient,
        )
        return None

    # -- background watcher --------------------------------------------------

    def start(self) -> "ModelRegistry":
        """Load the newest valid version NOW (raising if none exists) and
        start the background poll thread."""
        self.refresh()
        with self._lock:
            if self._engine is None:
                raise RuntimeError(
                    f"no valid model version under {self.directory}"
                )
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._poll_loop, name="model-registry", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                faults.fault_point(_FP_REGISTRY_POLL)
                self.refresh()
            except Exception:  # noqa: BLE001 — the watcher must survive
                logger.exception("model registry refresh failed")
