"""The freshness conductor: a supervised daemon over the three freshness
tiers (nearline, incremental, full retrain) under one cadence.

Counterpart of ``photon_ml_tpu/pipeline/conductor.py``, surfaced as ``cli
pipeline``. Each cycle:

1. tail the delta directory; ``delta_digest`` over the globbed shards
   detects new or changed content (an unchanged digest is an idle cycle: no
   read, no fit, no publish);
2. ``scan_delta`` the new shards against the base model's vocabularies;
3. decide the nearline-vs-delta reconciliation (``pipeline.reconcile``) and
   record it (:mod:`photon_ml_tpu_torch.pipeline.reconcile`, the
   retrain-wins-touched rule);
4. either run the masked incremental re-solve (``fit_incremental``, the
   touched lanes only) or, when the touched fraction or the count of cycles
   since the last full retrain trips a threshold, escalate
   (``pipeline.escalate``) to a full retrain into a fresh base generation
   under the workdir;
5. ``publish_incremental`` the result through the quality gate (its lineage
   carries the base checkpoint, the delta digest and the reconciliation
   record) and hot-swap the live ``ModelRegistry``;
6. observe each delta file's event-to-served staleness
   (``pipeline.staleness_s``) and set the gauge
   ``pipeline.event_to_served_staleness_p99_s``.

Every write of a cycle goes through the registry's assemble-then-rename or
into a fresh generation directory, and the base checkpoint is only read, so
a hard kill at any of the three ``pipeline.*`` seams leaves the base
byte-identical and the registry without a partial version
(``tools/chaos.py``'s pipeline matrix); a restarted daemon seeds its digest
cursor from the newest published lineage and redoes the interrupted cycle.

Supervision: live status through ``FleetStatusWriter`` (the conductor is a
1-member fleet; its heartbeat file, cycle counters and served version ride
the fleet-status document), counters ``pipeline.cycles``,
``pipeline.idle_cycles``, ``pipeline.reconciliations``,
``pipeline.escalations``, ``pipeline.publishes`` and ``pipeline.quarantines``
in ``telemetry.snapshot()`` (the run report's Pipeline section, ``cli pipeline
--report-out``), and SIGTERM: finish the current cycle, then exit 75.

``PipelineSpec.device`` (default cuda) is the port's one added field: the
reads, fits, scoring and the served registry all run there.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.config import parse_game_config
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.checkpoint import CheckpointSpec
from photon_ml_tpu_torch.game.estimator import GameEstimator
from photon_ml_tpu_torch.incremental import (
    delta_digest,
    load_warm_start,
    publish_incremental,
    scan_delta,
)
from photon_ml_tpu_torch.pipeline.reconcile import newest_version_metadata, reconcile_nearline
from photon_ml_tpu_torch.quality import QualityGateRefused

logger = logging.getLogger("photon_ml_tpu_torch.pipeline")

# plain seams (not write-path: the conductor never writes the base, and every
# registry write is behind incremental.publish's own seam); a hard kill at any
# of them leaves the base byte-identical and the registry without a partial
# version
FP_CYCLE_START = faults.register_point(
    "pipeline.cycle_start",
    description="top of a conductor cycle, before the delta poll is "
    "acted on — a kill here loses nothing (the cycle had no effects yet)",
)
FP_RECONCILE = faults.register_point(
    "pipeline.reconcile",
    description="before the nearline-vs-delta reconciliation decision "
    "is recorded — a kill here must not publish a version whose lineage "
    "lacks the decision",
)
FP_ESCALATE = faults.register_point(
    "pipeline.escalate",
    description="before an escalated full retrain begins — a kill here "
    "must leave the incumbent base generation intact and serving",
)


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static configuration of one :class:`FreshnessPipeline` run.

    ``config`` is a whole train-CLI config document: the conductor reuses
    the train driver's readers and estimator, so a cycle fits exactly what
    ``cli train`` would. ``base_dir`` is the warm-start base (a step
    checkpoint or a saved model directory); after an escalation the
    conductor re-bases onto the generation it trained under ``workdir``."""

    config: Mapping[str, Any]
    delta_dir: str
    base_dir: str
    registry_dir: str
    workdir: str
    interval_s: float = 5.0
    # 0 = run until stopped (SIGTERM); tests pin a count
    max_cycles: int = 0
    delta_glob: str = "*.avro"
    # escalation trips on EITHER threshold; escalate_after_cycles=0 disables
    # the count, escalate_touched_fraction >= 1.0 the fraction
    escalate_touched_fraction: float = 0.5
    escalate_after_cycles: int = 0
    # hot-swap a live ModelRegistry after each publish
    serve: bool = True
    status_file: Optional[str] = None
    status_port: Optional[int] = None
    heartbeat_deadline_s: float = 30.0
    # the champion/challenger publish gate: False still records the
    # candidate's stats but never quarantines
    quality_gate: bool = True
    bootstrap_samples: int = 32
    # where the cycles read, fit, score and serve (default cuda)
    device: Optional[str] = None


class FreshnessPipeline:
    """The conductor loop; one instance is one supervised daemon run."""

    def __init__(self, spec: PipelineSpec):
        if not spec.delta_dir:
            raise ValueError("PipelineSpec.delta_dir is required")
        if not spec.registry_dir:
            raise ValueError("PipelineSpec.registry_dir is required")
        self.spec = spec
        self.device = resolve_device(spec.device)
        # parsed now: a malformed config fails at start-up, not on the first
        # cycle that has work
        self._game_config = parse_game_config(spec.config)
        self._estimator = GameEstimator(self._game_config)
        self._base_dir = spec.base_dir
        # the index maps are pinned by the first cycle's combined read and
        # reused after it: the served feature space must not drift
        self._index_maps: Optional[Mapping] = None
        self._last_digest: Optional[str] = self._seed_digest()
        self._staleness: List[float] = []
        self._stop = threading.Event()
        self.cycle = 0
        self._cycles_since_full = 0
        self._published: List[str] = []
        self._quarantined: List[str] = []
        self._escalations = 0
        self._idle_cycles = 0
        self._reconciliations = 0
        self._registry = None
        self._status = None
        self._heartbeat = None
        self._last_p99: Optional[float] = None

    # -- cursor seeding ------------------------------------------------------

    def _seed_digest(self) -> Optional[str]:
        """The digest cursor from the newest published lineage, so a
        restarted conductor does not publish again the delta it served."""
        _, meta = newest_version_metadata(self.spec.registry_dir)
        lineage = ((meta or {}).get("extra") or {}).get("lineage") or {}
        return lineage.get("delta_digest")

    def _delta_paths(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.spec.delta_dir, self.spec.delta_glob)))

    # -- status --------------------------------------------------------------

    def _start_status(self) -> None:
        if self.spec.status_file is None and self.spec.status_port is None:
            return
        from photon_ml_tpu_torch.parallel.fleet_status import FleetStatusWriter
        from photon_ml_tpu_torch.parallel.multihost import HeartbeatWriter

        fleet_dir = os.path.join(self.spec.workdir, "fleet")
        os.makedirs(fleet_dir, exist_ok=True)
        self._status = FleetStatusWriter(
            fleet_dir, num_processes=1, heartbeat_deadline_s=self.spec.heartbeat_deadline_s,
            status_file=self.spec.status_file, port=self.spec.status_port).start()
        # the conductor is its own 1-member fleet: its heartbeat file makes
        # members["0"].alive true
        self._heartbeat = HeartbeatWriter(fleet_dir, 0).start()

    def _write_status(self, entry: Mapping[str, Any]) -> None:
        if self._status is None:
            return
        extras = dict(entry)
        extras.update(
            base_dir=self._base_dir,
            cycles_since_full=self._cycles_since_full,
            publishes=len(self._published),
            escalations=self._escalations,
            idle_cycles=self._idle_cycles,
            staleness_p99_s=self._last_p99,
            served_version=(self._registry.current_version
                            if self._registry is not None else None),
        )
        # the member's facts ride member_extras; generation doubles as the
        # cycle counter
        self._status.update(generation=self.cycle, member_extras={0: {"pipeline": extras}})
        self._status.write_once()

    def _close(self, outcome: str) -> None:
        if self._status is not None:
            self._status.update(outcome=outcome)
            self._status.write_once()
            self._status.stop()
            self._status = None
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        if self._registry is not None:
            self._registry.stop()

    # -- the cycle -----------------------------------------------------------

    def run_cycle(self) -> Dict[str, Any]:
        """One conductor cycle; returns a JSON-safe record of it."""
        self.cycle += 1
        faults.fault_point(FP_CYCLE_START)
        telemetry.counter("pipeline.cycles").inc()
        entry: Dict[str, Any] = {"cycle": self.cycle, "idle": True, "published_version": None,
                                 "escalated": False}
        paths = self._delta_paths()
        digest = delta_digest(paths) if paths else None
        if not paths or digest == self._last_digest:
            self._idle_cycles += 1
            telemetry.counter("pipeline.idle_cycles").inc()
            self._write_status(entry)
            return entry
        entry["idle"] = False
        t0 = time.perf_counter()
        with telemetry.span("pipeline.cycle", cycle=self.cycle, delta_files=len(paths),
                            delta_digest=digest):
            entry.update(self._refresh(paths))
        entry["cycle_s"] = time.perf_counter() - t0
        self._last_digest = digest
        self._write_status(entry)
        return entry

    @staticmethod
    def _event_times(paths: Sequence[str]) -> List[float]:
        times = []
        for p in paths:
            try:
                times.append(os.path.getmtime(p))
            except OSError:
                pass  # a shard replaced mid-cycle is still retrained
        return times

    def _refresh(self, paths: Sequence[str]) -> Dict[str, Any]:
        from photon_ml_tpu_torch.cli.train import read_input

        event_times = self._event_times(paths)
        ws = load_warm_start(self._base_dir, device=self.device)
        if ws.model is None:
            raise RuntimeError(
                f"{self._base_dir} holds a streamed coefficient table, not a full GAME model "
                "— the conductor needs a model base (train with --checkpoint-dir or point "
                "--base at a saved model dir)")
        base_vocabs = {}
        for sub in ws.model.models.values():
            id_name = getattr(sub, "id_name", None)
            vocab = getattr(sub, "vocab", None)
            if id_name is not None and vocab is not None:
                base_vocabs[id_name] = vocab

        # the delta alone (its id columns give the touched mask) ...
        delta_spec = {**self.spec.config["input"], "paths": list(paths)}
        for key in ("ingest", "date_range", "date_range_days_ago"):
            delta_spec.pop(key, None)
        delta_data, _ = read_input(delta_spec, index_maps=self._index_maps, device=self.device)
        scan = scan_delta(delta_data, base_vocabs, paths=list(paths))
        del delta_data

        # ... then the combined input (base shards, then the delta's): the
        # planner's deterministic order keeps the base's chunks where they were
        input_spec = dict(self.spec.config["input"])
        base_paths = input_spec.get("paths")
        if isinstance(base_paths, str):
            base_paths = [base_paths]
        input_spec["paths"] = list(base_paths) + list(paths)
        input_spec.pop("date_range", None)
        input_spec.pop("date_range_days_ago", None)
        train_data, index_maps = read_input(input_spec, index_maps=self._index_maps,
                                            device=self.device)
        if self._index_maps is None:
            self._index_maps = index_maps

        faults.fault_point(FP_RECONCILE)
        decision = reconcile_nearline(self.spec.registry_dir, scan)
        if decision["nearline_version"] is not None:
            self._reconciliations += 1
            telemetry.counter("pipeline.reconciliations").inc()

        touched = max((c.touched_fraction for c in scan.coordinates.values()), default=0.0)
        self._cycles_since_full += 1
        escalated = touched >= self.spec.escalate_touched_fraction or (
            self.spec.escalate_after_cycles > 0
            and self._cycles_since_full >= self.spec.escalate_after_cycles)
        base_version_name, _ = newest_version_metadata(self.spec.registry_dir)

        record: Dict[str, Any] = {"rows": int(train_data.num_rows)}
        t0 = time.perf_counter()
        if escalated:
            faults.fault_point(FP_ESCALATE)
            telemetry.counter("pipeline.escalations").inc()
            self._escalations += 1
            gen_dir = os.path.join(self.spec.workdir, f"base-gen-{self.cycle:04d}")
            with telemetry.span("pipeline.full_retrain", cycle=self.cycle,
                                touched_fraction=round(touched, 6)):
                self._estimator.fit(train_data, checkpoint_spec=CheckpointSpec(directory=gen_dir),
                                    device=self.device)
            # re-loaded through the warm-start reader, so the published
            # (model, lineage) pair is what the next cycle warm-starts from
            ws_new = load_warm_start(gen_dir, device=self.device)
            model, lineage = ws_new.model, ws_new.lineage
            self._base_dir = gen_dir
            self._cycles_since_full = 0
            record["full_retrain_s"] = time.perf_counter() - t0
        else:
            result = self._estimator.fit_incremental(
                train_data, ws, delta=scan, bootstrap_samples=self.spec.bootstrap_samples,
                device=self.device)
            model, lineage = result.model, result.lineage
            record.update(time_to_fresh_s=result.seconds, lanes_solved=result.lanes_solved,
                          lanes_skipped=result.lanes_skipped)

        quality = None
        if self.spec.quality_gate or self.spec.bootstrap_samples > 0:
            from photon_ml_tpu_torch.quality import game_quality_stats

            # the candidate's error bars on the cycle's combined data, the rows
            # the fit just saw
            quality = game_quality_stats(model, train_data,
                                         num_samples=self.spec.bootstrap_samples).to_json()
            if not escalated and result.bootstrap is not None:
                quality["bootstrap"] = result.bootstrap
        del train_data

        try:
            published = publish_incremental(
                self.spec.registry_dir, model, self._index_maps, lineage, delta=scan,
                base_version=base_version_name,
                extra_metadata={"pipeline": {"cycle": self.cycle, "escalated": bool(escalated),
                                             "cycles_since_full": self._cycles_since_full}},
                reconciliation=decision, quality=quality,
                gate_override=not self.spec.quality_gate)
        except QualityGateRefused as exc:
            # a quarantined cycle is a completed cycle: the champion keeps
            # serving and the digest cursor moves on (run_cycle), so the
            # refused delta is not retried forever
            telemetry.counter("pipeline.quarantines").inc()
            qname = os.path.basename(exc.quarantine_path or "")
            self._quarantined.append(qname)
            logger.warning("pipeline cycle %d quarantined its candidate (%s): %s",
                           self.cycle, qname, exc.decision.reason)
            return {**record, "published_version": None, "quarantined_version": qname,
                    "quality_gate": exc.decision.to_json(), "escalated": bool(escalated),
                    "touched_fraction": round(float(touched), 6), "reconciliation": decision}
        telemetry.counter("pipeline.publishes").inc()
        version_name = os.path.basename(published)
        logger.info("pipeline cycle %d published %s (escalated=%s touched=%.4f)",
                    self.cycle, version_name, escalated, touched)
        self._published.append(version_name)

        served_ts = self._swap()
        # event time = the delta shard's mtime; served time = the swap. Each
        # shard of the cycle is one sample, so the p99 reflects the oldest
        # events a slow cycle kept stale
        samples = [max(served_ts - t, 0.0) for t in event_times]
        hist = telemetry.histogram("pipeline.staleness_s")
        for s in samples:
            hist.observe(s)
        self._staleness.extend(samples)
        p99 = float(np.percentile(np.asarray(self._staleness), 99.0))
        self._last_p99 = p99
        telemetry.gauge("pipeline.event_to_served_staleness_p99_s").set(p99)
        return {**record, "published_version": version_name, "escalated": bool(escalated),
                "touched_fraction": round(float(touched), 6), "reconciliation": decision,
                "staleness_p99_s": round(p99, 3)}

    def _swap(self) -> float:
        """Hot-swap the live registry to the newest version; returns the
        served time (the wall clock: staleness is measured against the delta
        files' mtimes)."""
        if not self.spec.serve:
            return time.time()
        if self._registry is None:
            from photon_ml_tpu_torch.serving.registry import ModelRegistry

            # manual refresh: the conductor knows when a version landed, so
            # no polling thread
            self._registry = ModelRegistry(self.spec.registry_dir, warm=False,
                                           device=self.device)
        self._registry.refresh()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()

    # -- the daemon loop -----------------------------------------------------

    def request_stop(self) -> None:
        """Ask the loop to exit after the cycle in flight (signal-safe)."""
        self._stop.set()

    def run(self) -> Dict[str, Any]:
        """The supervised loop: cycle, sleep ``interval_s``, repeat until
        ``max_cycles`` or a stop request. Returns the run's summary."""
        self._start_status()
        logger.info("pipeline daemon up on %s: tailing %s, publishing to %s", self.device,
                    self.spec.delta_dir, self.spec.registry_dir)
        outcome = "completed"
        try:
            while True:
                if self._stop.is_set():
                    outcome = "interrupted"
                    break
                entry = self.run_cycle()
                logger.info("pipeline cycle %s", _cycle_line(entry))
                if self.spec.max_cycles and self.cycle >= self.spec.max_cycles:
                    break
                if self._stop.wait(self.spec.interval_s):
                    outcome = "interrupted"
                    break
        finally:
            self._close(outcome)
        return self.summary(interrupted=outcome == "interrupted")

    def summary(self, interrupted: bool = False) -> Dict[str, Any]:
        p99 = (float(np.percentile(np.asarray(self._staleness), 99.0))
               if self._staleness else None)
        return {
            "cycles": self.cycle,
            "idle_cycles": self._idle_cycles,
            "published_versions": list(self._published),
            "quarantined_versions": list(self._quarantined),
            "escalations": self._escalations,
            "reconciliations": self._reconciliations,
            "event_to_served_staleness_p99_s": round(p99, 3) if p99 is not None else None,
            "registry_dir": self.spec.registry_dir,
            "base_dir": self._base_dir,
            "interrupted": bool(interrupted),
        }


def _cycle_line(entry: Mapping[str, Any]) -> str:
    """A cycle's record as one JSON line (the daemon's log of each cycle)."""
    import json

    return json.dumps(entry, default=float, sort_keys=True)
