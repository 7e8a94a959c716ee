"""GAME training driver.

Counterpart of ``photon_ml_tpu/cli/train.py``: read the training (and
validation) data, fit the configured coordinates with ``GameEstimator``
under the coordinate-descent guard, save the final and best models, the
index maps and the feature statistics, and print a JSON summary:

    python -m photon_ml_tpu_torch.cli train --config train.json [--device cuda|cpu]

The config document is the reference's (``coordinates`` in updating order):

    {
      "task": "logistic",
      "input": {"format": "avro", "paths": ["train/"],
                "feature_shards": {"global": ["features"]},
                "id_columns": ["userId"], "add_intercept": true},
      "validation": {"paths": ["validate/"]},
      "coordinates": {"fixed": {"type": "fixed_effect",
                                "shard_name": "global",
                                "optimizer": {"regularization": "l2",
                                               "regularization_weight": 1.0}}},
      "num_iterations": 1,
      "evaluators": ["auc"],
      "output_dir": "out/model"
    }

``--device`` (default ``cuda``) is the port's one added argument. The guard
is on unless the config says ``"guard": false``; ``event_listeners`` loads
listeners by dotted path. A ``"sweep"`` key (or ``--sweep``, with
``--sweep-metric`` and ``--sweep-policy``) trains every λ of a grid at once
and saves the winner under ``<output_dir>/best`` instead of a single fit
(``cli/sweep.py``); it needs a validation input and refuses a checkpoint,
as the reference does. ``input.ingest`` (true, or an object of
``IngestSpec`` fields; ``--ingest-workers`` and ``--prefetch-depth`` set
two of them) reads the Avro input through the streamed ingest
(``ingest/``): block ranges decoded in parallel into a bounded staging
ring and assembled on the device, bit for bit the in-core read. ``"checkpoint": {"dir", "every", "keep_last",
"resume"}`` (or ``--checkpoint-dir``, ``--checkpoint-every``, ``--resume``)
saves the coordinate-descent state after each step and resumes from the
newest valid checkpoint (``resume`` defaults to true); with a checkpoint,
SIGTERM/SIGINT finish the step, write a final checkpoint and end the run
with an ``interrupted`` summary and exit code 75. ``"warm_start"`` (or ``--warm-start``, with
``--delta``, ``--refresh-registry-dir`` and ``--lambda-points``) runs the
incremental refresh instead of a fit: the base restored, the delta scanned,
only its touched random-effect lanes solved over the combined input
(yesterday's paths and the delta's), and the model published with its
lineage through the quality gate (``incremental/``; ``cli refresh`` is the
same branch as a subcommand).

Telemetry, as the reference's: ``trace_out`` (``--trace-out``) streams the
span tree to a JSONL file and writes a sibling ``.perfetto.json`` Chrome
trace at the end; ``telemetry_out`` (``--telemetry-out``) appends the final
metrics snapshot; ``heartbeat`` (on by default: true, false, an interval in
seconds, or ``{"every", "out"}``; ``--heartbeat-every``, 0 turns it off)
logs a progress line every ~30 s, into ``telemetry_out`` too; and
``report_out`` (``--report-out``) renders the run report (markdown and a
sibling ``.json`` compare baseline) from the run's sinks, or from the live
registries without them, with the checkpoint manifests' coordinate history.
In a fleet each path is suffixed per member. None of it adds a device sync
or fetch. ``xprof`` (``--xprof-dir``/``--xprof-arm``: a directory, or
``{"dir", "arm_at", "capture"}``) opens a ``torch.profiler`` capture window
around the ``arm_at``-th profiled call (default 20) for ``capture`` calls
(default 8) and writes a Chrome trace into the directory; it is refused on
the CPU unless ``PHOTON_XPROF_FORCE=1``.

``"distributed"`` (``coordinator_address``, ``num_processes``,
``process_id``, ``auto``, ``init_retries``, ``init_backoff_s``; each left
out falls back to the ``PHOTON_ML_*`` environment) joins a fleet through
``parallel.multihost.initialize`` before anything is read (:185-240). A
fleet of one process trains (a configured fleet without a ``mesh`` key
trains over a 1-D mesh of its devices); one of more processes is refused
with the reference's reason: this pipeline reads the whole input in every
process, so a fit across processes is a worker on the per-process APIs
supervised by ``tools/fleet``.

``"mesh"`` (or ``--mesh batch=N,model=M``, ``auto`` for a 1-D ``data`` mesh
over every CUDA device, ``off`` to drop a config's mesh) trains over a
device mesh (``parallel/``): fixed-effect rows split over ``batch``, random
effects' entities over ``model``. With ``--device cpu`` the mesh's devices
are the CPU repeated (one for ``auto``), which runs the sharding code. A
mesh with a sweep is refused, as the reference refuses it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.config import parse_game_config
from photon_ml_tpu_torch.game.checkpoint import CheckpointSpec, GracefulStop, TrainingInterrupted
from photon_ml_tpu_torch.game.dataset import FeatureShard, GameDataset, build_game_dataset
from photon_ml_tpu_torch.game.estimator import GameEstimator
from photon_ml_tpu_torch.optim.guard import GuardSpec
from photon_ml_tpu_torch.utils import setup_logging, timed

# the reference's own refusal of a train run across processes
# (photon_ml_tpu/cli/train.py:218-240)
ACROSS_PROCESSES = ("the `train` CLI does not span processes yet; write a worker with the "
                    "per-process APIs and supervise it with tools/fleet (README 'Multi-host "
                    "deployment' / 'Fleet supervision')")


def read_input(
    spec: Mapping,
    is_response_required: bool = True,
    index_maps: Optional[Mapping] = None,
    device: torch.device | str | None = None,
) -> tuple[GameDataset, Optional[Mapping]]:
    """A ``GameDataset`` on ``device`` (default cuda) from an input spec
    ({format, paths, ...}), and the index maps. For Avro, ``index_maps``
    (per shard) pin the feature space, as scoring needs; without them one
    scan builds them, and they are returned for the driver to save. LIBSVM
    gives one shard (``shard_name``, default "features") with the intercept
    last, ``num_features`` pinning the raw dimension, and no index maps."""
    spec = dict(spec)
    fmt = spec.pop("format", "avro")
    paths = spec.pop("paths")
    dr = spec.pop("date_range", None)
    dr_ago = spec.pop("date_range_days_ago", None)
    if dr or dr_ago:
        if fmt != "avro":
            raise ValueError("date_range expansion is supported for avro daily "
                             f"directories only, not format '{fmt}'")
        from photon_ml_tpu_torch.data.paths import expand_input_paths

        if isinstance(paths, str):
            paths = [paths]
        paths = expand_input_paths(paths, date_range=dr, date_range_days_ago=dr_ago)
    if fmt == "avro":
        shards = spec.pop("feature_shards", None)
        shards = {k: tuple(v) for k, v in (shards or {"features": ("features",)}).items()}
        ingest = spec.pop("ingest", None)
        if ingest:
            # the streamed ingest: block ranges decoded in parallel into a
            # bounded staging ring, the feature shards assembled on the device
            # (the host never holds the whole COO), bit for bit the in-core read
            from photon_ml_tpu_torch.ingest import IngestSpec, read_game_dataset_streamed

            return read_game_dataset_streamed(
                paths, feature_shards=shards, index_maps=index_maps,
                id_columns=tuple(spec.pop("id_columns", ())),
                add_intercept=bool(spec.pop("add_intercept", True)),
                is_response_required=is_response_required,
                spec=IngestSpec.from_config(ingest), return_index_maps=True, device=device)
        from photon_ml_tpu_torch.data.avro import read_game_dataset_from_avro

        # one scan builds the index maps and the dataset
        return read_game_dataset_from_avro(
            paths, feature_shards=shards, index_maps=index_maps,
            id_columns=tuple(spec.pop("id_columns", ())),
            add_intercept=bool(spec.pop("add_intercept", True)),
            is_response_required=is_response_required, return_index_maps=True,
            device=device)
    if fmt == "libsvm":
        from photon_ml_tpu_torch.data.libsvm import read_libsvm

        if isinstance(paths, (list, tuple)):
            if len(paths) != 1:
                raise ValueError("libsvm input takes exactly one path")
            paths = paths[0]
        lib = read_libsvm(paths)
        values, rows, cols, d = lib.coo(num_features=spec.pop("num_features", None),
                                        add_intercept=bool(spec.pop("add_intercept", True)))
        labels = np.asarray(lib.labels)
        if spec.pop("binarize_labels", True):
            labels = (labels > 0).astype(np.float64)
        shard = spec.pop("shard_name", "features")
        return (build_game_dataset(response=labels,
                                   feature_shards={shard: FeatureShard.from_coo(values, rows,
                                                                                cols, d)},
                                   device=device),
                None)
    raise ValueError(f"unknown input format '{fmt}'")


def _persist_feature_artifacts(output_dir, index_maps, train_data) -> None:
    """The feature space beside the saved models (``final/`` and ``best/``
    ``feature-indexes/<shard>``, which scoring reads to reproduce the
    training ids) and each shard's feature statistics
    (``feature-stats/<shard>.avro``, from ``summarize`` on the device)."""
    from photon_ml_tpu_torch.data.avro import write_feature_summary
    from photon_ml_tpu_torch.data.stats import summarize

    with timed("save index maps"):
        for shard, imap in index_maps.items():
            for sub in ("final", "best"):
                imap.save(os.path.join(output_dir, sub, "feature-indexes", shard))
    with timed("save feature summaries"):
        stats_dir = os.path.join(output_dir, "feature-stats")
        os.makedirs(stats_dir, exist_ok=True)
        for shard, imap in index_maps.items():
            write_feature_summary(os.path.join(stats_dir, f"{shard}.avro"),
                                  summarize(train_data.csr_batch(shard)), imap)


def parse_mesh_flag(raw: str):
    """``--mesh`` -> the config's ``mesh`` value: ``batch=N,model=M`` (either
    axis optional) a dict of axis sizes, ``auto``/``on`` True, ``off``/``none``
    False (``photon_ml_tpu/cli/train.py:151-182``)."""
    text = raw.strip().lower()
    if text in ("auto", "on", "true"):
        return True
    if text in ("off", "none", "false"):
        return False
    axes: dict[str, int] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, size = part.partition("=")
        if not eq or not name:
            raise ValueError(f"--mesh expects 'axis=N[,axis=M]' or 'auto'/'off', got {raw!r}")
        try:
            axes[name.strip()] = int(size)
        except ValueError:
            raise ValueError(f"--mesh axis '{name.strip()}' needs an integer size, got "
                             f"{size!r}") from None
    if not axes:
        raise ValueError(f"--mesh got no axes in {raw!r}")
    return axes


def init_distributed(config: Mapping, device: torch.device | str | None = None) -> None:
    """Join the fleet of the config's ``distributed`` key (each field left
    out taken from the ``PHOTON_ML_*`` environment), with bounded retry;
    a run that spans processes is refused with the reference's reason."""
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.parallel import multihost

    spec = config.get("distributed")
    if spec is not None:
        env = multihost.DistributedConfig.from_env()
        multihost.initialize(multihost.DistributedConfig(
            coordinator_address=spec.get("coordinator_address", env.coordinator_address),
            num_processes=spec.get("num_processes", env.num_processes),
            process_id=spec.get("process_id", env.process_id),
            auto=bool(spec.get("auto", env.auto)),
            init_retries=int(spec.get("init_retries", env.init_retries)),
            init_backoff_s=float(spec.get("init_backoff_s", env.init_backoff_s)),
        ), device=resolve_device(device))
    if multihost.is_multiprocess():
        raise NotImplementedError(ACROSS_PROCESSES)


def build_mesh(config: Mapping, device: torch.device | str | None = None):
    """The training mesh of the config's ``mesh`` key, or None: over the
    first CUDA devices, or on the CPU over the CPU repeated. A configured
    fleet (``distributed``) without a ``mesh`` key trains over a 1-D mesh
    of its devices, as the reference's does."""
    spec = config.get("mesh")
    if spec is None and config.get("distributed") is not None:
        spec = "auto"
    if not spec:
        return None
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.parallel import DATA_AXIS, make_mesh

    dev = resolve_device(device)
    if dev.type == "cpu":
        sizes = {DATA_AXIS: 1} if spec in (True, "auto") else {k: int(v) for k, v in spec.items()}
        return make_mesh(sizes, [dev] * int(np.prod(list(sizes.values()))))
    return make_mesh(None if spec in (True, "auto") else {k: int(v) for k, v in spec.items()})


def _parse_guard_spec(config: Mapping) -> Optional[GuardSpec]:
    """Config key ``"guard"``: true (the default), false, or an object
    overriding ``GuardSpec``'s fields."""
    spec = config.get("guard", True)
    if spec is False:
        return None
    if spec is True:
        return GuardSpec()
    spec = dict(spec)
    unknown = set(spec) - {f.name for f in dataclasses.fields(GuardSpec)}
    if unknown:
        raise ValueError(f"unknown guard config keys: {sorted(unknown)}")
    return GuardSpec(**spec)


def _parse_checkpoint_spec(config: Mapping) -> Optional[CheckpointSpec]:
    """Config key ``"checkpoint": {"dir", "every", "keep_last", "resume"}``.
    ``resume`` defaults to true, so a restarted run with the same arguments
    goes on; ``"resume": false`` is a fresh fit that clears the directory."""
    spec = config.get("checkpoint")
    if not spec:
        return None
    spec = dict(spec)
    if "dir" not in spec:
        raise ValueError("checkpoint config needs a 'dir' key")
    spec["directory"] = spec.pop("dir")
    unknown = set(spec) - {f.name for f in dataclasses.fields(CheckpointSpec)}
    if unknown:
        raise ValueError(f"unknown checkpoint config keys: {sorted(unknown)}")
    return CheckpointSpec(**spec)


_WARM_START_KEYS = {
    "dir", "delta_paths", "registry_dir", "base_version", "force",
    "lambda_factors", "lambda_points", "lambda_span", "metric", "policy",
    "quality_gate", "bootstrap_samples",
}


def _parse_warm_start(config: Mapping) -> Optional[dict]:
    """Config key ``"warm_start"`` (the ``--warm-start``/``--delta`` flags):
    ``{"dir": <base checkpoint or model dir>, "delta_paths": [...],
    "registry_dir": ..., "lambda_points"/"lambda_span" or a
    "lambda_factors" list, "metric", "policy", "base_version", "force",
    "quality_gate", "bootstrap_samples"}``, or the directory alone."""
    spec = config.get("warm_start")
    if not spec:
        return None
    if isinstance(spec, str):
        spec = {"dir": spec}
    spec = dict(spec)
    if "dir" not in spec:
        raise ValueError("warm_start config needs a 'dir' key")
    unknown = set(spec) - _WARM_START_KEYS
    if unknown:
        raise ValueError(f"unknown warm_start config keys: {sorted(unknown)}")
    if config.get("sweep"):
        raise ValueError(
            "warm_start and sweep are mutually exclusive — the incremental path runs its own "
            'local λ sweep (warm_start {"lambda_points": N, "lambda_span": S})')
    return spec


def _combined_input(config: Mapping, warm: Optional[dict]) -> dict:
    """The training input spec, with the delta's paths after yesterday's:
    the planner's deterministic order keeps yesterday's chunks where they
    were. Daily directories are expanded before the append (delta paths are
    files, which the expansion would drop)."""
    input_spec = dict(config["input"])
    if not (warm and warm.get("delta_paths")):
        return input_spec
    paths = input_spec.get("paths")
    if isinstance(paths, str):
        paths = [paths]
    dr = input_spec.pop("date_range", None)
    dr_ago = input_spec.pop("date_range_days_ago", None)
    if dr or dr_ago:
        from photon_ml_tpu_torch.data.paths import expand_input_paths

        paths = expand_input_paths(list(paths), date_range=dr, date_range_days_ago=dr_ago)
    input_spec["paths"] = list(paths) + list(warm["delta_paths"])
    return input_spec


def _run_incremental(config: Mapping, warm: dict, estimator: GameEstimator, train_data,
                     validation_data, index_maps, output_dir, mesh, checkpoint_spec, guard,
                     stop) -> dict:
    """The warm-start branch: restore the base, scan the delta, refuse a
    stale one, refresh, and publish through the gate with the lineage.
    Returns the freshness summary."""
    from photon_ml_tpu_torch.incremental import (
        WarmStartError,
        check_delta_freshness,
        load_warm_start,
        local_lambda_factors,
        publish_incremental,
        scan_delta,
    )

    dev = train_data.device
    with timed("warm-start restore"):
        ws = load_warm_start(warm["dir"], mesh=mesh, device=None if mesh is not None else dev)
    if ws.model is None:
        raise WarmStartError(
            f"{warm['dir']} holds a streamed coefficient-table checkpoint, not a full GAME "
            "model — the train CLI warm-starts coordinate descent; streamed tables warm-start "
            "StreamingRandomEffectTrainer via the API (incremental.load_warm_start + "
            "ShardedCoefficientTable.from_coefficients)")
    delta_scan = None
    delta_paths = list(warm.get("delta_paths") or ())
    if delta_paths:
        base_vocabs = {sub.id_name: sub.vocab for sub in ws.model.models.values()
                       if getattr(sub, "id_name", None) is not None
                       and getattr(sub, "vocab", None) is not None}
        if base_vocabs:
            with timed("delta scan"):
                # only the delta's id columns are needed; it is read again
                # (it already was, as the combined input's tail) at a
                # delta's size, by premise a fraction of the base
                delta_spec = {**config["input"], "paths": delta_paths}
                for key in ("ingest", "date_range", "date_range_days_ago"):
                    delta_spec.pop(key, None)
                delta_data, _ = read_input(delta_spec, index_maps=index_maps, device=dev)
                delta_scan = scan_delta(delta_data, base_vocabs, paths=delta_paths)
    if delta_scan is not None and warm.get("registry_dir"):
        check_delta_freshness(warm["registry_dir"], delta_scan.digest,
                              force=bool(warm.get("force")))
    factors = warm.get("lambda_factors")
    if factors is None and warm.get("lambda_points"):
        factors = local_lambda_factors(points=int(warm["lambda_points"]),
                                       span=float(warm.get("lambda_span", 4.0)))
    gate_enabled = bool(warm.get("quality_gate", True))
    bootstrap_samples = int(warm.get("bootstrap_samples", 32))
    publishing = bool(warm.get("registry_dir"))
    with timed("incremental fit"):
        result = estimator.fit_incremental(
            train_data, ws, delta=delta_scan, validation_data=validation_data,
            output_dir=output_dir, mesh=mesh, lambda_factors=factors,
            metric=warm.get("metric"), policy=warm.get("policy", "best"), guard=guard,
            checkpoint_spec=checkpoint_spec,
            should_stop=stop if checkpoint_spec is not None else None,
            bootstrap_samples=bootstrap_samples if publishing else 0, device=dev)
    gate_refusal = quality = None
    if publishing:
        if not index_maps:
            raise ValueError("publishing an incremental model needs index maps (avro input "
                             "builds them; libsvm input cannot publish)")
        from photon_ml_tpu_torch.quality import QualityGateRefused, game_quality_stats

        with timed("quality stats"):
            # the candidate's error bars on the strongest evaluation set at
            # hand; publish_version compares them with the champion's
            eval_data = validation_data if validation_data is not None else train_data
            quality = game_quality_stats(result.model, eval_data,
                                         num_samples=bootstrap_samples).to_json()
            if result.bootstrap is not None:
                quality["bootstrap"] = result.bootstrap
        with timed("registry publish"):
            try:
                result.published_version = publish_incremental(
                    warm["registry_dir"], result.model, index_maps, result.lineage,
                    delta=result.delta, base_version=warm.get("base_version"),
                    selection=result.selection, quality=quality,
                    gate_override=not gate_enabled)
            except QualityGateRefused as exc:
                # a quarantined candidate is a result, not a crash: the
                # champion keeps serving and the run ends cleanly
                gate_refusal = {**exc.decision.to_json(),
                                "quarantine_path": exc.quarantine_path}
    freshness = {
        "base": result.lineage.to_json(),
        "lanes_solved": result.lanes_solved,
        "lanes_skipped": result.lanes_skipped,
        "bucket_solves": result.bucket_solves,
        "buckets_skipped": result.buckets_skipped,
        "new_entities": result.new_entities,
        "time_to_fresh_s": round(result.seconds, 3),
        "best_metric": result.best_metric,
    }
    if result.delta is not None:
        freshness["delta"] = result.delta.to_json()
    if result.selection is not None:
        freshness["selection"] = result.selection.to_json()
    if result.published_version:
        freshness["published_version"] = result.published_version
    if quality is not None:
        freshness["quality"] = quality
    if gate_refusal is not None:
        freshness["quality_gate"] = gate_refusal
    return freshness


def _parse_heartbeat(config: Mapping, telemetry_out: Optional[str]):
    """Config key ``"heartbeat"``: true (the default: a progress line every
    ~30 s once a fit runs longer than that), false, null or 0 (off), an
    interval in seconds, or ``{"every": seconds, "out": jsonl_path}``. The
    sink defaults to ``telemetry_out``, where the run report finds the
    beats."""
    spec = config.get("heartbeat", True)
    if spec is None or spec is False or spec == 0:
        return None
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        spec = {"every": float(spec)}
    from photon_ml_tpu_torch.telemetry.progress import DEFAULT_INTERVAL_S, Heartbeat

    every = DEFAULT_INTERVAL_S
    out = telemetry_out
    if spec is not True:
        spec = dict(spec)
        unknown = set(spec) - {"every", "out"}
        if unknown:
            raise ValueError(f"unknown heartbeat config keys: {sorted(unknown)}")
        every = float(spec.get("every", every))
        out = spec.get("out", out)
        if every <= 0:
            return None
    return Heartbeat(interval=every, jsonl_path=out)


def _maybe_write_report(config: Mapping, summary: dict, trace_out: Optional[str],
                        telemetry_out: Optional[str]) -> None:
    """Config key ``report_out``: render the run report (markdown and a
    sibling ``.json``) from this run's sinks, or from the live registries
    when none is configured, and record both paths in the summary."""
    report_out = config.get("report_out")
    if not report_out:
        return
    report_out = telemetry.member_artifact_path(report_out)
    from photon_ml_tpu_torch.telemetry.report import RunReport

    ckpt_dir = (config.get("checkpoint") or {}).get("dir")
    if trace_out or telemetry_out:
        report = RunReport.load(trace=trace_out, telemetry=telemetry_out,
                                checkpoint_dir=ckpt_dir)
    else:
        report = RunReport.from_live(checkpoint_dir=ckpt_dir)
    with open(report_out, "w", encoding="utf-8") as fh:
        fh.write(report.to_markdown())
    json_path = (report_out[:-len(".md")] + ".json" if report_out.endswith(".md")
                 else report_out + ".json")
    report.save_json(json_path)
    summary["report"] = report_out
    summary["report_json"] = json_path


def _finish_telemetry(config: Mapping, summary: dict, trace_out: Optional[str],
                      telemetry_out: Optional[str]) -> dict:
    """At every exit of a run: flush the metrics snapshot, export the
    Perfetto trace beside the span JSONL, and write the report."""
    if telemetry_out:
        summary["telemetry"] = telemetry.flush_metrics(telemetry_out)
    if trace_out:
        telemetry.export_chrome_trace(trace_out, telemetry.perfetto_path(trace_out))
    _maybe_write_report(config, summary, trace_out, telemetry_out)
    return summary


def run(config: Mapping, output_dir: Optional[str] = None,
        device: torch.device | str | None = None) -> dict:
    """Run the training pipeline on ``device`` (default cuda); returns a
    JSON-safe summary."""
    game_config = parse_game_config(config)
    output_dir = output_dir or config.get("output_dir")
    guard = _parse_guard_spec(config)
    checkpoint_spec = _parse_checkpoint_spec(config)
    warm = _parse_warm_start(config)
    if config.get("sweep"):
        from photon_ml_tpu_torch.cli.sweep import parse_sweep_config

        parse_sweep_config(config["sweep"])  # a malformed grid fails before the read
    if config.get("sweep") and checkpoint_spec is not None:
        # a sweep is one batched solve per coordinate, not a resumable step
        # sequence: a "checkpointed" sweep would save nothing
        raise ValueError(
            "checkpointing is not supported with a sweep yet — drop "
            'the "checkpoint" config (sweeps are one batched solve '
            "per coordinate, not a resumable step sequence)")
    if config.get("sweep") and config.get("mesh"):
        raise ValueError(
            "mesh training is not supported with a GAME sweep yet — drop the \"mesh\" config / "
            "--mesh flag (plain-GLM sweeps can shard the config axis via "
            "sweep.sweep_glm(mesh=...))")
    init_distributed(config, device)
    mesh = build_mesh(config, device)
    # the sinks, suffixed per fleet member; the first traced phase is the read
    trace_out = config.get("trace_out")
    if trace_out:
        trace_out = telemetry.member_artifact_path(trace_out)
        telemetry.configure(trace_out=trace_out)
    telemetry_out = config.get("telemetry_out")
    if telemetry_out:
        telemetry_out = telemetry.member_artifact_path(telemetry_out)
    xprof_cfg = config.get("xprof")
    if xprof_cfg:
        # a torch.profiler window around the Kth profiled call (past the
        # warm-up); refused on the CPU unless forced
        from photon_ml_tpu_torch.device import resolve_device

        if isinstance(xprof_cfg, str):
            xprof_cfg = {"dir": xprof_cfg}
        xprof_kwargs = {k: int(xprof_cfg[k]) for k in ("arm_at", "capture")
                        if xprof_cfg.get(k) is not None}
        telemetry.profile.configure_xprof(
            telemetry.member_artifact_path(str(xprof_cfg["dir"])),
            device=resolve_device(device), **xprof_kwargs)
    stop = GracefulStop()
    if checkpoint_spec is not None:
        # without a checkpoint nothing durable is written on SIGTERM, so the
        # default handling (die at once) is the right one
        stop.install()

    with timed("read training data"):
        train_data, index_maps = read_input(_combined_input(config, warm), device=device)
    validation_data = None
    if config.get("validation"):
        with timed("read validation data"):
            # validation shares the training feature space
            vspec = {**config["input"], **config["validation"]}
            validation_data, _ = read_input(vspec, index_maps=index_maps, device=device)

    estimator = GameEstimator(game_config)
    if config.get("event_listeners"):
        from photon_ml_tpu_torch.utils.events import load_listeners

        for listener in load_listeners(config["event_listeners"]):
            estimator.events.register(listener)
    heartbeat = _parse_heartbeat(config, telemetry_out)
    try:
        if heartbeat is not None:
            heartbeat.start()
        if config.get("sweep"):
            # every λ at once and the winner under <output_dir>/best, instead
            # of a single fit (cli/sweep.py)
            from photon_ml_tpu_torch.cli.sweep import run_sweep_fit

            with timed("sweep"):
                sweep_summary = run_sweep_fit(estimator, config["sweep"], train_data,
                                              validation_data, output_dir,
                                              device=train_data.device, index_maps=index_maps)
            if output_dir is not None and index_maps is not None:
                with timed("save index maps"):
                    for shard, imap in index_maps.items():
                        imap.save(os.path.join(output_dir, "best", "feature-indexes", shard))
            return _finish_telemetry(config, {
                "sweep": sweep_summary, "best_metric": sweep_summary["selected_metric"],
                "output_dir": output_dir, "num_rows": train_data.num_rows},
                trace_out, telemetry_out)
        if warm:
            # the incremental refresh instead of a fit (_run_incremental)
            freshness = _run_incremental(config, warm, estimator, train_data, validation_data,
                                         index_maps, output_dir, mesh, checkpoint_spec, guard,
                                         stop)
            if output_dir is not None and index_maps is not None:
                _persist_feature_artifacts(output_dir, index_maps, train_data)
            return _finish_telemetry(config, {
                "freshness": freshness, "best_metric": freshness.get("best_metric"),
                "output_dir": output_dir, "num_rows": train_data.num_rows},
                trace_out, telemetry_out)
        with timed("fit"):
            result = estimator.fit(
                train_data, validation_data=validation_data, output_dir=output_dir,
                guard=guard, device=train_data.device, mesh=mesh,
                checkpoint_spec=checkpoint_spec,
                should_stop=stop if checkpoint_spec is not None else None)
    except TrainingInterrupted as e:
        # the final checkpoint is on disk: report, and a restart resumes
        return _finish_telemetry(config, {
            "interrupted": True, "interrupted_at_step": e.step,
            "checkpoint": e.checkpoint_path, "output_dir": output_dir,
            "num_rows": train_data.num_rows}, trace_out, telemetry_out)
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        # close a capture window still open (a fit shorter than the window,
        # or one interrupted in it)
        telemetry.profile.stop_xprof()
    if output_dir is not None and index_maps is not None:
        _persist_feature_artifacts(output_dir, index_maps, train_data)
    return _finish_telemetry(config, {
        "output_dir": output_dir,
        "best_metric": result.best_metric,
        "num_rows": train_data.num_rows,
        # each entry without its solve results (tensors), so JSON-safe
        "history": [{k: v for k, v in e.items() if k != "results"} for e in result.history],
    }, trace_out, telemetry_out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli train",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="JSON config path")
    parser.add_argument("--output-dir", help="override config output_dir")
    parser.add_argument("--device", default="cuda",
                        help="the device that reads, trains and scores (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")
    parser.add_argument("--trace-out",
                        help="write telemetry spans to this JSONL file (+ a sibling "
                        ".perfetto.json Chrome trace); overrides config trace_out")
    parser.add_argument("--telemetry-out",
                        help="append the final metrics snapshot to this JSONL file; overrides "
                        "config telemetry_out")
    parser.add_argument("--report-out",
                        help="write the run report (markdown; + a sibling .json compare "
                        "baseline) here when training ends (config report_out)")
    parser.add_argument("--heartbeat-every", type=float,
                        help="seconds between live progress heartbeat lines (default 30, so "
                        "only fits longer than ~30 s emit any; 0 disables; config heartbeat)")
    parser.add_argument("--sweep", action="append",
                        help="train a multi-λ sweep instead of a single fit: grid tokens "
                        "like 'lambda=1e-4:1e2:log16' (repeatable; needs a validation "
                        "input; config key sweep.grid)")
    parser.add_argument("--sweep-metric",
                        help="validation metric the sweep selects on (default: the task's "
                        "ModelSelection metric; config sweep.metric)")
    parser.add_argument("--sweep-policy", choices=("best", "parsimonious"),
                        help="sweep selection policy (config sweep.policy)")
    parser.add_argument("--sweep-registry-dir",
                        help="publish the sweep winner as the next version of this serving "
                        "registry (config sweep.registry_dir)")
    parser.add_argument("--warm-start", metavar="DIR",
                        help="incremental retrain: warm-start every coordinate from this base "
                        "(a --checkpoint-dir step checkpoint, a streamed chunk checkpoint or a "
                        "saved model dir) instead of fitting from scratch; with --delta only "
                        "the touched random-effect lanes solve again (config warm_start.dir)")
    parser.add_argument("--delta", action="append", metavar="PATH",
                        help="delta shard(s) appended to the input paths (repeatable); their "
                        "entity ids mask the lanes that solve (needs --warm-start; config "
                        "warm_start.delta_paths)")
    parser.add_argument("--refresh-registry-dir", metavar="DIR",
                        help="publish the refreshed model here with its lineage (base "
                        "checkpoint, delta digest) through the quality gate (config "
                        "warm_start.registry_dir)")
    parser.add_argument("--lambda-points", type=int,
                        help="a local descending-λ sweep of this many fits around the "
                        "incumbent regularization during an incremental retrain (needs a "
                        "validation input; config warm_start.lambda_points)")
    parser.add_argument("--xprof-dir", metavar="DIR",
                        help="capture a torch.profiler trace into this directory, armed "
                        "around the Kth profiled call (see --xprof-arm); refused on the CPU "
                        "(config key xprof.dir)")
    parser.add_argument("--xprof-arm", type=int, metavar="K",
                        help="profiled-call count at which the --xprof-dir capture window "
                        "opens (default 20, past the warm-up; config xprof.arm_at)")
    parser.add_argument("--mesh",
                        help="train over a named device mesh: 'batch=N,model=M' splits "
                        "fixed-effect rows over the batch axis and random-effect entities "
                        "over the model axis (either may be omitted); 'auto' is a 1-D mesh "
                        "over every CUDA device; 'off' drops a config mesh (overrides config "
                        "mesh)")
    parser.add_argument("--ingest-workers", type=int,
                        help="read the Avro input through the streamed ingest with N decode "
                        "workers (0 = one per core; sets input.ingest.workers)")
    parser.add_argument("--prefetch-depth", type=int,
                        help="device-ready chunks the streamed ingest may hold ahead "
                        "(sets input.ingest.prefetch_depth)")
    parser.add_argument("--checkpoint-dir",
                        help="save the coordinate-descent state here after each (iteration, "
                        "coordinate) step; SIGTERM/SIGINT then write a final checkpoint "
                        "before exiting (overrides config checkpoint.dir)")
    parser.add_argument("--checkpoint-every", type=int,
                        help="save every N steps (default 1; overrides checkpoint.every)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest valid checkpoint in --checkpoint-dir "
                        "(the default once a checkpoint dir is configured; config "
                        'checkpoint {"resume": false} is a fresh fit that clears it)')
    args = parser.parse_args(argv)
    setup_logging()
    with open(args.config) as f:
        config = json.load(f)
    for key in ("trace_out", "telemetry_out", "report_out"):
        if getattr(args, key):
            config[key] = getattr(args, key)
    if args.xprof_dir or args.xprof_arm is not None:
        xp = config.get("xprof")
        xp = dict(xp) if isinstance(xp, dict) else ({"dir": xp} if xp else {})
        if args.xprof_dir:
            xp["dir"] = args.xprof_dir
        if args.xprof_arm is not None:
            xp["arm_at"] = args.xprof_arm
        if "dir" not in xp:
            parser.error("--xprof-arm needs --xprof-dir (or a config xprof.dir)")
        config["xprof"] = xp
    if args.heartbeat_every is not None:
        if args.heartbeat_every <= 0:
            config["heartbeat"] = False
        else:
            hb = config.get("heartbeat")
            hb = dict(hb) if isinstance(hb, dict) else {}
            hb["every"] = args.heartbeat_every
            config["heartbeat"] = hb
    if args.mesh:
        config["mesh"] = parse_mesh_flag(args.mesh)
    if args.sweep or args.sweep_metric or args.sweep_policy or args.sweep_registry_dir:
        from photon_ml_tpu_torch.cli.sweep import merge_sweep_flags

        sweep_cfg = merge_sweep_flags(config, grid=args.sweep, metric=args.sweep_metric,
                                      policy=args.sweep_policy,
                                      registry_dir=args.sweep_registry_dir)
        if not sweep_cfg or not sweep_cfg.get("grid"):
            parser.error("--sweep-metric/--sweep-policy/--sweep-registry-dir need a grid: "
                         "pass --sweep lambda=... (or config sweep.grid)")
        config["sweep"] = sweep_cfg
    if (args.warm_start or args.delta or args.refresh_registry_dir
            or args.lambda_points is not None):
        ws = dict(config.get("warm_start") or {})
        if args.warm_start:
            ws["dir"] = args.warm_start
        if args.delta:
            ws["delta_paths"] = list(ws.get("delta_paths") or ()) + list(args.delta)
        if args.refresh_registry_dir:
            ws["registry_dir"] = args.refresh_registry_dir
        if args.lambda_points is not None:
            ws["lambda_points"] = args.lambda_points
        if "dir" not in ws:
            parser.error("--delta/--refresh-registry-dir/--lambda-points need --warm-start "
                         "(or a config warm_start.dir)")
        config["warm_start"] = ws
    if args.ingest_workers is not None or args.prefetch_depth is not None:
        inp = dict(config.get("input") or {})
        ing = inp.get("ingest")
        ing = dict(ing) if isinstance(ing, dict) else {}
        if args.ingest_workers is not None:
            ing["workers"] = args.ingest_workers
        if args.prefetch_depth is not None:
            ing["prefetch_depth"] = args.prefetch_depth
        inp["ingest"] = ing
        config["input"] = inp
    if args.checkpoint_dir or args.checkpoint_every is not None or args.resume:
        ckpt = dict(config.get("checkpoint") or {})
        if args.checkpoint_dir:
            ckpt["dir"] = args.checkpoint_dir
        if args.checkpoint_every is not None:
            ckpt["every"] = args.checkpoint_every  # 0 reaches CheckpointSpec's check
        if args.resume:
            ckpt["resume"] = True
        if "dir" not in ckpt:
            parser.error("--checkpoint-every/--resume need --checkpoint-dir "
                         "(or a config checkpoint.dir)")
        config["checkpoint"] = ckpt
    summary = run(config, output_dir=args.output_dir, device=args.device)
    print(json.dumps(summary, default=float))
    # an interrupted run is incomplete: a non-zero code asks for a restart
    return 75 if summary.get("interrupted") else 0


if __name__ == "__main__":
    raise SystemExit(main())
