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
with an ``interrupted`` summary and exit code 75. The reference's progress heartbeat (a log line
every ~30 s) is not started. Every key and flag the port cannot honour yet
raises ``NotImplementedError`` naming its ROADMAP.md Queue 1 item:
``warm_start``, ``--warm-start``, ``--delta``, ``--refresh-registry-dir``,
``--lambda-points`` (14b);
``distributed`` and a run across processes (12); ``trace_out``, ``telemetry_out``,
``report_out``, ``xprof``, their flags, a ``heartbeat`` object or interval
and ``--heartbeat-every`` > 0 (14).

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

from photon_ml_tpu_torch.config import parse_game_config
from photon_ml_tpu_torch.game.checkpoint import CheckpointSpec, GracefulStop, TrainingInterrupted
from photon_ml_tpu_torch.game.coordinates import NOT_PORTED
from photon_ml_tpu_torch.game.dataset import FeatureShard, GameDataset, build_game_dataset
from photon_ml_tpu_torch.game.estimator import GameEstimator
from photon_ml_tpu_torch.optim.guard import GuardSpec
from photon_ml_tpu_torch.utils import setup_logging, timed

# config keys the port refuses, with the ROADMAP.md Queue 1 item that ports them
_REFUSED_KEYS = {"warm_start": "14b", "distributed": 12,
                 "trace_out": 14, "telemetry_out": 14, "report_out": 14, "xprof": 14}


def _refuse(what: str, item):
    raise NotImplementedError(NOT_PORTED.format(what, item))


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


def build_mesh(config: Mapping, device: torch.device | str | None = None):
    """The training mesh of the config's ``mesh`` key, or None: over the
    first CUDA devices, or on the CPU over the CPU repeated. A run across
    processes is refused (ROADMAP.md Queue 1 item 12), as the reference's
    ``cli train`` refuses to span processes."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        _refuse("a train run across processes", 12)
    spec = config.get("mesh")
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


def _check_heartbeat(config: Mapping) -> None:
    """``heartbeat`` true, false, null or 0 start nothing; an object or an
    interval asks for the reference's heartbeat, which is not ported."""
    spec = config.get("heartbeat", True)
    if spec is None or isinstance(spec, bool) or spec == 0:
        return
    _refuse("the progress heartbeat (heartbeat)", 14)


def run(config: Mapping, output_dir: Optional[str] = None,
        device: torch.device | str | None = None) -> dict:
    """Run the training pipeline on ``device`` (default cuda); returns a
    JSON-safe summary."""
    for key, item in _REFUSED_KEYS.items():
        if config.get(key):
            _refuse(f"the train config key '{key}'", item)
    _check_heartbeat(config)
    game_config = parse_game_config(config)
    output_dir = output_dir or config.get("output_dir")
    guard = _parse_guard_spec(config)
    checkpoint_spec = _parse_checkpoint_spec(config)
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
    mesh = build_mesh(config, device)
    stop = GracefulStop()
    if checkpoint_spec is not None:
        # without a checkpoint nothing durable is written on SIGTERM, so the
        # default handling (die at once) is the right one
        stop.install()

    with timed("read training data"):
        train_data, index_maps = read_input(config["input"], device=device)
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
    if config.get("sweep"):
        # every λ at once and the winner under <output_dir>/best, instead of
        # a single fit (cli/sweep.py)
        from photon_ml_tpu_torch.cli.sweep import run_sweep_fit

        with timed("sweep"):
            sweep_summary = run_sweep_fit(estimator, config["sweep"], train_data,
                                          validation_data, output_dir,
                                          device=train_data.device, index_maps=index_maps)
        if output_dir is not None and index_maps is not None:
            with timed("save index maps"):
                for shard, imap in index_maps.items():
                    imap.save(os.path.join(output_dir, "best", "feature-indexes", shard))
        return {"sweep": sweep_summary, "best_metric": sweep_summary["selected_metric"],
                "output_dir": output_dir, "num_rows": train_data.num_rows}
    try:
        with timed("fit"):
            result = estimator.fit(
                train_data, validation_data=validation_data, output_dir=output_dir,
                guard=guard, device=train_data.device, mesh=mesh,
                checkpoint_spec=checkpoint_spec,
                should_stop=stop if checkpoint_spec is not None else None)
    except TrainingInterrupted as e:
        # the final checkpoint is on disk: report, and a restart resumes
        return {"interrupted": True, "interrupted_at_step": e.step,
                "checkpoint": e.checkpoint_path, "output_dir": output_dir,
                "num_rows": train_data.num_rows}
    if output_dir is not None and index_maps is not None:
        _persist_feature_artifacts(output_dir, index_maps, train_data)
    return {
        "output_dir": output_dir,
        "best_metric": result.best_metric,
        "num_rows": train_data.num_rows,
        # each entry without its solve results (tensors), so JSON-safe
        "history": [{k: v for k, v in e.items() if k != "results"} for e in result.history],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli train",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="JSON config path")
    parser.add_argument("--output-dir", help="override config output_dir")
    parser.add_argument("--device", default="cuda",
                        help="the device that reads, trains and scores (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")
    # the reference's flags, refused with their ROADMAP item
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
    refused = {"--trace-out": 14, "--telemetry-out": 14, "--report-out": 14,
               "--xprof-dir": 14, "--xprof-arm": 14,
               "--warm-start": "14b", "--delta": "14b", "--refresh-registry-dir": "14b",
               "--lambda-points": "14b"}
    for flag in refused:
        parser.add_argument(flag, action="append", help=argparse.SUPPRESS)
    parser.add_argument("--heartbeat-every", type=float, help=argparse.SUPPRESS)
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
    for flag, item in refused.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            _refuse(f"the train flag {flag}", item)
    if args.heartbeat_every is not None and args.heartbeat_every > 0:
        _refuse("the train flag --heartbeat-every", 14)
    setup_logging()
    with open(args.config) as f:
        config = json.load(f)
    if args.heartbeat_every is not None:
        config["heartbeat"] = False
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
