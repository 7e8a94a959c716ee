"""GAME online scoring server driver.

Counterpart of ``photon_ml_tpu/cli/serve.py``, the long-lived, low-latency
counterpart of the batch ``cli score`` driver:

    python -m photon_ml_tpu_torch.cli serve --registry-dir out/registry \\
        --port 8080 --max-batch 64 --queue-depth 256

    python -m photon_ml_tpu_torch.cli serve --model-dir out/model/best \\
        --mesh model=4 --frontend asyncio --batcher continuous \\
        --nearline memberId --nearline-publish-dir out/registry

    python -m photon_ml_tpu_torch.cli serve --model-dir out/model/best --stdio

``--registry-dir`` watches a versioned models directory and hot-swaps to the
newest valid version (serving/registry.py); ``--model-dir`` pins one saved
model (still requiring its ``feature-indexes/``). ``--mesh model=N`` splits
the random-effect tables over an N-device model axis; ``--re-checkpoint
coord=dir`` restores that coordinate's table from a streamed checkpoint
straight onto the serving mesh. ``--frontend asyncio`` swaps the
thread-per-connection server for the event-loop one; ``--batcher
continuous`` swaps the deadline batcher for continuous batching.
``--nearline <id_name>`` accepts ``POST /v1/update`` feedback events.
``--stdio`` serves a JSONL stdin/stdout loop instead of HTTP.
``--hbm-budget-mb`` fails start-up when the model's tables exceed the budget
(or the budget exceeds the card, ``torch.cuda.mem_get_info``). ``--device``
(default cuda) is where the model is served; ``cpu`` runs the kernels'
plain versions.

Refused with ``NotImplementedError`` naming their ROADMAP item: the fleet
flags (``--member``, ``--fleet-size``, ``--router``, ``--announce-dir``,
``--epoch``, ``--member-timeout-s``, ``--router-refresh-s``,
``--heartbeat-dir``: Queue 1 item 14a (ii)) and the telemetry flags
(``--telemetry-out``, ``--trace-out``, ``--trace-sample-every``: item 14d).

SIGTERM/SIGINT drains gracefully: admission closes (503 with
``Retry-After``), in-flight batches finish, and the process exits 75. A
second signal hard-exits at once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from photon_ml_tpu_torch.utils import logger, setup_logging

NOT_PORTED = ("the 'serve' flag {flag} is not ported to photon_ml_tpu_torch yet "
              "(ROADMAP.md Queue 1 item {item})")

# the reference's flags that this package refuses, with their ROADMAP item
_REFUSED = {
    "--member": "14a (ii)", "--fleet-size": "14a (ii)", "--router": "14a (ii)",
    "--announce-dir": "14a (ii)", "--epoch": "14a (ii)", "--member-timeout-s": "14a (ii)",
    "--router-refresh-s": "14a (ii)", "--heartbeat-dir": "14a (ii)",
    "--telemetry-out": "14d", "--trace-out": "14d", "--trace-sample-every": "14d",
}


def _build_mesh(raw: str, device):
    """``--mesh`` -> a serving Mesh (or None for off): over the first N
    CUDA devices, or ``device`` repeated when it is the CPU."""
    import numpy as np
    import torch

    from photon_ml_tpu_torch.cli.train import parse_mesh_flag
    from photon_ml_tpu_torch.parallel.mesh import make_mesh
    from photon_ml_tpu_torch.parallel.sharding import MODEL_AXIS

    spec = parse_mesh_flag(raw)
    if spec is False:
        return None
    if device.type == "cpu":
        sizes = {MODEL_AXIS: 1} if spec is True else {k: int(v) for k, v in spec.items()}
        return make_mesh(sizes, [device] * int(np.prod(list(sizes.values()))))
    if spec is True:
        spec = {MODEL_AXIS: torch.cuda.device_count()}
    return make_mesh({k: int(v) for k, v in spec.items()})


def _parse_re_checkpoints(pairs):
    out = {}
    for pair in pairs or ():
        coord, eq, directory = pair.partition("=")
        if not eq or not coord or not directory:
            raise ValueError(f"--re-checkpoint expects 'coord=dir', got {pair!r}")
        out[coord] = directory
    return out or None


def _check_budget(engine, budget_mb) -> None:
    """Fail start-up when the model's tables exceed ``--hbm-budget-mb``, or
    the budget exceeds what the card holds (``torch.cuda.mem_get_info``)."""
    import torch

    if budget_mb is None:
        return
    budget = int(budget_mb * 2**20)
    if engine.model_bytes > budget:
        raise SystemExit(f"model tables take {engine.model_bytes} bytes, over the "
                         f"--hbm-budget-mb budget of {budget} bytes")
    if engine.device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(engine.device)
        if budget > total:
            raise SystemExit(f"--hbm-budget-mb {budget_mb} exceeds the {total} bytes of "
                             f"{engine.device}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli serve",
                                     description=__doc__.splitlines()[0])
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-dir", help="serve one saved GAME model dir")
    src.add_argument("--registry-dir", help="watch a versioned models directory and "
                     "hot-swap to the newest valid version")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--mesh", help="serve entity-sharded: 'model=N' splits the "
                        "random-effect tables over N devices ('auto': every CUDA device)")
    parser.add_argument("--entity-axis", help="mesh axis to shard entity rows over "
                        "(default: the mesh's model axis)")
    parser.add_argument("--re-checkpoint", action="append", metavar="COORD=DIR",
                        help="restore this coordinate's table from a streamed checkpoint "
                        "directory onto the serving mesh (repeatable)")
    parser.add_argument("--frontend", choices=("threading", "asyncio"), default="threading",
                        help="HTTP front end (asyncio defaults --batcher to continuous)")
    parser.add_argument("--batcher", choices=("deadline", "continuous"),
                        help="request scheduler (default: continuous under --frontend "
                        "asyncio, deadline otherwise)")
    parser.add_argument("--max-batch", type=int, default=64,
                        help="largest padded device batch (buckets are powers of two up "
                        "to this)")
    parser.add_argument("--max-delay-ms", type=float, default=5.0,
                        help="micro-batching deadline (deadline batcher only)")
    parser.add_argument("--queue-depth", type=int, default=256,
                        help="pending-row cap before requests are shed with 503")
    parser.add_argument("--max-row-nnz", type=int, default=128,
                        help="per-shard feature cap per request row")
    parser.add_argument("--poll-interval", type=float, default=2.0,
                        help="registry watch interval in seconds")
    parser.add_argument("--nearline", metavar="ID_NAME",
                        help="accept POST /v1/update feedback events and re-solve that "
                        "random-effect coordinate's entity rows")
    parser.add_argument("--nearline-flush-s", type=float, default=1.0,
                        help="nearline flush cadence in seconds")
    parser.add_argument("--nearline-publish-dir",
                        help="persist nearline-updated tables as new registry versions "
                        "here (defaults to --registry-dir when watching one)")
    parser.add_argument("--nearline-publish-s", type=float, default=30.0,
                        help="minimum seconds between nearline version publishes")
    parser.add_argument("--stdio", action="store_true",
                        help="serve a JSONL request/response loop on stdin/stdout")
    parser.add_argument("--hbm-budget-mb", type=float,
                        help="fail start-up when the model's tables exceed this many MiB")
    parser.add_argument("--device", default="cuda",
                        help="the device that serves the model (default cuda; cpu runs "
                        "the kernels' plain PyTorch versions)")
    for flag in _REFUSED:
        if flag == "--router":
            parser.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
        else:
            parser.add_argument(flag, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    for flag, item in _REFUSED.items():
        if getattr(args, flag[2:].replace("-", "_")):
            raise NotImplementedError(NOT_PORTED.format(flag=flag, item=item))

    setup_logging()
    from photon_ml_tpu_torch import faults
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.serving import (
        AsyncScoringServer,
        ModelRegistry,
        NearlineUpdater,
        ScoringEngine,
        ScoringServer,
        ScoringService,
        serve_stdio,
    )

    # a serving process with an armed fault plan WILL fail requests on purpose
    faults.warn_if_armed()
    if args.stdio:
        ignored = [flag for flag, on in (("--nearline", args.nearline),
                                         ("--frontend", args.frontend != "threading"),
                                         ("--batcher", args.batcher)) if on]
        if ignored:
            raise SystemExit("--stdio is a bare engine loop with no batcher, front end, or "
                             "nearline path; drop " + ", ".join(ignored))
    device = resolve_device(args.device)
    mesh = _build_mesh(args.mesh, device) if args.mesh else None
    registry = None
    if args.model_dir:
        source = ScoringEngine.load(
            args.model_dir, max_batch=args.max_batch, max_row_nnz=args.max_row_nnz,
            mesh=mesh, entity_axis=args.entity_axis,
            re_checkpoints=_parse_re_checkpoints(args.re_checkpoint),
            device=None if mesh is not None else device).warmup()
        _check_budget(source, args.hbm_budget_mb)
    else:
        if args.re_checkpoint:
            raise SystemExit("--re-checkpoint requires --model-dir (registry versions carry "
                             "their own tables)")
        registry = ModelRegistry(args.registry_dir, max_batch=args.max_batch,
                                 max_row_nnz=args.max_row_nnz, poll_interval=args.poll_interval,
                                 mesh=mesh, entity_axis=args.entity_axis,
                                 device=None if mesh is not None else device)
        registry.start()
        source = registry
        _check_budget(registry.engine, args.hbm_budget_mb)

    try:
        if args.stdio:
            return serve_stdio(source, sys.stdin, sys.stdout)
        batcher = args.batcher or ("continuous" if args.frontend == "asyncio" else "deadline")
        service = ScoringService(source, max_batch=args.max_batch,
                                 max_delay_ms=args.max_delay_ms, queue_depth=args.queue_depth,
                                 batcher=batcher)
        if args.nearline:
            publish_dir = args.nearline_publish_dir or args.registry_dir
            engine = source.engine if registry is not None else source
            service.attach_nearline(NearlineUpdater(
                source, id_name=args.nearline, flush_interval_s=args.nearline_flush_s,
                publish_dir=publish_dir, publish_interval_s=args.nearline_publish_s,
                index_maps=engine.index_maps if publish_dir else None))
        server_cls = AsyncScoringServer if args.frontend == "asyncio" else ScoringServer
        server = server_cls(service, host=args.host, port=args.port)
        server.start()

        from photon_ml_tpu_torch.game.checkpoint import GracefulStop

        stop = GracefulStop(hard_exit_code=75).install()
        banner = {"host": args.host, "port": server.port, "frontend": args.frontend,
                  "batcher": batcher, "model_version": service.health().get("model_version")}
        print(json.dumps({"serving": banner}), flush=True)
        while not stop():
            time.sleep(0.2)
        logger.info("draining: admission closed (503 + Retry-After), in-flight batches "
                    "finishing; exiting %d", stop.hard_exit_code)
        service.drain()
        server.stop()
        return stop.hard_exit_code
    finally:
        if registry is not None:
            registry.stop()


if __name__ == "__main__":
    raise SystemExit(main())
