"""GAME online scoring server driver.

Counterpart of ``photon_ml_tpu/cli/serve.py``, the long-lived, low-latency
counterpart of the batch ``cli score`` driver:

    python -m photon_ml_tpu_torch.cli serve --registry-dir out/registry \\
        --port 8080 --max-batch 64 --queue-depth 256

    python -m photon_ml_tpu_torch.cli serve --model-dir out/model/best \\
        --mesh model=4 --frontend asyncio --batcher continuous \\
        --nearline memberId --nearline-publish-dir out/registry

    python -m photon_ml_tpu_torch.cli serve --model-dir out/model/best --stdio

    python -m photon_ml_tpu_torch.cli serve --registry-dir out/registry \\
        --member 1 --fleet-size 4 --announce-dir out/fleet \\
        --heartbeat-dir out/fleet/alive --hbm-budget-mb 64 --port 0

    python -m photon_ml_tpu_torch.cli serve --registry-dir out/registry \\
        --router --announce-dir out/fleet --port 8080

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

``--member i --fleet-size N`` serves as one shard-owning fleet member: the
process loads only its entity block of every random-effect table
(serving/shard.py), holds ``--hbm-budget-mb`` against the SLICE, announces
``member-<i>.json`` into ``--announce-dir`` once warm (and again at each
commit, at the new size and epoch), touches ``proc-<i>.alive`` under
``--heartbeat-dir``, and takes ``/v1/admin/stage`` + ``/v1/admin/commit``
for live resizes and hot swaps; at drain it prints its device's peak
allocated bytes. ``--router`` serves the fleet's routing front end instead:
lookups fan out to the owning members found in the announce directory and
the partial margins fold exactly (serving/router.py); an unreachable
member's rows degrade to fixed-effect-only scores. The router does no work
on a device (it folds on the host, as the reference's does), so it takes no
``--device``.

``--trace-out`` opens the span JSONL sink (suffixed per member in a fleet:
``trace.proc-<i>.jsonl``); the request records tail-sample into it, and the
drain path dumps the flight recorder (``flight-proc-<i>.json``) beside it.
``--telemetry-out`` (a member) appends a serving heartbeat line every
second (the cumulative request and margin-row counters, with ``proc``) and,
at drain, the final metrics snapshot, whose presence marks the member as
not lost in ``cli report --fleet``. ``--trace-sample-every N`` (the router)
samples every Nth routed batch: its full trace is persisted on the router
and the members.

SIGTERM/SIGINT drains gracefully: admission closes (503 with
``Retry-After``), in-flight batches finish, and the process exits 75. A
second signal hard-exits at once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from photon_ml_tpu_torch.utils import logger, setup_logging


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


class _ServingBeat:
    """A fleet member's serving heartbeat: one JSONL line every interval
    with the cumulative request and margin-row counters and ``proc``, so a
    supervisor's ``tail_heartbeat_fields`` poll can difference two beats
    into requests per second without calling the member."""

    def __init__(self, path: str, member: int, interval_s: float = 1.0):
        self.path = path
        self.member = int(member)
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()
        self._seq = 0
        self._t0 = time.monotonic()

    def beat(self) -> None:
        from photon_ml_tpu_torch import telemetry

        with self._lock:
            self._seq += 1
            seq = self._seq
        line = {
            "type": "heartbeat",
            "seq": seq,
            "proc": self.member,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "serving_requests_total": int(telemetry.counter("serving.requests").value),
            "serving_margin_rows_total": int(telemetry.counter("serving.margin_rows").value),
        }
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(line) + "\n")

    def start(self) -> "_ServingBeat":
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.beat()
        self._thread = threading.Thread(target=self._run, name="serving-beat", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except OSError as e:  # a removed workdir must not stop serving
                logger.warning("serving heartbeat write failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s * 4)
            self._thread = None


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


def _check_fleet_flags(args) -> None:
    """The reference's refusals of fleet flag combinations, before anything
    loads."""
    if args.member is not None and args.router:
        raise SystemExit("--member and --router are different fleet processes; run one")
    if args.member is not None or args.router:
        if not args.announce_dir:
            raise SystemExit("--member/--router require --announce-dir")
        incompatible = [flag for flag, on in (("--stdio", args.stdio),
                                              ("--nearline", args.nearline),
                                              ("--mesh", args.mesh)) if on]
        if incompatible:
            raise SystemExit("fleet processes replicate fixed effects and slice random-effect "
                             "tables per member; drop " + ", ".join(incompatible))
    if args.member is not None and args.fleet_size is None:
        raise SystemExit("--member requires --fleet-size")


def _version_dir(args, version=None) -> str:
    """A registry version (None: the newest) -> its published directory;
    ``--model-dir`` pins one directory. An unknown version raises
    ``KeyError`` (the front ends answer 409)."""
    from photon_ml_tpu_torch.serving import scan_versions

    if args.model_dir:
        return args.model_dir
    versions = scan_versions(args.registry_dir)
    if not versions:
        raise SystemExit(f"no published versions under {args.registry_dir}")
    if version is None:
        return versions[-1][1]
    for _, path in versions:
        if os.path.basename(os.path.normpath(path)) == str(version):
            return path
    raise KeyError(f"version {version!r} is not published under {args.registry_dir}")


def _owned_ranges(args, fleet_size: int, version: str) -> dict:
    """``{id_name: [lo, hi]}`` this member serves, from the version's
    ``model-metadata.json`` (for the announce record)."""
    from photon_ml_tpu_torch.parallel.sharding import member_row_range

    try:
        with open(os.path.join(_version_dir(args, version), "model-metadata.json")) as fh:
            meta = json.load(fh)
        out = {}
        for spec in (meta.get("coordinates") or {}).values():
            if spec.get("type") == "random_effect":
                out[spec["id_name"]] = list(member_row_range(int(spec["num_entities"]),
                                                             args.member, fleet_size))
        return out
    except (OSError, ValueError, KeyError):
        return {}


def _member_source(args, device):
    """A ``ShardMemberSource`` over ``load_member_engine``, its first slice
    staged and committed (loaded and warmed before serving: announcing is
    the readiness barrier)."""
    from photon_ml_tpu_torch.serving import ShardMemberSource, load_member_engine

    budget = None if args.hbm_budget_mb is None else int(args.hbm_budget_mb * 2**20)

    def load_slice(fleet_size, version=None):
        return load_member_engine(
            _version_dir(args, version), args.member, fleet_size, max_batch=args.max_batch,
            max_row_nnz=args.max_row_nnz, hbm_budget_bytes=budget,
            re_checkpoints=_parse_re_checkpoints(args.re_checkpoint), device=device)

    source = ShardMemberSource(load_slice, member=args.member, fleet_size=args.fleet_size)
    source.commit(*source.stage(args.fleet_size))
    return source


def main(argv=None) -> int:
    t_main = time.monotonic()
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
                        help="fail start-up when the model's tables (a fleet member: its "
                        "slice's) exceed this many MiB")
    parser.add_argument("--device", default="cuda",
                        help="the device that serves the model (default cuda; cpu runs "
                        "the kernels' plain PyTorch versions)")
    fleet = parser.add_argument_group("serving fleet (shard-owning members + routing front end)")
    fleet.add_argument("--member", type=int, help="serve as shard-owning fleet member i: load "
                       "only this member's entity block of every random-effect table")
    fleet.add_argument("--fleet-size", type=int, help="fleet size N the ownership map is "
                       "derived from (required with --member)")
    fleet.add_argument("--router", action="store_true", help="serve as the fleet's routing "
                       "front end: fan lookups out to the owning members, fold exactly")
    fleet.add_argument("--announce-dir", help="fleet rendezvous directory: members announce "
                       "member-<i>.json once warm; the router adopts the newest complete epoch "
                       "(required with --member / --router)")
    fleet.add_argument("--epoch", type=int, default=0,
                       help="announce epoch this member starts in")
    fleet.add_argument("--heartbeat-dir", help="touch proc-<member>.alive here on a cadence, "
                       "so a supervisor detects a dead member from the file's mtime")
    fleet.add_argument("--telemetry-out", help="a member: append its serving heartbeat JSONL "
                       "here (requests/s for the fleet status); the final metrics snapshot "
                       "flushes to the same stream at drain")
    parser.add_argument("--trace-out", help="span JSONL sink (suffixed per member in a fleet); "
                        "request records tail-sample into it, and the drain path dumps the "
                        "flight recorder (flight-proc-<i>.json) beside it")
    fleet.add_argument("--trace-sample-every", type=int, default=0,
                       help="router: sample every Nth routed batch (its full trace persisted "
                       "on the router and the members); 0: only slow, degraded and failed "
                       "requests persist")
    fleet.add_argument("--member-timeout-s", type=float, default=5.0,
                       help="router: per-member fan-out timeout before retry and degraded "
                       "fallback")
    fleet.add_argument("--router-refresh-s", type=float, default=0.5,
                       help="router: announce-directory rescan cadence")
    args = parser.parse_args(argv)
    _check_fleet_flags(args)

    setup_logging()
    from photon_ml_tpu_torch import faults, telemetry
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
    if args.trace_out:
        # suffixed per member: N fleet processes given one --trace-out write
        # N streams (the --fleet report's contract)
        telemetry.configure(trace_out=telemetry.member_artifact_path(args.trace_out))
    if args.stdio:
        ignored = [flag for flag, on in (("--nearline", args.nearline),
                                         ("--frontend", args.frontend != "threading"),
                                         ("--batcher", args.batcher)) if on]
        if ignored:
            raise SystemExit("--stdio is a bare engine loop with no batcher, front end, or "
                             "nearline path; drop " + ", ".join(ignored))
    registry = heartbeat = beat = device = None
    if args.router:
        from photon_ml_tpu_torch.serving import FleetRouter, fleet_lookups_from_version_dir

        task, link, lookups = fleet_lookups_from_version_dir(_version_dir(args))
        source = FleetRouter(args.announce_dir, lookups, task=task, link=link,
                             member_timeout_s=args.member_timeout_s,
                             refresh_interval_s=args.router_refresh_s, max_batch=args.max_batch,
                             sample_every=args.trace_sample_every)
    elif args.member is not None:
        device = resolve_device(args.device)
        t_load = time.monotonic()
        source = _member_source(args, device)
        load_s = time.monotonic() - t_load
    else:
        device = resolve_device(args.device)
        mesh = _build_mesh(args.mesh, device) if args.mesh else None
        if args.model_dir:
            source = ScoringEngine.load(
                args.model_dir, max_batch=args.max_batch, max_row_nnz=args.max_row_nnz,
                mesh=mesh, entity_axis=args.entity_axis,
                re_checkpoints=_parse_re_checkpoints(args.re_checkpoint),
                device=None if mesh is not None else device).warmup()
            _check_budget(source, args.hbm_budget_mb)
        else:
            if args.re_checkpoint:
                raise SystemExit("--re-checkpoint requires --model-dir (registry versions "
                                 "carry their own tables)")
            registry = ModelRegistry(args.registry_dir, max_batch=args.max_batch,
                                     max_row_nnz=args.max_row_nnz,
                                     poll_interval=args.poll_interval, mesh=mesh,
                                     entity_axis=args.entity_axis,
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

        epoch = {"epoch": int(args.epoch)}
        if args.member is not None:
            from photon_ml_tpu_torch.serving import write_announce

            def announce(fleet_size, version):
                write_announce(args.announce_dir, {
                    "member": args.member, "fleet_size": int(fleet_size),
                    "epoch": epoch["epoch"], "url": f"http://{args.host}:{server.port}",
                    "version": str(version), "ready": True, "pid": os.getpid(),
                    "owned": _owned_ranges(args, fleet_size, version)})

            def on_commit(key, payload):
                if payload.get("epoch") is not None:
                    epoch["epoch"] = int(payload["epoch"])
                announce(*key)

            service.on_commit = on_commit
            announce(source.fleet_size, source.engine.version)
            if args.heartbeat_dir:
                from photon_ml_tpu_torch.parallel.multihost import HeartbeatWriter

                heartbeat = HeartbeatWriter(args.heartbeat_dir, args.member).start()
            if args.telemetry_out:
                beat = _ServingBeat(args.telemetry_out, args.member).start()

        from photon_ml_tpu_torch.game.checkpoint import GracefulStop

        stop = GracefulStop(hard_exit_code=75).install()
        banner = {"host": args.host, "port": server.port, "frontend": args.frontend,
                  "batcher": batcher, "model_version": service.health().get("model_version")}
        if args.member is not None:
            # seconds from main() to the announce, and of them the slice's
            # load and warm-up (the interpreter's start and imports precede)
            banner.update(member=args.member, fleet_size=source.fleet_size,
                          epoch=epoch["epoch"], device=str(source.engine.device),
                          main_s=round(time.monotonic() - t_main, 3), load_s=round(load_s, 3))
        if args.router:
            banner["router"] = True
        print(json.dumps({"serving": banner}), flush=True)
        while not stop():
            time.sleep(0.2)
        logger.info("draining: admission closed (503 + Retry-After), in-flight batches "
                    "finishing; exiting %d", stop.hard_exit_code)
        service.drain()
        server.stop()
        # the flight recorder's drain-path dump: the last seconds of request
        # records land atomically beside the telemetry artifacts
        flight_dir = next((os.path.dirname(os.path.abspath(p))
                           for p in (args.trace_out, args.telemetry_out) if p), None)
        if flight_dir is not None:
            from photon_ml_tpu_torch.telemetry import identity, requests

            proc = identity.fleet_process_index()
            if proc is None:
                proc = args.member or 0
            requests.flight_dump(requests.flight_path(flight_dir, proc))
        if args.telemetry_out:
            # the final snapshot marks this member "ok", not lost, in the
            # fleet report
            telemetry.flush_metrics(args.telemetry_out)
        if args.member is not None:
            import torch

            peak = (torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else None)
            print(json.dumps({"drained": {"member": args.member,
                                          "device": str(source.engine.device),
                                          "max_memory_allocated": peak}}), flush=True)
        return stop.hard_exit_code
    finally:
        if beat is not None:
            beat.stop()
        if heartbeat is not None:
            heartbeat.stop()
        if registry is not None:
            registry.stop()
        if args.router:
            source.close()


if __name__ == "__main__":
    raise SystemExit(main())
