"""Supervise a training fleet: launch, watch and relaunch on the survivors a
multi-process streamed random-effect fit.

Counterpart of the training half of the repo's ``tools/fleet.py``
(``make_problem``, ``FleetSpec``, ``run_fleet``,
``verify_certified_checkpoints`` and the worker). A fleet is N worker
processes that join one ``torch.distributed`` rendezvous
(``parallel.multihost.initialize``, bounded retry; gloo when members share
a card or run on the CPU, NCCL when each owns a card) and run the streamed
entity-sharded fit with coordinated checkpoints:

1. **launch**: each worker drives its own device (``--device``), places the
   table's blocks of its positions of the fleet's ``entity`` axis and is fed
   only its ``process_slice`` of every chunk (``LocalChunk``);
2. **watch**: exit codes, and the heartbeat files (``proc-<i>.alive``,
   stale past a deadline = dead: the member is killed). A member exiting
   with the injection code 113, or whose file goes stale, marks its host
   lost;
3. **stop the survivors**: SIGTERM asks for the boundary stop
   (``GracefulStop`` and ``multihost.fleet_any`` make every member stop at
   the same boundary); a member stuck in a collective against the dead
   peer is killed after ``grace_s``; its work since the last certified
   checkpoint is replayed;
4. **relaunch on the survivors**: a smaller fleet restores the newest
   certified checkpoint with ``restore_placed`` (the entity axis cut again
   for the smaller mesh) and goes on from its ``next_chunk``.

A SIGTERM to one member (an external preemption) goes through the same
agreement: every member writes the coordinated checkpoint and exits 75.

Two problems: ``small`` is the reference's (16 entities x 8 rows x 4
features in 4 chunks, numpy from ``DATA_SEED``); ``scale`` is the
``per_user_re`` part of bench_scale.py (1M entities x 512 features, chunks
of 125,000 entities x 8 rows, LBFGS 8, tolerance 1e-5, history 4, L2 1),
each member making only its rows of each chunk on its device
(:func:`scale_rows`). Workers run on ``cuda`` unless the spec asks for the
CPU. Each member prints one JSON line at its end with its start-up seconds,
backend, fit seconds, coefficients per second, peak allocated bytes and
``comms.wait_seconds_total``.

Left out, with the ROADMAP item that owns it: the members' trace and
telemetry streams (``PHOTON_TRACE_OUT``/``PHOTON_TELEMETRY_OUT``) and the
progress heartbeat (item 14d): ``FleetSpec.telemetry`` is False, and True
raises.

    python -m photon_ml_tpu_torch.tools.fleet --workdir out/fleet --device cpu
    python -m photon_ml_tpu_torch.tools.fleet --worker ...   # one member (internal)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional

import numpy as np

#: the small worker problem, the reference's (tools/fleet.py:69-104)
N_ENTITIES = 16
N_ROWS = 8
DIM = 4
N_CHUNKS = 4
DATA_SEED = 20260803

#: bench_scale.py:137-139's per_user_re part: entities, features, entities a
#: chunk, rows an entity, the part's seed; made in blocks of SCALE_BLOCK
#: entities, each from its own generator, so any member's slice of a chunk is
#: made alone (4 members: one block each)
SCALE_PART = (1_000_000, 512, 125_000, 8, 1)
SCALE_BLOCK = 31_250

#: the exit code of a graceful boundary stop
GRACEFUL_EXIT_CODE = 75
#: a member that saw the fleet break (a collective failed against a dead
#: peer) exits with this through ``os._exit``; its host is fine
FLEET_ABORT_EXIT_CODE = 76
#: the injection's exit code (faults.DEFAULT_EXIT_CODE): a lost host
LOST_HOST_EXIT_CODE = 113

#: the fault plan the supervisor hands the victim; the worker installs it
#: at the boundary after ``--arm-after-chunk``, so the rule fires after a
#: certified checkpoint whatever the machine's speed
ARMED_PLAN_ENV = "PHOTON_FLEET_ARMED_PLAN"


def make_problem():
    """The small worker problem ``(X, y)``: every member, and the scorer of
    the final loss, makes the same data from ``DATA_SEED``."""
    rng = np.random.default_rng(DATA_SEED)
    X = rng.normal(size=(N_ENTITIES, N_ROWS, DIM))
    W = rng.normal(size=(N_ENTITIES, DIM))
    z = np.einsum("erk,ek->er", X, W)
    y = (rng.random((N_ENTITIES, N_ROWS)) < 1 / (1 + np.exp(-z))).astype(np.float32)
    return X.astype(np.float32), y


def small_config():
    """The small problem's solver (the reference worker's)."""
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )

    return OptimizerConfig(max_iterations=60, tolerance=1e-9, regularization_weight=0.3,
                           regularization=RegularizationContext(RegularizationType.L2))


def scale_config():
    """bench_scale.py:49-55's solver: logistic LBFGS 8, tolerance 1e-5,
    history 4, L2 1."""
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )

    return OptimizerConfig(max_iterations=8, tolerance=1e-5, lbfgs_history=4,
                           regularization=RegularizationContext(RegularizationType.L2),
                           regularization_weight=1.0)


def scale_rows(seed: int, part_seed: int, index: int, lo: int, hi: int, rows: int, dims: int,
               device="cuda"):
    """Entities ``[lo, hi)`` of chunk ``index`` of bench_scale.py:60-74's
    planted logistic part, made on ``device``: X ~ N(0, 1), w* ~ N(0, 0.3),
    offsets N(0, 0.2) for the other coordinates' scores, labels
    Bernoulli(sigmoid(X.w* + offset)). Each block of ``SCALE_BLOCK``
    entities comes from its own generator, seeded by (seed, part, chunk,
    block), so rows made alone are the same bits as in a whole chunk; the
    margins are an elementwise product and a sum (no GEMM)."""
    import torch

    from photon_ml_tpu_torch.ops.dense import DenseBatch

    if lo % SCALE_BLOCK or (hi % SCALE_BLOCK and hi - lo > 0):
        raise ValueError(f"rows [{lo}, {hi}) must be whole blocks of {SCALE_BLOCK}")
    n = hi - lo
    x = torch.empty((n, rows, dims), device=device)
    w_true = torch.empty((n, dims), device=device)
    off = torch.empty((n, rows), device=device)
    y = torch.empty((n, rows), device=device)
    for b in range(lo // SCALE_BLOCK, -(-hi // SCALE_BLOCK)):
        a, e = b * SCALE_BLOCK - lo, min((b + 1) * SCALE_BLOCK, hi) - lo
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([seed, part_seed, index, b])
                          .generate_state(1)[0]))
        x[a:e].normal_(generator=g)
        w_true[a:e].normal_(std=0.3, generator=g)
        off[a:e].normal_(std=0.2, generator=g)
        z = (x[a:e] * w_true[a:e, None, :]).sum(-1) + off[a:e]
        y[a:e] = (torch.rand((e - a, rows), generator=g, device=device)
                  < torch.sigmoid(z)).float()
    return DenseBatch(x=x, labels=y, offsets=off, weights=torch.ones_like(y))


def _chunk_rows(problem: str, seed: int, index: int, lo: int, hi: int, device):
    """Entities ``[lo, hi)`` of chunk ``index`` (within the chunk) of
    ``problem`` as a ``DenseBatch`` on ``device``."""
    import torch

    from photon_ml_tpu_torch.ops.dense import DenseBatch

    if problem == "scale":
        _, dims, _, rows, part_seed = SCALE_PART
        return scale_rows(seed, part_seed, index, lo, hi, rows, dims, device)
    X, y = make_problem()
    per = N_ENTITIES // N_CHUNKS
    g_lo, g_hi = index * per + lo, index * per + hi
    return DenseBatch(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        X[g_lo:g_hi], y[g_lo:g_hi], np.zeros((g_hi - g_lo, N_ROWS), np.float32),
        np.ones((g_hi - g_lo, N_ROWS), np.float32))))


def problem_shape(problem: str) -> tuple[int, int, int, int]:
    """(entities, features, entities a chunk, chunks) of ``problem``."""
    if problem == "scale":
        n, dims, per, _, _ = SCALE_PART
        return n, dims, per, n // per
    return N_ENTITIES, DIM, N_ENTITIES // N_CHUNKS, N_CHUNKS


def problem_config(problem: str):
    return scale_config() if problem == "scale" else small_config()


def problem_loss(problem: str, seed: int, table, device="cpu") -> float:
    """The fit's objective at ``table`` ([N, K], host or device): the sum over
    entities of the logistic loss of its rows plus its L2 term, in float64,
    chunk by chunk."""
    import torch

    n, _, per, chunks = problem_shape(problem)
    lam = problem_config(problem).regularization_weight
    total = 0.0
    for i in range(chunks):
        b = _chunk_rows(problem, seed, i, 0, per, device)
        w = torch.as_tensor(np.asarray(table[i * per:(i + 1) * per]) if not isinstance(
            table, torch.Tensor) else table[i * per:(i + 1) * per]).to(device, torch.float64)
        z = (b.x.double() * w[:, None, :]).sum(-1) + b.offsets.double()
        nll = torch.nn.functional.softplus(z) - b.labels.double() * z
        total += float((b.weights.double() * nll).sum() + 0.5 * lam * (w * w).sum())
    return total


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class FleetSpec:
    """One supervised fleet run, relaunches included."""

    workdir: str
    num_processes: int = 2
    #: the members' device: "cuda" (member i on ``cuda:(i mod count)`` with
    #: ``distinct_cards``, else every member on ``cuda:0``) or "cpu"
    device: str = "cuda"
    distinct_cards: bool = False
    problem: str = "small"
    seed: int = 0
    #: a coordinated checkpoint every this many chunk boundaries (and at the end)
    checkpoint_every: int = 1
    heartbeat_every_s: float = 0.25
    #: staleness past which a member with no exit code counts dead
    heartbeat_deadline_s: float = 5.0
    #: how long the survivors get to reach their boundary stop after SIGTERM
    #: before they are killed
    grace_s: float = 12.0
    #: the coordinated checkpoints' quorum wait (well under grace_s)
    quorum_timeout_s: float = 4.0
    max_relaunches: int = 2
    timeout_s: float = 600.0
    #: a fault plan armed on exactly one member of the first generation, from
    #: the boundary after chunk ``victim_arm_after_chunk``; -1 arms it from
    #: the process's start (``PHOTON_FAULT_PLAN``), for a seam hit before the
    #: first chunk (``multihost.init``)
    victim_plan: Optional[dict] = None
    victim_process: int = 1
    victim_arm_after_chunk: int = 0
    #: SIGTERM to this member this many seconds after its first heartbeat
    sigterm_after_s: Optional[float] = None
    sigterm_process: int = 0
    #: stretch each chunk boundary so signals land mid-fit (tests)
    chunk_sleep_s: float = 0.0
    #: the members' trace/telemetry streams and progress heartbeat: item 14d
    telemetry: bool = False
    status_file: Optional[str] = None
    status_port: Optional[int] = None
    status_interval_s: float = 1.0

    def __post_init__(self):
        if self.telemetry:
            from photon_ml_tpu_torch.game.coordinates import NOT_PORTED

            raise NotImplementedError(NOT_PORTED.format(
                "the fleet members' trace and telemetry streams and progress heartbeat "
                "(FleetSpec.telemetry)", "14d"))
        if self.problem not in ("small", "scale"):
            raise ValueError(f"problem must be 'small' or 'scale', got {self.problem!r}")

    def member_device(self, proc: int) -> str:
        if self.device != "cuda":
            return self.device
        if not self.distinct_cards:
            return "cuda:0"
        import torch

        return f"cuda:{proc % max(torch.cuda.device_count(), 1)}"


def _worker_env(spec: FleetSpec, proc: int, nproc: int, armed: bool) -> dict:
    env = dict(os.environ)
    env.pop("PHOTON_FAULT_PLAN", None)
    env.pop(ARMED_PLAN_ENV, None)
    if armed and spec.victim_plan is not None:
        key = "PHOTON_FAULT_PLAN" if spec.victim_arm_after_chunk < 0 else ARMED_PLAN_ENV
        env[key] = json.dumps(spec.victim_plan)
    env["PHOTON_PROC_ID"] = str(proc)
    env["PHOTON_PROC_COUNT"] = str(nproc)
    root = _repo_root()
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


@dataclasses.dataclass
class _Member:
    proc: subprocess.Popen
    process_id: int
    out_path: str
    err_path: str
    rc: Optional[int] = None
    lost_host: bool = False
    lost_at: Optional[float] = None
    #: seconds from the member's last heartbeat to the verdict
    detect_s: Optional[float] = None

    def mark_lost(self, fleet_dir: str, now: float) -> None:
        from photon_ml_tpu_torch.parallel import multihost

        self.lost_host, self.lost_at = True, now
        try:
            # wall clock by necessity: the file's mtime is one
            self.detect_s = time.time() - os.path.getmtime(
                multihost.heartbeat_path(fleet_dir, self.process_id))
        except OSError:
            self.detect_s = None


def _launch_generation(spec: FleetSpec, generation: int, nproc: int,
                       arm_victim: bool) -> list[_Member]:
    fleet_dir = os.path.join(spec.workdir, "fleet")
    os.makedirs(fleet_dir, exist_ok=True)
    # the previous generation's liveness files must not mask a new death
    for name in os.listdir(fleet_dir):
        if name.endswith(".alive"):
            try:
                os.unlink(os.path.join(fleet_dir, name))
            except OSError:
                pass
    port = _free_port()
    members = []
    for pid in range(nproc):
        out_path = os.path.join(spec.workdir, f"gen{generation}-proc{pid}.out")
        err_path = os.path.join(spec.workdir, f"gen{generation}-proc{pid}.err")
        armed = arm_victim and pid == spec.victim_process
        argv = [sys.executable, "-m", "photon_ml_tpu_torch.tools.fleet", "--worker",
                "--proc", str(pid), "--nproc", str(nproc), "--port", str(port),
                "--dir", spec.workdir, "--device", spec.member_device(pid),
                "--problem", spec.problem, "--seed", str(spec.seed),
                "--checkpoint-every", str(spec.checkpoint_every),
                "--quorum-timeout", str(spec.quorum_timeout_s),
                "--heartbeat-every", str(spec.heartbeat_every_s),
                "--arm-after-chunk", str(spec.victim_arm_after_chunk),
                "--chunk-sleep", str(spec.chunk_sleep_s)]
        with open(out_path, "wb") as out, open(err_path, "wb") as err:
            proc = subprocess.Popen(argv, env=_worker_env(spec, pid, nproc, armed),
                                    cwd=_repo_root(), stdout=out, stderr=err)
        members.append(_Member(proc, pid, out_path, err_path))
    return members


def _signal_all(members: list[_Member], sig) -> None:
    for m in members:
        if m.proc.poll() is None:
            try:
                m.proc.send_signal(sig)
            except OSError:
                pass


def _member_line(path: str) -> Optional[dict]:
    """The last JSON object line a member printed, or None."""
    try:
        with open(path, encoding="utf-8", errors="replace") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    return None


def _supervise_generation(spec: FleetSpec, generation: int, nproc: int, deadline: float,
                          status=None) -> dict:
    """One generation to its end: exit codes, detected deaths, whether any
    member had to be killed, the members' own lines."""
    from photon_ml_tpu_torch.parallel import multihost

    fleet_dir = os.path.join(spec.workdir, "fleet")
    launched = time.monotonic()
    members = _launch_generation(spec, generation, nproc, arm_victim=generation == 0)
    if status is not None:
        status.update(generation=generation, num_processes=nproc, rcs={}, deaths=[],
                      outcome=None)
    sigterm_sent, sigterm_anchor = False, None
    stopping, stop_started = False, 0.0
    escalated: list[int] = []
    up_at: Optional[float] = None
    outcome = None
    try:
        while True:
            now = time.monotonic()
            if now > deadline:
                _signal_all(members, signal.SIGKILL)
                outcome = "timeout"
                break
            if up_at is None and all(os.path.exists(multihost.heartbeat_path(fleet_dir, m.process_id))
                                     for m in members):
                up_at = now
            if spec.sigterm_after_s is not None and not sigterm_sent:
                if sigterm_anchor is None and os.path.exists(
                        multihost.heartbeat_path(fleet_dir, spec.sigterm_process)):
                    sigterm_anchor = now
                if sigterm_anchor is not None and now - sigterm_anchor >= spec.sigterm_after_s:
                    for m in members:
                        if m.process_id == spec.sigterm_process and m.proc.poll() is None:
                            m.proc.send_signal(signal.SIGTERM)
                    sigterm_sent = True
            # 113 (the injection's code) = a lost host; 76 = a member that saw
            # the fleet break (its host is kept); other codes are crashes
            for m in members:
                if m.rc is None and m.proc.poll() is not None:
                    m.rc = m.proc.returncode
                    if m.rc == LOST_HOST_EXIT_CODE:
                        m.mark_lost(fleet_dir, now)
            if now - launched > spec.heartbeat_deadline_s:
                for pid in multihost.dead_peers(fleet_dir, nproc, spec.heartbeat_deadline_s):
                    m = members[pid]
                    if m.lost_host:
                        continue
                    if m.rc is None and m.proc.poll() is None:
                        m.proc.send_signal(signal.SIGKILL)
                        m.proc.wait()
                        m.rc = m.proc.returncode
                        m.mark_lost(fleet_dir, now)
                        escalated.append(pid)
            lost = [m for m in members if m.lost_host]
            broken = [m for m in members if m.rc is not None
                      and m.rc not in (0, GRACEFUL_EXIT_CODE) and m.process_id not in escalated]
            alive = [m for m in members if m.rc is None]
            if (lost or broken) and not stopping:
                stopping, stop_started = True, now
                _signal_all(members, signal.SIGTERM)
            if (stopping and alive and now - stop_started > spec.grace_s
                    and not any(m.process_id in escalated for m in alive)):
                # survivors stuck in a collective against the dead member
                # never reach the boundary: the certified checkpoint replays
                escalated.extend(m.process_id for m in alive)
                _signal_all(members, signal.SIGKILL)
            if status is not None:
                status.update(rcs={m.process_id: m.rc for m in members if m.rc is not None},
                              deaths=[m.process_id for m in members if m.lost_host])
            if not alive:
                break
            time.sleep(0.05)
    finally:
        for m in members:
            if m.proc.poll() is None:
                m.proc.kill()
            m.proc.wait()
            if m.rc is None:
                m.rc = m.proc.returncode
    rcs = {m.process_id: m.rc for m in members}
    deaths = [m.process_id for m in members if m.lost_host]
    if outcome is None:
        if deaths:
            outcome = "member_death"
        elif all(r == 0 for r in rcs.values()):
            outcome = "complete"
        elif all(r in (0, GRACEFUL_EXIT_CODE) for r in rcs.values()):
            outcome = "interrupted"
        else:
            outcome = "failed"
    detected = [m.lost_at for m in members if m.lost_at is not None]
    return {"generation": generation, "num_processes": nproc, "rcs": rcs, "deaths": deaths,
            "outcome": outcome, "escalated": escalated,
            "launched_at": launched, "up_s": None if up_at is None else up_at - launched,
            "detected_at": min(detected) if detected else None,
            "detect_s": max((m.detect_s for m in members if m.detect_s is not None),
                            default=None),
            "seconds": time.monotonic() - launched,
            "members": {m.process_id: _member_line(m.out_path) for m in members}}


def run_fleet(spec: FleetSpec) -> dict:
    """Supervise a fit to its end across member loss: launch, watch,
    boundary-stop, relaunch on the survivors (``nproc = survivors``). A
    JSON-safe report; ``ok`` means the fit completed (a survivor resume
    counts; a graceful external stop reports ``interrupted``). ``detect_s``
    is the seconds from a lost member's last heartbeat to its detection,
    ``relaunch_s`` from the detection to the next generation's members all
    beating."""
    from photon_ml_tpu_torch import telemetry

    os.makedirs(spec.workdir, exist_ok=True)
    deadline = time.monotonic() + spec.timeout_s
    nproc = spec.num_processes
    generations: list[dict] = []
    relaunches = 0
    report: dict = {"workdir": spec.workdir, "generations": generations}
    status = None
    if spec.status_file is not None or spec.status_port is not None:
        from photon_ml_tpu_torch.parallel.fleet_status import FleetStatusWriter

        status = FleetStatusWriter(
            fleet_dir=os.path.join(spec.workdir, "fleet"), num_processes=nproc,
            heartbeat_deadline_s=spec.heartbeat_deadline_s, status_file=spec.status_file,
            port=spec.status_port, interval_s=spec.status_interval_s).start()
        report["status_port"] = status.port
        report["status_file"] = spec.status_file
    death_history: list = []
    try:
        while True:
            gen = _supervise_generation(spec, len(generations), nproc, deadline, status=status)
            generations.append(gen)
            death_history.extend({"generation": gen["generation"], "process_id": pid}
                                 for pid in gen["deaths"])
            if status is not None:
                status.update(rcs=gen["rcs"], deaths=gen["deaths"],
                              death_history=list(death_history), outcome=gen["outcome"])
            if gen["deaths"]:
                telemetry.counter("recovery.fleet_member_deaths").inc(len(gen["deaths"]))
            if gen["outcome"] == "complete":
                report.update(ok=True, interrupted=False)
                break
            if gen["outcome"] == "interrupted":
                report.update(ok=False, interrupted=True)
                break
            if gen["outcome"] in ("timeout", "failed") and not gen["deaths"]:
                report.update(ok=False, interrupted=False)
                break
            survivors = nproc - len(gen["deaths"])
            if survivors < 1 or relaunches >= spec.max_relaunches:
                report.update(ok=False, interrupted=False)
                break
            relaunches += 1
            telemetry.counter("recovery.fleet_relaunches").inc()
            if status is not None:
                status.update(relaunches=relaunches)
            nproc = survivors
    finally:
        if status is not None:
            status.stop()
    report["relaunches"] = relaunches
    report["deaths_total"] = sum(len(g["deaths"]) for g in generations)
    report["final_path"] = os.path.join(spec.workdir, "final.npy")
    for prev, nxt in zip(generations, generations[1:]):
        if prev["detected_at"] is not None and nxt["up_s"] is not None:
            report["detect_s"] = prev["detect_s"]
            report["relaunch_s"] = nxt["launched_at"] + nxt["up_s"] - prev["detected_at"]
    for g in generations:  # monotonic stamps mean nothing outside this process
        g.pop("launched_at", None)
        g.pop("detected_at", None)
    return report


def verify_certified_checkpoints(checkpoint_dir: str, num_entities: int, dim: int) -> list[str]:
    """Audit every certified checkpoint under ``checkpoint_dir``: each
    ``chunk-*`` directory must carry a manifest whose blocks cover [0, N)
    contiguously with readable payloads. The violations (empty: no partial
    checkpoint was ever certified)."""
    from photon_ml_tpu_torch.game.checkpoint import (
        CheckpointError,
        CheckpointSpec,
        StreamingCheckpointManager,
    )

    if not os.path.isdir(checkpoint_dir):
        return []
    mgr = StreamingCheckpointManager(CheckpointSpec(directory=checkpoint_dir, every=1))
    problems = []
    for _c, path in mgr._chunk_dirs():
        try:
            manifest = mgr._read_manifest(path)
            if int(manifest["num_entities"]) != num_entities:
                raise CheckpointError(f"{path}: wrong entity count {manifest['num_entities']}")
            if int(manifest["dim"]) != dim:
                raise CheckpointError(f"{path}: wrong dim {manifest['dim']}")
            reader = mgr._row_reader(path, manifest, "coefficients")
            reader(0, num_entities)  # every payload byte readable
        except (CheckpointError, ValueError, OSError, KeyError) as e:
            problems.append(f"{path}: certified but partial/corrupt: {e}")
    return problems


# ---------------------------------------------------------------------------
# the worker (one fleet member)
# ---------------------------------------------------------------------------


def _process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux's process table), or None."""
    try:
        with open("/proc/self/stat", encoding="ascii") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def _worker_main(args) -> int:
    import torch

    from photon_ml_tpu_torch import faults
    from photon_ml_tpu_torch.parallel import multihost

    faults.warn_if_armed()
    device = torch.device(args.device)
    if args.nproc > 1:
        multihost.initialize(multihost.DistributedConfig(
            coordinator_address=f"127.0.0.1:{args.port}", num_processes=args.nproc,
            process_id=args.proc, init_retries=2, init_backoff_s=0.2), device=device)
    heartbeat = multihost.HeartbeatWriter(os.path.join(args.dir, "fleet"), args.proc,
                                          interval_s=args.heartbeat_every).start()
    try:
        # start-up: from the process's start to a joined fleet and a first beat
        return _worker_fit(args, device, _process_age_s())
    finally:
        heartbeat.stop()


def _worker_fit(args, device, startup_s: Optional[float]) -> int:
    import torch

    from photon_ml_tpu_torch import faults, telemetry
    from photon_ml_tpu_torch.game.checkpoint import (
        CheckpointSpec,
        GracefulStop,
        StreamingCheckpointManager,
        TrainingInterrupted,
    )
    from photon_ml_tpu_torch.game.streaming import (
        LocalChunk,
        ShardedCoefficientTable,
        StreamingRandomEffectTrainer,
    )
    from photon_ml_tpu_torch.parallel import multihost

    stop = GracefulStop().install()
    n, dim, per, n_chunks = problem_shape(args.problem)
    mesh = multihost.global_mesh({"entity": args.nproc}, [device])
    lo, hi = multihost.process_slice(per, mesh, "entity")

    def local_chunk(i: int):
        # this process's rows of chunk i, from the current mesh: a smaller
        # fleet's members take the lost member's rows on their own
        return lambda: LocalChunk(_chunk_rows(args.problem, args.seed, i, lo, hi, device),
                                  global_size=per)

    chunks = [(i * per, local_chunk(i)) for i in range(n_chunks)]
    mgr = StreamingCheckpointManager(CheckpointSpec(
        directory=os.path.join(args.dir, "ckpt"), every=args.checkpoint_every, keep_last=1,
        quorum_timeout_s=args.quorum_timeout))
    restored = mgr.restore_placed(mesh=mesh)
    if restored is not None:
        table = ShardedCoefficientTable.from_coefficients(restored.coefficients, mesh=mesh)
        start_chunk = restored.next_chunk
    else:
        table = ShardedCoefficientTable(n, dim, mesh=mesh)
        start_chunk = 0
    armed = os.environ.get(ARMED_PLAN_ENV)
    boundary = [start_chunk - 1]

    def should_stop() -> bool:
        boundary[0] += 1
        if args.chunk_sleep > 0:
            time.sleep(args.chunk_sleep)
        if armed and boundary[0] == args.arm_after_chunk + 1:
            # the previous boundary's checkpoint is certified: arm the plan
            # and beat at once, so its rule fires here whatever the cadence
            faults.install_plan(faults.FaultPlan.from_json(armed))
            multihost.HeartbeatWriter(os.path.join(args.dir, "fleet"), args.proc).beat()
        # every member sees the same verdict at the same boundary
        return multihost.fleet_any(stop.requested, mesh)

    trainer = StreamingRandomEffectTrainer("logistic", problem_config(args.problem), mesh=mesh,
                                           prefetch=False, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.monotonic()
    try:
        run = trainer.train(table, chunks, checkpointer=mgr, start_chunk=start_chunk,
                            should_stop=should_stop)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        fit_s = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        final = table.to_numpy()  # every member takes part in the gather
    except TrainingInterrupted as e:
        print(json.dumps({"interrupted": True, "at_chunk": e.step, "checkpoint": e.checkpoint_path,
                          "start_chunk": start_chunk, "process_id": args.proc}), flush=True)
        return GRACEFUL_EXIT_CODE
    except Exception as e:  # noqa: BLE001 - any failure in a broken fleet
        if args.nproc > 1:
            # a collective failed against a dead peer: leave through os._exit
            # (unwinding could block in the process group's teardown)
            print(json.dumps({"fleet_abort": True, "process_id": args.proc,
                              "error": f"{type(e).__name__}: {e}"[:500]}), flush=True)
            sys.stderr.flush()
            os._exit(FLEET_ABORT_EXIT_CODE)
        raise
    if args.proc == 0:
        np.save(os.path.join(args.dir, "final.npy"), final)
    counters = telemetry.snapshot()["counters"]
    solved = (n - start_chunk * per) * dim
    print(json.dumps({
        "interrupted": False, "resumed": restored is not None, "start_chunk": start_chunk,
        "process_id": args.proc, "num_processes": args.nproc, "device": str(device),
        "backend": multihost.backend(), "startup_s": startup_s, "fit_s": fit_s,
        "coefficients_solved": solved, "coeffs_per_s": solved / fit_s if fit_s else None,
        "mean_iterations": run.mean_iterations,
        "max_memory_allocated": peak,
        "comms_wait_seconds_total": counters.get("comms.wait_seconds_total", 0.0),
        "comms_wait_calls": counters.get("comms.wait_calls", 0),
    }), flush=True)
    if args.nproc > 1:
        multihost.shutdown()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.tools.fleet",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--worker", action="store_true", help="run as one fleet member")
    parser.add_argument("--proc", type=int, default=0)
    parser.add_argument("--nproc", type=int, default=1)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--dir", help="the fleet's working directory (worker)")
    parser.add_argument("--device", default="cuda", help="cuda, cuda:i or cpu")
    parser.add_argument("--distinct-cards", action="store_true",
                        help="member i on cuda:(i mod count) instead of every member on cuda:0")
    parser.add_argument("--problem", choices=("small", "scale"), default="small")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint-every", type=int, default=1)
    parser.add_argument("--quorum-timeout", type=float, default=4.0)
    parser.add_argument("--heartbeat-every", type=float, default=0.25)
    parser.add_argument("--arm-after-chunk", type=int, default=0)
    parser.add_argument("--chunk-sleep", type=float, default=0.0)
    parser.add_argument("--workdir", help="the supervisor's working directory")
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--max-relaunches", type=int, default=2)
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--json", dest="json_out", help="write the report here")
    parser.add_argument("--status-file", help="an atomic live status snapshot, refreshed")
    parser.add_argument("--status-port", type=int,
                        help="serve the status on http://127.0.0.1:PORT/statusz (0: any port)")
    parser.add_argument("--status-interval", type=float, default=1.0)
    args = parser.parse_args(argv)
    if args.worker:
        if not args.dir:
            parser.error("--worker requires --dir")
        return _worker_main(args)
    if not args.workdir:
        parser.error("--workdir is required (or --worker --dir)")
    report = run_fleet(FleetSpec(
        workdir=args.workdir, num_processes=args.num_processes,
        device="cpu" if args.device == "cpu" else "cuda", distinct_cards=args.distinct_cards,
        problem=args.problem, seed=args.seed, checkpoint_every=args.checkpoint_every,
        max_relaunches=args.max_relaunches, timeout_s=args.timeout,
        status_file=args.status_file, status_port=args.status_port,
        status_interval_s=args.status_interval))
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    raise SystemExit(main())
