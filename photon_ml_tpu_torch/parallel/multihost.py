"""The per-process fleet on ``torch.distributed``: joining a fleet, this
process's rows of a mesh axis, the fleet-wide agreements, and the liveness
files a supervisor reads.

Counterpart of ``photon_ml_tpu/parallel/multihost.py``. One process per
member; each member drives its own devices (one card, or the CPU), reads
and places only its own rows (:func:`process_slice`,
:func:`host_local_array`), and solves its own entities with no collective
(the per-entity solves are independent, :23-28). The collectives are small
host-bound agreements and gathers: the stop flag at a chunk boundary
(:func:`fleet_any`), a table fetched to every member
(:func:`gather_to_host`), the end-of-fit summaries.

Joining (:func:`initialize`) is a rendezvous at ``coordinator_address``:
process 0 serves a ``TCPStore`` there, every member writes the identity of
its device into it, and the backend follows from the placement, chosen
once and reported by :func:`backend`: NCCL when every member owns a
distinct CUDA card, gloo when members share a card (NCCL refuses a device
that repeats) or run on the CPU. Nothing falls back silently: a rendezvous
that fails every attempt raises :class:`FleetInitError` naming the
coordinator. Failed attempts are retried with exponential backoff
(``multihost.init_retries``), and the ``multihost.init`` fault seam fires
before each.

A member touches ``proc-<i>.alive`` from a daemon thread
(:class:`HeartbeatWriter`), and a supervisor reads the files' mtimes
(:func:`dead_peers`, :320-400), so detecting a dead member needs no RPC
with a process that may be gone.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
import threading
import time
from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import faults, telemetry

logger = logging.getLogger("photon_ml_tpu_torch.parallel.multihost")

_ENV_COORDINATOR = "PHOTON_ML_COORDINATOR"
_ENV_NUM_PROCESSES = "PHOTON_ML_NUM_PROCESSES"
_ENV_PROCESS_ID = "PHOTON_ML_PROCESS_ID"
_ENV_AUTO = "PHOTON_ML_AUTO_DISTRIBUTED"
_ENV_INIT_RETRIES = "PHOTON_ML_INIT_RETRIES"

# the joined fleet: its backend and the device this member drives
_fleet: dict = {"backend": None, "device": None, "store": None}

# an `exit` rule at init is a member preempted before it joined; `raise` and
# `io` rules are the flaky rendezvous the bounded retry absorbs
_FP_INIT = faults.register_point(
    "multihost.init", distributed=True,
    description="one torch.distributed rendezvous attempt (retried with backoff)",
)
# an `exit` rule here is a member dying between touches: the supervisor sees
# the stale proc-<i>.alive file, not an exit hook
_FP_HEARTBEAT = faults.register_point(
    "fleet.heartbeat", distributed=True,
    description="one liveness-file touch by the heartbeat writer thread",
)


class FleetInitError(RuntimeError):
    """Joining the fleet failed every attempt; carries the coordinator
    address, so the operator knows which rendezvous died."""

    def __init__(self, coordinator: Optional[str], attempts: int, last: Exception):
        self.coordinator = coordinator
        super().__init__(f"could not join the fleet at coordinator "
                         f"{coordinator or '<from the environment>'} after {attempts} "
                         f"attempt(s): {last}")


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Where this process sits in the fleet. All fields default: one
    process, nothing to join. ``auto=True``: the launcher's environment
    (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``). An explicit
    ``coordinator_address`` (``host:port``) with ``num_processes`` and
    ``process_id``: a fleet started by a supervisor, and the tests."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[tuple[int, ...]] = None
    auto: bool = False
    #: total attempts = 1 + init_retries, backoff doubling from init_backoff_s
    init_retries: int = 3
    init_backoff_s: float = 0.5
    #: how long one rendezvous attempt waits for its peers
    timeout_s: float = 60.0

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        addr = os.environ.get(_ENV_COORDINATOR)
        nproc = os.environ.get(_ENV_NUM_PROCESSES)
        pid = os.environ.get(_ENV_PROCESS_ID)
        auto = os.environ.get(_ENV_AUTO, "").lower() in ("1", "true", "yes")
        retries = os.environ.get(_ENV_INIT_RETRIES)
        return cls(coordinator_address=addr, num_processes=int(nproc) if nproc else None,
                   process_id=int(pid) if pid else None, auto=auto,
                   init_retries=int(retries) if retries else 3)

    @property
    def is_explicit(self) -> bool:
        return self.coordinator_address is not None

    def validate(self) -> None:
        if self.auto and self.is_explicit:
            raise ValueError("auto=True (the launcher's environment) conflicts with an explicit "
                             "coordinator_address")
        if self.is_explicit:
            if self.num_processes is None or self.process_id is None:
                raise ValueError("distributed config with a coordinator_address needs "
                                 "num_processes and process_id too")
            if not 0 <= self.process_id < self.num_processes:
                raise ValueError(f"process_id {self.process_id} out of range for "
                                 f"{self.num_processes} processes")
        elif self.num_processes is not None and self.num_processes > 1:
            raise ValueError("num_processes > 1 needs either a coordinator_address (explicit "
                             "fleet) or auto=True (the launcher's environment)")


def _init_attempts(cfg: DistributedConfig, attempt_fn) -> None:
    """Bounded retry around one rendezvous attempt: transient failures
    (refused connections, timeouts: RuntimeError/OSError) back off
    exponentially and count ``multihost.init_retries``; exhaustion raises
    :class:`FleetInitError` naming the coordinator."""
    attempts = max(int(cfg.init_retries), 0) + 1
    last: Optional[Exception] = None
    for attempt in range(attempts):
        if attempt:
            telemetry.counter("multihost.init_retries").inc()
            backoff = cfg.init_backoff_s * (2 ** (attempt - 1))
            logger.warning("distributed init failed (%s); retry %d/%d in %.2fs", last, attempt,
                           attempts - 1, backoff)
            time.sleep(backoff)
        try:
            faults.fault_point(_FP_INIT)
            attempt_fn()
            return
        except (RuntimeError, OSError, ConnectionError, TimeoutError) as e:
            last = e
    assert last is not None
    raise FleetInitError(cfg.coordinator_address, attempts, last)


def device_identity(device: torch.device) -> str:
    """What makes two members' devices the same device: a CUDA card's UUID
    (two processes may call different cards ``cuda:0``), or the host for
    the CPU."""
    if device.type == "cuda":
        return f"cuda/{torch.cuda.get_device_properties(device).uuid}"
    return f"cpu/{socket.gethostname()}"


def choose_backend(identities: Sequence[str]) -> str:
    """NCCL when every member owns a distinct CUDA card, else gloo (members
    sharing a card, which NCCL refuses, or on the CPU)."""
    cuda = all(i.startswith("cuda/") for i in identities)
    return "nccl" if cuda and len(set(identities)) == len(identities) else "gloo"


def _join(cfg: DistributedConfig, device: torch.device) -> None:
    """One rendezvous attempt: the store at the coordinator, the members'
    device identities through it, then the process group on the backend
    they imply."""
    import torch.distributed as dist

    host, port = cfg.coordinator_address.rsplit(":", 1)
    rank, world = int(cfg.process_id), int(cfg.num_processes)
    timeout = datetime.timedelta(seconds=cfg.timeout_s)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout)
    store.set(f"photon/device/{rank}", device_identity(device))
    identities = [store.get(f"photon/device/{r}").decode() for r in range(world)]
    backend = choose_backend(identities)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=timeout)
    _fleet.update(backend=backend, device=device, store=store)


def initialize(config: Optional[DistributedConfig] = None,
               device: torch.device | str | None = None) -> None:
    """Join the fleet (idempotent) with ``device`` as this member's device
    (default: the first CUDA device, or the CPU where there is none). A
    config with nothing to join does nothing. The backend follows from
    the members' placement (:func:`choose_backend`)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    cfg = config if config is not None else DistributedConfig.from_env()
    cfg.validate()
    if cfg.auto:
        env = os.environ
        cfg = dataclasses.replace(
            cfg, auto=False,
            coordinator_address=f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                                f"{env.get('MASTER_PORT', '29500')}",
            num_processes=int(env.get("WORLD_SIZE", "1")), process_id=int(env.get("RANK", "0")))
    if not cfg.is_explicit:
        return
    if device is None:
        device = (torch.device("cuda", (cfg.local_device_ids or (0,))[0])
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    _init_attempts(cfg, lambda: _join(cfg, device))
    logger.info("joined the fleet as process %d of %d on %s (backend %s)", cfg.process_id,
                cfg.num_processes, device, _fleet["backend"])


def shutdown() -> None:
    """Leave the fleet (a no-op outside one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _fleet.update(backend=None, device=None, store=None)


def backend() -> Optional[str]:
    """The joined fleet's backend ("nccl" or "gloo"), or None."""
    return _fleet["backend"]


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def _comm_device() -> torch.device:
    """Where a collective's tensors live: the card for NCCL, else the CPU."""
    return _fleet["device"] if _fleet["backend"] == "nccl" else torch.device("cpu")


def global_mesh(axis_sizes: Optional[dict[str, int]] = None,
                devices: Optional[Sequence[torch.device]] = None):
    """A mesh over every member's devices, process-major: each member gives
    its own devices (default: the one it joined with), so a 1-D mesh, or
    the first axis of a 2-D one, gives each process a contiguous block (what
    :func:`process_slice` relies on). One process: a mesh of its own
    devices."""
    from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

    local = [torch.device(d) for d in (devices if devices is not None else
                                       [_fleet["device"] or torch.device("cpu")])]
    if not is_multiprocess():
        from photon_ml_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(axis_sizes or {DATA_AXIS: len(local)}, local)
    import torch.distributed as dist

    gathered: list = [None] * process_count()
    dist.all_gather_object(gathered, [str(d) for d in local])
    if len({len(g) for g in gathered}) != 1:
        raise ValueError(f"members give different numbers of devices: "
                         f"{[len(g) for g in gathered]}")
    all_devices = [torch.device(d) for g in gathered for d in g]
    owners = [p for p, g in enumerate(gathered) for _ in g]
    sizes = axis_sizes or {DATA_AXIS: len(all_devices)}
    if int(np.prod(list(sizes.values()))) != len(all_devices):
        raise ValueError(f"mesh {dict(sizes)} needs {int(np.prod(list(sizes.values())))} "
                         f"devices, the fleet has {len(all_devices)}")
    return Mesh(all_devices, tuple(sizes), tuple(int(v) for v in sizes.values()),
                owners=owners, process=process_index())


def process_slice(total: int, mesh, axis: str) -> tuple[int, int]:
    """``[lo, hi)`` of the rows this process owns when ``total`` rows are
    split evenly over ``axis`` of ``mesh`` (process-major, as
    :func:`global_mesh` lays it out; ``total`` a multiple of the axis)."""
    size = int(mesh.shape[axis])
    if total % size:
        raise ValueError(f"total={total} must divide over the {size}-device '{axis}' axis")
    per = total // size
    mine = mesh.local_positions(axis)
    if not mine:
        return (0, 0)
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(f"devices of process {mesh.process} are not contiguous along axis "
                         f"'{axis}'; use global_mesh() ordering")
    return (mine[0] * per, (mine[-1] + 1) * per)


def host_local_array(local, mesh, axis: Optional[str] = None,
                     global_shape: Optional[tuple[int, ...]] = None):
    """This process's rows ``local`` (its :func:`process_slice` of the
    leading axis) placed over ``axis`` of ``mesh``: an ``EntityShards`` whose
    blocks on this process's devices hold the rows and whose other blocks
    are shapes only (``meta`` tensors), so no member ever holds the global
    array. ``axis`` None replicates: :func:`replicate_to_all`."""
    from photon_ml_tpu_torch.parallel.sharding import EntityShards

    if axis is None:
        return replicate_to_all(local, mesh)
    local = torch.as_tensor(np.asarray(local))
    size = int(mesh.shape[axis])
    n = int(global_shape[0]) if global_shape is not None else int(local.shape[0]) * (
        size // max(len(mesh.local_positions(axis)), 1))
    lo, hi = process_slice(n, mesh, axis)
    if int(local.shape[0]) != hi - lo:
        raise ValueError(f"process {mesh.process} owns rows [{lo}, {hi}) of {n}, got "
                         f"{int(local.shape[0])} local rows")
    per = n // size
    parts = []
    for pos, (dev, owner) in enumerate(zip(mesh.axis_devices(axis), mesh.axis_owners(axis))):
        if owner == mesh.process:
            parts.append(local[pos * per - lo:(pos + 1) * per - lo].to(dev, copy=True))
        else:
            parts.append(torch.empty((per,) + tuple(local.shape[1:]), dtype=local.dtype,
                                     device="meta"))
    return EntityShards(parts=tuple(parts), mesh=mesh, axis=axis)


def replicate_to_all(value, mesh) -> list[torch.Tensor]:
    """``value`` (the same on every member) copied to each of this
    process's distinct devices of ``mesh``."""
    t = torch.as_tensor(np.asarray(value))
    out, seen = [], set()
    for d, owner in zip(mesh.device_list(), mesh.device_owners()):
        if owner == mesh.process and str(d) not in seen:
            seen.add(str(d))
            out.append(t.to(d, copy=True))
    return out


@contextmanager
def collective_wait(label: str):
    """Time this process's blocking entry into a cross-process collective:
    a ``collective_wait`` span, the ``comms.wait_s`` histogram and the
    ``comms.wait_calls``/``comms.wait_seconds_total`` counters. At a
    barrier the last member to arrive waits about nothing, so the member
    whose total is near zero is the straggler the rest waited for. One
    process: nothing is recorded (nobody to wait for)."""
    if not is_multiprocess():
        yield
        return
    t0 = time.monotonic()
    with telemetry.span("collective_wait", label=label):
        try:
            yield
        finally:
            wait = time.monotonic() - t0
            telemetry.histogram("comms.wait_s").observe(wait)
            telemetry.counter("comms.wait_calls").inc()
            telemetry.counter("comms.wait_seconds_total").inc(wait)


def fleet_any(flag: bool, mesh=None, axis: Optional[str] = None) -> bool:
    """The fleet-wide OR of a per-process flag: every member sees the same
    verdict at the same boundary, so a stop requested on one member stops
    them all there (a member that read only its own flag would go on into
    the next collective against a stopped peer). One process: the flag."""
    if not is_multiprocess():
        return bool(flag)
    import torch.distributed as dist

    t = torch.tensor([1.0 if flag else 0.0], device=_comm_device())
    with collective_wait("fleet_any"):
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        value = float(t.item())
    return value > 0.0


def fleet_sum(values: Sequence[float]) -> list[float]:
    """Per-process numbers summed over the fleet (float64), the same list on
    every member. One process: the numbers."""
    if not is_multiprocess():
        return [float(v) for v in values]
    import torch.distributed as dist

    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=_comm_device())
    with collective_wait("fleet_sum"):
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t.cpu().tolist()


def exchange(sends: Sequence[tuple[int, torch.Tensor]],
             recvs: Sequence[tuple[int, torch.Tensor]]) -> None:
    """Point to point in one batch: each ``(peer, tensor)`` of ``sends`` goes
    to ``peer``, each ``(peer, out)`` of ``recvs`` is filled from ``peer``.
    Both sides list a pair's transfers in the same order. Under gloo the
    tensors pass through host memory; under NCCL they stay on the card."""
    if not sends and not recvs:
        return
    import torch.distributed as dist

    dev = _comm_device()
    ops, staged = [], []
    for peer, t in sends:
        ops.append(dist.P2POp(dist.isend, t.detach().to(dev).contiguous(), int(peer)))
    for peer, out in recvs:
        buf = torch.empty(tuple(out.shape), dtype=out.dtype, device=dev)
        ops.append(dist.P2POp(dist.irecv, buf, int(peer)))
        staged.append((buf, out))
    with collective_wait("exchange"):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for buf, out in staged:
        out.copy_(buf)


def gather_to_host(arr) -> np.ndarray:
    """The whole of a (possibly cross-process) array on every member's
    host. A tensor or an array: itself. An ``EntityShards``: its blocks
    in order; across processes each member contributes its own blocks
    (an all-gather), so use it for models and summaries, not bulk data."""
    from photon_ml_tpu_torch.parallel.sharding import EntityShards

    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    if not isinstance(arr, EntityShards):
        return np.asarray(arr)
    if not arr.mesh.is_multiprocess:
        return np.concatenate([p.detach().cpu().numpy() for p in arr.parts])
    import torch.distributed as dist

    mine = arr.mesh.local_positions(arr.axis)
    owners = arr.mesh.axis_owners(arr.axis)
    if list(owners) != sorted(owners):
        raise ValueError("gather_to_host needs a process-major axis (global_mesh)")
    dev = _comm_device()
    local = torch.cat([arr.parts[i].detach().to(dev) for i in mine])
    pieces = [torch.empty_like(local) for _ in range(process_count())]
    with collective_wait("gather_to_host"):
        dist.all_gather(pieces, local)
    return torch.cat(pieces).cpu().numpy()


def heartbeat_path(directory: str, process_id: int) -> str:
    """The heartbeat file of fleet member ``process_id``."""
    return os.path.join(directory, f"proc-{int(process_id)}.alive")


class HeartbeatWriter:
    """Touch ``proc-<i>.alive`` on a cadence from a daemon thread.

    The liveness signal is the file's mtime, so detection needs only a
    shared filesystem. A killed process takes this thread with it and the
    file goes stale; :func:`dead_peers` reports the member once the
    staleness passes its deadline. Thread cadence jitters, so deadlines
    should be several intervals long.
    """

    def __init__(self, directory: str, process_id: int, interval_s: float = 1.0):
        if interval_s <= 0:
            raise ValueError("heartbeat interval_s must be > 0")
        self.path = heartbeat_path(directory, process_id)
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        """One touch."""
        faults.fault_point(_FP_HEARTBEAT)
        with open(self.path, "a"):
            os.utime(self.path, None)

    def start(self) -> "HeartbeatWriter":
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.beat()
        self._thread = threading.Thread(target=self._run, name="fleet-heartbeat", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except OSError as e:  # a torn-down workdir must not kill the member
                logger.warning("heartbeat touch failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s * 4)


def dead_peers(directory: str, num_processes: int, deadline_s: float,
               now: Optional[float] = None) -> list[int]:
    """Member ids whose heartbeat file is older than ``deadline_s``.

    A missing file does not count as dead: the member may not have reached
    its first beat (the supervisor pairs this with exit codes, which catch a
    member that dies before beating)."""
    # wall clock by necessity: file mtimes are wall-clock times
    now = time.time() if now is None else now
    dead = []
    for pid in range(int(num_processes)):
        try:
            mtime = os.path.getmtime(heartbeat_path(directory, pid))
        except OSError:
            continue
        if now - mtime > deadline_s:
            dead.append(pid)
    return dead


