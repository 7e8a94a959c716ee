"""Fleet liveness for processes that share a filesystem: heartbeat files and
the supervisor's staleness check.

Counterpart of the liveness part of ``photon_ml_tpu/parallel/multihost.py``
(:320-400): a member touches ``proc-<i>.alive`` from a daemon thread, and a
supervisor reads the files' mtimes (:func:`dead_peers`), so detecting a dead
member needs no RPC with a process that may be gone. The serving fleet
(``cli serve --member --heartbeat-dir``, ``tools/serving_fleet.py``) uses it.

The rest of the reference module, the per-process training fleet
(``initialize``, ``DistributedConfig``, ``process_slice``,
``host_local_array``, ``gather_to_host``, ``fleet_any``,
``collective_wait``), is ROADMAP.md Queue 1 item 12b: each name here raises
``NotImplementedError`` saying so.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from photon_ml_tpu_torch import faults

logger = logging.getLogger("photon_ml_tpu_torch.parallel.multihost")

# an `exit` rule here is a member dying between touches: the supervisor sees
# the stale proc-<i>.alive file, not an exit hook
_FP_HEARTBEAT = faults.register_point(
    "fleet.heartbeat", distributed=True,
    description="one liveness-file touch by the heartbeat writer thread",
)

_NOT_PORTED = ("photon_ml_tpu_torch.parallel.multihost.{name} is not ported yet: the "
               "per-process fleet is ROADMAP.md Queue 1 item 12b")


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


def _refused(name: str):
    def refuse(*_args, **_kwargs):
        raise NotImplementedError(_NOT_PORTED.format(name=name))

    refuse.__name__ = name
    refuse.__doc__ = f"Not ported: ``{name}`` belongs to ROADMAP.md Queue 1 item 12b."
    return refuse


initialize = _refused("initialize")
DistributedConfig = _refused("DistributedConfig")
process_slice = _refused("process_slice")
host_local_array = _refused("host_local_array")
gather_to_host = _refused("gather_to_host")
fleet_any = _refused("fleet_any")
collective_wait = _refused("collective_wait")
