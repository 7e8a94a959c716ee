"""Fleet process identity for telemetry artifacts.

Counterpart of ``photon_ml_tpu/telemetry/identity.py``: the one place the
telemetry layer learns which fleet member it is, so that artifact paths are
suffixed per member (``trace.jsonl`` -> ``trace.proc-0.jsonl``,
:func:`member_artifact_path`) and trace headers, metric snapshots and
heartbeat lines carry ``process_index``/``hostname``.

Identity, in priority order:

1. ``PHOTON_PROC_ID`` (and ``PHOTON_PROC_COUNT``), set by the fleet
   supervisor (``tools/fleet.py``) before a worker starts;
2. ``torch.distributed``, only when it is available, already initialized
   and its world size is above 1: telemetry never initializes a process
   group;
3. none: a single process keeps unsuffixed paths and unchanged formats.
"""

from __future__ import annotations

import os
import socket
import sys
from typing import Optional

__all__ = [
    "ENV_PROC_ID",
    "ENV_PROC_COUNT",
    "fleet_process_index",
    "fleet_process_count",
    "hostname",
    "member_artifact_path",
]

ENV_PROC_ID = "PHOTON_PROC_ID"
ENV_PROC_COUNT = "PHOTON_PROC_COUNT"


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        value = int(raw)
    except ValueError:
        return None  # a malformed environment must not fail telemetry setup
    return value if value >= 0 else None


def _process_group():
    """``torch.distributed`` when a process group of more than one member is
    already initialized, else None (never initializes one)."""
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None) if torch is not None else None
    try:
        if dist is not None and dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            return dist
    except Exception:  # noqa: BLE001 — identity must never fail telemetry
        return None
    return None


def fleet_process_index() -> Optional[int]:
    """This process's fleet member index, or ``None`` outside a fleet."""
    env = _env_int(ENV_PROC_ID)
    if env is not None:
        return env
    dist = _process_group()
    return None if dist is None else int(dist.get_rank())


def fleet_process_count() -> Optional[int]:
    """The fleet size this member believes in, or ``None`` when unknown."""
    env = _env_int(ENV_PROC_COUNT)
    if env is not None:
        return env
    dist = _process_group()
    return None if dist is None else int(dist.get_world_size())


def hostname() -> str:
    try:
        return socket.gethostname()
    except OSError:
        return "unknown"


def member_artifact_path(path: str, proc: Optional[int] = None) -> str:
    """Suffix an artifact path per fleet member: ``trace.jsonl`` ->
    ``trace.proc-0.jsonl`` (before the final extension; an extensionless
    path gets ``.proc-0``). Outside a fleet the path is returned unchanged;
    an already-suffixed path is left alone."""
    if proc is None:
        proc = fleet_process_index()
    if proc is None:
        return path
    base, ext = os.path.splitext(path)
    if base.endswith(f".proc-{proc}"):
        return path
    return f"{base}.proc-{proc}{ext}"
