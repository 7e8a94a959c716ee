"""Crash-durable file writes: write to a temporary file, fsync, rename.

The port's own copy of ``photon_ml_tpu/utils/atomic.py``: after an
``atomic_*`` call returns, the destination holds either the complete new
content or, if the process died mid-write, whatever was there before, so a
reader never sees a truncated file. The fsync before ``os.replace`` matters:
without it a crash after the rename can still surface an empty file on
ext4/xfs (the rename is journaled ahead of the data).
"""

from __future__ import annotations

import json
import os

import numpy as np


def fsync_dir(path: str) -> None:
    """fsync a directory, so an entry just renamed into it survives a crash
    (a POSIX rename is durable only once its parent is synced)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse a directory fsync; best effort
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_json(path: str, obj, **dump_kwargs) -> None:
    """Serialize ``obj`` as JSON at ``path`` atomically and durably."""
    atomic_write_bytes(path, json.dumps(obj, **dump_kwargs).encode("utf-8"))


def atomic_write_npz(path: str, **arrays) -> None:
    """An npz container written atomically, so a crash mid-save never leaves
    a truncated array file next to valid metadata."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_npy(path: str, arr) -> None:
    """One array as .npy, streamed by ``np.save`` into the temporary file (no
    copy in memory), then renamed."""
    tmp = path + ".tmp.npy"
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
