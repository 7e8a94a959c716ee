"""Feature index maps: feature name and term <-> dense integer id.

Counterpart of ``photon_ml_tpu/data/index_map.py`` (:29-165), with the same
files on disk, so a map saved by either package loads in the other: a
sorted uint64 hash table (``hashes.npy``, blake2b-64 of the key) with the
ids in hash order (``ids.npy``), the names (``names.json``) and
``meta.json``. ``MmapIndexMap`` binary-searches the memory-mapped table.
Index maps live on the host; the device sees dense feature ids only.

Feature keys follow the reference convention name + '\\x01' + term.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable, Iterator, Mapping, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.utils.atomic import atomic_write_json, atomic_write_npy

DELIMITER = "\x01"
INTERCEPT_KEY = "(INTERCEPT)"


def feature_key(name: str, term: str = "") -> str:
    return f"{name}{DELIMITER}{term}" if term else name


def _hash64(key: str) -> int:
    # stable across processes (unlike Python's salted hash)
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "little")


class IndexMap(Mapping[str, int]):
    """An in-memory feature index map with binary persistence."""

    def __init__(self, names: Sequence[str]):
        self._names = list(names)
        self._index = {n: i for i, n in enumerate(self._names)}
        if len(self._index) != len(self._names):
            raise ValueError("duplicate feature keys in index map")

    def __getitem__(self, key: str) -> int:
        return self._index[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def get(self, key: str, default: int = -1) -> int:  # type: ignore[override]
        return self._index.get(key, default)

    def name_of(self, idx: int) -> str:
        return self._names[idx]

    @property
    def names(self) -> list[str]:
        return self._names

    @staticmethod
    def build(keys: Iterable[str], add_intercept: bool = False, sort: bool = True) -> "IndexMap":
        """From (possibly repeated) feature keys; sorted ids are independent
        of the input order."""
        uniq = set(keys)
        if add_intercept:
            uniq.add(INTERCEPT_KEY)
        return IndexMap(sorted(uniq) if sort else list(uniq))

    def save(self, directory: str) -> None:
        """Write the mmap layout. Raises on a 64-bit hash collision between
        two keys: ``MmapIndexMap`` looks up by hash alone, so a collision
        would return a wrong id."""
        os.makedirs(directory, exist_ok=True)
        hashes = np.asarray([_hash64(n) for n in self._names], dtype=np.uint64)
        if len(hashes) != len(np.unique(hashes)):
            sorted_h = np.sort(hashes)
            dup = sorted_h[:-1][sorted_h[:-1] == sorted_h[1:]][0]
            clashing = [n for n in self._names if np.uint64(_hash64(n)) == dup]
            raise ValueError(f"64-bit hash collision between feature keys {clashing!r}; "
                             "the mmap store cannot represent this vocabulary")
        order = np.argsort(hashes)
        atomic_write_npy(os.path.join(directory, "hashes.npy"), hashes[order])
        atomic_write_npy(os.path.join(directory, "ids.npy"), np.asarray(order, dtype=np.int64))
        atomic_write_json(os.path.join(directory, "names.json"), self._names)
        atomic_write_json(os.path.join(directory, "meta.json"),
                          {"num_features": len(self._names), "format": 1})

    @staticmethod
    def load(directory: str) -> "IndexMap":
        with open(os.path.join(directory, "names.json")) as f:
            return IndexMap(json.load(f))


class MmapIndexMap:
    """A read-only index map over the memory-mapped table: loads in O(1)
    whatever the vocabulary size, and looks keys up by binary search."""

    def __init__(self, directory: str):
        self._hashes = np.load(os.path.join(directory, "hashes.npy"), mmap_mode="r")
        self._ids = np.load(os.path.join(directory, "ids.npy"), mmap_mode="r")
        with open(os.path.join(directory, "meta.json")) as f:
            self._size = json.load(f)["num_features"]
        self._dir = directory
        self._names: Optional[list[str]] = None  # read on the first reverse lookup

    def __len__(self) -> int:
        return self._size

    def get(self, key: str, default: int = -1) -> int:
        h = np.uint64(_hash64(key))
        pos = int(np.searchsorted(self._hashes, h))
        if pos < len(self._hashes) and self._hashes[pos] == h:
            return int(self._ids[pos])
        return default

    def get_many(self, keys: Sequence[str]) -> np.ndarray:
        """Ids of ``keys``; -1 for unknown keys."""
        hs = np.asarray([_hash64(k) for k in keys], dtype=np.uint64)
        pos = np.searchsorted(self._hashes, hs)
        pos_c = np.minimum(pos, len(self._hashes) - 1)
        hit = self._hashes[pos_c] == hs
        return np.where(hit, self._ids[pos_c], -1).astype(np.int64)

    def name_of(self, idx: int) -> str:
        if self._names is None:
            with open(os.path.join(self._dir, "names.json")) as f:
                self._names = json.load(f)
        return self._names[idx]
