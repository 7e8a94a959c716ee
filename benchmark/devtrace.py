"""The device trace of a traced window, from ``torch.profiler``, reduced
to what the per-layer metrics and the breakdown read.

A device interval is a kernel, a copy or a set on a card. The busy time of
a card is the length of the union of its intervals; its idle gaps are the
holes between them, each named by the innermost host operation that spans
it whole (``host_python`` when none does: the host ran Python between
operations).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from benchmark.yardstick.kernels import kernel_of

#: gaps a card, longest first, that are named by a host operation
NAMED_GAPS = 4000


@dataclasses.dataclass
class Interval:
    name: str
    device: int  # -1: the host
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: dict  # card -> seconds of the union of its intervals
    kernels: dict  # __global__ name -> [launches, device seconds]
    device_ops: list  # [[name, seconds]] the ten longest totals
    idle_gaps: list  # [[host operation, seconds]] the ten longest totals

    def mean_busy_s(self, cards: int) -> float:
        """Busy seconds averaged over ``cards`` cards (a card with no
        interval counts as idle)."""
        return sum(self.busy_s.values()) / max(cards, 1)


def union_length(starts: np.ndarray, ends: np.ndarray) -> tuple[int, np.ndarray, np.ndarray]:
    """The length of the union of intervals, and the holes between its
    pieces (starts, ends)."""
    if not len(starts):
        return 0, np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    piece_start = s[new]
    idx = np.flatnonzero(new)
    piece_end = np.append(reach[idx[1:] - 1], reach[-1])
    total = int((piece_end - piece_start).sum())
    return total, piece_end[:-1], piece_start[1:]


def name_gaps(gap_s: np.ndarray, gap_e: np.ndarray, host: list) -> dict:
    """Seconds of the gaps by the innermost host interval spanning each."""
    if not len(gap_s):
        return {}
    top = np.argsort(gap_s - gap_e, kind="stable")[:NAMED_GAPS]
    gs, ge = gap_s[top], gap_e[top]
    order = np.argsort(gs, kind="stable")
    gs, ge = gs[order], ge[order]
    label = np.full(len(gs), -1, np.int64)
    shortest = int((ge - gs).min())
    spans = sorted((iv for iv in host if iv.end_ns - iv.start_ns >= shortest),
                   key=lambda iv: iv.end_ns - iv.start_ns)
    nxt = np.arange(len(gs) + 1)  # the next unnamed gap at or after i

    def find(i: int) -> int:
        root = i
        while nxt[root] != root:
            root = nxt[root]
        while nxt[i] != root:
            nxt[i], i = root, nxt[i]
        return root

    names = []
    for iv in spans:
        lo = int(np.searchsorted(gs, iv.start_ns, "left"))
        hi = int(np.searchsorted(gs, iv.end_ns, "right"))
        i = find(lo)
        while i < hi:
            if ge[i] <= iv.end_ns:
                label[i] = len(names)
                nxt[i] = i + 1
            i = find(i + 1)
        names.append(iv.name)
    out: dict = defaultdict(float)
    for i in range(len(gs)):
        out[names[label[i]] if label[i] >= 0 else "host_python"] += (ge[i] - gs[i]) * 1e-9
    return dict(out)


def summarize(intervals: list, window_s: float) -> TraceSummary:
    """Reduce a window's intervals (device and host)."""
    host = [iv for iv in intervals if iv.device < 0]
    by_card: dict = defaultdict(list)
    for iv in intervals:
        if iv.device >= 0:
            by_card[iv.device].append(iv)
    busy, kernels, totals = {}, defaultdict(lambda: [0, 0.0]), defaultdict(float)
    gaps: dict = defaultdict(float)
    for card, ivs in sorted(by_card.items()):
        s = np.array([iv.start_ns for iv in ivs], np.int64)
        e = np.array([iv.end_ns for iv in ivs], np.int64)
        total, gap_s, gap_e = union_length(s, e)
        busy[card] = total * 1e-9
        for iv in ivs:
            secs = (iv.end_ns - iv.start_ns) * 1e-9
            totals[iv.name] += secs
            k = kernel_of(iv.name)
            if k is not None:
                kernels[k][0] += 1
                kernels[k][1] += secs
        for name, secs in name_gaps(gap_s, gap_e, host).items():
            gaps[name] += secs
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s=window_s, busy_s=busy, kernels=dict(kernels),
                        device_ops=[[k, v] for k, v in top],
                        idle_gaps=[[k, v] for k, v in top_gaps])


def intervals_of(prof) -> list:
    """The intervals of a finished ``torch.profiler.profile``: each device
    event on its card, each host operation on -1."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        kind = str(ev.device_type()).split(".")[-1]
        start = int(ev.start_ns())
        end = start + int(ev.duration_ns())
        if kind == "CUDA":
            if not ev.is_user_annotation():  # a host range drawn on the card
                out.append(Interval(ev.name(), int(ev.device_index()), start, end))
        elif kind == "CPU":
            out.append(Interval(ev.name(), -1, start, end))
    return out
