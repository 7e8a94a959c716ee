"""The serving fleet's routing front end: split each request's entity lookups
over the shard-owning members, fold the partial margins exactly, and degrade,
never fail, when part of the fleet is lost.

Counterpart of ``photon_ml_tpu/serving/router.py``. A GAME score is a sum of
per-coordinate margins, so routed scoring is lossless: each entity's rows
live on exactly one member (contiguous code blocks,
``parallel.sharding.owner_of_row``), each owning member returns its partial
margin, one designated member per row adds the fixed-effect margin
(``include_fixed``; fixed effects are replicated, so any member can), and
the router folds the partials in float64, adds the offset once and applies
the link on the host. The router does no work on the card: it is numpy and
stdlib HTTP, as the reference's is, so a routing tier needs no accelerator;
the members' engines launch the kernels.

Degraded mode: an unreachable member's entities fall back to
fixed-effect-only scores (the unseen-entity semantics), counted per affected
row in ``serving.degraded_scores``. A row's fixed-effect margin is retried on
any live member, so losing part of the fleet sheds accuracy, bounded and
counted, but never availability while one member lives.

Discovery is by files: each member atomically writes ``member-<i>.json``
into the announce directory once its slice is warm. The router adopts the
newest ``epoch`` whose member set is complete and swaps its view atomically
(seam ``serving.resize_swap``; a failed swap keeps the old view). Requests
are pinned to the view's version, so a member in the middle of a swap
either serves the pinned version (staged or committed) or sheds for that
request: a score never blends two versions.

The router is where request traces start: each ``score_rows`` without an
inbound context mints one (every ``sample_every``-th one marked sampled),
keeps a ``route`` record with ``fanout`` and ``fold`` phases and each
member call's ``member<i>_rtt``, and sends the context to every member in
``X-Photon-Trace``, so the members' records join it by ``trace_id``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.parallel.sharding import owner_of_row
from photon_ml_tpu_torch.telemetry import requests as request_trace
from photon_ml_tpu_torch.utils.atomic import atomic_write_json

_FP_ROUTE_FANOUT = faults.register_point(
    "serving.route_fanout",
    distributed=True,
    description=("one member's margin fan-out call from the router — io action = the member "
                 "unreachable for that batch (degraded, never failed)"),
)
_FP_RESIZE_SWAP = faults.register_point(
    "serving.resize_swap",
    distributed=True,
    description=("the router's atomic ownership-map swap at a fleet resize / epoch flip — a "
                 "failed swap keeps the old map serving"),
)

#: link functions applied on the host after the fold (the engine's post-link,
#: ``get_loss(task).name``)
_LINKS = {
    "logistic": lambda s: 1.0 / (1.0 + np.exp(-s)),
    "poisson": np.exp,
}


class FleetUnavailable(RuntimeError):
    """No member could serve any part of a request: total fleet loss, or no
    complete epoch announced yet. Partial loss never raises this."""


class _MemberUnavailable(RuntimeError):
    """One member failed a fan-out call past its retry budget."""


# ---------------------------------------------------------------------------
# announce files: how members and the router find each other
# ---------------------------------------------------------------------------


def announce_path(announce_dir: str, member: int) -> str:
    return os.path.join(announce_dir, f"member-{int(member)}.json")


def write_announce(announce_dir: str, payload: Mapping) -> str:
    """Atomically publish one member's announce record (a member does so once
    its slice is warm: announcing is the readiness barrier). Required keys:
    member, fleet_size, epoch, url, version."""
    os.makedirs(announce_dir, exist_ok=True)
    path = announce_path(announce_dir, int(payload["member"]))
    atomic_write_json(path, dict(payload), indent=2, sort_keys=True)
    return path


def scan_announce(announce_dir: str) -> list[dict]:
    """Every parseable announce record in ``announce_dir``; a torn file (a
    member killed mid-write) reads as absent."""
    out = []
    try:
        names = os.listdir(announce_dir)
    except FileNotFoundError:
        return out
    for name in sorted(names):
        if not (name.startswith("member-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(announce_dir, name)) as fh:
                rec = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict) and "member" in rec:
            out.append(rec)
    return out


def fleet_lookups_from_version_dir(version_dir: str):
    """``(task, link, {id_name: {value: code}})`` of a published registry
    version, read with numpy and JSON alone: the router's share of the model
    (the entity vocabularies, for ownership, and the task's link), no
    coefficients. Two coordinates keyed by one id must agree on its
    vocabulary, or no single ownership map exists."""
    from photon_ml_tpu_torch.ops.losses import get_loss

    with open(os.path.join(version_dir, "model-metadata.json")) as fh:
        meta = json.load(fh)
    task = meta["task"]
    link = get_loss(task).name
    lookups: dict[str, dict] = {}
    for name, spec in (meta.get("coordinates") or {}).items():
        if spec.get("type") != "random_effect":
            continue
        with np.load(os.path.join(version_dir, "random-effect", name, "model.npz")) as z:
            vocab = z["vocab"]
        id_name = spec["id_name"]
        table = {str(v): i for i, v in enumerate(vocab.tolist())}
        if id_name in lookups and lookups[id_name] != table:
            raise ValueError(f"coordinates disagree on the '{id_name}' vocabulary — the router "
                             "cannot derive one ownership map")
        lookups[id_name] = table
    return task, link, lookups


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetView:
    """One immutable ownership snapshot: a request reads the view current
    when it started; a resize swaps the reference, never edits a view."""

    epoch: int
    fleet_size: int
    version: str
    endpoints: tuple  # member index -> base url


class FleetRouter:
    """An engine-shaped fleet scorer: ``score_rows(rows)`` as
    :class:`~photon_ml_tpu_torch.serving.engine.ScoringEngine` has it, so the
    front ends (service, batchers, HTTP/asyncio servers) serve a fleet with a
    router where an engine went.

    ``lookups`` maps ``id_name -> {entity value: training code}`` (see
    :func:`fleet_lookups_from_version_dir`); ``link`` is the link applied
    after the fold."""

    def __init__(
        self,
        announce_dir: str,
        lookups: Mapping[str, Mapping[str, int]],
        task: str = "logistic",
        link: Optional[str] = None,
        member_timeout_s: float = 5.0,
        retries: int = 1,
        backoff_s: float = 0.05,
        refresh_interval_s: float = 0.5,
        cooldown_s: float = 1.0,
        max_batch: int = 1024,
        sample_every: int = 0,
    ):
        self.announce_dir = announce_dir
        self._lookups = {name: dict(table) for name, table in dict(lookups).items()}
        self._num_entities = {name: len(table) for name, table in self._lookups.items()}
        self.task = task
        # unknown link names fold to identity, as the engine's do
        self._link = task if link is None else link
        self.member_timeout_s = float(member_timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.refresh_interval_s = float(refresh_interval_s)
        self.cooldown_s = float(cooldown_s)
        # the engine-shaped surface the front ends read
        self.max_batch = int(max_batch)
        self.max_row_nnz = None
        self.bucket_sizes = (int(max_batch),)
        self.warm = True
        self.entity_axis = None
        self.nearline_seq = 0
        self.lineage = None
        # every Nth routed batch is sampled: its full trace is persisted on
        # the router and, through the header, on the members; 0 = never
        self.sample_every = int(sample_every)
        self._req_seq = itertools.count(1)
        self._view: Optional[FleetView] = None
        self._view_lock = threading.Lock()
        # keyed by endpoint, not member index: a failure seen through a
        # superseded view (a call planned before a relaunch, failing on the
        # dead process's port) must not cool down the member's new process
        self._down_until: dict[str, float] = {}
        self._next_refresh = 0.0
        self._pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix="fleet-router")

    # -- fleet view ----------------------------------------------------------

    @property
    def version(self) -> str:
        view = self._view
        return view.version if view is not None else "fleet-unannounced"

    @property
    def view(self) -> Optional[FleetView]:
        return self._view

    def compile_summary(self) -> dict:
        return {}

    def refresh(self) -> Optional[FleetView]:
        """Re-scan the announce directory and adopt the newest complete epoch
        (an atomic swap through ``serving.resize_swap`` when the epoch or the
        size changes). Safe from any thread; the request path calls it on a
        cadence."""
        by_epoch: dict[tuple[int, int], dict[int, dict]] = {}
        for rec in scan_announce(self.announce_dir):
            try:
                key = (int(rec.get("epoch", 0)), int(rec["fleet_size"]))
                member = int(rec["member"])
            except (TypeError, ValueError, KeyError):
                continue
            if rec.get("ready", True) and "url" in rec:
                by_epoch.setdefault(key, {})[member] = rec
        for (epoch, fleet_size), members in sorted(by_epoch.items(), reverse=True):
            if set(members) != set(range(fleet_size)):
                continue  # an incomplete epoch: keep serving the old view
            view = FleetView(epoch=epoch, fleet_size=fleet_size,
                             version=str(members[0].get("version", "unversioned")),
                             endpoints=tuple(str(members[i]["url"]) for i in range(fleet_size)))
            return self._adopt(view)
        return self._view

    def _adopt(self, view: FleetView) -> Optional[FleetView]:
        with self._view_lock:
            old = self._view
            if old == view:
                return old
            if old is None or (old.epoch, old.fleet_size) != (view.epoch, view.fleet_size):
                try:
                    # an injected failure here must leave the old map serving
                    faults.fault_point(_FP_RESIZE_SWAP)
                except (faults.InjectedFault, faults.InjectedIOError):
                    telemetry.counter("serving.resize_swap_failures").inc()
                    return old
                telemetry.counter("serving.resize_swaps").inc()
            self._view = view  # the atomic ownership swap
            self._down_until.clear()
            return view

    def _current_view(self) -> FleetView:
        now = time.monotonic()
        if now >= self._next_refresh or self._view is None:
            self._next_refresh = now + self.refresh_interval_s
            self.refresh()
        view = self._view
        if view is None:
            raise FleetUnavailable(
                f"no complete serving-fleet epoch announced under {self.announce_dir}")
        return view

    def members_status(self) -> dict[int, dict]:
        """Each member's liveness as the router sees it: its cooldown (the
        router's degraded signal: rows it owns shed to fixed-effect-only
        until it recovers) and its fan-out RTT histogram
        (``serving.fanout_rtt_ms.m<i>``)."""
        view = self._view
        if view is None:
            return {}
        now = time.monotonic()
        hists = telemetry.snapshot().get("histograms", {})
        out: dict[int, dict] = {}
        for m in range(view.fleet_size):
            until = self._down_until.get(view.endpoints[m], 0.0)
            entry: dict = {
                "url": view.endpoints[m],
                "cooling_down": until > now,
                "cooldown_remaining_s": round(max(0.0, until - now), 3),
                "degraded": until > now,
            }
            rtt = hists.get(f"serving.fanout_rtt_ms.m{m}")
            if rtt:
                entry["fanout_rtt_ms"] = rtt
            out[m] = entry
        return out

    # -- request path --------------------------------------------------------

    def score_rows(self, rows: Sequence[Mapping],
                   ctx: Optional[request_trace.TraceContext] = None) -> np.ndarray:
        """Mean predictions for ``rows`` (``ScoringEngine.score_rows``'s
        contract), served by the fleet. Without an inbound ``ctx`` the call
        mints one and sends it to every member it calls."""
        if not rows:
            return np.zeros((0,), np.float32)
        if ctx is None:
            sampled = self.sample_every > 0 and next(self._req_seq) % self.sample_every == 0
            ctx = request_trace.make_context(sampled=sampled)
        rec = request_trace.begin("route", ctx=ctx, role="router", rows=len(rows))
        try:
            view = self._current_view()
        except FleetUnavailable as e:
            request_trace.finish(rec, status="error", error=str(e))
            raise
        if rec is not None:
            rec.set_attr(fleet_size=view.fleet_size, version=view.version, epoch=view.epoch)
        try:
            scores = self._score_routed(rows, view, ctx, rec)
        except FleetUnavailable as e:
            request_trace.finish(rec, status="error", error=str(e))
            raise
        request_trace.finish(rec)
        return scores

    def _owners(self, row, fleet: int) -> set:
        """The members owning ``row``'s known entities."""
        ids = row.get("ids") if isinstance(row, Mapping) else None
        owners = set()
        for id_name, table in self._lookups.items():
            value = (ids or {}).get(id_name)
            if value is None:
                continue
            code = table.get(str(value))
            if code is None:
                continue  # unseen entity: fixed-effect-only everywhere
            owners.add(owner_of_row(self._num_entities[id_name], code, fleet))
        return owners

    def _score_routed(self, rows: Sequence[Mapping], view: FleetView,
                      ctx: Optional[request_trace.TraceContext] = None, rec=None) -> np.ndarray:
        n, fleet = len(rows), view.fleet_size
        offsets = np.zeros((n,), np.float64)
        # the plan: row -> its owning members (one per entity) + one FE owner
        member_rows: dict[int, list[int]] = {}
        member_fe: dict[int, list[bool]] = {}
        row_owners = []
        for i, row in enumerate(rows):
            try:
                offsets[i] = float(row.get("offset") or 0.0)
            except (TypeError, ValueError, AttributeError):
                offsets[i] = 0.0  # the member rejects the malformed row
            owners = self._owners(row, fleet)
            row_owners.append(owners)
            fe_owner = min(owners) if owners else i % fleet
            for m in owners | {fe_owner}:
                member_rows.setdefault(m, []).append(i)
                member_fe.setdefault(m, []).append(m == fe_owner)
        t_fanout = time.monotonic()
        futures = {m: self._pool.submit(self._call_member, view, m,
                                        [self._sub_row(rows[i]) for i in idxs], member_fe[m],
                                        ctx, rec)
                   for m, idxs in member_rows.items()}
        totals = np.zeros((n,), np.float64)
        degraded = np.zeros((n,), bool)
        fe_orphans: list[int] = []
        failed: set[int] = set()
        # members fold in ascending order: the same rows against the same view
        # sum their partials in the same order, so they repeat bit for bit
        for m in sorted(futures):
            idxs = member_rows[m]
            try:
                totals[idxs] += np.asarray(futures[m].result(), np.float64)
            except _MemberUnavailable:
                failed.add(m)
                telemetry.counter("serving.member_failures").inc()
                for i, had_fe in zip(idxs, member_fe[m]):
                    if had_fe:
                        fe_orphans.append(i)
                    # only a lost ENTITY margin sheds accuracy; a fixed-effect
                    # margin retried elsewhere is exact
                    if m in row_owners[i]:
                        degraded[i] = True
        if rec is not None:
            rec.phase("fanout", (time.monotonic() - t_fanout) * 1000.0,
                      ts=request_trace.trace_time(t_fanout))
        t_fold = time.monotonic()
        if fe_orphans:
            totals[fe_orphans] += self._fe_fallback(view, [rows[i] for i in fe_orphans], failed,
                                                    ctx, rec)
        shed = int(np.count_nonzero(degraded))
        if shed:
            telemetry.counter("serving.degraded_scores").inc(shed)
        telemetry.counter("serving.routed_rows").inc(n)
        scores = totals + offsets
        link_fn = _LINKS.get(self._link)
        if link_fn is not None:
            scores = link_fn(scores)
        if rec is not None:
            rec.phase("fold", (time.monotonic() - t_fold) * 1000.0,
                      ts=request_trace.trace_time(t_fold))
            rec.set_attr(degraded=bool(shed), members=sorted(member_rows),
                         failed_members=sorted(failed))
        return np.asarray(scores, np.float32)

    @staticmethod
    def _sub_row(row) -> dict:
        """A member-bound copy of ``row``: the offset stays with the router
        (added once, after the fold)."""
        if not isinstance(row, Mapping):
            return {"features": {}}
        return {k: v for k, v in row.items() if k != "offset"}

    def _fe_fallback(self, view: FleetView, rows: Sequence[Mapping], failed: set,
                     ctx: Optional[request_trace.TraceContext] = None, rec=None) -> np.ndarray:
        """Fixed-effect margins for rows whose designate died, retried on any
        live member with the ids stripped (so no member adds entity margins
        a second time). Total fleet loss is the one unservable case."""
        stripped = [{k: v for k, v in self._sub_row(r).items() if k != "ids"} for r in rows]
        last_err: Optional[Exception] = None
        for m in range(view.fleet_size):
            if m in failed:
                continue
            try:
                return np.asarray(self._call_member(view, m, stripped, [True] * len(stripped),
                                                    ctx, rec), np.float64)
            except _MemberUnavailable as e:
                failed.add(m)
                telemetry.counter("serving.member_failures").inc()
                last_err = e
        raise FleetUnavailable(
            f"every member of fleet epoch {view.epoch} is unreachable") from last_err

    def _call_member(self, view: FleetView, member: int, sub_rows: list, include_fixed: list,
                     ctx: Optional[request_trace.TraceContext] = None, rec=None) -> list:
        """One member's margin batch, with bounded retry and backoff, then a
        cooldown, so a dead member costs one timeout per cooldown window,
        not one per request. Each attempt's RTT lands in
        ``serving.fanout_rtt_ms.m<i>``; the call's whole wall time is the
        ``member<i>_rtt`` phase of ``rec`` (appended from the pool thread)."""
        endpoint = view.endpoints[member]
        if self._down_until.get(endpoint, 0.0) > time.monotonic():
            raise _MemberUnavailable(f"member {member} cooling down")
        try:
            faults.fault_point(_FP_ROUTE_FANOUT)
        except (faults.InjectedFault, faults.InjectedIOError) as e:
            # the seam's contract: an injected failure IS the member
            # unreachable for this batch — degraded, never failed
            self._down_until[endpoint] = time.monotonic() + self.cooldown_s
            raise _MemberUnavailable(f"member {member} fan-out fault: {e}") from e
        headers = {"Content-Type": "application/json"}
        if ctx is not None:
            headers[request_trace.TRACE_HEADER] = ctx.to_header()
        body = json.dumps({"rows": sub_rows, "include_fixed": include_fixed,
                           "fleet_size": view.fleet_size, "version": view.version}).encode()
        url = endpoint + "/v1/margins"
        rtt_hist = telemetry.histogram(f"serving.fanout_rtt_ms.m{member}")
        t_call = time.monotonic()

        def rtt_phase() -> None:
            if rec is not None:
                rec.phase(f"member{member}_rtt", (time.monotonic() - t_call) * 1000.0,
                          ts=request_trace.trace_time(t_call))

        last_err: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            t_attempt = time.monotonic()
            try:
                req = urllib.request.Request(url, data=body, headers=headers)
                with urllib.request.urlopen(req, timeout=self.member_timeout_s) as resp:
                    payload = json.loads(resp.read())
                rtt_hist.observe((time.monotonic() - t_attempt) * 1000.0)
                self._down_until.pop(endpoint, None)
                margins = payload["margins"]
                if len(margins) != len(sub_rows):
                    raise _MemberUnavailable(f"member {member} returned {len(margins)} margins "
                                             f"for {len(sub_rows)} rows")
                rtt_phase()
                return margins
            except urllib.error.HTTPError as e:
                # 409: the member holds no engine for the pinned (fleet_size,
                # version), a mixed-swap window; shed it for this request
                # rather than blend versions
                rtt_hist.observe((time.monotonic() - t_attempt) * 1000.0)
                last_err = e
                if e.code == 409:
                    break
            except (OSError, ValueError, KeyError) as e:
                # a timeout's RTT counts too: without it the histogram hides
                # exactly the calls that hurt
                rtt_hist.observe((time.monotonic() - t_attempt) * 1000.0)
                last_err = e
            if attempt < self.retries:
                time.sleep(self.backoff_s * (2 ** attempt))
        self._down_until[endpoint] = time.monotonic() + self.cooldown_s
        rtt_phase()
        raise _MemberUnavailable(f"member {member} at {url}: {last_err}") from last_err

    def close(self):
        self._pool.shutdown(wait=False)
