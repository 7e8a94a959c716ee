"""Supervise a serving fleet: shard-owning ``cli serve --member`` processes
behind an in-process :class:`~photon_ml_tpu_torch.serving.FleetRouter`.

Counterpart of the serving half of the repo's ``tools/fleet.py``
(``make_serving_model``, ``ServingFleetSpec``, ``run_serving_fleet``).
:func:`run_serving_fleet`

1. launches N members (``python -m photon_ml_tpu_torch.cli serve --member i
   --fleet-size N --device <dev>``, ``PHOTON_PROC_ID`` set, a fault plan in
   ``PHOTON_FAULT_PLAN`` on the victim only) and waits for the epoch's
   announce files;
2. drives closed-loop traffic through the router from a thread;
3. hard-kills one member, detects the death by heartbeat staleness
   (``parallel.multihost.dead_peers``) and relaunches the member in its slot
   and epoch;
4. runs each live resize as: launch the growth slots at the next epoch,
   stage the new slice on the survivors, commit, wait for the complete
   epoch, then, once no call routed over the old view is in flight, drain
   the retired slots;
5. drains every member (SIGTERM -> exit 75) and returns a JSON-safe report:
   latency samples with the degraded rows of each call, failures, the kill's
   and each resize's timings, each member's start-up seconds, exit code,
   banner and drain line, and the spec's ``check_rows`` routed at every
   settled view (the start, after the relaunch, after each swap).

With ``device="cuda"`` member m runs on ``cuda:m mod count`` (every member
on ``cuda:0`` with one card); ``device="cpu"`` runs them on the CPU.

The members write their span streams and serving heartbeats
(``--trace-out``, ``--telemetry-out``) into one fleet directory,
``<workdir>/telemetry``, the in-process router writes
``trace.router.jsonl`` there (its ``request:route`` spans, every
``trace_sample_every``-th call sampled), the survivors dump their flight
records there at drain, and a hard-killed member's flight record is
harvested from the tail of its span stream once its death is detected.
That directory holds each slot's first process: a relaunch in a used slot
writes into ``telemetry/relaunch-<n>/`` instead, so the dead process's
stream (and its last words) survive beside the live ones, and ``cli report
--fleet <workdir>`` shows it lost.

Left out: the live status surface (``parallel/fleet_status.py``'s
``FleetStatusWriter``, which this supervisor does not publish to). A
member's death is detected from its heartbeat file and its exit code.

    from photon_ml_tpu_torch.tools.serving_fleet import (
        ServingFleetSpec, make_serving_model, run_serving_fleet)

    version_dir = make_serving_model("out/registry", n_entities=12)
    report = run_serving_fleet(ServingFleetSpec(
        workdir="out/fleet", model_dir=version_dir, fleet_size=3, device="cpu",
        kill_member=1, resizes=((3.0, 6), (14.0, 3))))
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_serving_model(
    registry_dir: str,
    n_entities: int = 48,
    fe_dim: int = 4,
    re_dim: int = 3,
    n_buckets: int = 2,
    task: str = "logistic",
    seed: int = 20260807,
) -> str:
    """Build and publish one small deterministic GAME model (a fixed effect
    on shard ``global`` plus a per-``userId`` random effect over
    ``n_entities`` entities on shard ``user``) into ``registry_dir``; returns
    the published version directory. The draws are those of the repo's
    ``tools/fleet.py``, so a seed publishes the same model files."""
    import torch

    from photon_ml_tpu_torch.game.models import (
        FixedEffectModel,
        GameModel,
        RandomEffectBucketModel,
        RandomEffectModel,
    )
    from photon_ml_tpu_torch.serving import publish_version

    rng = np.random.default_rng(seed)
    fe = FixedEffectModel(
        coefficients=torch.from_numpy(rng.normal(size=fe_dim).astype(np.float32)),
        shard_name="global")
    w_users = rng.normal(size=(n_entities, re_dim))
    entity_bucket = (np.arange(n_entities) % n_buckets).astype(np.int64)
    entity_pos = np.zeros(n_entities, np.int64)
    buckets = []
    for b in range(n_buckets):
        codes_b = np.nonzero(entity_bucket == b)[0]
        entity_pos[codes_b] = np.arange(len(codes_b))
        proj = np.tile(np.arange(re_dim, dtype=np.int32), (len(codes_b), 1))
        buckets.append(RandomEffectBucketModel(
            coefficients=torch.from_numpy(w_users[codes_b].astype(np.float32)),
            projection=torch.from_numpy(proj),
            entity_codes=np.asarray(codes_b, np.int32)))
    re_model = RandomEffectModel(id_name="userId", shard_name="user", buckets=tuple(buckets),
                                 entity_bucket=entity_bucket, entity_pos=entity_pos,
                                 vocab=np.arange(n_entities))
    model = GameModel(task=task, models={"fixed": fe, "perUser": re_model})
    index_maps = {"global": [f"g{j}" for j in range(fe_dim)],
                  "user": [f"u{j}" for j in range(re_dim)]}
    return publish_version(registry_dir, model, index_maps)


@dataclasses.dataclass
class ServingFleetSpec:
    """One supervised serving-fleet run: N shard-owning members, an
    in-process router driving traffic, heartbeat supervision with a
    same-slot relaunch, and live resizes through the stage/commit barrier."""

    workdir: str
    #: a published model directory (feature-indexes/ + model-metadata.json)
    model_dir: str
    fleet_size: int = 3
    max_batch: int = 64
    #: "cuda" (member m on cuda:m mod count) or "cpu"
    device: str = "cuda"
    #: each member's slice budget; None skips the check
    hbm_budget_mb: Optional[float] = None
    #: staleness past which a member with no exit code counts as dead
    heartbeat_deadline_s: float = 3.0
    #: how long one member gets to load, warm and announce
    warm_timeout_s: float = 180.0
    timeout_s: float = 600.0
    #: the router's fan-out timeout per member call
    member_timeout_s: float = 3.0
    router_refresh_s: float = 0.15
    # -- the traffic the supervisor drives through the router
    traffic_seconds: float = 6.0
    traffic_rows: int = 8
    traffic_hz: float = 20.0
    #: dense feature noise on each traffic row, ``((shard_name, n_cols), ...)``:
    #: ``[col, value]`` pairs for cols [0, n_cols) of that shard
    traffic_features: tuple = ()
    rng_seed: int = 20260807
    # -- hard-kill one member mid-traffic (None: no kill)
    kill_member: Optional[int] = None
    kill_after_s: float = 1.5
    # -- live resizes: ((after_s, new_fleet_size), ...)
    resizes: tuple = ()
    # -- a fault plan armed in exactly one member's environment
    victim_plan: Optional[dict] = None
    victim_member: int = 1
    #: rows routed at every settled view (the start, after the relaunch,
    #: after each swap); the report's ``checks`` holds their scores
    check_rows: tuple = ()
    #: the router samples every Nth routed call (0: never; slow, degraded
    #: and failed calls persist all the same)
    trace_sample_every: int = 0

    def announce_dir(self) -> str:
        return os.path.join(self.workdir, "announce")

    def fleet_dir(self) -> str:
        return os.path.join(self.workdir, "fleet")

    def telemetry_dir(self) -> str:
        return os.path.join(self.workdir, "telemetry")


@dataclasses.dataclass
class _ServingMember:
    proc: subprocess.Popen
    member: int
    fleet_size: int
    epoch: int
    device: str
    out_path: str
    err_path: str
    t_launch: float
    #: where its span stream, serving heartbeats and flight record go
    telemetry_dir: Optional[str] = None
    startup_s: Optional[float] = None
    rc: Optional[int] = None


def _member_device(spec: ServingFleetSpec, member: int) -> str:
    if spec.device != "cuda":
        return spec.device
    import torch

    return f"cuda:{member % max(torch.cuda.device_count(), 1)}"


def _serving_member_env(spec: ServingFleetSpec, member: int) -> dict:
    env = dict(os.environ)
    env["PHOTON_PROC_ID"] = str(member)
    env["PYTHONPATH"] = _repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PHOTON_FAULT_PLAN", None)
    if spec.victim_plan is not None and member == spec.victim_member:
        env["PHOTON_FAULT_PLAN"] = json.dumps(spec.victim_plan)
    return env


def _launch_serving_member(spec: ServingFleetSpec, member: int, fleet_size: int, epoch: int,
                           telemetry_dir: Optional[str] = None) -> _ServingMember:
    """One ``cli serve --member`` process; with ``telemetry_dir`` it writes
    ``trace.proc-<m>.jsonl`` and ``serving.proc-<m>.jsonl`` there (and its
    drain dump ``flight-proc-<m>.json``)."""
    os.makedirs(spec.workdir, exist_ok=True)
    stem, n = os.path.join(spec.workdir, f"member{member}-e{epoch}"), 0
    while os.path.exists(f"{stem}-{n}.out"):  # a relaunch keeps the dead one's logs
        n += 1
    out_path, err_path = f"{stem}-{n}.out", f"{stem}-{n}.err"
    device = _member_device(spec, member)
    argv = [sys.executable, "-m", "photon_ml_tpu_torch.cli", "serve",
            "--model-dir", spec.model_dir,
            "--member", str(member), "--fleet-size", str(fleet_size),
            "--announce-dir", spec.announce_dir(), "--epoch", str(epoch),
            "--host", "127.0.0.1", "--port", "0",
            "--max-batch", str(spec.max_batch),
            "--heartbeat-dir", spec.fleet_dir(), "--device", device]
    if spec.hbm_budget_mb is not None:
        argv += ["--hbm-budget-mb", str(spec.hbm_budget_mb)]
    if telemetry_dir is not None:
        os.makedirs(telemetry_dir, exist_ok=True)
        # PHOTON_PROC_ID in the member's environment suffixes --trace-out to
        # trace.proc-<member>.jsonl
        argv += ["--telemetry-out",
                 os.path.join(telemetry_dir, f"serving.proc-{member}.jsonl"),
                 "--trace-out", os.path.join(telemetry_dir, "trace.jsonl")]
    with open(out_path, "wb") as out, open(err_path, "wb") as err:
        proc = subprocess.Popen(argv, env=_serving_member_env(spec, member), cwd=_repo_root(),
                                stdout=out, stderr=err)
    return _ServingMember(proc, member, fleet_size, epoch, device, out_path, err_path,
                          t_launch=time.monotonic(), telemetry_dir=telemetry_dir)


def _admin_post(url: str, op: str, payload: dict, timeout_s: float) -> dict:
    import urllib.request

    req = urllib.request.Request(f"{url}/v1/admin/{op}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def _scan_ready(spec: ServingFleetSpec, epoch: int, fleet_size: int) -> list[dict]:
    from photon_ml_tpu_torch.serving import scan_announce

    return [r for r in scan_announce(spec.announce_dir())
            if int(r.get("epoch", -1)) == epoch and int(r.get("fleet_size", -1)) == fleet_size
            and r.get("ready")]


def _wait_for_epoch(spec: ServingFleetSpec, epoch: int, fleet_size: int, deadline: float,
                    members: Optional[dict] = None) -> dict:
    """Block until every member of ``(epoch, fleet_size)`` has announced
    ready; returns {member: record}. A launched member of this epoch (in
    ``members``) counts only once its record names its own pid (a killed
    predecessor's stale record in the same slot does not), gets its
    start-up seconds then, and fails the wait at once if it exits first."""
    want = set(range(fleet_size))
    records: dict[int, dict] = {}
    while time.monotonic() < deadline:
        records = {int(r["member"]): r for r in _scan_ready(spec, epoch, fleet_size)}
        for m, mem in (members or {}).items():
            if mem.epoch != epoch:
                continue
            if m in records and records[m].get("pid") != mem.proc.pid:
                del records[m]
            elif m in records and mem.startup_s is None:
                mem.startup_s = round(time.monotonic() - mem.t_launch, 3)
            if m not in records and mem.proc.poll() is not None:
                raise RuntimeError(f"serving member {m} exited {mem.proc.returncode} before "
                                   f"announcing epoch {epoch}; see {mem.err_path}")
        if set(records) == want:
            return records
        time.sleep(0.05)
    raise TimeoutError(f"serving fleet epoch {epoch} (size {fleet_size}) incomplete after the "
                       f"warm timeout; have {sorted(records)}")


class _TrafficDriver:
    """Closed-loop traffic through the router on a thread: each call's start
    (seconds from the first call), wall ms, rows and the degraded rows it
    counted (the router serves only this thread, so the counter's change
    over a call is that call's), so disturbance windows can be cut out."""

    def __init__(self, router, rows_fn, hz: float):
        self.router = router
        self.rows_fn = rows_fn
        self.period_s = 1.0 / max(hz, 0.1)
        self.samples: list = []  # (t_rel, latency_ms, rows, degraded rows)
        self.failures: list = []  # (t_rel, error)
        self.call_started: Optional[float] = None  # the call in flight, if any
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="serving-traffic", daemon=True)
        self.t0 = 0.0

    def start(self) -> "_TrafficDriver":
        self.t0 = time.monotonic()
        self._thread.start()
        return self

    def _run(self) -> None:
        from photon_ml_tpu_torch import telemetry

        degraded = telemetry.counter("serving.degraded_scores")
        while not self._stop.is_set():
            rows = self.rows_fn()
            t_start = self.call_started = time.monotonic()
            d0 = degraded.value
            try:
                self.router.score_rows(rows)
                self.samples.append((round(t_start - self.t0, 4),
                                     round((time.monotonic() - t_start) * 1000.0, 3),
                                     len(rows), int(degraded.value - d0)))
            except Exception as e:  # noqa: BLE001 — a failed call IS the finding
                self.failures.append((round(t_start - self.t0, 4), f"{type(e).__name__}: {e}"))
            self.call_started = None
            rest = self.period_s - (time.monotonic() - t_start)
            if rest > 0:
                self._stop.wait(rest)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def wait_for_calls_started_after(self, t: float, deadline: float) -> None:
        """Block until no call that started before ``t`` (and so may route
        over an older view) is still in flight."""
        while time.monotonic() < deadline:
            started = self.call_started
            if started is None or started >= t:
                return
            time.sleep(0.01)


def _traffic_rows_fn(spec: ServingFleetSpec, lookups: dict):
    """Deterministic traffic: each call's rows take ids across the whole
    vocabulary of every coordinate (so every member owns part of most
    calls), plus the spec's dense feature noise."""
    rng = np.random.default_rng(spec.rng_seed)
    values = {id_name: list(table) for id_name, table in lookups.items()}

    def rows_fn():
        return [{"features": {shard: [[j, float(rng.normal())] for j in range(n_cols)]
                              for shard, n_cols in spec.traffic_features},
                 "ids": {id_name: str(vals[int(rng.integers(len(vals)))])
                         for id_name, vals in values.items() if vals}}
                for _ in range(spec.traffic_rows)]

    return rows_fn


def _quiet_latency(samples: list, windows: list) -> dict:
    """p50/p99 wall ms of the calls that started outside every disturbance
    window ``(t_lo, t_hi)``."""
    lat = [s[1] for s in samples if not any(lo <= s[0] <= hi for lo, hi in windows)]
    if not lat:
        return {"calls": 0, "p50_ms": None, "p99_ms": None}
    arr = np.asarray(lat, np.float64)
    return {"calls": len(lat), "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99))}


def run_serving_fleet(spec: ServingFleetSpec) -> dict:
    """Supervise a shard-owning serving fleet end to end (see the module
    docstring); the report's ``ok`` is False when any routed call failed."""
    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.parallel import multihost
    from photon_ml_tpu_torch.serving import FleetRouter, fleet_lookups_from_version_dir
    from photon_ml_tpu_torch.telemetry import requests as rq

    os.makedirs(spec.announce_dir(), exist_ok=True)
    os.makedirs(spec.fleet_dir(), exist_ok=True)
    deadline = time.monotonic() + spec.timeout_s
    report: dict = {"workdir": spec.workdir, "events": []}
    task, link, lookups = fleet_lookups_from_version_dir(spec.model_dir)
    fleet_size, epoch = spec.fleet_size, 0
    members: dict[int, _ServingMember] = {}
    retired: list[_ServingMember] = []
    router = traffic = None
    counters = ("serving.degraded_scores", "serving.routed_rows", "serving.member_failures")
    base = {name: telemetry.counter(name).value for name in counters}
    launched: set[int] = set()
    relaunches = [0]

    def launch(m: int, size: int, at_epoch: int) -> _ServingMember:
        """A member into the fleet directory, or, in a slot used before,
        into the next ``relaunch-<n>`` beside it."""
        tdir = spec.telemetry_dir()
        if m in launched:
            relaunches[0] += 1
            tdir = os.path.join(tdir, f"relaunch-{relaunches[0]}")
        launched.add(m)
        return _launch_serving_member(spec, m, size, at_epoch, telemetry_dir=tdir)

    report["telemetry_dir"] = spec.telemetry_dir()
    os.makedirs(spec.telemetry_dir(), exist_ok=True)
    # the router's half of every fan-out trace, beside the members'
    telemetry.configure(trace_out=os.path.join(spec.telemetry_dir(), "trace.router.jsonl"))
    try:
        for m in range(fleet_size):
            members[m] = launch(m, fleet_size, epoch)
        records = _wait_for_epoch(spec, epoch, fleet_size,
                                  min(deadline, time.monotonic() + spec.warm_timeout_s), members)
        version = str(records[0]["version"])
        router = FleetRouter(spec.announce_dir(), lookups, task=task, link=link,
                             member_timeout_s=spec.member_timeout_s,
                             refresh_interval_s=spec.router_refresh_s, retries=1,
                             backoff_s=0.05, cooldown_s=0.4,
                             sample_every=spec.trace_sample_every)
        router.refresh()
        checks = report["checks"] = []

        def check(at: str) -> None:
            if spec.check_rows:
                view = router.view
                scores = router.score_rows(list(spec.check_rows))
                checks.append({"at": at, "epoch": view.epoch, "fleet_size": view.fleet_size,
                               "scores": [float(x) for x in scores]})

        check("start")
        traffic = _TrafficDriver(router, _traffic_rows_fn(spec, lookups), spec.traffic_hz).start()
        t0 = traffic.t0

        def rel() -> float:
            return round(time.monotonic() - t0, 4)

        kill_at = None if spec.kill_member is None else t0 + spec.kill_after_s
        resize_plan = [(t0 + after_s, int(new_size)) for after_s, new_size in spec.resizes]
        traffic_end = t0 + spec.traffic_seconds
        killed: Optional[dict] = None
        # a resize that slips past the end of traffic still completes under
        # traffic: every scheduled swap lands while calls flow
        while time.monotonic() < deadline and (time.monotonic() < traffic_end or resize_plan):
            now = time.monotonic()
            if kill_at is not None and now >= kill_at:
                kill_at = None
                victim = members[spec.kill_member]
                t_kill = rel()
                victim.proc.kill()
                victim.rc = victim.proc.wait()
                killed = {"member": spec.kill_member, "t_kill": t_kill}
                report["events"].append({"kill": dict(killed)})
                # heartbeat staleness, then a relaunch in the same slot and
                # epoch (an endpoint update, not an ownership change: no
                # serving.resize_swap)
                while time.monotonic() < deadline:
                    if spec.kill_member in multihost.dead_peers(
                            spec.fleet_dir(), fleet_size, spec.heartbeat_deadline_s):
                        break
                    time.sleep(0.05)
                killed["detect_s"] = round(rel() - t_kill, 3)
                # it never ran its drain dump: its last words come from the
                # tail of its span stream (a torn last line dropped)
                flight = rq.harvest_flight(
                    os.path.join(victim.telemetry_dir, f"trace.proc-{spec.kill_member}.jsonl"),
                    rq.flight_path(victim.telemetry_dir, spec.kill_member))
                if flight is not None:
                    killed["flight_spans"] = flight
                retired.append(victim)
                fresh = launch(spec.kill_member, fleet_size, epoch)
                members[spec.kill_member] = fresh
                records = _wait_for_epoch(spec, epoch, fleet_size,
                                          min(deadline, time.monotonic() + spec.warm_timeout_s),
                                          {spec.kill_member: fresh})
                router.refresh()
                killed["recovery_s"] = round(rel() - t_kill, 3)
                killed["startup_s"] = fresh.startup_s
                check("relaunch")
                continue
            if resize_plan and now >= resize_plan[0][0]:
                _t, new_size = resize_plan.pop(0)
                event = {"from": fleet_size, "to": new_size, "t_start": rel(),
                         "epoch": epoch + 1}
                survivors = list(range(min(fleet_size, new_size)))
                # 1) growth first: the new slots load and warm while the
                #    survivors stage
                growth = {m: launch(m, new_size, epoch + 1) for m in range(fleet_size, new_size)}
                members.update(growth)
                # 2) stage the new slice on every survivor while the old one
                #    serves (concurrently: N separate processes)
                with ThreadPoolExecutor(max_workers=max(len(survivors), 1)) as pool:
                    for fut in [pool.submit(_admin_post, records[m]["url"], "stage",
                                            {"fleet_size": new_size, "version": version},
                                            spec.warm_timeout_s) for m in survivors]:
                        fut.result()
                # 3) the barrier: commit the survivors (each re-announces at
                #    the new size and epoch)
                for m in survivors:
                    _admin_post(records[m]["url"], "commit",
                                {"fleet_size": new_size, "version": version,
                                 "epoch": epoch + 1}, spec.member_timeout_s * 4)
                old_size = fleet_size
                epoch += 1
                records = _wait_for_epoch(spec, epoch, new_size,
                                          min(deadline, time.monotonic() + spec.warm_timeout_s),
                                          growth)
                fleet_size = new_size
                router.refresh()
                t_refresh = time.monotonic()
                event["t_swap"] = rel()
                event["growth_startup_s"] = {m: g.startup_s for m, g in growth.items()}
                check(f"resize {old_size}->{new_size}")
                # 4) shrink: retire the slots no longer owned (SIGTERM ->
                #    503 + Retry-After -> exit 75), once no call routed over
                #    the old view can still reach them
                traffic.wait_for_calls_started_after(
                    t_refresh, min(deadline, time.monotonic() + spec.member_timeout_s * 4))
                for m in range(new_size, old_size):
                    gone = members.pop(m)
                    gone.proc.send_signal(signal.SIGTERM)
                    retired.append(gone)
                    try:
                        os.unlink(os.path.join(spec.announce_dir(), f"member-{m}.json"))
                    except OSError:
                        pass
                report["events"].append({"resize": event})
                continue
            time.sleep(0.05)
        traffic.stop()
        report["t_end"] = rel()
        if killed is not None:
            report["kill"] = killed
        # graceful teardown: every member drains and exits 75 (the retired
        # ones have their signal already: a second one is a hard exit)
        for m in members.values():
            if m.proc.poll() is None:
                m.proc.send_signal(signal.SIGTERM)
        everyone = list(members.values()) + retired
        for m in everyone:
            if m.rc is None:
                try:
                    m.rc = m.proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    m.proc.kill()
                    m.rc = m.proc.wait()
        report["members"] = [
            {"member": m.member, "epoch": m.epoch, "fleet_size": m.fleet_size,
             "device": m.device, "startup_s": m.startup_s, "rc": m.rc,
             "telemetry_dir": m.telemetry_dir,
             "killed": killed is not None and m.rc == -signal.SIGKILL,
             "banner": _json_line(m.out_path, "serving"),
             "drained": _json_line(m.out_path, "drained")} for m in everyone]
        windows = []
        if killed is not None:
            windows.append((killed["t_kill"], killed.get("recovery_s", 0.0) + killed["t_kill"]))
        for ev in report["events"]:
            if "resize" in ev:
                windows.append((ev["resize"]["t_start"], ev["resize"]["t_swap"]))
        report["quiet_latency"] = _quiet_latency(traffic.samples, windows)
        report["samples"] = traffic.samples
        report["failures"] = traffic.failures
        for name in counters:
            report[name.split(".", 1)[1]] = int(telemetry.counter(name).value - base[name])
        report["fleet_size"] = fleet_size
        report["epoch"] = epoch
        report["ok"] = not traffic.failures
        return report
    finally:
        if traffic is not None and traffic._thread.is_alive():
            traffic.stop()
        if router is not None:
            router.close()
        telemetry.trace.TRACER.close_sink()
        for m in list(members.values()) + retired:
            if m.proc.poll() is None:
                m.proc.kill()
                m.proc.wait()


def _json_line(out_path: str, key: str) -> Optional[dict]:
    """A member's ``{"<key>": ...}`` line (its ``serving`` banner, its
    ``drained`` line), if it printed one."""
    try:
        with open(out_path) as fh:
            for line in fh:
                if line.startswith('{"%s"' % key):
                    return json.loads(line)[key]
    except (OSError, ValueError):
        pass
    return None
