"""The crash matrices: recovery proven at every write-path, fleet, pipeline,
quality and serving fault point of photon_ml_tpu_torch.

Counterpart of the repo's ``tools/chaos.py``, driving the port's modules.
Each row kills a subprocess with an ``exit`` rule through
``PHOTON_FAULT_PLAN`` (``os._exit``: no unwinding, the shape of a
preemption), checks that it died with the injection code 113 (the seam
fired, not something else), reruns it unarmed over the same directories and
holds the result to the reference row's bound:

- ``run_matrix``: the four write-path points of the checkpoint protocol over
  a streamed random-effect fit that checkpoints at every chunk boundary; the
  resumed table must be exactly the uninterrupted one;
- ``run_fleet_matrix``: one 2-process gloo fleet (``tools/fleet.py``) per
  training-fleet seam (``multihost.init``, ``fleet.heartbeat``,
  ``checkpoint.peer_manifest``, ``parallel.collective.entry``), one member
  hard-killed; the survivors' resumed fit must end within 1e-6 (relative) of
  the uninterrupted fleet's loss, and no checkpoint may be certified
  partial;
- ``run_pipeline_matrix``: a ``cli pipeline`` daemon killed at each
  ``pipeline.*`` seam leaves the base checkpoint byte-identical and the
  registry without a partial version, and the rerun publishes;
- ``run_quality_matrix``: a publisher killed at ``quality.publish_gate``
  leaves the registry untouched; the rerun quarantines the regressed
  challenger and publishes the healthy one;
- ``run_serving_matrix``: ``member_load_io``, ``route_fanout_io``,
  ``resize_swap`` and the hard kill under traffic
  (``tools/serving_fleet.py``). ``flight_dump_kill`` is ROADMAP.md Queue 1
  item 14d's and is reported as not ported, never as passed.

A ``budget_s`` reports the rows it did not reach under ``skipped``; none is
dropped silently. The workers run on ``--device`` (default cuda; cpu runs
the kernels' plain versions)::

    python -m photon_ml_tpu_torch.tools.chaos --workdir out/chaos [--device cpu]
    python -m photon_ml_tpu_torch.tools.chaos --workdir out/chaos --fleet
    python -m photon_ml_tpu_torch.tools.chaos --workdir out/chaos --pipeline
    python -m photon_ml_tpu_torch.tools.chaos --workdir out/chaos --quality
    python -m photon_ml_tpu_torch.tools.chaos --workdir out/chaos --serving-fleet
    python -m photon_ml_tpu_torch.tools.chaos --worker --dir D   # one fit (internal)
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

#: the worker fit's shape (the reference's): small, and enough chunks that a
#: crash at the first boundary resumes mid-stream
N_ENTITIES = 16
N_ROWS = 8
DIM = 4
N_CHUNKS = 4
DATA_SEED = 20260803

#: the injection's exit code (faults.DEFAULT_EXIT_CODE)
EXIT_CODE = 113


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worker_env(plan: Optional[dict]) -> dict:
    """A subprocess's environment: the fault plan, if any, and the repo on
    the path."""
    env = dict(os.environ)
    env.pop("PHOTON_FAULT_PLAN", None)
    env.pop("PHOTON_FLEET_ARMED_PLAN", None)
    if plan is not None:
        env["PHOTON_FAULT_PLAN"] = json.dumps(plan)
    root = _repo_root()
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def exit_plan(point: str, nth: int = 1) -> dict:
    """A fault plan that hard-kills the process at ``point``'s nth hit."""
    return {"rules": [{"point": point, "action": "exit", "nth": nth}]}


def run_worker(workdir: str, plan: Optional[dict] = None, device: str = "cuda",
               timeout: float = 600.0) -> subprocess.CompletedProcess:
    """One worker fit in ``workdir``: checkpoints in ``workdir/ckpt``, the
    final table in ``workdir/final.npy``."""
    os.makedirs(workdir, exist_ok=True)
    return subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.tools.chaos", "--worker", "--dir", workdir,
         "--device", device],
        env=worker_env(plan), cwd=_repo_root(), capture_output=True, text=True,
        timeout=timeout)


def _report(workdir: str, points: Sequence[str], **extra) -> dict:
    return {"workdir": workdir, "points": list(points), "results": {}, "skipped": [],
            "ok": True, **extra}


def _over_budget(report: dict, points: Sequence[str], t0: float,
                 budget_s: Optional[float]) -> bool:
    """True once ``budget_s`` is spent; the rows not reached go to
    ``skipped``."""
    if budget_s is None or time.monotonic() - t0 <= budget_s:
        return False
    report["skipped"] = [p for p in points if p not in report["results"]]
    return True


def _last_json(proc: subprocess.CompletedProcess) -> dict:
    try:
        return json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {}


# ---------------------------------------------------------------------------
# the write-path matrix
# ---------------------------------------------------------------------------


def run_matrix(workdir: str, points: Optional[Sequence[str]] = None,
               budget_s: Optional[float] = None, nth: int = 1, device: str = "cuda",
               jobs: int = 1) -> dict:
    """The write-path crash matrix; ``ok`` only when every row attempted
    died at its seam, resumed and ended on the uninterrupted table exactly.
    The uninterrupted fit runs beside ``jobs`` rows at once (each in its own
    directory); a row that starts after ``budget_s`` is reported skipped."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from photon_ml_tpu_torch import faults
    import photon_ml_tpu_torch.game.checkpoint  # noqa: F401 (registers the seams)

    all_points = faults.write_path_points()
    points = list(points) if points is not None else all_points
    unknown = sorted(set(points) - set(all_points))
    if unknown:
        raise ValueError(f"not registered write-path fault points: {unknown} "
                         f"(known: {all_points})")
    t0 = time.monotonic()
    report = _report(workdir, points, nth=nth, device=device)

    def reference_fit() -> np.ndarray:
        ref_dir = os.path.join(workdir, "reference")
        proc = run_worker(ref_dir, device=device)
        if proc.returncode != 0:
            raise RuntimeError(f"reference fit failed (rc={proc.returncode}):\n"
                               f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        report["reference_s"] = round(time.monotonic() - t0, 3)
        return np.load(os.path.join(ref_dir, "final.npy"))

    def row(point: str) -> Optional[dict]:
        if budget_s is not None and time.monotonic() - t0 > budget_s:
            return None
        t_row = time.monotonic()
        entry: dict = {"point": point}
        point_dir = os.path.join(workdir, point.replace(".", "_"))
        armed = run_worker(point_dir, plan=exit_plan(point, nth=nth), device=device)
        entry["armed_rc"] = armed.returncode
        if armed.returncode != EXIT_CODE:
            entry["error"] = (f"armed run exited {armed.returncode}, expected {EXIT_CODE} (did "
                              f"the point fire?)\n{armed.stdout[-1000:]}\n{armed.stderr[-1000:]}")
        else:
            resumed = run_worker(point_dir, device=device)
            entry["resume_rc"] = resumed.returncode
            if resumed.returncode != 0:
                entry["error"] = (f"resume run failed (rc={resumed.returncode}):\n"
                                  f"{resumed.stdout[-1000:]}\n{resumed.stderr[-1000:]}")
            else:
                entry["resumed_from_chunk"] = _last_json(resumed).get("start_chunk")
        entry["seconds"] = time.monotonic() - t_row
        return entry

    with ThreadPoolExecutor(max(int(jobs), 1) + 1) as pool:
        ref = pool.submit(reference_fit)
        entries = list(pool.map(row, points))
        reference = ref.result()
    for point, entry in zip(points, entries):
        if entry is None:
            report["skipped"].append(point)
            continue
        if "error" not in entry:
            got = np.load(os.path.join(workdir, point.replace(".", "_"), "final.npy"))
            entry["max_abs_delta"] = float(np.max(np.abs(got - reference)))
            entry["exact"] = bool(np.array_equal(got, reference))
            if not entry["exact"]:
                entry["error"] = ("resumed final table does not match the uninterrupted "
                                  f"reference (max |delta| = {entry['max_abs_delta']:g})")
        entry["passed"] = "error" not in entry
        report["ok"] &= entry["passed"]
        report["results"][point] = entry
    report["elapsed_s"] = round(time.monotonic() - t0, 3)
    return report


# ---------------------------------------------------------------------------
# the distributed matrix (training-fleet rows, through tools/fleet.py)
# ---------------------------------------------------------------------------

#: how each fleet seam is armed on the victim: (the boundary after which its
#: plan is installed, -1 from the process's start; the hit it dies on). Every
#: row that can have a certified coordinated checkpoint behind it has one
#: (the port's fleet installs a victim plan at a boundary, after the previous
#: boundary's save was certified):
#:   multihost.init            from the start, 1st hit: dead before joining
#:   fleet.heartbeat           after chunk 1's boundary, at once: mid-fit
#:   checkpoint.peer_manifest  the next coordinated save: abandoned by quorum
#:                             timeout, never certified partial
#:   parallel.collective.entry the next chunk solve: the survivor stuck in a
#:                             collective is reclaimed by SIGKILL
FLEET_ARMING = {
    "multihost.init": (-1, 1),
    "fleet.heartbeat": (0, 1),
    "checkpoint.peer_manifest": (0, 1),
    "parallel.collective.entry": (0, 1),
}

#: the survivor-resume bound on the final loss, relative (tools/chaos.py:366)
FLEET_LOSS_RTOL = 1e-6


def fleet_final_loss(table, device: str = "cpu") -> float:
    """The small fleet problem's objective at a final table (float64)."""
    from photon_ml_tpu_torch.tools import fleet

    return fleet.problem_loss("small", 0, table, device=device)


def run_fleet_matrix(workdir: str, points: Optional[Sequence[str]] = None,
                     budget_s: Optional[float] = None, device: str = "cuda") -> dict:
    """The distributed crash matrix: for each training-fleet seam a 2-process
    gloo fleet with member 1 hard-killed there must see the member die with
    the injection code, resume on the survivor and complete, end within
    ``FLEET_LOSS_RTOL`` of the uninterrupted fleet's loss, and never certify
    a partial checkpoint (audited over the row's checkpoint directory)."""
    import numpy as np

    from photon_ml_tpu_torch import faults
    import photon_ml_tpu_torch.game.checkpoint  # noqa: F401 (registers the seams)
    import photon_ml_tpu_torch.parallel.distributed  # noqa: F401
    import photon_ml_tpu_torch.parallel.multihost  # noqa: F401
    from photon_ml_tpu_torch.tools import fleet

    # the serving.* seams fire in router and member processes: the serving
    # matrix owns them
    all_points = [p for p in faults.distributed_points() if not p.startswith("serving.")]
    points = list(points) if points is not None else all_points
    unknown = sorted(set(points) - set(all_points))
    if unknown:
        raise ValueError(f"not registered distributed fault points: {unknown} "
                         f"(known: {all_points})")
    t0 = time.monotonic()
    report = _report(workdir, points, device=device)

    def make_spec(subdir: str, plan: Optional[dict], arm: int = 0) -> "fleet.FleetSpec":
        return fleet.FleetSpec(
            workdir=os.path.join(workdir, subdir), num_processes=2,
            device="cpu" if device == "cpu" else "cuda", victim_plan=plan, victim_process=1,
            victim_arm_after_chunk=arm, quorum_timeout_s=3.0, grace_s=8.0,
            heartbeat_deadline_s=5.0, timeout_s=240.0)

    ref = fleet.run_fleet(make_spec("reference_fleet", None))
    if not ref.get("ok"):
        raise RuntimeError("uninterrupted reference fleet failed: "
                           f"{json.dumps(ref, default=str)[:2000]}")
    ref_loss = fleet_final_loss(np.load(ref["final_path"]))
    report["reference_loss"] = ref_loss
    for point in points:
        if _over_budget(report, points, t0, budget_s):
            break
        t_row = time.monotonic()
        entry: dict = {"point": point}
        subdir = point.replace(".", "_")
        arm, nth = FLEET_ARMING.get(point, (0, 1))
        run = fleet.run_fleet(make_spec(subdir, exit_plan(point, nth=nth), arm))
        gen0 = run["generations"][0]
        entry.update(generations=len(run["generations"]), relaunches=run.get("relaunches"),
                     victim_rc=gen0["rcs"].get(1), deaths=run.get("deaths_total"),
                     detect_s=run.get("detect_s"), relaunch_s=run.get("relaunch_s"))
        problems = []
        if gen0["rcs"].get(1) != EXIT_CODE:
            problems.append(f"victim exited {gen0['rcs'].get(1)}, expected {EXIT_CODE} (did "
                            "the seam fire?)")
        if not run.get("ok"):
            problems.append("fleet did not complete after the member death: "
                            + json.dumps(run["generations"], default=str)[:1500])
        else:
            got_loss = fleet_final_loss(np.load(run["final_path"]))
            entry["final_loss"] = got_loss
            entry["loss_delta"] = abs(got_loss - ref_loss)
            entry["loss_rel_delta"] = entry["loss_delta"] / max(abs(ref_loss), 1e-30)
            if entry["loss_rel_delta"] >= FLEET_LOSS_RTOL:
                problems.append("survivor-resumed final loss off the uninterrupted fleet's by "
                                f"{entry['loss_rel_delta']:g} relative (>= {FLEET_LOSS_RTOL})")
        partial = fleet.verify_certified_checkpoints(os.path.join(workdir, subdir, "ckpt"),
                                                     fleet.N_ENTITIES, fleet.DIM)
        entry["partial_certified"] = partial
        if partial:
            problems.append(f"partially certified checkpoint(s) observed: {partial}")
        if problems:
            entry["error"] = "; ".join(problems)
        entry["passed"] = not problems
        entry["seconds"] = time.monotonic() - t_row
        report["ok"] &= entry["passed"]
        report["results"][point] = entry
    report["elapsed_s"] = round(time.monotonic() - t0, 3)
    return report


# ---------------------------------------------------------------------------
# the serving matrix (shard-owning fleet rows)
# ---------------------------------------------------------------------------

#: the serving rows, cheapest first, so a tight budget still lands the
#: in-process seam rows before the subprocess hard kill
SERVING_ROWS = ("member_load_io", "route_fanout_io", "resize_swap", "flight_dump_kill",
                "member_hard_kill")

#: rows this package does not run yet, with the ROADMAP item that owns them
SERVING_NOT_PORTED = {"flight_dump_kill": "14d"}

#: hard-kill recovery budget: heartbeat detection plus a same-slot relaunch
KILL_RECOVERY_BUDGET_S = 120.0


def _mini_member(version_dir: str, announce_dir: str, member: int, fleet_size: int,
                 device: str, epoch: int = 0):
    """One in-process shard member: a slice engine behind a
    ``ShardMemberSource``, a ``ScoringServer`` on an ephemeral port, and its
    announce record. Returns (server, source)."""
    from photon_ml_tpu_torch.serving import (
        ScoringServer,
        ScoringService,
        ShardMemberSource,
        load_member_engine,
        write_announce,
    )

    def loader(fs, version=None):
        return load_member_engine(version_dir, member, fs, max_batch=16, device=device)

    source = ShardMemberSource(loader, member=member, fleet_size=fleet_size)
    source.commit(*source.stage(fleet_size))
    server = ScoringServer(ScoringService(source, max_batch=16), port=0).start()
    write_announce(announce_dir, {
        "member": member, "fleet_size": fleet_size, "epoch": epoch,
        "url": f"http://127.0.0.1:{server.port}", "version": source.engine.version,
        "ready": True, "pid": os.getpid(), "owned": {}})
    return server, source


def _serving_rows(n_entities: int) -> list[dict]:
    """Rows over every entity, so every member owns part of every batch."""
    return [{"features": {"global": [[0, 0.5], [1, -0.25]], "user": [[0, 1.0], [1, 0.5]]},
             "ids": {"userId": str(i)}} for i in range(n_entities)]


def _router_row(row: str, workdir: str, version_dir: str, n_entities: int, device: str,
                entry: dict, problems: list) -> None:
    """``route_fanout_io`` or ``resize_swap`` over two in-process members."""
    import numpy as np

    from photon_ml_tpu_torch import faults, telemetry
    from photon_ml_tpu_torch.serving import (
        FleetRouter,
        ScoringEngine,
        fleet_lookups_from_version_dir,
        write_announce,
    )

    sub = os.path.join(workdir, row)
    announce = os.path.join(sub, "announce")
    os.makedirs(announce, exist_ok=True)
    members = [_mini_member(version_dir, announce, m, 2, device) for m in range(2)]
    task, link, lookups = fleet_lookups_from_version_dir(version_dir)
    router = FleetRouter(announce, lookups, task=task, link=link, member_timeout_s=5.0,
                         cooldown_s=0.05, backoff_s=0.01)
    ref_engine = ScoringEngine.load(version_dir, max_batch=16, device=device)
    ref_engine.warmup()
    score_rows = _serving_rows(n_entities)
    ref = np.asarray(ref_engine.score_rows(score_rows))
    try:
        router.refresh()
        if row == "route_fanout_io":
            degraded0 = telemetry.counter("serving.degraded_scores").value
            faults.install_plan(faults.FaultPlan([
                faults.FaultRule("serving.route_fanout", action="io", nth=1)]))
            shed = np.asarray(router.score_rows(score_rows))
            faults.clear_plan()
            entry["degraded_scores"] = int(telemetry.counter("serving.degraded_scores").value
                                           - degraded0)
            if len(shed) != len(score_rows):
                problems.append("degraded request dropped rows")
            if not entry["degraded_scores"]:
                problems.append("injected fan-out failure shed nothing (seam misses the "
                                "request path?)")
            time.sleep(0.1)  # the member's cooldown lapses
            clean = np.asarray(router.score_rows(score_rows))
            entry["recovered_delta"] = float(np.max(np.abs(clean - ref)))
            if entry["recovered_delta"] >= 1e-6:
                problems.append("post-shed request off single-engine parity by "
                                f"{entry['recovered_delta']:g}")
            return
        failed0 = telemetry.counter("serving.resize_swap_failures").value
        old_epoch = router.view.epoch
        for m, (server, source) in enumerate(members):
            write_announce(announce, {
                "member": m, "fleet_size": 2, "epoch": 1,
                "url": f"http://127.0.0.1:{server.port}", "version": source.engine.version,
                "ready": True, "pid": os.getpid(), "owned": {}})
        faults.install_plan(faults.FaultPlan([
            faults.FaultRule("serving.resize_swap", action="raise", nth=1)]))
        router.refresh()
        faults.clear_plan()
        entry["swap_failures"] = int(telemetry.counter("serving.resize_swap_failures").value
                                     - failed0)
        if router.view.epoch != old_epoch:
            problems.append("injected swap failure still adopted the new epoch (old view not "
                            "preserved)")
        if not entry["swap_failures"]:
            problems.append("swap failure not counted serving.resize_swap_failures")
        during = np.asarray(router.score_rows(score_rows))
        entry["old_view_delta"] = float(np.max(np.abs(during - ref)))
        if entry["old_view_delta"] >= 1e-6:
            problems.append("old view served wrong scores under the failed swap")
        router.refresh()  # unarmed: adopts epoch 1
        if router.view.epoch != 1:
            problems.append("unarmed refresh did not adopt the new epoch")
        after = np.asarray(router.score_rows(score_rows))
        if float(np.max(np.abs(after - ref))) >= 1e-6:
            problems.append("post-swap scores off single-engine parity")
    finally:
        router.close()
        for server, _source in members:
            server.stop()


def run_serving_matrix(workdir: str, rows: Optional[Sequence[str]] = None,
                       budget_s: Optional[float] = None, traffic_seconds: float = 8.0,
                       device: str = "cuda") -> dict:
    """The serving-fleet chaos matrix:

    - ``member_load_io``: an injected IO failure in the slice load surfaces
      as ``OSError``; the unarmed retry loads and serves;
    - ``route_fanout_io``: an injected fan-out failure degrades that
      member's entity margins to fixed-effect-only (the request succeeds,
      ``serving.degraded_scores`` counts the shed), and the next request is
      back to single-engine parity;
    - ``resize_swap``: an injected ownership-swap failure leaves the old view
      serving (``serving.resize_swap_failures``); the unarmed refresh adopts
      the new epoch with parity;
    - ``member_hard_kill``: a 3-process ``cli serve`` fleet under router
      traffic, one member SIGKILLed: no request failure that is not a shed,
      degraded scores accounted, heartbeat detection and a same-slot
      relaunch within ``KILL_RECOVERY_BUDGET_S``, every member draining to
      exit 75;
    - ``flight_dump_kill``: not ported (ROADMAP.md Queue 1 item 14d), reported
      with ``not_ported`` and never as passed.
    """
    from photon_ml_tpu_torch import faults
    from photon_ml_tpu_torch.tools import serving_fleet

    known = list(SERVING_ROWS)
    rows = list(rows) if rows is not None else known
    unknown = sorted(set(rows) - set(known))
    if unknown:
        raise ValueError(f"not serving chaos rows: {unknown} (known: {known})")
    t0 = time.monotonic()
    report = _report(workdir, rows, rows=rows, not_ported={}, device=device)
    os.makedirs(workdir, exist_ok=True)
    n_entities = 12
    version_dir = serving_fleet.make_serving_model(os.path.join(workdir, "registry"),
                                                   n_entities=n_entities)
    for row in rows:
        if _over_budget(report, rows, t0, budget_s):
            break
        if row in SERVING_NOT_PORTED:
            report["not_ported"][row] = f"ROADMAP.md Queue 1 item {SERVING_NOT_PORTED[row]}"
            continue
        t_row = time.monotonic()
        entry: dict = {"row": row}
        problems: list = []
        faults.clear_plan()
        try:
            if row == "member_load_io":
                from photon_ml_tpu_torch.serving import load_member_engine

                faults.install_plan(faults.FaultPlan([
                    faults.FaultRule("serving.member_load", action="io", nth=1)]))
                try:
                    load_member_engine(version_dir, 0, 2, max_batch=16, device=device)
                    problems.append("armed slice load did not raise (seam misses the load "
                                    "path?)")
                except OSError as e:
                    entry["armed_error"] = f"{type(e).__name__}: {e}"
                finally:
                    faults.clear_plan()
                engine = load_member_engine(version_dir, 0, 2, max_batch=16, device=device)
                got = engine.score_rows(_serving_rows(n_entities)[:4])
                entry["retry_scores"] = len(got)
                if len(got) != 4:
                    problems.append("unarmed retry did not serve")
            elif row in ("route_fanout_io", "resize_swap"):
                _router_row(row, workdir, version_dir, n_entities, device, entry, problems)
            elif row == "member_hard_kill":
                spec = serving_fleet.ServingFleetSpec(
                    workdir=os.path.join(workdir, row), model_dir=version_dir, fleet_size=3,
                    device="cpu" if device == "cpu" else "cuda",
                    traffic_seconds=traffic_seconds, traffic_hz=10.0, traffic_rows=6,
                    traffic_features=(("global", 2), ("user", 2)), kill_member=1,
                    kill_after_s=min(2.0, traffic_seconds / 3), heartbeat_deadline_s=2.0)
                run = serving_fleet.run_serving_fleet(spec)
                entry.update(routed_rows=run.get("routed_rows"),
                             degraded_scores=run.get("degraded_scores"),
                             degraded_fraction=run.get("degraded_fraction"),
                             failures=len(run.get("failures") or []), kill=run.get("kill"),
                             rcs=run.get("rcs"))
                if run.get("failures"):
                    problems.append("non-shed request failures under the kill: "
                                    + "; ".join(str(f) for f in run["failures"][:3]))
                if not run.get("degraded_scores"):
                    problems.append("hard kill shed nothing (did the outage overlap "
                                    "traffic?)")
                if (run.get("degraded_scores") or 0) > (run.get("routed_rows") or 0):
                    problems.append("degraded accounting exceeds routed rows")
                recovery = (run.get("kill") or {}).get("recovery_s")
                if recovery is None:
                    problems.append("no relaunch recovery recorded")
                elif recovery > KILL_RECOVERY_BUDGET_S:
                    problems.append(f"recovery took {recovery:.1f}s "
                                    f"(> {KILL_RECOVERY_BUDGET_S:.0f}s budget)")
                bad_rcs = {m: rc for m, rc in (run.get("rcs") or {}).items() if rc != 75}
                if bad_rcs:
                    problems.append(f"members did not drain to exit 75: {bad_rcs}")
        except Exception as e:  # noqa: BLE001 - a row that crashes is the finding
            problems.append(f"row crashed: {type(e).__name__}: {e}")
        finally:
            faults.clear_plan()
        if problems:
            entry["error"] = "; ".join(problems)
        entry["passed"] = not problems
        entry["seconds"] = time.monotonic() - t_row
        report["ok"] &= entry["passed"]
        report["results"][row] = entry
    report["elapsed_s"] = round(time.monotonic() - t0, 3)
    return report


# ---------------------------------------------------------------------------
# the pipeline matrix (the freshness conductor's daemon)
# ---------------------------------------------------------------------------

#: the conductor's cycle seams, in cycle order
PIPELINE_POINTS = ("pipeline.cycle_start", "pipeline.reconcile", "pipeline.escalate")


def tree_digest(root: str) -> str:
    """A byte-level digest of a directory tree (relative paths and contents):
    the base checkpoint's "untouched" is stated over it."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for name in sorted(filenames):
            p = os.path.join(dirpath, name)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def registry_debris(reg: str) -> dict:
    """A registry's published versions and ``.tmp-`` assembly directories."""
    names = sorted(os.listdir(reg)) if os.path.isdir(reg) else []
    return {"versions": [n for n in names if n.startswith("v-")],
            "tmp": [n for n in names if n.startswith(".tmp-")], "all": names}


def pipeline_fixture(workdir: str, device: str, in_process: bool = False) -> dict:
    """The pipeline rows' world (the reference's): a small Avro base, one
    delta shard touching 2 of 8 users and one new user (under the default
    escalation fraction, so the unarmed reruns stay incremental), a train
    config, and the base fit's step checkpoint from ``cli train`` in a
    subprocess (``in_process``: in this process). Returns {cfg_path, ckpt,
    delta_dir}."""
    import numpy as np

    from photon_ml_tpu_torch.data.avro import TRAINING_EXAMPLE_AVRO, write_avro

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(DATA_SEED)
    d, n_users, n_base, n_delta = 6, 8, 160, 36
    X = rng.normal(size=(n_base + n_delta, d))
    users = np.concatenate([rng.integers(0, n_users, n_base),
                            np.array([1, 2, n_users] * (n_delta // 3))])
    w = rng.normal(size=d)
    u_eff = rng.normal(size=n_users + 1)
    logits = X @ w + u_eff[users]
    y = (rng.random(len(users)) < 1 / (1 + np.exp(-logits))).astype(float)

    def recs(lo, hi):
        for i in range(lo, hi):
            yield {"uid": str(i), "label": float(y[i]),
                   "features": [{"name": f"c{j}", "term": "", "value": float(X[i, j])}
                                for j in range(d)],
                   "metadataMap": {"userId": str(users[i])}, "weight": None, "offset": None}

    train_path = os.path.join(workdir, "train.avro")
    delta_dir = os.path.join(workdir, "deltas")
    os.makedirs(delta_dir, exist_ok=True)
    write_avro(train_path, TRAINING_EXAMPLE_AVRO, recs(0, n_base))
    write_avro(os.path.join(delta_dir, "delta-0001.avro"), TRAINING_EXAMPLE_AVRO,
               recs(n_base, n_base + n_delta))
    ckpt = os.path.join(workdir, "base-ckpt")
    config = {
        "task": "logistic",
        "input": {"format": "avro", "paths": [train_path],
                  "feature_shards": {"global": ["features"]}, "id_columns": ["userId"]},
        "coordinates": {
            "fixed": {"type": "fixed_effect", "shard_name": "global",
                      "optimizer": {"regularization": "l2", "regularization_weight": 0.1}},
            "perUser": {"type": "random_effect", "shard_name": "global", "id_name": "userId",
                        "optimizer": {"regularization": "l2", "regularization_weight": 1.0}},
        },
        "num_iterations": 1,
        "output_dir": os.path.join(workdir, "base-model"),
        "checkpoint": {"dir": ckpt, "resume": False},
    }
    cfg_path = os.path.join(workdir, "train.json")
    with open(cfg_path, "w", encoding="utf-8") as fh:
        json.dump(config, fh)
    if in_process:
        from photon_ml_tpu_torch.cli.train import run

        run(dict(config), device=device)
        return {"cfg_path": cfg_path, "ckpt": ckpt, "delta_dir": delta_dir}
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli", "train", "--config", cfg_path,
         "--device", device],
        env=worker_env(None), cwd=_repo_root(), capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"pipeline fixture base train failed (rc={proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return {"cfg_path": cfg_path, "ckpt": ckpt, "delta_dir": delta_dir}


def pipeline_command(cfg_path: str, base: str, delta_dir: str, registry: str, work: str,
                     device: str, *extra: str) -> list[str]:
    """The ``cli pipeline`` daemon's command line."""
    return [sys.executable, "-m", "photon_ml_tpu_torch.cli", "pipeline", "--config", cfg_path,
            "--base", base, "--delta-dir", delta_dir, "--registry-dir", registry,
            "--workdir", work, "--device", device, *extra]


def run_pipeline_matrix(workdir: str, points: Optional[Sequence[str]] = None,
                        budget_s: Optional[float] = None, device: str = "cuda",
                        fixture: Optional[dict] = None) -> dict:
    """The freshness conductor's crash matrix: for each ``pipeline.*`` seam a
    ``cli pipeline`` daemon armed to exit there must (1) die with the
    injection code, (2) leave the base checkpoint byte-identical, (3) leave
    the registry without a version or ``.tmp-`` debris, and (4) publish a
    lineage-linked version on the unarmed rerun over the same directories.
    The ``pipeline.escalate`` row escalates after one cycle, so its rerun is
    a full retrain, which also leaves the base untouched. ``fixture`` (the
    dict ``pipeline_fixture`` returns) reuses a world instead of building
    one."""
    from photon_ml_tpu_torch import faults
    import photon_ml_tpu_torch.pipeline  # noqa: F401 (registers the seams)

    known = list(PIPELINE_POINTS)
    points = list(points) if points is not None else known
    unknown = sorted(set(points) - set(known))
    if unknown:
        raise ValueError(f"not pipeline fault points: {unknown} (known: {known})")
    assert set(points) <= set(faults.registered_points())
    t0 = time.monotonic()
    report = _report(workdir, points, device=device)
    fix = fixture if fixture is not None else pipeline_fixture(workdir, device)
    base_before = tree_digest(fix["ckpt"])
    report["base_digest"] = base_before
    report["fixture_s"] = round(time.monotonic() - t0, 3)
    for point in points:
        if _over_budget(report, points, t0, budget_s):
            break
        t_row = time.monotonic()
        entry: dict = {"point": point}
        problems: list = []
        sub = os.path.join(workdir, point.replace(".", "_"))
        reg = os.path.join(sub, "registry")
        extra = ["--cycles", "1", "--interval-s", "0.1"]
        if point == "pipeline.escalate":
            extra += ["--escalate-after-cycles", "1"]
        cmd = pipeline_command(fix["cfg_path"], fix["ckpt"], fix["delta_dir"], reg,
                               os.path.join(sub, "work"), device, *extra)
        armed = subprocess.run(cmd, env=worker_env(exit_plan(point)), cwd=_repo_root(),
                               capture_output=True, text=True, timeout=600)
        entry["armed_rc"] = armed.returncode
        entry["armed_s"] = time.monotonic() - t_row
        if armed.returncode != EXIT_CODE:
            problems.append(f"armed daemon exited {armed.returncode}, expected {EXIT_CODE} "
                            f"(did the seam fire?) {armed.stderr[-500:]}")
        if tree_digest(fix["ckpt"]) != base_before:
            problems.append("hard kill mutated the warm-start base checkpoint")
        debris = registry_debris(reg)
        entry["registry_after_kill"] = debris["all"]
        if debris["versions"]:
            problems.append(f"kill mid-cycle left published version(s): {debris['all']}")
        if debris["tmp"]:
            problems.append(f"kill left .tmp- assembly debris: {debris['all']}")
        resumed = subprocess.run(cmd, env=worker_env(None), cwd=_repo_root(),
                                 capture_output=True, text=True, timeout=600)
        entry["resume_rc"] = resumed.returncode
        if resumed.returncode != 0:
            problems.append(f"unarmed rerun failed (rc={resumed.returncode}): "
                            f"{resumed.stdout[-500:]} {resumed.stderr[-500:]}")
        else:
            summary = _last_json(resumed)
            entry["published_versions"] = summary.get("published_versions")
            entry["escalations"] = summary.get("escalations")
            entry["staleness_p99_s"] = summary.get("event_to_served_staleness_p99_s")
            if not summary.get("published_versions"):
                problems.append("unarmed rerun published nothing")
            if point == "pipeline.escalate" and summary.get("escalations") != 1:
                problems.append("the rerun of the escalate row did not escalate")
            entry["registry_after_resume"] = registry_debris(reg)["versions"]
            if not entry["registry_after_resume"]:
                problems.append("no registry version after the unarmed rerun")
        if tree_digest(fix["ckpt"]) != base_before:
            problems.append("unarmed rerun mutated the base checkpoint")
        if problems:
            entry["error"] = "; ".join(problems)
        entry["passed"] = not problems
        entry["seconds"] = time.monotonic() - t_row
        report["ok"] &= entry["passed"]
        report["results"][point] = entry
    report["elapsed_s"] = round(time.monotonic() - t0, 3)
    return report


# ---------------------------------------------------------------------------
# the quality row (the publish gate)
# ---------------------------------------------------------------------------


def _quality_worker_main(directory: str, mode: str, device: str) -> int:
    """Publish one version through the champion/challenger gate (in a
    subprocess, so the armed run can die at the seam). ``champion``: a
    first version (no champion: it publishes); ``challenger-bad``: an AUC
    below the champion's CI (quarantined); ``challenger-good``: inside the
    CI (published)."""
    import numpy as np
    import torch

    from photon_ml_tpu_torch import faults
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.game.models import FixedEffectModel, GameModel
    from photon_ml_tpu_torch.quality import QualityGateRefused, QualityStats
    from photon_ml_tpu_torch.serving.registry import publish_version

    faults.warn_if_armed()
    dev = resolve_device(device)
    model = GameModel(task="logistic", models={"fixed": FixedEffectModel(
        coefficients=torch.from_numpy(np.linspace(-0.5, 0.5, DIM).astype(np.float32)).to(dev),
        shard_name="global")})
    index_maps = {"global": [f"f{i}" for i in range(DIM)]}
    stats = {
        "champion": QualityStats(auc=0.80, auc_ci_low=0.75, auc_ci_high=0.85, rows=200,
                                 bootstrap_samples=8),
        "challenger-bad": QualityStats(auc=0.60, auc_ci_low=0.55, auc_ci_high=0.65, rows=200,
                                       bootstrap_samples=8),
        "challenger-good": QualityStats(auc=0.82, auc_ci_low=0.77, auc_ci_high=0.87, rows=200,
                                        bootstrap_samples=8),
    }[mode]
    try:
        path = publish_version(os.path.join(directory, "registry"), model, index_maps,
                               quality=stats.to_json(),
                               lineage={"base_kind": "chaos", "mode": mode})
        print(json.dumps({"published": os.path.basename(path)}))
    except QualityGateRefused as exc:
        print(json.dumps({"quarantined": os.path.basename(exc.quarantine_path or ""),
                          "decision": exc.decision.to_json()}))
    return 0


def run_quality_matrix(workdir: str, device: str = "cuda") -> dict:
    """The publish-gate crash row: a publisher hard-killed at
    ``quality.publish_gate`` (before any registry write) leaves no partial,
    ``.tmp-`` or wrongly quarantined version and the champion byte-identical;
    the unarmed rerun quarantines the regressed challenger (the champion
    still serving) and a healthy challenger publishes."""
    import photon_ml_tpu_torch.quality  # noqa: F401 (registers the seam)

    point = "quality.publish_gate"
    t0 = time.monotonic()
    report = _report(workdir, [point], device=device)
    entry: dict = {"point": point}
    problems: list = []
    os.makedirs(workdir, exist_ok=True)
    reg = os.path.join(workdir, "registry")

    def worker(mode, plan=None):
        return subprocess.run(
            [sys.executable, "-m", "photon_ml_tpu_torch.tools.chaos", "--worker-quality",
             "--dir", workdir, "--mode", mode, "--device", device],
            env=worker_env(plan), cwd=_repo_root(), capture_output=True, text=True,
            timeout=600)

    champ = worker("champion")
    champ_name = _last_json(champ).get("published")
    if champ.returncode != 0 or not champ_name:
        problems.append(f"champion publish failed (rc={champ.returncode}): "
                        f"{champ.stderr[-500:]}")
    champion_digest = tree_digest(reg)
    champ_dir = os.path.join(reg, champ_name or "")
    listing_before = registry_debris(reg)["all"]

    armed = worker("challenger-bad", plan=exit_plan(point))
    entry["armed_rc"] = armed.returncode
    if armed.returncode != EXIT_CODE:
        problems.append(f"armed publisher exited {armed.returncode}, expected {EXIT_CODE} (did "
                        f"the seam fire?) {armed.stderr[-500:]}")
    listing = registry_debris(reg)["all"]
    entry["registry_after_kill"] = listing
    if any(n.startswith(".tmp-") for n in listing):
        problems.append(f"kill left .tmp- assembly debris: {listing}")
    if any(n.startswith("quarantined-") for n in listing):
        problems.append(f"kill mid-gate left a wrongly quarantined version: {listing}")
    if listing != listing_before:
        problems.append(f"kill changed the registry: {listing_before} -> {listing}")
    if tree_digest(reg) != champion_digest:
        problems.append("hard kill mutated the champion version")

    rerun = worker("challenger-bad")
    out = _last_json(rerun)
    entry["rerun_rc"] = rerun.returncode
    entry["quarantined"] = out.get("quarantined")
    if rerun.returncode != 0 or not out.get("quarantined"):
        problems.append("unarmed regressed challenger did not quarantine cleanly "
                        f"(rc={rerun.returncode}, out={out}) {rerun.stderr[-500:]}")
    if not any(n.startswith("quarantined-") for n in registry_debris(reg)["all"]):
        problems.append("no quarantine directory after the rerun")

    good = worker("challenger-good")
    out = _last_json(good)
    entry["published"] = out.get("published")
    if good.returncode != 0 or not out.get("published"):
        problems.append(f"healthy challenger failed to publish (rc={good.returncode}, "
                        f"out={out}) {good.stderr[-500:]}")
    if champ_name and not os.path.isdir(champ_dir):
        problems.append(f"champion {champ_name} vanished during the matrix")
    if problems:
        entry["error"] = "; ".join(problems)
    entry["passed"] = not problems
    report["ok"] = entry["passed"]
    report["results"][point] = entry
    report["elapsed_s"] = round(time.monotonic() - t0, 3)
    return report


# ---------------------------------------------------------------------------
# the worker fit (in the subprocess)
# ---------------------------------------------------------------------------


def _worker_main(directory: str, device: str) -> int:
    import numpy as np
    import torch

    from photon_ml_tpu_torch import faults
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.game.checkpoint import CheckpointSpec, StreamingCheckpointManager
    from photon_ml_tpu_torch.game.streaming import (
        ShardedCoefficientTable,
        StreamingRandomEffectTrainer,
    )
    from photon_ml_tpu_torch.ops.dense import DenseBatch
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )

    os.makedirs(directory, exist_ok=True)
    faults.warn_if_armed()
    dev = resolve_device(device)
    rng = np.random.default_rng(DATA_SEED)
    X = rng.normal(size=(N_ENTITIES, N_ROWS, DIM))
    W = rng.normal(size=(N_ENTITIES, DIM))
    z = np.einsum("erk,ek->er", X, W)
    y = (rng.random((N_ENTITIES, N_ROWS)) < 1 / (1 + np.exp(-z))).astype(float)
    per = N_ENTITIES // N_CHUNKS

    def chunk(lo, hi):
        return DenseBatch.from_arrays(
            X[lo:hi].astype(np.float32), y[lo:hi].astype(np.float32),
            np.zeros((hi - lo, N_ROWS), np.float32), np.ones((hi - lo, N_ROWS), np.float32),
            device=dev)

    chunks = [(i * per, chunk(i * per, (i + 1) * per)) for i in range(N_CHUNKS)]
    cfg = OptimizerConfig(max_iterations=60, tolerance=1e-9, regularization_weight=0.3,
                          regularization=RegularizationContext(RegularizationType.L2))
    mgr = StreamingCheckpointManager(CheckpointSpec(directory=os.path.join(directory, "ckpt"),
                                                    every=1))
    state = mgr.restore()  # the newest valid one, past whatever a crash left
    table = ShardedCoefficientTable(N_ENTITIES, DIM, device=dev)
    start_chunk = 0
    if state is not None:
        table.write_chunk(0, torch.as_tensor(np.asarray(state.coefficients), device=dev))
        start_chunk = state.next_chunk
    trainer = StreamingRandomEffectTrainer("logistic", cfg, prefetch=False, device=dev)
    trainer.train(table, chunks, checkpointer=mgr, start_chunk=start_chunk)
    final = os.path.join(directory, "final.npy")
    np.save(final, table.to_numpy())
    print(json.dumps({"final": final, "resumed": state is not None,
                      "start_chunk": start_chunk, "device": str(dev)}))
    return 0


def _print_report(report: dict, kind: str) -> None:
    for point, entry in report["results"].items():
        status = "ok" if entry.get("passed") else "FAIL"
        detail = {k: entry.get(k) for k in ("armed_rc", "victim_rc", "resumed_from_chunk",
                                            "relaunches", "loss_rel_delta", "degraded_scores",
                                            "published_versions", "quarantined", "published",
                                            "error") if entry.get(k) is not None}
        print(f"{status:4s} {point}  {json.dumps(detail, default=str)}")
    for point, why in (report.get("not_ported") or {}).items():
        print(f"not ported {point}  ({why})")
    for point in report["skipped"]:
        print(f"skip {point}  (budget exhausted)")
    print(f"{kind}: {'OK' if report['ok'] else 'FAILED'} in {report['elapsed_s']:.1f}s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.tools.chaos",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--worker", action="store_true", help="run one worker fit (internal)")
    parser.add_argument("--worker-quality", action="store_true",
                        help="publish one gated version (internal)")
    parser.add_argument("--dir", help="the worker's directory")
    parser.add_argument("--mode", default="champion",
                        help="worker-quality mode: champion | challenger-bad | challenger-good")
    parser.add_argument("--workdir", help="the matrix's working directory")
    parser.add_argument("--device", default="cuda",
                        help="where the workers run (default cuda; cpu runs the plain versions)")
    parser.add_argument("--fleet", action="store_true",
                        help="the distributed matrix (2-process gloo fleets, one member "
                        "hard-killed a seam)")
    parser.add_argument("--serving-fleet", action="store_true",
                        help="the serving matrix (shard-owning fleet seams and the hard kill "
                        "under traffic)")
    parser.add_argument("--pipeline", action="store_true",
                        help="the pipeline matrix (cli pipeline killed at each pipeline.* seam)")
    parser.add_argument("--quality", action="store_true",
                        help="the quality row (a publisher killed at quality.publish_gate)")
    parser.add_argument("--points", nargs="*", help="a subset of the matrix's points or rows")
    parser.add_argument("--nth", type=int, default=1,
                        help="crash on the nth hit of each write-path point (default 1)")
    parser.add_argument("--jobs", type=int, default=1,
                        help="write-path rows run at once (default 1)")
    parser.add_argument("--budget-s", type=float,
                        help="wall-time budget; the rows not reached are reported skipped")
    parser.add_argument("--json", dest="json_out", help="write the report here")
    args = parser.parse_args(argv)
    if args.worker or args.worker_quality:
        if not args.dir:
            parser.error("--worker and --worker-quality need --dir")
        if args.worker:
            return _worker_main(args.dir, args.device)
        return _quality_worker_main(args.dir, args.mode, args.device)
    if not args.workdir:
        parser.error("--workdir is required (or --worker --dir)")
    if args.quality:
        kind, report = "quality", run_quality_matrix(args.workdir, device=args.device)
    elif args.pipeline:
        kind, report = "pipeline", run_pipeline_matrix(
            args.workdir, points=args.points, budget_s=args.budget_s, device=args.device)
    elif args.serving_fleet:
        kind, report = "serving", run_serving_matrix(
            args.workdir, rows=args.points, budget_s=args.budget_s, device=args.device)
    elif args.fleet:
        kind, report = "fleet", run_fleet_matrix(
            args.workdir, points=args.points, budget_s=args.budget_s, device=args.device)
    else:
        kind, report = "write-path", run_matrix(
            args.workdir, points=args.points, budget_s=args.budget_s, nth=args.nth,
            device=args.device, jobs=args.jobs)
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True, default=str)
    _print_report(report, kind)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
