"""The port's serving fleet (``photon_ml_tpu_torch.serving.shard`` and
``.router``, ``cli serve --member/--router``, ``tools/serving_fleet.py``)
against the JAX package's, case for case with tests/test_serving_fleet.py:
ownership and its inverse, indivisible sizes, member slices whose margins
fold to the single engine's scores, owned ranges and the slice budget, the
stage/commit barrier with version pins (409), the router's parity and exact
degraded accounting, a live resize through the announce files, torn
announce files, the three serving seams, drain with 503 + Retry-After, and a
real 3-process ``cli serve --member --device cpu`` fleet (parity under a
budget the full model exceeds, exact shedding after a SIGKILL, drain to
exit 75). Beyond the reference's cases: the port's router against the JAX
router over one published model, two random effects keyed by one id, a
member slice restored from a streamed checkpoint's rows, the heartbeat
files, a ``cli serve --router`` process over the 3-process fleet, and
``run_serving_fleet`` through a kill, a relaunch and a 3 -> 6 -> 3
resize. The 3-process fleet also carries part (d) of the reference's
(:540-640): one request trace joined by ``trace_id`` across the router's and
the members' streams, the survivors' drain-path flight dumps, and the killed
member's last words harvested from its span stream, read by both packages'
``FleetReport`` and by ``cli report --fleet``; ``run_serving_fleet`` keeps
the killed process's stream and last words beside its relaunch's.
Tolerance 1e-6, the reference's (:584-586).
"""

import filecmp
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.parallel.sharding import (
    ElasticPlacementError,
    member_row_range,
    owner_of_row,
    valid_fleet_sizes,
)
from photon_ml_tpu_torch.serving import (
    AsyncScoringServer,
    FleetRouter,
    ScoringEngine,
    ScoringServer,
    ScoringService,
    ShardBudgetError,
    ShardMemberSource,
    fleet_lookups_from_version_dir,
    load_member_engine,
    member_owned_ranges,
    publish_version,
    scan_announce,
    slice_model_for_member,
    write_announce,
)
from photon_ml_tpu_torch.serving.batcher import Draining
from photon_ml_tpu_torch.serving.shard import serving_table_bytes
from photon_ml_tpu_torch.tools import serving_fleet

N_ENTITIES = 12
CPU = "cpu"


@pytest.fixture(autouse=True)
def _port_telemetry():
    telemetry.reset()
    yield
    faults.clear_plan()
    telemetry.reset()


def _same_tree(a: str, b: str) -> list[str]:
    """Relative paths under ``a`` whose bytes differ from ``b``'s (or that
    one side lacks)."""
    diff = []
    for root, _dirs, files in os.walk(a):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), a)
            other = os.path.join(b, rel)
            if not (os.path.exists(other)
                    and filecmp.cmp(os.path.join(a, rel), other, shallow=False)):
                diff.append(rel)
    for root, _dirs, files in os.walk(b):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), b)
            if not os.path.exists(os.path.join(a, rel)):
                diff.append(rel)
    return diff


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """One published model (FE ``global`` + 12-entity ``userId`` RE), from
    both launchers: the port's ``make_serving_model`` must publish the
    reference's files byte for byte."""
    from tools import fleet as j_fleet

    j_dir = j_fleet.make_serving_model(str(tmp_path_factory.mktemp("j-registry")),
                                       n_entities=N_ENTITIES)
    version_dir = serving_fleet.make_serving_model(str(tmp_path_factory.mktemp("registry")),
                                                   n_entities=N_ENTITIES)
    task, link, lookups = fleet_lookups_from_version_dir(version_dir)
    return {"version_dir": version_dir, "j_version_dir": j_dir, "task": task, "link": link,
            "lookups": lookups}


@pytest.fixture(scope="module")
def member_engine(published):
    """One warmed slice engine per (member, fleet_size), shared by the file."""
    cache: dict = {}

    def get(member: int, fleet_size: int) -> ScoringEngine:
        key = (member, fleet_size)
        if key not in cache:
            cache[key] = load_member_engine(published["version_dir"], member, fleet_size,
                                            max_batch=16, device=CPU)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def full_engine(published):
    return ScoringEngine.load(published["version_dir"], max_batch=16, device=CPU)


def _request_rows(n=N_ENTITIES, with_offset=True):
    rows = []
    for i in range(n):
        row = {"features": {"global": [[0, 0.5], [1, -0.25], [2, float(i) / 10]],
                            "user": [[0, 1.0], [1, 0.5]]},
               "ids": {"userId": str(i)}}
        if with_offset:
            row["offset"] = 0.1 * (i % 3)
        rows.append(row)
    return rows


def _fe_only(rows):
    return [{k: v for k, v in r.items() if k != "ids"} for r in rows]


def _start_fleet(member_engine, announce_dir, fleet_size=3, epoch=0, frontend="threading"):
    """In-process fleet: one server per member over a ShardMemberSource
    wrapping the cached slice engine."""
    os.makedirs(announce_dir, exist_ok=True)
    server_cls = AsyncScoringServer if frontend == "asyncio" else ScoringServer
    out = []
    for m in range(fleet_size):
        source = ShardMemberSource(lambda fs, version=None, _m=m: member_engine(_m, fs),
                                   member=m, fleet_size=fleet_size)
        source.commit(*source.stage(fleet_size))
        server = server_cls(ScoringService(source, max_batch=16), port=0).start()
        write_announce(announce_dir, {
            "member": m, "fleet_size": fleet_size, "epoch": epoch,
            "url": f"http://127.0.0.1:{server.port}", "version": source.engine.version,
            "ready": True, "pid": os.getpid(), "owned": {}})
        out.append((server, source))
    return out


def _router(published, announce_dir, **kw):
    opts = dict(member_timeout_s=5.0, cooldown_s=0.05, backoff_s=0.01)
    opts.update(kw)
    return FleetRouter(announce_dir, published["lookups"], task=published["task"],
                       link=published["link"], **opts)


def _post(url, body, timeout=5):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


# ---------------------------------------------------------------------------
# 1. ownership arithmetic and slices
# ---------------------------------------------------------------------------


def test_both_launchers_publish_the_same_model_files(published):
    assert _same_tree(published["version_dir"], published["j_version_dir"]) == []


def test_member_ranges_partition_and_invert():
    for fleet_size in (1, 2, 3, 4, 6, 12):
        ranges = [member_row_range(N_ENTITIES, m, fleet_size) for m in range(fleet_size)]
        covered = [c for lo, hi in ranges for c in range(lo, hi)]
        assert covered == list(range(N_ENTITIES))
        for m, (lo, hi) in enumerate(ranges):
            for code in (lo, hi - 1):
                assert owner_of_row(N_ENTITIES, code, fleet_size) == m


def test_indivisible_fleet_size_lists_valid_sizes():
    with pytest.raises(ElasticPlacementError) as exc:
        member_row_range(N_ENTITIES, 0, 5)
    msg = str(exc.value)
    assert "valid fleet sizes" in msg
    assert str(valid_fleet_sizes(N_ENTITIES)) in msg
    with pytest.raises(ValueError):
        member_row_range(N_ENTITIES, 3, 3)


@pytest.mark.parametrize("fleet_size", [3, 4])
def test_slice_matches_the_jax_slice(published, fleet_size):
    """Each member's cut (placement arrays, coefficients, projections,
    entity codes, bytes) is the JAX package's, array for array."""
    from photon_ml_tpu.data.model_store import load_game_model as j_load
    from photon_ml_tpu.serving import slice_model_for_member as j_slice
    from photon_ml_tpu.serving.shard import serving_table_bytes as j_bytes
    from photon_ml_tpu_torch.data.model_store import load_game_model

    model = load_game_model(published["version_dir"], device=CPU)
    j_model = j_load(published["version_dir"])
    for m in range(fleet_size):
        got = slice_model_for_member(model, m, fleet_size).models["perUser"]
        want = j_slice(j_model, m, fleet_size).models["perUser"]
        np.testing.assert_array_equal(got.entity_bucket, np.asarray(want.entity_bucket))
        np.testing.assert_array_equal(got.entity_pos, np.asarray(want.entity_pos))
        assert len(got.buckets) == len(want.buckets)
        for gb, wb in zip(got.buckets, want.buckets):
            np.testing.assert_array_equal(gb.coefficients.numpy(), np.asarray(wb.coefficients))
            np.testing.assert_array_equal(gb.projection.numpy(), np.asarray(wb.projection))
            np.testing.assert_array_equal(gb.entity_codes, np.asarray(wb.entity_codes))
        assert (serving_table_bytes(slice_model_for_member(model, m, fleet_size))
                == j_bytes(j_slice(j_model, m, fleet_size)))


def test_sliced_margins_fold_to_single_engine_scores(published, member_engine, full_engine):
    """Per-member margins (entity block + one FE designate) fold, plus the
    offset and the link, to the single engine's scores within 1e-6."""
    from photon_ml_tpu.serving import ScoringEngine as JEngine

    rows = _request_rows()
    ref = np.asarray(full_engine.score_rows(rows), np.float64)
    fleet_size = 3
    totals = np.zeros(len(rows), np.float64)
    for m in range(fleet_size):
        include_fixed = [owner_of_row(N_ENTITIES, i, fleet_size) == m for i in range(len(rows))]
        totals += np.asarray(member_engine(m, fleet_size).margin_rows(
            rows, include_fixed=include_fixed), np.float64)
    offsets = np.asarray([r.get("offset") or 0.0 for r in rows])
    folded = 1.0 / (1.0 + np.exp(-(totals + offsets)))
    np.testing.assert_allclose(folded, ref, atol=1e-6)
    j_ref = np.asarray(JEngine.load(published["version_dir"], max_batch=16).score_rows(rows))
    np.testing.assert_allclose(folded, j_ref, atol=1e-6)


def test_owned_ranges_and_slice_budget(published):
    from photon_ml_tpu_torch.data.model_store import load_game_model

    model = load_game_model(published["version_dir"], device=CPU)
    assert member_owned_ranges(model, 1, 3) == {"userId": (4, 8)}
    full_bytes = serving_table_bytes(model)
    slice_bytes = serving_table_bytes(slice_model_for_member(model, 0, 3))
    assert slice_bytes < full_bytes
    budget = (slice_bytes + full_bytes) // 2
    engine = load_member_engine(published["version_dir"], 0, 3, max_batch=16,
                                hbm_budget_bytes=budget, warm=False, device=CPU)
    assert engine.version == os.path.basename(published["version_dir"])
    assert engine.model_bytes == slice_bytes
    with pytest.raises(ShardBudgetError) as exc:
        load_member_engine(published["version_dir"], 0, 3, max_batch=16, hbm_budget_bytes=16,
                           warm=False, device=CPU)
    assert "grow the fleet" in str(exc.value)
    # the sizes named are those whose every member's slice fits
    with pytest.raises(ShardBudgetError, match=r"fleet sizes whose slices fit: \[2, 3, 4, 6, 12\]"):
        load_member_engine(published["version_dir"], 0, 1, max_batch=16,
                           hbm_budget_bytes=budget, warm=False, device=CPU)


def test_member_source_stage_commit_resolve(published, member_engine):
    calls = []

    def loader(fleet_size, version=None):
        calls.append((fleet_size, version))
        return member_engine(0, fleet_size)

    src = ShardMemberSource(loader, member=0, fleet_size=3)
    with pytest.raises(RuntimeError):
        _ = src.engine
    with pytest.raises(KeyError):
        src.commit(3, "v-never-staged")
    src.commit(*src.stage(3))
    version = src.engine.version
    assert src.fleet_size == 3
    src.stage(3, version)  # idempotent per key: no second load
    assert calls == [(3, None)]
    src.commit(*src.stage(6))
    assert src.fleet_size == 6
    assert src.resolve(3, version) is member_engine(0, 3)
    assert src.resolve(6, version) is member_engine(0, 6)
    assert src.resolve() is member_engine(0, 6)
    with pytest.raises(KeyError) as exc:
        src.resolve(6, "v-unknown")
    assert "staged" in str(exc.value)
    src.commit(*src.stage(2))  # keeps (2, v) and its previous (6, v); drops (3, v)
    assert src.staged_keys() == [(2, version), (6, version)]


# ---------------------------------------------------------------------------
# 2. the router: parity, version pins, degraded mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frontend", ["threading", "asyncio"])
def test_router_matches_single_engine_and_pins_versions(published, member_engine,
                                                        full_engine, tmp_path, frontend):
    members = _start_fleet(member_engine, str(tmp_path / "announce"), frontend=frontend)
    router = _router(published, str(tmp_path / "announce"))
    try:
        router.refresh()
        assert router.view.fleet_size == 3
        rows = _request_rows()
        ref = np.asarray(full_engine.score_rows(rows))
        got = np.asarray(router.score_rows(rows))
        np.testing.assert_allclose(got, ref, atol=1e-6)
        # the same rows against the same view fold in the same order
        np.testing.assert_array_equal(np.asarray(router.score_rows(rows)), got)
        url = router.view.endpoints[0] + "/v1/margins"
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(url, {"rows": rows[:2], "fleet_size": 3, "version": "v-bogus"})
        assert exc.value.code == 409
        assert json.loads(exc.value.read())["error"] == "version_unavailable"
        pinned = _post(url, {"rows": rows[:2], "fleet_size": 3, "version": router.version})
        assert len(pinned["margins"]) == 2
    finally:
        router.close()
        for server, _src in members:
            server.stop()


def test_port_router_matches_the_jax_router(published, member_engine, tmp_path):
    """The port's fleet (members and router) and the JAX package's fleet over
    the same published model score the same rows within 1e-6."""
    from photon_ml_tpu.serving import FleetRouter as JRouter
    from photon_ml_tpu.serving import ScoringServer as JServer
    from photon_ml_tpu.serving import ScoringService as JService
    from photon_ml_tpu.serving import ShardMemberSource as JSource
    from photon_ml_tpu.serving import fleet_lookups_from_version_dir as j_lookups
    from photon_ml_tpu.serving import load_member_engine as j_load_member
    from photon_ml_tpu.serving import write_announce as j_announce

    vdir = published["version_dir"]
    assert j_lookups(vdir) == fleet_lookups_from_version_dir(vdir)
    members = _start_fleet(member_engine, str(tmp_path / "port"), fleet_size=2)
    j_dir = str(tmp_path / "jax")
    j_servers = []
    for m in range(2):
        engine = j_load_member(vdir, m, 2, max_batch=16)
        src = JSource(lambda fs, version=None, _e=engine: _e, member=m, fleet_size=2)
        src.commit(*src.stage(2))
        server = JServer(JService(src, max_batch=16), port=0).start()
        j_servers.append(server)
        j_announce(j_dir, {"member": m, "fleet_size": 2, "epoch": 0,
                           "url": f"http://127.0.0.1:{server.port}", "version": engine.version,
                           "ready": True})
    router = _router(published, str(tmp_path / "port"))
    task, link, lookups = j_lookups(vdir)
    j_router = JRouter(j_dir, lookups, task=task, link=link, member_timeout_s=5.0)
    try:
        rows = _request_rows() + _fe_only(_request_rows(3))
        rows.append({"features": {"global": [[3, 2.0]]}, "ids": {"userId": "unseen"},
                     "offset": -0.5})
        got = np.asarray(router.score_rows(rows), np.float64)
        want = np.asarray(j_router.score_rows(rows), np.float64)
        np.testing.assert_allclose(got, want, atol=1e-6)
    finally:
        router.close()
        j_router.close()
        for server, _src in members:
            server.stop()
        for server in j_servers:
            server.stop()


def test_degraded_mode_sheds_exactly_the_lost_entities(published, member_engine, full_engine,
                                                      tmp_path):
    """Member 1's endpoint stopped: the rows whose entity it owns degrade to
    FE-only (exactly 4 of 12 counted), every other row keeps parity, and
    no request fails."""
    members = _start_fleet(member_engine, str(tmp_path / "announce"))
    router = _router(published, str(tmp_path / "announce"), member_timeout_s=2.0,
                     cooldown_s=30.0)
    try:
        router.refresh()
        rows = _request_rows()
        ref = np.asarray(full_engine.score_rows(rows))
        fe_only = np.asarray(full_engine.score_rows(_fe_only(rows)))
        members[1][0].stop()  # member 1 owns codes [4, 8)
        degraded0 = telemetry.counter("serving.degraded_scores").value
        failures0 = telemetry.counter("serving.member_failures").value
        got = np.asarray(router.score_rows(rows))
        lost = [i for i in range(len(rows)) if owner_of_row(N_ENTITIES, i, 3) == 1]
        kept = [i for i in range(len(rows)) if i not in lost]
        assert lost == [4, 5, 6, 7]
        assert telemetry.counter("serving.degraded_scores").value - degraded0 == len(lost)
        assert telemetry.counter("serving.member_failures").value > failures0
        np.testing.assert_allclose(got[kept], ref[kept], atol=1e-6)
        np.testing.assert_allclose(got[lost], fe_only[lost], atol=1e-6)
        assert router.members_status()[1]["cooling_down"]
        # rows without ids whose FE designate was member 1 are retried
        # elsewhere, exactly, and shed nothing
        degraded1 = telemetry.counter("serving.degraded_scores").value
        plain = _fe_only(_request_rows(3))
        np.testing.assert_allclose(np.asarray(router.score_rows(plain)),
                                   np.asarray(full_engine.score_rows(plain)), atol=1e-6)
        assert telemetry.counter("serving.degraded_scores").value == degraded1
    finally:
        router.close()
        for server, _src in members:
            server.stop()


def test_a_failure_through_a_superseded_view_cools_down_only_its_endpoint(
        published, member_engine, full_engine, tmp_path):
    """A call planned before member 1 was relaunched fails on the dead
    process's port after the router adopted the new one: its cooldown holds
    the old endpoint, so the next call reaches the new process and sheds
    nothing."""
    import socket

    from photon_ml_tpu_torch.serving.router import FleetView, _MemberUnavailable

    members = _start_fleet(member_engine, str(tmp_path / "announce"))
    router = _router(published, str(tmp_path / "announce"), cooldown_s=60.0)
    try:
        view = router.refresh()
        with socket.socket() as sock:  # a port nothing listens on
            sock.bind(("127.0.0.1", 0))
            dead = f"http://127.0.0.1:{sock.getsockname()[1]}"
        stale = FleetView(epoch=view.epoch, fleet_size=view.fleet_size, version=view.version,
                          endpoints=(view.endpoints[0], dead, view.endpoints[2]))
        rows = _request_rows()
        with pytest.raises(_MemberUnavailable):
            router._call_member(stale, 1, rows[4:5], [True])
        degraded0 = telemetry.counter("serving.degraded_scores").value
        np.testing.assert_allclose(np.asarray(router.score_rows(rows)),
                                   np.asarray(full_engine.score_rows(rows)), atol=1e-6)
        assert telemetry.counter("serving.degraded_scores").value == degraded0
        assert not router.members_status()[1]["cooling_down"]
    finally:
        router.close()
        for server, _src in members:
            server.stop()


def test_live_resize_adopts_new_epoch_and_keeps_parity(published, member_engine, full_engine,
                                                      tmp_path):
    """A 3 -> 2 resize through the announce files: the router keeps the old
    view until the new epoch is complete, then swaps once
    (``serving.resize_swaps``) and stays on parity at the new size."""
    announce = str(tmp_path / "announce")
    gen0 = _start_fleet(member_engine, announce, fleet_size=3)
    router = _router(published, announce)
    gen1 = []
    try:
        router.refresh()
        rows = _request_rows()
        ref = np.asarray(full_engine.score_rows(rows))
        assert router.view.fleet_size == 3
        swaps0 = telemetry.counter("serving.resize_swaps").value
        write_announce(announce, {"member": 0, "fleet_size": 2, "epoch": 1,
                                  "url": "http://127.0.0.1:1", "version": "x", "ready": True})
        router.refresh()
        assert router.view.epoch == 0  # an incomplete epoch does not swap
        gen1 = _start_fleet(member_engine, announce, fleet_size=2, epoch=1)
        router.refresh()
        assert (router.view.epoch, router.view.fleet_size) == (1, 2)
        assert telemetry.counter("serving.resize_swaps").value == swaps0 + 1
        np.testing.assert_allclose(np.asarray(router.score_rows(rows)), ref, atol=1e-6)
    finally:
        router.close()
        for server, _src in gen0 + gen1:
            server.stop()


def test_stage_and_commit_over_http_reannounce_and_400_elsewhere(published, member_engine,
                                                                full_engine, tmp_path):
    """``/v1/admin/stage`` then ``/commit`` on a member: the resize slice
    serves, the hook sees the new key and epoch, and a commit without a
    version or of an unstaged key fails; a plain engine's server answers
    400 to both."""
    source = ShardMemberSource(lambda fs, version=None: member_engine(0, fs), member=0,
                               fleet_size=3)
    source.commit(*source.stage(3))
    service = ScoringService(source, max_batch=16)
    seen = []
    service.on_commit = lambda key, payload: seen.append((key, payload.get("epoch")))
    server = ScoringServer(service, port=0).start()
    plain = ScoringServer(ScoringService(full_engine, max_batch=16), port=0).start()
    try:
        base = f"http://127.0.0.1:{server.port}/v1/admin/"
        version = source.engine.version
        staged = _post(base + "stage", {"fleet_size": 6})
        assert staged == {"staged": {"fleet_size": 6, "version": version}}
        assert source.fleet_size == 3 and not seen
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "commit", {"fleet_size": 6})
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "commit", {"fleet_size": 4, "version": version})
        assert exc.value.code == 409  # the unstaged key is a KeyError
        committed = _post(base + "commit", {"fleet_size": 6, "version": version, "epoch": 1})
        assert committed == {"committed": {"fleet_size": 6, "version": version}}
        assert source.fleet_size == 6 and seen == [((6, version), 1)]
        rows = _request_rows()
        want = member_engine(0, 6).margin_rows(rows)
        got = _post(f"http://127.0.0.1:{server.port}/v1/margins", {"rows": rows})["margins"]
        np.testing.assert_array_equal(np.asarray(got, np.float32), want)
        for op in ("stage", "commit"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(f"http://127.0.0.1:{plain.port}/v1/admin/{op}",
                      {"fleet_size": 2, "version": version})
            assert exc.value.code == 400
    finally:
        server.stop()
        plain.stop()


def test_scan_announce_skips_torn_files(tmp_path):
    write_announce(str(tmp_path), {"member": 0, "fleet_size": 1, "epoch": 0, "url": "http://x",
                                   "ready": True})
    (tmp_path / "member-1.json").write_text('{"member": 1, "fle')
    assert [r["member"] for r in scan_announce(str(tmp_path))] == [0]


# ---------------------------------------------------------------------------
# 3. two random effects keyed by one id; a slice from a streamed checkpoint
# ---------------------------------------------------------------------------


def _two_coordinate_model(n_users=8, seed=3):
    """FE ``global`` (6 features) + a per-user effect over ``global`` (K 2 or
    3, two buckets; user 5 has no model) + a per-user effect over ``user``
    (2 features, one bucket): two coordinates keyed by ``userId``."""
    from photon_ml_tpu_torch.game.models import (
        FixedEffectModel,
        GameModel,
        RandomEffectBucketModel,
        RandomEffectModel,
    )

    rng = np.random.default_rng(seed)
    fe = FixedEffectModel(coefficients=torch.from_numpy(rng.normal(size=6).astype(np.float32)),
                          shard_name="global")
    eb = np.array([0, 1, 0, 1, 0, -1, 1, 0], np.int64)
    ep = np.zeros(n_users, np.int64)
    buckets = []
    for b, k in ((0, 2), (1, 3)):
        codes = np.nonzero(eb == b)[0]
        ep[codes] = np.arange(len(codes))
        proj = np.stack([np.sort(rng.choice(6, size=k, replace=False)) for _ in codes])
        buckets.append(RandomEffectBucketModel(
            coefficients=torch.from_numpy(rng.normal(size=(len(codes), k)).astype(np.float32)),
            projection=torch.from_numpy(proj.astype(np.int64)),
            entity_codes=codes.astype(np.int32)))
    items = RandomEffectModel(id_name="userId", shard_name="global", buckets=tuple(buckets),
                              entity_bucket=eb, entity_pos=ep, vocab=np.arange(n_users))
    per_user = RandomEffectModel(
        id_name="userId", shard_name="user",
        buckets=(RandomEffectBucketModel(
            coefficients=torch.from_numpy(rng.normal(size=(n_users, 2)).astype(np.float32)),
            projection=torch.from_numpy(np.tile(np.arange(2), (n_users, 1))),
            entity_codes=np.arange(n_users, dtype=np.int32)),),
        entity_bucket=np.zeros(n_users, np.int64), entity_pos=np.arange(n_users),
        vocab=np.arange(n_users))
    model = GameModel(task="logistic", models={"fixed": fe, "perUserItems": items,
                                               "perUser": per_user})
    return model, {"global": [f"g{j}" for j in range(6)], "user": ["u0", "u1"]}


def test_two_random_effects_keyed_by_one_id(tmp_path):
    """A user's two coordinates live on one member: a non-owned user adds
    exactly 0 from both, the router folds each row from one owner plus the
    FE designate, and the scores match the single engine and the JAX
    router's."""
    from photon_ml_tpu.serving import FleetRouter as JRouter

    model, maps = _two_coordinate_model()
    vdir = publish_version(str(tmp_path / "registry"), model, maps)
    task, link, lookups = fleet_lookups_from_version_dir(vdir)
    assert list(lookups) == ["userId"]
    rows = [{"features": {"global": [[j, 0.3 * (j + 1) - i * 0.1] for j in range(6)],
                          "user": [[0, 1.0], [1, -0.5 + i]]},
             "ids": {"userId": str(i)}, "offset": 0.05 * i} for i in range(8)]
    full = ScoringEngine.load(vdir, max_batch=16, device=CPU)
    engines = {m: load_member_engine(vdir, m, 4, max_batch=16, device=CPU) for m in range(4)}
    for m, engine in engines.items():
        margins = engine.margin_rows(rows, include_fixed=[False] * len(rows))
        for i in range(len(rows)):
            if owner_of_row(8, i, 4) != m:
                assert margins[i] == 0.0  # bucket -1 in both coordinates
    announce = str(tmp_path / "announce")
    servers = []
    try:
        for m, engine in engines.items():
            src = ShardMemberSource(lambda fs, version=None, _e=engine: _e, member=m,
                                    fleet_size=4)
            src.commit(*src.stage(4))
            server = ScoringServer(ScoringService(src, max_batch=16), port=0).start()
            servers.append(server)
            write_announce(announce, {"member": m, "fleet_size": 4, "epoch": 0,
                                      "url": f"http://127.0.0.1:{server.port}",
                                      "version": engine.version, "ready": True})
        router = FleetRouter(announce, lookups, task=task, link=link)
        j_router = JRouter(announce, lookups, task=task, link=link)
        try:
            got = np.asarray(router.score_rows(rows))
            np.testing.assert_allclose(got, full.score_rows(rows), atol=1e-6)
            np.testing.assert_allclose(got, j_router.score_rows(rows), atol=1e-6)
            assert telemetry.counter("serving.routed_rows").value == len(rows)
        finally:
            router.close()
            j_router.close()
    finally:
        for server in servers:
            server.stop()


def test_member_slice_restores_from_a_streamed_checkpoint(tmp_path):
    """``re_checkpoints`` gives a member its rows off a streamed checkpoint
    written as 4 shard files (a 3-member block spans two of them), equal to
    the whole-table restore's and the JAX member's."""
    from photon_ml_tpu.serving import load_member_engine as j_load_member
    from photon_ml_tpu_torch.game.checkpoint import (
        CheckpointSpec,
        StreamCheckpointState,
        StreamingCheckpointManager,
    )
    from photon_ml_tpu_torch.parallel import make_mesh, place_entities

    vdir = serving_fleet.make_serving_model(str(tmp_path / "registry"), n_entities=N_ENTITIES,
                                            n_buckets=1)
    table = torch.from_numpy(np.random.default_rng(7).normal(size=(N_ENTITIES, 3))
                             .astype(np.float32))
    mesh = make_mesh({"model": 4}, [torch.device(CPU)] * 4)
    ckpt = str(tmp_path / "ckpt")
    StreamingCheckpointManager(CheckpointSpec(directory=ckpt)).save(
        StreamCheckpointState(next_chunk=1, coefficients=place_entities(table, mesh)))
    reader = StreamingCheckpointManager.open_for_restore(ckpt)
    np.testing.assert_array_equal(reader.restore_row_range(2, 7), table.numpy()[2:7])
    with pytest.raises(Exception, match="member row range"):
        reader.restore_row_range(8, 13)
    rows = _request_rows()
    full = ScoringEngine.load(vdir, max_batch=16, device=CPU, re_checkpoints={"perUser": ckpt})
    ref = np.asarray(full.score_rows(rows), np.float64)
    totals = np.zeros(len(rows))
    for m in range(3):
        include_fixed = [owner_of_row(N_ENTITIES, i, 3) == m for i in range(len(rows))]
        engine = load_member_engine(vdir, m, 3, max_batch=16, device=CPU,
                                    re_checkpoints={"perUser": ckpt})
        lo, hi = member_row_range(N_ENTITIES, m, 3)
        np.testing.assert_array_equal(engine.re_tables(0)[0][1].numpy(), table.numpy()[lo:hi])
        j_engine = j_load_member(vdir, m, 3, max_batch=16, re_checkpoints={"perUser": ckpt})
        got = engine.margin_rows(rows, include_fixed=include_fixed)
        np.testing.assert_allclose(got, j_engine.margin_rows(rows, include_fixed=include_fixed),
                                   atol=1e-6)
        totals += got
    offsets = np.asarray([r["offset"] for r in rows])
    np.testing.assert_allclose(1.0 / (1.0 + np.exp(-(totals + offsets))), ref, atol=1e-6)


# ---------------------------------------------------------------------------
# 4. the serving seams, heartbeats and drain
# ---------------------------------------------------------------------------


def test_member_load_seam_fails_the_load_then_retries_clean(published):
    faults.install_plan(faults.FaultPlan([
        faults.FaultRule("serving.member_load", action="io", nth=1)]))
    with pytest.raises(OSError):
        load_member_engine(published["version_dir"], 0, 3, max_batch=16, warm=False, device=CPU)
    faults.clear_plan()
    engine = load_member_engine(published["version_dir"], 0, 3, max_batch=16, warm=False,
                                device=CPU)
    assert engine.version == os.path.basename(published["version_dir"])


def test_route_fanout_seam_degrades_never_fails(published, member_engine, full_engine, tmp_path):
    members = _start_fleet(member_engine, str(tmp_path / "announce"), fleet_size=2)
    router = _router(published, str(tmp_path / "announce"))
    try:
        router.refresh()
        rows = _request_rows()
        degraded0 = telemetry.counter("serving.degraded_scores").value
        faults.install_plan(faults.FaultPlan([
            faults.FaultRule("serving.route_fanout", action="io", nth=1)]))
        got = router.score_rows(rows)
        faults.clear_plan()
        assert len(got) == len(rows)
        assert telemetry.counter("serving.degraded_scores").value > degraded0
        time.sleep(0.1)  # the cooldown lapses; the seam is spent
        np.testing.assert_allclose(np.asarray(router.score_rows(rows)),
                                   np.asarray(full_engine.score_rows(rows)), atol=1e-6)
    finally:
        router.close()
        for server, _src in members:
            server.stop()


def test_resize_swap_seam_preserves_the_old_view(published, member_engine, tmp_path):
    announce = str(tmp_path / "announce")
    members = _start_fleet(member_engine, announce, fleet_size=2)
    router = _router(published, announce)
    try:
        router.refresh()
        rows = _request_rows()
        ref = np.asarray(router.score_rows(rows))
        for m, (server, source) in enumerate(members):
            write_announce(announce, {"member": m, "fleet_size": 2, "epoch": 1,
                                      "url": f"http://127.0.0.1:{server.port}",
                                      "version": source.engine.version, "ready": True})
        fails0 = telemetry.counter("serving.resize_swap_failures").value
        faults.install_plan(faults.FaultPlan([
            faults.FaultRule("serving.resize_swap", action="raise", nth=1)]))
        router.refresh()
        faults.clear_plan()
        assert router.view.epoch == 0
        assert telemetry.counter("serving.resize_swap_failures").value == fails0 + 1
        np.testing.assert_allclose(np.asarray(router.score_rows(rows)), ref, atol=1e-6)
        router.refresh()
        assert router.view.epoch == 1
    finally:
        router.close()
        for server, _src in members:
            server.stop()


def test_heartbeat_files_and_dead_peers(tmp_path):
    from photon_ml_tpu.parallel import multihost as j_multihost
    from photon_ml_tpu_torch.parallel import multihost

    writer = multihost.HeartbeatWriter(str(tmp_path), 0, interval_s=0.05).start()
    try:
        multihost.HeartbeatWriter(str(tmp_path), 1).beat()
        assert multihost.heartbeat_path(str(tmp_path), 1) == j_multihost.heartbeat_path(
            str(tmp_path), 1)
        old = time.time() - 10.0
        os.utime(multihost.heartbeat_path(str(tmp_path), 1), (old, old))
        time.sleep(0.2)
        # member 2 never beat: absent, not dead
        assert multihost.dead_peers(str(tmp_path), 3, deadline_s=5.0) == [1]
        assert j_multihost.dead_peers(str(tmp_path), 3, deadline_s=5.0) == [1]
    finally:
        writer.stop()
    with pytest.raises(ValueError):
        multihost.HeartbeatWriter(str(tmp_path), 0, interval_s=0)
    # the rest of the module is ported: in one process initialize joins
    # nothing, fleet_any is the flag and gather_to_host the array
    # (tests/test_torch_multihost.py holds the fleet's cases)
    multihost.initialize(multihost.DistributedConfig())
    assert multihost.process_count() == 1 and multihost.backend() is None
    assert multihost.fleet_any(True) and not multihost.fleet_any(False)
    np.testing.assert_array_equal(multihost.gather_to_host(torch.arange(3)), [0, 1, 2])
    mesh = multihost.global_mesh({"entity": 2}, [torch.device("cpu")] * 2)
    assert multihost.process_slice(8, mesh, "entity") == (0, 8)


def test_drain_rejects_new_work_with_retry_after(member_engine):
    source = ShardMemberSource(lambda fs, version=None: member_engine(0, fs), member=0,
                               fleet_size=3)
    source.commit(*source.stage(3))
    service = ScoringService(source, max_batch=16)
    server = ScoringServer(service, port=0).start()
    try:
        service.drain()
        assert service.draining
        with pytest.raises(Draining):
            service.margin_request({"rows": _request_rows(2)})
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"http://127.0.0.1:{server.port}/v1/score", {"rows": _request_rows(2)})
        assert exc.value.code == 503
        assert exc.value.headers.get("Retry-After") == "2"
        service.drain()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# 5. a real 3-process fleet
# ---------------------------------------------------------------------------


def _launch_router(announce_dir: str, registry_dir: str, workdir: str) -> tuple:
    """A ``cli serve --router`` process over the newest version under
    ``registry_dir``; returns (proc, stdout path)."""
    out_path = os.path.join(workdir, "router.out")
    env = dict(os.environ)
    env["PYTHONPATH"] = serving_fleet._repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    with open(out_path, "wb") as out, open(os.path.join(workdir, "router.err"), "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "photon_ml_tpu_torch.cli", "serve", "--router",
             "--registry-dir", registry_dir, "--announce-dir", announce_dir,
             "--host", "127.0.0.1", "--port", "0", "--max-batch", "16",
             "--member-timeout-s", "3.0"],
            env=env, cwd=serving_fleet._repo_root(), stdout=out, stderr=err)
    return proc, out_path


def _wait_for_banner(proc, out_path: str, timeout_s: float) -> dict:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        banner = serving_fleet._json_line(out_path, "serving")
        if banner is not None:
            return banner
        assert proc.poll() is None, f"the router exited {proc.returncode} before serving"
        time.sleep(0.1)
    raise AssertionError("the router printed no banner")


@pytest.mark.chaos_serving
def test_three_process_fleet_parity_budget_kill_drain(published, full_engine, tmp_path):
    """Three ``cli serve --member --device cpu`` processes under a per-member
    budget the FULL model exceeds: (a) a member of a 1-member fleet is
    refused (ShardBudgetError), (b) the router matches the single engine
    within 1e-6, in process and as a ``cli serve --router`` process over
    ``/v1/score``, (c) a SIGKILLed member sheds exactly its rows with no
    failed request, (d) every survivor and the router drain to exit 75, and
    (e) the request traces: every routed call sampled, one trace joins the
    router's stream and at least two members', each member hop with its
    phases, version and fleet size; the survivors' drain dumps and the
    killed member's harvested last words in ``cli report --fleet``."""
    from photon_ml_tpu.telemetry.fleet_report import FleetReport as JFleetReport
    from photon_ml_tpu_torch.cli.report import main as report_main
    from photon_ml_tpu_torch.data.model_store import load_game_model
    from photon_ml_tpu_torch.parallel.multihost import dead_peers
    from photon_ml_tpu_torch.telemetry import requests as rq
    from photon_ml_tpu_torch.telemetry.fleet_report import FleetReport

    model = load_game_model(published["version_dir"], device=CPU)
    full_bytes = serving_table_bytes(model)
    slice_bytes = serving_table_bytes(slice_model_for_member(model, 0, 3))
    spec = serving_fleet.ServingFleetSpec(
        workdir=str(tmp_path), model_dir=published["version_dir"], fleet_size=3, max_batch=16,
        device=CPU, hbm_budget_mb=((slice_bytes + full_bytes) / 2) / 2**20,
        heartbeat_deadline_s=2.0, warm_timeout_s=60.0)
    os.makedirs(spec.announce_dir(), exist_ok=True)
    os.makedirs(spec.fleet_dir(), exist_ok=True)
    tdir = spec.telemetry_dir()
    lone = serving_fleet._launch_serving_member(spec, 0, 1, 9)
    members = {m: serving_fleet._launch_serving_member(spec, m, 3, 0, telemetry_dir=tdir)
               for m in range(3)}
    router_proc, router_out = _launch_router(
        spec.announce_dir(), os.path.dirname(published["version_dir"]), str(tmp_path))
    router = None
    try:
        assert lone.proc.wait(timeout=60) != 0
        with open(lone.err_path) as fh:
            assert "ShardBudgetError" in fh.read()
        serving_fleet._wait_for_epoch(spec, 0, 3, time.monotonic() + spec.warm_timeout_s,
                                      members)
        assert all(m.startup_s is not None for m in members.values())
        # the router's span stream, every call sampled: the members see
        # X-Photon-Trace ...;s=1 and persist their half of each trace
        telemetry.configure(trace_out=os.path.join(tdir, "trace.router.jsonl"))
        router = _router(published, spec.announce_dir(), member_timeout_s=3.0, cooldown_s=0.2,
                         backoff_s=0.02, sample_every=1)
        router.refresh()
        rows = _request_rows()
        ref = np.asarray(full_engine.score_rows(rows))
        np.testing.assert_allclose(np.asarray(router.score_rows(rows)), ref, atol=1e-6)
        banner = _wait_for_banner(router_proc, router_out, spec.warm_timeout_s)
        assert banner["router"] is True
        answer = _post(f"http://127.0.0.1:{banner['port']}/v1/score", {"rows": rows}, timeout=30)
        assert answer["model_version"] == os.path.basename(published["version_dir"])
        np.testing.assert_allclose(np.asarray(answer["scores"]), ref, atol=1e-6)
        router_proc.send_signal(signal.SIGTERM)
        assert router_proc.wait(timeout=30) == 75
        members[1].proc.kill()
        members[1].proc.wait()
        degraded0 = telemetry.counter("serving.degraded_scores").value
        got = np.asarray(router.score_rows(rows))
        lost = [i for i in range(N_ENTITIES) if owner_of_row(N_ENTITIES, i, 3) == 1]
        assert telemetry.counter("serving.degraded_scores").value - degraded0 == len(lost)
        fe_only = np.asarray(full_engine.score_rows(_fe_only(rows)))
        np.testing.assert_allclose(got[lost], fe_only[lost], atol=1e-6)
        deadline = time.monotonic() + 30
        while 1 not in dead_peers(spec.fleet_dir(), 3, spec.heartbeat_deadline_s):
            assert time.monotonic() < deadline, "the killed member's heartbeat never went stale"
            time.sleep(0.1)
        # member 1 never ran its drain dump: its last words come from the
        # tail of its span stream
        assert rq.harvest_flight(os.path.join(tdir, "trace.proc-1.jsonl"),
                                 rq.flight_path(tdir, 1))
        for m in (0, 2):
            members[m].proc.send_signal(signal.SIGTERM)
        assert members[0].proc.wait(timeout=30) == 75
        assert members[2].proc.wait(timeout=30) == 75
        telemetry.trace.TRACER.close_sink()
        for m in (0, 2):  # the drain-path dumps
            doc = rq.read_flight(rq.flight_path(tdir, m))
            assert doc is not None and not doc.get("harvested")
            assert doc["process_index"] == m and doc["records"]
        fr = FleetReport.load(str(tmp_path))
        assert fr.lost_members() == [1]
        traces = fr.request_traces()
        assert traces == JFleetReport.load(str(tmp_path)).request_traces()
        joined = [t for t in traces if "router" in t["sources"]
                  and sum(src.startswith("proc-") for src in t["sources"]) >= 2]
        assert joined, "no request trace spans the router and two members"
        for hop in joined[0]["hops"]:
            if hop["source"].startswith("proc-"):
                assert hop["phases"] and "version" in hop["attrs"], hop
                assert hop["attrs"]["fleet_size"] == 3
        assert fr.members[1].flight is not None and fr.members[1].flight["harvested"]
        out_md = str(tmp_path / "fleet-report.md")
        assert report_main(["--fleet", str(tmp_path), "--out", out_md]) == 0
        with open(out_md, encoding="utf-8") as fh:
            content = fh.read()
        assert "Last words — member 1" in content and "## Requests" in content
        for m in (0, 2):
            with open(members[m].out_path) as fh:
                lines = [json.loads(ln) for ln in fh if ln.startswith("{")]
            banner = lines[0]["serving"]
            assert (banner["member"], banner["fleet_size"], banner["epoch"],
                    banner["device"]) == (m, 3, 0, CPU)
            assert lines[-1]["drained"]["member"] == m
    finally:
        if router is not None:
            router.close()
        for proc in [lone.proc, router_proc, *(m.proc for m in members.values())]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.mark.chaos_serving
def test_run_serving_fleet_kill_relaunch_and_resize(published, full_engine, tmp_path):
    """``run_serving_fleet`` on the CPU: three members under traffic, member
    1 hard-killed, detected by heartbeat and relaunched in its slot, a live
    resize 3 -> 6 -> 3; no failed call, degraded rows only in the kill
    window, the probe rows within 1e-6 of the single engine at every
    settled view, epoch 2 at size 3, every member but the killed one
    draining to 75, and the fault plan armed in the victim's environment
    alone. The fleet directory keeps the killed process's stream with its
    harvested last words (the report shows member 1 lost), the relaunch
    writes beside it, and every 5th routed call's trace joins the router's
    stream and the members'."""
    from photon_ml_tpu_torch.telemetry import requests as rq
    from photon_ml_tpu_torch.telemetry.fleet_report import FleetReport

    rows = _request_rows()
    plan = {"rules": [{"point": "fleet.heartbeat", "action": "io", "nth": 3}]}
    spec = serving_fleet.ServingFleetSpec(
        workdir=str(tmp_path), model_dir=published["version_dir"], fleet_size=3, max_batch=16,
        device=CPU, heartbeat_deadline_s=2.0, warm_timeout_s=60.0, timeout_s=180.0,
        member_timeout_s=3.0, traffic_seconds=6.0, kill_member=1, kill_after_s=1.0,
        resizes=((3.0, 6), (5.0, 3)), victim_plan=plan, victim_member=2,
        check_rows=tuple(rows), trace_sample_every=5)
    report = serving_fleet.run_serving_fleet(spec)
    assert report["ok"] and report["failures"] == []
    assert (report["epoch"], report["fleet_size"]) == (2, 3)
    kill = report["kill"]
    assert kill["member"] == 1 and 0 < kill["detect_s"] <= kill["recovery_s"]
    t_rec = kill["t_kill"] + kill["recovery_s"]
    in_kill = sum(s[3] for s in report["samples"] if kill["t_kill"] <= s[0] <= t_rec)
    late = [s for s in report["samples"] if s[0] > t_rec and s[3]]
    rtt = {name: h.get("max") for name, h in telemetry.snapshot().get("histograms", {}).items()
           if name.startswith("serving.fanout_rtt_ms")}
    assert in_kill > 0 and not late, (kill, late, report["events"], rtt)
    assert [(ev["resize"]["from"], ev["resize"]["to"]) for ev in report["events"]
            if "resize" in ev] == [(3, 6), (6, 3)]
    ref = np.asarray(full_engine.score_rows(rows))
    assert [(c["at"], c["fleet_size"]) for c in report["checks"]] == [
        ("start", 3), ("relaunch", 3), ("resize 3->6", 6), ("resize 6->3", 3)]
    for c in report["checks"]:
        np.testing.assert_allclose(np.asarray(c["scores"]), ref, atol=1e-6)
    assert sorted((m["member"], m["epoch"]) for m in report["members"]) == [
        (0, 0), (1, 0), (1, 0), (2, 0), (3, 1), (4, 1), (5, 1)]
    for m in report["members"]:
        assert m["rc"] == (-signal.SIGKILL if m["killed"] else 75), m
        assert m["banner"]["device"] == CPU
        assert m["killed"] or m["drained"]["device"] == CPU
    assert sum(m["killed"] for m in report["members"]) == 1
    armed = sorted(name for name in os.listdir(tmp_path) if name.endswith(".err")
                   and "FAULT INJECTION ARMED" in (tmp_path / name).read_text())
    assert armed == ["member2-e0-0.err"]
    tdir = report["telemetry_dir"]
    assert tdir == spec.telemetry_dir() and kill["flight_spans"] > 0
    fr = FleetReport.load(str(tmp_path))
    assert [m.process_index for m in fr.members] == list(range(6))
    assert fr.lost_members() == [1] and fr.members[1].flight["harvested"]
    assert "Last words — member 1" in fr.to_markdown()
    (relaunched,) = [m for m in report["members"] if m["member"] == 1 and not m["killed"]]
    assert relaunched["telemetry_dir"] == os.path.join(tdir, "relaunch-1")
    assert rq.read_flight(rq.flight_path(relaunched["telemetry_dir"], 1)) is not None
    assert any("router" in t["sources"] and any(src.startswith("proc-") for src in t["sources"])
               for t in fr.request_traces())


# ---------------------------------------------------------------------------
# the serving chaos matrix (photon_ml_tpu_torch.tools.chaos)
# ---------------------------------------------------------------------------


@pytest.mark.chaos_serving
def test_serving_chaos_tier1_slice(tmp_path):
    """The in-process seam rows of the serving chaos matrix: a slice load
    failing with an injected OSError and served on the retry, a fan-out
    failure shed to fixed-effect-only and back at parity, a failed
    ownership swap leaving the old view serving, a kill in the middle of a
    flight dump leaving nothing adoptable. The hard kill under traffic runs
    in the full matrix (slow)."""
    import warnings

    from photon_ml_tpu_torch.tools import chaos

    budget = float(os.environ.get("PHOTON_CHAOS_BUDGET_S", "300"))
    report = chaos.run_serving_matrix(
        str(tmp_path), rows=["member_load_io", "route_fanout_io", "resize_swap",
                             "flight_dump_kill"], budget_s=budget, device="cpu")
    if report["skipped"]:
        warnings.warn("chaos budget truncated the serving matrix; uncovered this run: "
                      f"{report['skipped']}", stacklevel=1)
        return
    assert report["ok"], json.dumps(report, indent=2, default=str)
    assert sorted(report["results"]) == ["flight_dump_kill", "member_load_io", "resize_swap",
                                         "route_fanout_io"]
    assert report["results"]["route_fanout_io"]["degraded_scores"] > 0
    assert report["results"]["resize_swap"]["swap_failures"] == 1
    assert report["results"]["flight_dump_kill"]["armed_rc"] == 113
    assert report["results"]["flight_dump_kill"]["adopted_after_kill"] == []


@pytest.mark.slow
@pytest.mark.chaos_serving
def test_serving_chaos_full_matrix(tmp_path):
    """Every serving chaos row the port runs, the 3-process hard kill under
    traffic included."""
    from photon_ml_tpu_torch.tools import chaos

    report = chaos.run_serving_matrix(str(tmp_path), device="cpu")
    assert not report["skipped"]
    assert report["ok"], json.dumps(report, indent=2, default=str)
    kill = report["results"]["member_hard_kill"]
    assert kill["failures"] == 0
    assert kill["degraded_scores"] > 0
    assert kill["kill"]["recovery_s"] <= chaos.KILL_RECOVERY_BUDGET_S
