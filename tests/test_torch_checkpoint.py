"""The port's checkpoints (``photon_ml_tpu_torch.game.checkpoint``) and the
coordinate-descent loop's checkpoint and stop, against the JAX package's, on
the CPU (after ``tests/test_checkpoint.py:96-208`` and ``:267-419``).

The toy coordinates do no optimizer work: every update adds 1 to both
coefficients, so the checkpoint machinery is held exactly. A real GAME fit
interrupted and resumed reproduces the uninterrupted one bit for bit within
the port (the reference holds its own to rtol 1e-6, atol 1e-7), and a fit
resumed by the port from a checkpoint the JAX package wrote ends within
tests/test_torch_game.py's fit tolerance (rtol 1e-3, atol 1e-3) of the JAX
package's uninterrupted fit. A checkpoint written by either package restores
in the other, exactly.
"""

import dataclasses
import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game import CheckpointManager as JManager
from photon_ml_tpu.game import CheckpointSpec as JSpec
from photon_ml_tpu.game import FixedEffectConfig as JFEConfig
from photon_ml_tpu.game import FixedEffectModel as JFixedModel
from photon_ml_tpu.game import GameConfig as JGameConfig
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JREConfig
from photon_ml_tpu.game import TrainingInterrupted as JInterrupted
from photon_ml_tpu.game import build_game_dataset as j_build
from photon_ml_tpu.game import run_coordinate_descent as j_run
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.game import (
    CheckpointError,
    CheckpointManager,
    CheckpointSpec,
    FeatureShard,
    FixedEffectConfig,
    FixedEffectModel,
    GameConfig,
    GameEstimator,
    GracefulStop,
    RandomEffectConfig,
    TrainingInterrupted,
    build_game_dataset,
    run_coordinate_descent,
)
from photon_ml_tpu_torch.game import checkpoint as t_checkpoint
from photon_ml_tpu_torch.optim.guard import GuardSpec


class _Toy:
    """Every update adds 1 to both coefficients; ``mode="nan"`` always
    diverges."""

    def __init__(self, mode="ok", n_rows=6):
        self.mode, self.n_rows, self.updates, self.extra_l2 = mode, n_rows, 0, 0.0

    def initialize_model(self):
        return FixedEffectModel(coefficients=torch.zeros(2), shard_name="f")

    def update_model(self, model, residual_scores):
        self.updates += 1
        if self.mode == "nan":
            return dataclasses.replace(model, coefficients=torch.full((2,), float("nan")))
        return dataclasses.replace(model, coefficients=model.coefficients + 1.0)

    def score(self, model):
        return model.coefficients[0].expand(self.n_rows).clone()


class _JToy(_Toy):
    def initialize_model(self):
        return JFixedModel(coefficients=jnp.zeros((2,), jnp.float32), shard_name="f")

    def update_model(self, model, residual_scores):
        self.updates += 1
        return dataclasses.replace(model, coefficients=model.coefficients + 1.0)

    def score(self, model):
        return jnp.broadcast_to(model.coefficients[0], (self.n_rows,)).astype(jnp.float32)


def _run(coords, path=None, num_iterations=2, guard=None, should_stop=None, **spec_kw):
    manager = (None if path is None
               else CheckpointManager(CheckpointSpec(directory=str(path), **spec_kw),
                                      device="cpu"))
    return run_coordinate_descent(coords, task="logistic", num_iterations=num_iterations,
                                  guard=guard, checkpoint=manager, should_stop=should_stop)


def _coef(result, name):
    return result.model.models[name].coefficients.numpy()


def test_checkpoint_saves_per_step_and_resume_skips_completed(tmp_path):
    reference = _run({"a": _Toy(), "b": _Toy()})
    stops = iter([False, False, True, True, True])
    with pytest.raises(TrainingInterrupted) as ei:
        _run({"a": _Toy(), "b": _Toy()}, tmp_path, should_stop=lambda: next(stops))
    assert ei.value.step == 2
    assert ei.value.checkpoint_path == str(tmp_path / "step-00000002")
    assert sorted(os.listdir(tmp_path)) == ["step-00000000", "step-00000001",
                                            "step-00000002"]
    resumed = {"a": _Toy(), "b": _Toy()}
    result = _run(resumed, tmp_path)
    assert (resumed["a"].updates, resumed["b"].updates) == (0, 1)
    for name in ("a", "b"):
        np.testing.assert_array_equal(_coef(result, name), _coef(reference, name))
    assert len(result.history) == 4


def test_resume_false_clears_stale_checkpoints(tmp_path):
    _run({"a": _Toy()}, tmp_path, num_iterations=3, keep_last=10)
    fresh = {"a": _Toy()}
    _run(fresh, tmp_path, num_iterations=1, resume=False, keep_last=10)
    assert fresh["a"].updates == 1
    assert sorted(os.listdir(tmp_path)) == ["step-00000000"]


def test_frozen_coordinates_survive_resume(tmp_path):
    guard = GuardSpec(max_retries=1, freeze_after=1)
    coords = {"bad": _Toy("nan"), "ok": _Toy()}
    stops = iter([False, False, True, True])
    with pytest.raises(TrainingInterrupted):
        _run(coords, tmp_path, num_iterations=3, guard=guard, should_stop=lambda: next(stops))
    assert coords["bad"].updates == 2  # one attempt and one retry, then frozen
    resumed = {"bad": _Toy("nan"), "ok": _Toy()}
    result = _run(resumed, tmp_path, num_iterations=3, guard=guard)
    assert resumed["bad"].updates == 0
    np.testing.assert_array_equal(_coef(result, "ok"), [3.0, 3.0])
    # resuming without a guard trains every coordinate again
    again = {"bad": _Toy(), "ok": _Toy()}
    _run(again, tmp_path, num_iterations=4)
    assert again["bad"].updates == 1


def test_restore_falls_back_past_corrupt_checkpoints(tmp_path):
    telemetry.reset()
    _run({"a": _Toy()}, tmp_path, num_iterations=3, keep_last=10)
    spec = CheckpointSpec(directory=str(tmp_path), keep_last=10)
    npz = tmp_path / "step-00000002" / "model" / "fixed-effect" / "a" / "coefficients.npz"
    npz.write_bytes(npz.read_bytes()[:20])
    assert CheckpointManager(spec, device="cpu").restore().step == 1
    (tmp_path / "step-00000001" / "manifest.json").unlink()
    assert CheckpointManager(spec, device="cpu").restore().step == 0
    counters = telemetry.snapshot()["counters"]
    assert counters["checkpoint.corrupt"] >= 2 and counters["checkpoint.restores"] == 2
    (tmp_path / "step-00000000" / "manifest.json").write_text("{ not json")
    assert CheckpointManager(spec, device="cpu").restore() is None
    manifest = tmp_path / "step-00000000" / "manifest.json"
    manifest.write_text(json.dumps({"format_version": 99}))
    with pytest.raises(CheckpointError, match="format_version"):
        CheckpointManager(spec, device="cpu")._load(str(tmp_path / "step-00000000"))


def test_restore_rejects_mismatched_coordinates(tmp_path):
    _run({"a": _Toy()}, tmp_path, num_iterations=1)
    with pytest.raises(CheckpointError, match="coordinates"):
        _run({"other": _Toy()}, tmp_path, num_iterations=1)


def test_retention_keeps_last_k_and_cleans_tmp(tmp_path):
    (tmp_path / ".tmp-step-00000099").mkdir()
    _run({"a": _Toy()}, tmp_path, num_iterations=4, keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["step-00000002", "step-00000003"]


def test_checkpoint_every_n_steps(tmp_path):
    _run({"a": _Toy()}, tmp_path, num_iterations=4, every=2, keep_last=10)
    assert sorted(os.listdir(tmp_path)) == ["step-00000001", "step-00000003"]


def test_manifest_is_json_safe_and_names_step(tmp_path):
    _run({"a": _Toy()}, tmp_path, num_iterations=1)
    manifest = json.loads((tmp_path / "step-00000000" / "manifest.json").read_text())
    assert manifest["step"] == 0 and manifest["format_version"] == 1
    assert manifest["coordinate_order"] == ["a"]
    assert manifest["history"][0]["coordinate"] == "a"
    assert "results" not in manifest["history"][0]


@pytest.mark.parametrize("kw,match", [(dict(every=0), "every"), (dict(keep_last=0), "keep_last"),
                                      (dict(quorum_timeout_s=0), "quorum_timeout_s")])
def test_spec_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        CheckpointSpec(directory="x", **kw)
    with pytest.raises(ValueError, match=match):
        JSpec(directory="x", **kw)


def test_a_checkpoint_written_by_either_package_restores_in_the_other(tmp_path):
    j_run({"a": _JToy(), "b": _JToy()}, task="logistic", num_iterations=2,
          checkpoint=JManager(JSpec(directory=str(tmp_path / "j"))))
    state = CheckpointManager(CheckpointSpec(directory=str(tmp_path / "j")),
                              device="cpu").restore()
    assert state.step == 3 and list(state.model.models) == ["a", "b"]
    np.testing.assert_array_equal(state.model.models["b"].coefficients.numpy(), [2.0, 2.0])
    # the port resumes the JAX package's fit and goes on
    resumed = {"a": _Toy(), "b": _Toy()}
    result = _run(resumed, tmp_path / "j", num_iterations=3)
    assert (resumed["a"].updates, resumed["b"].updates) == (1, 1)
    np.testing.assert_array_equal(_coef(result, "a"), [3.0, 3.0])

    _run({"a": _Toy(), "b": _Toy()}, tmp_path / "t", num_iterations=2)
    jstate = JManager(JSpec(directory=str(tmp_path / "t"))).restore()
    assert jstate.step == 3 and jstate.best_model is None
    np.testing.assert_array_equal(np.asarray(jstate.model.models["a"].coefficients),
                                  [2.0, 2.0])
    assert [e["coordinate"] for e in jstate.history] == ["a", "b", "a", "b"]


def test_graceful_stop_flag_on_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    try:
        stop = GracefulStop().install(signums=(signal.SIGTERM,))
        assert not stop()
        signal.raise_signal(signal.SIGTERM)
        assert stop() and stop.signum == signal.SIGTERM
    finally:
        signal.signal(signal.SIGTERM, prev)


@pytest.mark.parametrize("code,signum", [(75, signal.SIGTERM), (99, signal.SIGINT)])
def test_graceful_stop_second_signal_hard_exits(monkeypatch, code, signum):
    exited = []
    monkeypatch.setattr(t_checkpoint.os, "_exit", lambda c: exited.append(c))
    prev = signal.getsignal(signum)
    try:
        stop = (GracefulStop() if code == 75 else GracefulStop(hard_exit_code=code)).install(
            signums=(signum,))
        signal.raise_signal(signum)
        assert stop() and exited == []
        signal.raise_signal(signum)
        assert exited == [code]
    finally:
        signal.signal(signum, prev)


def test_sigterm_mid_fit_writes_final_checkpoint(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    try:
        stop = GracefulStop().install(signums=(signal.SIGTERM,))
        fired = []

        def stop_after_first_step():
            if not fired:
                fired.append(True)
                signal.raise_signal(signal.SIGTERM)
            return stop()

        with pytest.raises(TrainingInterrupted):
            _run({"a": _Toy(), "b": _Toy()}, tmp_path, every=100,
                 should_stop=stop_after_first_step)
        assert sorted(os.listdir(tmp_path)) == ["step-00000000"]
        reference = _run({"a": _Toy(), "b": _Toy()})
        resumed = _run({"a": _Toy(), "b": _Toy()}, tmp_path, every=100)
        for name in ("a", "b"):
            np.testing.assert_array_equal(_coef(resumed, name), _coef(reference, name))
    finally:
        signal.signal(signal.SIGTERM, prev)


def _toy_game(seed=0, n=130):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    users = rng.integers(0, 4, n)
    y = (rng.random(n) < 0.5).astype(float)
    jds = j_build(response=y, feature_shards={"f": JSparse.from_dense(X, y)},
                  id_columns={"u": users})
    tds = build_game_dataset(response=y, feature_shards={"f": FeatureShard.from_dense(X)},
                             id_columns={"u": users}, device="cpu")
    jcfg = JGameConfig(task="logistic", num_iterations=2, coordinates={
        "fixed": JFEConfig(shard_name="f"), "perUser": JREConfig(shard_name="f", id_name="u")})
    tcfg = GameConfig(task="logistic", num_iterations=2, coordinates={
        "fixed": FixedEffectConfig(shard_name="f"),
        "perUser": RandomEffectConfig(shard_name="f", id_name="u")})
    return jds, tds, jcfg, tcfg


def _tensors(model):
    out = {"fixed": model.models["fixed"].coefficients}
    out.update({f"perUser/{i}": b.coefficients
                for i, b in enumerate(model.models["perUser"].buckets)})
    return out


def test_game_fit_interrupted_and_resumed_reproduces_the_uninterrupted_fit(tmp_path):
    _, tds, _, tcfg = _toy_game()
    reference = GameEstimator(tcfg).fit(tds, device="cpu")
    spec = CheckpointSpec(directory=str(tmp_path / "ckpt"))
    stops = iter([False, True, True, True])
    with pytest.raises(TrainingInterrupted) as ei:
        GameEstimator(tcfg).fit(tds, device="cpu", checkpoint_spec=spec,
                                should_stop=lambda: next(stops))
    assert ei.value.step == 1
    resumed = GameEstimator(tcfg).fit(tds, device="cpu", checkpoint_spec=spec)
    ref_t, res_t = _tensors(reference.model), _tensors(resumed.model)
    assert all(torch.equal(ref_t[k], res_t[k]) for k in ref_t)  # bit for bit
    assert [e["coordinate"] for e in resumed.history] == ["fixed", "perUser"] * 2
    assert [("results" in e) for e in resumed.history] == [False, False, True, True]


def test_the_port_resumes_a_fit_the_jax_package_interrupted(tmp_path):
    jds, tds, jcfg, tcfg = _toy_game(seed=1)
    reference = JEstimator(jcfg).fit(jds)
    spec_kw = dict(directory=str(tmp_path / "ckpt"))
    stops = iter([False, True, True])
    with pytest.raises(JInterrupted):
        JEstimator(jcfg).fit(jds, checkpoint_spec=JSpec(**spec_kw),
                             should_stop=lambda: next(stops))
    resumed = GameEstimator(tcfg).fit(tds, device="cpu", checkpoint_spec=CheckpointSpec(
        **spec_kw))
    np.testing.assert_allclose(resumed.model.models["fixed"].coefficients.numpy(),
                               np.asarray(reference.model.models["fixed"].coefficients),
                               rtol=1e-3, atol=1e-3)
    for jb, tb in zip(reference.model.models["perUser"].buckets,
                      resumed.model.models["perUser"].buckets):
        np.testing.assert_allclose(tb.coefficients.numpy(), np.asarray(jb.coefficients),
                                   rtol=1e-3, atol=1e-3)


# -- the coordinated multi-process streaming save (tests/test_checkpoint.py:543-811) --


def _patch_fleet(monkeypatch, pid, nproc):
    """This process as member ``pid`` of an ``nproc``-process fleet, for the
    save's protocol (the reference patches jax's process index and count)."""
    from photon_ml_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "process_index", lambda: pid)
    monkeypatch.setattr(multihost, "process_count", lambda: nproc)
    monkeypatch.setattr(multihost, "is_multiprocess", lambda: nproc > 1)


def _stream_mgr(tmp_path, timeout):
    from photon_ml_tpu_torch.game.checkpoint import StreamingCheckpointManager

    return StreamingCheckpointManager(CheckpointSpec(directory=str(tmp_path), every=1,
                                                     quorum_timeout_s=timeout))


def _peer(tmp, next_chunk, manifest, payload=None):
    """Process 1, simulated: waits for the rendezvous, writes its rows (when
    given) and its manifest, the manifest last."""
    import threading
    import time as _t

    def run():
        t0 = _t.monotonic()
        while not os.path.exists(tmp / "rendezvous.json"):
            assert _t.monotonic() - t0 < 10.0
            _t.sleep(0.01)
        assert json.load(open(tmp / "rendezvous.json")) == {"num_processes": 2,
                                                             "next_chunk": next_chunk}
        if payload is not None:
            np.save(tmp / "coefficients-p0001-0000.npy", payload)
        with open(tmp / ".peer-manifest", "w") as fh:
            json.dump(manifest, fh)
        os.rename(tmp / ".peer-manifest", tmp / "manifest.proc-0001.json")

    t = threading.Thread(target=run)
    t.start()
    return t


def _peer_manifest(next_chunk, row_start):
    return {"process_id": 1, "num_processes": 2, "next_chunk": next_chunk,
            "shards": [{"file": "coefficients-p0001-0000.npy", "row_start": row_start,
                        "rows": 2}], "variance_shards": None}


def test_quorum_timeout_spec_validation(tmp_path):
    with pytest.raises(ValueError, match="quorum_timeout_s"):
        CheckpointSpec(directory=str(tmp_path), quorum_timeout_s=0.0)


def test_coordinated_save_abandons_uncertified_without_peer_quorum(tmp_path, monkeypatch):
    """Process 0 with a dead peer: the save returns None after the quorum
    wait, the directory stays uncertified (its own manifest, no quorum
    manifest), restore passes it by, and the next good save's retention
    sweeps it."""
    from photon_ml_tpu_torch.game.checkpoint import StreamCheckpointState

    mgr = _stream_mgr(tmp_path, 0.3)
    coeffs = np.arange(12, dtype=np.float32).reshape(4, 3)
    _patch_fleet(monkeypatch, 0, 2)
    telemetry.reset()
    try:
        assert mgr.save(StreamCheckpointState(next_chunk=1, coefficients=coeffs)) is None
        snap = telemetry.snapshot()["counters"]
        assert snap["checkpoint.quorum_timeouts"] == 1 and "checkpoint.saves" not in snap
    finally:
        telemetry.reset()
    assert [n for n in os.listdir(tmp_path) if n.startswith(".tmp-chunk-")] == [
        ".tmp-chunk-00000001"]
    contents = os.listdir(tmp_path / ".tmp-chunk-00000001")
    assert "manifest.proc-0000.json" in contents and "manifest.json" not in contents
    assert mgr.restore() is None
    _patch_fleet(monkeypatch, 0, 1)
    assert mgr.save(StreamCheckpointState(next_chunk=2, coefficients=coeffs)) is not None
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-chunk-")]


def test_coordinated_save_certifies_quorum_after_all_peers_land(tmp_path, monkeypatch):
    """The whole rendezvous from process 0's seat with a live peer (a
    thread): the quorum manifest merges the blocks by row range and records
    the quorum, the directory is renamed into place, restore reassembles the
    table, and ``restore_placed`` puts it on a smaller fleet (one process,
    one device) as an elastic resume."""
    from photon_ml_tpu_torch.game.checkpoint import StreamCheckpointState

    mgr = _stream_mgr(tmp_path, 10.0)
    tmp = tmp_path / ".tmp-chunk-00000003"
    peer_rows = np.full((2, 3), 7.0, np.float32)
    t = _peer(tmp, 3, _peer_manifest(3, 2), payload=peer_rows)
    my_rows = np.full((2, 3), 3.0, np.float32)
    _patch_fleet(monkeypatch, 0, 2)
    telemetry.reset()
    try:
        path = mgr.save(StreamCheckpointState(next_chunk=3, coefficients=my_rows))
        t.join()
        assert path == str(tmp_path / "chunk-00000003")
        snap = telemetry.snapshot()["counters"]
        assert snap["checkpoint.saves"] == 1 and snap["checkpoint.peer_manifests"] == 1
        assert "checkpoint.quorum_timeouts" not in snap
    finally:
        telemetry.reset()
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["quorum"] == {"num_processes": 2}
    assert [(s["row_start"], s["rows"]) for s in manifest["shards"]] == [(0, 2), (2, 2)]
    assert {"manifest.proc-0000.json", "manifest.proc-0001.json"} <= set(os.listdir(path))
    restored = mgr.restore()
    assert restored is not None and restored.next_chunk == 3
    np.testing.assert_array_equal(restored.coefficients[:2], my_rows)
    np.testing.assert_array_equal(restored.coefficients[2:], peer_rows)
    _patch_fleet(monkeypatch, 0, 1)
    placed = mgr.restore_placed(device="cpu")
    assert placed.next_chunk == 3
    np.testing.assert_array_equal(placed.coefficients.numpy(),
                                  np.concatenate([my_rows, peer_rows]))


def test_coordinated_save_abandons_on_cover_violation_or_missing_payload(tmp_path,
                                                                          monkeypatch):
    """A peer manifest that overlaps process 0's rows, or names a payload
    not on disk, is never certified: ``checkpoint.quorum_cover_violations``,
    not a quorum timeout."""
    from photon_ml_tpu_torch.game.checkpoint import StreamCheckpointState

    mgr = _stream_mgr(tmp_path, 10.0)
    my_rows = np.zeros((2, 3), np.float32)
    _patch_fleet(monkeypatch, 0, 2)
    telemetry.reset()
    try:
        for chunk, row_start in ((1, 0), (2, 2)):  # overlap; then a missing payload
            t = _peer(tmp_path / f".tmp-chunk-{chunk:08d}", chunk,
                      _peer_manifest(chunk, row_start))
            try:
                assert mgr.save(StreamCheckpointState(next_chunk=chunk,
                                                      coefficients=my_rows)) is None
            finally:
                t.join()
        snap = telemetry.snapshot()["counters"]
        assert snap["checkpoint.quorum_cover_violations"] == 2
        assert "checkpoint.quorum_timeouts" not in snap and "checkpoint.saves" not in snap
    finally:
        telemetry.reset()
    assert mgr.restore() is None


def test_coordinated_save_peer_ignores_stale_rendezvous(tmp_path, monkeypatch):
    """A member finding a stale rendezvous (another fleet size's) keeps
    waiting instead of writing into a directory process 0 is about to
    remove, and times out uncertified."""
    from photon_ml_tpu_torch.game.checkpoint import StreamCheckpointState
    from photon_ml_tpu_torch.utils.atomic import atomic_write_json

    mgr = _stream_mgr(tmp_path, 0.3)
    tmp = tmp_path / ".tmp-chunk-00000001"
    os.makedirs(tmp)
    atomic_write_json(str(tmp / "rendezvous.json"), {"num_processes": 3, "next_chunk": 1})
    _patch_fleet(monkeypatch, 1, 2)
    telemetry.reset()
    try:
        assert mgr.save(StreamCheckpointState(next_chunk=1, coefficients=np.zeros(
            (2, 3), np.float32))) is None
        assert telemetry.snapshot()["counters"]["checkpoint.quorum_timeouts"] == 1
    finally:
        telemetry.reset()
    assert sorted(os.listdir(tmp)) == ["rendezvous.json"]


def test_coordinated_save_peer_gives_up_without_process_zero(tmp_path, monkeypatch):
    """A member whose process 0 died before the rendezvous: the bounded wait
    ends, the save returns None uncertified."""
    from photon_ml_tpu_torch.game.checkpoint import StreamCheckpointState

    mgr = _stream_mgr(tmp_path, 0.3)
    _patch_fleet(monkeypatch, 1, 2)
    telemetry.reset()
    try:
        assert mgr.save(StreamCheckpointState(next_chunk=1, coefficients=np.zeros(
            (4, 3), np.float32))) is None
        assert telemetry.snapshot()["counters"]["checkpoint.quorum_timeouts"] == 1
    finally:
        telemetry.reset()
    assert mgr.restore() is None
