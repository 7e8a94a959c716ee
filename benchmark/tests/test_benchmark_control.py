"""The check fails what it must: the control and each fault a cell can
have, driven through the rest of a run with the timed path broken
underneath (the look for a card skipped, the CPU at the tests' size)."""

import time

import pytest

from benchmark import calibrate, faults, harness

GLM_CELLS = ["glm1-lbfgs-32m", "glm1-sweep16-32m"]
CASES = [(c, m) for c in GLM_CELLS for m in faults.MODES]


def _broken_run(monkeypatch, cell, devices, mode):
    real = harness.load_module

    def load(kind, name):
        mod = real(kind, name)
        if kind != "drivers":
            return mod

        class Broken:
            @staticmethod
            def prepare(bench):
                session = mod.prepare(bench)
                faults.install(session, mode)
                return session
        return Broken
    monkeypatch.setattr(harness, "load_module", load)
    return harness.measure(cell, 2**31 + 77, 0.01, False, time.perf_counter(), devices)


def test_a_sound_run_is_correct(small_cell):
    for name in GLM_CELLS:
        cell, devices = small_cell(name)
        res = harness.measure(cell, 2**31 + 77, 0.01, False, time.perf_counter(), devices)
        assert res["correct"] is True, (name, res["checks"])


@pytest.mark.parametrize("name,mode", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, small_cell, name, mode):
    cell, devices = small_cell(name)
    res = _broken_run(monkeypatch, cell, devices, mode)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1


@pytest.mark.cuda
def test_calibration_runs_on_the_card(small_cell, cuda_card):
    cell, _ = small_cell("glm1-lbfgs-32m")
    seen = []
    calibrate.calibrate(cell, 3, ["sound", "control"], [cuda_card], seen.append)
    assert [r["mode"] for r in seen] == ["sound", "control"]
