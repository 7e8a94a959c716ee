"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the repository. Tests that need a card take ``cuda_card`` and
skip where there is none; nothing is decided while a module is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the tests' small sizes of each cell: (traffic, configuration) overrides.
#: Rows stay many times the features, as at the cells' own sizes, so each
#: fit is as well posed as there.
NARROW = {"num_features": 200}
SMALL = {
    "glm1-lbfgs-32m": ({"rows": 20000}, NARROW),
    "glm1-sweep16-32m": ({"rows": 20000}, NARROW),
}


def small(name: str):
    """The cell ``name`` at the tests' size on the CPU, and its devices."""
    import torch

    from benchmark import harness

    traffic, config = SMALL[name]
    cell = harness.load_cell(name, root=ROOT, overrides=traffic, config_overrides=config)
    return cell, [torch.device("cpu")] * cell.chips


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.fixture
def small_cell():
    """``small_cell(name)``: ``small``."""
    return small
