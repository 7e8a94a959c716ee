"""The frozen cost against hand counts, and the kernel-name map."""

import glob
import os
import re

import pytest

from benchmark.yardstick import cost, kernels, peaks, work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_csr_margins_by_hand():
    # 3 rows, 5 nonzeros, 4 features: row pointer 4, cols 5, vals 5, w 4,
    # margins 3, offsets 3; a multiply-add per nonzero
    assert cost.csr_margins(3, 5, 4) == (10, 4 * (4 + 10 + 4 + 3))
    assert cost.csr_margins(3, 5, 4, use_offsets=True) == (10, 4 * (4 + 10 + 4 + 3 + 3))


def test_csc_scatter_by_hand():
    # column pointer 5, rows and vals 10, per_row 3, out 4
    assert cost.csc_scatter(3, 5, 4) == (10, 4 * (5 + 10 + 3 + 4))


def test_lane_costs_by_hand():
    assert cost.csr_margins_lanes(3, 5, 4, 2) == (20, 4 * (4 + 10 + 8 + 6))
    assert cost.csr_margins_lanes(3, 5, 4, 2, offset_words=3) == (20, 4 * (4 + 10 + 8 + 6 + 3))
    assert cost.csc_scatter_lanes(3, 5, 4, 2) == (20, 4 * (5 + 10 + 6 + 8))


def test_dense_costs_by_hand():
    # E=2, R=3, K=4: x 24 values, w 8, margins 6
    assert cost.dense_rows(2, 3, 4) == (48, 4 * (24 + 8 + 6))
    assert cost.dense_scatter(2, 3, 4) == (48, 4 * (24 + 6 + 8))


def test_fit_work_by_hand():
    assert work.glm_pass(3, 5, 4) == cost.value_grad(3, 5, 4)
    # a second lane adds its w, gradient and two sums, and its products
    f1, b1 = work.glm_pass(3, 5, 4, lanes=1)
    f2, b2 = work.glm_pass(3, 5, 4, lanes=2)
    assert f2 == 2 * f1 and b2 - b1 == 4 * (2 * 4 + 2)


def test_bound_takes_the_larger_side():
    assert peaks.bound_seconds(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_seconds(67e12, 3.35e12 * 2) == pytest.approx(2.0)
    assert peaks.bound_seconds(67e12 * 4, 0, cards=4) == pytest.approx(1.0)


@pytest.mark.parametrize("name,want", [
    ("void row_pass_kernel<MarginsEpi<false> >(RowPassParams)", "row_pass_kernel"),
    # as torch.profiler names them on the card
    ("void photon::(anonymous namespace)::row_pass_kernel<true, photon::(anonymous "
     "namespace)::MarginsEpilogue>(photon::(anonymous namespace)::RowPassParams)",
     "row_pass_kernel"),
    ("photon::(anonymous namespace)::scatter_lanes_kernel(photon::(anonymous "
     "namespace)::ScatterLaneParams)", "scatter_lanes_kernel"),
    ("csc_scatter_tiled_kernel(TileIndex, int const*, float const*)", "csc_scatter_tiled_kernel"),
    ("finish_lanes_kernel", "finish_lanes_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, float>", None),
    ("Memcpy DtoH (Device -> Pageable)", None),
])
def test_kernel_of(name, want):
    assert kernels.kernel_of(name) == want


def test_every_global_kernel_is_mapped():
    found = set()
    for path in glob.glob(os.path.join(ROOT, "photon_ml_tpu_torch", "csrc", "*.cu*")):
        text = open(path).read()
        found |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text))
    assert found == set(kernels.KERNEL_NAMES)
    for counter, (wrapper, members) in kernels.CALLS.items():
        assert counter in members and hasattr(cost, wrapper)
