"""The map from the ``__global__`` names of ``photon_ml_tpu_torch/csrc/`` to
the work a call moves (``cost.py``).

A call of a wrapper launches its kernel once, and the scatters a finish
kernel after it: ``CALLS`` names the kernel whose launches count the calls,
the cost function, and the kernels whose device time belongs to the call.
``tile_fused_kernel`` serves ``value_grad``, ``hv`` and ``hv_at`` alike; its
launches are priced as ``value_grad``'s.
"""

from __future__ import annotations

import re

from benchmark.yardstick import cost

#: every ``__global__`` kernel of the program's sources
KERNEL_NAMES = (
    "row_pass_kernel",
    "csc_scatter_tiled_kernel",
    "finish_tiled_kernel",
    "tile_fused_kernel",
    "tile_fused_finish_kernel",
    "margins_lanes_kernel",
    "scatter_lanes_kernel",
    "finish_lanes_kernel",
    "ell_margins_kernel",
)

#: counting kernel -> (default wrapper, kernels whose time the call takes)
CALLS = {
    "row_pass_kernel": ("csr_margins", ("row_pass_kernel",)),
    "csc_scatter_tiled_kernel": ("csc_scatter", ("csc_scatter_tiled_kernel",
                                                 "finish_tiled_kernel")),
    "tile_fused_kernel": ("value_grad", ("tile_fused_kernel", "tile_fused_finish_kernel")),
    "margins_lanes_kernel": ("csr_margins_lanes", ("margins_lanes_kernel",)),
    "scatter_lanes_kernel": ("csc_scatter_lanes", ("scatter_lanes_kernel",
                                                   "finish_lanes_kernel")),
    "ell_margins_kernel": ("ell_margins", ("ell_margins_kernel",)),
}


_NAME = re.compile(r"(?:^|[\s:])(" + "|".join(KERNEL_NAMES) + r")\s*(?:[<(]|$)")


def kernel_of(device_op_name: str) -> str | None:
    """The ``__global__`` name inside a profiler's kernel name (which may
    carry ``void``, namespaces, template arguments and a parameter list),
    or None."""
    m = _NAME.search(device_op_name)
    return m.group(1) if m else None


def call_work(wrapper: str, shape: dict) -> tuple[int, int]:
    """(flops, bytes) of one call of ``wrapper`` at ``shape``: keyword
    arguments of its ``cost`` function."""
    return getattr(cost, wrapper)(**shape)
