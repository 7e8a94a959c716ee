"""Data-parallel GLM solves over a mesh.

Counterpart of ``photon_ml_tpu/parallel/distributed.py:180-289``. The
reference runs the whole optimizer loop in one ``jax.jit`` and lets GSPMD put
the psums in; here the optimizer's host loop runs once, on the mesh's first
device, over the sharded adapter (``optim/adapter.py`` ``sharded_adapter``):
every data pass launches each shard's kernels on the shard's device and sums
the partials on the first device in shard order.

- ``gspmd_solve``: a design placed by ``place_batch`` (a ``ShardedBatch``;
  a ``CSRBatch`` is placed first);
- ``distributed_solve``: the stacked layout of ``shard_rows`` (a list of
  ``RowShard``), placed by ``put_sharded``;
- ``distributed_value_and_grad`` and ``distributed_hessian_diagonal``: one
  evaluation (diagnostics, variances).

The fault point ``parallel.collective.entry`` (distributed) fires at the
entry of every mesh solve; the streamed random effect hits it too, before a
fleet member's chunk solve.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from photon_ml_tpu_torch import faults
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.common import BoxConstraints, SolveResult
from photon_ml_tpu_torch.optim.factory import OptimizerConfig, solve
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, RowShard
from photon_ml_tpu_torch.parallel.sharding import as_sharded, data_axis

Tensor = torch.Tensor

FP_COLLECTIVE_ENTRY = faults.register_point(
    "parallel.collective.entry", distributed=True,
    description="host-side entry into a multi-process collective program "
    "(gspmd/distributed solve dispatch, streamed chunk solves)",
)


def gspmd_solve(
    loss_name: str,
    batch,
    config: OptimizerConfig,
    w0: Tensor,
    mesh: Mesh,
    axis: Optional[str] = None,
    constraints: Optional[BoxConstraints] = None,
    factors: Optional[Tensor] = None,
    shifts: Optional[Tensor] = None,
    extra_l2: float = 0.0,
) -> SolveResult:
    """Solve a GLM whose rows are split over ``axis`` (default the mesh's
    batch/data axis); ``extra_l2`` adds the guard's damping. The result
    lives on the mesh's first device."""
    axis = axis or data_axis(mesh)
    if axis is None:
        raise ValueError(f"mesh {mesh.shape} has no batch/data axis to shard rows over")
    faults.fault_point(FP_COLLECTIVE_ENTRY)
    sb = as_sharded(batch, mesh, axis)
    return solve(loss_name, sb, config, w0, constraints, factors=factors, shifts=shifts,
                 device=sb.device, extra_l2=extra_l2)


def distributed_solve(
    loss_name: str,
    stacked: Sequence[RowShard],
    config: OptimizerConfig,
    w0: Tensor,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    constraints: Optional[BoxConstraints] = None,
    factors: Optional[Tensor] = None,
    shifts: Optional[Tensor] = None,
    extra_l2: float = 0.0,
) -> SolveResult:
    """Solve a GLM given in the stacked layout (``shard_rows``'s pieces);
    the same solve as ``gspmd_solve``."""
    return gspmd_solve(loss_name, as_sharded(list(stacked), mesh, axis), config, w0, mesh, axis,
                       constraints, factors, shifts, extra_l2)


def distributed_value_and_grad(obj: GLMObjective, w: Tensor, batch, mesh: Mesh,
                               axis: str = DATA_AXIS) -> tuple[Tensor, Tensor]:
    """(value, gradient) of ``obj`` at ``w`` over a sharded design."""
    return glm_adapter(obj, as_sharded(batch, mesh, axis)).value_and_grad(w)


def distributed_hessian_diagonal(obj: GLMObjective, w: Tensor, batch,
                                 mesh: Optional[Mesh] = None,
                                 axis: str = DATA_AXIS) -> Tensor:
    """diag H(w) over a sharded design, for coefficient variances; without a
    mesh, over ``batch`` as one shard (``obj.hessian_diagonal``'s bits)."""
    sb = as_sharded(batch, mesh, axis)
    w_eff, shift = obj._effective(w)
    parts = sb.each(lambda b, we, s: obj.hessian_diagonal_sums(we, s, b), sb.broadcast(w_eff),
                    sb.broadcast(shift))
    sums = [None if p[0] is None else sb.reduce(p) for p in zip(*parts)]
    return obj.finish_hessian_diagonal(w, *sums)
