"""Bridge from ``GLMObjective`` to the optimizer ``Objective``, including the
margin-space line search.

Counterpart of ``glm_adapter`` in ``photon_ml_tpu/optim/adapter.py``
(:35-171). Along a direction p the margins are affine, z(a) = z + a*u with
u = X'p computed once per line search, so each Wolfe trial is O(n)
elementwise work on the carried margins instead of a pass over the nonzeros.
Over a bucket of per-entity problems (a ``DenseBatch``, or the
``BlockDiagonalBatch`` of a COO bucket), or lanes over a shared design
(``ops/shared_design.py``: a sweep's or a bootstrap's), the adapter is
batched (``lane_adapter``): every field works on ``[E, K]`` coefficients, one lane
per entity, as ``vmap`` gives the reference; it adds the explicit Hessians,
and its oracle evaluates a vector of step sizes for every entity at once
(what ``vmap`` over the step sizes gives the reference's Newton,
``optim/newton.py:117-128``) or one step size per lane (the lane line
searches).
Over one problem's rows the adapter is sharded (``sharded_adapter``), the
reference's GSPMD mode (``row_sharding``, :45-60), over a ``ShardedBatch``
(``parallel/sharding.py``): a design's rows split over a mesh, or a batch
that is not split, as the one shard of a one-device mesh. The margins z and u stay
per shard on the shard's device (``RowShards``) and are never gathered; each
data sum is the shards' partials summed on the first device in shard order
(``ShardedBatch.reduce``): a line-search trial reduces two scalars, a
gradient one [F] vector and two scalars, a TRON CG step one Hv. The solver
state lives on the first device; each shard takes a copy of ``w`` and ``p``
per evaluation. The reference's explicit-SPMD ``axis_name`` is not ported:
one process drives the mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch
from photon_ml_tpu_torch.ops.dense import DenseBatch, per_entity
from photon_ml_tpu_torch.ops.objective import GLMObjective, sqnorm
from photon_ml_tpu_torch.ops.shared_design import BlockDiagonalLanes, DenseLanes, SharedDesign
from photon_ml_tpu_torch.optim.common import Objective
from photon_ml_tpu_torch.parallel.sharding import RowShards, ShardedBatch, as_sharded

Tensor = torch.Tensor


class _LSCarry(NamedTuple):
    z: Tensor  # margins at w
    u: Tensor  # directional margins X'p (+ shift)
    w: Tensor
    p: Tensor
    ww: Tensor
    wp: Tensor
    pp: Tensor


_LANE_BATCHES = (DenseBatch, BlockDiagonalBatch, SharedDesign, DenseLanes, BlockDiagonalLanes)


def glm_adapter(obj: GLMObjective, batch) -> Objective:
    """Build the optimizer-facing adapter for a GLM objective over a batch:
    the batched adapter over lanes, else the sharded one over ``batch``'s
    rows (one shard when it is not split over a mesh)."""
    if isinstance(batch, _LANE_BATCHES):
        return lane_adapter(obj, batch)
    return sharded_adapter(obj, as_sharded(batch))


def lane_adapter(obj: GLMObjective, batch) -> Objective:
    """The batched adapter over a bucket of per-entity problems, a
    ``DenseBatch`` or a ``BlockDiagonalBatch``: coefficients ``[E, K]``,
    values ``[E]``, gradients, Hv and Hessian diagonals ``[E, K]``, margins
    ``[E, R]``, and each lane's sums over its own rows. It carries the
    margin protocol and the second-order fields per lane, and the explicit
    ``[E, K, K]`` Hessians from the bucket's dense designs (none over a
    shared CSR design, which NEWTON refuses). A per-lane L2 weight (``[E]``)
    enters the line search as ``[E, 1]``."""
    loss = obj.loss_for(batch)
    l2 = obj._l2_col

    def value_and_grad(w):
        return obj.value_and_grad(w, batch)

    def value(w):
        return obj.value(w, batch)

    def _carry(z, u, w, p):
        return _LSCarry(z=z, u=u, w=w, p=p, ww=sqnorm(w), wp=torch.sum(w * p, dim=-1),
                        pp=sqnorm(p))

    def ls_prepare(w, p):
        p_eff, p_shift = obj._effective(p)
        w_eff, w_shift = obj._effective(w)
        z, u = batch.margins_pair(w_eff, w_shift, p_eff, p_shift)
        return _carry(z, u, w, p)

    def ls_eval(carry: _LSCarry, alphas: Tensor):
        """(phi, dphi) [E, A] at the step sizes ``alphas``: [A] shared by
        every lane, or [E, A], one row per lane."""
        a = alphas.reshape(1, -1) if alphas.dim() == 1 else alphas
        z_a = carry.z.unsqueeze(1) + a.unsqueeze(-1) * carry.u.unsqueeze(1)  # [E, A, R]
        l, dz = loss.loss_and_dz(z_a, batch.labels.unsqueeze(1))
        wgt = batch.weights.unsqueeze(1)
        ww, wp, pp = carry.ww.unsqueeze(1), carry.wp.unsqueeze(1), carry.pp.unsqueeze(1)
        phi = torch.sum(wgt * l, dim=-1) + 0.5 * l2 * (ww + 2.0 * a * wp + a * a * pp)
        dphi = torch.sum(wgt * dz * carry.u.unsqueeze(1), dim=-1) + l2 * (wp + a * pp)
        return phi, dphi

    def margins(w):
        return obj.margins(w, batch)

    def dir_margins(p):
        p_eff, p_shift = obj._effective(p)
        return batch.dot_rows(p_eff) + per_entity(p_shift)

    def ls_prepare_z(z, w, p):
        return _carry(z, dir_margins(p), w, p)

    def ls_advance(carry: _LSCarry, alpha: Tensor):
        """The margins at one step size per lane, ``alpha`` [E]."""
        return carry.z + alpha.unsqueeze(-1) * carry.u

    def value_and_grad_at(w, z):
        return obj.value_and_grad_at_margins(w, z, batch)

    hvp = curvature = hvp_at = hessian = None
    if loss.has_hessian:
        def hvp(w, v):
            return obj.hessian_vector(w, v, batch)

        def curvature(z):
            return obj.curvature_at_margins(z, batch)

        def hvp_at(d2, v):
            return obj.hessian_vector_with_curvature(d2, v, batch)

        if not isinstance(batch, SharedDesign):
            def hessian(w):
                return obj.dense_hessian(w, batch)

    return Objective(
        value_and_grad=value_and_grad,
        value=value,
        ls_prepare=ls_prepare,
        ls_eval=ls_eval,
        margins=margins,
        ls_prepare_z=ls_prepare_z,
        ls_advance=ls_advance,
        value_and_grad_at=value_and_grad_at,
        dir_margins=dir_margins,
        hvp=hvp,
        curvature=curvature,
        hvp_at=hvp_at,
        hessian=hessian,
    )


def sharded_adapter(obj: GLMObjective, batch: ShardedBatch) -> Objective:
    """The adapter over a design's rows split over a mesh: every field runs
    the objective's data passes shard by shard and sums the partials on the
    first device in shard order; over one shard a broadcast is the value
    itself and a sum the one partial, so it computes what ``GLMObjective``
    gives over the batch alone. Margins are ``RowShards``."""
    loss, l2 = obj.loss, obj.l2_weight

    def effective(v):
        v_eff, v_shift = obj._effective(v)
        return batch.broadcast(v_eff), batch.broadcast(v_shift)

    def reduced(parts):
        return tuple(batch.reduce(p) for p in zip(*parts))

    def value_and_grad(w):
        w_eff, shift = effective(w)
        return obj.finish_value_grad(w, *reduced(batch.each(
            lambda b, we, s: b.fused_value_grad(we, s, obj.loss_name), w_eff, shift)))

    def margins(w):
        w_eff, shift = effective(w)
        return RowShards(batch.each(lambda b, we, s: b.margins(we, s), w_eff, shift))

    def value(w):
        def part(b, z):
            return torch.sum(b.weights * loss.loss(z, b.labels), dim=-1)

        return batch.reduce(batch.each(part, margins(w))) + 0.5 * l2 * sqnorm(w)

    def _carry(z, u, w, p):
        return _LSCarry(z=z, u=u, w=w, p=p, ww=torch.dot(w, w), wp=torch.dot(w, p),
                        pp=torch.dot(p, p))

    def ls_prepare(w, p):
        w_eff, w_shift = effective(w)
        p_eff, p_shift = effective(p)
        pairs = batch.each(lambda b, we, ws, pe, ps: b.margins_pair(we, ws, pe, ps),
                           w_eff, w_shift, p_eff, p_shift)
        return _carry(RowShards(z for z, _ in pairs), RowShards(u for _, u in pairs), w, p)

    def ls_eval(carry: _LSCarry, alpha: float):
        def part(b, z, u):
            l, dz = loss.loss_and_dz(z + alpha * u, b.labels)
            return torch.sum(b.weights * l), torch.sum(b.weights * dz * u)

        data_phi, data_dphi = reduced(batch.each(part, carry.z, carry.u))
        phi = data_phi + 0.5 * l2 * (carry.ww + 2.0 * alpha * carry.wp + alpha * alpha * carry.pp)
        dphi = data_dphi + l2 * (carry.wp + alpha * carry.pp)
        return phi, dphi

    def dir_margins(p):
        p_eff, p_shift = effective(p)
        return RowShards(batch.each(lambda b, pe, ps: b.dot_rows(pe) + ps, p_eff, p_shift))

    def ls_prepare_z(z, w, p):
        return _carry(z, dir_margins(p), w, p)

    def ls_advance(carry: _LSCarry, alpha: float):
        return RowShards(z + alpha * u for z, u in zip(carry.z, carry.u))

    def value_and_grad_at(w, z):
        return obj.finish_value_grad(w, *reduced(batch.each(
            lambda b, zs: obj.value_grad_sums_at_margins(zs, b), z)))

    hvp = curvature = hvp_at = None
    if loss.has_hessian:
        def hvp(w, v):
            w_eff, w_shift = effective(w)
            v_eff, v_shift = effective(v)
            return obj.finish_hv(v, *reduced(batch.each(
                lambda b, we, ws, ve, vs: b.fused_hessian_vector(we, ws, ve, vs, obj.loss_name),
                w_eff, w_shift, v_eff, v_shift)))

        def curvature(z):
            return RowShards(batch.each(lambda b, zs: obj.curvature_at_margins(zs, b), z))

        def hvp_at(d2, v):
            v_eff, v_shift = effective(v)
            return obj.finish_hv(v, *reduced(batch.each(
                lambda b, d, ve, vs: b.fused_hv_at(d, ve, vs), d2, v_eff, v_shift)))

    return Objective(
        value_and_grad=value_and_grad,
        value=value,
        ls_prepare=ls_prepare,
        ls_eval=ls_eval,
        margins=margins,
        ls_prepare_z=ls_prepare_z,
        ls_advance=ls_advance,
        value_and_grad_at=value_and_grad_at,
        dir_margins=dir_margins,
        hvp=hvp,
        curvature=curvature,
        hvp_at=hvp_at,
    )
