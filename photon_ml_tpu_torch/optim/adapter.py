"""Bridge from ``GLMObjective`` to the optimizer ``Objective``, including the
margin-space line search.

Counterpart of ``glm_adapter`` in ``photon_ml_tpu/optim/adapter.py``
(:35-171). Along a direction p the margins are affine, z(a) = z + a*u with
u = X'p computed once per line search, so each Wolfe trial is O(n)
elementwise work on the carried margins instead of a pass over the nonzeros.
Over a bucket of per-entity problems (a ``DenseBatch``, or the
``BlockDiagonalBatch`` of a COO bucket) the adapter is batched
(``lane_adapter``): every field works on ``[E, K]`` coefficients, one lane
per entity, as ``vmap`` gives the reference; it adds the explicit Hessians,
and its oracle evaluates a vector of step sizes for every entity at once
(what ``vmap`` over the step sizes gives the reference's Newton,
``optim/newton.py:117-128``) or one step size per lane (the lane line
searches).
The reference's ``axis_name``/``row_sharding`` (multi-device) arguments are
not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch
from photon_ml_tpu_torch.ops.dense import DenseBatch, per_entity
from photon_ml_tpu_torch.ops.objective import GLMObjective, sqnorm
from photon_ml_tpu_torch.optim.common import Objective

Tensor = torch.Tensor


class _LSCarry(NamedTuple):
    z: Tensor  # margins at w
    u: Tensor  # directional margins X'p (+ shift)
    w: Tensor
    p: Tensor
    ww: Tensor
    wp: Tensor
    pp: Tensor


def glm_adapter(obj: GLMObjective, batch) -> Objective:
    """Build the optimizer-facing adapter for a GLM objective over a batch."""
    if isinstance(batch, (DenseBatch, BlockDiagonalBatch)):
        return lane_adapter(obj, batch)
    loss = obj.loss
    l2 = obj.l2_weight

    def value_and_grad(w):
        return obj.value_and_grad(w, batch)

    def value(w):
        return obj.value(w, batch)

    def _carry(z, u, w, p):
        return _LSCarry(z=z, u=u, w=w, p=p, ww=torch.dot(w, w), wp=torch.dot(w, p),
                        pp=torch.dot(p, p))

    def ls_prepare(w, p):
        p_eff, p_shift = obj._effective(p)
        w_eff, w_shift = obj._effective(w)
        z, u = batch.margins_pair(w_eff, w_shift, p_eff, p_shift)
        return _carry(z, u, w, p)

    def ls_eval(carry: _LSCarry, alpha: float):
        z_a = carry.z + alpha * carry.u
        l, dz = loss.loss_and_dz(z_a, batch.labels)
        phi = torch.sum(batch.weights * l) + 0.5 * l2 * (
            carry.ww + 2.0 * alpha * carry.wp + alpha * alpha * carry.pp
        )
        dphi = torch.sum(batch.weights * dz * carry.u) + l2 * (carry.wp + alpha * carry.pp)
        return phi, dphi

    def margins(w):
        return obj.margins(w, batch)

    def dir_margins(p):
        p_eff, p_shift = obj._effective(p)
        return batch.dot_rows(p_eff) + p_shift

    def ls_prepare_z(z, w, p):
        return _carry(z, dir_margins(p), w, p)

    def ls_advance(carry: _LSCarry, alpha: float):
        return carry.z + alpha * carry.u

    def value_and_grad_at(w, z):
        return obj.value_and_grad_at_margins(w, z, batch)

    hvp = curvature = hvp_at = None
    if loss.has_hessian:
        def hvp(w, v):
            return obj.hessian_vector(w, v, batch)

        def curvature(z):
            return obj.curvature_at_margins(z, batch)

        def hvp_at(d2, v):
            return obj.hessian_vector_with_curvature(d2, v, batch)

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


def lane_adapter(obj: GLMObjective, batch) -> Objective:
    """The batched adapter over a bucket of per-entity problems, a
    ``DenseBatch`` or a ``BlockDiagonalBatch``: coefficients ``[E, K]``,
    values ``[E]``, gradients, Hv and Hessian diagonals ``[E, K]``, margins
    ``[E, R]``, and each lane's sums over its own rows. It carries the
    margin protocol and the second-order fields per lane, and the explicit
    ``[E, K, K]`` Hessians from the bucket's dense designs."""
    loss = obj.loss
    l2 = obj.l2_weight

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
