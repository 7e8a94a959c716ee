"""Bridge from ``GLMObjective`` to the optimizer ``Objective``, including the
margin-space line search.

Counterpart of ``glm_adapter`` in ``photon_ml_tpu/optim/adapter.py``
(:35-171), without the dense ``hessian`` of Newton. Along a direction p the
margins are affine, z(a) = z + a*u with u = X'p computed once per line
search, so each Wolfe trial is O(n) elementwise work on the carried margins
instead of a pass over the nonzeros.
The reference's ``axis_name``/``row_sharding`` (multi-device) arguments are
not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from photon_ml_tpu_torch.ops.objective import GLMObjective
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
