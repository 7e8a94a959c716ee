"""The control and the faults: the timed path broken on purpose, to show
that the check fails it.

``install(session, mode)`` puts a broken entry in the program's place for
the session's next calls and returns a function that puts the program
back. The modes:

- ``control``: the plain reference in the program's place at the next
  precision down from the configuration's float32 that changes its
  arithmetic: bfloat16, the plain L-BFGS;
- ``unchanged``: the fit returns its starting state (zero coefficients and
  the objective there);
- ``half_batch``: the fit sees the first half of the rows and scales its
  objective by two (the mean taken over the rest);
- ``altered``: the answer's largest coefficient negated where it is
  produced.
"""

from __future__ import annotations

import math
import types

import torch

from benchmark.reference import glm as ref_glm
from benchmark.reference.lbfgs import lbfgs

MODES = ("control", "unchanged", "half_batch", "altered")


def _half(batch):
    """The first half of a batch's rows, built on its card."""
    from photon_ml_tpu_torch.ops.csr import CSRBatch

    h = batch.num_rows // 2
    nnz = int(batch.row_ptr[h])
    return CSRBatch.from_device_csr(batch.row_ptr[:h + 1], batch.cols[:nnz],
                                    batch.vals[:nnz], batch.labels[:h], batch.num_features)


def _entry(w, value, passes=0):
    res = types.SimpleNamespace(value=value, data_passes=passes)
    return types.SimpleNamespace(model=types.SimpleNamespace(
        coefficients=types.SimpleNamespace(means=w)), result=res)


def _negate_largest(w):
    w = w.clone()
    i = int(w.abs().argmax())
    w[i] = -w[i]
    return w


def _glm(session, mode):
    real = session.training.train_glm
    cache = {}

    def train_glm(batch, task, lambdas, opt, **kw):
        if mode == "control":
            out = []
            for lam in lambdas:
                l2 = opt.regularization.l2_weight(lam)

                def vg(w):
                    return ref_glm.value_grad(session.shards, w, l2, dtype=torch.bfloat16)

                w0 = torch.zeros(batch.num_features, dtype=torch.bfloat16,
                                 device=session.device)
                w, f, passes = lbfgs(vg, w0, opt.max_iterations, opt.lbfgs_history)
                out.append(_entry(w.float(), f.float(), passes))
            return out
        if mode == "half_batch":
            if "half" not in cache:
                cache["half"] = _half(batch)
            return [_entry(e.model.coefficients.means, 2 * e.result.value, e.result.data_passes)
                    for e in real(cache["half"], task, lambdas, opt, **kw)]
        entries = real(batch, task, lambdas, opt, **kw)
        if mode == "unchanged":
            return [_entry(torch.zeros_like(e.model.coefficients.means), e.result.values[0])
                    for e in entries]
        if mode == "altered":
            return [_entry(_negate_largest(e.model.coefficients.means), e.result.value,
                           e.result.data_passes) for e in entries]
        raise ValueError(mode)

    session.training = types.SimpleNamespace(train_glm=train_glm)

    def restore():
        session.training = types.SimpleNamespace(train_glm=real)
    return restore


def _sweep(session, mode):
    real = session.runner.sweep_glm
    cache = {}
    lambdas = list(session.lambdas)

    def sweep_glm(batch, task, lams, opt, **kw):
        if mode == "control":
            W, values = [], []
            for lam in lams:
                l2 = opt.regularization.l2_weight(lam)

                def vg(w):
                    return ref_glm.value_grad(session.shards, w, l2, dtype=torch.bfloat16)

                w0 = torch.zeros(batch.num_features, dtype=torch.bfloat16,
                                 device=session.device)
                w, f, _ = lbfgs(vg, w0, opt.max_iterations, opt.lbfgs_history)
                W.append(w.float())
                values.append(f.float())
            return types.SimpleNamespace(w=torch.stack(W), values=torch.stack(values),
                                         data_passes=[0])
        if mode == "half_batch":
            if "half" not in cache:
                cache["half"] = _half(batch)
            res = real(cache["half"], task, lams, opt, **kw)
            return types.SimpleNamespace(w=res.w, values=2 * res.values,
                                         data_passes=res.data_passes)
        res = real(batch, task, lams, opt, **kw)
        if mode == "unchanged":
            at_zero = batch.num_rows * math.log(2.0)
            return types.SimpleNamespace(w=torch.zeros_like(res.w),
                                         values=torch.full_like(res.values, at_zero),
                                         data_passes=res.data_passes)
        if mode == "altered":
            w = res.w.clone()
            g = w.shape[0] // 2
            w[g] = _negate_largest(w[g])
            return types.SimpleNamespace(w=w, values=res.values, data_passes=res.data_passes)
        raise ValueError(mode)

    if mode == "control":
        # three lanes, the ends and the middle of the grid, keep its cost down
        g = len(lambdas)
        session.lambdas = [lambdas[0], lambdas[g // 2], lambdas[-1]]
    session.runner = types.SimpleNamespace(sweep_glm=sweep_glm)

    def restore():
        session.runner = types.SimpleNamespace(sweep_glm=real)
        session.lambdas = lambdas
    return restore


def install(session, mode: str):
    """Break the session's entry in ``mode``; returns the undo."""
    from benchmark.drivers.sweep_glm import SweepSession

    if isinstance(session, SweepSession):
        return _sweep(session, mode)
    return _glm(session, mode)
