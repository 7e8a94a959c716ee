"""The port's data-parallel solves (``photon_ml_tpu_torch/parallel/distributed.py``)
on ``[cpu] * 8`` against the JAX package's on its 8-device CPU mesh
(tests/test_distributed.py), from the same numpy draws:

- the sharded value and gradient (value rtol 1e-5, gradient rtol/atol 1e-4),
  also on 403 rows over 8 shards (the padding rows inert) and under a
  standardization with shifts (the shift's correction on the reduced sums);
- LBFGS, TRON and OWLQN (L1) solves: value rtol 1e-4, w rtol/atol 5e-3;
- the sharded Hessian diagonal and ``train_glm(mesh=...)`` with variances;
- a 1-shard mesh gives the unsharded solve bit for bit, and a sharded solve
  repeats bit for bit (the fixed-order reduction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.objective import make_objective as j_objective
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import OptimizerConfig as JOpt
from photon_ml_tpu.optim import OptimizerType as JOptType
from photon_ml_tpu.optim import RegularizationContext as JReg
from photon_ml_tpu.optim import RegularizationType as JRegType
from photon_ml_tpu.parallel import distributed_solve as j_distributed_solve
from photon_ml_tpu.parallel import distributed_value_and_grad as j_value_and_grad
from photon_ml_tpu.parallel import make_mesh as j_make_mesh
from photon_ml_tpu.parallel import put_sharded as j_put_sharded
from photon_ml_tpu.parallel import shard_rows as j_shard_rows
from photon_ml_tpu.parallel.distributed import (
    distributed_hessian_diagonal as j_hessian_diagonal,
)
from photon_ml_tpu.training import train_glm as j_train_glm
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
    solve,
)
from photon_ml_tpu_torch.parallel import (
    distributed_hessian_diagonal,
    distributed_solve,
    distributed_value_and_grad,
    gspmd_solve,
    make_mesh,
    place_batch,
    shard_rows,
)
from photon_ml_tpu_torch.training import train_glm

CPU = torch.device("cpu")
VG_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_distributed.py:43-59
SOLVE_W_TOL = dict(rtol=5e-3, atol=5e-3)  # :62-75


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return j_make_mesh({"data": 8}), make_mesh({"data": 8}, [CPU] * 8)


def _draw(seed, n=400, d=20):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.3)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ rng.normal(size=d))))).astype(float)
    wt = rng.random(n) + 0.5
    w = rng.normal(size=d) * 0.2
    return X, y, wt, w


def _batches(X, y, wt):
    return JSparse.from_dense(X, y, weights=wt), CSRBatch.from_dense(X, y, weights=wt,
                                                                      device=CPU)


@pytest.mark.parametrize("n", [400, 403], ids=["even", "403_uneven"])
def test_sharded_value_and_grad_matches_the_reference(meshes, n):
    jmesh, tmesh = meshes
    X, y, wt, w = _draw(0, n=n)
    jb, tb = _batches(X, y, wt)
    jv, jg = j_value_and_grad(j_objective("logistic", l2_weight=0.7),
                              jnp.asarray(w, jnp.float32),
                              j_put_sharded(j_shard_rows(jb, 8), jmesh), jmesh)
    tv, tg = distributed_value_and_grad(make_objective("logistic", l2_weight=0.7),
                                        torch.tensor(w, dtype=torch.float32),
                                        place_batch(tb, tmesh), tmesh)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **VG_TOL)


def test_sharded_normalized_value_grad_and_hessian_diagonal(meshes):
    """Shifts enter the margins and the gradient's correction reads the
    reduced row total; the diagonal's shift terms too."""
    jmesh, tmesh = meshes
    X, y, wt, w = _draw(1, n=403)
    jb, tb = _batches(X, y, wt)
    rng = np.random.default_rng(11)
    factors = (rng.random(X.shape[1]) + 0.5).astype(np.float32)
    shifts = rng.normal(size=X.shape[1]).astype(np.float32) * 0.1
    jobj = j_objective("logistic", l2_weight=0.3, factors=jnp.asarray(factors),
                       shifts=jnp.asarray(shifts))
    tobj = make_objective("logistic", l2_weight=0.3, factors=torch.from_numpy(factors),
                          shifts=torch.from_numpy(shifts))
    jstacked = j_put_sharded(j_shard_rows(jb, 8), jmesh)
    tplaced = place_batch(tb, tmesh)
    wj, wt_ = jnp.asarray(w, jnp.float32), torch.tensor(w, dtype=torch.float32)
    jv, jg = j_value_and_grad(jobj, wj, jstacked, jmesh)
    tv, tg = distributed_value_and_grad(tobj, wt_, tplaced, tmesh)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **VG_TOL)
    np.testing.assert_allclose(
        distributed_hessian_diagonal(tobj, wt_, tplaced, tmesh).numpy(),
        np.asarray(j_hessian_diagonal(jobj, wj, jstacked, jmesh)), **VG_TOL)


def _configs(opt, reg, max_iterations=50):
    kw = dict(regularization_weight=1.0, max_iterations=max_iterations)
    return (JOpt(optimizer_type=JOptType[opt], regularization=JReg(JRegType[reg]), **kw),
            OptimizerConfig(optimizer_type=OptimizerType[opt],
                            regularization=RegularizationContext(RegularizationType[reg]), **kw))


SOLVES = [("LBFGS", "L2"), ("TRON", "L2"), ("LBFGS", "L1")]


@pytest.mark.parametrize("opt,reg", SOLVES)
def test_distributed_solve_matches_the_reference(meshes, opt, reg):
    jmesh, tmesh = meshes
    X, y, wt, _ = _draw(2)
    jb, tb = _batches(X, y, wt)
    jcfg, tcfg = _configs(opt, reg)
    d = X.shape[1]
    jres = j_distributed_solve("logistic", j_put_sharded(j_shard_rows(jb, 8), jmesh), jcfg,
                               jnp.zeros(d, jnp.float32), jmesh)
    tres = distributed_solve("logistic", shard_rows(tb, 8), tcfg, torch.zeros(d), tmesh)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=1e-4)
    np.testing.assert_allclose(tres.w.numpy(), np.asarray(jres.w), **SOLVE_W_TOL)


@pytest.mark.parametrize("opt,reg", SOLVES)
def test_one_shard_is_the_unsharded_solve_and_a_mesh_repeats(opt, reg):
    X, y, wt, _ = _draw(3, n=403)
    _, tb = _batches(X, y, wt)
    _, tcfg = _configs(opt, reg, max_iterations=15)
    w0 = torch.zeros(X.shape[1])
    plain = solve("logistic", tb, tcfg, w0, device=CPU)
    one = gspmd_solve("logistic", tb, tcfg, w0, make_mesh({"batch": 1}, [CPU]))
    assert torch.equal(one.w, plain.w) and torch.equal(one.value, plain.value)
    assert (one.iterations, one.reason) == (plain.iterations, plain.reason)
    mesh = make_mesh({"batch": 8}, [CPU] * 8)
    placed = place_batch(tb, mesh)
    first, again = (gspmd_solve("logistic", placed, tcfg, w0, mesh) for _ in range(2))
    assert torch.equal(first.w, again.w) and first.iterations == again.iterations


def test_train_glm_on_a_mesh_matches_the_reference_with_variances(meshes):
    jmesh, tmesh = meshes
    X, y, wt, _ = _draw(4, n=403)
    jb, tb = _batches(X, y, wt)
    jcfg, tcfg = _configs("LBFGS", "L2")
    lambdas = [10.0, 1.0]
    jout = j_train_glm(j_put_sharded(j_shard_rows(jb, 8), jmesh), "logistic", lambdas, jcfg,
                       compute_variances=True, mesh=jmesh)
    tout = train_glm(tb, "logistic", lambdas, tcfg, compute_variances=True, mesh=tmesh)
    plain = train_glm(tb, "logistic", lambdas, tcfg, compute_variances=True, device=CPU)
    one = train_glm(tb, "logistic", lambdas, tcfg, compute_variances=True,
                    mesh=make_mesh({"data": 1}, [CPU]))
    for je, te, pe, oe in zip(jout, tout, plain, one):
        assert te.reg_weight == je.reg_weight
        np.testing.assert_allclose(te.model.coefficients.means.numpy(),
                                   np.asarray(je.model.coefficients.means), **SOLVE_W_TOL)
        np.testing.assert_allclose(te.model.coefficients.variances.numpy(),
                                   np.asarray(je.model.coefficients.variances), rtol=1e-3)
        assert torch.equal(oe.model.coefficients.means, pe.model.coefficients.means)
        assert torch.equal(oe.model.coefficients.variances, pe.model.coefficients.variances)
