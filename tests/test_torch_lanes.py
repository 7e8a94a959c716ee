"""The port's lane solvers (one problem per entity of a random-effect bucket:
``lbfgs_solve_lanes``, ``owlqn_solve_lanes``, ``tron_solve_lanes``) and the
batched NEWTON in a box against the JAX package's solvers under ``vmap``
over the same ``[E, K]`` problems, on the two layouts of a bucket: dense
designs (``DenseBatch``) and the COO layout (the port's
``BlockDiagonalBatch`` against one padded-COO ``SparseBatch`` per entity,
as ``EntityBucket.entity_batch`` gives the reference).

One lane is all padding (weight 0) and stops at once; the others stop at
different iterations. Per lane: the same reason and iteration count, the
final value within rtol 1e-4, the coefficients within atol 1e-3. LBFGS and
OWLQN stop at tolerance 1e-4; TRON and NEWTON at 1e-3, as
tests/test_torch_newton.py does: their quadratic steps bring a lane to the
float32 plateau within a few iterations, and there a lane's last damping or
trust-region decision follows rounding, which the two packages' sums (in
different orders) make differently.

A frozen lane keeps its state bit for bit: a lane that stopped at
iteration t in a long solve has the w, value and gradient of the same solve
cut at max_iterations = t. The host fetches per round of the lanes, never
per lane: a bucket doubled by repeating its lanes makes the same number of
fetches, and each of its halves the reasons and iterations of the bucket
(the coefficients within rtol 1e-6: a batched sum over more lanes may
block its terms differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.dense import DenseBatch as JDense
from photon_ml_tpu.ops.objective import make_objective as j_make
from photon_ml_tpu.ops.sparse import SparseBatch as JSparse
from photon_ml_tpu.optim import glm_adapter as j_adapter
from photon_ml_tpu.optim.common import BoxConstraints as JBox
from photon_ml_tpu.optim.lbfgs import LBFGSConfig as JLBFGSConfig
from photon_ml_tpu.optim.lbfgs import lbfgs_solve as j_lbfgs
from photon_ml_tpu.optim.newton import NewtonConfig as JNewtonConfig
from photon_ml_tpu.optim.newton import newton_solve as j_newton
from photon_ml_tpu.optim.owlqn import owlqn_solve as j_owlqn
from photon_ml_tpu.optim.tron import TRONConfig as JTRONConfig
from photon_ml_tpu.optim.tron import tron_solve as j_tron
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.ops.objective import make_objective as t_make
from photon_ml_tpu_torch.optim import (
    LBFGSConfig,
    NewtonConfig,
    TRONConfig,
    lane_adapter,
    lbfgs_solve_lanes,
    newton_solve,
    owlqn_solve_lanes,
    tron_solve_lanes,
)
from photon_ml_tpu_torch.optim.common import MAX_ITERATIONS, BoxConstraints

E, R, K, NZ = 12, 10, 6, 32
PADDED = 4  # an all-padding lane
L2, L1 = 0.5, 0.3
LO, HI = -0.3, 0.4  # the box of features 0 and 2


def _bucket(seed=5):
    """A bucket of per-entity problems as padded COO (rows sorted, padding
    at row R-1 with value 0) and as its dense designs."""
    rng = np.random.default_rng(seed)
    vals = np.zeros((E, NZ), np.float32)
    rows = np.full((E, NZ), R - 1, np.int32)
    cols = np.zeros((E, NZ), np.int32)
    for e in range(E):
        n = rng.integers(NZ // 2, NZ + 1)
        r = np.sort(rng.integers(0, R - 2, size=n))
        rows[e, :n], cols[e, :n] = r, rng.integers(0, K, size=n)
        vals[e, :n] = rng.normal(size=n)
    x = np.zeros((E, R, K), np.float32)
    np.add.at(x, (np.arange(E)[:, None], rows, cols), vals)
    w_true = rng.normal(size=(E, K))
    z = np.einsum("erk,ek->er", x, w_true)
    y = (rng.random((E, R)) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    off = (rng.normal(size=(E, R)) * 0.1).astype(np.float32)
    wgt = (rng.random((E, R)) + 0.5).astype(np.float32)
    wgt[:, R - 2:] = 0.0  # padded rows
    wgt[PADDED] = 0.0
    return vals, rows, cols, x, y, off, wgt


def _port_batch(layout, seed=5):
    vals, rows, cols, x, y, off, wgt = _bucket(seed)
    if layout == "dense":
        return DenseBatch.from_arrays(x, y, off, wgt, device="cpu")
    return BlockDiagonalBatch.from_bucket(vals, rows, cols, y, off, wgt, K, device="cpu")


def _jax_batches(layout, seed=5):
    """The per-entity reference batches, stacked for vmap."""
    vals, rows, cols, x, y, off, wgt = (jnp.asarray(a) for a in _bucket(seed))
    if layout == "dense":
        return JDense(x=x, labels=y, offsets=off, weights=wgt)
    return JSparse(values=vals, rows=rows, cols=cols, labels=y, offsets=off, weights=wgt,
                   num_features=K)


def _bounds():
    lower = np.full(K, -np.inf, np.float32)
    upper = np.full(K, np.inf, np.float32)
    lower[[0, 2]], upper[[0, 2]] = LO, HI
    return lower, upper


SOLVERS = ["lbfgs", "owlqn", "tron", "lbfgs_box", "newton_box", "tron_box"]


def _reference(solver, layout, max_iterations):
    jo = j_make("logistic", l2_weight=L2)
    name, boxed = solver.split("_")[0], solver.endswith("box")
    tol = 1e-3 if name in ("tron", "newton") else 1e-4
    lower, upper = _bounds()
    box = JBox(lower=jnp.asarray(lower), upper=jnp.asarray(upper)) if boxed else None

    def one(b, w0):
        a = j_adapter(jo, b)
        if name == "lbfgs":
            return j_lbfgs(a, w0, JLBFGSConfig(max_iterations=max_iterations, tolerance=tol),
                           constraints=box)
        if name == "owlqn":
            return j_owlqn(a, w0, L1, JLBFGSConfig(max_iterations=max_iterations,
                                                   tolerance=tol))
        if name == "tron":
            return j_tron(a, w0, JTRONConfig(max_iterations=max_iterations, tolerance=tol),
                          constraints=box)
        return j_newton(a.value_and_grad, a.hessian, w0,
                        JNewtonConfig(max_iterations=max_iterations, tolerance=tol),
                        constraints=box, ls_prepare=a.ls_prepare, ls_eval=a.ls_eval)

    return jax.jit(jax.vmap(one))(_jax_batches(layout), jnp.zeros((E, K), jnp.float32))


def _port(solver, layout, max_iterations, batch=None):
    batch = _port_batch(layout) if batch is None else batch
    n_lanes = batch.labels.shape[0]
    a = lane_adapter(t_make("logistic", l2_weight=L2), batch)
    name, boxed = solver.split("_")[0], solver.endswith("box")
    tol = 1e-3 if name in ("tron", "newton") else 1e-4
    lower, upper = _bounds()
    box = BoxConstraints(torch.from_numpy(lower), torch.from_numpy(upper)) if boxed else None
    w0 = torch.zeros(n_lanes, K)
    if name == "lbfgs":
        return lbfgs_solve_lanes(a, w0, LBFGSConfig(max_iterations=max_iterations,
                                                    tolerance=tol), box, device="cpu")
    if name == "owlqn":
        return owlqn_solve_lanes(a, w0, L1, LBFGSConfig(max_iterations=max_iterations,
                                                        tolerance=tol), device="cpu")
    if name == "tron":
        return tron_solve_lanes(a, w0, TRONConfig(max_iterations=max_iterations,
                                                  tolerance=tol), box, device="cpu")
    return newton_solve(a.value_and_grad, a.hessian, w0, a.ls_prepare, a.ls_eval,
                        NewtonConfig(max_iterations=max_iterations, tolerance=tol),
                        device="cpu", constraints=box, value=a.value)


@pytest.mark.parametrize("layout", ["dense", "coo"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_lane_solver_matches_the_vmapped_reference(solver, layout):
    rj = _reference(solver, layout, 15)
    rt = _port(solver, layout, 15)
    np.testing.assert_array_equal(rt.reason.numpy(), np.asarray(rj.reason))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.value.numpy(), np.asarray(rj.value), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), atol=1e-3)
    np.testing.assert_array_equal(np.asarray(rt.data_passes), np.asarray(rj.data_passes))
    finite = np.isfinite(np.asarray(rj.values))
    np.testing.assert_array_equal(np.isfinite(rt.values.numpy()), finite)
    np.testing.assert_allclose(rt.values.numpy()[finite], np.asarray(rj.values)[finite],
                               rtol=1e-4, atol=1e-6)
    assert rt.iterations[PADDED] <= 1  # the all-padding lane stops at once
    assert len(set(rt.iterations.tolist())) > 1  # lanes froze at different steps
    if solver.endswith("box") and not solver.startswith("tron"):
        lower, upper = _bounds()
        assert np.all(rt.w.numpy() >= lower) and np.all(rt.w.numpy() <= upper)


@pytest.mark.parametrize("solver", ["lbfgs", "tron", "owlqn"])
def test_a_frozen_lane_keeps_its_state_bit_for_bit(solver):
    long = _port(solver, "coo", 25)
    stopped = (long.reason != MAX_ITERATIONS) & (long.iterations > 0)
    checked = 0
    for t in sorted(set(long.iterations[stopped].tolist())):
        cut = _port(solver, "coo", t)
        lanes = stopped & (long.iterations == t)
        for field in ("w", "value", "grad"):
            assert torch.equal(getattr(long, field)[lanes], getattr(cut, field)[lanes])
        checked += int(lanes.sum())
    assert checked >= E // 2


@pytest.mark.parametrize("solver", ["lbfgs", "owlqn", "tron"])
def test_the_host_fetches_per_round_not_per_lane(solver):
    batch = _port_batch("coo")
    telemetry.reset()
    one = _port(solver, "coo", 15, batch)
    syncs = telemetry.snapshot()["counters"]["host_syncs"]
    vals, rows, cols, _, y, off, wgt = _bucket()
    twice = BlockDiagonalBatch.from_bucket(*(np.concatenate([a, a]) for a in (
        vals, rows, cols, y, off, wgt)), K, device="cpu")
    telemetry.reset()
    two = _port(solver, "coo", 15, twice)
    assert telemetry.snapshot()["counters"]["host_syncs"] == syncs
    for half in (slice(0, E), slice(E, 2 * E)):
        assert torch.equal(two.reason[half], one.reason)
        assert torch.equal(two.iterations[half], one.iterations)
        torch.testing.assert_close(two.w[half], one.w, rtol=1e-6, atol=1e-7)
    assert syncs >= int(one.iterations.max())
