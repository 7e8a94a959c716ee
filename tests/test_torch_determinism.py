"""Scores and metrics of the port repeat bit for bit from call to call.

A random effect's scores are a fixed-order sum of each row's terms, and the
sharded evaluators take their group sums in a fixed order, so neither
depends on the order in which float atomics (``index_add_``) happen to add.
A feature summary takes its sums from the scatter kernel and fixed-order
segment reductions. The CPU tests hold the scores against float64 row sums;
the tests marked ``cuda`` score, evaluate and summarize twice on the card
and compare bit for bit. The
file imports no JAX, so it runs on the card with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_determinism.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.evaluation import sharded_auc, sharded_precision_at_k
from photon_ml_tpu_torch.game import (
    FeatureShard,
    GameConfig,
    GameEstimator,
    RandomEffectConfig,
    build_game_dataset,
)
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)

N_USERS, K = 2_000, 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _fitted(device, n):
    """A per-user random effect over K dense features, fitted on ``device``:
    (model, dataset, the host design, the user codes)."""
    rng = np.random.default_rng(21)
    X = rng.normal(size=(n, K)).astype(np.float32)
    users = rng.integers(0, N_USERS, size=n)
    w = rng.normal(size=(N_USERS, K))
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-np.einsum("ij,ij->i", X, w[users])))) * 1.0
    data = build_game_dataset(y, {"user": FeatureShard.from_dense(X)},
                              id_columns={"userId": users}, device=device)
    opt = OptimizerConfig(optimizer_type=OptimizerType.NEWTON, max_iterations=5,
                          regularization=RegularizationContext(RegularizationType.L2),
                          regularization_weight=1.0)
    config = GameConfig(task="logistic", num_iterations=1, coordinates={
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId", optimizer=opt)})
    model = GameEstimator(config).fit(data, device=device).model
    return model.models["per-user"], data, X, data.id_columns["userId"]


def test_random_effect_scores_are_the_rows_sums():
    re, data, X, idc = _fitted("cpu", 4_000)
    got = re.score(data).numpy()
    coef = np.zeros((len(idc.vocab), K))
    for b in re.buckets:
        codes = np.asarray(b.entity_codes)
        proj = b.projection.numpy()
        for j, code in enumerate(codes):
            keep = proj[j] < K
            coef[code, proj[j][keep]] = b.coefficients.numpy()[j][keep]
    want = np.einsum("ij,ij->i", X.astype(np.float64), coef[idc.codes])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _group_inputs(device, n=200_000, groups=5_000):
    rng = np.random.default_rng(22)
    scores = torch.from_numpy(np.round(rng.normal(size=n), 2).astype(np.float32))  # ties
    labels = torch.from_numpy((rng.random(n) < 0.3).astype(np.float32))
    weights = torch.from_numpy((rng.random(n) + 0.05).astype(np.float32))
    gids = torch.from_numpy(rng.integers(0, groups, size=n))
    return [t.to(device) for t in (scores, labels, weights, gids)], groups


def _on_cpu(re):
    """The random-effect model with its tensors on the CPU."""
    buckets = tuple(dataclasses.replace(b, coefficients=b.coefficients.cpu(),
                                        projection=b.projection.cpu())
                    for b in re.buckets)
    return dataclasses.replace(re, buckets=buckets)


@pytest.mark.cuda
def test_random_effect_scores_repeat_bit_for_bit_on_the_card(cuda):
    re, data, _, _ = _fitted(cuda, 200_000)
    first, again = re.score(data), re.score(data)
    assert torch.equal(first, again)
    cpu = dataclasses.replace(data, device=torch.device("cpu"))
    np.testing.assert_allclose(first.cpu().numpy(), _on_cpu(re).score(cpu).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_sharded_metrics_repeat_bit_for_bit_on_the_card(cuda):
    (scores, labels, weights, gids), groups = _group_inputs(cuda)
    for fn, extra in ((sharded_auc, ()), (sharded_precision_at_k, (5,))):
        first = fn(scores, labels, weights, gids, groups, *extra)
        again = fn(scores, labels, weights, gids, groups, *extra)
        assert torch.equal(first, again)
        on_cpu = fn(*(t.cpu() for t in (scores, labels, weights, gids)), groups, *extra)
        assert abs(float(first) - float(on_cpu)) <= 1e-5


@pytest.mark.cuda
def test_metrics_on_tied_importance_weighted_rows_repeat_bit_for_bit_on_the_card(cuda):
    """1M rows, scores binned to 1,000 values (tie runs of about 1,000 rows)
    and weights log-uniform over [1e-3, 1e3]: ``auc``, ``auc:<col>`` and
    ``precision@5:<col>``, each evaluated twice, agree bit for bit, since no
    running sum or tie sum takes the device's order."""
    from photon_ml_tpu_torch.evaluation import auc

    rng = np.random.default_rng(23)
    n, groups = 1_000_000, 10_000
    scores = np.floor(rng.random(n) * 1_000).astype(np.float32) / 1_000
    labels = (rng.random(n) < 0.3).astype(np.float32)
    weights = (10.0 ** rng.uniform(-3, 3, size=n)).astype(np.float32)
    gids = rng.integers(0, groups, size=n)
    args = [torch.from_numpy(a).to(cuda) for a in (scores, labels, weights, gids)]
    calls = {"auc": lambda: auc(*args[:3]),
             "auc:<col>": lambda: sharded_auc(*args, groups),
             "precision@5:<col>": lambda: sharded_precision_at_k(*args, groups, 5)}
    for name, call in calls.items():
        first, again = call(), call()
        assert torch.equal(first, again), name


@pytest.mark.cuda
def test_summaries_of_a_card_batch_repeat_bit_for_bit_and_match_the_plain_version(cuda):
    """``summarize`` of a CUDA ``CSRBatch`` (explicit zeros, rows of weight
    0) runs the scatter kernel, repeats bit for bit, and agrees with the
    same batch's summary on the CPU (the kernels' plain versions): sums
    within float32 reordering, max, min and counts exactly."""
    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.data.stats import summarize
    from photon_ml_tpu_torch.ops.csr import CSRBatch

    rng = np.random.default_rng(24)
    n, d, k = 200_000, 3_000, 20
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, d, size=n * k)
    vals = rng.normal(size=n * k)
    vals[rng.random(n * k) < 0.01] = 0.0
    weights = (rng.random(n) > 0.1).astype(np.float64)
    args = (vals, rows, cols, np.zeros(n), d)
    gpu = CSRBatch.from_coo(*args, weights=weights, device=cuda)
    cpu = CSRBatch.from_coo(*args, weights=weights, device="cpu")
    before = kernels.LAUNCHES["csc_scatter"]
    first, again = summarize(gpu), summarize(gpu)
    assert kernels.LAUNCHES["csc_scatter"] - before == 6
    plain = summarize(cpu)
    for field in dataclasses.fields(first):
        a, b = getattr(first, field.name), getattr(again, field.name)
        assert torch.equal(a, b), field.name
        want = getattr(plain, field.name).numpy()
        if field.name in ("max", "min", "num_nonzeros", "count"):
            np.testing.assert_array_equal(a.cpu().numpy(), want, err_msg=field.name)
        else:
            np.testing.assert_allclose(a.cpu().numpy(), want, rtol=1e-5, atol=1e-6,
                                       err_msg=field.name)
