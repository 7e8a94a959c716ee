"""Scores and metrics of the port repeat bit for bit from call to call.

A random effect's scores are a fixed-order sum of each row's terms, and the
sharded evaluators take their group sums in a fixed order, so neither
depends on the order in which float atomics (``index_add_``) happen to add.
The CPU tests hold the scores against float64 row sums; the tests marked
``cuda`` score and evaluate twice on the card and compare bit for bit. The
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
