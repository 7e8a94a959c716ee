"""Synthetic data generators for tests, benchmarks and examples.

Counterpart of ``photon_ml_tpu/testing.py``: the same numpy draws in the
same order from the same seed, so both packages' generators give the same
arrays bit for bit; the batches and datasets are the port's types
(``CSRBatch``, ``GameDataset``) on an explicit ``device`` (default cuda,
as every entry point of the port).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.dataset import FeatureShard, GameDataset, build_game_dataset
from photon_ml_tpu_torch.ops.csr import CSRBatch

__all__ = [
    "GLMProblem",
    "generate_glm_problem",
    "generate_game_dataset",
    "generate_low_rank_game_dataset",
    "write_libsvm",
]


@dataclasses.dataclass
class GLMProblem:
    """A generated GLM problem with its ground truth."""

    X: np.ndarray
    y: np.ndarray
    w_true: np.ndarray
    batch: CSRBatch


def generate_glm_problem(
    task: str = "logistic",
    n: int = 500,
    d: int = 10,
    density: float = 1.0,
    noise: float = 0.1,
    intercept: bool = False,
    weights: Optional[np.ndarray] = None,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> GLMProblem:
    """Labels drawn from the planted model, so optimizers do real work."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    if density < 1.0:
        X *= rng.random((n, d)) < density
    if intercept:
        X[:, 0] = 1.0
    w = rng.normal(size=d)
    z = X @ w
    if task == "logistic" or task == "smoothed_hinge":
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    elif task == "squared":
        y = z + noise * rng.normal(size=n)
    elif task == "poisson":
        y = rng.poisson(np.exp(np.clip(0.3 * z, -3, 3))).astype(np.float64)
        w = 0.3 * w
    else:
        raise ValueError(f"unknown task '{task}'")
    batch = CSRBatch.from_dense(X, y, weights=weights, device=device)
    return GLMProblem(X=X, y=y, w_true=w, batch=batch)


def generate_game_dataset(
    task: str = "logistic",
    n_users: int = 20,
    rows_per_user: int = 15,
    fe_dim: int = 10,
    re_dim: int = 4,
    noise: float = 0.1,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> tuple[GameDataset, dict]:
    """A GLMix problem: a global FE shard and a per-user RE shard with
    planted global and per-user coefficients. Returns (dataset, truth)."""
    rng = np.random.default_rng(seed)
    n = n_users * rows_per_user
    users = np.repeat(np.arange(n_users), rows_per_user)
    Xg = rng.normal(size=(n, fe_dim))
    Xu = rng.normal(size=(n, re_dim))
    w_global = rng.normal(size=fe_dim)
    w_users = rng.normal(size=(n_users, re_dim))
    z = Xg @ w_global + np.einsum("nd,nd->n", Xu, w_users[users])
    if task == "logistic":
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    elif task == "squared":
        y = z + noise * rng.normal(size=n)
    else:
        raise ValueError(f"unknown task '{task}' (logistic|squared)")
    data = build_game_dataset(
        response=y,
        feature_shards={"global": FeatureShard.from_dense(Xg),
                        "user": FeatureShard.from_dense(Xu)},
        id_columns={"userId": users},
        device=device,
    )
    truth = {"w_global": w_global, "w_users": w_users, "users": users,
             "Xg": Xg, "Xu": Xu, "z": z}
    return data, truth


def generate_low_rank_game_dataset(
    n_users: int = 40,
    rows_per_user: int = 20,
    d: int = 30,
    latent_dim: int = 2,
    noise: float = 0.05,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> tuple[GameDataset, dict]:
    """Per-user coefficients in a shared latent subspace (w_u = B^T z_u):
    the factored random effect's ground truth."""
    rng = np.random.default_rng(seed)
    n = n_users * rows_per_user
    users = np.repeat(np.arange(n_users), rows_per_user)
    X = rng.normal(size=(n, d))
    B = rng.normal(size=(latent_dim, d)) / np.sqrt(d)
    Z = rng.normal(size=(n_users, latent_dim)) * 2.0
    W = Z @ B
    y = np.einsum("nd,nd->n", X, W[users]) + noise * rng.normal(size=n)
    data = build_game_dataset(
        response=y,
        feature_shards={"feats": FeatureShard.from_dense(X)},
        id_columns={"userId": users},
        device=device,
    )
    return data, {"B": B, "Z": Z, "W": W, "users": users, "X": X}


def write_libsvm(path: str, X: np.ndarray, y: np.ndarray) -> str:
    """Write (X, y) as LibSVM text (1-based feature ids, zero entries
    skipped)."""
    lines = []
    for i in range(len(y)):
        feats = " ".join(f"{j + 1}:{X[i, j]:.6f}" for j in np.nonzero(X[i])[0])
        lines.append(f"{int(y[i])} {feats}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
