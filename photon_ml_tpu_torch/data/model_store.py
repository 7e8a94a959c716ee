"""Model persistence: save and load GLM and GAME models, and score a saved
GAME model.

Counterpart of ``photon_ml_tpu/data/model_store.py`` (:49-418), with the
same files, so a model saved by either package loads in the other:

    model_dir/
      model-metadata.json               format_version, model_type, task,
                                        coordinate specs and order, extras
      coefficients.npz                  a GLM: means (+ variances), float32
      fixed-effect/<name>/coefficients.npz
      random-effect/<name>/model.npz    per bucket: coefficients_i (f32),
                                        projection_i (i32, sentinel =
                                        num_global), entity_codes_i (i32),
                                        variances_i; entity_bucket,
                                        entity_pos (i32) and vocab
      factored-random-effect/<name>/model.npz
                                        projection (f32 [K, d]), latent
                                        (f32 [n_flat, K]), entity_flat
                                        (i64), vocab
      matrix-factorization/<name>/model.npz
                                        row_factors, col_factors (f32),
                                        row_vocab, col_vocab

Loads read every array with ``allow_pickle=False``: a vocabulary of string
ids is saved as a fixed-width unicode array. Loaded coefficients are
tensors on ``device`` (default cuda); a random effect's projections become
int64 tensors, its entity codes and lookup tables stay host numpy, as the
port's ``RandomEffectModel`` holds them; so do a factored model's
``entity_flat`` and the vocabularies. Every load failure is a ``ModelLoadError`` that names the offending path.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.data.projection import ProjectionMatrix
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.game.factored import (
    FactoredRandomEffectModel,
    MatrixFactorizationModel,
)
from photon_ml_tpu_torch.game.models import (
    FixedEffectModel,
    GameModel,
    RandomEffectBucketModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.utils.atomic import atomic_write_json, atomic_write_npz

_METADATA_FILE = "model-metadata.json"
_FORMAT_VERSION = 1


class ModelLoadError(ValueError):
    """A model directory failed to load; the message names the offending
    path and what was wrong (a missing file, a truncated npz, a missing
    array key, an unsupported format_version)."""

    def __init__(self, path: str, message: str):
        super().__init__(f"{path}: {message}")
        self.path = path


def _host(t, dtype) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype)


def _vocab(vocab) -> np.ndarray:
    """The vocabulary as an array that loads without pickle (an object
    array of ids becomes the array numpy infers from the ids)."""
    vocab = np.asarray(vocab)
    return np.array(vocab.tolist()) if vocab.dtype == object else vocab


def _write_json(path: str, obj) -> None:
    atomic_write_json(path, obj, indent=2, sort_keys=True)


def _read_metadata(model_dir: str, expected_type: str) -> dict:
    path = os.path.join(model_dir, _METADATA_FILE)
    try:
        with open(path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise ModelLoadError(path, "missing metadata file") from None
    except json.JSONDecodeError as e:
        raise ModelLoadError(path, f"corrupt metadata JSON ({e})") from None
    version = meta.get("format_version")
    if version != _FORMAT_VERSION:
        raise ModelLoadError(path, f"unsupported format_version {version!r} "
                                   f"(this build reads version {_FORMAT_VERSION})")
    if meta.get("model_type") != expected_type:
        raise ModelLoadError(path, f"does not contain a {expected_type.upper()} model")
    return meta


class _NpzReader:
    """npz access where a missing or corrupt array raises ModelLoadError
    with the path."""

    def __init__(self, z, path: str):
        self._z = z
        self._path = path

    def __contains__(self, key: str) -> bool:
        return key in self._z

    def __getitem__(self, key: str) -> np.ndarray:
        try:
            return self._z[key]
        except KeyError:
            raise ModelLoadError(self._path, f"missing array key '{key}'") from None
        except (zipfile.BadZipFile, OSError, ValueError) as e:
            raise ModelLoadError(self._path, f"corrupt array '{key}' ({e})") from None


class _open_npz:
    """``np.load`` (no pickle) with load failures mapped to ModelLoadError."""

    def __init__(self, path: str):
        self._path = path

    def __enter__(self) -> _NpzReader:
        try:
            self._z = np.load(self._path, allow_pickle=False)
        except FileNotFoundError:
            raise ModelLoadError(self._path, "missing array file") from None
        except (zipfile.BadZipFile, OSError, ValueError) as e:
            raise ModelLoadError(self._path, f"corrupt npz ({e})") from None
        return _NpzReader(self._z, self._path)

    def __exit__(self, *exc):
        self._z.close()
        return False


def _tensor(a: np.ndarray, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)


# -- a single GLM -------------------------------------------------------------


def save_glm(model: GeneralizedLinearModel, path: str) -> None:
    """One GLM: its coefficients (and variances) next to the metadata."""
    os.makedirs(path, exist_ok=True)
    arrays = {"means": _host(model.coefficients.means, np.float32)}
    if model.coefficients.variances is not None:
        arrays["variances"] = _host(model.coefficients.variances, np.float32)
    atomic_write_npz(os.path.join(path, "coefficients.npz"), **arrays)
    _write_json(os.path.join(path, _METADATA_FILE),
                {"format_version": _FORMAT_VERSION, "model_type": "glm", "task": model.task})


def load_glm(path: str, device: torch.device | str | None = None) -> GeneralizedLinearModel:
    """A saved GLM with its tensors on ``device`` (default cuda)."""
    dev = resolve_device(device)
    meta = _read_metadata(path, "glm")
    with _open_npz(os.path.join(path, "coefficients.npz")) as z:
        means = _tensor(z["means"], dev)
        variances = _tensor(z["variances"], dev) if "variances" in z else None
    return GeneralizedLinearModel(coefficients=Coefficients(means=means, variances=variances),
                                  task=meta["task"])


# -- GAME models ----------------------------------------------------------------


def _save_fixed_effect(model: FixedEffectModel, path: str) -> dict:
    os.makedirs(path, exist_ok=True)
    coefficients = _host(model.coefficients, np.float32)
    atomic_write_npz(os.path.join(path, "coefficients.npz"), coefficients=coefficients)
    return {"type": "fixed_effect", "shard_name": model.shard_name,
            "num_features": int(coefficients.shape[0])}


def _load_fixed_effect(path: str, spec: dict, dev: torch.device) -> FixedEffectModel:
    with _open_npz(os.path.join(path, "coefficients.npz")) as z:
        coefficients = _tensor(z["coefficients"], dev)
    return FixedEffectModel(coefficients=coefficients, shard_name=spec["shard_name"])


def _save_random_effect(model: RandomEffectModel, path: str) -> dict:
    os.makedirs(path, exist_ok=True)
    arrays = {
        "entity_bucket": _host(model.entity_bucket, np.int32),
        "entity_pos": _host(model.entity_pos, np.int32),
        "vocab": _vocab(model.vocab),
    }
    for i, bm in enumerate(model.buckets):
        arrays[f"coefficients_{i}"] = _host(bm.coefficients, np.float32)
        arrays[f"projection_{i}"] = _host(bm.projection, np.int32)
        arrays[f"entity_codes_{i}"] = _host(bm.entity_codes, np.int32)
        if bm.variances is not None:
            arrays[f"variances_{i}"] = _host(bm.variances, np.float32)
    atomic_write_npz(os.path.join(path, "model.npz"), **arrays)
    return {"type": "random_effect", "shard_name": model.shard_name, "id_name": model.id_name,
            "num_buckets": len(model.buckets), "num_entities": int(len(model.vocab))}


def _load_random_effect(path: str, spec: dict, dev: torch.device) -> RandomEffectModel:
    with _open_npz(os.path.join(path, "model.npz")) as z:
        buckets = tuple(
            RandomEffectBucketModel(
                coefficients=_tensor(z[f"coefficients_{i}"], dev),
                projection=_tensor(z[f"projection_{i}"], dev, torch.int64),
                entity_codes=np.asarray(z[f"entity_codes_{i}"], np.int32),
                variances=(_tensor(z[f"variances_{i}"], dev)
                           if f"variances_{i}" in z else None),
            )
            for i in range(spec["num_buckets"])
        )
        return RandomEffectModel(id_name=spec["id_name"], shard_name=spec["shard_name"],
                                 buckets=buckets, entity_bucket=z["entity_bucket"],
                                 entity_pos=z["entity_pos"], vocab=z["vocab"])


def _save_factored_random_effect(model: FactoredRandomEffectModel, path: str) -> dict:
    os.makedirs(path, exist_ok=True)
    atomic_write_npz(os.path.join(path, "model.npz"),
                     projection=_host(model.projection.matrix, np.float32),
                     latent=_host(model.latent, np.float32),
                     entity_flat=_host(model.entity_flat, np.int64),
                     vocab=_vocab(model.vocab))
    return {"type": "factored_random_effect", "shard_name": model.shard_name,
            "id_name": model.id_name, "latent_dim": int(model.latent_dim),
            "num_entities": int(len(model.vocab))}


def _load_factored_random_effect(path: str, spec: dict,
                                 dev: torch.device) -> FactoredRandomEffectModel:
    with _open_npz(os.path.join(path, "model.npz")) as z:
        return FactoredRandomEffectModel(
            id_name=spec["id_name"], shard_name=spec["shard_name"],
            projection=ProjectionMatrix(matrix=_tensor(z["projection"], dev)),
            latent=_tensor(z["latent"], dev), entity_flat=np.asarray(z["entity_flat"], np.int64),
            vocab=z["vocab"])


def _save_matrix_factorization(model: MatrixFactorizationModel, path: str) -> dict:
    os.makedirs(path, exist_ok=True)
    atomic_write_npz(os.path.join(path, "model.npz"),
                     row_factors=_host(model.row_factors, np.float32),
                     col_factors=_host(model.col_factors, np.float32),
                     row_vocab=_vocab(model.row_vocab), col_vocab=_vocab(model.col_vocab))
    return {"type": "matrix_factorization", "row_effect": model.row_effect,
            "col_effect": model.col_effect,
            "num_latent_factors": int(model.num_latent_factors)}


def _load_matrix_factorization(path: str, spec: dict,
                               dev: torch.device) -> MatrixFactorizationModel:
    with _open_npz(os.path.join(path, "model.npz")) as z:
        return MatrixFactorizationModel(
            row_effect=spec["row_effect"], col_effect=spec["col_effect"],
            row_factors=_tensor(z["row_factors"], dev), col_factors=_tensor(z["col_factors"], dev),
            row_vocab=z["row_vocab"], col_vocab=z["col_vocab"])


# the coordinate types: (model class, subdirectory, saver, loader)
_COORDINATE_TYPES = {
    "fixed_effect": (FixedEffectModel, "fixed-effect", _save_fixed_effect,
                     _load_fixed_effect),
    "random_effect": (RandomEffectModel, "random-effect", _save_random_effect,
                      _load_random_effect),
    "factored_random_effect": (FactoredRandomEffectModel, "factored-random-effect",
                               _save_factored_random_effect, _load_factored_random_effect),
    "matrix_factorization": (MatrixFactorizationModel, "matrix-factorization",
                             _save_matrix_factorization, _load_matrix_factorization),
}


def save_game_model(model: GameModel, path: str, extra_metadata: Optional[dict] = None) -> None:
    """One subdirectory per coordinate, then the metadata; ``extra_metadata``
    (for example the configs that produced the model) round-trips under
    "extra"."""
    os.makedirs(path, exist_ok=True)
    coords = {}
    for name, sub in model.models.items():
        kind = next((v for v in _COORDINATE_TYPES.values() if isinstance(sub, v[0])), None)
        if kind is None:
            raise TypeError(f"coordinate '{name}': cannot persist {type(sub).__name__}")
        _cls, subdir, saver, _loader = kind
        coords[name] = saver(sub, os.path.join(path, subdir, name))
    _write_json(os.path.join(path, _METADATA_FILE), {
        "format_version": _FORMAT_VERSION,
        "model_type": "game",
        "task": model.task,
        "coordinates": coords,
        "coordinate_order": list(model.models.keys()),
        "extra": extra_metadata or {},
    })


def load_game_model(path: str, device: torch.device | str | None = None) -> GameModel:
    """A saved GAME model with its tensors on ``device`` (default cuda)."""
    dev = resolve_device(device)
    meta = _read_metadata(path, "game")
    meta_path = os.path.join(path, _METADATA_FILE)
    if "coordinate_order" not in meta:
        raise ModelLoadError(meta_path, "missing coordinate_order")
    models = {}
    for name in meta["coordinate_order"]:
        spec = meta.get("coordinates", {}).get(name)
        if spec is None:
            raise ModelLoadError(meta_path, f"coordinate '{name}' listed but not described")
        if spec["type"] not in _COORDINATE_TYPES:
            raise ValueError(f"unknown coordinate type '{spec['type']}'")
        _cls, subdir, _saver, loader = _COORDINATE_TYPES[spec["type"]]
        models[name] = loader(os.path.join(path, subdir, name), spec, dev)
    return GameModel(task=meta["task"], models=models)


def load_game_model_metadata(path: str) -> dict:
    with open(os.path.join(path, _METADATA_FILE)) as f:
        return json.load(f)


def load_feature_index_maps(model_dir: str) -> Optional[dict]:
    """The per-shard ``IndexMap``s under ``<model_dir>/feature-indexes/``,
    or None when that directory is absent."""
    idx_dir = os.path.join(model_dir, "feature-indexes")
    if not os.path.isdir(idx_dir):
        return None
    return {shard: IndexMap.load(os.path.join(idx_dir, shard))
            for shard in sorted(os.listdir(idx_dir))}


def score_game_dataset(model_dir: str, data: GameDataset) -> np.ndarray:
    """Load a saved GAME model onto the dataset's device and score every row
    (the sum of the sub-models' margins) as host numpy; entities unseen in
    training contribute 0."""
    model = load_game_model(model_dir, device=data.device)
    return model.score(data).cpu().numpy()
