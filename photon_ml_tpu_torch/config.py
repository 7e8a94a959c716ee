"""JSON config parsing: the typed GAME config from one JSON document.

Counterpart of ``photon_ml_tpu/config.py:41-187``: the optimizer mini-DSL
(``maxIter,tolerance,regWeight,downSamplingRate,optimizerType,regType
[,alpha]``), the JSON optimizer object, one coordinate object per
coordinate (the JSON object order of ``coordinates`` is the updating
sequence) and ``game_config_to_json``, its inverse, which is what a saved
model's metadata holds. Unknown or malformed keys raise ``ValueError``, as
in the reference.

The port builds its own ``GameConfig``, ``FixedEffectConfig``,
``RandomEffectConfig``, ``FactoredRandomEffectConfig`` and
``OptimizerConfig``; a ``factored_random_effect`` coordinate's ``optimizer``
is its per-entity optimizer. A fixed effect's ``layout`` key is checked
against the reference's values and selects nothing: the port has one
fixed-effect layout, the CSR batch with its tile index.
"""

from __future__ import annotations

import json
from typing import Mapping, Optional

from photon_ml_tpu_torch.game.estimator import (
    FactoredRandomEffectConfig,
    FixedEffectConfig,
    GameConfig,
    RandomEffectConfig,
    _config_metadata,
)
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)

_REG_TYPE_ALIASES = {
    "none": "none",
    "l1": "l1",
    "l2": "l2",
    "elastic_net": "elastic_net",
    "elasticnet": "elastic_net",
}
_FE_LAYOUTS = ("auto", "tiled", "coo")


def parse_optimizer_config_string(spec: str) -> OptimizerConfig:
    """The reference's comma-separated optimizer DSL; a trailing alpha is
    allowed for elastic net only."""
    parts = [p.strip() for p in spec.split(",")]
    if len(parts) not in (6, 7):
        raise ValueError(
            f"bad optimizer config string '{spec}': expected "
            "'maxIter,tol,lambda,downSamplingRate,optimizerType,regularizationType[,alpha]'")
    max_iter, tol, lam, ds_rate = parts[:4]
    try:
        opt_type = OptimizerType(parts[4].lower())
    except ValueError:
        raise ValueError(f"unknown optimizer type '{parts[4]}'") from None
    reg_name = parts[5].lower()
    if reg_name not in _REG_TYPE_ALIASES:
        raise ValueError(f"unknown regularization type '{parts[5]}'")
    reg_type = RegularizationType(_REG_TYPE_ALIASES[reg_name])
    if len(parts) == 7 and reg_type != RegularizationType.ELASTIC_NET:
        raise ValueError(f"alpha ('{parts[6]}') only applies to elastic_net, not '{parts[5]}'")
    alpha = float(parts[6]) if len(parts) == 7 else 1.0
    return OptimizerConfig(
        optimizer_type=opt_type,
        max_iterations=int(max_iter),
        tolerance=float(tol),
        regularization=RegularizationContext(reg_type, alpha=alpha),
        regularization_weight=float(lam),
        down_sampling_rate=float(ds_rate),
    )


def _parse_constraints(triples):
    # [[index, lower|null, upper|null], ...]
    out = []
    for idx, lo, hi in triples:
        out.append((int(idx), float("-inf") if lo is None else float(lo),
                    float("inf") if hi is None else float(hi)))
    return tuple(out) or None


_OPTIMIZER_KEYS = {
    "type": ("optimizer_type", OptimizerType),
    "max_iterations": ("max_iterations", int),
    "tolerance": ("tolerance", float),
    "regularization_weight": ("regularization_weight", float),
    "lbfgs_history": ("lbfgs_history", int),
    "down_sampling_rate": ("down_sampling_rate", float),
    "box_constraints": ("box_constraints", _parse_constraints),
}


def parse_optimizer_config(obj: Optional[Mapping | str]) -> OptimizerConfig:
    """The JSON optimizer object; a plain string goes through the DSL."""
    if isinstance(obj, str):
        return parse_optimizer_config_string(obj)
    obj = dict(obj or {})
    reg = RegularizationContext(RegularizationType(obj.pop("regularization", "none")),
                                alpha=float(obj.pop("alpha", 1.0)))
    kwargs = {field: conv(obj.pop(key))
              for key, (field, conv) in _OPTIMIZER_KEYS.items() if key in obj}
    if obj:
        raise ValueError(f"unknown optimizer config keys: {sorted(obj)}")
    return OptimizerConfig(regularization=reg, **kwargs)


def parse_coordinate_config(obj: Mapping):
    obj = dict(obj)
    ctype = obj.pop("type", "fixed_effect")
    if ctype == "fixed_effect":
        out = FixedEffectConfig(
            shard_name=obj.pop("shard_name"),
            optimizer=parse_optimizer_config(obj.pop("optimizer", None)),
            normalization=obj.pop("normalization", "none"),
            intercept_index=obj.pop("intercept_index", None),
            down_sampling_seed=int(obj.pop("down_sampling_seed", 0)),
        )
        layout = obj.pop("layout", "auto")
        if layout not in _FE_LAYOUTS:
            raise ValueError(f"unknown layout '{layout}'")
    elif ctype == "random_effect":
        ratio = obj.pop("features_to_samples_ratio", None)
        out = RandomEffectConfig(
            shard_name=obj.pop("shard_name"),
            id_name=obj.pop("id_name"),
            optimizer=parse_optimizer_config(obj.pop("optimizer", None)),
            active_rows_per_entity=obj.pop("active_rows_per_entity", None),
            min_rows_per_entity=int(obj.pop("min_rows_per_entity", 1)),
            features_to_samples_ratio=None if ratio is None else float(ratio),
            projector=obj.pop("projector", "index_map"),
            projected_dim=obj.pop("projected_dim", None),
            projection_seed=int(obj.pop("projection_seed", 0)),
            projection_intercept_index=obj.pop("projection_intercept_index", None),
            compute_variances=bool(obj.pop("compute_variances", False)),
        )
    elif ctype == "factored_random_effect":
        out = FactoredRandomEffectConfig(
            shard_name=obj.pop("shard_name"),
            id_name=obj.pop("id_name"),
            latent_dim=int(obj.pop("latent_dim")),
            mf_iterations=int(obj.pop("mf_iterations", 1)),
            re_optimizer=parse_optimizer_config(obj.pop("optimizer", None)),
            latent_optimizer=parse_optimizer_config(obj.pop("latent_optimizer", None)),
            active_rows_per_entity=obj.pop("active_rows_per_entity", None),
            min_rows_per_entity=int(obj.pop("min_rows_per_entity", 1)),
            seed=int(obj.pop("seed", 0)),
        )
    else:
        raise ValueError(f"unknown coordinate type '{ctype}'")
    if obj:  # a typo must not train with defaults
        raise ValueError(f"unknown keys in {ctype} coordinate config: {sorted(obj)}")
    return out


def parse_game_config(obj: Mapping | str) -> GameConfig:
    """A ``GameConfig`` from a JSON document (a dict or a JSON string)."""
    if isinstance(obj, str):
        obj = json.loads(obj)
    coords = {name: parse_coordinate_config(c) for name, c in obj.get("coordinates", {}).items()}
    return GameConfig(task=obj["task"], coordinates=coords,
                      num_iterations=int(obj.get("num_iterations", 1)),
                      evaluators=tuple(obj.get("evaluators", ())))


def game_config_to_json(config: GameConfig) -> dict:
    """The inverse of ``parse_game_config``, as saved in model metadata."""
    return _config_metadata(config)
