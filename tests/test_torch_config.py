"""The port's config parsing against the JAX package's (tests/test_cli.py's
parse tests), on the CPU:

- the same JSON documents and optimizer DSL strings give field-equal
  configs in both packages;
- bad keys, values and DSL strings raise the same exception type in both;
- ``game_config_to_json`` round-trips, and a JAX model's metadata parses in
  the port;
- a factored coordinate and a random projector parse as in the reference
  (BASELINE config #5's document among them).

Every comparison is exact: parsing has no arithmetic.
"""

import dataclasses

import pytest

from photon_ml_tpu import config as J
from photon_ml_tpu_torch import config as T
from photon_ml_tpu_torch.game.estimator import (
    FactoredRandomEffectConfig,
    FixedEffectConfig,
    RandomEffectConfig,
)
from photon_ml_tpu_torch.optim.factory import OptimizerType, RegularizationType


def _enum(v):
    return getattr(v, "value", v)


def _opt_fields(o) -> dict:
    return {"type": _enum(o.optimizer_type), "max_iterations": o.max_iterations,
            "tolerance": o.tolerance, "reg": _enum(o.regularization.reg_type),
            "alpha": o.regularization.alpha, "weight": o.regularization_weight,
            "history": o.lbfgs_history, "down_sampling": o.down_sampling_rate,
            "box": o.box_constraints}


def _coord_fields(c) -> dict:
    """Every field the port's config shares with the reference's."""
    out = {}
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        out[f.name] = _opt_fields(v) if f.name.endswith("optimizer") else _enum(v)
    return out


def _same(tc, jc):
    assert tc.task == jc.task
    assert tc.num_iterations == jc.num_iterations
    assert tuple(tc.evaluators) == tuple(jc.evaluators)
    assert list(tc.coordinates) == list(jc.coordinates)
    for name, t in tc.coordinates.items():
        j = _coord_fields(jc.coordinates[name])
        for k, v in _coord_fields(t).items():
            assert v == j[k], (name, k)


DOCS = {
    "glmix": {
        "task": "logistic", "num_iterations": 2, "evaluators": ["auc", "rmse"],
        "coordinates": {
            "fixed": {"type": "fixed_effect", "shard_name": "global",
                      "normalization": "standardization", "intercept_index": 0,
                      "down_sampling_seed": 3, "layout": "coo",
                      "optimizer": {"regularization": "l2", "regularization_weight": 1.0,
                                    "type": "tron", "max_iterations": 15, "tolerance": 1e-5}},
            "perUser": {"type": "random_effect", "shard_name": "user", "id_name": "userId",
                        "active_rows_per_entity": 64, "min_rows_per_entity": 2,
                        "features_to_samples_ratio": 0.5, "compute_variances": True,
                        "optimizer": {"type": "newton", "regularization": "l2",
                                      "regularization_weight": 2.5}},
        },
    },
    "dsl_and_boxes": {
        "task": "poisson",
        "coordinates": {
            "fixed": {"shard_name": "g",
                      "optimizer": {"regularization": "elastic_net", "alpha": 0.25,
                                    "regularization_weight": 0.5, "lbfgs_history": 4,
                                    "box_constraints": [[0, -1.0, None], [2, None, 3]]}},
            "perItem": {"type": "random_effect", "shard_name": "g", "id_name": "itemId",
                        "optimizer": "20,1e-6,0.5,1.0,LBFGS,ElasticNet,0.3"},
        },
    },
    # bench_northstar.py:186-231 (BASELINE config #5) and a random projector
    "northstar_and_projector": {
        "task": "logistic", "evaluators": ["auc"],
        "coordinates": {
            "fixed": {"type": "fixed_effect", "shard_name": "movieFeatures",
                      "optimizer": {"type": "lbfgs", "max_iterations": 10}},
            "per-user": {"type": "random_effect", "shard_name": "movieCtx",
                         "id_name": "userId", "active_rows_per_entity": 256,
                         "optimizer": {"type": "newton", "max_iterations": 8,
                                       "regularization": "l2", "regularization_weight": 1.0}},
            "mf": {"type": "factored_random_effect", "shard_name": "movieCtx",
                   "id_name": "userId", "latent_dim": 2, "mf_iterations": 1, "seed": 4,
                   "optimizer": {"type": "lbfgs", "max_iterations": 8, "tolerance": 1e-7},
                   "latent_optimizer": "8,1e-7,1.0,1.0,LBFGS,L2",
                   "active_rows_per_entity": 32, "min_rows_per_entity": 2},
            "projected": {"type": "random_effect", "shard_name": "items", "id_name": "userId",
                          "projector": "random", "projected_dim": 16, "projection_seed": 7,
                          "projection_intercept_index": 3},
        },
    },
}


@pytest.mark.parametrize("doc", sorted(DOCS))
def test_documents_parse_field_equal(doc):
    t, j = T.parse_game_config(DOCS[doc]), J.parse_game_config(DOCS[doc])
    _same(t, j)
    assert isinstance(t.coordinates[next(iter(t.coordinates))], FixedEffectConfig)


@pytest.mark.parametrize("spec", ["10,1e-4,1.0,1.0,lbfgs,l2", "5,0,0.5,0.8,TRON,none",
                                  "7,1e-7,2,1,newton,L2", "20,1e-6,0.5,1.0,lbfgs,elasticnet,0.3",
                                  "3,1e-3,1.0,1.0,lbfgs,l1"])
def test_dsl_strings_parse_field_equal(spec):
    t, j = T.parse_optimizer_config_string(spec), J.parse_optimizer_config_string(spec)
    assert _opt_fields(t) == _opt_fields(j)
    assert _opt_fields(T.parse_optimizer_config(spec)) == _opt_fields(t)


BAD = {
    "optimizer_key": lambda m: m.parse_optimizer_config({"max_iter": 3}),
    "optimizer_type": lambda m: m.parse_optimizer_config({"type": "sgd"}),
    "regularization": lambda m: m.parse_optimizer_config({"regularization": "l3"}),
    "dsl_length": lambda m: m.parse_optimizer_config_string("10,1e-4,1.0"),
    "dsl_type": lambda m: m.parse_optimizer_config_string("10,1e-4,1.0,1.0,sgd,l2"),
    "dsl_reg": lambda m: m.parse_optimizer_config_string("10,1e-4,1.0,1.0,lbfgs,l3"),
    "dsl_alpha": lambda m: m.parse_optimizer_config_string("10,1e-4,1.0,1.0,lbfgs,l2,0.5"),
    "dsl_number": lambda m: m.parse_optimizer_config_string("ten,1e-4,1.0,1.0,lbfgs,l2"),
    "coordinate_key": lambda m: m.parse_coordinate_config(
        {"type": "fixed_effect", "shard_name": "g", "normalisation": "none"}),
    "re_key": lambda m: m.parse_coordinate_config(
        {"type": "random_effect", "shard_name": "g", "id_name": "u", "idname": "u"}),
    "coordinate_type": lambda m: m.parse_coordinate_config({"type": "mixed", "shard_name": "g"}),
    "missing_shard": lambda m: m.parse_coordinate_config({"type": "fixed_effect"}),
    "missing_task": lambda m: m.parse_game_config({"coordinates": {}}),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_keys_raise_the_same_exception_type(case):
    with pytest.raises(Exception) as jerr:
        BAD[case](J)
    with pytest.raises(Exception) as terr:
        BAD[case](T)
    assert type(terr.value) is type(jerr.value)


def test_an_unknown_layout_is_refused_at_parse_time():
    """The reference raises ValueError for it when the coordinate is built;
    the port, which builds one layout whatever the key says, at parse."""
    with pytest.raises(ValueError, match="layout"):
        T.parse_coordinate_config({"shard_name": "g", "layout": "dense"})


@pytest.mark.parametrize("doc", sorted(DOCS))
def test_game_config_to_json_round_trips(doc):
    t = T.parse_game_config(DOCS[doc])
    assert T.parse_game_config(T.game_config_to_json(t)) == t


@pytest.mark.parametrize("doc", sorted(DOCS))
def test_jax_model_metadata_parses_in_the_port(doc):
    """The reference's saved metadata (with its layout and projection keys)
    parses in the port to the config the port parses from the document."""
    meta = J.game_config_to_json(J.parse_game_config(DOCS[doc]))
    assert T.parse_game_config(meta) == T.parse_game_config(DOCS[doc])


def test_factored_coordinate_and_random_projector_are_refused():
    """Refused until ROADMAP item 10 was ported; now both kinds parse as the
    reference parses them, and their errors are the reference's."""
    factored = {"type": "factored_random_effect", "shard_name": "user", "id_name": "userId",
                "latent_dim": 4, "mf_iterations": 2}
    t, j = T.parse_coordinate_config(factored), J.parse_coordinate_config(factored)
    assert isinstance(t, FactoredRandomEffectConfig)
    assert _coord_fields(t) == _coord_fields(j)
    projected = {"type": "random_effect", "shard_name": "u", "id_name": "userId",
                 "projector": "random", "projected_dim": 2}
    assert _coord_fields(T.parse_coordinate_config(projected)) == _coord_fields(
        J.parse_coordinate_config(projected))
    for bad in ({**factored, "rank": 3}, {k: v for k, v in factored.items() if k != "latent_dim"},
                {**projected, "projected_dim": None}, {**projected, "projector": "gauss"}):
        with pytest.raises(Exception) as te:
            T.parse_coordinate_config(bad)
        with pytest.raises(Exception) as je:
            J.parse_coordinate_config(bad)
        assert te.type is je.type


def test_parsed_types_are_the_ports_own():
    t = T.parse_game_config(DOCS["glmix"])
    re = t.coordinates["perUser"]
    assert isinstance(re, RandomEffectConfig)
    assert re.optimizer.optimizer_type is OptimizerType.NEWTON
    assert re.optimizer.regularization.reg_type is RegularizationType.L2
