"""GAME scoring driver.

Counterpart of ``photon_ml_tpu/cli/score.py``: load a saved model, read the
data (the response is optional) in the feature space saved beside the
model, score on the device, add the offsets, write ScoringResultAvro and
compute the requested evaluators on the device:

    python -m photon_ml_tpu_torch.cli score --model-dir out/model/best \\
        --config score.json [--output scores.avro] [--evaluators auc rmse] \\
        [--device cuda|cpu]

The config's "input" block has the training driver's schema. A model
directory without ``feature-indexes/`` is refused unless
``--allow-index-rebuild`` accepts that the scoring data's feature ids may
not match the stored coefficients.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.cli.train import read_input
from photon_ml_tpu_torch.utils import logger, setup_logging, timed


def run(
    model_dir: str,
    input_spec: Mapping,
    output_path: Optional[str] = None,
    evaluators: Sequence[str] = (),
    model_id: str = "",
    allow_index_rebuild: bool = False,
    device: torch.device | str | None = None,
) -> dict:
    from photon_ml_tpu_torch.data.model_store import (
        ModelLoadError,
        load_feature_index_maps,
        load_game_model,
    )
    from photon_ml_tpu_torch.evaluation import EVALUATORS

    # the training feature space, saved beside the model, so feature ids
    # line up with the stored coefficients
    index_maps = load_feature_index_maps(model_dir)
    if index_maps is None and not allow_index_rebuild:
        raise ModelLoadError(
            os.path.join(model_dir, "feature-indexes"),
            "missing feature-indexes/ — feature ids rebuilt from scoring data may not match "
            "the stored coefficients and scores would be silently wrong; pass "
            "--allow-index-rebuild to accept that risk")
    if index_maps is None:
        logger.warning("%s has no feature-indexes/: index maps will be rebuilt by scanning "
                       "the SCORING data — feature ids may not match the stored coefficients "
                       "and scores may be silently wrong (--allow-index-rebuild)", model_dir)

    with timed("read scoring data"):
        data, _ = read_input(input_spec, is_response_required=False, index_maps=index_maps,
                             device=device)
    with timed("load model"):
        model = load_game_model(model_dir, device=data.device)
    with timed("score"):
        raw = model.score(data).cpu().numpy()
    # saved scores include the offset
    scores = raw + data.offset

    if output_path is not None:
        from photon_ml_tpu_torch.data.avro import write_scoring_results

        with timed("save scores"):
            write_scoring_results(output_path, scores, model_id=model_id, labels=data.response,
                                  weights=data.weight)

    metrics = {}
    if evaluators and len(np.unique(data.response)) < 2:
        logger.warning("scoring data has a constant response column (%s) — requested "
                       "evaluator metrics will be meaningless placeholders",
                       data.response[0] if data.num_rows else "empty")
    for name in evaluators:
        fn = EVALUATORS.get(name)
        if fn is None:
            raise ValueError(f"unknown evaluator '{name}'")
        metrics[name] = float(fn(data.per_row(scores), data.per_row(data.response),
                                 data.per_row(data.weight)))
    return {"num_rows": data.num_rows, "output": output_path, "metrics": metrics}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli score",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--model-dir", required=True, help="saved GAME model dir")
    parser.add_argument("--config", required=True, help="JSON config with input block")
    parser.add_argument("--output", help="ScoringResultAvro output path")
    parser.add_argument("--evaluators", nargs="*", default=[])
    parser.add_argument("--model-id", default="")
    parser.add_argument("--allow-index-rebuild", action="store_true",
                        help="score a model dir with no feature-indexes/ by rebuilding the "
                        "feature space from the scoring data (scores may be silently wrong "
                        "if the spaces differ)")
    parser.add_argument("--device", default="cuda",
                        help="the device that reads and scores (default cuda)")
    args = parser.parse_args(argv)

    setup_logging()
    with open(args.config) as f:
        config = json.load(f)
    input_spec = config["input"] if "input" in config else config
    summary = run(args.model_dir, input_spec, output_path=args.output,
                  evaluators=args.evaluators, model_id=args.model_id,
                  allow_index_rebuild=args.allow_index_rebuild, device=args.device)
    print(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
