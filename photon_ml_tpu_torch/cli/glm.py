"""Legacy single-GLM driver: the staged pipeline
INIT -> PREPROCESSED -> TRAINED -> VALIDATED -> DIAGNOSED.

Counterpart of ``photon_ml_tpu/cli/glm.py``: each stage asserts that its
predecessor completed; ``preprocess`` reads, validates and summarizes the
data and builds the normalization context, ``train`` runs the warm-started
lambda sweep (``train_glm``), ``validate_models`` computes each lambda's
metric map (``diagnostics.evaluate``) and selects the best model, and
``diagnose`` (with ``"diagnostics": true``) composes the best model's
diagnostic report (``diagnose_model``, the fitting curves and
``bootstrap_train`` with ``bootstrap_samples`` resamples, default 8) into
``diagnostic-report.html`` and ``.txt`` under ``output_dir``, and
``write_models`` saves every lambda's model (npz through ``save_glm``, and
text: one ``index<TAB>value[<TAB>variance]`` line per nonzero coefficient
under ``learned-models-text/``):

    python -m photon_ml_tpu_torch.cli glm --config glm.json [--device cuda|cpu]

Config:

    {
      "task": "logistic",
      "input": {"format": "libsvm", "paths": ["a1a"]},
      "validation": {"paths": ["a1a.t"]},     # optional
      "optimizer": {"type": "lbfgs", "regularization": "l2"},
      "lambdas": [100.0, 10.0, 1.0, 0.1],
      "normalization": "standardization",      # optional
      "compute_variances": false,
      "validation_mode": "full",               # full | sample | disabled
      "diagnostics": false,                    # the DIAGNOSED stage
      "diagnostic_fitting": true, "diagnostic_bootstrap": true,
      "bootstrap_samples": 8,
      "output_dir": "out/"
    }

``trace_out`` (``--trace-out``) streams the stages' spans to a JSONL file
with a sibling ``.perfetto.json`` Chrome trace; ``telemetry_out``
(``--telemetry-out``) appends the final metrics snapshot, as the
reference's do.
"""

from __future__ import annotations

import argparse
import enum
import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.cli.train import read_input
from photon_ml_tpu_torch.utils import logger, setup_logging, timed
from photon_ml_tpu_torch.utils.events import (
    EventEmitter,
    OptimizationLogEvent,
    SetupEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)


class DriverStage(enum.IntEnum):
    """Pipeline stages in their strict order."""

    INIT = 0
    PREPROCESSED = 1
    TRAINED = 2
    VALIDATED = 3
    DIAGNOSED = 4


class GLMDriver:
    """The staged GLM pipeline on ``device`` (default cuda);
    ``stage_history`` records every stage transition."""

    def __init__(self, config: Mapping, output_dir: Optional[str] = None,
                 device: torch.device | str | None = None):
        self.config = dict(config)
        self.output_dir = output_dir or self.config.get("output_dir")
        self.device = device
        self.stage = DriverStage.INIT
        self.stage_history: list[DriverStage] = [DriverStage.INIT]
        self.events = EventEmitter()
        self.sweep = None  # list[SweepEntry]
        self.best = None  # (SweepEntry, metric)
        self.metrics: dict[float, dict] = {}
        self._batch = None
        self._val_batch = None
        self._normalization = None
        self._summary = None

    def _assert_stage(self, expected: DriverStage) -> None:
        if self.stage != expected:
            raise RuntimeError(f"driver stage must be {expected.name} but is {self.stage.name}")

    def _update_stage(self, new: DriverStage) -> None:
        self.stage = new
        self.stage_history.append(new)

    def preprocess(self) -> None:
        """Read, validate and summarize the data; build the normalization
        context; read the validation data in training's feature space."""
        from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY
        from photon_ml_tpu_torch.data.normalization import (
            NormalizationType,
            build_normalization_context,
        )
        from photon_ml_tpu_torch.data.stats import summarize
        from photon_ml_tpu_torch.data.validators import ValidationMode, validate

        task = self.config["task"]
        in_spec = self.config["input"]
        data, index_maps = read_input(in_spec, device=self.device)
        if len(data.feature_shards) != 1:
            raise ValueError("the legacy GLM driver trains one feature shard; got "
                             f"{sorted(data.feature_shards)} (use the GAME train driver for "
                             "multi-shard configs)")
        shard = next(iter(data.feature_shards))
        self._batch = data.csr_batch(shard)
        # the short aliases full/sample/disabled, or VALIDATE_FULL-style names
        raw_mode = str(self.config.get("validation_mode", "full")).lower()
        if not raw_mode.startswith("validate_"):
            raw_mode = f"validate_{raw_mode}"
        mode = ValidationMode(raw_mode)
        validate(self._batch, task, mode=mode)
        self._summary = summarize(self._batch)

        # the intercept column: explicit config wins; otherwise the avro
        # index map's intercept key, or libsvm's appended last column
        add_intercept = bool(in_spec.get("add_intercept", True))
        intercept_index = self.config.get("intercept_index")
        if intercept_index is None and add_intercept:
            if index_maps is not None:
                idx = index_maps[shard].get(INTERCEPT_KEY)
                intercept_index = idx if idx >= 0 else None
            else:
                intercept_index = self._batch.num_features - 1

        ntype = NormalizationType(self.config.get("normalization", "none"))
        if ntype != NormalizationType.NONE:
            self._normalization = build_normalization_context(ntype, self._summary,
                                                              intercept_index=intercept_index)
        if self.config.get("validation"):
            vspec = {**in_spec, **self.config["validation"]}
            if in_spec.get("format", "avro") == "libsvm":
                # pin the raw feature dimension to training's
                vspec["num_features"] = self._batch.num_features - (1 if add_intercept else 0)
            val_data, _ = read_input(vspec, index_maps=index_maps, device=self.device)
            self._val_batch = val_data.csr_batch(next(iter(val_data.feature_shards)))
            if self._val_batch.num_features != self._batch.num_features:
                raise ValueError(f"validation feature dimension {self._val_batch.num_features} "
                                 f"!= training {self._batch.num_features}")
            validate(self._val_batch, task, mode=mode)

    def train(self) -> None:
        """The warm-started lambda sweep."""
        from photon_ml_tpu_torch.config import parse_optimizer_config
        from photon_ml_tpu_torch.training import train_glm

        opt = parse_optimizer_config(self.config.get("optimizer"))
        lambdas = [float(x) for x in self.config.get("lambdas", [0.0])]
        self.sweep = train_glm(self._batch, self.config["task"], lambdas, opt,
                               normalization=self._normalization,
                               compute_variances=bool(self.config.get("compute_variances",
                                                                      False)),
                               device=self._batch.labels.device)
        for pos, e in enumerate(self.sweep):
            self.events.send(OptimizationLogEvent(
                iteration=pos, coordinate=f"lambda={e.reg_weight}", seconds=0.0,
                metrics={"solver_iterations": int(e.result.iterations)}))

    def validate_models(self) -> None:
        """Each lambda's validation metric map, and the best model by the
        task's selection metric (its validation scores computed once)."""
        from photon_ml_tpu_torch.diagnostics import evaluate
        from photon_ml_tpu_torch.training import select_best_model

        score_cache = {}
        for e in self.sweep:
            score_cache[id(e.model)] = e.model.compute_score(self._val_batch)
            self.metrics[e.reg_weight] = evaluate(e.model, self._val_batch)
        self.best = select_best_model(self.sweep, self._val_batch,
                                      scorer=lambda m: score_cache[id(m)])
        logger.info("best lambda=%s (metric %.6g)", self.best[0].reg_weight, self.best[1])

    def diagnose(self) -> dict:
        """Diagnostics and the HTML and text report (Driver.scala:600-627,
        writeDiagnostics:711-731) of the best model (the last lambda's
        without validation); returns the report paths."""
        import dataclasses

        from photon_ml_tpu_torch.config import parse_optimizer_config
        from photon_ml_tpu_torch.diagnostics import (
            Chapter,
            Section,
            Table,
            bootstrap_train,
            diagnose_model,
            render_html,
            render_text,
        )
        from photon_ml_tpu_torch.diagnostics.fitting import (
            fitting_diagnostic,
            fitting_report_sections,
        )

        entry = (self.best or (self.sweep[-1], None))[0]
        device = self._batch.labels.device
        doc = diagnose_model(entry.model, self._batch, summary=self._summary)
        opt = dataclasses.replace(parse_optimizer_config(self.config.get("optimizer")),
                                  regularization_weight=entry.reg_weight)
        extra = []
        if self.config.get("diagnostic_fitting", True):
            fit_rep = fitting_diagnostic(self._batch, self.config["task"], opt,
                                         lambdas=[entry.reg_weight],
                                         normalization=self._normalization, device=device)
            extra.append(Chapter("Fitting curves", fitting_report_sections(fit_rep)))
        if self.config.get("diagnostic_bootstrap", True):
            boot = bootstrap_train(self._batch, self.config["task"], opt,
                                   num_samples=int(self.config.get("bootstrap_samples", 8)),
                                   normalization=self._normalization, device=device)
            extra.append(Chapter("Bootstrap confidence intervals", [Section(
                "Per-coefficient summaries",
                [Table(header=["coefficient", "summary"],
                       rows=[(j, s.to_summary_string())
                             for j, s in enumerate(boot.coefficient_summaries)])])]))
        doc = dataclasses.replace(doc, chapters=list(doc.chapters) + extra)
        paths = {}
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            html_path = os.path.join(self.output_dir, "diagnostic-report.html")
            text_path = os.path.join(self.output_dir, "diagnostic-report.txt")
            with open(html_path, "w") as f:
                f.write(render_html(doc))
            with open(text_path, "w") as f:
                f.write(render_text(doc))
            paths = {"html": html_path, "text": text_path}
        return paths

    def write_models(self) -> Optional[str]:
        """Every lambda's model, as npz and as text."""
        if not self.output_dir:
            return None
        from photon_ml_tpu_torch.data.model_store import save_glm

        text_dir = os.path.join(self.output_dir, "learned-models-text")
        os.makedirs(text_dir, exist_ok=True)
        for e in self.sweep:
            save_glm(e.model, os.path.join(self.output_dir, "models", f"lambda-{e.reg_weight}"))
            means = e.model.coefficients.means.cpu().numpy()
            variances = e.model.coefficients.variances
            if variances is not None:
                variances = variances.cpu().numpy()
            lines = []
            for j in np.nonzero(means)[0]:
                cols = [str(int(j)), repr(float(means[j]))]
                if variances is not None:
                    cols.append(repr(float(variances[j])))
                lines.append("\t".join(cols))
            with open(os.path.join(text_dir, f"lambda-{e.reg_weight}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
        return text_dir

    def run(self) -> dict:
        from photon_ml_tpu_torch import telemetry
        from photon_ml_tpu_torch.utils.timing import Timer

        t = Timer().start()
        trace_out = self.config.get("trace_out")
        if trace_out:
            telemetry.configure(trace_out=trace_out)
        self.events.send(SetupEvent(config=self.config))

        self._assert_stage(DriverStage.INIT)
        with timed("preprocess"):
            self.preprocess()
        self._update_stage(DriverStage.PREPROCESSED)
        self.events.send(TrainingStartEvent(num_rows=int((self._batch.weights > 0).sum())))

        self._assert_stage(DriverStage.PREPROCESSED)
        with timed("train"):
            self.train()
        self._update_stage(DriverStage.TRAINED)

        if self._val_batch is not None:
            self._assert_stage(DriverStage.TRAINED)
            with timed("validate"):
                self.validate_models()
            self._update_stage(DriverStage.VALIDATED)

        report_paths = {}
        if self.config.get("diagnostics", False):
            self._assert_stage(DriverStage.VALIDATED if self._val_batch is not None
                               else DriverStage.TRAINED)
            with timed("diagnose"):
                report_paths = self.diagnose()
            self._update_stage(DriverStage.DIAGNOSED)

        with timed("write models"):
            text_dir = self.write_models()

        self.events.send(TrainingFinishEvent(best_metric=self.best[1] if self.best else None,
                                             seconds=t.stop(),
                                             metrics_snapshot=telemetry.snapshot()))
        telemetry_out = self.config.get("telemetry_out")
        if telemetry_out:
            telemetry.flush_metrics(telemetry_out)
        if trace_out:
            telemetry.export_chrome_trace(trace_out, telemetry.perfetto_path(trace_out))
        return {
            "stages": [s.name for s in self.stage_history],
            "lambdas": [e.reg_weight for e in self.sweep],
            "best_lambda": self.best[0].reg_weight if self.best else None,
            "best_metric": self.best[1] if self.best else None,
            "metrics": {str(k): {m: float(v) for m, v in mm.items()}
                        for k, mm in self.metrics.items()},
            "models_text_dir": text_dir,
            "report": report_paths,
        }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli glm",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="JSON config path")
    parser.add_argument("--output-dir", help="override config output_dir")
    parser.add_argument("--device", default="cuda",
                        help="the device that trains and validates (default cuda)")
    parser.add_argument("--trace-out",
                        help="write telemetry spans to this JSONL file (+ a sibling "
                        ".perfetto.json Chrome trace); overrides config trace_out")
    parser.add_argument("--telemetry-out",
                        help="append the final metrics snapshot to this JSONL file; overrides "
                        "config telemetry_out")
    args = parser.parse_args(argv)

    setup_logging()
    with open(args.config) as f:
        config = json.load(f)
    if args.trace_out:
        config["trace_out"] = args.trace_out
    if args.telemetry_out:
        config["telemetry_out"] = args.telemetry_out
    summary = GLMDriver(config, output_dir=args.output_dir, device=args.device).run()
    print(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
