"""Optimization trackers: the solve telemetry of one coordinate update.

Counterpart of ``photon_ml_tpu/optim/trackers.py:23-195``: a fixed effect's
tracker holds its one solve's iterations, reason, final value and final
gradient norm; a random effect's holds every entity's iterations, reason and
final value, aggregated into reason counts, iteration statistics and
percentiles; a factored coordinate's pairs the two per MF iteration.

Each tracker is built with one host fetch (counted in ``host_syncs``): a
random effect's iterations, reasons and float32 values of all its buckets
cross together as one int32 tensor, the values bit-cast, as the reference
packs them. The counters ``fe_solves`` and ``re_solved_entities`` go
through the telemetry shim; the reference's histograms are not kept.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES, SolveResult


@dataclasses.dataclass(frozen=True)
class FixedEffectOptimizationTracker:
    """One solve's terminal telemetry."""

    iterations: int
    reason: str
    final_value: float
    final_grad_norm: float

    @staticmethod
    def from_result(res: SolveResult) -> "FixedEffectOptimizationTracker":
        """The tracker of a single-problem solve, with one host fetch."""
        it = int(res.iterations)
        telemetry.counter("host_syncs").inc()
        value = res.value.reshape(()).float()
        # the host-driven solvers keep their tracks on the host
        gnorm = res.grad_norms[it].float().to(value.device)
        value, gnorm = torch.stack([value, gnorm]).cpu().tolist()
        telemetry.counter("fe_solves").inc()
        return FixedEffectOptimizationTracker(
            iterations=it, reason=CONVERGENCE_REASON_NAMES.get(int(res.reason), "Unknown"),
            final_value=float(np.float32(value)), final_grad_norm=float(np.float32(gnorm)))

    def to_summary_string(self) -> str:
        return (f"iterations={self.iterations} reason={self.reason} "
                f"value={self.final_value:.6g} |grad|={self.final_grad_norm:.3g}")


_PERCENTILES = (5, 25, 50, 75, 95)


def _pct(a: np.ndarray) -> dict[str, float]:
    if len(a) == 0:
        return {f"p{p}": 0.0 for p in _PERCENTILES}
    qs = np.percentile(a, _PERCENTILES)
    return {f"p{p}": float(q) for p, q in zip(_PERCENTILES, qs)}


@dataclasses.dataclass(frozen=True)
class RandomEffectOptimizationTracker:
    """Per-entity solve telemetry of one update, over all buckets in order."""

    iterations: np.ndarray  # i32[n_entities]
    reasons: np.ndarray  # i32[n_entities]
    final_values: Optional[np.ndarray] = None  # f32[n_entities]

    @staticmethod
    def from_device_parts(its: list, reasons: list,
                          vals: list) -> "RandomEffectOptimizationTracker":
        """From per-bucket ``[E]`` tensors, with ONE host fetch: iterations,
        reasons and the float32 values bit-cast to int32, in one tensor."""
        if not its:
            z = np.zeros(0, np.int32)
            return RandomEffectOptimizationTracker(iterations=z, reasons=z,
                                                   final_values=np.zeros(0, np.float32))
        packed = torch.cat([
            torch.cat([t.to(torch.int32) for t in its]),
            torch.cat([t.to(torch.int32) for t in reasons]),
            torch.cat([t.to(torch.float32) for t in vals]).view(torch.int32),
        ])
        telemetry.counter("host_syncs").inc()
        packed = packed.cpu().numpy()
        n = len(packed) // 3
        telemetry.counter("re_solved_entities").inc(n)
        return RandomEffectOptimizationTracker(iterations=packed[:n],
                                               reasons=packed[n:2 * n],
                                               final_values=packed[2 * n:].view(np.float32))

    @staticmethod
    def from_results(results) -> "RandomEffectOptimizationTracker":
        """From a coordinate's per-bucket lane ``SolveResult``s."""
        return RandomEffectOptimizationTracker.from_device_parts(
            [r.iterations for r in results], [r.reason for r in results],
            [r.value for r in results])

    def count_convergence_reasons(self) -> dict[str, int]:
        """Reason name -> entity count."""
        out: dict[str, int] = {}
        codes, counts = np.unique(self.reasons, return_counts=True)
        for code, count in zip(codes, counts):
            name = CONVERGENCE_REASON_NAMES.get(int(code), "Unknown")
            out[name] = out.get(name, 0) + int(count)
        return out

    def iteration_stats(self) -> dict[str, float]:
        """count, mean, stdev, min and max of the iterations."""
        it = self.iterations
        if len(it) == 0:
            return {"count": 0, "mean": 0.0, "stdev": 0.0, "min": 0.0, "max": 0.0}
        return {"count": int(len(it)), "mean": float(it.mean()), "stdev": float(it.std()),
                "min": float(it.min()), "max": float(it.max())}

    def percentile_summary(self) -> dict[str, dict[str, float]]:
        """p5/p25/p50/p75/p95 of the iterations and the final values."""
        out = {"iterations": _pct(self.iterations)}
        if self.final_values is not None:
            out["final_loss"] = _pct(self.final_values)
        return out

    def to_summary_string(self) -> str:
        s = self.iteration_stats()
        reasons = ", ".join(f"{k}: {v}"
                            for k, v in sorted(self.count_convergence_reasons().items()))
        pcts = self.percentile_summary()
        it_p = pcts["iterations"]
        line = (f"entities={s['count']} iterations(mean={s['mean']:.2f}, "
                f"std={s['stdev']:.2f}, min={s['min']:.0f}, max={s['max']:.0f}, "
                f"p50={it_p['p50']:.0f}, p95={it_p['p95']:.0f}) "
                f"convergence {{{reasons}}}")
        if "final_loss" in pcts:
            fl = pcts["final_loss"]
            line += f" final_loss(p5={fl['p5']:.4g}, p50={fl['p50']:.4g}, p95={fl['p95']:.4g})"
        return line


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectOptimizationTracker:
    """Per MF iteration, the latent-space solves' tracker and the latent
    matrix refit's (None under the random projector, which refits
    nothing)."""

    steps: tuple  # of (RandomEffectOptimizationTracker, FE tracker | None)

    def to_summary_string(self) -> str:
        lines = []
        for i, (re_t, fe_t) in enumerate(self.steps):
            lines.append(f"MF iteration {i}:")
            lines.append("  latent RE: " + re_t.to_summary_string())
            if fe_t is not None:
                lines.append("  latent matrix: " + fe_t.to_summary_string())
        return "\n".join(lines)
