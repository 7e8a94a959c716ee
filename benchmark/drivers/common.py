"""What the drivers share: the solver settings of a configuration file, the
window's answers, and the GLM check against the plain reference."""

from __future__ import annotations

import random

import torch

from benchmark.reference import glm as ref_glm

Tensor = torch.Tensor

#: distinct answers of a window that the check compares (more: a sample)
CHECKED_ANSWERS = 4


def optimizer_config(opt: dict):
    """The program's ``OptimizerConfig`` of a configuration's optimizer
    entry (``type``, ``max_iterations``, ``tolerance``, ``regularization``,
    ``reg_weight``, ``history``)."""
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )

    return OptimizerConfig(
        optimizer_type=OptimizerType[opt["type"]],
        max_iterations=int(opt["max_iterations"]),
        tolerance=float(opt["tolerance"]),
        regularization=RegularizationContext(RegularizationType[opt["regularization"]]),
        regularization_weight=float(opt.get("reg_weight", 0.0)),
        lbfgs_history=int(opt.get("history", 10)),
    )


class Answers:
    """The window's answers, grouped bit for bit as the calls return them, so
    that a window of many equal answers holds one copy: groups of [calls,
    answer, what the check needs beside it]; an answer is a tuple of
    tensors."""

    def __init__(self):
        self.groups: list = []

    def add(self, answer: tuple, extra=None) -> None:
        for g in self.groups:
            if all(torch.equal(a, b) for a, b in zip(g[1], answer)):
                g[0] += 1
                return
        self.groups.append([1, answer, extra])

    def chosen(self, seed: int, keep: int = CHECKED_ANSWERS) -> list:
        """The groups the check judges: all, or past ``keep`` a sample drawn
        from the seed with the last group always in it."""
        groups = self.groups
        if len(groups) > keep:
            groups = random.Random(seed).sample(groups[:-1], keep - 1) + [groups[-1]]
        return groups


class GlmAnswers:
    """Judges GLM answers: coefficients ``W`` [G, F] and the reported
    objective values [G] at L2 weights ``l2`` [G], over the raw row shards.

    ``loss_gap``: the worst lane's |reported - F(W)| / F(W), F in float64.
    ``grad_ratio``: the worst lane's |grad F(W)| / |grad F(0)|: how far the
    answer is from the optimum that a solve to tolerance 0 promises."""

    def __init__(self, shards: list, l2: Tensor):
        self.shards, self.l2 = shards, l2

    def numbers(self, W: Tensor, reported: Tensor, grad0_norm: Tensor) -> dict:
        value, grad = ref_glm.value_grad(self.shards, W, self.l2)
        gap = (reported.to(value) - value).abs() / value.abs()
        ratio = grad.norm(dim=1) / grad0_norm
        return {"loss_gap": float(gap.max()), "grad_ratio": float(ratio.max())}

    def grad0_norm(self, num_features: int, lanes: int, device) -> Tensor:
        W0 = torch.zeros(lanes, num_features, dtype=torch.float32, device=device)
        return ref_glm.value_grad(self.shards, W0, self.l2)[1].norm(dim=1)

    def check(self, answers: Answers, seed: int) -> list:
        """[(calls, numbers)] for the window's (W, reported) answers."""
        chosen = answers.chosen(seed)
        if not chosen:
            return []
        W = chosen[0][1][0]
        g0 = self.grad0_norm(W.shape[1], W.shape[0], W.device)
        return [(count, self.numbers(*answer, g0)) for count, answer, _ in chosen]
