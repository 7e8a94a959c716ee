"""``train_glm`` on one card: one L-BFGS fit of the configuration's GLM from
zero coefficients a call, on a batch built once in set-up."""

from __future__ import annotations

import time

import torch

from benchmark import gen
from benchmark.drivers.common import Answers, GlmAnswers, optimizer_config
from benchmark.yardstick import work


class GlmSession:
    """Calls of ``train_glm`` (``photon_ml_tpu_torch.training``) over one
    batch."""

    def __init__(self, bench, shards: list, batch, build_s: float):
        from photon_ml_tpu_torch import training

        cfg = bench.cell.config
        self.training = training
        self.seed = bench.seed
        self.device = bench.devices[0]
        self.shards, self.batch = shards, batch
        self.build_s = build_s
        self.task = cfg["task"]
        self.opt = optimizer_config(cfg["optimizer"])
        self.lambdas = [float(x) for x in bench.cell.traffic.get(
            "lambdas", [cfg["optimizer"]["reg_weight"]])]
        self.begin_window()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self) -> None:
        entries = self.training.train_glm(self.batch, self.task, self.lambdas, self.opt,
                                          device=self.device)
        self._sync()
        W = torch.stack([e.model.coefficients.means for e in entries])
        values = torch.stack([e.result.value.reshape(()) for e in entries])
        self.answers.add((W, values))
        self.passes.append(sum(int(e.result.data_passes) for e in entries))

    def begin_window(self) -> None:
        self.answers, self.passes = Answers(), []

    def window_work(self) -> tuple[float, float]:
        flops = nbytes = 0.0
        for s in self.shards:
            f, b = work.glm_pass(s.num_rows, s.num_rows * s.nnz_per_row, s.num_features)
            flops, nbytes = flops + f * sum(self.passes), nbytes + b * sum(self.passes)
        return flops, nbytes

    def kernel_shapes(self) -> dict:
        s = self.shards[0]
        shape = dict(n_rows=s.num_rows, nnz=s.num_rows * s.nnz_per_row,
                     n_features=s.num_features)
        return {"csr_margins": dict(shape, use_offsets=True), "csc_scatter": shape}

    def free(self) -> None:
        self.batch = None

    def check(self) -> list:
        l2 = torch.tensor([self.opt.regularization.l2_weight(lam) for lam in self.lambdas],
                          dtype=torch.float64, device=self.device)
        return GlmAnswers(self.shards, l2).check(self.answers, self.seed)


def build(rows) -> object:
    """The program's batch of one shard of rows, built on its card."""
    from photon_ml_tpu_torch.ops.csr import CSRBatch

    return CSRBatch.from_device_csr(rows.row_ptr(), rows.cols, rows.vals, rows.labels,
                                    rows.num_features)


def prepare(bench) -> GlmSession:
    cfg, tr = bench.cell.config, bench.cell.traffic
    rows = gen.glm_rows(int(tr["data_seed"]), bench.seed, 0, int(tr["rows"]),
                        int(cfg["num_features"]), int(cfg["nnz_per_row"]), bench.devices[0])
    bench.inputs_made()
    t = time.perf_counter()
    batch = build(rows)
    bench.sync()
    session = GlmSession(bench, [rows], batch, time.perf_counter() - t)
    session.call()  # the warm-up: every shape of the window
    return session
