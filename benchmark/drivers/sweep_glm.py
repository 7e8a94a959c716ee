"""``sweep_glm`` on one card: the λ grid as lanes over one batch, one cold
round a call (every lane from zero coefficients)."""

from __future__ import annotations

import time

from benchmark import gen
from benchmark.drivers.train_glm import GlmSession, build
from benchmark.yardstick import work


class SweepSession(GlmSession):
    def __init__(self, bench, shards, batch, build_s):
        super().__init__(bench, shards, batch, build_s)
        from photon_ml_tpu_torch.sweep import runner

        self.runner = runner
        self.rounds = int(bench.cell.traffic.get("rounds", 1))
        # the sweep's lanes run in descending λ; its answers keep that order
        self.lambdas = sorted(self.lambdas, reverse=True)

    def call(self) -> None:
        res = self.runner.sweep_glm(self.batch, self.task, self.lambdas, self.opt,
                                    warm_start=self.rounds > 1, rounds=self.rounds,
                                    device=self.device)
        self._sync()
        self.answers.add((res.w, res.values))
        self.passes.append(int(max(res.data_passes)))

    def window_work(self) -> tuple[float, float]:
        s = self.shards[0]
        f, b = work.glm_pass(s.num_rows, s.num_rows * s.nnz_per_row, s.num_features,
                             lanes=len(self.lambdas))
        return f * sum(self.passes), b * sum(self.passes)

    def kernel_shapes(self) -> dict:
        s = self.shards[0]
        shape = dict(n_rows=s.num_rows, nnz=s.num_rows * s.nnz_per_row,
                     n_features=s.num_features, lanes=len(self.lambdas))
        return {"csr_margins_lanes": dict(shape, offset_words=s.num_rows),
                "csc_scatter_lanes": shape}


def prepare(bench) -> SweepSession:
    cfg, tr = bench.cell.config, bench.cell.traffic
    rows = gen.glm_rows(int(tr["data_seed"]), bench.seed, 0, int(tr["rows"]),
                        int(cfg["num_features"]), int(cfg["nnz_per_row"]), bench.devices[0])
    bench.inputs_made()
    t = time.perf_counter()
    batch = build(rows)
    bench.sync()
    session = SweepSession(bench, [rows], batch, time.perf_counter() - t)
    session.call()
    return session
