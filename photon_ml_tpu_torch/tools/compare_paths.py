"""chip_smoke.py's GLM and GLMix paths of one checkout, saved to compare with another's.

    python photon_ml_tpu_torch/tools/compare_paths.py --root OTHER --save other.pt [--mesh]
    python photon_ml_tpu_torch/tools/compare_paths.py --report a.pt b.pt ...

Imports ``chip_smoke.py`` and ``photon_ml_tpu_torch`` from the checkout under
``--root`` (by default the one holding this file) and runs that checkout's
paths on their seeded data, as its ``chip_smoke.py`` runs them: path 5
(config #1, LBFGS, lambdas 10 and 1, variances) and paths 5b-5e
(bench_suite.py's TRON, OWLQN, Poisson in a box and TRON in a box), three
times each, then path 6 (config #4 through ``GameEstimator.fit``). For each
path it saves the kernel launches, the wall seconds and the coefficients.
With ``--mesh`` it then fits path 6's config on a ``batch`` 2 x ``model`` 2
mesh (four distinct cards when the machine has four, else cuda:0 repeated)
and saves, per device, the bytes allocated before and after that fit (the
estimator keeps its placed coordinates: the fixed effect's row blocks and
the random effect's owner blocks) and the fit's peak, then runs path 18's
uninterrupted training fleet (``tools/fleet.run_fleet`` over 13b's
per_user_re part) with one worker process per card: NCCL on distinct
cards, gloo on one card shared by two. ``--mesh-only`` skips the GLM paths
(path 6 still runs: the mesh fit needs its data). ``--report``
prints the saved runs side by side and, for each path, whether its launches
and coefficients equal the first run's bit for bit. Runs on the card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))


def _glm_paths(cs, out: dict) -> None:
    import numpy as np
    import torch

    from photon_ml_tpu_torch.ops.csr import CSRBatch

    def record(label, batch, task, lambdas, cfg, required, constraints=None,
               variances=False):
        walls, keep, launches = [], {}, None
        for _ in range(3):
            launches, stats = cs.run_path(label, batch, task, lambdas, cfg, required,
                                          constraints=constraints,
                                          compute_variances=variances, keep=keep)
            walls.append(stats["elapsed_s"])
        tensors = []
        for e in keep[label][0]:
            tensors.append(e.model.coefficients.means.cpu())
            if e.model.coefficients.variances is not None:
                tensors.append(e.model.coefficients.variances.cpu())
        out[label] = {"launches": launches, "walls": walls, "tensors": tensors}

    n, f, nnz = cs.N_ROWS, cs.N_FEATURES, cs.NNZ_PER_ROW
    values, rows, cols, y = cs.make_problem(0, n, f, nnz)
    batch = CSRBatch.from_coo(values, rows, cols, y, f)
    record("5", batch, "logistic", [10.0, 1.0], cs.solver_config("lbfgs", 20),
           ("csr_margins", "csc_scatter"), variances=True)
    del batch
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    values, rows, cols, y, _ = cs.make_suite_problem(rng, n, f, nnz, "linear")
    linear = CSRBatch.from_coo(values, rows, cols, y, f)
    values, rows, cols, y, offsets = cs.make_suite_problem(rng, n, f, nnz, "poisson")
    poisson = CSRBatch.from_coo(values, rows, cols, y, f, offsets=offsets)
    box = cs.box(f, "cuda")
    record("5b", linear, "squared", [1.0], cs.solver_config("tron", 10), ("hv_at",))
    record("5c", linear, "squared", [1.0], cs.solver_config("owlqn", 20), ("value_grad",))
    record("5d", poisson, "poisson", [1.0], cs.solver_config("lbfgs", 20), ("margins_pair",),
           constraints=box)
    record("5e", linear, "squared", [1.0], cs.solver_config("tron", 3), ("hv",),
           constraints=box)
    del linear, poisson
    torch.cuda.empty_cache()


def _mesh_fit(cs, gds, config) -> dict:
    import torch

    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.parallel import make_mesh

    devices, kind = cs.mesh_devices(4)
    names = sorted({str(d) for d in devices})
    cs._sync(devices)
    torch.cuda.empty_cache()
    before = {d: torch.cuda.memory_allocated(d) for d in names}
    cs._reset_peaks(devices)
    est = GameEstimator(config)
    t0 = time.perf_counter()
    est.fit(gds, mesh=make_mesh({"batch": 2, "model": 2}, devices))
    cs._sync(devices)
    wall = time.perf_counter() - t0
    after = {d: torch.cuda.memory_allocated(d) for d in names}
    stats = {"kind": kind, "devices": [str(d) for d in devices], "wall_s": wall,
             "allocated_before": before, "allocated_after": after,
             "held_by_fit": {d: after[d] - before[d] for d in names},
             "peak": cs._peaks(devices)}
    del est
    print(f"mesh fit: {stats}", flush=True)
    return stats


def _fleet(cs, work: str) -> dict:
    """Path 18's uninterrupted fleet with a member per card (two on one
    card): each member's backend, start-up, fit seconds, coefficients/s,
    peak and collective wait."""
    import shutil

    import torch

    from photon_ml_tpu_torch.tools import fleet

    cards = torch.cuda.device_count()
    nproc = cards if cards >= 2 else 2
    spec = fleet.FleetSpec(workdir=os.path.join(work, "fleet"), num_processes=nproc,
                           device="cuda", distinct_cards=cards >= 2, problem="scale",
                           seed=0, checkpoint_every=cs.TRAIN_FLEET_CKPT_EVERY,
                           heartbeat_deadline_s=20.0, grace_s=30.0, quorum_timeout_s=60.0,
                           timeout_s=420.0)
    t0 = time.perf_counter()
    report = fleet.run_fleet(spec)
    wall = time.perf_counter() - t0
    (gen,) = report["generations"][:1]
    stats = {"ok": report["ok"], "processes": nproc, "distinct_cards": cards >= 2,
             "wall_s": wall, "rcs": gen["rcs"], "members": gen["members"]}
    shutil.rmtree(spec.workdir, ignore_errors=True)
    print(f"fleet: {stats}", flush=True)
    return stats


def _report(paths: list[str]) -> None:
    import torch

    runs = {p: torch.load(p) for p in paths}
    first = runs[paths[0]]
    for label in first["paths"]:
        for p, run in runs.items():
            got, want = run["paths"][label], first["paths"][label]
            same = len(got["tensors"]) == len(want["tensors"]) and all(
                torch.equal(a, b) for a, b in zip(got["tensors"], want["tensors"]))
            print(f"path {label} {p}: walls={got['walls']} launches={got['launches']} "
                  f"launches_equal={got['launches'] == want['launches']} "
                  f"bit_identical={same}", flush=True)
    for p, run in runs.items():
        if run.get("mesh"):
            print(f"mesh fit {p}: {run['mesh']}", flush=True)
        if run.get("fleet"):
            print(f"fleet {p}: {run['fleet']}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(_HERE)),
                        help="the checkout whose chip_smoke.py and photon_ml_tpu_torch run")
    parser.add_argument("--save", help="write the run here")
    parser.add_argument("--mesh", action="store_true",
                        help="also fit path 6's config on a batch 2 x model 2 mesh and run "
                        "path 18's fleet with a member per card")
    parser.add_argument("--mesh-only", action="store_true",
                        help="with --mesh, skip the GLM paths")
    parser.add_argument("--report", nargs="+", help="saved runs, the first the reference")
    args = parser.parse_args(argv)
    if args.report:
        _report(args.report)
        return 0
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from photon_ml_tpu_torch.kernels import build
    from photon_ml_tpu_torch.tools.probe_ell import card_line

    print(f"root {root}; card: {card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library(verbose=False)
    out: dict = {"root": root, "card": card_line(), "paths": {}}
    if not (args.mesh and args.mesh_only):
        _glm_paths(cs, out["paths"])
    launches, stats, _, gds, (config, model) = cs.run_game_path(0, False)
    out["paths"]["6"] = {
        "launches": launches, "walls": [stats["elapsed_s"]],
        "tensors": [model.models["fixed"].coefficients.cpu()]
        + [b.coefficients.cpu() for b in model.models["per-user"].buckets]}
    if args.mesh:
        out["mesh"] = _mesh_fit(cs, gds, config)
        del gds
        torch.cuda.empty_cache()
        import tempfile

        build_dir = os.path.join(root, "build")
        os.makedirs(build_dir, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build_dir) as work:
            out["fleet"] = _fleet(cs, work)
    if args.save:
        torch.save(out, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
