#!/usr/bin/env python3
"""Drive photon_ml_tpu_torch's GLM, GLMix and serving paths once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--profile] [--json-out PATH]

Phases, in order; any failure exits non-zero before the last line:

  1. print the card (``nvidia-smi --query-gpu=name,power.limit``);
  2. build the Hopper kernels from ``photon_ml_tpu_torch/csrc`` with nvcc
     (into ``build/kernels/``);
  3. at full width (1M rows x 10K features x 20 nnz/row, bench.py config #1's
     data from ``--seed``; the margins and ELL kernels also on skewed row
     lengths, the scatter also on power-law column lengths, value_grad, hv
     and hv_at on both) hold each kernel against its plain PyTorch version on the
     card (and each kernel against itself: two launches must agree bit for
     bit), and time kernel, plain version and the library yardstick where one
     PyTorch call computes the same function (never used by the port); the
     plain versions read the mirror column-major (``CSRBatch.column_major``),
     the kernels in the tile index's slot order; the lane kernels
     (``csr_margins_lanes``, ``csc_scatter_lanes``) at G = 16 and G = 8
     vectors, also each lane against the single-vector kernel bit for bit,
     timed beside G single launches and ``torch.sparse.mm``, with their
     bounds and design floors (path 9 adds them at G = 16 on its largest
     COO bucket, the margins' block-diagonal regime);
  4. train at a reduced size (64K x 2K) on the card and on the CPU (plain
     versions) with LBFGS, TRON, OWLQN and box-constrained Poisson LBFGS:
     same convergence reason and iteration count, final loss within rtol 1e-4;
     and update a per-user random effect (2K users over a 2K-feature sparse
     shard, the wide buckets on the COO layout) on both with LBFGS, OWLQN,
     TRON and NEWTON in a box: per lane the same reason, the value within
     rtol 1e-4, the same iterations but on plateau lanes; then a factored
     coordinate (latent_dim 2, 2 MF iterations) and the random projector
     (projected_dim 16) on the same data, each latent matrix refit with the
     same reason and iterations and its value within rtol 1e-4; and the
     incremental refresh's masked update (about 5% of the users touched,
     from a drawn warm model, LBFGS) on card and CPU: the touched lanes
     gathered once (the COO buckets into a block-diagonal batch on the card,
     whose ``csr_margins`` and ``csc_scatter`` must launch), the untouched
     rows bit for bit, the solved lanes under the same lane rule;
  5. the paths, each at full width through the entry point a user calls,
     with the kernels' launch counts zeroed just before it and read just
     after (a kernel of the path that did not launch fails the run):
       5.  bench.py config #1 through ``train_glm``: logistic, lambdas
           [10, 1], LBFGS 20 iterations at tolerance 0, with variances;
       14. config #1's solve of path 5 through ``train_glm(mesh=...)``: on
           a 1-shard mesh (bit for bit path 5), then placed once on a 4-shard
           ``batch`` mesh (four cards when the machine has them, else cuda:0
           repeated; the line says which) and solved twice (bit for bit);
           each lambda's value within rtol 1e-4 and w within rtol/atol 5e-3
           of path 5's; 14-tron and 14-owlqn the same for paths 5b and 5c;
       12. bench_sweep.py on config #1 through ``sweep_glm``: 16 lambdas
           ``np.logspace(2, -4, 16)`` as lanes, LBFGS 20 at tolerance 0,
           cold, timed beside one ``train_glm`` fit (``sweep_over_single_
           ratio``); lanes 0, 8 and 15 against independent fits; then the
           warm-started sweep (2 rounds), no lane above the cold sweep;
       12c. ``bootstrap_random_effect`` at bench_diagnostics.py's bucket
           (4096 entities x 64 rows x 16 features, NEWTON 10), B = 64 against
           the one-lane fit (``bootstrap_overhead_ratio``), the same call on
           512 gathered entities bit for bit the full run's lanes, and
           ``bootstrap_train`` at config #1 with B = 8;
       5b. bench_suite.py config #2: squared, TRON, L2 1, 10 iterations;
       5c. its elastic-net half: OWLQN, l1 = l2 = 0.5, 20 iterations;
       5d. config #3: Poisson with offsets, L2 1, box [-0.5, 0.5], LBFGS 20
           iterations;
       5e. TRON with the box [-0.5, 0.5] on config #2's data, 3 iterations;
       8.  the data plane at config #1's width: its draws (and 100K held-out
           rows drawn next) written as LIBSVM, read by the native parser onto
           the card, validated, summarized twice (bit-identical, and within
           the reference test's tolerances of a float64 numpy summary),
           standardized and trained (logistic, lambdas [10, 1], LBFGS 20),
           the best lambda picked by held-out AUC, saved and loaded (means
           and held-out scores bit-identical);
       6.  bench_game.py config #4 through ``GameEstimator.fit``: a 10K-feature
           fixed effect (LBFGS 20 iterations, L2 1) plus a 10-feature
           per-user random effect over 100K users (batched NEWTON, tolerance
           1e-7), 2 coordinate-descent iterations; the first fit saves its
           models (``output_dir``) and the saved final model, loaded back,
           must score bit for bit as the fitted one; the second of two fits
           is timed, as bench_game.py times it; the fitted model is then
           scored and evaluated twice (``auc``, ``auc:userId``,
           ``precision@5:userId``), and each pair must agree bit for bit;
       14b. path 6's config and dataset through ``GameEstimator.fit(mesh=
           make_mesh({"batch": 2, "model": 2}))``: the coefficients within
           rtol/atol 5e-3 and the scores within 2e-3 of path 6's fit,
           a second fit bit for bit, a fit stopped after its second update
           and resumed from its checkpoint bit for bit, the AUC beside path
           6's; the fit's own coordinates keep their state with the owners
           (each batch shard built on its device from its host rows, fewer
           nonzeros than the batch, no whole device batch; each random
           effect bucket's coefficients per model-axis owner, fewer rows than
           the bucket), and the bytes allocated per device before and after
           the fit and each device's peak are printed;
       17c. (after 12) path 12's cold sweep through ``sweep_glm(mesh=...)``
           on a ``model`` axis of 4: values within rtol 1e-5 and w within
           atol 1e-3 of path 12's, the lane kernels launched on the owners;
       9.  config #4's dataset again through ``GameEstimator.fit`` (one CD
           iteration, cut from 2 for the time limit): its fixed
           effect, a per-user random effect over the sparse 10K-feature
           shard under the default optimizer type (LBFGS: 10 buckets, the 3
           widest on the COO layout, the block-diagonal batch, whose sweeps
           are the margins, scatter and hv_at kernels), and the dense
           per-user effect under NEWTON in a box with variances; the
           coordinates are built, then one fit is timed and saved (the
           reloaded model must score bit for bit and keep its variances); every lane's objective must not
           rise, the box hold, the variances match a plain recomputation on
           1,000 lanes, the train AUC beat path 6's fixed effect alone, two
           scorings and evaluations agree bit for bit; then the largest COO
           bucket's kernels against their plain versions and ``torch.mv``;
       9b. one update of the sparse per-user effect with TRON (hv_at on the
           COO buckets); 9c. the same with OWLQN (elastic net); 11b. the
           same with the random projector (projected_dim 16, LBFGS 20): no
           lane's objective rises, finite scores, two scorings and the
           saved and reloaded ``factored_random_effect`` bit-identical;
           17b. 11b's projector on a ``model`` axis of 4: latent table and
           scores within rtol/atol 5e-3 of 11b's;
       15. the serving tier on path 6's dataset: path 6's model published
           as registry version 1 with the quality gate on, loaded by
           ``ModelRegistry`` and warmed; at least 1,000 requests (cut from
           2,000 for the time limit) of 1-64
           of path 6's rows through ``ContinuousBatcher`` and
           ``ScoringServer`` (HTTP) from 8 closed-loop clients in a process
           of their own (``tools/http_load.py``), each answer within 1e-6
           of ``predict_mean``; path 9's model published and
           swapped in mid traffic (zero failed requests); the steady
           window's p50/p99, rows/s, host syncs and ``csr_margins``
           launches per request batch and the allocator's reserved bytes
           (which must not grow); the same rows twice bit for bit; ``cli
           serve --stdio`` (a subprocess) bit for bit the in-process
           engine; nearline events (both shards) for 256 users, their rows
           equal to a direct warm-started lane solve whose residuals carry
           the fixed and the per-user effects, every other user's score bit
           for bit; a label-shuffled candidate quarantined with the
           registry untouched; ``csr_margins`` at a 64-row request batch
           against its plain version;
       15b. the served model in an entity-sharded engine over a ``model``
           axis of 4 (cuda:0 repeated on one card), within 1e-6 of path
           15's engine on the same rows;
       15c. the serving fleet on path 15's version 2 (its 99,997 users
           padded to 100,000 by 3 ids with no model): (a) 4 in-process
           members (``load_member_engine``, ``ShardMemberSource``) behind a
           ``FleetRouter``, 125 calls (cut from 500, then 250) of 1-64 rows within 1e-6 of a single
           engine, a repeat bit for bit, each member's tables about a
           quarter, a pin to another version refused with 409, member 1 stopped and its
           rows shed to FE-only exactly; (b) 4 ``cli serve --member``
           processes on the card (``tools/serving_fleet.py``) under a budget
           the full model exceeds (a 1-member fleet refused), 10 s of
           traffic through the router (cut from 40 s and 20 s, the resizes
           at 5 s and 9.5 s, each when the step before it ends), member 1 hard-killed, detected by heartbeat
           and relaunched, a live resize 4 -> 8 -> 4: zero failed calls,
           64 rows routed at each settled view within 1e-6 of the single
           engine, every member reporting the card and draining to exit
           75; a probe before and after the path (``host_probe``: threads,
           child processes, memory, a fixed host workload and matmul) and
           a failure if the path left a process running;
       16. bench_freshness.py's config #4 (1M rows, 100K users, the last
           50,000 rows over 5% of the users as the delta, 50,000 validation
           rows; FE LBFGS 20, RE NEWTON, L2 1, tolerance 1e-7, 2 CD
           iterations): the base fit with a checkpoint a step (untimed), the
           full retrain over the combined data (timed), ``load_warm_start``
           + ``scan_delta`` + ``fit_incremental`` timed together
           (``time_to_fresh_s``), then three ``publish_incremental`` calls
           each followed by a ``ModelRegistry.refresh`` hot swap; every
           untouched user's row bit for bit the base's, every touched user's
           row changed, the AUC within 0.02 of the retrain's, the lanes
           solved twice the touched-or-new users and skipped twice the rest,
           ``csr_margins`` and ``csc_scatter`` launched by the refresh;
       16b. path 16's refresh over a ``model`` axis of 4 (cuda:0 repeated on
           one card): untouched rows bit for bit, solved rows within
           rtol/atol 5e-3 of path 16's, the same counts;
       10. the CLI pipeline at config #4's width: path 6's draws written as
           TrainingExampleAvro (4 files, the native encoder), ``cli index``
           (a subprocess), ``cli train`` in process with path 6's config and
           the default guard (the native decoder must read; the dataset must
           equal path 6's draws, the FE loss per CD iteration path 6's within
           rtol 1e-4, the AUC path 6's within 1e-3; no retry, no rollback;
           the models, index maps and feature statistics written), ``cli
           score`` (a subprocess, on the card by default: its scores read
           back bit for bit as the in-process model's plus offsets, its AUC
           equal), and ``cli glm`` in process on path 8's LIBSVM files,
           bit-identical to path 8's sweep (best lambda, metrics, means);
           ``cli train`` takes a checkpoint key (every step, keep the last
           2: steps 2 and 3 must remain) and prints each fixed-effect
           solve's tracker beside path 6's;
       13. on path 10's files, the streamed ingest: (a)
           ``read_game_dataset_streamed`` with a decode worker per core,
           65,536-row chunks and a staging budget of two slots (about 105
           MiB: a slot holds the chunk's CSR and the decoder's scratch, so
           64 MiB does not hold two), the native decoder must read every
           chunk, the staging ring, scratch included, stay within the
           budget, and every array equal path 10's in-core read bit for bit,
           each shard's mirror and tile index too);
           (b) a ``ChunkStream`` from half its chunks yields exactly the tail;
           (c) ``cli train`` in process with path 10's config plus
           ``input.ingest``: coefficients, trackers, train AUC and best metric
           bit for bit path 10's, the same ``csr_margins`` and ``csc_scatter``
           launches;
       13b. ``StreamingRandomEffectTrainer`` at bench_scale.py:137-139's three
           parts (1,056,000,000 coefficients: per-user and per-item 1M x 512,
           chunks of 125,000 x 8 rows; mf_latent 2M x 16, chunks of 1M),
           chunks generated on the card from a planted model, LBFGS 8 at
           tolerance 1e-5, history 4, L2 1; per part a warm-up chunk, the
           timed pass (``game_1B_coeffs_trained_per_sec``) and a tracker pass
           over the first chunk; every coefficient finite, no lane's
           objective above its value at w = 0; per_user_re's first two chunks
           bit for bit with prefetch on and off and fed from pinned host
           memory; mf_latent checkpointed after its first chunk and resumed
           bit for bit; a 2,000 x 8 x 64 chunk on the card as on the CPU
           (values within rtol 1e-4, iterations and reasons but on plateau
           lanes);
       14c. 13b's per_user_re part on a 4-device ``entity`` mesh: each
           device holds a quarter of the table, which is within rtol 2e-3 /
           atol 2e-4 of 13b's (the largest per-entity difference printed);
       18. 13b's per_user_re part through ``tools/fleet.run_fleet``: 2
           worker processes on cuda:0 (gloo), each making only its
           ``LocalChunk`` rows of every chunk on the card, a coordinated
           checkpoint every 4 chunks: (a) uninterrupted, the gathered table
           bit for bit an in-process 2-device ``entity`` mesh run over the
           same chunks; (b) member 1 killed at the ``fleet.heartbeat`` seam
           after the first certified checkpoint, the fit relaunched on the
           survivor from it: no partially certified checkpoint, the loss
           within 1e-6 (relative) of (a)'s, the rows solved before the
           checkpoint bit for bit (a)'s; each member's start-up seconds,
           backend, coefficients/s, peak (at most 0.55 of the one-process
           survivor's) and collective wait printed, with the detection and
           relaunch seconds;
       12d. on path 10's files: ``cli glm`` with ``"diagnostics": true``
           (both reports written, the VALIDATED results bit for bit path
           8's), and ``cli sweep`` on the Avro files (three to train, one to
           validate, ``lambda=1e-2:1e2:log4``), selecting as an in-process
           ``fit_sweep`` on the same datasets;
       16c. ``cli refresh`` (a subprocess) on path 10's files, config and
           checkpoint with a 50,000-row delta over 5% of the users, published
           through the gate into a new registry (untouched users of path 10's
           final model bit for bit), then the same delta refused as stale;
       19. ``cli pipeline`` (the freshness conductor's daemon, a subprocess
           on the card) on path 10's files, ``train.json`` and ``ckpt`` with
           16c's delta: (a) a daemon killed at ``pipeline.reconcile`` exits
           113, ``ckpt``'s tree digest unchanged, nothing in its registry;
           (b) one daemon, 4 cycles 1 s apart, escalating after 3: cycle 1
           publishes 16c's refresh as v-00000001 bit for bit, cycle 2 idles,
           the script publishes a nearline version (4 events each for 256
           users, half in a second 50,000-row shard's touched set) and
           renames that shard in; cycle 3's incremental candidate, which
           the gate decides against v1, has a lineage naming the nearline
           version (touched rows re-solved, untouched rows the base's bit
           for bit); a third shard renamed in lets cycle 4 retrain in full
           over 1,150,000 rows into a new generation, decided by the gate
           against the champion (a quarantined candidate is held where the
           gate parks it); ``ckpt`` unchanged, exit 0, the status file's
           served version and counters; each
           cycle's seconds and staleness p99, ``time_to_fresh_s``, the
           retrain's seconds, the lanes and the daemon's start-up printed;
       chaos. ``photon_ml_tpu_torch/tools/chaos.py`` with its workers on
           cuda:0: the write-path matrix (the four checkpoint seams, a
           streamed fit killed at each and resumed bit for bit, 4 rows at
           once) beside the pipeline row ``pipeline.cycle_start`` (a small
           ``cli pipeline`` daemon killed at the top of its cycle: base
           unchanged, no partial version, the rerun publishes);
       12b. config #4 (path 6's draws, every tenth row held out) through
           ``GameEstimator.fit_sweep`` over ``lambda=1e-4:1e2:log16``, one CD
           iteration (cut from 2 for the time limit), selected on auc: the saved winner and the one
           published to a registry (``registry_dir``) reload bit for bit,
           its validation AUC within 1e-3 of ``fit`` at its lambda;
           ``fit_grid`` over two fixed effects (L2 1 and 10) best-first,
           each entry bit for bit its combination's ``fit``;
       11. BASELINE config #5 (bench_northstar.py: 138,493 users, 26,744
           movies, its 20M rows cut to NS_ROWS = 7.5M, every user and movie
           still drawn ~54 and ~280 times (at 5M rows the per-user update
           no longer raised the validation AUC: 0.6751 -> 0.6743); a fixed effect on movieFeatures, per-user and
           per-movie NEWTON random effects and the factored ``mf``
           coordinate, latent_dim 2, its kron refit on the margins and
           scatter kernels) through ``GameEstimator.fit`` with 1M
           validation rows: fit A (AUC after each update, the ``mf``
           tracker, the saved model scoring bit for bit), fit B stopped
           after its second update with a checkpoint a step, fit C resumed
           from it and bit-identical to A; 17a. fit A's ``mf`` update (the
           same model and residual) again with the coordinate over a
           ``model`` axis of 4, against the unsharded coordinate: the
           projection matrix and the scores within rtol/atol 5e-3, both
           updates timed;
       7.  the ELL probe (``photon_ml_tpu_torch.tools.probe_ell``) at 1M x 10K
           x 20: ELL against CSR ``dot_rows``, both timed;
  6. print the ``kernels`` JSON line, the card again, and the result line
     ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result. ``--profile`` adds a torch.profiler window
over one extra solve of each path and prints its device-busy share.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import tempfile
import time
import warnings

import numpy as np

N_ROWS = 1_000_000
N_FEATURES = 10_000
NNZ_PER_ROW = 20
GAME_USERS = 100_000  # bench_game.py config #4: users, RE features, CD iterations
GAME_RE_FEATURES = 10
GAME_CD_ITERATIONS = 2
RE_CD_ITERATIONS = 1  # path 9's CD iterations (2 until cut for the script's time limit)
SWEEP_GAME_CD_ITERATIONS = 1  # path 12b's CD iterations (2 until cut, as path 9's)
N_HELDOUT = 100_000  # path 8's held-out rows, drawn after config #1's
SMALL_ROWS = 65_536
SMALL_FEATURES = 2_048
KERNEL_REL_TOL = 1e-4  # max |kernel - plain| / max(1, max |plain|)
LOSS_RTOL = 1e-4
RE_SMALL_USERS = 2_000  # the small card-vs-CPU random effect
RE_SMALL_ROWS = 20_000
RE_SMALL_FEATURES = 2_048
PLATEAU_RTOL = 1e-5
RE_BOX = ((0, -0.5, 0.5),)  # path 9's per-user box, on global feature 0
VARIANCE_LANES = 1_000
VARIANCE_RTOL = 1e-4
# bench_northstar.py (BASELINE config #5): rows, users, movies. Its 20M rows
# are cut to 10M to keep the whole script inside its time limit: a depth cut,
# the model's width (every user and movie, every feature) unchanged
NS_ROWS = 7_500_000
NS_VAL = 1_000_000
NS_USERS = 138_493
NS_MOVIES = 26_744
NS_FE_SPACE = 2_000  # movieFeatures: the id space and the features a movie has
NS_FE_NNZ = 4
NS_CTX = 4  # movieCtx and userCtx dims
PROJECTED_DIM = 16  # path 11b: no wider than the widest buckets' 16-32 rows
SWEEP_LANES = 16  # bench_sweep.py's N_CONFIGS: the lambdas of path 12 and the lane rows
GAME_SWEEP_GRID = "lambda=1e-4:1e2:log16"  # path 12b, cli/sweep.py's documented grid
CLI_SWEEP_GRID = "lambda=1e-2:1e2:log4"  # path 12d
BOOT_ENTITIES, BOOT_ROWS, BOOT_FEATURES = 4096, 64, 16  # bench_diagnostics.py's bucket
BOOT_SAMPLES = 64  # bench_diagnostics.py's NUM_SAMPLES
BOOT_GATHERED = 512  # path 12c's gathered entities
GLM_BOOTSTRAP_SAMPLES = 8  # cli glm's default bootstrap_samples
INGEST_CHUNK_ROWS = 65_536  # path 13: IngestSpec's default chunk, one block of path 10's files
INGEST_BUDGET_SLOTS = 2  # path 13's resident staging budget, in slots of its chunks
# bench_scale.py:137-139: (name, entities, local dims, entities a chunk, rows an
# entity, the part's seed); the 1B parts, LBFGS 8 at tolerance 1e-5, history 4, L2 1
SCALE_PARTS = (("per_user_re", 1_000_000, 512, 125_000, 8, 1),
               ("per_item_re", 1_000_000, 512, 125_000, 8, 2),
               ("mf_latent", 2_000_000, 16, 1_000_000, 8, 3))
SCALE_SMALL = (2_000, 64, 64)  # path 13b's card-vs-CPU chunk: entities, rows, dims
MESH_SHARDS = 4  # paths 14 and 14c: a 4-shard batch (entity) mesh; 14b: batch 2 x model 2
MESH_W_TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_distributed.py:62-75: a sharded solve's w
# the reference's tolerance for a GLMix fit on a batch x model mesh against one device
# (tests/test_multichip.py:165-215)
MESH_GAME_TOL = dict(rtol=5e-3, atol=5e-3)
MESH_TABLE_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_streaming.py:150-181

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor) FLOP/s
SERVE_REQUESTS = 1_000  # path 15: at least this many requests, each of 1 to SERVE_MAX_BATCH rows
# (2,000 until cut for the script's time limit)
SERVE_MAX_BATCH = 64  # bench_serving.py:82-86: MAX_BATCH 64, N_CLIENTS 8
SERVE_CLIENTS = 8
SERVE_ATOL = 1e-6  # tests/test_serving.py:134 (and the mesh's, tests/test_serving_sharded.py:151)
NEARLINE_USERS = 256  # path 15's feedback events: 4 rows each of 256 users
NEARLINE_ATOL = 1e-6  # tests/test_serving_sharded.py:519
GATE_SAMPLES = 16  # bootstrap resamples of the quality gate's AUC CI
SERVE_MESH = 4  # path 15b: the entity-sharded engine's model axis
FLEET_SIZE = 4  # path 15c: members; 100,000 users divide over 4 and 8
FLEET_CALLS = 125  # path 15c (a): router calls of 1 to SERVE_MAX_BATCH rows (500, then 250 until cut)
# path 15c (b): the router's traffic, the kill and the resizes, seconds from
# the first call; a step that finds the previous one still running starts
# when it ends
FLEET_TRAFFIC = dict(traffic_seconds=10.0, traffic_hz=20.0, traffic_rows=16,
                     traffic_features=(("global", NNZ_PER_ROW), ("user", GAME_RE_FEATURES)),
                     kill_member=1, kill_after_s=1.5, resizes=((5.0, 8), (9.5, 4)))
MESH_OWNERS = 4  # path 17: the model axis of the factored coordinate, the projector, the sweep
FACTORED_MESH_TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_factored.py:310-320
SWEEP_MESH_RTOL, SWEEP_MESH_W_ATOL = 1e-5, 1e-3  # tests/test_sweep.py:227-235
TRAIN_FLEET = 2  # path 18: worker processes, on cuda:0 (gloo)
TRAIN_FLEET_CKPT_EVERY = 4  # path 18: a coordinated checkpoint every 4 chunk boundaries
TRAIN_FLEET_LOSS_RTOL = 1e-6  # tools/chaos.py:366's bound, relative to the table's loss
FRESH_DELTA_FRACTION = 0.05  # bench_freshness.py:47: the delta's share of users (and rows)
FRESH_AUC_GAP = 0.02  # bench_freshness.py:48: |AUC(incremental) - AUC(from scratch)|
FRESH_PUBLISHES = 3  # bench_freshness.py:285-313: publish + hot swap samples
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def make_problem(seed: int, n_rows: int, n_features: int, nnz_per_row: int):
    """bench.py config #1's data: uniform columns, N(0,1) values, labels drawn
    from a planted logistic model (same draws in the same order)."""
    return draw_problem(np.random.default_rng(seed), n_rows, n_features, nnz_per_row)[:4]


def draw_problem(rng, n_rows: int, n_features: int, nnz_per_row: int, w_true=None):
    """``make_problem``'s draws from ``rng``: (values, rows, cols, y, w_true).
    Given ``w_true`` (the planted model), it is not drawn again, so rows drawn
    next from the same generator come from the same model."""
    nnz = n_rows * nnz_per_row
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, n_features, size=nnz)
    values = rng.normal(size=nnz)
    if w_true is None:
        w_true = rng.normal(size=n_features) * 0.5
    margins = np.bincount(rows, weights=values * w_true[cols], minlength=n_rows)
    y = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    return values, rows, cols, y, w_true


def make_suite_problem(rng, n_rows: int, n_features: int, nnz_per_row: int, kind: str):
    """bench_suite.py's ``_sparse_problem`` (configs #2 and #3): the same draws
    in the same order; "linear" labels are the planted margins plus noise,
    "poisson" labels are counts with exposure offsets."""
    nnz = n_rows * nnz_per_row
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, n_features, size=nnz)
    values = rng.normal(size=nnz)
    w_true = rng.normal(size=n_features) * 0.5
    margins = np.bincount(rows, weights=values * w_true[cols], minlength=n_rows)
    if kind == "linear":
        return values, rows, cols, margins + 0.1 * rng.normal(size=n_rows), None
    offsets = rng.normal(size=n_rows) * 0.3
    y = rng.poisson(np.exp(np.clip(0.2 * margins + offsets, -4, 4))).astype(np.float64)
    return values, rows, cols, y, offsets


def skewed_rows(seed: int):
    """COO of 100K rows with geometric lengths (mean ~20, capped at 256), as
    click data has: (values, rows, cols, n_rows)."""
    rng = np.random.default_rng(seed + 2)
    lengths = np.minimum(rng.geometric(0.05, size=N_ROWS // 10), 256)
    rows = np.repeat(np.arange(len(lengths)), lengths)
    return (rng.normal(size=len(rows)), rows, rng.integers(0, N_FEATURES, size=len(rows)),
            len(lengths))


def power_law_columns(seed: int, nnz: int) -> np.ndarray:
    """``nnz`` column ids over N_FEATURES drawn Zipf-like (probability of the
    k-th feature ~ 1/k), as feature frequencies in click data are."""
    p = 1.0 / np.arange(1, N_FEATURES + 1)
    return np.random.default_rng(seed + 3).choice(N_FEATURES, size=nnz, p=p / p.sum())


def device_ms(fn, reps: int = 30) -> float:
    """Median device time of one call, by CUDA events (the probe's timer)."""
    from photon_ml_tpu_torch.tools.probe_ell import device_ms as timed

    return timed(fn, reps)


def compare(name: str, got, want) -> tuple[float, float]:
    got = got.double()
    want = want.double()
    if got.shape != want.shape or not bool(got.isfinite().all()):
        raise RuntimeError(f"{name}: bad output shape {tuple(got.shape)} or non-finite values")
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(1.0, float(want.abs().max()))
    print(f"check {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
          f"limit={KERNEL_REL_TOL:.0e}", flush=True)
    if not rel_err <= KERNEL_REL_TOL:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return abs_err, rel_err


def library_ms(make_matrix, op) -> float | None:
    """Time of one PyTorch sparse call ``op(matrix)`` (the yardstick; unused by
    the port). None when this build of torch cannot run it."""
    import torch

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "sparse CSR is in beta"
            mat = make_matrix()
            op(mat)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"library yardstick unavailable: {exc}", flush=True)
        return None
    return device_ms(lambda: op(mat))


def kernel_row(name, source, replaces, worst, timed, label, nbytes, flops,
               lib_ms, **extra) -> dict:
    """One row of the ``kernels`` line: times measured here, bound computed
    from this run's shapes (bytes over HBM rate vs flops over f32 peak)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": 0,
        "max_abs_err": worst,
        "ms": timed[label][0],
        "plain_ms": timed[label][1],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "timed_variant": label,
        "variants_ms": {k: v[0] for k, v in timed.items()},
        **extra,
    }


def run_variants(name: str, cases) -> tuple[float, dict]:
    """Hold each variant's kernel against its plain version and against a
    second launch bit for bit, then time both.
    Returns (worst abs error, {label: (kernel ms, plain ms)})."""
    import torch

    worst, timed = 0.0, {}
    for label, run_kernel, run_plain in cases:
        got, want, again = run_kernel(), run_plain(), run_kernel()
        if not isinstance(got, tuple):
            got, want, again = (got,), (want,), (again,)
        for i, (g, a, e) in enumerate(zip(got, again, want, strict=True)):
            abs_err, _ = compare(f"{name}[{label}][{i}]", g, e)
            worst = max(worst, abs_err)
            if not torch.equal(g, a):
                raise RuntimeError(f"{name}[{label}][{i}]: two launches disagree")
        timed[label] = (device_ms(run_kernel), device_ms(run_plain))
        print(f"time {name}[{label}]: kernel_ms={timed[label][0]:.4f} "
              f"plain_ms={timed[label][1]:.4f}", flush=True)
    return worst, timed


def check_kernels(batch, w, per_row, d2_row, skewed, power_law) -> list[dict]:
    """Phase 3, the margins and scatter kernels: every variant of the path
    against its plain version and against a second launch, bit for bit;
    margins also on ``skewed`` rows, the scatter also on ``power_law``
    columns."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference

    n, f, nnz = batch.num_rows, batch.num_features, batch.nnz
    shift = torch.tensor(0.25, dtype=torch.float32, device=w.device)
    b_csr, plain_csc = batch._csr, batch.column_major()
    plain_power = power_law.column_major()

    def scatter(label, b, plain, r, square):
        return (label, lambda: kernels.csc_scatter(*b._csc, r, square, b.tiles),
                lambda: reference.csc_scatter(*plain, r, square))

    variants = {
        "csr_margins": [
            ("margins+offsets+shift", lambda: kernels.csr_margins(*b_csr, w, batch.offsets, shift, True),
             lambda: reference.csr_margins(*b_csr, w, batch.offsets, shift, True)),
            ("dot_rows", lambda: kernels.csr_margins(*b_csr, w, batch.offsets, 0.0, False),
             lambda: reference.csr_margins(*b_csr, w, batch.offsets, 0.0, False)),
            ("skewed dot_rows",
             lambda: kernels.csr_margins(*skewed._csr, w, skewed.offsets, 0.0, False),
             lambda: reference.csr_margins(*skewed._csr, w, skewed.offsets, 0.0, False)),
        ],
        "csc_scatter": [
            scatter("scatter", batch, plain_csc, per_row, False),
            scatter("scatter_sq", batch, plain_csc, d2_row, True),
            scatter("power-law scatter", power_law, plain_power, per_row, False),
        ],
    }
    # bytes each function must move (inputs read once, output written once)
    # and its flops; the timed variant of each kernel is the one the LBFGS
    # iteration launches (dot_rows for the gather, the plain scatter)
    margin_bytes = 4 * ((n + 1) + 2 * nnz + f + n)
    scatter_bytes = 4 * ((f + 1) + 2 * nnz + n + f)
    specs = {
        "csr_margins": ("photon_ml_tpu_torch/csrc/margins.cu", "photon_ml_tpu/ops/tiled.py:170",
                        "dot_rows", margin_bytes, 2 * nnz,
                        library_ms(lambda: torch.sparse_csr_tensor(
                            *b_csr, size=(n, f), check_invariants=False),
                            lambda m: torch.mv(m, w))),
        "csc_scatter": ("photon_ml_tpu_torch/csrc/scatter.cu", "photon_ml_tpu/ops/tiled.py:199",
                        "scatter", scatter_bytes, 2 * nnz,
                        library_ms(lambda: torch.sparse_csr_tensor(
                            *plain_csc, size=(f, n), check_invariants=False),
                            lambda m: torch.mv(m, per_row))),
    }
    for label, b in (("config #1", batch), ("power-law", power_law)):
        t = b.tiles
        print(f"scatter tiles, {label}: tile_rows={t.tile_rows} piece_len={t.piece_len} "
              f"slots={t.n_slots} pieces={t.n_pieces} index_bytes={4 * t.index.numel()} "
              f"part_bytes={4 * 32 * t.n_pieces} longest column "
              f"{int(torch.diff(b.col_ptr).max())} nnz", flush=True)
    rows = []
    for name, cases in variants.items():
        worst, timed = run_variants(name, cases)
        src, replaces, label, nbytes, flops, lib = specs[name]
        rows.append(kernel_row(name, src, replaces, worst, timed, label, nbytes, flops, lib))
    return rows


def launches_per_call(fn, want: int, attempts: int = 5, pad_s: float = 0.02) -> int | None:
    """Kernel launches of one call of ``fn``, counted by torch.profiler. A
    trace can lose device events (traces on the card have read 0 and 1 of a
    call's 2 launches, one run 1 three times in a row), never add them. The
    profiler can drop a device event that falls outside the trace's window
    on the host's clock, and a call traced edge to edge leaves its first and
    last kernels no room there, so the call is padded by ``pad_s`` of idle
    host time on each side. A count under ``want`` is taken again, up to
    ``attempts`` traces, and the largest count is returned (None when no
    trace saw device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        kernels = [ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not ev.name.startswith(("Memcpy", "Memset"))]
        if kernels:
            best = max(best or 0, len(kernels))
        if best is not None and best >= want:
            break
    return best


def check_fused_kernels(batch, w, v, d2_row, skewed, power_law) -> list[dict]:
    """Phase 3, the fused kernels: the variants the paths run (pair with
    offsets and both shifts; value_grad and hv for squared, Poisson and
    logistic; hv_at), value_grad, hv and hv_at also on the ``skewed`` rows
    and the ``power_law`` columns, each against its plain version and
    against a second launch, bit for bit. A tile-fused pass (value_grad, hv,
    hv_at) must make two launches a call, the pair one."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference

    n, f, nnz = batch.num_rows, batch.num_features, batch.nnz
    csr, csc, tiles = batch._csr, batch._csc, batch.tiles
    plain_csc = batch.column_major()
    rows3 = batch.labels, batch.weights, batch.offsets
    shift = torch.tensor(0.25, dtype=torch.float32, device=w.device)  # a 0-d device shift
    v_shift = -0.5  # and a host one

    def vg(loss, b=batch, plain=plain_csc, label=None):
        args = b._csr, b._csc, b.labels, b.weights, b.offsets, w, shift, loss
        return (label or loss, lambda: kernels.value_grad(*args, b.tiles),
                lambda: reference.value_grad(args[0], plain, *args[2:]))

    def hv(loss, b=batch, plain=plain_csc, label=None):
        args = b._csr, b._csc, b.labels, b.weights, b.offsets, w, shift, v, v_shift, loss
        return (label or loss, lambda: kernels.hv(*args, b.tiles),
                lambda: reference.hessian_vector(args[0], plain, *args[2:]))

    def hv_at(label, b=batch, plain=plain_csc, d2=d2_row):
        return (label, lambda: kernels.hv_at(b._csr, b._csc, d2, v, v_shift, b.tiles),
                lambda: reference.hv_at(b._csr, plain, d2, v, v_shift))

    others = {}
    for label, b in (("skewed", skewed), ("power-law", power_law)):
        s = torch.sigmoid(b.dot_rows(w))
        others[label] = b, b.column_major(), s * (1.0 - s)

    variants = {
        "margins_pair": [("pair+offsets+shifts",
                          lambda: kernels.margins_pair(csr, w, v, batch.offsets, shift, v_shift),
                          lambda: reference.margins_pair(csr, w, v, batch.offsets, shift,
                                                         v_shift))],
        "value_grad": [vg("squared"), vg("poisson"), vg("logistic")] + [
            vg("logistic", b, plain, f"{label} logistic")
            for label, (b, plain, _) in others.items()],
        "hv": [hv("squared"), hv("poisson"), hv("logistic")] + [
            hv("logistic", b, plain, f"{label} logistic")
            for label, (b, plain, _) in others.items()],
        "hv_at": [hv_at("hv_at")] + [hv_at(f"{label} hv_at", b, plain, d2)
                                     for label, (b, plain, d2) in others.items()],
    }
    # Bytes the function must move: the CSR slots once (8 per nonzero),
    # row_ptr, the per-row inputs and tables, the outputs. The two-layout
    # designs also read the CSC slots once and the tile index, and write and
    # read one part per segment: their own floor. The tile-fused kernel
    # (value_grad, hv, hv_at) reads the index but its `start`.
    slots = (n + 1) + 2 * nnz
    t = tiles
    tile_fused = 2 * nnz + (t.index.numel() - t.n_slots) + 2 * t.n_parts
    stacked = torch.stack([w, v], 1)
    specs = {
        "margins_pair": ("photon_ml_tpu_torch/csrc/margins_pair.cu",
                         "photon_ml_tpu/ops/tiled.py:194", "pair+offsets+shifts",
                         slots + 2 * f + n + 2 * n, 0, 4 * nnz,
                         library_ms(lambda: torch.sparse_csr_tensor(
                             *csr, size=(n, f), check_invariants=False),
                             lambda m: torch.sparse.mm(m, stacked)),
                         "torch.sparse.mm(X_csr, [w, p]) without offsets and shifts"),
        "value_grad": ("photon_ml_tpu_torch/csrc/value_grad.cu",
                       "photon_ml_tpu/ops/tiled.py:219", "squared",
                       slots + 3 * n + f + f + 2, tile_fused, 4 * nnz, None,
                       "no single PyTorch call computes loss, gradient and sums"),
        "hv": ("photon_ml_tpu_torch/csrc/hessian_vector.cu",
               "photon_ml_tpu/ops/tiled.py:251", "squared",
               slots + 3 * n + 2 * f + f + 1, tile_fused, 6 * nnz, None,
               "no single PyTorch call computes the curvature-weighted X^T D X v"),
        "hv_at": ("photon_ml_tpu_torch/csrc/hessian_vector.cu",
                  "photon_ml_tpu/ops/tiled.py:284", "hv_at",
                  slots + n + f + f + 1, tile_fused, 4 * nnz, None,
                  "X^T (d2 * (X v + s)) takes two sparse products and an elementwise op"),
    }
    want_launches = {"margins_pair": 1, "value_grad": 2, "hv": 2, "hv_at": 2}
    rows = []
    for name, cases in variants.items():
        worst, timed = run_variants(name, cases)
        src, replaces, label, words, extra_words, flops, lib, lib_note = specs[name]
        # not a measurement: the bytes the two layouts make this design move,
        # over the HBM rate, for the kernel table beside the bound
        print(f"design floor {name}: two-layout bytes={4 * (words + extra_words)} "
              f"floor_ms={4 * (words + extra_words) / PEAK_BYTES_PER_S * 1e3:.4f} (computed)",
              flush=True)
        launches = launches_per_call(cases[0][1], want_launches[name])
        print(f"launches per call {name}[{cases[0][0]}]: {launches} (torch.profiler)",
              flush=True)
        if launches != want_launches[name]:
            raise RuntimeError(f"{name}: {launches} launches a call, want "
                               f"{want_launches[name]}")
        rows.append(kernel_row(name, src, replaces, worst, timed, label, 4 * words, flops,
                               lib, library_note=lib_note, launches_per_call=launches))
    return rows


def check_ell_kernel(values, rows, cols, y, w, offsets, skewed, csr_lib_ms) -> dict:
    """Phase 3, the ELL margins kernel: at full width on config #1's arrays,
    and on the skewed rows (``skewed_rows``: mean ~20, up to 256 slots, so
    most slots are padding), against its plain version and a second launch."""
    import dataclasses

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference
    from photon_ml_tpu_torch.ops.ell import ELLBatch

    ell = dataclasses.replace(ELLBatch.from_coo(values, rows, cols, y, N_FEATURES),
                              offsets=offsets)
    s_vals, s_rows, s_cols, s_n = skewed
    skewed = ELLBatch.from_coo(s_vals, s_rows, s_cols, np.zeros(s_n), N_FEATURES)
    shift = 0.25

    def case(label, b, sh, use):
        return (label, lambda: kernels.ell_margins(b.vals, b.cols, w, b.offsets, sh, use),
                lambda: reference.ell_margins(b.vals, b.cols, w, b.offsets, sh, use))

    worst, timed = run_variants("ell_margins", [
        case("margins+offsets+shift", ell, shift, True),
        case("dot_rows", ell, 0.0, False),
        case("skewed dot_rows", skewed, 0.0, False),
    ])
    n_slots, n_pad = ell.vals.shape
    print(f"ell layout: slots_per_row={n_slots} n_pad={n_pad}; skewed: "
          f"slots_per_row={skewed.vals.shape[0]} rows={s_n} nnz={len(s_rows)}",
          flush=True)
    # bytes: the slots (value + column, padding included), w, one output per
    # padded row; the library yardstick is row 1's, torch.mv of the CSR
    return kernel_row("ell_margins", "photon_ml_tpu_torch/csrc/ell_margins.cu",
                      "tools/probe_ell.py:26", worst, timed, "dot_rows",
                      4 * (2 * n_slots * n_pad + N_FEATURES + n_pad), 2 * len(values),
                      csr_lib_ms)


def solver_config(kind: str, max_iterations: int):
    """LBFGS or TRON with L2, or OWLQN with elastic net at alpha 0.5; tolerance 0."""
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )

    if kind == "owlqn":
        reg = RegularizationContext(RegularizationType.ELASTIC_NET, alpha=0.5)
    else:
        reg = RegularizationContext(RegularizationType.L2)
    opt = OptimizerType.TRON if kind == "tron" else OptimizerType.LBFGS
    return OptimizerConfig(optimizer_type=opt, max_iterations=max_iterations, tolerance=0.0,
                           regularization=reg)


def box(n_features: int, device, bound: float = 0.5):
    import torch

    from photon_ml_tpu_torch.optim.common import BoxConstraints

    return BoxConstraints(
        lower=torch.full((n_features,), -bound, dtype=torch.float32, device=device),
        upper=torch.full((n_features,), bound, dtype=torch.float32, device=device),
    )


def check_small_parity(seed: int) -> None:
    """Phase 4: the same reduced problems trained on the card and on the CPU.
    The solves stop after a few iterations, before float32 noise (which the
    card's and the CPU's summation orders make differently) decides a step."""
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.training import train_glm

    logistic = make_problem(seed + 1, SMALL_ROWS, SMALL_FEATURES, NNZ_PER_ROW) + (None,)
    rng = np.random.default_rng(seed + 1)
    linear = make_suite_problem(rng, SMALL_ROWS, SMALL_FEATURES, NNZ_PER_ROW, "linear")
    poisson = make_suite_problem(rng, SMALL_ROWS, SMALL_FEATURES, NNZ_PER_ROW, "poisson")
    runs = [
        ("lbfgs", logistic, "logistic", solver_config("lbfgs", 5), False),
        ("tron", linear, "squared", solver_config("tron", 3), False),
        ("owlqn", linear, "squared", solver_config("owlqn", 5), False),
        ("box_poisson", poisson, "poisson", solver_config("lbfgs", 5), True),
    ]
    for name, (values, rows, cols, y, offsets), task, cfg, boxed in runs:
        out = {}
        for dev in ("cuda", "cpu"):
            batch = CSRBatch.from_coo(values, rows, cols, y, SMALL_FEATURES, offsets=offsets,
                                      device=dev)
            constraints = box(SMALL_FEATURES, dev) if boxed else None
            (entry,) = train_glm(batch, task, [1.0], cfg, constraints=constraints, device=dev)
            res = entry.result
            out[dev] = (res.reason, float(res.value), res.iterations)
            print(f"small {name} {dev}: iterations={res.iterations} "
                  f"reason={CONVERGENCE_REASON_NAMES[res.reason]} loss={float(res.value):.7g}",
                  flush=True)
        (r_gpu, f_gpu, i_gpu), (r_cpu, f_cpu, i_cpu) = out["cuda"], out["cpu"]
        rel = abs(f_gpu - f_cpu) / abs(f_cpu)
        print(f"small {name} parity: loss_rel_diff={rel:.3e} limit={LOSS_RTOL:.0e}", flush=True)
        if r_gpu != r_cpu or i_gpu != i_cpu or not rel <= LOSS_RTOL:
            raise RuntimeError(f"reduced-size {name} training on the card disagrees with the CPU")


def re_optimizer(kind: str, max_iterations: int, tolerance: float, box=None):
    """A random effect's optimizer, regularization weight 1: LBFGS (the
    default type), TRON or NEWTON with L2, or OWLQN with elastic net at alpha
    0.5; ``box`` the (global feature, lower, upper) triples."""
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )

    kw = {"optimizer_type": OptimizerType[kind.upper()]} if kind in ("tron", "newton") else {}
    reg = (RegularizationContext(RegularizationType.ELASTIC_NET, alpha=0.5) if kind == "owlqn"
           else RegularizationContext(RegularizationType.L2))
    return OptimizerConfig(max_iterations=max_iterations, tolerance=tolerance, regularization=reg,
                           regularization_weight=1.0, box_constraints=box, **kw)


def small_re_problem(seed: int):
    """A per-user problem over a sparse shard: RE_SMALL_ROWS rows of
    NNZ_PER_ROW uniform features out of RE_SMALL_FEATURES, RE_SMALL_USERS
    users, labels from a planted per-user logistic model."""
    rng = np.random.default_rng(seed + 4)
    rows = np.repeat(np.arange(RE_SMALL_ROWS, dtype=np.int64), NNZ_PER_ROW)
    cols = rng.integers(0, RE_SMALL_FEATURES, size=len(rows))
    vals = rng.normal(size=len(rows))
    users = rng.integers(0, RE_SMALL_USERS, size=RE_SMALL_ROWS)
    w_user = rng.normal(size=(RE_SMALL_USERS, RE_SMALL_FEATURES)) * 0.5
    margins = np.bincount(rows, weights=vals * w_user[users[rows], cols], minlength=RE_SMALL_ROWS)
    y = (rng.random(RE_SMALL_ROWS) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    return vals, rows, cols, users, y


def check_small_re_parity(seed: int) -> None:
    """Phase 4, the random effect: one update of a per-user coordinate over
    a sparse shard (``small_re_problem``) on the card and on the CPU, with
    the buckets of K >= 128 local features forced to the COO layout, under
    LBFGS, OWLQN, TRON and NEWTON in a box. Per lane: the same reason, the
    value within rtol 1e-4, and the same iteration count except on plateau
    lanes, named here as those whose last step moved the objective by at most
    PLATEAU_RTOL of its start on either side (where a step's fate follows the
    float32 rounding of the sums, which the card and the CPU order
    differently). Then, on the same data, a factored coordinate (latent_dim
    2, 2 MF iterations) and the random projector (projected_dim 16), LBFGS 20
    for both optimizers: their latent solves per lane as above but with the
    plateau lanes excepted from every check (and, in the second MF
    iteration, the lanes excepted in the first, whose warm start a rounding
    decided), and each latent matrix refit with the same reason and
    iterations, its value within rtol 1e-4."""
    from photon_ml_tpu_torch.game import (
        FactoredRandomEffectCoordinate,
        FeatureShard,
        RandomEffectCoordinate,
        build_game_dataset,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.game import random_effect_data
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES

    t0 = time.perf_counter()
    vals, rows, cols, users, y = small_re_problem(seed)
    dense_design = random_effect_data._bucket_dense_design
    random_effect_data._bucket_dense_design = (
        lambda b: None if b.num_local_features >= 128 else dense_design(b))
    try:
        data = {}
        for dev in ("cuda", "cpu"):
            gds = build_game_dataset(y, {"items": FeatureShard.from_coo(
                vals, rows, cols, RE_SMALL_FEATURES)}, id_columns={"userId": users}, device=dev)
            data[dev] = gds, build_random_effect_dataset(gds, "userId", "items")
        red = data["cuda"][1]
        layout = ["dense" if x is not None else "coo" for x in red.dense_designs()]
        print("small re buckets (E,R,K,layout): " + json.dumps(
            [(b.num_entities, b.rows_per_entity, b.num_local_features, lay)
             for b, lay in zip(red.buckets, layout)]), flush=True)
        runs = [("lbfgs", re_optimizer("lbfgs", 10, 1e-3)),
                ("owlqn", re_optimizer("owlqn", 10, 1e-3)),
                ("tron", re_optimizer("tron", 5, 1e-3)),
                ("newton_box", re_optimizer("newton", 10, 1e-3, RE_BOX))]
        for name, cfg in runs:
            out = {}
            for dev, (gds, red) in data.items():
                coord = RandomEffectCoordinate("per-user", gds, red, "logistic", cfg)
                coord.update_model(coord.initialize_model(), None)
                out[dev] = coord.last_results
            _compare_lanes(f"small re {name}", out)
        check_small_masked_parity(data, seed)
        # the factored coordinate and the random projector on the same data
        lbfgs = re_optimizer("lbfgs", 20, 1e-3)
        for name, kw in (("factored", dict(latent_dim=2, mf_iterations=2)),
                         ("projector", dict(latent_dim=16, refit_projection=False))):
            out, matrix = {}, {}
            for dev, (gds, red) in data.items():
                coord = FactoredRandomEffectCoordinate("per-user", gds, red, "logistic",
                                                       lbfgs, lbfgs, **kw)
                coord.update_model(coord.initialize_model(), None)
                out[dev] = [r for r in coord.last_results if r.value.dim() == 1]
                matrix[dev] = [(r.reason, r.iterations, float(r.value))
                               for r in coord.last_results if r.value.dim() == 0]
            n_buckets = len(red.buckets)
            for step, ((rg, ig, fg), (rc, ic, fc)) in enumerate(zip(matrix["cuda"],
                                                                    matrix["cpu"])):
                rel = abs(fg - fc) / abs(fc)
                print(f"small re {name} latent matrix {step}: reason={CONVERGENCE_REASON_NAMES[rg]} "
                      f"iterations={ig} value={fg:.7g} cpu: reason="
                      f"{CONVERGENCE_REASON_NAMES[rc]} iterations={ic} value={fc:.7g} "
                      f"rel_diff={rel:.3e} limit={LOSS_RTOL:.0e}", flush=True)
                if rg != rc or ig != ic or not rel <= LOSS_RTOL:
                    raise RuntimeError(f"small re {name}: the latent matrix refit {step} on "
                                       "the card disagrees with the CPU")
            carried = []
            for step in range(len(out["cuda"]) // n_buckets):
                part = slice(step * n_buckets, (step + 1) * n_buckets)
                carried, _ = _compare_lanes(f"small re {name} step {step}",
                                            {dev: r[part] for dev, r in out.items()}, carried)
    finally:
        random_effect_data._bucket_dense_design = dense_design
    print(f"small re: {time.perf_counter() - t0:.2f} s", flush=True)


def check_small_masked_parity(data: dict, seed: int) -> None:
    """Phase 4, the incremental refresh's masked update on the same buckets
    (the wide ones on the COO layout): about 5% of the users touched, every
    lane warm-started from one drawn model, one ``update_model`` of
    ``MaskedRandomEffectCoordinate`` (LBFGS 10) on the card and on the CPU.
    The touched lanes of each bucket are gathered once (on a COO bucket into
    a block-diagonal batch built on the card with its tile index). Fails
    unless the card's update launched ``csr_margins`` and ``csc_scatter``, a
    COO bucket was solved, every untouched row is the warm model's bit for
    bit on both devices, and the solved lanes pass phase 4's lane rule
    (reasons, values within rtol 1e-4, iterations but on plateau lanes)."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.game import RandomEffectCoordinate
    from photon_ml_tpu_torch.game.random_effect_data import CooBucket
    from photon_ml_tpu_torch.incremental import MaskedRandomEffectCoordinate

    red = data["cuda"][1]
    rng = np.random.default_rng(seed + 17)
    touched = rng.random(red.num_entities) < 0.05
    warm = [(rng.normal(size=(b.num_entities, b.num_local_features)) * 0.1).astype(np.float32)
            for b in red.buckets]
    cfg = re_optimizer("lbfgs", 10, 1e-3)
    out, kept, launches, coo_solved = {}, {}, {}, 0
    for dev, (gds, red_d) in data.items():
        coord = RandomEffectCoordinate("per-user", gds, red_d, "logistic", cfg)
        init = coord.initialize_model()
        model = dataclasses.replace(init, buckets=tuple(
            dataclasses.replace(bm, coefficients=torch.from_numpy(w).to(gds.device))
            for bm, w in zip(init.buckets, warm)))
        masked = MaskedRandomEffectCoordinate(coord, touched)
        if dev == "cuda":
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
        new = masked.update_model(model, None)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            coo_solved = sum(1 for b, ti in zip(coord._buckets, masked._positions)
                             if isinstance(b, CooBucket) and len(ti))
        same = True
        for ti, old, fresh in zip(masked._positions, model.buckets, new.buckets):
            keep = torch.ones(old.coefficients.shape[0], dtype=torch.bool, device=gds.device)
            keep[torch.from_numpy(ti).to(gds.device)] = False
            same &= torch.equal(old.coefficients[keep].view(torch.int32),
                                fresh.coefficients[keep].view(torch.int32))
        kept[dev] = same
        out[dev] = masked.last_results
        lanes = (masked.lanes_solved, masked.lanes_skipped, masked.bucket_solves,
                 masked.buckets_skipped)
    print(f"small re masked lbfgs: touched={int(touched.sum())} of {red.num_entities} "
          f"lanes_solved={lanes[0]} lanes_skipped={lanes[1]} bucket_solves={lanes[2]} "
          f"buckets_skipped={lanes[3]} coo_buckets_solved={coo_solved} "
          f"untouched_bit_identical={json.dumps(kept)} launches={json.dumps(launches)}",
          flush=True)
    bad = [k for k in ("csr_margins", "csc_scatter") if not launches.get(k)]
    if bad or not coo_solved or not all(kept.values()):
        raise RuntimeError(f"small re masked: kernels not launched {bad}, COO buckets solved "
                           f"{coo_solved}, untouched rows kept {kept}")
    _compare_lanes("small re masked lbfgs", out)


def _compare_lanes(label: str, out: dict, carried=None,
                   reasons_on_plateau: bool = True) -> tuple[list, float]:
    """Phase 4's per-lane check of one update's bucket results on the card
    and on the CPU (``out[dev]``, one ``SolveResult`` a bucket): the same
    reason, the value within LOSS_RTOL, the same iterations but on plateau
    lanes. With ``carried`` (per bucket, the lanes excepted in the previous
    MF iteration of a factored coordinate, or ``[]`` for its first) the
    plateau lanes are excepted from all three checks, and so are the lanes
    carried: a plateau lane's last step is decided by float32 rounding, and
    the point it stops at warm-starts its next MF iteration. Without
    ``reasons_on_plateau`` the plateau lanes' reasons are excepted too (their
    values are still held). Returns the lanes excepted, per bucket, and the
    largest relative value difference held."""
    import torch

    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES

    host = {dev: [tuple(t.cpu() for t in (r.reason, r.value, r.iterations, r.values))
                  for r in results] for dev, results in out.items()}
    worst, plateau, bad, excepted = 0.0, 0, [], []
    for b, ((rg, fg, ig, vg), (rc, fc, ic, vc)) in enumerate(zip(host["cuda"], host["cpu"])):
        rel = ((fg.double() - fc.double()).abs() / fc.double().abs().clamp(min=1e-30))
        flat = _plateau_lanes(vg, ig) | _plateau_lanes(vc, ic)
        if carried:
            flat |= carried[b]
        excepted.append(flat)
        plateau += int(flat.sum())
        held = ~flat if carried is not None else torch.ones_like(flat)
        reason_held = held if reasons_on_plateau else held & ~flat
        worst = max(worst, float(rel[held].max()) if bool(held.any()) else 0.0)
        if not torch.equal(rg[reason_held], rc[reason_held]):
            bad.append(f"bucket {b}: reasons differ on {int((rg != rc)[reason_held].sum())} "
                       "lanes")
        if not bool((rel[held] <= LOSS_RTOL).all()):
            bad.append(f"bucket {b}: values differ beyond rtol {LOSS_RTOL}")
        off = (ig != ic) & ~flat
        if bool(off.any()):
            bad.append(f"bucket {b}: iterations differ on {int(off.sum())} lanes "
                       "that are not plateau lanes")
        wrong = ((rg != rc) & reason_held) | ((rel > LOSS_RTOL) & held) | off
        for lane in torch.nonzero(wrong).flatten()[:3].tolist():
            bad.append({"bucket": b, "lane": lane, "reasons": [int(rg[lane]), int(rc[lane])],
                        "iterations": [int(ig[lane]), int(ic[lane])],
                        "values": [vg[lane, :int(ig[lane]) + 1].tolist(),
                                   vc[lane, :int(ic[lane]) + 1].tolist()]})
    reasons = torch.cat([r for r, *_ in host["cuda"]]).long()
    its = torch.cat([i for _, _, i, _ in host["cuda"]]).long()
    counts = torch.bincount(reasons, minlength=5).tolist()
    print(f"{label}: lanes={len(reasons)} reasons="
          f"{json.dumps({CONVERGENCE_REASON_NAMES[k]: int(c) for k, c in enumerate(counts) if c})} "
          f"iterations={torch.bincount(its).tolist()} plateau_lanes={plateau}"
          f"{' (excepted, with those carried)' if carried is not None else ''} "
          f"value_rel_diff={worst:.3e} limit={LOSS_RTOL:.0e}", flush=True)
    if bad:
        raise RuntimeError(f"{label}: the card disagrees with the CPU: {bad}")
    return excepted, worst


def _plateau_lanes(values, iterations):
    """Lanes whose last recorded step moved the objective by at most
    PLATEAU_RTOL of its start."""
    import torch

    it = iterations.long().clamp(min=1, max=values.shape[1] - 1)
    last = values.gather(1, it[:, None])[:, 0].double()
    before = values.gather(1, (it - 1)[:, None])[:, 0].double()
    start = values[:, 0].double().abs()
    return torch.nan_to_num((last - before).abs(), nan=0.0) <= PLATEAU_RTOL * start


def scatter_memory(batches) -> dict:
    """The device bytes the scatter adds to these batches: their tile
    indexes, held for the batches' lives, and the largest part scratch one
    scatter call allocates (32 floats a piece), freed when it returns."""
    tiles = [b.tiles for b in batches]
    return {"scatter_index_bytes": sum(4 * t.index.numel() for t in tiles),
            "scatter_part_bytes": max(4 * 32 * t.n_pieces for t in tiles)}


def run_path(label, batch, task, lambdas, cfg, required, constraints=None,
             compute_variances=False, min_auc=None, keep=None) -> tuple[dict, dict]:
    """Phase 5: one path through train_glm as a user calls it (device
    defaults to cuda), with the launch counts zeroed just before it and read
    just after. Fails on a bad result or a kernel of ``required`` that did
    not launch."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.training import train_glm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    entries = train_glm(batch, task, lambdas, cfg, constraints=constraints,
                        compute_variances=compute_variances)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    peak = torch.cuda.max_memory_allocated()

    passes = sum(e.result.data_passes for e in entries)
    iterations = sum(e.result.iterations for e in entries)
    for e in entries:
        res, coef = e.result, e.model.coefficients
        loss0, loss = float(res.values[0]), float(res.value)
        bad = []
        if not bool(coef.means.isfinite().all()) or not np.isfinite(loss):
            bad.append("non-finite")
        if not loss < loss0:
            bad.append("loss did not decrease")
        if compute_variances and not bool((coef.variances > 0).all()):
            bad.append("variances not positive")
        extra = ""
        if constraints is not None:
            if not (bool((coef.means >= constraints.lower).all())
                    and bool((coef.means <= constraints.upper).all())):
                bad.append("box violated")
            # TRON reports the value at its unprojected trial point, as the
            # reference does; hold the returned (projected) w to the start too
            obj = make_objective(task, cfg.regularization.l2_weight(e.reg_weight))
            loss_at_w = float(obj.value(coef.means, batch))
            extra = f" loss_at_w={loss_at_w:.7g}"
            if not loss_at_w < loss0:
                bad.append("loss at the returned w did not decrease")
        if min_auc is not None:
            score_auc = float(auc(e.model.compute_score(batch), batch.labels, batch.weights))
            extra += f" train_auc={score_auc:.6f}"
            if not score_auc > min_auc:
                bad.append(f"auc {score_auc}")
        values = " ".join(f"{float(x):.9g}" for x in res.values[:res.iterations + 1])
        print(f"path {label} lambda={e.reg_weight}: iterations={res.iterations} "
              f"reason={CONVERGENCE_REASON_NAMES[res.reason]} data_passes={res.data_passes} "
              f"loss0={loss0:.7g} loss={loss:.7g}{extra} values=[{values}]", flush=True)
        if bad:
            raise RuntimeError(f"path {label} lambda={e.reg_weight}: bad result: {bad}")
    rows_per_s = batch.num_rows * passes / elapsed
    stats = {"elapsed_s": elapsed, "rows_per_s": rows_per_s, "data_passes": passes,
             "iterations": iterations, "host_syncs": syncs,
             "ms_per_iteration": 1e3 * elapsed / max(iterations, 1),
             "max_memory_allocated": peak, **scatter_memory([batch])}
    print(f"path {label}: rows={batch.num_rows} data_passes={passes} iterations={iterations} "
          f"elapsed_s={elapsed:.4f} rows_per_s={rows_per_s:.1f} host_syncs={syncs} "
          f"ms_per_iteration={stats['ms_per_iteration']:.4f} max_memory_allocated={peak} "
          f"scatter_index_bytes={stats['scatter_index_bytes']} "
          f"scatter_part_bytes={stats['scatter_part_bytes']} "
          f"launches={json.dumps(launches)}", flush=True)
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path {label}: kernels not launched: {missing}")
    if keep is not None:  # path 14 holds its mesh solves against these
        keep[label] = (entries, launches)
    return launches, stats


def mesh_devices(n: int):
    """n devices for a mesh: n distinct cards when the machine has them, else
    cuda:0 repeated (which runs the sharding code, not transfers between
    cards); and which of the two it is."""
    import torch

    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], "distinct cards"
    return [torch.device("cuda", 0)] * n, "cuda:0 repeated"


def _sync(devices) -> None:
    import torch

    for d in sorted({str(d) for d in devices}):
        torch.cuda.synchronize(torch.device(d))


def _reset_peaks(devices) -> None:
    import torch

    for d in sorted({str(d) for d in devices}):
        torch.cuda.reset_peak_memory_stats(torch.device(d))


def _peaks(devices) -> dict:
    import torch

    return {d: torch.cuda.max_memory_allocated(torch.device(d))
            for d in sorted({str(d) for d in devices})}


def _add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def run_mesh_glm_path(label: str, batch, task: str, lambdas, cfg, ref, required,
                      compute_variances: bool = False) -> tuple[dict, dict]:
    """Path 14: ``train_glm(mesh=...)`` over the batch of path ``ref``'s label
    (its entries and launches, ``run_path(keep=...)``): on a 1-shard mesh,
    which must give the unsharded entries bit for bit, then placed once on a
    4-shard ``batch`` mesh and solved twice, the two solves bit for bit, each
    entry's value within rtol 1e-4 and its coefficients within rtol/atol
    5e-3 of the unsharded ones (tests/test_distributed.py:62-75). The launch
    counts are zeroed before each solve and summed over the path."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.parallel import make_mesh, place_batch
    from photon_ml_tpu_torch.training import train_glm

    ref_entries, ref_launches = ref
    devices, kind = mesh_devices(MESH_SHARDS)
    total, bad = {}, []

    def solve(arg, mesh):
        _sync(devices)
        _reset_peaks(devices)
        telemetry.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        entries = train_glm(arg, task, lambdas, cfg, compute_variances=compute_variances,
                            mesh=mesh)
        _sync(devices)
        elapsed = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        _add_launches(total, launches)
        return entries, elapsed, launches, telemetry.snapshot()["counters"].get(
            "host_syncs", 0), _peaks(devices)

    def same(a, b):
        ca, cb = a.model.coefficients, b.model.coefficients
        return (torch.equal(ca.means, cb.means) and torch.equal(a.result.value, b.result.value)
                and (ca.variances is None or torch.equal(ca.variances, cb.variances)))

    one = solve(batch, make_mesh({"batch": 1}, devices[:1]))[0]
    one_same = all(same(a, b) for a, b in zip(one, ref_entries))
    if not one_same:
        bad.append("the 1-shard mesh differs from the unsharded solve")
    del one
    mesh = make_mesh({"batch": MESH_SHARDS}, devices)
    t0 = time.perf_counter()
    placed = place_batch(batch, mesh)
    _sync(devices)
    place_s = time.perf_counter() - t0
    (first, elapsed, launches, syncs, peaks), second = solve(placed, mesh), solve(placed, mesh)
    repeat = all(same(a, b) for a, b in zip(first, second[0]))
    if not repeat:
        bad.append("two 4-shard solves differ")
    diffs = []
    for e, r in zip(first, ref_entries):
        w, w_ref = e.model.coefficients.means.cpu().numpy(), r.model.coefficients.means.cpu().numpy()
        rel = abs(float(e.result.value) - float(r.result.value)) / abs(float(r.result.value))
        diffs.append({"lambda": e.reg_weight, "iterations": e.result.iterations,
                      "ref_iterations": r.result.iterations, "value_rel_diff": rel,
                      "w_max_abs_diff": float(np.abs(w - w_ref).max())})
        if not rel <= 1e-4 or not np.allclose(w, w_ref, **MESH_W_TOL):
            bad.append(f"lambda {e.reg_weight}: the 4-shard solve is off the unsharded one")
    passes = sum(e.result.data_passes for e in first)
    ratio = {k: (launches[k] / ref_launches[k]) for k in ref_launches if ref_launches[k]}
    stats = {"devices": [str(d) for d in devices], "kind": kind, "wall_s": elapsed,
             "second_wall_s": second[1], "place_s": place_s,
             "rows_per_s": batch.num_rows * passes / elapsed, "host_syncs": syncs,
             "launches": launches, "launches_over_unsharded": ratio,
             "max_memory_allocated_by_device": peaks, "one_shard_bit_identical": one_same,
             "repeat_bit_identical": repeat, "against_unsharded": diffs}
    print(f"path {label}: mesh batch={MESH_SHARDS} over {kind} {stats['devices']}; "
          f"{json.dumps(stats)}", flush=True)
    missing = [k for k in required if launches[k] == 0]
    if missing:
        bad.append(f"kernels not launched: {missing}")
    if bad:
        raise RuntimeError(f"path {label}: bad result: {bad}")
    return total, stats


def profile_solve(label, run) -> dict:
    """--profile: device-busy share of one cold solve ``run()``, which returns
    its iteration count (or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iterations = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: an operator's device time repeats its kernels'
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0)
        if dev_us:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    report = {
        "path": label,
        "iterations": iterations,
        "wall_s": wall,
        "device_busy_s": busy_s if busy_s > 0 else None,
        "device_busy_share": busy_s / wall if busy_s > 0 else None,
        "top_device_us": [(name[:80], us) for name, us in top],
    }
    print("profile " + json.dumps(report), flush=True)
    return report


def make_game_problem(seed: int):
    """bench_game.py:49-81's data, the same draws in the same order: a sparse
    fixed-effect shard, dense per-user features over 100K users, and labels
    from a planted logistic model with both effects."""
    rng = np.random.default_rng(seed)
    nnz = N_ROWS * NNZ_PER_ROW
    fe_rows = np.repeat(np.arange(N_ROWS, dtype=np.int64), NNZ_PER_ROW)
    fe_cols = rng.integers(0, N_FEATURES, size=nnz)
    fe_vals = rng.normal(size=nnz)
    w_true = rng.normal(size=N_FEATURES) * 0.5
    users = rng.integers(0, GAME_USERS, size=N_ROWS)
    Xu = rng.normal(size=(N_ROWS, GAME_RE_FEATURES))
    wu_true = rng.normal(size=(GAME_USERS, GAME_RE_FEATURES)) * 0.5
    margins = np.bincount(fe_rows, weights=fe_vals * w_true[fe_cols], minlength=N_ROWS)
    margins += np.einsum("ij,ij->i", Xu, wu_true[users])
    y = (rng.random(N_ROWS) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    return fe_vals, fe_rows, fe_cols, users, Xu, y


def run_suite_paths(seed: int, profile: bool, by_path: dict, train: dict, prof: dict) -> None:
    """Paths 5b-5e: bench_suite.py configs #2 and #3, the linear problem
    first, then the Poisson one, from one generator. Their batches are freed
    on return, so path 6's peak memory holds only its own data."""
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.training import train_glm

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    values, rows, cols, y, _ = make_suite_problem(rng, N_ROWS, N_FEATURES, NNZ_PER_ROW,
                                                  "linear")
    linear = CSRBatch.from_coo(values, rows, cols, y, N_FEATURES)
    values, rows, cols, y, offsets = make_suite_problem(rng, N_ROWS, N_FEATURES,
                                                        NNZ_PER_ROW, "poisson")
    poisson = CSRBatch.from_coo(values, rows, cols, y, N_FEATURES, offsets=offsets)
    del values, rows, cols, y, offsets
    print(f"data: bench_suite linear + poisson {N_ROWS}x{N_FEATURES}, "
          f"setup_s={time.perf_counter() - t0:.2f}", flush=True)

    the_box = box(N_FEATURES, "cuda")
    paths = [
        ("5b", linear, "squared", solver_config("tron", 10), None, ("hv_at", "csr_margins",
                                                                    "csc_scatter")),
        ("5c", linear, "squared", solver_config("owlqn", 20), None, ("value_grad",
                                                                     "csr_margins")),
        ("5d", poisson, "poisson", solver_config("lbfgs", 20), the_box, ("margins_pair",
                                                                         "value_grad")),
        ("5e", linear, "squared", solver_config("tron", 3), the_box, ("hv", "value_grad")),
    ]
    refs = {}
    for label, pbatch, task, cfg, constraints, required in paths:
        by_path[label], train[label] = run_path(label, pbatch, task, [1.0], cfg, required,
                                                constraints=constraints, keep=refs)
        if profile:
            prof[label] = profile_solve(label, lambda: train_glm(
                pbatch, task, [1.0], cfg, constraints=constraints)[0].result.iterations)
        # path 14's config #2 solves on a mesh, held against 5b's and 5c's
        mesh_label = {"5b": "14-tron", "5c": "14-owlqn"}.get(label)
        if mesh_label is not None:
            by_path[mesh_label], train[mesh_label] = run_mesh_glm_path(
                mesh_label, pbatch, task, [1.0], cfg, refs.pop(label), required)
            mark(f"path {mesh_label}", train)
        refs.pop(label, None)


def run_game_path(seed: int, profile: bool) -> tuple[dict, dict, dict | None, object, tuple]:
    """Path 6: GLMix config #4 through ``GameEstimator.fit`` as bench_game.py
    drives it: the random-effect build timed alone, one fit that saves its
    models to ``output_dir``, then the second fit timed with the launch counts
    zeroed just before it. Fails unless the saved final model, loaded back,
    scores the dataset bit for bit as the fitted one, the
    fixed effect's margins and scatter kernels launched, its loss fell in
    every coordinate-descent iteration, every coefficient is finite, the
    GLMix model's train AUC beats its fixed effect's alone, and two scorings
    and evaluations of the model agree bit for bit. Returns the dataset too,
    for path 9, and the config and fitted model, for path 14b."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.data.model_store import load_game_model
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.game import (
        FeatureShard,
        FixedEffectConfig,
        GameConfig,
        GameEstimator,
        RandomEffectConfig,
        build_game_dataset,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.game.coordinate_descent import ValidationSpec, _evaluate
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.optim.factory import OptimizerType

    # the dataset's blocks come from fresh segments, so the fit's peak does
    # not depend on which blocks the earlier paths left cached
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fe_vals, fe_rows, fe_cols, users, Xu, y = make_game_problem(seed)
    ru_rows, ru_cols = np.nonzero(Xu)
    gds = build_game_dataset(y, {
        "global": FeatureShard.from_coo(fe_vals, fe_rows, fe_cols, N_FEATURES),
        "user": FeatureShard.from_coo(Xu[ru_rows, ru_cols], ru_rows, ru_cols, GAME_RE_FEATURES),
    }, id_columns={"userId": users})
    del fe_vals, fe_rows, fe_cols, Xu, ru_rows, ru_cols
    print(f"data: bench_game config #4 {N_ROWS} rows, FE {N_FEATURES} x {NNZ_PER_ROW} nnz/row, "
          f"RE {GAME_RE_FEATURES} dense over {GAME_USERS} users, "
          f"setup_s={time.perf_counter() - t0:.2f}", flush=True)

    opt = dataclasses.replace(solver_config("lbfgs", 20), regularization_weight=1.0)
    re_opt = dataclasses.replace(opt, optimizer_type=OptimizerType.NEWTON, tolerance=1e-7)
    config = GameConfig(task="logistic", num_iterations=GAME_CD_ITERATIONS, coordinates={
        "fixed": FixedEffectConfig(shard_name="global", optimizer=opt),
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId", optimizer=re_opt),
    })
    t0 = time.perf_counter()
    red = build_random_effect_dataset(gds, "userId", "user")
    re_build_s = time.perf_counter() - t0
    buckets = [(b.num_entities, b.rows_per_entity, b.num_local_features) for b in red.buckets]
    total_coeffs = N_FEATURES + sum(e * k for e, _, k in buckets)
    del red

    est = GameEstimator(config)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as out:
        t0 = time.perf_counter()
        first = est.fit(gds, output_dir=out)
        torch.cuda.synchronize()
        first_fit_s = time.perf_counter() - t0
        # the saved final model, loaded back, scores as the fitted one does
        loaded = load_game_model(os.path.join(out, "final"))
        reloaded_same = torch.equal(loaded.score(gds), first.model.score(gds))
    print(f"path 6 saved: first_fit_s={first_fit_s:.4f} (with output_dir) "
          f"final_reloaded_scores_bit_identical={reloaded_same}", flush=True)
    del first, loaded
    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = est.fit(gds)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    peak = torch.cuda.max_memory_allocated()

    bad = [] if reloaded_same else ["the saved final model scores differently when loaded"]
    model = result.model
    fe = model.models["fixed"]
    coeffs = [fe.coefficients] + [b.coefficients for b in model.models["per-user"].buckets]
    if not all(bool(c.isfinite().all()) for c in coeffs):
        bad.append("non-finite coefficients")
    newton, fe_losses, fe_trackers = [], [], []
    for entry in result.history:
        it, name = entry["iteration"], entry["coordinate"]
        if name == "fixed":
            (res,) = entry["results"]
            loss0, loss = float(res.values[0]), float(res.value)
            fe_losses.append(loss)
            fe_trackers.append(entry["tracker"])
            print(f"path 6 cd={it} fixed: iterations={res.iterations} "
                  f"reason={CONVERGENCE_REASON_NAMES[res.reason]} loss0={loss0:.7g} "
                  f"loss={loss:.7g} seconds={entry['seconds']:.4f}", flush=True)
            if not loss < loss0:
                bad.append(f"fixed-effect loss did not fall in CD iteration {it}")
            continue
        for b, res in enumerate(entry["results"]):
            reasons = torch.bincount(res.reason.long(), minlength=5).tolist()
            row = {"cd": it, "bucket": b, "entities_rows_k": buckets[b],
                   "max_iterations": int(res.iterations.max()),
                   "reasons": {CONVERGENCE_REASON_NAMES[r]: c for r, c in enumerate(reasons)
                               if c}}
            newton.append(row)
            print(f"path 6 cd={it} per-user newton {json.dumps(row)}", flush=True)
        print(f"path 6 cd={it} per-user: seconds={entry['seconds']:.4f}", flush=True)
    labels, weights = gds.per_row(gds.response), gds.per_row(gds.weight)
    glmix_auc = float(auc(model.score(gds) + gds.per_row(gds.offset), labels, weights))
    fe_auc = float(auc(fe.score(gds) + gds.per_row(gds.offset), labels, weights))
    if not glmix_auc > fe_auc:
        bad.append(f"GLMix train auc {glmix_auc} <= fixed effect alone {fe_auc}")
    # the fitted model scored twice and evaluated twice, as a validated fit
    # evaluates it: the random effect's scores and the metrics must repeat
    # bit for bit
    specs = ["auc", "auc:userId", "precision@5:userId"]
    scores = [model.score(gds) for _ in range(2)]
    evals = [_evaluate(model, ValidationSpec(data=gds, evaluators=specs)) for _ in range(2)]
    same = {"scores": torch.equal(*scores), **{k: evals[0][k] == evals[1][k] for k in specs}}
    print(f"path 6 twice: {' '.join(f'{k}={v:.9g}' for k, v in evals[0].items())} "
          f"bit_identical={json.dumps(same)}", flush=True)
    if not all(same.values()):
        bad.append(f"scores or metrics differ between two calls: {same}")
    coeffs_per_s = total_coeffs * GAME_CD_ITERATIONS / elapsed
    stats = {"elapsed_s": elapsed, "first_fit_s": first_fit_s, "re_build_s": re_build_s,
             "coeffs_per_s": coeffs_per_s, "total_coeffs": total_coeffs,
             "buckets": buckets, "newton": newton, "host_syncs": syncs,
             "max_memory_allocated": peak, "train_auc": glmix_auc, "fe_only_auc": fe_auc,
             "fe_losses": fe_losses, "fe_trackers": fe_trackers,
             "evaluated": evals[0], "bit_identical_twice": same,
             "final_reloaded_scores_bit_identical": reloaded_same,
             **scatter_memory(gds.__dict__["_csr_batches"].values())}
    print(f"path 6: coeffs_per_s={coeffs_per_s:.1f} total_coeffs={total_coeffs} "
          f"fit_wall_s={elapsed:.4f} first_fit_s={first_fit_s:.4f} re_build_s={re_build_s:.4f} "
          f"buckets(E,R,K)={buckets} host_syncs={syncs} max_memory_allocated={peak} "
          f"scatter_index_bytes={stats['scatter_index_bytes']} "
          f"scatter_part_bytes={stats['scatter_part_bytes']} "
          f"cached_batches={sorted(gds.__dict__['_csr_batches'])} "
          f"train_auc={glmix_auc:.6f} fe_only_auc={fe_auc:.6f} "
          f"launches={json.dumps(launches)}", flush=True)
    if bad:
        raise RuntimeError(f"path 6: bad result: {bad}")
    missing = [k for k in ("csr_margins", "csc_scatter") if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path 6: kernels not launched: {missing}")
    prof = None
    if profile:
        def refit():
            est.fit(gds)

        prof = profile_solve("6", refit)
    return launches, stats, prof, gds, (config, model)


def run_mesh_game_path(gds, config, ref_model, ref_stats: dict, ref_launches: dict,
                       work: str) -> tuple[dict, dict]:
    """Path 14b: path 6's config and dataset through ``GameEstimator.fit(mesh=
    make_mesh({"batch": 2, "model": 2}))``: the fixed effect's rows over 2
    shards, the per-user entities over 2 owners. Fails unless the fixed- and
    random-effect coefficients are within rtol/atol 5e-3 (the reference's
    batch x model mesh tolerance, tests/test_multichip.py:165-215) and the
    scores within 2e-3 (tests/test_mesh_game.py:103-104) of path 6's fit, a
    second fit (on the cached coordinates) is the first bit for bit, and a
    fit checkpointed every step, stopped after its second update and resumed
    is the first bit for bit. The launch counts are zeroed before each fit
    and summed over the path."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.game import CheckpointSpec, GameEstimator, TrainingInterrupted
    from photon_ml_tpu_torch.parallel import make_mesh

    devices, kind = mesh_devices(4)
    mesh = make_mesh({"batch": 2, "model": 2}, devices)
    total, bad = {}, []
    est = GameEstimator(config)

    def fit(estimator=est, **kw):
        _sync(devices)
        _reset_peaks(devices)
        telemetry.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = estimator.fit(gds, mesh=mesh, **kw)
        _sync(devices)
        elapsed = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        _add_launches(total, launches)
        return result, elapsed, launches, telemetry.snapshot()["counters"].get(
            "host_syncs", 0), _peaks(devices)

    def coefficients(model):
        return [model.models["fixed"].coefficients] + [
            b.coefficients for b in model.models["per-user"].buckets]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(coefficients(a), coefficients(b)))

    names = sorted({str(d) for d in devices})
    _sync(devices)
    torch.cuda.empty_cache()
    before = {d: torch.cuda.memory_allocated(d) for d in names}
    first, first_s, launches, syncs, peaks = fit()
    after = {d: torch.cuda.memory_allocated(d) for d in names}
    owners = _owner_state(est._build_coordinates(gds, mesh), mesh, gds, bad)
    second, second_s, *_ = fit()
    repeat = same(second.model, first.model)
    if not repeat:
        bad.append("a second mesh fit differs from the first")
    ckpt = os.path.join(work, "ckpt14b")
    polls = iter(range(1_000))
    stopped_at = None
    try:
        fit(GameEstimator(config), should_stop=lambda: next(polls) == 1,
            checkpoint_spec=CheckpointSpec(directory=ckpt, resume=False))
        bad.append("the stop after the second update did not interrupt the fit")
    except TrainingInterrupted as e:
        stopped_at = e.step
    resumed = fit(GameEstimator(config), checkpoint_spec=CheckpointSpec(directory=ckpt))[0]
    resumed_same = same(resumed.model, first.model)
    if not resumed_same:
        bad.append("the resumed mesh fit differs from the uninterrupted one")
    shutil.rmtree(ckpt, ignore_errors=True)
    diffs = {}
    for name, got, want in (("fixed", coefficients(first.model)[:1], coefficients(ref_model)[:1]),
                            ("per-user", coefficients(first.model)[1:],
                             coefficients(ref_model)[1:])):
        worst = 0.0
        for g, w in zip(got, want):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            worst = max(worst, float(np.abs(g - w).max()) if g.size else 0.0)
            if not np.allclose(g, w, **MESH_GAME_TOL):
                bad.append(f"{name} coefficients off path 6's beyond {MESH_GAME_TOL}")
        diffs[name] = worst
    scores, ref_scores = first.model.score(gds), ref_model.score(gds)
    diffs["scores"] = float((scores - ref_scores).abs().max())
    if not np.allclose(scores.cpu().numpy(), ref_scores.cpu().numpy(), rtol=2e-3, atol=2e-3):
        bad.append("scores off path 6's beyond 2e-3")
    labels, weights = gds.per_row(gds.response), gds.per_row(gds.weight)
    mesh_auc = float(auc(scores + gds.per_row(gds.offset), labels, weights))
    stats = {"devices": [str(d) for d in devices], "kind": kind, "wall_s": first_s,
             "second_wall_s": second_s,
             "coeffs_per_s": ref_stats["total_coeffs"] * GAME_CD_ITERATIONS / second_s,
             "host_syncs": syncs, "launches": launches,
             "launches_over_path6": {k: launches[k] / v for k, v in ref_launches.items() if v},
             "max_memory_allocated_by_device": peaks, "allocated_before": before,
             "allocated_after": after, "owner_state": owners,
             "max_abs_diff_vs_path6": diffs,
             "train_auc": mesh_auc, "path6_train_auc": ref_stats["train_auc"],
             "repeat_bit_identical": repeat, "stopped_at_step": stopped_at,
             "resumed_bit_identical": resumed_same}
    print(f"path 14b: mesh batch=2 x model=2 over {kind} {stats['devices']}; "
          f"{json.dumps(stats)}", flush=True)
    missing = [k for k in ("csr_margins", "csc_scatter") if launches[k] == 0]
    if missing:
        bad.append(f"kernels not launched: {missing}")
    if bad:
        raise RuntimeError(f"path 14b: bad result: {bad}")
    return total, stats


def _owner_state(coords, mesh, gds, bad: list) -> dict:
    """What the mesh fit's coordinates hold, and where: each batch shard of
    the fixed effect on its batch-axis device with its own rows only (and
    no whole device batch kept), and a random-effect update's coefficients
    kept per model-axis owner, each block on its owner's device with fewer
    rows than the bucket. Adds to ``bad`` what is not so."""
    from photon_ml_tpu_torch.parallel import OwnerBlocks

    fe, re = coords["fixed"], coords["per-user"]
    shards = fe._solve_batch.shards
    total = len(gds.shard("global").values)
    nnz = [int(b.nnz) for b in shards]
    fe_ok = (fe._batch is None and sum(nnz) == total and max(nnz) < total
             and [b.device for b in shards] == list(mesh.axis_devices("batch")))
    model = re.update_model(re.initialize_model(), None)
    owners = list(mesh.axis_devices("model"))
    blocks = []
    for bm in model.buckets:
        c = bm.coefficients
        rows = int(c.shape[0])
        ok = (isinstance(c, OwnerBlocks) and [p.device for p in c.parts] == owners
              and (rows < len(owners) or all(p.shape[0] < rows for p in c.parts)))
        blocks.append({"entities": rows, "block_rows": [int(p.shape[0]) for p in c.parts]
                       if isinstance(c, OwnerBlocks) else None, "per_owner": ok})
    out = {"fe_shard_nnz": nnz, "fe_batch_nnz": total, "fe_per_shard": fe_ok,
           "re_buckets": blocks}
    if not fe_ok:
        bad.append(f"the fixed effect's batch is not held per shard: {nnz} of {total}")
    if not all(b["per_owner"] for b in blocks):
        bad.append(f"a random effect's coefficients are not held per owner: {blocks}")
    return out


def lane_report(label: str, results, buckets) -> list[dict]:
    """Per bucket of one random-effect update: the histograms of lane
    iterations and reasons, printed; and each lane's objective at the
    returned w held to no more than at its start (a box lane reads both at
    projected points). Returns the rows, each with ``rose``, its count of
    lanes that ended higher."""
    import torch

    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES

    rows = []
    for b, res in enumerate(results):
        reasons = torch.bincount(res.reason.long(), minlength=5).tolist()
        row = {"bucket": b, "entities_rows_k": buckets[b],
               "iterations": torch.bincount(res.iterations.long()).tolist(),
               "reasons": {CONVERGENCE_REASON_NAMES[r]: c for r, c in enumerate(reasons) if c},
               "rose": int((res.value > res.values[:, 0]).sum())}
        rows.append(row)
        print(f"path {label} lanes {json.dumps(row)}", flush=True)
    return rows


def check_coo_bucket_kernels(block, w) -> dict:
    """Path 9's kernels at the shapes of its largest COO bucket (a
    block-diagonal batch): ``csr_margins``, ``csc_scatter`` (plain and
    square) and ``hv_at``, each against its plain version and a second
    launch; ``csr_margins`` and ``csc_scatter`` timed against ``torch.mv`` of
    the same CSR and transposed CSR, beside their bounds; then the lane
    kernels' four variants at G = SWEEP_LANES as ``fit_sweep`` launches them
    there (``run_lane_variants``), timed against ``torch.sparse.mm``."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference

    c = block.csr
    n, f, nnz = c.num_rows, c.num_features, c.nnz
    gen = torch.Generator(device="cuda").manual_seed(7)
    per_row = torch.randn(n, generator=gen, device="cuda")
    d2 = torch.rand(n, generator=gen, device="cuda")
    w = w.reshape(-1).contiguous()
    plain = c.column_major()
    out = {}
    for name, cases in {
        "csr_margins": [("coo dot_rows", lambda: kernels.csr_margins(*c._csr, w, c.offsets, 0.0,
                                                                     False),
                         lambda: reference.csr_margins(*c._csr, w, c.offsets, 0.0, False))],
        "csc_scatter": [("coo scatter", lambda: kernels.csc_scatter(*c._csc, per_row, False,
                                                                    c.tiles),
                         lambda: reference.csc_scatter(*plain, per_row, False)),
                        ("coo scatter_sq", lambda: kernels.csc_scatter(*c._csc, d2, True,
                                                                       c.tiles),
                         lambda: reference.csc_scatter(*plain, d2, True))],
        "hv_at": [("coo hv_at", lambda: kernels.hv_at(c._csr, c._csc, d2, w, 0.0, c.tiles)[0],
                   lambda: reference.hv_at(c._csr, plain, d2, w, 0.0)[0])],
    }.items():
        worst, timed = run_variants(name, cases)
        out[name] = {"max_abs_err": worst, "ms": timed[cases[0][0]][0],
                     "plain_ms": timed[cases[0][0]][1]}
    margin_bytes = 4 * ((n + 1) + 2 * nnz + f + n)
    scatter_bytes = 4 * ((f + 1) + 2 * nnz + n + f)
    out["csr_margins"].update(
        bound_ms=max(margin_bytes / PEAK_BYTES_PER_S, 2 * nnz / PEAK_F32_FLOPS) * 1e3,
        library_ms=library_ms(lambda: torch.sparse_csr_tensor(*c._csr, size=(n, f),
                                                              check_invariants=False),
                              lambda m: torch.mv(m, w)))
    out["csc_scatter"].update(
        bound_ms=max(scatter_bytes / PEAK_BYTES_PER_S, 2 * nnz / PEAK_F32_FLOPS) * 1e3,
        library_ms=library_ms(lambda: torch.sparse_csr_tensor(*plain, size=(f, n),
                                                              check_invariants=False),
                              lambda m: torch.mv(m, per_row)))
    # the lane kernels at G = SWEEP_LANES over the same batch, as
    # BlockDiagonalLanes launches them in fit_sweep: W [G, E*K] (too wide to
    # stage: the margins' L2 regime), R [G, E*R]
    G = SWEEP_LANES
    W = torch.randn(G, f, generator=gen, device="cuda") * 0.1
    W[0] = w
    R = torch.randn(G, n, generator=gen, device="cuda")
    off = torch.randn(G, n, generator=gen, device="cuda") * 0.1
    sh = torch.randn(G, generator=gen, device="cuda")
    res = run_lane_variants(lane_cases(c._csr, c._csc, c.tiles, plain, c.offsets, W, R, off,
                                       sh), G, f"coo G={G}")
    t_w, t_r = W.t().contiguous(), R.t().contiguous()
    libs = {
        "csr_margins_lanes": library_ms(lambda: torch.sparse_csr_tensor(
            *c._csr, size=(n, f), check_invariants=False), lambda m: torch.sparse.mm(m, t_w)),
        "csc_scatter_lanes": library_ms(lambda: torch.sparse_csr_tensor(
            *plain, size=(f, n), check_invariants=False), lambda m: torch.sparse.mm(m, t_r)),
    }
    for name, (nbytes, floor_bytes) in lane_design_bytes(n, f, nnz, G, c.tiles).items():
        worst, timed, singles_ms = res[name]
        first = next(iter(timed))
        out[name] = {"lanes": G, "max_abs_err": worst, "ms": timed[first][0],
                     "plain_ms": timed[first][1], "variants_ms": {k: v[0] for k, v in timed.items()},
                     "singles_ms": singles_ms, "library_ms": libs[name],
                     "bound_ms": max(nbytes / PEAK_BYTES_PER_S,
                                     2 * nnz * G / PEAK_F32_FLOPS) * 1e3,
                     "design_floor_ms": floor_bytes / PEAK_BYTES_PER_S * 1e3}
    del W, R, off, t_w, t_r
    t = c.tiles
    out["shape"] = {"entities": block.num_entities, "rows": n, "columns": f, "nnz": nnz,
                    "tile_slots": t.n_slots, "tile_pieces": t.n_pieces,
                    "index_bytes": 4 * t.index.numel(), "nnz_per_segment": nnz / t.n_slots}
    for name in ("csr_margins", "csc_scatter", "csr_margins_lanes", "csc_scatter_lanes"):
        r = out[name]
        lanes = (f" lanes={G} singles_ms={r['singles_ms']:.4f} "
                 f"design_floor_ms={r['design_floor_ms']:.4f}") if "lanes" in r else ""
        print(f"path 9 largest coo bucket {name}: kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']:.4f}{lanes} shape={json.dumps(out['shape'])}",
              flush=True)
    return out


def check_variances(model, gds, red, opt, n_lanes: int, seed: int) -> float:
    """The per-user variances on ``n_lanes`` lanes drawn from ``seed``,
    against 1 / (diag H + 1e-12) recomputed by plain float64 numpy on the
    host from the bucket's dense design, the final model's other scores as
    the residual, and the lane's coefficients. Returns the largest relative
    difference."""
    import torch

    from photon_ml_tpu_torch.game import random_effect_data

    user = model.models["per-user"]
    residual = (model.models["fixed"].score(gds) + model.models["per-user-items"].score(gds))
    residual = residual.double().cpu().numpy()
    sizes = np.array([b.num_entities for b in red.buckets])
    rng = np.random.default_rng(seed + 5)
    picks = rng.choice(sizes.sum(), size=min(n_lanes, int(sizes.sum())), replace=False)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    l2 = opt.regularization.l2_weight(opt.regularization_weight)
    worst = 0.0
    for bi, (b, bm) in enumerate(zip(red.buckets, user.buckets)):
        lanes = picks[(picks >= starts[bi]) & (picks < starts[bi + 1])] - starts[bi]
        if not len(lanes):
            continue
        x = random_effect_data._bucket_dense_design(b)[lanes].astype(np.float64)
        ri = b.row_index[lanes]
        off = b.offsets[lanes] + np.where(ri >= 0, residual[np.maximum(ri, 0)], 0.0)
        w = bm.coefficients[torch.from_numpy(lanes)].double().cpu().numpy()
        z = np.einsum("erk,ek->er", x, w) + off
        p = 1.0 / (1.0 + np.exp(-z))
        diag = np.einsum("er,erk->ek", b.weights[lanes] * p * (1.0 - p), x * x) + l2
        want = 1.0 / (diag + 1e-12)
        got = bm.variances[torch.from_numpy(lanes)].double().cpu().numpy()
        worst = max(worst, float(np.max(np.abs(got - want) / want)))
    return worst


def run_re_path(gds, seed: int, profile: bool, fe_only_auc: float, card: str,
                keep: dict | None = None):
    """Paths 9, 9b and 9c: the rest of the random-effect coordinate at
    config #4's width, on path 6's dataset. Path 9 is ``GameEstimator.fit``
    (one CD iteration, ``RE_CD_ITERATIONS``) of config #4's fixed effect, a per-user random effect
    over the sparse 10K-feature ``global`` shard under the default optimizer
    type (LBFGS 20, L2 1, tolerance 1e-7: its wide buckets go to the COO
    layout, the block-diagonal batch), and config #4's dense per-user effect
    under NEWTON in the box ``RE_BOX`` with variances, updated last so that
    its variances can be recomputed from the final model's scores. The
    coordinates are built first (the RE builds, the COO layouts), then one
    fit is timed and its model saved and reloaded. 9b and 9c are one update of
    the sparse per-user effect from zero with TRON (L2 1, 10 iterations) and
    with OWLQN (elastic net, alpha 0.5, weight 1, 20 iterations). Fails on
    non-finite coefficients or variances, a lane whose objective rose, a box
    that does not hold, variances that are not positive or disagree with
    their plain recomputation, a train AUC not above the fixed effect's
    alone (path 6), the COO buckets' kernels not launched (``csr_margins``
    and ``csc_scatter`` in path 9, ``hv_at`` in 9b), two scorings or
    evaluations that differ, or a reloaded model that scores differently.
    ``keep`` receives path 9's fitted model (``keep["9"]``, for path 15)."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.data.model_store import load_game_model, save_game_model
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.game import (
        FixedEffectConfig,
        GameConfig,
        GameEstimator,
        RandomEffectConfig,
    )
    from photon_ml_tpu_torch.game.coordinate_descent import ValidationSpec, _evaluate

    fixed_opt = dataclasses.replace(solver_config("lbfgs", 20), regularization_weight=1.0)
    items_opt = re_optimizer("lbfgs", 20, 1e-7)
    user_opt = re_optimizer("newton", 20, 1e-7, RE_BOX)
    config = GameConfig(task="logistic", num_iterations=RE_CD_ITERATIONS, coordinates={
        "fixed": FixedEffectConfig(shard_name="global", optimizer=fixed_opt),
        "per-user-items": RandomEffectConfig(shard_name="global", id_name="userId",
                                             optimizer=items_opt),
        "per-user": RandomEffectConfig(shard_name="user", id_name="userId", optimizer=user_opt,
                                       compute_variances=True),
    })
    est = GameEstimator(config)
    bad = []
    telemetry.reset()
    # the coordinates (the RE builds and the COO layouts) once, then the
    # timed fit on them; its model is saved and reloaded below
    t0 = time.perf_counter()
    est._build_coordinates(gds)
    torch.cuda.synchronize()
    coordinates_s = time.perf_counter() - t0
    spans = telemetry.snapshot()["span_seconds"]
    re_build_s = spans.get("re_build:userId:global", 0.0)
    coo_layout_s = spans.get("re_coo_layout", 0.0)

    coords = est._build_coordinates(gds)
    items, user = coords["per-user-items"], coords["per-user"]
    shapes = {}
    for name, coord in (("per-user-items", items), ("per-user", user)):
        designs = coord.re_data.dense_designs()
        shapes[name] = [(b.num_entities, b.rows_per_entity, b.num_local_features)
                        for b in coord.re_data.buckets]
        layout = ["dense" if x is not None else "coo" for x in designs]
        print(f"path 9 {name} buckets (E,R,K,layout): " + json.dumps(
            [s + (lay,) for s, lay in zip(shapes[name], layout)]), flush=True)
    n_coo = sum(x is None for x in items.re_data.dense_designs())
    total_coeffs = N_FEATURES + sum(e * k for v in shapes.values() for e, _, k in v)

    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = est.fit(gds)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    peak = torch.cuda.max_memory_allocated()

    model = result.model
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as out:
        save_game_model(model, os.path.join(out, "final"))
        loaded = load_game_model(os.path.join(out, "final"))
        same_scores = torch.equal(loaded.score(gds), model.score(gds))
        same_var = all(torch.equal(a.variances, b.variances) for a, b in zip(
            loaded.models["per-user"].buckets, model.models["per-user"].buckets))
    print(f"path 9 saved: coordinates_s={coordinates_s:.4f} (the RE builds and COO layouts) "
          f"re_build_s={re_build_s:.4f} coo_layout_s={coo_layout_s:.4f} "
          f"re_build_user_s={spans.get('re_build:userId:user', 0.0):.4f} "
          f"final_reloaded_scores_bit_identical={same_scores} "
          f"variances_reloaded_bit_identical={same_var}", flush=True)
    if not (same_scores and same_var):
        bad.append("the saved final model scores differently or loses its variances")
    del loaded
    lanes, item_launches = {}, {k: 0 for k in launches}
    for entry in result.history:
        name, it = entry["coordinate"], entry["iteration"]
        print(f"path 9 cd={it} {name}: seconds={entry['seconds']:.4f} "
              f"host_syncs={entry['host_syncs']} launches={json.dumps(entry['launches'])}",
              flush=True)
        if name == "fixed":
            continue
        if name == "per-user-items":
            for k, c in entry["launches"].items():
                item_launches[k] += c
        rows = lane_report(f"9 cd={it} {name}", entry["results"], shapes[name])
        lanes[f"{it}:{name}"] = rows
        if any(r["rose"] for r in rows):
            bad.append(f"cd {it} {name}: a lane's objective rose")
    coeffs = [model.models["fixed"].coefficients] + [
        b.coefficients for n in ("per-user-items", "per-user") for b in model.models[n].buckets]
    variances = [b.variances for b in model.models["per-user"].buckets]
    if not all(bool(c.isfinite().all()) for c in coeffs + variances):
        bad.append("non-finite coefficients or variances")
    if not all(bool((v > 0).all()) for v in variances):
        bad.append("variances not positive")
    lower, upper = user_opt.dense_box_bounds(user.re_data.num_global_features, sentinel=True)
    held, boxed = True, 0
    for b, bm in zip(user.re_data.buckets, model.models["per-user"].buckets):
        w = bm.coefficients.cpu().numpy()
        held &= bool(np.all(w >= lower[b.projection]) and np.all(w <= upper[b.projection]))
        boxed += int((b.projection == RE_BOX[0][0]).sum())
    var_err = check_variances(model, gds, user.re_data, user_opt, VARIANCE_LANES, seed)
    print(f"path 9 checks: box_held={held} entities_with_feature_0={boxed} "
          f"variance_max_rel_err={var_err:.3e} limit={VARIANCE_RTOL:.0e} "
          f"({VARIANCE_LANES} lanes)", flush=True)
    if not held:
        bad.append("the per-user box does not hold")
    if not var_err <= VARIANCE_RTOL:
        bad.append(f"variances disagree with their plain recomputation: {var_err}")
    labels, weights = gds.per_row(gds.response), gds.per_row(gds.weight)
    train_auc = float(auc(model.score(gds) + gds.per_row(gds.offset), labels, weights))
    if not train_auc > fe_only_auc:
        bad.append(f"train auc {train_auc} <= config #4's fixed effect alone {fe_only_auc}")
    missing = [k for k in ("csr_margins", "csc_scatter") if item_launches[k] == 0]
    if missing:
        bad.append(f"the COO buckets did not launch {missing}")
    specs = ["auc", "auc:userId"]
    scores = [model.score(gds) for _ in range(2)]
    evals = [_evaluate(model, ValidationSpec(data=gds, evaluators=specs)) for _ in range(2)]
    same = {"scores": torch.equal(*scores), **{k: evals[0][k] == evals[1][k] for k in specs}}
    print(f"path 9 twice: {' '.join(f'{k}={v:.9g}' for k, v in evals[0].items())} "
          f"bit_identical={json.dumps(same)}", flush=True)
    if not all(same.values()):
        bad.append(f"scores or metrics differ between two calls: {same}")
    coeffs_per_s = total_coeffs * RE_CD_ITERATIONS / elapsed
    stats = {"elapsed_s": elapsed, "coordinates_s": coordinates_s, "re_build_s": re_build_s,
             "coo_layout_s": coo_layout_s, "coeffs_per_s": coeffs_per_s,
             "total_coeffs": total_coeffs, "buckets": shapes, "coo_buckets": n_coo,
             "lanes": lanes, "host_syncs": syncs, "max_memory_allocated": peak,
             "train_auc": train_auc, "fe_only_auc": fe_only_auc, "evaluated": evals[0],
             "bit_identical_twice": same, "variance_max_rel_err": var_err,
             "item_launches": item_launches}
    print(f"path 9: coeffs_per_s={coeffs_per_s:.1f} total_coeffs={total_coeffs} "
          f"fit_wall_s={elapsed:.4f} host_syncs={syncs} max_memory_allocated={peak} "
          f"coo_buckets={n_coo} train_auc={train_auc:.6f} fe_only_auc={fe_only_auc:.6f} "
          f"launches={json.dumps(launches)} per_user_items_launches="
          f"{json.dumps(item_launches)} card={card}", flush=True)
    prof = None
    if profile:
        def refit():
            est.fit(gds)

        prof = profile_solve("9", refit)

    # the largest COO bucket's kernels, outside the counted window
    coo = [c for c in items.re_data.coo_buckets(gds.device) if c is not None]
    pos = max(range(len(coo)), key=lambda i: coo[i].block.csr.nnz)
    bucket_pos = [i for i, c in enumerate(items.re_data.coo_buckets(gds.device))
                  if c is not None][pos]
    coo_kernels = check_coo_bucket_kernels(
        coo[pos].block, model.models["per-user-items"].buckets[bucket_pos].coefficients)
    stats["largest_coo_bucket"] = coo_kernels
    if keep is not None:
        keep["9"] = model
    del result, model, scores

    sub = {"9": launches}
    for label, kind, iters, required in (("9b", "tron", 10, "hv_at"),
                                         ("9c", "owlqn", 20, None)):
        coord = dataclasses.replace(items, config=re_optimizer(kind, iters, 1e-7))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        telemetry.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = coord.update_model(coord.initialize_model(), None)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sub[label] = dict(kernels.LAUNCHES)
        s_syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
        rows = lane_report(label, coord.last_results, shapes["per-user-items"])
        finite = all(bool(b.coefficients.isfinite().all()) for b in m.buckets)
        stats[label] = {"seconds": dt, "host_syncs": s_syncs, "lanes": rows,
                        "max_memory_allocated": torch.cuda.max_memory_allocated(),
                        "launches": sub[label]}
        print(f"path {label}: optimizer={kind} seconds={dt:.4f} host_syncs={s_syncs} "
              f"max_memory_allocated={stats[label]['max_memory_allocated']} "
              f"launches={json.dumps(sub[label])}", flush=True)
        if not finite or any(r["rose"] for r in rows):
            bad.append(f"path {label}: non-finite coefficients or a lane's objective rose")
        if required and sub[label][required] == 0:
            bad.append(f"path {label}: {required} not launched on the COO buckets")
        del m
    sub["11b"], stats["11b"], projected = run_projector_path(gds, items,
                                                             shapes["per-user-items"], card, bad)
    sub["17b"], stats["17b"] = run_mesh_projector_path(gds, items, *projected, card, bad)
    del projected
    if bad:
        raise RuntimeError(f"path 9: bad result: {bad}")
    return sub, stats, prof


def run_projector_path(gds, items, shapes, card: str, bad: list) -> tuple[dict, dict]:
    """Path 11b: the random projector on path 9's sparse per-user effect (its
    dataset: 10 buckets over the 10K-feature shard, the 3 widest on COO),
    built as ``GameEstimator`` builds a ``projector: random`` random effect:
    one update from zero in a PROJECTED_DIM-dim Gaussian space, LBFGS 20, L2
    1, tolerance 1e-7. Adds to ``bad`` a lane whose objective rose, a score
    that is not finite, two scorings that differ, or a saved model (type
    ``factored_random_effect``) that reloads to other scores."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.data.model_store import (
        load_game_model,
        load_game_model_metadata,
        save_game_model,
    )
    from photon_ml_tpu_torch.game import FactoredRandomEffectCoordinate, GameModel

    opt = re_optimizer("lbfgs", 20, 1e-7)
    coord = FactoredRandomEffectCoordinate(
        "per-user-projected", gds, items.re_data, "logistic", opt, opt,
        latent_dim=PROJECTED_DIM, refit_projection=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model = coord.update_model(coord.initialize_model(), None)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    rows = lane_report("11b", coord.last_results, shapes)
    scores = [coord.score(model) for _ in range(2)]
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    with tempfile.TemporaryDirectory(dir=build_dir) as out:
        game = GameModel(task="logistic", models={"per-user-projected": model})
        save_game_model(game, out)
        kind = load_game_model_metadata(out)["coordinates"]["per-user-projected"]["type"]
        reloaded = torch.equal(load_game_model(out).score(gds), game.score(gds))
    checks = {"lanes_rose": sum(r["rose"] for r in rows),
              "finite": bool(scores[0].isfinite().all()),
              "twice": torch.equal(*scores), "saved_type": kind, "reloaded": reloaded}
    stats = {"seconds": dt, "host_syncs": syncs, "lanes": rows, "launches": launches,
             "max_memory_allocated": torch.cuda.max_memory_allocated(), **checks}
    print(f"path 11b: projected_dim={PROJECTED_DIM} seconds={dt:.4f} host_syncs={syncs} "
          f"max_memory_allocated={stats['max_memory_allocated']} checks={json.dumps(checks)} "
          f"launches={json.dumps(launches)} card={card}", flush=True)
    if checks["lanes_rose"] or not (checks["finite"] and checks["twice"] and reloaded
                                    and kind == "factored_random_effect"):
        bad.append(f"path 11b: {checks}")
    return launches, stats, (coord, model, scores[0])


def _owner_mesh():
    from photon_ml_tpu_torch.parallel import make_mesh

    devices, kind = mesh_devices(MESH_OWNERS)
    return make_mesh({"model": MESH_OWNERS}, devices), devices, kind


def run_mesh_projector_path(gds, items, coord, model, scores, card: str,
                            bad: list) -> tuple[dict, dict]:
    """Path 17b: 11b's random projector (the same dataset, optimizer and
    Gaussian space) on a ``model`` axis of 4: each owner's block of every
    bucket solved on its device. Adds to ``bad`` a latent table or scores
    off 11b's beyond rtol/atol 5e-3 (tests/test_factored.py:310-320), or a
    ``csr_margins`` that did not launch (the COO buckets' latent designs)."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.game import FactoredRandomEffectCoordinate

    mesh, devices, kind = _owner_mesh()
    t0 = time.perf_counter()
    sharded = FactoredRandomEffectCoordinate(
        coord.name, gds, items.re_data, "logistic", coord.re_config, coord.latent_config,
        latent_dim=coord.latent_dim, refit_projection=False, mesh=mesh)
    _sync(devices)
    build_s = time.perf_counter() - t0
    _reset_peaks(devices)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = sharded.update_model(sharded.initialize_model(), None)
    _sync(devices)
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    got_scores = sharded.score(got)
    diffs = {"latent": float((got.latent - model.latent).abs().max()),
             "scores": float((got_scores - scores).abs().max())}
    close = {"latent": torch.allclose(got.latent, model.latent, **FACTORED_MESH_TOL),
             "scores": torch.allclose(got_scores, scores, **FACTORED_MESH_TOL)}
    stats = {"devices": [str(d) for d in devices], "kind": kind, "build_s": build_s,
             "seconds": dt, "max_abs_diff_vs_11b": diffs, "within_tolerance": close,
             "launches": launches, "max_memory_allocated_by_device": _peaks(devices),
             "card": card}
    print(f"path 17b: projector on a model axis of {MESH_OWNERS} over {kind}; "
          f"{json.dumps(stats)}", flush=True)
    if not all(close.values()):
        bad.append(f"path 17b: off 11b beyond {FACTORED_MESH_TOL}: {diffs}")
    if not launches["csr_margins"]:
        bad.append("path 17b: csr_margins not launched on the owners' COO buckets")
    return launches, stats


def numpy_summary(values, cols, n_rows: int, n_features: int) -> dict:
    """The reference's summary (``photon_ml_tpu/data/stats.py``) in float64
    numpy over the nonzeros as entries: every row valid, zeros counted in the
    mean and variance, max and min over the nonzero entries and 0 where a
    feature has fewer nonzero entries than rows."""
    nz = values != 0
    s1 = np.bincount(cols, weights=values, minlength=n_features)
    s2 = np.bincount(cols, weights=values * values, minlength=n_features)
    count = np.bincount(cols, weights=nz, minlength=n_features)
    order = np.argsort(cols, kind="stable")
    starts = np.searchsorted(cols[order], np.arange(n_features))
    present = values[order]
    hi = np.maximum.reduceat(np.where(nz[order], present, -np.inf), starts)
    lo = np.minimum.reduceat(np.where(nz[order], present, np.inf), starts)
    some_zero = count < n_rows
    hi = np.where(count == 0, 0.0, np.where(some_zero, np.maximum(hi, 0.0), hi))
    lo = np.where(count == 0, 0.0, np.where(some_zero, np.minimum(lo, 0.0), lo))
    mean = s1 / n_rows
    return {"mean": mean, "variance": (s2 - n_rows * mean * mean) / (n_rows - 1),
            "max": hi, "min": lo, "num_nonzeros": count}


def run_data_plane_path(seed: int, card: str, work: str) -> tuple[dict, dict, dict]:
    """Path 8: config #1's draws as LIBSVM files in ``work`` (left there for
    path 10), through the data plane as a user calls it: the native parser,
    ``to_batch`` onto the card, ``validate``, ``summarize`` twice, a
    standardized ``train_glm`` picked by held-out AUC, each lambda's held-out
    metric map (``diagnostics.evaluate``), and ``save_glm`` / ``load_glm``.
    Returns the launches, the stats, and what path 10's ``cli glm`` must
    repeat bit for bit: the files, the best lambda and its AUC, each
    lambda's metrics and means. Fails unless the parsed
    arrays equal the draws as written, the two summaries are bit-identical
    and within the reference test's tolerances of a float64 numpy summary,
    the scatter kernel launched in ``summarize``, the loss fell from the
    sweep's start (and no solve ended above its own start) with finite
    coefficients and train AUC above 0.6, and the loaded model's means and
    held-out scores are bit-identical to the trained one's."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.data import (
        ValidationMode,
        build_normalization_context,
        read_libsvm,
        summarize,
        validate,
    )
    from photon_ml_tpu_torch.data.libsvm import write_libsvm
    from photon_ml_tpu_torch.data.model_store import load_glm, save_glm
    from photon_ml_tpu_torch.diagnostics import evaluate
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.training import select_best_model, train_glm

    stats, bad = {}, []
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    values, rows, cols, y, w_true = draw_problem(rng, N_ROWS, N_FEATURES, NNZ_PER_ROW)
    h_values, h_rows, h_cols, h_y, _ = draw_problem(rng, N_HELDOUT, N_FEATURES,
                                                    NNZ_PER_ROW, w_true)
    stats["draw_s"] = time.perf_counter() - t0
    train_path, heldout_path = os.path.join(work, "train.libsvm"), os.path.join(
        work, "heldout.libsvm")
    t0 = time.perf_counter()
    written = write_libsvm(train_path, values, rows, cols, 2.0 * y - 1.0)
    write_libsvm(heldout_path, h_values, h_rows, h_cols, 2.0 * h_y - 1.0)
    stats["write_s"] = time.perf_counter() - t0
    stats["file_bytes"] = os.path.getsize(train_path) + os.path.getsize(heldout_path)
    del values, h_values
    print(f"path 8 write: rows={N_ROWS}+{N_HELDOUT} bytes={stats['file_bytes']} "
          f"write_s={stats['write_s']:.4f}", flush=True)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    data = read_libsvm(train_path, engine="native")
    heldout_data = read_libsvm(heldout_path, engine="native")
    stats["parse_s"] = time.perf_counter() - t0
    same = (np.array_equal(data.rows, rows) and np.array_equal(data.cols, cols)
            and np.array_equal(data.values, written) and np.array_equal(data.labels, y))
    if not same:
        raise RuntimeError("path 8: the parsed rows, columns or values differ from the "
                           "draws as written")
    t0 = time.perf_counter()
    batch = data.to_batch(num_features=N_FEATURES, add_intercept=True)
    heldout = heldout_data.to_batch(num_features=N_FEATURES, add_intercept=True)
    torch.cuda.synchronize()
    stats["build_s"] = time.perf_counter() - t0
    stats.update(rows=batch.num_rows, nnz=batch.nnz)
    t0 = time.perf_counter()
    validate(batch, "logistic", mode=ValidationMode.FULL)
    stats["validate_s"] = time.perf_counter() - t0
    print(f"path 8 read: rows={batch.num_rows} nnz={batch.nnz} "
          f"parse_s={stats['parse_s']:.4f} build_s={stats['build_s']:.4f} "
          f"validate_s={stats['validate_s']:.4f}", flush=True)

    scatter_before = kernels.LAUNCHES["csc_scatter"]
    summaries = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summaries.append(summarize(batch))
        torch.cuda.synchronize()
        stats.setdefault("summarize_s", []).append(time.perf_counter() - t0)
    stats["summarize_scatter_launches"] = kernels.LAUNCHES["csc_scatter"] - scatter_before
    first, again = (dataclasses.asdict(x) for x in summaries)
    identical = all(torch.equal(first[k], again[k]) for k in first)
    want = numpy_summary(written, cols, N_ROWS, N_FEATURES)
    got = {k: first[k][:N_FEATURES].double().cpu().numpy() for k in want}
    checks = {
        "mean": np.allclose(got["mean"], want["mean"], rtol=1e-4, atol=1e-5),
        "variance": np.allclose(got["variance"], want["variance"], rtol=1e-3, atol=1e-5),
        "max": np.array_equal(got["max"], want["max"].astype(np.float32)),
        "min": np.array_equal(got["min"], want["min"].astype(np.float32)),
        "num_nonzeros": np.array_equal(got["num_nonzeros"], want["num_nonzeros"]),
        "intercept": (float(first["mean"][N_FEATURES]) == 1.0
                      and float(first["variance"][N_FEATURES]) == 0.0),
    }
    errs = {k: float(np.max(np.abs(got[k] - want[k]))) for k in ("mean", "variance")}
    print(f"path 8 summarize: summarize_s={stats['summarize_s']} "
          f"scatter_launches={stats['summarize_scatter_launches']} "
          f"bit_identical={identical} checks={json.dumps(checks)} "
          f"max_abs_err={json.dumps(errs)}", flush=True)
    if not identical:
        bad.append("two summaries differ")
    if not all(checks.values()):
        bad.append(f"summary against float64 numpy: {checks}")
    if stats["summarize_scatter_launches"] == 0:
        bad.append("csc_scatter did not launch in summarize")
    del rows, cols, written

    t0 = time.perf_counter()
    ctx = build_normalization_context("standardization", summaries[0],
                                      data.intercept_index)
    entries = train_glm(batch, "logistic", [10.0, 1.0], solver_config("lbfgs", 20),
                        normalization=ctx)
    best, heldout_auc = select_best_model(entries, heldout)
    torch.cuda.synchronize()
    stats["train_s"] = time.perf_counter() - t0
    model = best.model
    # lambda 1 starts at lambda 10's optimum, which standardization leaves
    # within float32 rounding of its own: each solve must end no higher
    # than it began, and below the sweep's start, the zero model
    sweep_loss0 = max(float(e.result.values[0]) for e in entries)
    for e in entries:
        res = e.result
        loss0, loss = float(res.values[0]), float(res.value)
        train_auc = float(auc(e.model.compute_score(batch), batch.labels, batch.weights))
        print(f"path 8 lambda={e.reg_weight}: iterations={res.iterations} "
              f"reason={CONVERGENCE_REASON_NAMES[res.reason]} loss0={loss0:.7g} "
              f"loss={loss:.7g} train_auc={train_auc:.6f}", flush=True)
        if not (loss <= loss0 and loss < sweep_loss0):
            bad.append(f"lambda {e.reg_weight}: loss did not fall")
        if not bool(e.model.coefficients.means.isfinite().all()):
            bad.append(f"lambda {e.reg_weight}: non-finite coefficients")
        if not train_auc > 0.6:
            bad.append(f"lambda {e.reg_weight}: train auc {train_auc}")
    stats.update(best_lambda=best.reg_weight, heldout_auc=heldout_auc)
    reference = {"train_path": train_path, "heldout_path": heldout_path,
                 "best_lambda": best.reg_weight, "heldout_auc": heldout_auc,
                 "metrics": {e.reg_weight: evaluate(e.model, heldout) for e in entries},
                 "means": {e.reg_weight: e.model.coefficients.means.cpu() for e in entries}}

    t0 = time.perf_counter()
    model_dir = os.path.join(work, "glm")
    save_glm(model, model_dir)
    loaded = load_glm(model_dir)
    stats["save_load_s"] = time.perf_counter() - t0
    same_means = torch.equal(loaded.coefficients.means, model.coefficients.means)
    same_scores = torch.equal(loaded.compute_score(heldout), model.compute_score(heldout))
    torch.cuda.synchronize()
    stats["path_s"] = time.perf_counter() - t_path
    launches = dict(kernels.LAUNCHES)
    print(f"path 8 model: best_lambda={best.reg_weight} heldout_auc={heldout_auc:.6f} "
          f"train_s={stats['train_s']:.4f} save_load_s={stats['save_load_s']:.4f} "
          f"means_bit_identical={same_means} heldout_scores_bit_identical={same_scores}",
          flush=True)
    if not (same_means and same_scores):
        bad.append("the loaded model differs from the saved one")
    print(f"path 8: rows={stats['rows']} nnz={stats['nnz']} write_s={stats['write_s']:.4f} "
          f"parse_s={stats['parse_s']:.4f} build_s={stats['build_s']:.4f} "
          f"validate_s={stats['validate_s']:.4f} "
          f"summarize_s={' '.join(f'{t:.4f}' for t in stats['summarize_s'])} "
          f"train_s={stats['train_s']:.4f} save_load_s={stats['save_load_s']:.4f} "
          f"path_s={stats['path_s']:.4f} launches={json.dumps(launches)} card={card}",
          flush=True)
    if bad:
        raise RuntimeError(f"path 8: bad result: {bad}")
    missing = [k for k in ("csr_margins", "csc_scatter") if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path 8: kernels not launched: {missing}")
    return launches, stats, reference


def _run_cli_in_process(argv: list[str]) -> dict:
    """``photon_ml_tpu_torch.cli.__main__.main(argv)`` in this process; its
    JSON summary (the last line it prints) is returned."""
    import contextlib
    import io

    from photon_ml_tpu_torch.cli.__main__ import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _run_cli_subprocess(argv: list[str], root: str,
                        label: str = "path 10") -> tuple[dict, float]:
    """``python -m photon_ml_tpu_torch.cli <argv>`` from the checkout's root:
    (its JSON summary, its seconds), its timed phases printed under
    ``label``. Fails on a non-zero exit."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.cli", *argv], cwd=root,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"cli {argv[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    for line in proc.stderr.splitlines():  # the driver's timed phases
        if " INFO photon_ml_tpu_torch: " in line:
            print(f"{label} {argv[0]} log: {line.split(' INFO ', 1)[1]}", flush=True)
    return json.loads(proc.stdout.strip().splitlines()[-1]), seconds


def _same_or_both_nan(a: float, b: float) -> bool:
    return a == b or (a != a and b != b)


def run_cli_path(seed: int, card: str, work: str, game: dict,
                 glm_ref: dict) -> tuple[dict, dict, dict]:
    """Path 10: the CLI pipeline at config #4's full width, as a user runs it.
    Path 6's draws go out as TrainingExampleAvro in 4 files through the
    native encoder; ``cli index`` (a subprocess) indexes them; ``cli train``
    (in process, the guard on by default) reads them with the native decoder
    and fits path 6's GLMix; ``cli score`` (a subprocess, on the card by
    default) scores the training files with ``final/``; ``cli glm`` (in
    process) repeats path 8's GLM sweep on its LIBSVM files. Fails unless the
    native reader ran, the dataset equals path 6's draws (columns mapped back
    through the saved index map), the fixed effect's loss per CD iteration is
    within rtol 1e-4 of path 6's, the train AUC within 1e-3 of path 6's GLMix
    AUC and above its fixed effect's alone, the guard neither retried nor
    rolled back, ``final/``, ``best/``, the index maps and the feature
    statistics were written, ``csr_margins`` and ``csc_scatter`` launched,
    the scores read back from the scoring output equal the in-process
    model's plus offsets bit for bit (and the AUC), and ``cli glm``'s stages,
    best lambda, metrics and means equal path 8's bit for bit. Returns, beside
    the launches and the numbers, what path 13 is held against: the input
    spec and config, the in-core dataset, the fitted model and the summary."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.cli import train as cli_train
    from photon_ml_tpu_torch.data.avro import read_scoring_results, write_training_examples_fast
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.data.model_store import load_glm
    from photon_ml_tpu_torch.data.native import load_avro_native
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.game import GameEstimator

    root = os.path.dirname(os.path.abspath(__file__))
    if load_avro_native() is None:
        raise RuntimeError("path 10: the native Avro library (build/native/libphoton_avro.so, "
                           "native/avro_*.cpp with -lz) did not build or load")
    stats, bad = {"card": card}, []

    # 1. path 6's draws as TrainingExampleAvro, 4 files, null codec
    fe_vals, fe_rows, fe_cols, users, Xu, y = make_game_problem(seed)
    data_dir = os.path.join(work, "avro")
    os.makedirs(data_dir)
    names = [f"f{j}" for j in range(N_FEATURES)] + [f"u{k}" for k in range(GAME_RE_FEATURES)]
    vocab = [str(u) for u in range(GAME_USERS)]
    bounds = np.linspace(0, N_ROWS, 5).astype(np.int64)
    t0 = time.perf_counter()
    for part in range(4):
        lo, hi = int(bounds[part]), int(bounds[part + 1])
        m = hi - lo
        bags = {
            "global": (np.arange(m + 1, dtype=np.int64) * NNZ_PER_ROW,
                       fe_cols[lo * NNZ_PER_ROW:hi * NNZ_PER_ROW],
                       fe_vals[lo * NNZ_PER_ROW:hi * NNZ_PER_ROW]),
            "user": (np.arange(m + 1, dtype=np.int64) * GAME_RE_FEATURES,
                     np.tile(np.arange(GAME_RE_FEATURES) + N_FEATURES, m), Xu[lo:hi].ravel()),
        }
        write_training_examples_fast(os.path.join(data_dir, f"part-{part}.avro"), y[lo:hi],
                                     bags, names, {"userId": (users[lo:hi], vocab)})
    stats["write_s"] = time.perf_counter() - t0
    stats["avro_bytes"] = sum(os.path.getsize(os.path.join(data_dir, f))
                              for f in os.listdir(data_dir))
    print(f"path 10 write: rows={N_ROWS} files=4 bytes={stats['avro_bytes']} "
          f"write_s={stats['write_s']:.4f} card={card}", flush=True)

    # 2. cli index, a subprocess
    idx_dir = os.path.join(work, "index")
    index, stats["index_s"] = _run_cli_subprocess(
        ["index", "--input", data_dir, "--output", idx_dir, "--shards", "global:global",
         "user:user", "--no-intercept"], root)
    stats["index_features"] = {k: v["num_features"] for k, v in index.items()}
    print(f"path 10 index: features={json.dumps(stats['index_features'])} "
          f"index_s={stats['index_s']:.4f} card={card}", flush=True)
    if stats["index_features"] != {"global": N_FEATURES, "user": GAME_RE_FEATURES}:
        bad.append(f"cli index wrote {stats['index_features']}")

    # 3. cli train, in process, with path 6's config and the default guard
    out = os.path.join(work, "model")
    inp = {"format": "avro", "paths": [data_dir], "add_intercept": False,
           "feature_shards": {"global": ["global"], "user": ["user"]}, "id_columns": ["userId"]}
    lbfgs = {"type": "lbfgs", "max_iterations": 20, "tolerance": 0.0, "regularization": "l2",
             "regularization_weight": 1.0}
    config = {"task": "logistic", "input": inp, "num_iterations": GAME_CD_ITERATIONS,
              "output_dir": out, "coordinates": {
                  "fixed": {"type": "fixed_effect", "shard_name": "global", "optimizer": lbfgs},
                  "per-user": {"type": "random_effect", "shard_name": "user",
                               "id_name": "userId",
                               "optimizer": {**lbfgs, "type": "newton", "tolerance": 1e-7}}},
              "checkpoint": {"dir": os.path.join(work, "ckpt"), "every": 1, "keep_last": 2}}
    train_cfg = os.path.join(work, "train.json")
    with open(train_cfg, "w") as fh:
        json.dump(config, fh)
    # the driver's dataset and fit result, as it builds them
    seen, read_input, fit = {}, cli_train.read_input, GameEstimator.fit

    def spy_read(*a, **k):
        t = time.perf_counter()
        seen.setdefault("read", read_input(*a, **k))
        stats.setdefault("read_s", time.perf_counter() - t)
        return seen["read"]

    def spy_fit(self, *a, **k):
        t = time.perf_counter()
        seen["fit"] = fit(self, *a, **k)
        torch.cuda.synchronize()
        stats["fit_s"] = time.perf_counter() - t
        return seen["fit"]

    cli_train.read_input, GameEstimator.fit = spy_read, spy_fit
    # with a checkpoint `cli train` installs its SIGTERM/SIGINT handlers; this
    # process keeps its own once it is done
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    torch.cuda.synchronize()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        summary = _run_cli_in_process(["train", "--config", train_cfg])
    finally:
        cli_train.read_input, GameEstimator.fit = read_input, fit
        for s, h in handlers.items():
            signal.signal(s, h)
    torch.cuda.synchronize()
    stats["train_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stats["train_launches"] = dict(launches)
    counters = telemetry.snapshot()["counters"]
    stats.update(avro_reads={k: v for k, v in counters.items() if k.startswith("avro.")},
                 guard={k: counters.get(k, 0) for k in ("solves.diverged", "solves.retried",
                                                       "solves.rolled_back", "solves.frozen")})
    ds, maps = seen["read"]
    model = seen["fit"].model
    if counters.get("avro.native_reads", 0) < 1 or counters.get("avro.python_reads", 0):
        bad.append(f"the native Avro reader did not read the training data: "
                   f"{stats['avro_reads']}")

    # the dataset against path 6's draws, columns mapped back through the maps
    fe_j = np.asarray([int(k[1:]) for k in maps["global"].names])
    u_k = np.asarray([int(k[1:]) for k in maps["user"].names])
    g, u = ds.shard("global"), ds.shard("user")
    same = {
        "labels": np.array_equal(ds.response, y),
        "global": (np.array_equal(g.rows, fe_rows) and np.array_equal(fe_j[g.cols], fe_cols)
                   and np.array_equal(g.values, fe_vals.astype(np.float32))),
        "user": (np.array_equal(u.rows, np.repeat(np.arange(N_ROWS), GAME_RE_FEATURES))
                 and np.array_equal(u_k[u.cols], np.tile(np.arange(GAME_RE_FEATURES), N_ROWS))
                 and np.array_equal(u.values, Xu.ravel().astype(np.float32))),
        "userId": (set(ds.id_columns["userId"].vocab.tolist()) == {str(v) for v in
                                                                   np.unique(users)}
                   and np.array_equal(ds.id_columns["userId"].vocab[ds.id_columns["userId"]
                                      .codes].astype(np.int64), users)),
        "index_maps": all(maps[s].names == IndexMap.load(os.path.join(idx_dir, s)).names
                          for s in ("global", "user")),
    }
    if not all(same.values()):
        bad.append(f"the CLI's dataset differs from path 6's draws: {same}")
    del fe_vals, fe_rows, fe_cols, Xu

    fe_losses = [float(e["results"][0].value) for e in seen["fit"].history
                 if e["coordinate"] == "fixed"]
    # each FE solve's iterations and reason, from its tracker, beside path 6's
    fe_trackers = [e["tracker"] for e in seen["fit"].history if e["coordinate"] == "fixed"]
    for it, (mine, six) in enumerate(zip(fe_trackers, game["fe_trackers"])):
        print(f"path 10 cd={it} fixed tracker: {mine} | path 6: {six}", flush=True)
    ckpt = os.path.join(work, "ckpt")
    steps = sorted(os.listdir(ckpt))
    kept = {"steps": steps, "manifests": all(
        os.path.exists(os.path.join(ckpt, d, "manifest.json")) for d in steps)}
    loss_ok = len(fe_losses) == len(game["fe_losses"]) and all(
        abs(a - b) <= LOSS_RTOL * abs(b) for a, b in zip(fe_losses, game["fe_losses"]))
    labels, weights = ds.per_row(ds.response), ds.per_row(ds.weight)
    scores = model.score(ds).cpu().numpy() + ds.offset
    train_auc = float(auc(ds.per_row(scores), labels, weights))
    written = {p: os.path.exists(os.path.join(out, p)) for p in (
        "final/model-metadata.json", "best/model-metadata.json", "final/feature-indexes/global",
        "final/feature-indexes/user", "best/feature-indexes/global", "best/feature-indexes/user",
        "feature-stats/global.avro", "feature-stats/user.avro")}
    stats.update(fe_trackers=fe_trackers, path6_fe_trackers=game["fe_trackers"],
                 checkpoints=kept)
    stats.update(fe_losses=fe_losses, path6_fe_losses=game["fe_losses"], train_auc=train_auc,
                 path6_auc=game["train_auc"], same=same, written=written, launches=launches,
                 history=[{k: v for k, v in e.items() if k not in ("results", "launches")}
                          for e in summary["history"]])
    print(f"path 10 train: read_s={stats['read_s']:.4f} fit_s={stats['fit_s']:.4f} "
          f"train_s={stats['train_s']:.4f} avro_reads={json.dumps(stats['avro_reads'])} "
          f"dataset_equal={json.dumps(same)} fe_losses={fe_losses} "
          f"path6_fe_losses={game['fe_losses']} train_auc={train_auc:.6f} "
          f"path6_auc={game['train_auc']:.6f} path6_fe_only_auc={game['fe_only_auc']:.6f} "
          f"guard={json.dumps(stats['guard'])} written={json.dumps(written)} "
          f"checkpoints={json.dumps(kept)} launches={json.dumps(launches)} card={card}",
          flush=True)
    if kept != {"steps": ["step-00000002", "step-00000003"], "manifests": True}:
        bad.append(f"cli train kept other checkpoints than steps 2 and 3: {kept}")
    if not loss_ok:
        bad.append(f"fixed-effect losses {fe_losses} vs path 6's {game['fe_losses']}")
    if not (abs(train_auc - game["train_auc"]) <= 1e-3 and train_auc > game["fe_only_auc"]):
        bad.append(f"train auc {train_auc} vs path 6's {game['train_auc']} (fixed effect "
                   f"alone {game['fe_only_auc']})")
    if stats["guard"]["solves.retried"] or stats["guard"]["solves.rolled_back"]:
        bad.append(f"the guard retried or rolled back: {stats['guard']}")
    if not all(written.values()):
        bad.append(f"missing outputs: {written}")
    missing = [k for k in ("csr_margins", "csc_scatter") if launches[k] == 0]
    if missing:
        bad.append(f"kernels not launched in cli train: {missing}")

    # 4. cli score, a subprocess on the card by default, on the training files
    score_cfg = os.path.join(work, "score.json")
    with open(score_cfg, "w") as fh:
        json.dump({"input": inp}, fh)
    scores_path = os.path.join(work, "scores.avro")
    scored, stats["score_s"] = _run_cli_subprocess(
        ["score", "--model-dir", os.path.join(out, "final"), "--config", score_cfg,
         "--output", scores_path, "--evaluators", "auc"], root)
    t0 = time.perf_counter()
    read_back = np.asarray([r["predictionScore"] for r in read_scoring_results(scores_path)])
    stats["score_read_back_s"] = time.perf_counter() - t0
    score_same = {"scores": np.array_equal(read_back, scores),
                  "auc": scored["metrics"]["auc"] == train_auc,
                  "rows": scored["num_rows"] == N_ROWS}
    stats.update(score_same=score_same, score_auc=scored["metrics"]["auc"])
    print(f"path 10 score: score_s={stats['score_s']:.4f} (a subprocess) "
          f"read_back_s={stats['score_read_back_s']:.4f} auc={scored['metrics']['auc']:.9g} "
          f"bit_identical={json.dumps(score_same)} card={card}", flush=True)
    if not all(score_same.values()):
        bad.append(f"cli score differs from the in-process model: {score_same}")
    # what path 13 holds its streamed read and fit against
    handover = {"input": inp, "config": config, "dataset": ds, "maps": maps, "model": model,
                "summary": summary, "train_auc": train_auc}
    del ds, model, seen, scores, read_back
    torch.cuda.empty_cache()

    # 5. cli glm, in process, on path 8's LIBSVM files with path 8's settings
    glm_out = os.path.join(work, "glm_driver")
    glm_cfg = os.path.join(work, "glm.json")
    with open(glm_cfg, "w") as fh:
        json.dump({"task": "logistic", "input": {"format": "libsvm", "num_features": N_FEATURES,
                                                 "paths": [glm_ref["train_path"]]},
                   "validation": {"paths": [glm_ref["heldout_path"]]},
                   "optimizer": {"type": "lbfgs", "max_iterations": 20, "tolerance": 0.0,
                                 "regularization": "l2"},
                   "lambdas": [10.0, 1.0], "normalization": "standardization",
                   "output_dir": glm_out}, fh)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    glm = _run_cli_in_process(["glm", "--config", glm_cfg])
    torch.cuda.synchronize()
    stats["glm_s"] = time.perf_counter() - t0
    for k, n in kernels.LAUNCHES.items():
        launches[k] += n
    glm_same = {
        "stages": glm["stages"] == ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED"],
        "best_lambda": glm["best_lambda"] == glm_ref["best_lambda"],
        "best_metric": glm["best_metric"] == glm_ref["heldout_auc"],
        "metrics": all(
            sorted(glm["metrics"][str(lam)]) == sorted(ref)
            and all(_same_or_both_nan(glm["metrics"][str(lam)][k], v) for k, v in ref.items())
            for lam, ref in glm_ref["metrics"].items()),
        "means": all(torch.equal(load_glm(os.path.join(glm_out, "models", f"lambda-{lam}"))
                                 .coefficients.means.cpu(), ref)
                     for lam, ref in glm_ref["means"].items()),
    }
    stats.update(glm_same=glm_same, glm_best_lambda=glm["best_lambda"],
                 glm_best_metric=glm["best_metric"])
    print(f"path 10 glm: glm_s={stats['glm_s']:.4f} stages={glm['stages']} "
          f"best_lambda={glm['best_lambda']} best_metric={glm['best_metric']:.9g} "
          f"bit_identical_to_path_8={json.dumps(glm_same)} card={card}", flush=True)
    if not all(glm_same.values()):
        bad.append(f"cli glm differs from path 8: {glm_same}")
    print(f"path 10: write_s={stats['write_s']:.4f} index_s={stats['index_s']:.4f} "
          f"train_s={stats['train_s']:.4f} score_s={stats['score_s']:.4f} "
          f"glm_s={stats['glm_s']:.4f} launches={json.dumps(launches)} card={card}",
          flush=True)
    if bad:
        raise RuntimeError(f"path 10: bad result: {bad}")
    return launches, stats, handover


def _same_batches(a, b) -> dict:
    """Two ``CSRBatch``es array for array: the CSR, the mirror in its slot
    order, the row vectors and the scatter's tile index."""
    import torch

    same = {leaf: bool(getattr(a, leaf).dtype == getattr(b, leaf).dtype
                       and torch.equal(getattr(a, leaf), getattr(b, leaf)))
            for leaf in ("row_ptr", "cols", "vals", "col_ptr", "csc_rows", "csc_vals", "labels",
                         "offsets", "weights")}
    same["tiles"] = (a.tiles is not None and b.tiles is not None
                     and torch.equal(a.tiles.index, b.tiles.index)
                     and tuple(a.tiles[1:]) == tuple(b.tiles[1:]))
    return same


def run_ingest_path(card: str, work: str, ref: dict, ref_stats: dict) -> tuple[dict, dict]:
    """Path 13: path 10's Avro files (config #4, 1M rows) through the
    streamed ingest. (a) ``read_game_dataset_streamed`` with a decode worker
    per core, 65,536-row chunks and a staging budget of two slots (a slot's
    real size, the decoder's scratch included, from ``StagingBuffer``; 64 MiB
    does not hold two): the native decoder must read every chunk, the
    staging ring stay within the budget,
    and every array equal path 10's in-core read bit for bit, the
    device-built mirror and tile index against ``from_coo``'s too. (b) A
    ``ChunkStream`` from half its chunks yields exactly the tail of the
    stream. (c) ``cli train`` in process with path 10's config plus the
    ingest: its coefficients and best metric bit for bit path 10's, with the
    same ``csr_margins`` and ``csc_scatter`` launches. Returns the launches
    of (c) and the numbers."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.cli import train as cli_train
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.data.avro import _as_paths
    from photon_ml_tpu_torch.ingest import (
        ChunkStream,
        IngestSpec,
        plan_chunks,
        read_game_dataset_streamed,
    )
    from photon_ml_tpu_torch.ingest.buffers import StagingBuffer

    inp, ref_ds = ref["input"], ref["dataset"]
    workers = os.cpu_count() or 1
    # the budget from the real size of a slot of these files' chunks (the
    # native path's one scratch; the intercept is off)
    rows_cap = max(p.n_rows for p in plan_chunks(_as_paths(inp["paths"]), INGEST_CHUNK_ROWS)[1])
    slot_bytes = StagingBuffer(rows_cap, rows_cap * NNZ_PER_ROW, len(inp["feature_shards"]),
                               len(inp["id_columns"]), inp["add_intercept"], 1, False).nbytes
    budget_bytes = INGEST_BUDGET_SLOTS * slot_bytes
    ingest = {"workers": workers, "chunk_rows": INGEST_CHUNK_ROWS,
              "nnz_per_row_hint": NNZ_PER_ROW, "resident_budget_mb": budget_bytes / 2**20}
    spec = IngestSpec(**ingest)
    stats, bad = {"card": card, "ingest": ingest, "slot_bytes": slot_bytes}, []

    # (a) the streamed read against path 10's in-core one
    torch.cuda.synchronize()
    telemetry.reset()
    t0 = time.perf_counter()
    ds, maps = read_game_dataset_streamed(
        inp["paths"], feature_shards=inp["feature_shards"], id_columns=inp["id_columns"],
        add_intercept=inp["add_intercept"], spec=spec, return_index_maps=True)
    torch.cuda.synchronize()
    stats["read_s"] = time.perf_counter() - t0
    snap = telemetry.snapshot()
    counters, gauges = snap["counters"], snap["gauges"]
    chunks = counters.get("ingest.chunks", 0)
    stats.update(
        rows_per_s=ds.num_rows / stats["read_s"], chunks=chunks,
        stalls=counters.get("ingest.stalls", 0), solve_waits=counters.get("ingest.solve_waits", 0),
        buffer_growths=counters.get("ingest.buffer_growths", 0),
        native_decodes=counters.get("ingest.native_decodes", 0),
        python_decodes=counters.get("ingest.python_decodes", 0),
        staging_bytes=gauges.get("ingest.staging_bytes"),
        span_seconds={k: v for k, v in snap["span_seconds"].items() if k.startswith("ingest")})
    same = {
        "rows": ds.num_rows == ref_ds.num_rows == N_ROWS,
        **{leaf: bool(np.array_equal(getattr(ds, leaf), getattr(ref_ds, leaf)))
           for leaf in ("response", "offset", "weight")},
        "userId": bool(np.array_equal(ds.id_columns["userId"].codes,
                                      ref_ds.id_columns["userId"].codes)
                       and np.array_equal(ds.id_columns["userId"].vocab,
                                          ref_ds.id_columns["userId"].vocab)),
        "index_maps": all(maps[s].names == ref["maps"][s].names for s in maps),
    }
    for name in ("global", "user"):
        a, b = ds.shard(name), ref_ds.shard(name)
        same[f"{name}.coo"] = all(getattr(a, f).dtype == getattr(b, f).dtype
                                  and np.array_equal(getattr(a, f), getattr(b, f))
                                  for f in ("values", "rows", "cols"))
        same.update({f"{name}.{k}": v for k, v in
                     _same_batches(ds.csr_batch(name), ref_ds.csr_batch(name)).items()})
    staging_ok = stats["staging_bytes"] is not None and stats["staging_bytes"] <= budget_bytes
    native_ok = stats["native_decodes"] == chunks > 0 and stats["python_decodes"] == 0
    print(f"path 13 read: read_s={stats['read_s']:.4f} path10_read_s={ref_stats['read_s']:.4f} "
          f"rows_per_s={stats['rows_per_s']:.1f} chunks={chunks} workers={workers} "
          f"stalls={stats['stalls']} solve_waits={stats['solve_waits']} "
          f"buffer_growths={stats['buffer_growths']} native_decodes={stats['native_decodes']} "
          f"python_decodes={stats['python_decodes']} staging_bytes={stats['staging_bytes']} "
          f"slot_bytes={slot_bytes} budget_bytes={budget_bytes} "
          f"fits_64MiB={budget_bytes <= 64 * 2**20} "
          f"spans={json.dumps(stats['span_seconds'])} bit_identical={json.dumps(same)} "
          f"card={card}", flush=True)
    if not all(same.values()):
        bad.append(f"the streamed dataset differs from path 10's in-core read: {same}")
    if not staging_ok:
        bad.append(f"staging ring {stats['staging_bytes']} bytes over the "
                   f"{budget_bytes}-byte budget")
    if not native_ok:
        bad.append(f"not every chunk went through the native decoder: {counters}")

    # (b) a stream resumed at half its chunks yields the tail
    t0 = time.perf_counter()
    start = chunks // 2
    tail_same, n_tail = [], 0
    with ChunkStream(inp["paths"], feature_shards=inp["feature_shards"], index_maps=maps,
                     id_columns=inp["id_columns"], add_intercept=inp["add_intercept"],
                     spec=spec, start_chunk=start) as stream:
        plans = stream.plans[start:]
        batches = {name: ds.csr_batch(name) for name in ("global", "user")}
        vocab = ds.id_columns["userId"].vocab
        for chunk, plan in zip(stream, plans):
            n_tail += 1
            lo, hi = chunk.row_start, chunk.row_start + chunk.rows
            ok = (chunk.index == plan.index and lo == plan.row_start
                  and np.array_equal(chunk.labels, ds.response[lo:hi])
                  and np.array_equal(chunk.offsets, ds.offset[lo:hi])
                  and np.array_equal(chunk.weights, ds.weight[lo:hi]))
            ids = stream.id_vocabulary("userId")[chunk.id_codes["userId"]]
            ok = ok and np.array_equal(ids, vocab[ds.id_columns["userId"].codes[lo:hi]])
            for name, b in batches.items():
                csr = chunk.shards[name]
                p0, p1 = int(b.row_ptr[lo]), int(b.row_ptr[hi])
                ok = ok and torch.equal(csr.row_ptr, b.row_ptr[lo:hi + 1] - p0)
                ok = ok and torch.equal(csr.cols, b.cols[p0:p1])
                ok = ok and torch.equal(csr.vals, b.vals[p0:p1])
            tail_same.append(bool(ok))
    stats["resume"] = {"start_chunk": start, "chunks": n_tail,
                       "expected": chunks - start, "all_equal": all(tail_same),
                       "native_decoder": stream.using_native_decoder,
                       "seconds": time.perf_counter() - t0}
    print(f"path 13 resume: {json.dumps(stats['resume'])} card={card}", flush=True)
    if not (all(tail_same) and n_tail == chunks - start > 0 and stream.using_native_decoder):
        bad.append(f"the stream resumed at chunk {start} is not the tail: {stats['resume']}")
    del ds, batches
    torch.cuda.empty_cache()

    # (c) cli train through the ingest, against path 10's fit
    out = os.path.join(work, "model13")
    config = {**ref["config"], "output_dir": out, "input": {**inp, "ingest": ingest},
              "checkpoint": {**ref["config"]["checkpoint"], "dir": os.path.join(work, "ckpt13")}}
    cfg_path = os.path.join(work, "train13.json")
    with open(cfg_path, "w") as fh:
        json.dump(config, fh)
    seen, read_input, fit = {}, cli_train.read_input, GameEstimator.fit

    def spy_read(*a, **k):
        t = time.perf_counter()
        seen.setdefault("read", read_input(*a, **k))
        stats.setdefault("train_read_s", time.perf_counter() - t)
        return seen["read"]

    def spy_fit(self, *a, **k):
        seen["fit"] = fit(self, *a, **k)
        return seen["fit"]

    cli_train.read_input, GameEstimator.fit = spy_read, spy_fit
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    torch.cuda.synchronize()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        summary = _run_cli_in_process(["train", "--config", cfg_path])
    finally:
        cli_train.read_input, GameEstimator.fit = read_input, fit
        for s_, h in handlers.items():
            signal.signal(s_, h)
    torch.cuda.synchronize()
    stats["train_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    mine, theirs = _model_tensors(seen["fit"].model), _model_tensors(ref["model"])
    fit_same = {
        "coefficients": sorted(mine) == sorted(theirs) and all(
            torch.equal(mine[k], theirs[k]) for k in theirs),
        "best_metric": _same_or_both_nan(summary["best_metric"], ref["summary"]["best_metric"])
        if summary["best_metric"] is not None else ref["summary"]["best_metric"] is None,
        "trackers": [e.get("tracker") for e in summary["history"]]
        == [e.get("tracker") for e in ref["summary"]["history"]],
        "launches": all(launches[k] == ref_stats["train_launches"][k]
                        for k in ("csr_margins", "csc_scatter")),
    }
    ds13 = seen["read"][0]
    scores = seen["fit"].model.score(ds13).cpu().numpy() + ds13.offset
    from photon_ml_tpu_torch.evaluation.evaluators import auc

    train_auc = float(auc(ds13.per_row(scores), ds13.per_row(ds13.response),
                          ds13.per_row(ds13.weight)))
    fit_same["train_auc"] = train_auc == ref["train_auc"]
    stats.update(fit_same=fit_same, launches=launches, train_auc=train_auc,
                 best_metric=summary["best_metric"])
    print(f"path 13 train: train_s={stats['train_s']:.4f} "
          f"path10_train_s={ref_stats['train_s']:.4f} read_s={stats['train_read_s']:.4f} "
          f"path10_read_s={ref_stats['read_s']:.4f} train_auc={train_auc:.9g} "
          f"best_metric={summary['best_metric']} bit_identical_to_path_10={json.dumps(fit_same)} "
          f"launches={json.dumps(launches)} path10_launches="
          f"{json.dumps(ref_stats['train_launches'])} card={card}", flush=True)
    if not all(fit_same.values()):
        bad.append(f"cli train through the ingest differs from path 10's: {fit_same}")
    missing = [k for k in ("csr_margins", "csc_scatter") if launches[k] == 0]
    if missing:
        bad.append(f"kernels not launched in path 13's cli train: {missing}")
    if bad:
        raise RuntimeError(f"path 13: bad result: {bad}")
    return launches, stats


def scale_chunk(seed: int, part_seed: int, index: int, entities: int, rows: int, dims: int):
    """bench_scale.py:60-74's planted logistic chunk, made on the card
    (``tools/fleet.scale_rows``: X ~ N(0, 1), w* ~ N(0, 0.3), offsets N(0,
    0.2), labels Bernoulli(sigmoid(X.w* + offset)), each block of 31,250
    entities from its own seeded generator, so path 18's members make their
    rows of a chunk alone, the same bits)."""
    from photon_ml_tpu_torch.tools.fleet import scale_rows

    return scale_rows(seed, part_seed, index, 0, entities, rows, dims)


def scale_config():
    """bench_scale.py:49-55's solver: logistic LBFGS 8, tolerance 1e-5,
    history 4, L2 1."""
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )

    return OptimizerConfig(max_iterations=8, tolerance=1e-5, lbfgs_history=4,
                           regularization=RegularizationContext(RegularizationType.L2),
                           regularization_weight=1.0)


def run_scale_path(seed: int, card: str, work: str, profile: bool,
                   keep: dict | None = None) -> tuple[dict, dict, dict | None]:
    """Path 13b: ``StreamingRandomEffectTrainer`` at bench_scale.py's three
    parts (1,056,000,000 coefficients), chunks made on the card; per part one
    untimed warm-up chunk, then the timed pass over a fresh table
    (``game_1B_coeffs_trained_per_sec``: coefficients over timed seconds, as
    bench_scale.py defines it), then a tracker pass over the first chunk.
    Fails unless every coefficient is finite, no lane's objective rose above
    its value at w = 0, per_user_re's first two chunks give the timed table's
    rows bit for bit with prefetch on and off and fed from pinned host memory
    (the side-stream upload), mf_latent checkpointed after its first chunk
    and resumed gives the timed table bit for bit, and a small chunk trains
    on the card as on the CPU (per lane the same reason, the value within
    rtol 1e-4, the same iterations but on plateau lanes)."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.game import (
        CheckpointSpec,
        ShardedCoefficientTable,
        StreamingCheckpointManager,
        StreamingRandomEffectTrainer,
    )
    from photon_ml_tpu_torch.ops.dense import DenseBatch

    cfg = scale_config()
    stats, bad, prof = {"card": card, "parts": []}, [], None
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for name, n, dims, per, rows, part_seed in SCALE_PARTS:
        chunks = [(start, (lambda i=i: scale_chunk(seed, part_seed, i, per, rows, dims)))
                  for i, start in enumerate(range(0, n, per))]
        trainer = StreamingRandomEffectTrainer("logistic", cfg)
        trainer.train(ShardedCoefficientTable(per, dims), chunks[:1])  # warm-up, untimed
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        telemetry.reset()
        table = ShardedCoefficientTable(n, dims)
        t0 = time.perf_counter()
        run = trainer.train(table, chunks)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
        peak = torch.cuda.max_memory_allocated()
        tracker = trainer.train(ShardedCoefficientTable(per, dims), chunks[:1],
                                with_tracker=True).tracker
        its = tracker.iterations
        part = {
            "name": name, "coefficients": run.total_coefficients, "entities": run.total_entities,
            "chunks": run.num_chunks, "seconds": secs, "mean_iterations": run.mean_iterations,
            "tracker_sample_entities": len(its),
            "iteration_percentiles_first_chunk": {f"p{p}": float(np.percentile(its, p))
                                                  for p in (50, 90, 99)},
            "converged_frac_first_chunk": float(np.mean(tracker.reasons >= 3)),
            "stalled_frac_first_chunk": float(np.mean(tracker.reasons == 2)),
            "table_gb": table.nbytes / 2**30, "host_syncs": syncs,
            "max_memory_allocated": peak, "lanes_rose": run.lanes_rose,
            "finite": bool(torch.isfinite(table.coefficients).all()),
        }
        if part["lanes_rose"] or not part["finite"]:
            bad.append(f"{name}: {part['lanes_rose']} lanes rose, finite={part['finite']}")
        if name == "per_user_re":
            if profile:
                prof = profile_solve("13b", lambda: trainer.train(
                    ShardedCoefficientTable(2 * per, dims), chunks[:2]).mean_iterations)
            head = table.coefficients[:2 * per]
            arms = {}
            for prefetch in (True, False):
                t = ShardedCoefficientTable(2 * per, dims)
                StreamingRandomEffectTrainer("logistic", cfg, prefetch=prefetch).train(
                    t, chunks[:2])
                arms[f"prefetch={prefetch}"] = torch.equal(t.coefficients, head)
                del t

            def pinned(b):
                return DenseBatch(*(torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                                    .copy_(v) for v in (b.x, b.labels, b.offsets, b.weights)))

            host = [(start, pinned(source())) for start, source in chunks[:2]]
            torch.cuda.synchronize()
            t = ShardedCoefficientTable(2 * per, dims)
            t0 = time.perf_counter()
            trainer.train(t, host)
            torch.cuda.synchronize()
            part["pinned_host_s"] = time.perf_counter() - t0
            arms["pinned_host"] = torch.equal(t.coefficients, head)
            del t, host, head
            if keep is not None:  # path 14c holds its entity-sharded table against it
                keep["per_user_re"] = table.coefficients.cpu()
            part["arms_bit_identical"] = arms
            if not all(arms.values()):
                bad.append(f"{name}: the feeding arms differ from the timed table: {arms}")
        if name == "mf_latent":
            ckpt = os.path.join(work, "ckpt13b")
            mgr = StreamingCheckpointManager(CheckpointSpec(directory=ckpt, every=1,
                                                            resume=False))
            trainer.train(ShardedCoefficientTable(n, dims), chunks[:1], checkpointer=mgr)
            state = StreamingCheckpointManager.open_for_restore(ckpt).restore_placed()
            resumed = ShardedCoefficientTable.from_coefficients(state.coefficients)
            trainer.train(resumed, chunks, start_chunk=state.next_chunk)
            part["resume"] = {"next_chunk": state.next_chunk,
                              "bit_identical": torch.equal(resumed.coefficients,
                                                           table.coefficients)}
            if not part["resume"]["bit_identical"] or state.next_chunk != 1:
                bad.append(f"{name}: the resumed table differs: {part['resume']}")
            del resumed, state
        print(f"path 13b part: {json.dumps(part)} card={card}", flush=True)
        stats["parts"].append(part)
        del table, trainer, chunks
        torch.cuda.empty_cache()
    launches = dict(kernels.LAUNCHES)
    total = sum(p["coefficients"] for p in stats["parts"])
    seconds = sum(p["seconds"] for p in stats["parts"])
    stats.update(game_1B_coeffs_trained_per_sec=total / seconds, total_coefficients=total,
                 total_seconds=seconds, launches=launches)
    stats["small"] = check_small_scale_parity(seed)
    print(f"path 13b: game_1B_coeffs_trained_per_sec={stats['game_1B_coeffs_trained_per_sec']:.1f} "
          f"total_coefficients={total} total_seconds={seconds:.4f} card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 13b: bad result: {bad}")
    return launches, stats, prof


def run_mesh_scale_path(seed: int, card: str, ref) -> tuple[dict, dict]:
    """Path 14c: path 13b's per_user_re part (1M entities x 512 dims, chunks
    of 125,000 x 8 rows, made on the card) through ``ShardedCoefficientTable``
    and ``StreamingRandomEffectTrainer`` on a 4-device ``entity`` mesh: a
    warm-up chunk, then the timed pass. Fails unless every device holds a
    quarter of the table's bytes and the table is within rtol 2e-3 / atol
    2e-4 of 13b's single-device one (tests/test_streaming.py:150-181); the
    largest per-entity difference is printed, and whether it is zero."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.game import ShardedCoefficientTable, StreamingRandomEffectTrainer
    from photon_ml_tpu_torch.parallel import make_mesh

    name, n, dims, per, rows, part_seed = SCALE_PARTS[0]
    devices, kind = mesh_devices(MESH_SHARDS)
    mesh = make_mesh({"entity": MESH_SHARDS}, devices)
    chunks = [(start, (lambda i=i: scale_chunk(seed, part_seed, i, per, rows, dims)))
              for i, start in enumerate(range(0, n, per))]
    trainer = StreamingRandomEffectTrainer("logistic", scale_config(), mesh=mesh)
    trainer.train(ShardedCoefficientTable(per, dims, mesh=mesh), chunks[:1])  # warm-up, untimed
    _sync(devices)
    torch.cuda.empty_cache()
    _reset_peaks(devices)
    telemetry.reset()
    kernels.reset_launch_counts()
    table = ShardedCoefficientTable(n, dims, mesh=mesh)
    t0 = time.perf_counter()
    run = trainer.train(table, chunks)
    _sync(devices)
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    peaks = _peaks(devices)
    # 13b's table, kept on the host, against each block where it lies
    per_entity, close = [], True
    for lo, p in zip(table.coefficients.row_starts(), table.coefficients.parts):
        want = ref[lo:lo + p.shape[0]].to(p.device)
        per_entity.append((p - want).abs().amax(dim=1).cpu())
        close = close and torch.allclose(p, want, **MESH_TABLE_TOL)
        del want
    per_entity = torch.cat(per_entity)
    largest = float(per_entity.max())
    stats = {"part": name, "devices": [str(d) for d in devices], "kind": kind,
             "coefficients": run.total_coefficients, "seconds": secs,
             "coeffs_per_s": run.total_coefficients / secs, "host_syncs": syncs,
             "mean_iterations": run.mean_iterations, "lanes_rose": run.lanes_rose,
             "shard_bytes": table.shard_nbytes(), "table_bytes": table.nbytes,
             "max_memory_allocated_by_device": peaks,
             "largest_per_entity_abs_diff": largest, "identical": largest == 0.0,
             "entities_differing": int((per_entity > 0).sum()),
             "within_tolerance": close, "card": card}
    print(f"path 14c: entity mesh of {MESH_SHARDS} over {kind} {stats['devices']}; "
          f"{json.dumps(stats)}", flush=True)
    bad = []
    if stats["shard_bytes"] != [table.nbytes // MESH_SHARDS] * MESH_SHARDS:
        bad.append("a shard does not hold a quarter of the table")
    if not close or run.lanes_rose:
        bad.append(f"off 13b's table beyond {MESH_TABLE_TOL} or a lane rose")
    if bad:
        raise RuntimeError(f"path 14c: bad result: {bad}")
    return launches, stats


def run_training_fleet_path(seed: int, card: str, work: str) -> tuple[dict, dict]:
    """Path 18: 13b's per_user_re part (1M entities x 512 features, chunks of
    125,000 x 8 rows, LBFGS 8, tolerance 1e-5, history 4, L2 1) through the
    port's ``tools/fleet.run_fleet``: TRAIN_FLEET worker processes on cuda:0
    (gloo: they share the card), each making only its ``LocalChunk`` rows
    of every chunk on the card, a coordinated checkpoint every
    TRAIN_FLEET_CKPT_EVERY chunks. (a) Uninterrupted: the gathered table
    bit for bit an in-process 2-device ``entity`` mesh run over the same
    chunks (the same pieces on the same card); where it is not, the chunks
    where it parts are printed and the table held to 14c's rtol 2e-3 / atol
    2e-4. (b) Member 1 armed with an ``exit`` rule at ``fleet.heartbeat``
    from the boundary after the first certified checkpoint: the fleet
    relaunches on the survivor from the newest certified checkpoint; no
    certified checkpoint may be partial, the final loss must be within
    1e-6 (relative) of (a)'s, and the rows of the chunks solved before that
    checkpoint bit for bit (a)'s. Each member of the 2-process fleet must
    peak under 0.55 of the relaunched survivor's peak (a member holds half
    of the table, of each chunk and of the lanes' solver state; the
    survivor all of them); the table plus one chunk is printed beside. The
    trainer's chunks are dense batched products (cuBLAS): no hand-written
    kernel runs on this path."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.game import ShardedCoefficientTable, StreamingRandomEffectTrainer
    from photon_ml_tpu_torch.parallel import make_mesh
    from photon_ml_tpu_torch.tools import fleet

    n, dims, per, n_chunks = fleet.problem_shape("scale")
    rows = fleet.SCALE_PART[3]
    table_bytes, chunk_bytes = n * dims * 4, per * rows * (dims + 3) * 4
    kernels.reset_launch_counts()

    def spec(name, **kw):
        return fleet.FleetSpec(workdir=os.path.join(work, name), num_processes=TRAIN_FLEET,
                               device="cuda", problem="scale", seed=seed,
                               checkpoint_every=TRAIN_FLEET_CKPT_EVERY,
                               heartbeat_deadline_s=20.0, grace_s=30.0, quorum_timeout_s=60.0,
                               timeout_s=420.0, **kw)

    def members(report):
        out = {}
        for g in report["generations"]:
            for pid, line in g["members"].items():
                line = line or {}
                out[f"gen{g['generation']}-proc{pid}"] = {k: line.get(k) for k in (
                    "backend", "device", "startup_s", "fit_s", "coeffs_per_s",
                    "coefficients_solved", "max_memory_allocated", "comms_wait_seconds_total",
                    "comms_wait_calls", "start_chunk", "fleet_abort", "error")}
        return out

    bad, stats = [], {"card": card, "processes": TRAIN_FLEET, "table_bytes": table_bytes,
                      "chunk_bytes": chunk_bytes}
    t0 = time.perf_counter()
    report_a = fleet.run_fleet(spec("fleet_a"))
    stats["a_s"] = time.perf_counter() - t0
    stats["a"] = {"ok": report_a["ok"], "rcs": [g["rcs"] for g in report_a["generations"]],
                  "members": members(report_a)}
    print(f"path 18 (a): {json.dumps(stats['a'])} seconds={stats['a_s']:.4f} card={card}",
          flush=True)
    if not report_a["ok"]:
        raise RuntimeError(f"path 18 (a): the fleet did not complete: "
                           f"{json.dumps(report_a, default=str)[-4000:]}")
    want = np.load(report_a["final_path"])
    shutil.rmtree(os.path.join(work, "fleet_a", "ckpt"), ignore_errors=True)
    # the in-process reference: one process, the same two positions, the same chunks
    mesh = make_mesh({"entity": TRAIN_FLEET}, [torch.device("cuda", 0)] * TRAIN_FLEET)
    table = ShardedCoefficientTable(n, dims, mesh=mesh)
    t0 = time.perf_counter()
    StreamingRandomEffectTrainer("logistic", fleet.scale_config(), mesh=mesh,
                                 prefetch=False).train(table, [
        (i * per, (lambda i=i: fleet._chunk_rows("scale", seed, i, 0, per, "cuda")))
        for i in range(n_chunks)])
    torch.cuda.synchronize()
    stats["in_process_s"] = time.perf_counter() - t0
    ref = table.to_numpy()
    del table
    torch.cuda.empty_cache()
    identical = bool(np.array_equal(want, ref))
    stats["a"]["bit_identical_to_in_process_mesh"] = identical
    if not identical:
        parts = [i for i in range(n_chunks)
                 if not np.array_equal(want[i * per:(i + 1) * per], ref[i * per:(i + 1) * per])]
        stats["a"]["chunks_differing"] = parts
        stats["a"]["max_abs_diff"] = float(np.abs(want - ref).max())
        if not np.allclose(want, ref, **MESH_TABLE_TOL):
            bad.append(f"(a) off the in-process mesh run beyond {MESH_TABLE_TOL} in chunks "
                       f"{parts}")
    del ref
    loss_a = fleet.problem_loss("scale", seed, want, device="cuda")
    t0 = time.perf_counter()
    report_b = fleet.run_fleet(spec(
        "fleet_b", victim_plan={"rules": [{"point": "fleet.heartbeat", "action": "exit"}]},
        victim_process=1, victim_arm_after_chunk=TRAIN_FLEET_CKPT_EVERY - 1))
    stats["b_s"] = time.perf_counter() - t0
    gens = report_b["generations"]
    stats["b"] = {"ok": report_b["ok"], "relaunches": report_b["relaunches"],
                  "rcs": [g["rcs"] for g in gens], "deaths": [g["deaths"] for g in gens],
                  "escalated": [g["escalated"] for g in gens],
                  "detect_s": report_b.get("detect_s"), "relaunch_s": report_b.get("relaunch_s"),
                  "members": members(report_b)}
    if not (report_b["ok"] and report_b["relaunches"] == 1 and len(gens) == 2
            and gens[0]["deaths"] == [1] and gens[1]["num_processes"] == TRAIN_FLEET - 1):
        raise RuntimeError(f"path 18 (b): the kill and relaunch went otherwise: "
                           f"{json.dumps(stats['b'], default=str)}")
    partial = fleet.verify_certified_checkpoints(os.path.join(work, "fleet_b", "ckpt"), n, dims)
    got = np.load(report_b["final_path"])
    start = (gens[1]["members"][0] or {}).get("start_chunk") or 0
    loss_b = fleet.problem_loss("scale", seed, got, device="cuda")
    head = bool(np.array_equal(got[:start * per], want[:start * per]))
    stats["b"].update(partial_certified=partial, resumed_at_chunk=start, loss_a=loss_a,
                      loss_b=loss_b, loss_rel_diff=abs(loss_b - loss_a) / abs(loss_a),
                      rows_before_checkpoint_bit_identical=head)
    print(f"path 18 (b): {json.dumps(stats['b'], default=str)} seconds={stats['b_s']:.4f} "
          f"card={card}", flush=True)
    if partial:
        bad.append(f"(b) partially certified checkpoints: {partial}")
    if not 0 < start < n_chunks:
        bad.append(f"(b) the survivor resumed at chunk {start}")
    if not stats["b"]["loss_rel_diff"] <= TRAIN_FLEET_LOSS_RTOL:
        bad.append(f"(b) loss {loss_b} vs (a)'s {loss_a}")
    if not head:
        bad.append("(b) the rows solved before the checkpoint differ from (a)'s")
    peaks = {k: m["max_memory_allocated"] for report in (report_a, report_b)
             for k, m in members(report).items() if m["max_memory_allocated"]}
    stats["member_peaks"] = peaks
    # a member of the 2-process fleet holds half the table, half of each
    # chunk and half the lanes' solver state; the relaunched survivor holds
    # all of them (13b's one-process layout), so a member's peak is held to
    # half the survivor's, with 10% for the allocator's rounding. The table
    # plus one chunk is printed beside it: the lane LBFGS's state (its
    # history pairs and line-search points, ~19 [E, K] tensors) comes on top.
    survivor = peaks.get("gen1-proc0")
    stats["table_plus_chunk_bytes"] = table_bytes + chunk_bytes
    over = {k: v for k, v in peaks.items()
            if k.startswith("gen0-") and (survivor is None or v > 0.55 * survivor)}
    if over:
        bad.append(f"members over half the one-process peak ({survivor}): {over}")
    backends = {m["backend"] for m in members(report_a).values()}
    stats["backend"] = sorted(b for b in backends if b)
    if stats["backend"] != ["gloo"]:
        bad.append(f"members sharing cuda:0 joined on {stats['backend']}, not gloo")
    del want, got
    shutil.rmtree(os.path.join(work, "fleet_a"), ignore_errors=True)
    shutil.rmtree(os.path.join(work, "fleet_b"), ignore_errors=True)
    print(f"path 18: backend={stats['backend']} member_peaks={json.dumps(peaks)} "
          f"bit_identical={identical} card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 18: bad result: {bad}")
    return dict(kernels.LAUNCHES), stats


def check_small_scale_parity(seed: int) -> dict:
    """Path 13b's small chunk (SCALE_SMALL: entities x rows x dims, numpy
    draws from ``seed``) through the trainer on the card and on the CPU:
    each table is its device's lane solve bit for bit, and per lane the card
    agrees with the CPU by phase 4's check (``_compare_lanes``): the value
    within rtol 1e-4 on every lane, the same iterations and reason but on
    plateau lanes (at tolerance 1e-5 a lane's last function-value test can
    fall on its threshold, and rounding then decides between one more step
    and stopping). 64 rows an entity keep most lanes off the plateau within
    LBFGS 8, so the reasons and iterations are held on most lanes; at 8 rows
    nearly every lane converges onto it."""
    import torch

    from photon_ml_tpu_torch.game import ShardedCoefficientTable, StreamingRandomEffectTrainer
    from photon_ml_tpu_torch.ops.dense import DenseBatch
    from photon_ml_tpu_torch.optim import glm_adapter
    from photon_ml_tpu_torch.optim.factory import build_objective, dispatch_solve

    e, r, k = SCALE_SMALL
    rng = np.random.default_rng([seed, 13])
    x = rng.normal(size=(e, r, k)).astype(np.float32)
    w_true = (rng.normal(size=(e, k)) * 0.3).astype(np.float32)
    off = (rng.normal(size=(e, r)) * 0.2).astype(np.float32)
    y = (rng.random((e, r)) < 1 / (1 + np.exp(-(np.einsum("erk,ek->er", x, w_true) + off))))
    cfg = scale_config()
    out, tables = {}, {}
    for dev in ("cuda", "cpu"):
        batch = DenseBatch.from_arrays(x, y, off, device=dev)
        table = ShardedCoefficientTable(e, k, device=dev)
        StreamingRandomEffectTrainer("logistic", cfg, device=dev).train(table, [(0, batch)])
        res = dispatch_solve(glm_adapter(build_objective("logistic", cfg), batch),
                             torch.zeros(e, k, device=dev), cfg, device=dev)
        out[dev] = [res]
        tables[dev] = torch.equal(table.coefficients, res.w)
    (flat,), worst = _compare_lanes("path 13b small chunk card vs cpu", out,
                                    reasons_on_plateau=False)
    if not all(tables.values()):
        raise RuntimeError(f"path 13b: the trainer's table is not its lane solve: {tables}")
    return {"shape": list(SCALE_SMALL), "table_is_lane_solve": tables, "lanes": e,
            "plateau_lanes": int(flat.sum()), "value_rel_diff": worst}


def make_northstar_problem(seed: int, n_rows: int):
    """bench_northstar.py's data (its generator at :47-83 and the planted
    model drawn in ``_run``, the same draws in the same order from
    ``seed``): ``n_rows`` training rows, then NS_VAL validation rows. Each
    split is (users, movies, labels, logits, shards): ``movieFeatures``
    (NS_FE_NNZ of NS_FE_SPACE per movie), ``movieCtx`` (the movie's NS_CTX
    embedding) and ``userCtx`` (the user's), each in its own column space."""
    from photon_ml_tpu_torch.game import FeatureShard

    rng = np.random.default_rng(seed)
    movie_cols = rng.integers(0, NS_FE_SPACE, size=(NS_MOVIES, NS_FE_NNZ)).astype(np.int32)
    movie_vals = rng.normal(size=(NS_MOVIES, NS_FE_NNZ))
    emb_m = rng.normal(size=(NS_MOVIES, NS_CTX)) * 0.7
    emb_u = rng.normal(size=(NS_USERS, NS_CTX)) * 0.7
    w_g = rng.normal(size=NS_FE_SPACE) * 0.4
    a_u = rng.normal(size=(NS_USERS, NS_CTX)) * 0.4
    b_m = rng.normal(size=(NS_MOVIES, NS_CTX)) * 0.4
    splits = []
    for n in (n_rows, NS_VAL):
        users = rng.integers(0, NS_USERS, size=n)
        movies = rng.integers(0, NS_MOVIES, size=n)
        logit = (np.einsum("ij,ij->i", movie_vals[movies], w_g[movie_cols[movies]])
                 + np.einsum("ij,ij->i", emb_m[movies], a_u[users])
                 + np.einsum("ij,ij->i", emb_u[users], b_m[movies]))
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float64)
        rows = np.repeat(np.arange(n, dtype=np.int64), NS_CTX)
        ctx_cols = np.tile(np.arange(NS_CTX, dtype=np.int64), n)
        shards = {
            "movieFeatures": FeatureShard.from_coo(
                movie_vals[movies].ravel(), np.repeat(np.arange(n, dtype=np.int64), NS_FE_NNZ),
                movie_cols[movies].ravel(), NS_FE_SPACE),
            "movieCtx": FeatureShard.from_coo(emb_m[movies].ravel(), rows, ctx_cols, NS_CTX),
            "userCtx": FeatureShard.from_coo(emb_u[users].ravel(), rows, ctx_cols, NS_CTX),
        }
        splits.append((users, movies, y, logit, shards))
    return splits


def planted_auc(logit: np.ndarray, y: np.ndarray) -> float:
    """The planted model's AUC on its own draws (bench_northstar.py's
    ceiling): the rank-sum form over the logits."""
    ranks = np.empty(len(logit))
    ranks[np.argsort(logit)] = np.arange(1, len(logit) + 1)
    pos = y > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def northstar_config() -> dict:
    """bench_northstar.py:186-231's coordinates, evaluators and schedule, as
    the JSON document ``parse_game_config`` reads."""
    def opt(kind: str, iters: int) -> dict:
        return {"type": kind, "max_iterations": iters, "tolerance": 1e-7,
                "regularization": "l2", "regularization_weight": 1.0}

    return {"task": "logistic", "num_iterations": 1, "evaluators": ["auc"], "coordinates": {
        "fixed": {"type": "fixed_effect", "shard_name": "movieFeatures",
                  "optimizer": opt("lbfgs", 10)},
        "per-user": {"type": "random_effect", "shard_name": "movieCtx", "id_name": "userId",
                     "optimizer": opt("newton", 8), "active_rows_per_entity": 256},
        "per-movie": {"type": "random_effect", "shard_name": "userCtx", "id_name": "movieId",
                      "optimizer": opt("newton", 8), "active_rows_per_entity": 256},
        "mf": {"type": "factored_random_effect", "shard_name": "movieCtx", "id_name": "userId",
               "latent_dim": 2, "mf_iterations": 1, "optimizer": opt("lbfgs", 8),
               "latent_optimizer": opt("lbfgs", 8), "active_rows_per_entity": 32},
    }}


def _model_tensors(model) -> dict:
    """Every tensor of a GAME model, by name, for a bit-for-bit comparison."""
    out = {}
    for name, sub in model.models.items():
        if hasattr(sub, "coefficients"):
            out[name] = sub.coefficients
        for i, b in enumerate(getattr(sub, "buckets", ())):
            out[f"{name}/{i}"] = b.coefficients
        if hasattr(sub, "latent"):
            out[f"{name}/latent"] = sub.latent
            out[f"{name}/projection"] = sub.projection.matrix
    return out


def run_northstar_path(seed: int, card: str, keep: dict | None = None) -> tuple[dict, dict]:
    """Path 11: BASELINE config #5 (bench_northstar.py: a fixed effect, a
    per-user and a per-movie random effect, and the factored ``mf``
    coordinate) at its full width through ``GameEstimator.fit``, with one
    estimator for three fits that share its random-effect datasets: fit A
    uninterrupted with ``output_dir``; fit B with a checkpoint every step and
    a stop after the second update; fit C resumed from B's checkpoint. Fails
    unless the validation AUC rises from ``fixed`` to ``per-user`` to
    ``per-movie`` (the ``mf`` update's change is printed: it lowers the AUC
    here, as it does in the JAX package); the ``mf`` update launched ``csr_margins`` and ``csc_scatter`` and its
    tracker holds one MF step whose latent solves cover every entity with no
    lane above its value at zero, and whose refit took at least one
    iteration and lowered its value; the saved final model scores the
    validation rows bit for bit as the fitted one, and two scorings agree;
    B stops at step 1 with its manifest on disk; C restores step 1, runs
    steps 2 and 3 only, and ends bit-identical to A, tensor for tensor, with
    A's AUC. Everything it writes goes at the end. Path 17a runs after fit
    A (``run_mesh_mf_path``); ``keep["17a"]`` receives its launches and
    numbers."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.config import parse_game_config
    from photon_ml_tpu_torch.data.model_store import load_game_model
    from photon_ml_tpu_torch.game import (
        CheckpointSpec,
        GameEstimator,
        TrainingInterrupted,
        build_game_dataset,
    )

    stats, bad = {"card": card, "rows": NS_ROWS}, []
    t0 = time.perf_counter()
    (users, movies, y, _, shards), (v_users, v_movies, v_y, v_logit, v_shards) = \
        make_northstar_problem(seed, NS_ROWS)
    stats["ceiling_auc"] = planted_auc(v_logit, v_y)
    stats["generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gds = build_game_dataset(y, shards, id_columns={"userId": users, "movieId": movies})
    vds = build_game_dataset(v_y, v_shards, id_columns={"userId": v_users, "movieId": v_movies})
    gds.csr_batch("movieFeatures")
    torch.cuda.synchronize()
    stats["dataset_s"] = time.perf_counter() - t0
    del users, movies, y, shards, v_users, v_movies, v_y, v_logit, v_shards
    print(f"path 11 data: rows={NS_ROWS} validation_rows={NS_VAL} users={NS_USERS} "
          f"movies={NS_MOVIES} generate_s={stats['generate_s']:.4f} "
          f"dataset_s={stats['dataset_s']:.4f} ceiling_auc={stats['ceiling_auc']:.6f} "
          f"card={card}", flush=True)

    config = parse_game_config(northstar_config())
    est = GameEstimator(config)
    stats["re_build_s"] = {}
    for name, c in config.coordinates.items():
        if hasattr(c, "id_name"):
            t0 = time.perf_counter()
            red = est._re_dataset(gds, c)
            stats["re_build_s"][name] = time.perf_counter() - t0
            print(f"path 11 re build {name}: seconds={stats['re_build_s'][name]:.4f} "
                  f"entities={sum(b.num_entities for b in red.buckets)} "
                  f"buckets={len(red.buckets)} passive_rows={len(red.passive_rows)} "
                  f"card={card}", flush=True)

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=build_dir)
    try:
        # fit A, uninterrupted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        telemetry.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fit_a = est.fit(gds, validation_data=vds, output_dir=os.path.join(work, "a"))
        torch.cuda.synchronize()
        stats["fit_a_s"] = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        spans = telemetry.snapshot()["span_seconds"]
        stats["kron_structure_s"] = spans.get("factored_kron_structure", 0.0)
        stats["build_coordinates_s"] = spans.get("build_coordinates", 0.0)
        mf = est._coordinates[(id(gds), "mf")][1]
        stats["kron_nnz"] = mf.kron_nnz
        aucs, updates = [], []
        for e in fit_a.history:
            aucs.append(e["metrics"]["auc"])
            updates.append({"coordinate": e["coordinate"], "seconds": e["seconds"],
                            "host_syncs": e["host_syncs"], "auc": e["metrics"]["auc"],
                            "launches": {k: n for k, n in e["launches"].items() if n}})
            print(f"path 11 fit A {e['coordinate']}: auc={e['metrics']['auc']:.6f} "
                  f"seconds={e['seconds']:.4f} host_syncs={e['host_syncs']} "
                  f"launches={json.dumps(updates[-1]['launches'])} card={card}", flush=True)
        stats.update(updates=updates, aucs=aucs, mf_auc_change=aucs[3] - aucs[2])
        # the mf update lowers the validation AUC of this configuration in
        # the JAX package too (tests/test_torch_factored.py holds the port
        # to the reference's AUC after each update), so only the order of
        # the first three updates is checked here, and mf's AUC is printed
        if not (aucs[0] < aucs[1] < aucs[2] and np.isfinite(aucs[3])):
            bad.append(f"the validation AUC does not rise as it should: {aucs}")
        print(f"path 11 mf: validation auc change {aucs[3] - aucs[2]:+.6f} from per-movie "
              f"(the JAX package's change on this generator's data at 40K and 400K rows: "
              f"-0.019824, -0.023000)", flush=True)
        mf_launches = fit_a.history[3]["launches"]
        if not (mf_launches["csr_margins"] and mf_launches["csc_scatter"]):
            bad.append(f"the mf update did not launch csr_margins and csc_scatter: "
                       f"{mf_launches}")
        tracker = mf.last_tracker
        lane_results = [r for r in mf.last_results if r.value.dim() == 1]
        lat_res = mf.last_results[-1]
        (re_t, fe_t), = tracker.steps
        rose = sum(int((r.value > r.values[:, 0]).sum()) for r in lane_results)
        lat_start = float(lat_res.values[0])
        stats["mf_tracker"] = {"entities": len(re_t.iterations), "n_flat": mf._n_flat,
                               "lanes_rose": rose,
                               "reasons": re_t.count_convergence_reasons(),
                               "matrix_iterations": fe_t.iterations,
                               "matrix_reason": fe_t.reason,
                               "matrix_value": fe_t.final_value, "matrix_value0": lat_start}
        print(f"path 11 mf tracker:\n{tracker.to_summary_string()}", flush=True)
        print(f"path 11 mf: kron_nnz={mf.kron_nnz} {json.dumps(stats['mf_tracker'])}",
              flush=True)
        if len(re_t.iterations) != mf._n_flat or rose:
            bad.append(f"the mf latent solves: {len(re_t.iterations)} lanes of {mf._n_flat}, "
                       f"{rose} rose above their value at zero")
        if not (fe_t.iterations >= 1 and fe_t.final_value < lat_start):
            bad.append(f"the mf latent refit: {fe_t.iterations} iterations, value "
                       f"{fe_t.final_value} from {lat_start}")
        mesh_mf = run_mesh_mf_path(est, gds, fit_a, card)
        if keep is not None:
            keep["17a"] = mesh_mf
        loaded = load_game_model(os.path.join(work, "a", "final"))
        scored = [fit_a.model.score(vds) for _ in range(2)]
        same = {"reloaded": torch.equal(loaded.score(vds), scored[0]),
                "twice": torch.equal(*scored)}
        stats["bit_identical"] = same
        if not all(same.values()):
            bad.append(f"validation scores differ: {same}")
        del loaded, scored

        # fit B: a checkpoint every step, stopped after the second update
        ckpt = os.path.join(work, "ckpt")
        spec = CheckpointSpec(directory=ckpt, every=1)
        polls = []

        def stop_after_two() -> bool:
            polls.append(1)
            return len(polls) >= 2

        telemetry.reset()
        t0 = time.perf_counter()
        stopped = None
        try:
            est.fit(gds, validation_data=vds, checkpoint_spec=spec, should_stop=stop_after_two)
        except TrainingInterrupted as e:
            stopped = e
        stats["fit_b_s"] = time.perf_counter() - t0
        stats["fit_b_save_s"] = telemetry.snapshot()["span_seconds"].get("checkpoint:save", 0.0)
        manifest = os.path.join(ckpt, "step-00000001", "manifest.json")
        stats["fit_b"] = {"stopped_at": None if stopped is None else stopped.step,
                          "manifest": os.path.exists(manifest)}
        if stopped is None or stopped.step != 1 or not os.path.exists(manifest):
            bad.append(f"fit B did not stop at step 1 with its manifest: {stats['fit_b']}")

        # fit C: resumed from fit B's checkpoint
        telemetry.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fit_c = est.fit(gds, validation_data=vds, checkpoint_spec=spec)
        torch.cuda.synchronize()
        stats["fit_c_s"] = time.perf_counter() - t0
        counters = telemetry.snapshot()["counters"]
        stats["fit_c_save_s"] = telemetry.snapshot()["span_seconds"].get("checkpoint:save", 0.0)
        ran = [e["coordinate"] for e in fit_c.history if "results" in e]
        a_t, c_t = _model_tensors(fit_a.model), _model_tensors(fit_c.model)
        identical = sorted(a_t) == sorted(c_t) and all(torch.equal(a_t[k], c_t[k]) for k in a_t)
        stats["fit_c"] = {"restores": counters.get("checkpoint.restores", 0), "ran": ran,
                          "bit_identical_to_a": identical,
                          "auc": fit_c.history[-1]["metrics"]["auc"]}
        if not (stats["fit_c"]["restores"] == 1 and ran == ["per-movie", "mf"]):
            bad.append(f"fit C did not resume at step 2: {stats['fit_c']}")
        if not identical or stats["fit_c"]["auc"] != aucs[-1]:
            diff = [k for k in a_t if k in c_t and not torch.equal(a_t[k], c_t[k])]
            bad.append(f"the resumed fit differs from the uninterrupted one: {diff}, auc "
                       f"{stats['fit_c']['auc']} vs {aucs[-1]}")
        print(f"path 11 checkpoints: fit_b={json.dumps(stats['fit_b'])} "
              f"fit_c={json.dumps(stats['fit_c'])} fit_b_s={stats['fit_b_s']:.4f} "
              f"fit_c_s={stats['fit_c_s']:.4f} save_s(b)={stats['fit_b_save_s']:.4f} "
              f"save_s(c)={stats['fit_c_save_s']:.4f} card={card}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"path 11: fit_a_s={stats['fit_a_s']:.4f} "
          f"re_build_s={json.dumps(stats['re_build_s'])} "
          f"kron_structure_s={stats['kron_structure_s']:.4f} kron_nnz={stats['kron_nnz']} "
          f"max_memory_allocated={stats['max_memory_allocated']} aucs={aucs} "
          f"ceiling_auc={stats['ceiling_auc']:.6f} bit_identical={json.dumps(same)} "
          f"launches={json.dumps(launches)} card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 11: bad result: {bad}")
    return launches, stats


def run_mesh_mf_path(est, gds, fit_a, card: str) -> tuple[dict, dict]:
    """Path 17a: fit A's ``mf`` update again from the same model (its initial
    one: ``mf`` comes last in one CD iteration) and the same residual (the
    other coordinates' scores at fit A's models, summed in the fit's
    order), once by fit A's coordinate and once by the coordinate over a
    ``model`` axis of 4 (latent solves per owner, the kron refit over row
    blocks on the owners' devices). Fails unless the projection matrix and
    the scores are within rtol/atol 5e-3 (tests/test_factored.py:310-320) and
    the sharded update launched ``csr_margins`` and ``csc_scatter``; both
    updates are timed."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.game import FactoredRandomEffectCoordinate

    mf = est._coordinates[(id(gds), "mf")][1]
    residual = torch.zeros(gds.num_rows, dtype=torch.float32, device=gds.device)
    for name, sub in fit_a.model.models.items():
        if name != "mf":
            residual = residual + est._coordinates[(id(gds), name)][1].score(sub)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    local = mf.update_model(mf.initialize_model(), residual)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    local_scores = mf.score(local)
    mesh, devices, kind = _owner_mesh()
    t0 = time.perf_counter()
    sharded = FactoredRandomEffectCoordinate(
        "mf", gds, mf.re_data, mf.loss_name, mf.re_config, mf.latent_config,
        latent_dim=mf.latent_dim, mf_iterations=mf.mf_iterations, seed=mf.seed, mesh=mesh)
    _sync(devices)
    build_s = time.perf_counter() - t0
    _reset_peaks(devices)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = sharded.update_model(sharded.initialize_model(), residual)
    _sync(devices)
    sharded_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    got_scores = sharded.score(got)
    a, a_ref = got.projection.matrix, local.projection.matrix
    diffs = {"projection": float((a - a_ref).abs().max()),
             "scores": float((got_scores - local_scores).abs().max())}
    close = {"projection": torch.allclose(a, a_ref, **FACTORED_MESH_TOL),
             "scores": torch.allclose(got_scores, local_scores, **FACTORED_MESH_TOL)}
    stats = {"devices": [str(d) for d in devices], "kind": kind, "kron_nnz": sharded.kron_nnz,
             "kron_blocks_nnz": [int(b.nnz) for b, _, _ in sharded._kron_blocks],
             "build_s": build_s, "unsharded_update_s": local_s, "sharded_update_s": sharded_s,
             "max_abs_diff": diffs, "within_tolerance": close, "launches": launches,
             "max_memory_allocated_by_device": _peaks(devices), "card": card}
    print(f"path 17a: mf on a model axis of {MESH_OWNERS} over {kind}; {json.dumps(stats)}",
          flush=True)
    bad = []
    if not all(close.values()):
        bad.append(f"off the unsharded update beyond {FACTORED_MESH_TOL}: {diffs}")
    missing = [k for k in ("csr_margins", "csc_scatter") if not launches[k]]
    if missing:
        bad.append(f"kernels not launched: {missing}")
    if bad:
        raise RuntimeError(f"path 17a: bad result: {bad}")
    del sharded, got, local
    torch.cuda.empty_cache()
    return launches, stats


def run_probe_path(seed: int) -> tuple[dict, dict]:
    """Path 7: the ELL probe's entry point at bench.py's shape. Fails unless
    the ELL kernel launched and agrees with CSR ``dot_rows``."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.tools import probe_ell

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = probe_ell.run_probe(seed=seed)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"path 7: ell_ms={res['ell_ms']:.4f} csr_ms={res['csr_ms']:.4f} "
          f"csr_over_ell={res['csr_over_ell']:.4f} max_abs_err={res['max_abs_err']:.3e} "
          f"max_rel_err={res['max_rel_err']:.3e} limit={KERNEL_REL_TOL:.0e} "
          f"launches={json.dumps(launches)}", flush=True)
    if launches["ell_margins"] == 0:
        raise RuntimeError("path 7: kernels not launched: ['ell_margins']")
    if not res["max_rel_err"] <= KERNEL_REL_TOL:
        raise RuntimeError("path 7: ELL and CSR dot_rows disagree")
    return launches, res


def lane_cases(csr, csc, tiles, plain_csc, shared_off, W, R, off, shift):
    """The lane kernels' four variants over one design: (name, label, lanes,
    plain, single) each, ``single(g)`` the single-vector kernel on lane g;
    ``shared_off`` is the ``[N]`` offsets that ``dot_rows`` does not add."""
    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.kernels import reference

    def margins(label, off_g, sh, use):
        per_lane = off_g.dim() == 2
        return ("csr_margins_lanes", label,
                lambda: kernels.csr_margins_lanes(*csr, W, off_g, sh, use),
                lambda: reference.csr_margins_lanes(*csr, W, off_g, sh, use),
                lambda g: kernels.csr_margins(*csr, W[g], off_g[g] if per_lane else off_g,
                                              sh[g:g + 1] if not isinstance(sh, float)
                                              else sh, use))

    def scatter(label, r, square):
        return ("csc_scatter_lanes", label,
                lambda: kernels.csc_scatter_lanes(*csc, r, square, tiles),
                lambda: reference.csc_scatter_lanes(*plain_csc, r, square),
                lambda g: kernels.csc_scatter(*csc, r[g], square, tiles))

    return [margins("dot_rows", shared_off, 0.0, False),
            margins("margins+offsets+shift per lane", off, shift, True),
            scatter("scatter", R, False), scatter("scatter_sq", R.abs(), True)]


def lane_design_bytes(n, f, nnz, G, tiles) -> dict:
    """Bytes each lane kernel must move (its bound) and the bytes its design
    moves from HBM (its floor): the margins read X, W and write Z once, its
    bound; the scatter also reads the tile index but ``start`` and writes and
    reads G parts a segment piece."""
    scatter = 4 * ((f + 1) + 2 * nnz + G * n + G * f)
    return {
        "csr_margins_lanes": (4 * ((n + 1) + 2 * nnz + G * f + G * n),) * 2,
        "csc_scatter_lanes": (scatter, scatter + 4 * (tiles.index.numel() - tiles.n_slots)
                              + 2 * G * tiles.n_parts * 4),
    }


def run_lane_variants(cases, G: int, tag: str) -> dict:
    """Each case: every lane against the single kernel bit for bit, then
    ``run_variants`` (the plain version within KERNEL_REL_TOL, two launches
    bit for bit), and G single launches timed beside the first variant.
    Returns {name: (worst abs error, {label: (ms, plain ms)}, singles ms)}."""
    import torch

    out = {}
    for name in dict.fromkeys(c[0] for c in cases):
        mine = [c[1:] for c in cases if c[0] == name]
        for label, run_lanes, _, run_single in mine:
            got = run_lanes()
            same = all(torch.equal(got[g], run_single(g)) for g in range(G))
            print(f"check {name}[{tag} {label}]: each of {G} lanes bit-identical to the "
                  f"single kernel: {same}", flush=True)
            if not same:
                raise RuntimeError(f"{name}[{tag} {label}]: a lane differs from the single "
                                   "kernel")
        worst, timed = run_variants(f"{name}[{tag}]", [c[:3] for c in mine])
        run_single = mine[0][3]
        singles_ms = device_ms(lambda: [run_single(g) for g in range(G)], reps=10)
        print(f"time {name}[{tag} {mine[0][0]}]: {G} single launches ms={singles_ms:.4f}",
              flush=True)
        out[name] = worst, timed, singles_ms
    return out


def check_lane_kernels(batch, w) -> list[dict]:
    """Phase 3, the lane kernels at config #1 with G = SWEEP_LANES vectors and
    with G = GLM_BOOTSTRAP_SAMPLES: each variant against its plain version and
    against a second launch, and every lane against the single-vector kernel
    on that lane's vector, bit for bit; timed beside G launches of the single
    kernel and the library's sparse product, with the bound and the design
    floor (computed bytes over the HBM rate, not measurements)."""
    import torch

    n, f, nnz = batch.num_rows, batch.num_features, batch.nnz
    csr, csc, tiles = batch._csr, batch._csc, batch.tiles
    plain_csc = batch.column_major()
    sources = {
        "csr_margins_lanes": ("photon_ml_tpu_torch/csrc/margins_lanes.cu",
                              "photon_ml_tpu/ops/tiled.py:170", "dot_rows"),
        "csc_scatter_lanes": ("photon_ml_tpu_torch/csrc/scatter_lanes.cu",
                              "photon_ml_tpu/ops/tiled.py:199", "scatter"),
    }
    measured = {}
    for G in (SWEEP_LANES, GLM_BOOTSTRAP_SAMPLES):
        gen = torch.Generator(device="cuda").manual_seed(12 + G)
        W = torch.randn(G, f, generator=gen, device="cuda") * 0.1
        W[0] = w
        R = torch.randn(G, n, generator=gen, device="cuda")
        off = torch.randn(G, n, generator=gen, device="cuda") * 0.1
        shift = torch.randn(G, generator=gen, device="cuda")
        res = run_lane_variants(lane_cases(csr, csc, tiles, plain_csc, batch.offsets, W, R,
                                           off, shift), G, f"G={G}")
        t_w, t_r = W.t().contiguous(), R.t().contiguous()
        libs = {
            "csr_margins_lanes": library_ms(lambda: torch.sparse_csr_tensor(
                *csr, size=(n, f), check_invariants=False), lambda m: torch.sparse.mm(m, t_w)),
            "csc_scatter_lanes": library_ms(lambda: torch.sparse_csr_tensor(
                *plain_csc, size=(f, n), check_invariants=False),
                lambda m: torch.sparse.mm(m, t_r)),
        }
        for name, (nbytes, floor_bytes) in lane_design_bytes(n, f, nnz, G, tiles).items():
            floor_ms = floor_bytes / PEAK_BYTES_PER_S * 1e3
            print(f"design floor {name}[G={G}]: bytes={floor_bytes} floor_ms={floor_ms:.4f} "
                  f"bound_bytes={nbytes} (computed)", flush=True)
            measured[name, G] = res[name] + (libs[name], nbytes, floor_ms)
        del W, R, off, t_w, t_r
    rows = []
    for name, (src, replaces, label) in sources.items():
        worst, timed, singles_ms, lib, nbytes, floor_ms = measured[name, SWEEP_LANES]
        worst8, timed8, singles8, lib8, nbytes8, floor8 = measured[name, GLM_BOOTSTRAP_SAMPLES]
        g8 = kernel_row(name, src, replaces, worst8, timed8, label, nbytes8,
                        2 * nnz * GLM_BOOTSTRAP_SAMPLES, lib8)
        rows.append(kernel_row(
            name, src, replaces, max(worst, worst8), timed, label, nbytes, 2 * nnz * SWEEP_LANES,
            lib, lanes=SWEEP_LANES, singles_ms=singles_ms, design_floor_ms=floor_ms,
            vmapped_at="photon_ml_tpu/sweep/runner.py:91-116",
            lanes_bit_identical_to_single=True,
            redesigned="lane sums in registers, lane groups in clusters",
            lanes_8={"ms": g8["ms"], "plain_ms": g8["plain_ms"], "bound_ms": g8["bound_ms"],
                     "design_floor_ms": floor8, "singles_ms": singles8,
                     "library_ms": lib8, "variants_ms": g8["variants_ms"]}))
    return rows


def run_sweep_path(batch, card: str, keep: dict | None = None) -> tuple[dict, dict]:
    """Path 12: bench_sweep.py at BASELINE config #1 through ``sweep_glm``: 16
    lambdas ``np.logspace(2, -4, 16)``, LBFGS 20 iterations at tolerance 0,
    cold lanes (``warm_start=False``), timed beside one ``train_glm`` fit at
    the first lambda (each warmed by an untimed call, then timed, as
    bench_sweep.py times them);
    ``sweep_over_single_ratio`` = sweep_s / single_s. Lanes 0, 8 and 15 are
    held against independent fits (the same reason and iterations but on
    plateau lanes, the loss within LOSS_RTOL), then the warm-started sweep (2
    rounds) runs: no lane's value may rise above the cold sweep's. The lane
    kernels must have launched in the cold sweep."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
    from photon_ml_tpu_torch.sweep import sweep_glm
    from photon_ml_tpu_torch.training import train_glm

    cfg = solver_config("lbfgs", 20)
    lams = tuple(float(v) for v in np.logspace(2, -4, SWEEP_LANES))
    train_glm(batch, "logistic", [lams[0]], cfg)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_glm(batch, "logistic", [lams[0]], cfg)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0

    sweep_glm(batch, "logistic", lams, cfg, warm_start=False)  # warm-up
    torch.cuda.synchronize()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cold = sweep_glm(batch, "logistic", lams, cfg, warm_start=False)
    cold_values = cold.values.cpu().numpy()
    sweep_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
    ratio = sweep_s / max(single_s, 1e-9)

    bad, parity = [], []
    for g in (0, SWEEP_LANES // 2, SWEEP_LANES - 1):
        ind = train_glm(batch, "logistic", [lams[g]], cfg)[0].result
        values = ind.values.numpy().astype(np.float64)
        it = int(ind.iterations)
        plateau = bool(abs(values[it] - values[it - 1]) <= PLATEAU_RTOL * abs(values[0]))
        rel = abs(float(cold_values[g]) - float(ind.value)) / abs(float(ind.value))
        row = {"lane": g, "lambda": lams[g], "sweep_iterations": int(cold.iterations[g]),
               "fit_iterations": it,
               "sweep_reason": CONVERGENCE_REASON_NAMES[int(cold.reasons[g])],
               "fit_reason": CONVERGENCE_REASON_NAMES[int(ind.reason)],
               "sweep_value": float(cold_values[g]), "fit_value": float(ind.value),
               "rel_err": rel, "plateau": plateau}
        parity.append(row)
        print(f"path 12 lane {json.dumps(row)}", flush=True)
        if not rel <= LOSS_RTOL:
            bad.append(f"lane {g}: loss {cold_values[g]} vs independent fit {float(ind.value)}")
        if not plateau and (row["sweep_iterations"], row["sweep_reason"]) != (
                it, row["fit_reason"]):
            bad.append(f"lane {g}: iterations/reason differ from the independent fit")

    t0 = time.perf_counter()
    warm = sweep_glm(batch, "logistic", lams, cfg, warm_start=True)
    warm_values = warm.values.cpu().numpy()
    warm_s = time.perf_counter() - t0
    rose = [g for g in range(SWEEP_LANES) if warm_values[g] > cold_values[g]]
    if warm.rounds != 2 or rose:
        bad.append(f"the warm-started sweep (rounds {warm.rounds}) rose on lanes {rose}")
    finite = bool(np.isfinite(cold_values).all()) and bool(cold.w.isfinite().all())
    if not finite:
        bad.append("non-finite sweep values or coefficients")
    stats = {"single_s": single_s, "sweep_s": sweep_s, "sweep_over_single_ratio": ratio,
             "warm_s": warm_s, "host_syncs": syncs, "lambdas": list(lams),
             "iterations": cold.iterations.tolist(), "reasons": cold.reason_names(),
             "cold_values": cold_values.tolist(), "warm_values": warm_values.tolist(),
             "parity": parity, "card": card}
    print(f"path 12: sweep_over_single_ratio={ratio:.4f} single_s={single_s:.4f} "
          f"sweep_s={sweep_s:.4f} warm_sweep_s={warm_s:.4f} lanes={SWEEP_LANES} "
          f"host_syncs={syncs} warm_not_above_cold={not rose} launches={json.dumps(launches)} "
          f"card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 12: bad result: {bad}")
    missing = [k for k in ("csr_margins_lanes", "csc_scatter_lanes") if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path 12: kernels not launched: {missing}")
    if keep is not None:  # path 17c holds its mesh sweep against the cold sweep
        keep["12"] = (lams, cfg, cold)
    return launches, stats


def run_mesh_sweep_path(batch, lams, cfg, cold, card: str) -> tuple[dict, dict]:
    """Path 17c: path 12's cold sweep (16 lambdas, LBFGS 20) through
    ``sweep_glm(mesh=...)`` on a ``model`` axis of 4: 4 lanes an owner,
    each owner running the lane kernels on its replica of the batch. Fails
    unless the values are within rtol 1e-5 and w within atol 1e-3 of path
    12's meshless cold sweep (tests/test_sweep.py:227-235) and both lane
    kernels launched."""
    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.sweep import sweep_glm

    mesh, devices, kind = _owner_mesh()
    _sync(devices)
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = sweep_glm(batch, "logistic", lams, cfg, warm_start=False, mesh=mesh)
    values = got.values.cpu().numpy()
    _sync(devices)
    sweep_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = cold.values.cpu().numpy()
    w_diff = float((got.w - cold.w).abs().max())
    rel = float(np.max(np.abs(values - want) / np.abs(want)))
    stats = {"devices": [str(d) for d in devices], "kind": kind, "sweep_s": sweep_s,
             "lanes": len(lams), "max_rel_value_diff": rel, "max_abs_w_diff": w_diff,
             "iterations": got.iterations.tolist(), "launches": launches,
             "host_syncs": telemetry.snapshot()["counters"].get("host_syncs", 0), "card": card}
    print(f"path 17c: sweep on a model axis of {MESH_OWNERS} over {kind}; {json.dumps(stats)}",
          flush=True)
    bad = []
    if not (rel <= SWEEP_MESH_RTOL and w_diff <= SWEEP_MESH_W_ATOL):
        bad.append(f"off path 12's cold sweep: values {rel} (rtol {SWEEP_MESH_RTOL}), w "
                   f"{w_diff} (atol {SWEEP_MESH_W_ATOL})")
    missing = [k for k in ("csr_margins_lanes", "csc_scatter_lanes") if launches[k] == 0]
    if missing:
        bad.append(f"kernels not launched: {missing}")
    if bad:
        raise RuntimeError(f"path 17c: bad result: {bad}")
    return launches, stats


def run_bootstrap_path(seed: int, batch, card: str) -> tuple[dict, dict]:
    """Path 12c: ``bootstrap_random_effect`` at bench_diagnostics.py's
    geometry (BOOT_ENTITIES entities x BOOT_ROWS rows x BOOT_FEATURES
    features, its draws, NEWTON 10 iterations, L2 1), B = BOOT_SAMPLES
    against the one-lane fit (identity weights), each warmed and then the
    best of 3 reps with w0 perturbed, as bench_diagnostics.py times them:
    ``bootstrap_overhead_ratio`` = bootstrap_s / single_s; the same call on
    BOOT_GATHERED gathered entities, with the full draw's weights for them,
    must give the full run's coefficients on those entities bit for bit.
    Then ``bootstrap_train`` at config #1 with B = GLM_BOOTSTRAP_SAMPLES (cli
    glm's default): finite coefficient summaries; the lane kernels must have
    launched."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.diagnostics.bootstrap import (
        bootstrap_random_effect,
        bootstrap_re_weights,
        bootstrap_train,
    )
    from photon_ml_tpu_torch.ops.dense import DenseBatch
    from photon_ml_tpu_torch.optim.factory import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )

    rng = np.random.default_rng(seed)
    E, R, K, B = BOOT_ENTITIES, BOOT_ROWS, BOOT_FEATURES, BOOT_SAMPLES
    x = rng.normal(size=(E, R, K))
    w_true = rng.normal(size=(E, K)) * 0.5
    y = rng.random((E, R)) < 1.0 / (1.0 + np.exp(-np.einsum("erk,ek->er", x, w_true)))
    ebatch = DenseBatch.from_arrays(x, y.astype(np.float64))
    w0 = torch.zeros((E, K), dtype=torch.float32, device="cuda")
    config = OptimizerConfig(optimizer_type=OptimizerType.NEWTON, max_iterations=10,
                             tolerance=1e-7,
                             regularization=RegularizationContext(RegularizationType.L2),
                             regularization_weight=1.0)
    single_lanes = np.ones((1, E, R), np.float32)
    boot_lanes = bootstrap_re_weights(B, np.ones((E, R), np.float32), seed=0)

    def timed(lane_weights):
        bootstrap_random_effect(ebatch, "logistic", config, w0, lane_weights=lane_weights)
        best = report = None
        for rep in range(1, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = bootstrap_random_effect(ebatch, "logistic", config, w0 + 1e-6 * rep,
                                             lane_weights=lane_weights)
            elapsed = time.perf_counter() - t0
            best = elapsed if best is None else min(best, elapsed)
        return best, report

    kernels.reset_launch_counts()
    single_s, _ = timed(single_lanes)
    boot_s, full = timed(boot_lanes)
    ratio = boot_s / max(single_s, 1e-9)
    full = bootstrap_random_effect(ebatch, "logistic", config, w0, lane_weights=boot_lanes)
    idx = np.sort(np.random.default_rng(seed + 12).choice(E, BOOT_GATHERED, replace=False))
    t0 = time.perf_counter()
    part = bootstrap_random_effect(
        DenseBatch.from_arrays(x[idx], y[idx].astype(np.float64)), "logistic", config,
        w0[torch.from_numpy(idx).cuda()], lane_weights=boot_lanes[:, idx])
    gathered_s = time.perf_counter() - t0
    gathered_same = bool(np.array_equal(part.samples, full.samples[:, idx]))

    cfg = dataclasses.replace(solver_config("lbfgs", 20), regularization_weight=1.0)
    t0 = time.perf_counter()
    fe = bootstrap_train(batch, "logistic", cfg, num_samples=GLM_BOOTSTRAP_SAMPLES)
    torch.cuda.synchronize()
    fe_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    summaries = fe.coefficient_summaries
    fe_finite = len(summaries) == batch.num_features and all(
        np.isfinite([s.mean, s.std_dev, s.min, s.max]).all() for s in summaries)
    bad = []
    if not gathered_same:
        bad.append("gathered entity lanes differ from the full run")
    if not fe_finite:
        bad.append("non-finite coefficient summaries in bootstrap_train")
    if not np.isfinite(full.samples).all():
        bad.append("non-finite random-effect bootstrap coefficients")
    stats = {"single_s": single_s, "bootstrap_s": boot_s, "bootstrap_overhead_ratio": ratio,
             "gathered_s": gathered_s, "gathered_bit_identical": gathered_same,
             "re_summary": full.summary(), "fe_bootstrap_s": fe_s,
             "fe_significant": int(len(fe.significant_coefficients())),
             "fe_metrics": {k: s.mean for k, s in fe.metric_summaries.items()}, "card": card}
    print(f"path 12c: bootstrap_overhead_ratio={ratio:.4f} single_s={single_s:.4f} "
          f"bootstrap_s={boot_s:.4f} samples={B} entities={E} rows={R} features={K} "
          f"gathered={BOOT_GATHERED} gathered_s={gathered_s:.4f} "
          f"gathered_bit_identical={gathered_same} re_summary={json.dumps(full.summary())} "
          f"fe_bootstrap_s={fe_s:.4f} fe_samples={GLM_BOOTSTRAP_SAMPLES} "
          f"fe_significant={stats['fe_significant']} launches={json.dumps(launches)} "
          f"card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 12c: bad result: {bad}")
    missing = [k for k in ("csr_margins_lanes", "csc_scatter_lanes") if launches[k] == 0]
    if missing:
        raise RuntimeError(f"path 12c: kernels not launched: {missing}")
    return launches, stats


def _game_split(seed: int):
    """Path 6's draws with every tenth row held out: the (train, validation)
    GameDatasets, interleaved as tests/test_sweep.py's split."""
    from photon_ml_tpu_torch.game import FeatureShard, build_game_dataset

    fe_vals, _, fe_cols, users, Xu, y = make_game_problem(seed)
    held = np.arange(N_ROWS) % 10 == 9

    def subset(mask):
        idx = np.flatnonzero(mask)
        m = len(idx)
        rows = np.repeat(np.arange(m, dtype=np.int64), NNZ_PER_ROW)
        xu = Xu[idx]
        ru, cu = np.nonzero(xu)
        return build_game_dataset(y[idx], {
            "global": FeatureShard.from_coo(fe_vals.reshape(N_ROWS, NNZ_PER_ROW)[idx].ravel(),
                                            rows, fe_cols.reshape(N_ROWS, NNZ_PER_ROW)[idx]
                                            .ravel(), N_FEATURES),
            "user": FeatureShard.from_coo(xu[ru, cu], ru, cu, GAME_RE_FEATURES),
        }, id_columns={"userId": users[idx]})

    return subset(~held), subset(held)


def _game_sweep_config(fe_lambda: float = 1.0):
    import dataclasses as dc

    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.optim.factory import OptimizerType

    opt = dc.replace(solver_config("lbfgs", 20), regularization_weight=fe_lambda)
    re_opt = dc.replace(opt, optimizer_type=OptimizerType.NEWTON, tolerance=1e-7,
                        regularization_weight=1.0)
    return GameConfig(task="logistic", num_iterations=SWEEP_GAME_CD_ITERATIONS,
                      evaluators=["auc"], coordinates={
                          "fixed": FixedEffectConfig(shard_name="global", optimizer=opt),
                          "per-user": RandomEffectConfig(shard_name="user", id_name="userId",
                                                         optimizer=re_opt)})


def run_sweep_game_path(seed: int, card: str) -> tuple[dict, dict]:
    """Path 12b: ``GameEstimator.fit_sweep`` at BASELINE config #4 (path 6's
    draws and coordinates, every tenth row held out), the grid
    GAME_SWEEP_GRID for both coordinates, one CD iteration
    (``SWEEP_GAME_CD_ITERATIONS``), selected on
    ``auc``. Fails unless the winner saved under ``best/`` and the one
    published to a serving registry (``fit_sweep(registry_dir=...)``)
    reload and score bit for bit, the winning lane's validation AUC is within 1e-3 of
    ``GameEstimator.fit`` at the winning lambda, ``fit_grid`` over two fixed
    effects (L2 1 and 10) returns its entries best-first, each bit for bit
    the ``fit`` of its combination, the lane kernels launched in the sweep
    and the single ones in ``fit_grid``."""
    import dataclasses as dc

    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.data.model_store import load_game_model
    from photon_ml_tpu_torch.evaluation.evaluators import auc
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.sweep import parse_sweep_spec

    t0 = time.perf_counter()
    train, val = _game_split(seed)
    setup_s = time.perf_counter() - t0
    grid = parse_sweep_spec(GAME_SWEEP_GRID)
    config = _game_sweep_config()
    bad = []

    def val_auc(model):
        return float(auc(model.score(val) + val.per_row(val.offset), val.per_row(val.response),
                         val.per_row(val.weight)))

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    maps = {"global": [f"g{j}" for j in range(N_FEATURES)],
            "user": [f"u{j}" for j in range(GAME_RE_FEATURES)]}
    with tempfile.TemporaryDirectory(dir=build_dir) as out:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fs = GameEstimator(config).fit_sweep(train, val, grid, metric="auc", output_dir=out,
                                             registry_dir=os.path.join(out, "registry"),
                                             index_maps=maps)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        sweep_launches = dict(kernels.LAUNCHES)
        loaded = load_game_model(os.path.join(out, "best"))
        reloaded_same = torch.equal(loaded.score(val), fs.model.score(val))
        # the winner published to the serving registry reloads bit for bit
        published = fs.published_version
        published_same = (published is not None
                          and os.path.basename(published) == "v-00000001"
                          and torch.equal(load_game_model(published).score(val),
                                          fs.model.score(val)))
    sel = fs.selection
    lam = grid.default[sel.index]
    conv = fs.sweep.convergence()
    print(f"path 12b sweep: sweep_s={sweep_s:.4f} selected_index={sel.index} lambda={lam:.6g} "
          f"auc={sel.best_value:.9g} aucs={json.dumps(sel.to_json()['values'])} "
          f"fe_iterations={conv['fixed']['iterations'].tolist()} "
          f"re_iterations={conv['per-user']['iterations'].tolist()} "
          f"best_reloaded_bit_identical={reloaded_same} "
          f"published={os.path.basename(published or '')} "
          f"published_reloaded_bit_identical={published_same} "
          f"launches={json.dumps(sweep_launches)}", flush=True)
    if not reloaded_same:
        bad.append("the winner saved under best/ scores differently when loaded")
    if not published_same:
        bad.append("the winner published to the registry is missing or scores differently")
    t0 = time.perf_counter()
    winner_cfg = dc.replace(config, coordinates={
        name: dc.replace(c, optimizer=dc.replace(c.optimizer, regularization_weight=lam))
        for name, c in config.coordinates.items()})
    donor = GameEstimator(winner_cfg)
    fit_auc = val_auc(donor.fit(train).model)
    fit_s = time.perf_counter() - t0

    def estimator(cfg):
        # the random-effect dataset depends on the data, the id and shard
        # and the caps, never on the optimizer: one host build serves the
        # fits below
        est = GameEstimator(cfg)
        est._re_datasets = dict(donor._re_datasets)
        return est

    print(f"path 12b winner: fit at lambda {lam:.6g} auc={fit_auc:.9g} vs the lane's "
          f"{sel.best_value:.9g} fit_s={fit_s:.4f}", flush=True)
    if not abs(fit_auc - sel.best_value) <= 1e-3:
        bad.append(f"the winning lane's auc {sel.best_value} vs fit {fit_auc}")

    fe_opt = config.coordinates["fixed"].optimizer
    combos = [dc.replace(fe_opt, regularization_weight=v) for v in (1.0, 10.0)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    entries = estimator(config).fit_grid(train, val, {"fixed": combos})
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    grid_launches = dict(kernels.LAUNCHES)
    metrics = [e.result.best_metric for e in entries]
    if metrics != sorted(metrics, reverse=True):
        bad.append(f"fit_grid entries are not best-first: {metrics}")
    same = []
    for e in entries:
        cfg = dc.replace(config, coordinates={**config.coordinates, "fixed": dc.replace(
            config.coordinates["fixed"], optimizer=e.optimizer_configs["fixed"])})
        fit = estimator(cfg).fit(train, validation_data=val)
        same.append(fit.best_metric == e.result.best_metric
                    and torch.equal(fit.model.score(val), e.result.model.score(val)))
    print(f"path 12b grid: grid_s={grid_s:.4f} metrics={metrics} "
          f"lambdas={[e.optimizer_configs['fixed'].regularization_weight for e in entries]} "
          f"entries_bit_identical_to_fit={same} launches={json.dumps(grid_launches)}",
          flush=True)
    if not all(same):
        bad.append(f"fit_grid entries differ from fit: {same}")
    launches = {k: sweep_launches[k] + grid_launches[k] for k in sweep_launches}
    stats = {"setup_s": setup_s, "sweep_s": sweep_s, "selected_index": sel.index,
             "selected_lambda": lam, "selected_auc": sel.best_value, "aucs": sel.to_json(),
             "fit_auc_at_winner": fit_auc, "grid_s": grid_s, "grid_metrics": metrics,
             "best_reloaded_bit_identical": reloaded_same,
             "published_reloaded_bit_identical": published_same, "grid_bit_identical": same,
             "card": card}
    print(f"path 12b: setup_s={setup_s:.4f} sweep_s={sweep_s:.4f} grid_s={grid_s:.4f} "
          f"card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 12b: bad result: {bad}")
    missing = [k for k in ("csr_margins_lanes", "csc_scatter_lanes")
               if sweep_launches[k] == 0] + [
        k for k in ("csr_margins", "csc_scatter") if grid_launches[k] == 0]
    if missing:
        raise RuntimeError(f"path 12b: kernels not launched: {missing}")
    return launches, stats


def run_sweep_cli_path(card: str, work: str, glm_ref: dict) -> tuple[dict, dict]:
    """Path 12d, after path 10 and on its files: ``cli glm`` in process on
    path 8's LIBSVM files with ``"diagnostics": true`` (both report files
    written, the stages ending DIAGNOSED, the VALIDATED results bit for bit
    path 8's), and ``cli sweep`` in process on path 10's Avro files (the
    first three for training, the fourth for validation, the grid
    CLI_SWEEP_GRID): its selected index and metric must equal an in-process
    ``fit_sweep`` on the datasets the driver read."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.cli import train as cli_train
    from photon_ml_tpu_torch.config import parse_game_config
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.sweep import parse_sweep_spec

    bad, stats = [], {"card": card}
    with open(os.path.join(work, "glm.json")) as fh:
        glm_cfg = json.load(fh)
    glm_out = os.path.join(work, "glm_diagnosed")
    glm_cfg.update(diagnostics=True, output_dir=glm_out)
    cfg_path = os.path.join(work, "glm_diagnosed.json")
    with open(cfg_path, "w") as fh:
        json.dump(glm_cfg, fh)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    glm = _run_cli_in_process(["glm", "--config", cfg_path])
    torch.cuda.synchronize()
    stats["glm_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    glm_same = {
        "stages": glm["stages"] == ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED", "DIAGNOSED"],
        "best_lambda": glm["best_lambda"] == glm_ref["best_lambda"],
        "best_metric": glm["best_metric"] == glm_ref["heldout_auc"],
        "metrics": all(
            sorted(glm["metrics"][str(lam)]) == sorted(ref)
            and all(_same_or_both_nan(glm["metrics"][str(lam)][k], v) for k, v in ref.items())
            for lam, ref in glm_ref["metrics"].items()),
        "reports": all(os.path.getsize(glm["report"][k]) > 0 for k in ("html", "text")),
    }
    stats.update(glm_same=glm_same, glm_report_bytes={
        k: os.path.getsize(p) for k, p in glm["report"].items()})
    print(f"path 12d glm: glm_s={stats['glm_s']:.4f} stages={glm['stages']} "
          f"report_bytes={json.dumps(stats['glm_report_bytes'])} "
          f"bit_identical_to_path_8={json.dumps(glm_same)} launches={json.dumps(launches)} "
          f"card={card}", flush=True)
    if not all(glm_same.values()):
        bad.append(f"cli glm with diagnostics differs from path 8: {glm_same}")

    data_dir = os.path.join(work, "avro")
    parts = [os.path.join(data_dir, f"part-{p}.avro") for p in range(4)]
    lbfgs = {"type": "lbfgs", "max_iterations": 20, "tolerance": 0.0, "regularization": "l2",
             "regularization_weight": 1.0}
    config = {"task": "logistic", "num_iterations": GAME_CD_ITERATIONS, "evaluators": ["auc"],
              "input": {"format": "avro", "paths": parts[:3], "add_intercept": False,
                        "feature_shards": {"global": ["global"], "user": ["user"]},
                        "id_columns": ["userId"]},
              "validation": {"paths": parts[3:]},
              "output_dir": os.path.join(work, "sweep_model"),
              "coordinates": {
                  "fixed": {"type": "fixed_effect", "shard_name": "global", "optimizer": lbfgs},
                  "per-user": {"type": "random_effect", "shard_name": "user",
                               "id_name": "userId",
                               "optimizer": {**lbfgs, "type": "newton", "tolerance": 1e-7}}}}
    cfg_path = os.path.join(work, "sweep.json")
    with open(cfg_path, "w") as fh:
        json.dump(config, fh)
    reads, read_input = [], cli_train.read_input

    def spy_read(*a, **k):
        reads.append(read_input(*a, **k))
        return reads[-1]

    cli_train.read_input = spy_read
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        summary = _run_cli_in_process(["sweep", "--config", cfg_path, "--sweep",
                                       CLI_SWEEP_GRID])["sweep"]
    finally:
        cli_train.read_input = read_input
    torch.cuda.synchronize()
    stats["sweep_cli_s"] = time.perf_counter() - t0
    for k, n in kernels.LAUNCHES.items():
        launches[k] += n
    (train, _), (val, _) = reads
    fs = GameEstimator(parse_game_config(config)).fit_sweep(
        train, val, parse_sweep_spec(CLI_SWEEP_GRID))
    sweep_same = {"selected_index": summary["selected_index"] == fs.selection.index,
                  "selected_metric": summary["selected_metric"] == fs.selection.best_value,
                  "best_written": os.path.exists(os.path.join(config["output_dir"], "best",
                                                              "model-metadata.json"))}
    stats.update(sweep_same=sweep_same, sweep_selected=summary["selected_index"],
                 sweep_metrics=[c["metric"] for c in summary["configs"]])
    print(f"path 12d sweep: sweep_cli_s={stats['sweep_cli_s']:.4f} train_rows={train.num_rows} "
          f"validation_rows={val.num_rows} selected_index={summary['selected_index']} "
          f"selected_metric={summary['selected_metric']:.9g} "
          f"aucs={json.dumps(stats['sweep_metrics'])} "
          f"same_as_fit_sweep={json.dumps(sweep_same)} card={card}", flush=True)
    if not all(sweep_same.values()):
        bad.append(f"cli sweep differs from fit_sweep: {sweep_same}")
    if bad:
        raise RuntimeError(f"path 12d: bad result: {bad}")
    return launches, stats


def serving_rows(gds, idx) -> list[dict]:
    """Rows ``idx`` of a GAME dataset in the serving request schema: both
    shards' features as [col, value] pairs, the user id and the offset."""
    idx = np.asarray(idx, np.int64)
    ids = gds.id_columns["userId"]
    uid = ids.vocab[ids.codes[idx]].tolist()
    offsets = np.asarray(gds.offset, np.float64)[idx].tolist()
    feats = {}
    for name in ("global", "user"):
        sh = gds.shard(name)
        ptr = np.searchsorted(sh.rows, np.arange(gds.num_rows + 1))
        lo, hi = ptr[idx], ptr[idx + 1]
        lengths = hi - lo
        take = np.repeat(lo - np.cumsum(lengths) + lengths, lengths) + np.arange(lengths.sum())
        pairs = list(map(list, zip(sh.cols[take].tolist(), sh.values[take].tolist())))
        ends = np.cumsum(lengths).tolist()
        feats[name] = [pairs[a:b] for a, b in zip([0] + ends[:-1], ends)]
    return [{"features": {"global": g, "user": u}, "ids": {"userId": int(i)}, "offset": o}
            for g, u, i, o in zip(feats["global"], feats["user"], uid, offsets)]


def _percentile_ms(values, q: float) -> float:
    if not len(values):
        return float("nan")
    return float(np.percentile(np.asarray(values, np.float64) * 1e3, q))


def _http_traffic(port: int, bodies_path: str, out_path: str, n_clients: int,
                  min_requests: int, marks) -> tuple:
    """Start ``tools/http_load.py`` in a process of its own: ``n_clients``
    closed-loop keep-alive HTTP clients cycling over the request bodies in
    ``bodies_path`` until told to stop and at least ``min_requests`` have
    completed. A thread here follows its progress lines, counting answers by
    model version and setting each ``(count, event)`` of ``marks`` once that
    many answers have come back, and the times of its first request and of
    its last answer. Returns the process, the progress dict and the
    thread."""
    import subprocess
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(root, "photon_ml_tpu_torch", "tools", "http_load.py"),
         "--port", str(port), "--bodies", bodies_path, "--out", out_path,
         "--clients", str(n_clients), "--min-requests", str(min_requests)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=root)
    progress = {"done": 0, "by_version": {}, "t_ready": None, "t_last": None}

    def follow():
        for line in proc.stdout:
            parts = line.split()
            if parts == ["ready"]:
                progress["t_ready"] = time.perf_counter()
            if len(parts) != 2:
                continue
            n, version = int(parts[0]), parts[1]
            progress["done"], progress["t_last"] = n, time.perf_counter()
            progress["by_version"][version] = progress["by_version"].get(version, 0) + 1
            for at, ev in marks:
                if n >= at:
                    ev.set()

    reader = threading.Thread(target=follow, daemon=True)
    reader.start()
    return proc, progress, reader


class _Scored:
    """A model's one scoring pass, for ``game_quality_stats`` (which reads
    ``task`` and calls ``score``) without scoring the model again."""

    def __init__(self, task: str, scores):
        self.task, self._scores = task, scores

    def score(self, data):
        return self._scores


def _pad_entities(model, multiple: int):
    """``model`` with every random-effect bucket padded to a multiple of
    ``multiple`` entities (zero coefficients, the last row's projection): no
    entity maps to a padding row, so every score is the unpadded model's."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch.game.models import RandomEffectModel

    for name, sub in model.models.items():
        if not isinstance(sub, RandomEffectModel):
            continue
        buckets = []
        for bm in sub.buckets:
            pad = -bm.coefficients.shape[0] % multiple
            if pad:
                bm = dataclasses.replace(
                    bm, coefficients=torch.cat([bm.coefficients,
                                                bm.coefficients.new_zeros((pad,) + tuple(
                                                    bm.coefficients.shape[1:]))]),
                    projection=torch.cat([bm.projection, bm.projection[-1:].expand(pad, -1)]),
                    entity_codes=np.concatenate([bm.entity_codes, np.full(pad, -1, np.int32)]),
                    variances=None)
            buckets.append(bm)
        model = model.with_model(name, dataclasses.replace(sub, buckets=tuple(buckets)))
    return model


def _nearline_direct(engine, model, updater, events_by_user: dict, config) -> tuple[dict, float]:
    """The warm-started lane solve that a nearline flush of ``events_by_user``
    must equal, built from the events and the served ``model`` directly: per
    bucket, in the flush's lane order, each event's features mapped into its
    entity's projection row, its residual offset the event offset plus every
    other coordinate's margin of the event (the fixed effect's, then each
    other random effect's, found in ``model``'s own buckets), entity lanes
    padded to a power of two by the last lane, warm-started from the live
    rows. Returns ``{bucket: (positions, w [n, K])}`` and the largest
    |margin| that the other random effects added to an event."""
    from photon_ml_tpu_torch.game.models import FixedEffectModel, map_vocab_codes
    from photon_ml_tpu_torch.ops.dense import DenseBatch
    from photon_ml_tpu_torch.optim.adapter import glm_adapter
    from photon_ml_tpu_torch.optim.factory import build_objective, dispatch_solve

    slot = engine.re_slot_for("userId")
    _id, lookup, ebkt, epos = engine.re_host(slot)
    # the update targets the first random effect keyed by the id
    target = next(name for name, sub in model.models.items()
                  if not isinstance(sub, FixedEffectModel) and sub.id_name == "userId")
    others = []  # (shard, w) for a fixed effect, (shard, sub, cache) for a random one
    for name, sub in model.models.items():
        if isinstance(sub, FixedEffectModel):
            others.append((sub.shard_name, sub.coefficients.detach().cpu().numpy()))
        elif name != target:
            others.append((sub.shard_name, sub, {}))

    def other_margin(shard, sub, cache, ev):
        code = int(map_vocab_codes(sub.vocab, np.asarray([ev["ids"][sub.id_name]],
                                                          sub.vocab.dtype))[0])
        if code < 0 or sub.entity_bucket[code] < 0:
            return 0.0
        b, pos = int(sub.entity_bucket[code]), int(sub.entity_pos[code])
        if b not in cache:
            bm = sub.buckets[b]
            cache[b] = (bm.projection.cpu().numpy(), bm.coefficients.detach().cpu().numpy())
        row_p, row_c = cache[b][0][pos], cache[b][1][pos]
        total = 0.0
        for col, val in ev["features"].get(shard, ()):
            kk = int(np.searchsorted(row_p, col))
            if kk < row_p.shape[0] and row_p[kk] == col:
                total += float(row_c[kk]) * val
        return total

    tables = engine.re_tables(slot)
    by_bucket = {}
    for user, evs in events_by_user.items():
        code = lookup[str(user)]
        by_bucket.setdefault(int(ebkt[code]), []).append((int(epos[code]), evs))
    obj = build_objective("logistic", config)
    l1 = config.regularization.l1_weight(config.regularization_weight)
    out, other_max = {}, 0.0
    for b, members in sorted(by_bucket.items()):
        proj = tables[b][0].cpu().numpy()
        k = proj.shape[1]
        r = updater.rows_per_solve
        lanes = []
        for pos, evs in members:
            row, rows = proj[pos], []
            for ev in evs[-r:]:
                xrow, total, mapped = np.zeros(k, np.float32), float(ev["offset"]), 0
                for col, val in ev["features"]["global"]:
                    kk = int(np.searchsorted(row, col))
                    if kk < k and row[kk] == col:  # out-of-projection features drop
                        xrow[kk] = val
                        mapped += 1
                # the residual: each other coordinate's margin, summed in model order
                for other in others:
                    if len(other) == 2:
                        for col, val in ev["features"].get(other[0], ()):
                            total += float(other[1][col]) * val
                    else:
                        m = other_margin(*other, ev)
                        other_max = max(other_max, abs(m))
                        total += m
                if mapped:  # an event with no feature in the projection drops whole
                    rows.append((xrow, ev["label"], total))
            if rows:  # an entity left without rows keeps its live row
                lanes.append((pos, rows))
        n = len(lanes)
        if not n:
            continue
        n_pad = 1 << (n - 1).bit_length()
        x = np.zeros((n_pad, r, k), np.float32)
        labels, offsets, weights = (np.zeros((n_pad, r), np.float32) for _ in range(3))
        positions = np.zeros(n_pad, np.int32)
        for j, (pos, rows) in enumerate(lanes):
            positions[j] = pos
            for i, (xrow, label, total) in enumerate(rows):
                x[j, i], labels[j, i], offsets[j, i], weights[j, i] = xrow, label, total, 1.0
        for j in range(n, n_pad):
            x[j], labels[j], offsets[j], weights[j] = x[n - 1], labels[n - 1], offsets[n - 1], \
                weights[n - 1]
            positions[j] = positions[n - 1]
        w0 = engine.gather_re_rows(slot, b, positions)
        batch = DenseBatch.from_arrays(x, labels, offsets, weights, device=engine.device)
        res = dispatch_solve(glm_adapter(obj, batch), w0, config, l1, None, device=engine.device)
        out[b] = (positions[:n], res.w[:n])
    return out, other_max


def run_serving_path(gds, model6, model9, seed: int, card: str, work: str,
                     profile: bool) -> tuple[dict, dict, dict | None, object]:
    """Path 15: config #4's GLMix model served. Each model is scored once
    over path 6's rows; that pass gives the expected means (``predict_mean``'s
    own arithmetic: the sigmoid of the scores plus the offsets) and the
    quality gate's stats (``game_quality_stats``). Path 6's model is
    published as registry version 1 with the gate on, loaded by
    ``ModelRegistry`` and warmed; at least SERVE_REQUESTS requests of 1-64
    of path 6's rows go through ``ContinuousBatcher`` + ``ScoringServer``
    (HTTP) from 8 closed-loop clients in a process of their own, each
    answer within 1e-6 of its expected mean; in mid
    traffic path 9's model (30M coefficients, buckets with K up to 256) is
    published as version 2 and swapped in with zero failed requests. Then:
    csr_margins at the request batch against its plain version; the same
    rows scored twice bit for bit; ``cli serve --stdio`` in a subprocess
    bit for bit the in-process engine; nearline events for 256 users
    flushed, their rows equal to a direct warm-started lane solve (1e-6),
    every other user's score bit for bit; a label-shuffled candidate
    quarantined with the registry untouched. Returns the launches, the
    stats, the profile and the registry (for path 15b)."""
    import dataclasses
    import subprocess
    import threading

    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.kernels import reference
    from photon_ml_tpu_torch.quality import QualityGateRefused, game_quality_stats
    from photon_ml_tpu_torch.serving import (
        ModelRegistry,
        NearlineUpdater,
        ScoringServer,
        ScoringService,
        publish_version,
        scan_versions,
    )

    bad = []
    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t_path = time.perf_counter()
    maps = {"global": IndexMap([f"g{j}" for j in range(N_FEATURES)]),
            "user": IndexMap([f"u{j}" for j in range(GAME_RE_FEATURES)])}
    reg = os.path.join(work, "registry")
    t0 = time.perf_counter()
    scores = {1: model6.score(gds), 2: model9.score(gds)}
    offsets = gds.per_row(gds.offset)
    # predict_mean's own arithmetic on the one scoring pass of each model
    expected = {f"v-0000000{v}": torch.sigmoid(s + offsets).cpu().numpy().astype(np.float64)
                for v, s in scores.items()}
    score_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q1 = game_quality_stats(_Scored(model6.task, scores[1]), gds, num_samples=GATE_SAMPLES,
                            seed=seed)
    q2 = game_quality_stats(_Scored(model9.task, scores[2]), gds, num_samples=GATE_SAMPLES,
                            seed=seed)
    gate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    publish_version(reg, model6, maps, quality=q1.to_json())
    publish_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    registry = ModelRegistry(reg, max_batch=SERVE_MAX_BATCH, poll_interval=0.2).start()
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 15)
    t0 = time.perf_counter()
    sizes = rng.integers(1, SERVE_MAX_BATCH + 1, size=SERVE_REQUESTS)
    starts = rng.integers(0, gds.num_rows - SERVE_MAX_BATCH, size=SERVE_REQUESTS)
    idxs = [np.arange(a, a + n) for a, n in zip(starts, sizes)]
    all_rows = serving_rows(gds, np.concatenate(idxs))
    requests, at = [], 0
    for idx in idxs:
        requests.append((idx, all_rows[at:at + len(idx)]))
        at += len(idx)
    rows_s = time.perf_counter() - t0
    print(f"path 15 setup: score_s={score_s:.4f} gate_stats_s={gate_s:.4f} "
          f"publish_v1_s={publish_s:.4f} "
          f"registry_load_warm_s={load_s:.4f} request_rows_s={rows_s:.4f} "
          f"v1_auc={q1.auc:.6f} [{q1.auc_ci_low:.6f}, {q1.auc_ci_high:.6f}] "
          f"v2_auc={q2.auc:.6f} requests={len(requests)} rows={at}", flush=True)

    # the request bodies, encoded once; the clients run in a process of their own
    bodies_path = os.path.join(work, "bodies.jsonl")
    with open(bodies_path, "w") as f:
        for _idx, rows in requests:
            f.write(json.dumps({"rows": rows}) + "\n")
    out_path = os.path.join(work, "http_load.json")
    service = ScoringService(registry, max_batch=SERVE_MAX_BATCH, queue_depth=4096,
                             batcher="continuous")
    server = ScoringServer(service, port=0).start()
    steady_from, steady_to = threading.Event(), threading.Event()
    snap = {}
    proc = None
    try:
        proc, progress, reader = _http_traffic(
            server.port, bodies_path, out_path, SERVE_CLIENTS, SERVE_REQUESTS,
            ((SERVE_REQUESTS // 20, steady_from), (SERVE_REQUESTS // 3, steady_to)))
        steady_from.wait(timeout=300)
        torch.cuda.synchronize()
        snap["from"] = (telemetry.snapshot(), torch.cuda.memory_reserved(),
                        dict(kernels.LAUNCHES), progress["done"], time.perf_counter())
        steady_to.wait(timeout=300)
        snap["to"] = (telemetry.snapshot(), torch.cuda.memory_reserved(),
                      dict(kernels.LAUNCHES), progress["done"], time.perf_counter())
        # the hot swap, mid traffic: version 2 published with the gate on
        t0 = time.perf_counter()
        publish_version(reg, model9, maps, quality=q2.to_json())
        publish2_s = time.perf_counter() - t0
        deadline = time.monotonic() + 300
        while registry.current_version != "v-00000002" and time.monotonic() < deadline:
            time.sleep(0.05)
        swap_s = time.perf_counter() - t0
        n_at_swap = progress["done"]
        while (progress["by_version"].get("v-00000002", 0) < 500
               and time.monotonic() < deadline and proc.poll() is None):
            time.sleep(0.05)
        try:
            proc.stdin.write("stop\n")
            proc.stdin.close()
        except BrokenPipeError:  # the clients are gone already: their exit code says why
            pass
        proc.wait(timeout=300)
        reader.join(timeout=60)
        traffic_s = progress["t_last"] - progress["t_ready"]
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop()
    if proc.returncode != 0:
        raise RuntimeError(f"path 15: the HTTP clients exited {proc.returncode}")
    with open(out_path) as f:
        load = json.load(f)
    failures = load["failures"]
    records = []  # (version, rows, seconds, max abs error) in the order answered
    for i, version, dt, got in load["records"]:
        idx = requests[i][0]
        err = float(np.max(np.abs(np.asarray(got, np.float64) - expected[version][idx])))
        records.append((version, len(idx), dt, err))
    snap_end = telemetry.snapshot()
    versions = {}
    for version, n, dt, err in records:
        v = versions.setdefault(version, {"requests": 0, "rows": 0, "max_abs_err": 0.0,
                                          "latency_s": []})
        v["requests"] += 1
        v["rows"] += n
        v["max_abs_err"] = max(v["max_abs_err"], err)
        v["latency_s"].append(dt)
    lat = [r[2] for r in records]
    n_rows = sum(r[1] for r in records)
    (s_from, res_from, l_from, n_from, t_from), (s_to, res_to, l_to, n_to, t_to) = \
        snap["from"], snap["to"]

    def counter(sn, name):
        return sn["counters"].get(name, 0)

    def hist_count(sn, name):
        return sn["histograms"].get(name, {}).get("count", 0)

    steady_batches = hist_count(s_to, "serving.batch_size") - hist_count(s_from,
                                                                         "serving.batch_size")
    steady_syncs = counter(s_to, "host_syncs") - counter(s_from, "host_syncs")
    steady_launches = l_to["csr_margins"] - l_from["csr_margins"]
    steady_lat = [r[2] for r in records[n_from:n_to]]
    steady_rows = sum(r[1] for r in records[n_from:n_to])
    stats = {
        "card": card, "requests": len(records), "rows": n_rows, "traffic_s": traffic_s,
        "rows_per_s": n_rows / traffic_s, "requests_per_s": len(records) / traffic_s,
        "p50_ms": _percentile_ms(lat, 50), "p99_ms": _percentile_ms(lat, 99),
        "steady": {"requests": n_to - n_from, "rows": steady_rows,
                   "rows_per_s": steady_rows / (t_to - t_from),
                   "p50_ms": _percentile_ms(steady_lat, 50),
                   "p99_ms": _percentile_ms(steady_lat, 99),
                   "batches": steady_batches,
                   "host_syncs_per_batch": steady_syncs / max(steady_batches, 1),
                   "csr_margins_per_batch": steady_launches / max(steady_batches, 1),
                   "rows_per_batch": steady_rows / max(steady_batches, 1),
                   "reserved_bytes_before": res_from, "reserved_bytes_after": res_to},
        "by_version": {v: {k: x for k, x in d.items() if k != "latency_s"}
                       | {"p50_ms": _percentile_ms(d["latency_s"], 50),
                          "p99_ms": _percentile_ms(d["latency_s"], 99)}
                       for v, d in versions.items()},
        "failures": len(failures), "publish_v2_s": publish2_s, "swap_s": swap_s,
        "requests_at_swap": n_at_swap, "gate_stats_s": gate_s, "registry_load_warm_s": load_s,
        "server_total_ms": snap_end["histograms"].get("serving.total_ms"),
        "engine_call_ms": snap_end["histograms"].get("serving.device_ms"),
        "server_queue_ms": snap_end["histograms"].get("serving.queue_ms"),
        "batch_size": snap_end["histograms"].get("serving.batch_size"),
        "model_swaps": counter(snap_end, "serving.model_swaps"),
    }
    print(f"path 15 traffic: requests={len(records)} rows={n_rows} traffic_s={traffic_s:.4f} "
          f"rows_per_s={stats['rows_per_s']:.1f} p50_ms={stats['p50_ms']:.4f} "
          f"p99_ms={stats['p99_ms']:.4f} failures={len(failures)} swap_s={swap_s:.4f} "
          f"by_version={json.dumps(stats['by_version'])} card={card}", flush=True)
    print(f"path 15 steady (v1, requests {n_from}..{n_to}): "
          f"{json.dumps(stats['steady'])} card={card}", flush=True)
    if failures:
        bad.append(f"{len(failures)} failed requests: {failures[:3]}")
    if set(versions) != {"v-00000001", "v-00000002"}:
        bad.append(f"versions served: {sorted(versions)}")
    worst = max((d["max_abs_err"] for d in versions.values()), default=float("inf"))
    if not worst <= SERVE_ATOL:
        bad.append(f"served scores differ from predict_mean by {worst}")
    if res_to != res_from:
        bad.append(f"the allocator grew in the steady window: {res_from} -> {res_to}")
    # one batch may be in flight at each end of the window: counted
    # dispatched but not yet fetched
    if abs(steady_syncs - steady_batches) > 1:
        bad.append(f"host syncs {steady_syncs} for {steady_batches} request batches")
    if len(records) < SERVE_REQUESTS:
        bad.append(f"only {len(records)} requests served")

    engine = registry.engine
    check_idx = np.concatenate(idxs[:64])
    check_rows = all_rows[:len(check_idx)]
    first, again = engine.score_rows(check_rows), engine.score_rows(check_rows)
    twice = bool(np.array_equal(first, again))
    direct_err = float(np.max(np.abs(first - expected["v-00000002"][check_idx])))
    print(f"path 15 twice: rows={len(check_idx)} bit_identical={twice} "
          f"max_abs_err_vs_predict_mean={direct_err:.3e}", flush=True)
    if not twice or not direct_err <= SERVE_ATOL:
        bad.append(f"repeat bit for bit {twice}, predict_mean error {direct_err}")

    # where a request batch's time goes with no client beside it: the
    # host assembly (parse, validate, stage, one copy) against the whole
    # score call (assembly, the device pass, the one fetch), sequentially
    # over the first 200 requests
    chunks = [rows for _idx, rows in requests[:200]]
    tables = engine._tables
    t0 = time.perf_counter()
    for rows in chunks:
        with engine._score_lock:
            engine._assemble(rows, engine._bucket_for(len(rows)), tables)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for rows in chunks:
        engine.score_rows(rows)
    call_s = time.perf_counter() - t0
    stats["uncontended"] = {"batches": len(chunks),
                            "rows": sum(len(r) for r in chunks),
                            "assemble_ms_per_batch": assemble_s / len(chunks) * 1e3,
                            "score_call_ms_per_batch": call_s / len(chunks) * 1e3}
    print(f"path 15 uncontended (v2, one caller): {json.dumps(stats['uncontended'])} "
          f"card={card}", flush=True)

    # cli serve --stdio in a subprocess: the registry's newest version,
    # bit for bit the in-process engine (after the wire's 8 decimals)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    lines = [json.dumps({"rows": rows}) for _idx, rows in requests[:64]]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.cli", "serve",
                           "--registry-dir", reg, "--stdio", "--max-batch",
                           str(SERVE_MAX_BATCH)], input="\n".join(lines) + "\n",
                          capture_output=True, text=True, timeout=600, cwd=root, env=env)
    stdio_s = time.perf_counter() - t0
    stdio_same = False
    if proc.returncode != 0:
        bad.append(f"cli serve --stdio exited {proc.returncode}: {proc.stderr[-1500:]}")
    else:
        got = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
        want = [[round(float(x), 8) for x in engine.score_rows(rows)]
                for _idx, rows in requests[:64]]
        stdio_same = ([g.get("scores") for g in got] == want
                      and {g.get("model_version") for g in got} == {"v-00000002"})
    print(f"path 15 cli serve --stdio: requests=64 wall_s={stdio_s:.4f} "
          f"bit_identical_to_in_process={stdio_same}", flush=True)
    if not stdio_same:
        bad.append("cli serve --stdio differs from the in-process engine")

    # nearline: 4 events for each of 256 users, flushed once
    users_all = gds.id_columns["userId"]
    uid = users_all.vocab[users_all.codes]
    _name, lookup, ebkt, _epos = engine.re_host(engine.re_slot_for("userId"))
    picked = []
    for user in rng.permutation(np.unique(uid)).tolist():
        code = lookup.get(str(user), -1)
        if code >= 0 and ebkt[code] >= 0:
            picked.append(user)
        if len(picked) == NEARLINE_USERS:
            break
    order = np.argsort(uid, kind="stable")
    first_row = np.searchsorted(uid[order], picked)
    ev_rows = {u: order[f:f + 4][uid[order[f:f + 4]] == u] for u, f in zip(picked, first_row)}
    ev_idx = np.concatenate(list(ev_rows.values()))
    ev_reqs = dict(zip(ev_idx.tolist(), serving_rows(gds, ev_idx)))
    # each event carries both shards, as a scored row does: the per-user
    # effect's margin enters the residual of the per-user-items update
    events_by_user = {u: [{"ids": {"userId": u}, "label": float(gds.response[r]),
                           "offset": float(gds.offset[r]),
                           "features": ev_reqs[r]["features"]}
                          for r in rows_u.tolist()] for u, rows_u in ev_rows.items()}
    config = re_optimizer("lbfgs", 20, 1e-7)
    updater = NearlineUpdater(registry, id_name="userId", config=config)
    direct, other_max = _nearline_direct(engine, model9, updater, events_by_user, config)
    touched = np.isin(uid[check_idx], picked)
    probe_idx = np.concatenate([check_idx, ev_idx])
    probe_rows = check_rows + [ev_reqs[r] for r in ev_idx.tolist()]
    probe_touched = np.isin(uid[probe_idx], picked)
    before = engine.score_rows(probe_rows)
    accepted = updater.submit([ev for evs in events_by_user.values() for ev in evs])
    t0 = time.perf_counter()
    flushed = updater.flush()
    flush_s = time.perf_counter() - t0
    after = engine.score_rows(probe_rows)
    slot = engine.re_slot_for("userId")
    row_err = 0.0
    for b, (positions, w) in direct.items():
        live = engine.gather_re_rows(slot, b, positions)
        row_err = max(row_err, float((live - w).abs().max()))
    untouched_same = bool(np.array_equal(before[~probe_touched], after[~probe_touched]))
    moved = bool(not np.allclose(before[probe_touched], after[probe_touched]))
    nl = telemetry.snapshot()
    stats["nearline"] = {"users": len(picked), "events": accepted, "flush": flushed,
                         "flush_s": flush_s, "max_row_err_vs_direct": row_err,
                         "other_effect_max_abs_margin": other_max,
                         "untouched_bit_identical": untouched_same, "touched_moved": moved,
                         "untouched_rows": int((~probe_touched).sum()),
                         "touched_rows": int(probe_touched.sum()),
                         "solve_ms": nl["histograms"].get("serving.nearline.solve_ms"),
                         "update_lag_ms": nl["histograms"].get(
                             "serving.nearline.update_lag_ms")}
    print(f"path 15 nearline: {json.dumps(stats['nearline'])}", flush=True)
    if flushed["entities"] != len(picked) or not row_err <= NEARLINE_ATOL:
        bad.append(f"nearline flush {flushed}, row error vs the direct solve {row_err}")
    if not other_max > 0.0:
        bad.append("nearline: the per-user effect added no margin to any event's residual")
    if not (untouched_same and moved):
        bad.append(f"nearline: untouched bit for bit {untouched_same}, touched moved {moved}")
    del touched

    # the quality gate: a label-shuffled candidate is quarantined
    shuffled = dataclasses.replace(gds, response=rng.permutation(gds.response))
    q_bad = game_quality_stats(_Scored(model6.task, scores[1]), shuffled,
                               num_samples=GATE_SAMPLES, seed=seed)
    listing = sorted(os.listdir(reg))
    quarantined = False
    try:
        publish_version(reg, model6, maps, quality=q_bad.to_json())
    except QualityGateRefused as e:
        quarantined = e.decision.decision == "quarantined"
        reason = e.decision.reason
    else:
        reason = "published"
    time.sleep(0.5)  # a poll interval and more: the registry must not move
    untouched = ([v for v, _p in scan_versions(reg)] == [1, 2]
                 and sorted(os.listdir(reg)) == sorted(listing + ["quarantined-v-00000003"])
                 and registry.current_version == "v-00000002")
    stats["gate"] = {"candidate_auc": q_bad.auc, "quarantined": quarantined, "reason": reason,
                     "registry_untouched": untouched}
    print(f"path 15 gate: {json.dumps(stats['gate'])}", flush=True)
    if not (quarantined and untouched):
        bad.append(f"the shuffled candidate: {stats['gate']}")

    launches = dict(kernels.LAUNCHES)
    stats["host_syncs"] = telemetry.snapshot()["counters"].get("host_syncs", 0)
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    stats["path_s"] = time.perf_counter() - t_path
    stats["launches"] = launches

    # csr_margins at the request batch (64 rows of path 6's fixed-effect
    # shard), outside the counted window
    b64 = gds.csr_batch("global")
    ptr = b64.row_ptr[:SERVE_MAX_BATCH + 1].contiguous()
    nnz = int(ptr[-1])
    cols, vals = b64.cols[:nnz].contiguous(), b64.vals[:nnz].contiguous()
    w = model6.models["fixed"].coefficients.contiguous()
    off = torch.zeros(SERVE_MAX_BATCH, device="cuda")
    got = kernels.csr_margins(ptr, cols, vals, w, off, 0.0, False)
    want = reference.csr_margins(ptr, cols, vals, w, off, 0.0, False)
    abs_err, _ = compare("csr_margins[request batch]", got, want)
    k_ms = device_ms(lambda: kernels.csr_margins(ptr, cols, vals, w, off, 0.0, False))
    p_ms = device_ms(lambda: reference.csr_margins(ptr, cols, vals, w, off, 0.0, False))
    nbytes = 4 * (SERVE_MAX_BATCH + 1) + 12 * nnz + 4 * SERVE_MAX_BATCH
    bound = max(nbytes / PEAK_BYTES_PER_S, 2 * nnz / PEAK_F32_FLOPS) * 1e3
    # the library call for the same function: torch.mv of the batch as sparse CSR
    lib_ms = library_ms(lambda: torch.sparse_csr_tensor(
        ptr, cols, vals, size=(SERVE_MAX_BATCH, b64.num_features), check_invariants=False),
        lambda m: torch.mv(m, w))
    stats["request_batch_kernel"] = {"rows": SERVE_MAX_BATCH, "nnz": nnz, "max_abs_err": abs_err,
                                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                                     "library_ms": lib_ms}
    print(f"path 15 csr_margins at the request batch: {json.dumps(stats['request_batch_kernel'])}"
          f" card={card}", flush=True)
    print(f"path 15: path_s={stats['path_s']:.4f} host_syncs={stats['host_syncs']} "
          f"max_memory_allocated={stats['max_memory_allocated']} "
          f"launches={json.dumps(launches)} card={card}", flush=True)
    prof = None
    if profile:
        def serve_once():
            for _idx, rows in requests[:200]:
                engine.score_rows(rows)

        prof = profile_solve("15", serve_once)
    if bad:
        registry.stop()
        raise RuntimeError(f"path 15: bad result: {bad}")
    if launches["csr_margins"] == 0:
        registry.stop()
        raise RuntimeError("path 15: csr_margins not launched")
    return launches, stats, prof, (registry, probe_rows)


def run_mesh_serving_path(registry, probe_rows, card: str) -> tuple[dict, dict]:
    """Path 15b: the served model (path 15's version 2 with its nearline
    rows) in an entity-sharded engine over a ``model`` axis of SERVE_MESH
    devices (each bucket padded to a multiple of it), its scores of path
    15's probe rows within 1e-6 of the single-device engine's."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.parallel import make_mesh
    from photon_ml_tpu_torch.serving import ScoringEngine

    try:
        engine = registry.engine
        want = engine.score_rows(probe_rows)
        model = _pad_entities(engine.current_model(), SERVE_MESH)
    finally:
        registry.stop()
    devices, kind = mesh_devices(SERVE_MESH)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sharded = ScoringEngine(model, max_batch=SERVE_MAX_BATCH, version="v-00000002",
                            mesh=make_mesh({"model": SERVE_MESH}, devices)).warmup()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = sharded.score_rows(probe_rows)
    _sync(devices)
    score_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    err = float(np.max(np.abs(got - want)))
    stats = {"devices": kind, "load_warm_s": load_s, "score_s": score_s,
             "rows": len(probe_rows), "max_abs_err": err,
             "bit_identical": bool(np.array_equal(got, want)),
             "part_rows": [int(p.parts[0].shape[0]) for p in
                           (coef for _proj, coef in sharded.re_tables(0))], "card": card}
    print(f"path 15b: {json.dumps(stats)} launches={json.dumps(launches)}", flush=True)
    if not err <= SERVE_ATOL:
        raise RuntimeError(f"path 15b: the sharded engine differs by {err}")
    if launches["csr_margins"] == 0:
        raise RuntimeError("path 15b: csr_margins not launched")
    return launches, stats


def _pad_vocabulary(model, multiple: int):
    """``model`` with every random-effect coordinate's vocabulary extended,
    past its largest value, by ids that no row carries, up to a multiple of
    ``multiple``; they have no model (bucket -1), so every score is the
    unpadded model's. Coordinates keyed by one id get the same ids."""
    import dataclasses

    from photon_ml_tpu_torch.game.models import RandomEffectModel

    for name, sub in model.models.items():
        if not isinstance(sub, RandomEffectModel):
            continue
        vocab = np.asarray(sub.vocab)
        pad = -len(vocab) % multiple
        if not pad:
            continue
        if vocab.dtype.kind in "iu":
            extra = vocab.max() + 1 + np.arange(pad, dtype=vocab.dtype)
        else:
            extra = np.array([f"~pad-{i:04d}" for i in range(pad)], dtype=vocab.dtype)
        model = model.with_model(name, dataclasses.replace(
            sub, vocab=np.concatenate([vocab, extra]),
            entity_bucket=np.concatenate([sub.entity_bucket,
                                          np.full(pad, -1, sub.entity_bucket.dtype)]),
            entity_pos=np.concatenate([sub.entity_pos, np.full(pad, -1, sub.entity_pos.dtype)])))
    return model


def _row_owner(lookups: dict, rows, fleet_size: int) -> np.ndarray:
    """The member owning each row's user (every row of path 6 has one)."""
    from photon_ml_tpu_torch.parallel.sharding import owner_of_row

    table = lookups["userId"]
    return np.array([owner_of_row(len(table), table[str(r["ids"]["userId"])], fleet_size)
                     for r in rows])


def _proc_lines(path: str) -> list[str]:
    """The lines of a /proc file; none where the machine does not have it."""
    try:
        with open(path) as fh:
            return fh.read().splitlines()
    except OSError:
        return []


def _proc_stat(pid: str):
    """(comm, ppid, user + system CPU seconds) of a process from /proc."""
    head, rest = _proc_lines(f"/proc/{pid}/stat")[0].rsplit(")", 1)
    fields = rest.split()
    tick = os.sysconf("SC_CLK_TCK")
    return head.split("(", 1)[1], int(fields[1]), (int(fields[11]) + int(fields[12])) / tick


def host_probe(label: str) -> dict:
    """What a path may leave behind, and fixed workloads timed now, so that
    paths run before and after it can be compared within one run: this
    process's threads, children, resident and swapped bytes, tracked Python
    objects and CPU seconds while it sleeps; every other process on the
    machine with its CPU seconds; the load average and the machine's memory
    and swap, where /proc has them; the card's allocated and reserved bytes;
    the seconds of a fixed host workload (numpy sort, a Python loop, 1 GiB
    allocated and touched) and the milliseconds of a fixed matmul on the
    card."""
    import gc
    import threading

    import torch

    me = os.getpid()
    others = []
    for pid in os.listdir("/proc"):
        if pid.isdigit() and int(pid) != me:
            try:
                comm, ppid, cpu_s = _proc_stat(pid)
            except (IndexError, ValueError):
                continue
            if int(pid) != 2 and ppid != 2:  # not the kernel's threads
                others.append([int(pid), ppid, comm, round(cpu_s, 2)])
    children = sorted(p[0] for p in others if p[1] == me)
    status = {ln.split(":")[0]: int(ln.split()[1]) * 1024
              for ln in _proc_lines("/proc/self/status") if ln.startswith(("VmRSS", "VmSwap"))}
    meminfo = {ln.split(":")[0]: int(ln.split()[1]) * 1024 for ln in _proc_lines("/proc/meminfo")
               if ln.startswith(("MemTotal", "MemAvailable", "Cached", "SwapTotal", "SwapFree"))}
    load = (_proc_lines("/proc/loadavg") or [""])[0].split()[:3]
    c0 = time.process_time()
    time.sleep(1.0)
    idle_cpu_s = time.process_time() - c0
    t0 = time.perf_counter()
    np.sort(np.random.default_rng(0).standard_normal(4_000_000))
    sum(i * i for i in range(2_000_000))
    np.ones(2**27).sum()
    host_s = time.perf_counter() - t0
    a = torch.ones(4096, 4096, device="cuda")
    a @ a
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        a @ a
    end.record()
    end.synchronize()
    del a
    out = {"threads": sorted(t.name for t in threading.enumerate()), "children": children,
           "others": others, "loadavg": load, "rss_bytes": status.get("VmRSS"),
           "swap_bytes": status.get("VmSwap"), "meminfo": meminfo,
           "python_objects": len(gc.get_objects()), "idle_cpu_s": round(idle_cpu_s, 4),
           "allocated_bytes": torch.cuda.memory_allocated(),
           "reserved_bytes": torch.cuda.memory_reserved(), "host_probe_s": round(host_s, 4),
           "matmul_probe_ms": round(start.elapsed_time(end), 4)}
    print(f"probe {label}: {json.dumps(out)}", flush=True)
    return out


def run_fleet_path(gds, registry_dir: str, seed: int, card: str,
                   work: str) -> tuple[dict, dict]:
    """Path 15c: the serving fleet on path 15's registry version 2 (path 9's
    model, both random effects keyed by ``userId``). Its 99,997 users divide
    over no fleet of 2-18 members, so the fleet serves it republished with
    the vocabulary padded to 100,000 (``_pad_vocabulary``: 3 ids with no
    model) into a registry of its own; the single engine it is held
    against loads version 2 itself.

    (a) In process: FLEET_SIZE ``ScoringServer``s, each over a
    ``ShardMemberSource`` on ``load_member_engine(v2, m, 4)`` on the card,
    and a ``FleetRouter`` over their announce files. FLEET_CALLS router
    calls of 1-64 of path 6's rows, each within 1e-6 of a single engine on
    v2 (``csr_margins`` launched by the members, counted around the calls);
    one call repeated bit for bit; each member's table bytes about a quarter
    of the full model's; a ``/v1/margins`` pinned to a version the members
    do not hold refused with 409;
    member 1's server stopped, the next call answering every row, the rows
    whose user member 1 owns equal to the single engine's FE-only scores
    within 1e-6 and ``serving.degraded_scores`` grown by exactly their
    count.

    (b) ``tools/serving_fleet.run_serving_fleet``: FLEET_SIZE ``cli serve
    --member`` processes on the card (member m on cuda:m mod count) under
    an ``--hbm-budget-mb`` halfway between a slice's bytes and the full
    model's (a member of a 1-member fleet, started beside them, must exit
    with ``ShardBudgetError``); traffic through the router; member 1
    hard-killed, detected by heartbeat and relaunched in its slot; a live
    resize 4 -> 8 -> 4. Zero failed calls, degraded rows in the kill window
    and none after the recovery, epoch 2 at size 4, every member on the
    card and every one but the killed exiting 75."""
    import urllib.error
    import urllib.request

    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.data.model_store import load_feature_index_maps, load_game_model
    from photon_ml_tpu_torch.parallel.sharding import valid_fleet_sizes
    from photon_ml_tpu_torch.serving import (
        FleetRouter,
        ScoringEngine,
        ScoringServer,
        ScoringService,
        ShardMemberSource,
        fleet_lookups_from_version_dir,
        load_member_engine,
        publish_version,
        write_announce,
    )
    from photon_ml_tpu_torch.tools import serving_fleet

    bad = []
    t_path = time.perf_counter()
    src = os.path.join(registry_dir, "v-00000002")
    t0 = time.perf_counter()
    model = load_game_model(src, device="cpu")
    vocab_sizes = {name: len(sub.vocab) for name, sub in model.models.items()
                   if hasattr(sub, "vocab")}
    vdir = publish_version(os.path.join(work, "fleet-registry"),
                           _pad_vocabulary(model, 2 * FLEET_SIZE),
                           load_feature_index_maps(src))
    version = os.path.basename(vdir)
    del model
    task, link, lookups = fleet_lookups_from_version_dir(vdir)
    republish_s = time.perf_counter() - t0
    print(f"path 15c: vocabularies {vocab_sizes} padded to {len(lookups['userId'])} "
          f"(valid fleet sizes before: {valid_fleet_sizes(min(vocab_sizes.values()))}); "
          f"republished as {vdir} in {republish_s:.4f} s", flush=True)
    telemetry.reset()
    t0 = time.perf_counter()
    full = ScoringEngine.load(src, max_batch=SERVE_MAX_BATCH).warmup()
    rng = np.random.default_rng(seed + 153)
    sizes = rng.integers(1, SERVE_MAX_BATCH + 1, size=FLEET_CALLS)
    starts = rng.integers(0, gds.num_rows - SERVE_MAX_BATCH, size=FLEET_CALLS)
    all_rows = serving_rows(gds, np.concatenate([np.arange(a, a + n)
                                                 for a, n in zip(starts, sizes)]))
    want = full.score_rows(all_rows).astype(np.float64)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    kill_rows = all_rows[:SERVE_MAX_BATCH]
    fe_only = full.score_rows([{k: v for k, v in r.items() if k != "ids"}
                               for r in kill_rows]).astype(np.float64)
    engines = {m: load_member_engine(vdir, m, FLEET_SIZE, max_batch=SERVE_MAX_BATCH)
               for m in range(FLEET_SIZE)}
    load_s = time.perf_counter() - t0
    member_bytes = [engines[m].model_bytes for m in range(FLEET_SIZE)]
    shares = [b / full.model_bytes for b in member_bytes]
    print(f"path 15c (a) tables: full={full.model_bytes} members={member_bytes} "
          f"shares={[round(x, 4) for x in shares]} version={version} load_s={load_s:.4f}",
          flush=True)
    if not all(0.2 <= x <= 0.3 for x in shares):
        bad.append(f"member table shares {shares}, not about a quarter")
    announce = os.path.join(work, "fleet-announce")
    servers = []
    router = None
    stats = {"card": card, "version": version, "vocab_sizes": vocab_sizes,
             "republish_s": republish_s, "full_bytes": full.model_bytes,
             "member_bytes": member_bytes}
    try:
        for m, engine in engines.items():
            src = ShardMemberSource(lambda fs, v=None, _e=engine: _e, member=m,
                                    fleet_size=FLEET_SIZE)
            src.commit(*src.stage(FLEET_SIZE))
            server = ScoringServer(ScoringService(src, max_batch=SERVE_MAX_BATCH), port=0).start()
            servers.append(server)
            write_announce(announce, {"member": m, "fleet_size": FLEET_SIZE, "epoch": 0,
                                      "url": f"http://127.0.0.1:{server.port}",
                                      "version": engine.version, "ready": True})
        router = FleetRouter(announce, lookups, task=task, link=link, member_timeout_s=10.0,
                             cooldown_s=60.0, backoff_s=0.01)
        router.refresh()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        worst, lat = 0.0, []
        for c in range(FLEET_CALLS):
            rows = all_rows[bounds[c]:bounds[c + 1]]
            t_call = time.perf_counter()
            got = router.score_rows(rows)
            lat.append(time.perf_counter() - t_call)
            worst = max(worst, float(np.max(np.abs(got - want[bounds[c]:bounds[c + 1]]))))
        calls_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        again = router.score_rows(kill_rows)
        twice = bool(np.array_equal(again, router.score_rows(kill_rows)))
        req = urllib.request.Request(
            router.view.endpoints[0] + "/v1/margins", headers={"Content-Type": "application/json"},
            data=json.dumps({"rows": kill_rows[:2], "fleet_size": FLEET_SIZE,
                             "version": "v-00000002"}).encode())
        pinned = None
        try:
            urllib.request.urlopen(req, timeout=10)
        except urllib.error.HTTPError as e:
            pinned = e.code
        servers[1].stop()  # member 1 gone
        owner = _row_owner(lookups, kill_rows, FLEET_SIZE)
        lost = owner == 1
        d0 = telemetry.counter("serving.degraded_scores").value
        got = router.score_rows(kill_rows).astype(np.float64)
        shed = int(telemetry.counter("serving.degraded_scores").value - d0)
        lost_err = float(np.max(np.abs(got[lost] - fe_only[lost]))) if lost.any() else 0.0
        kept_err = float(np.max(np.abs(got[~lost] - want[:SERVE_MAX_BATCH][~lost])))
    finally:
        if router is not None:
            router.close()
        for server in servers:
            server.stop()
        servers.clear()  # the services hold the member engines
    stats["in_process"] = {
        "calls": FLEET_CALLS, "rows": int(bounds[-1]), "calls_s": calls_s,
        "p50_ms": _percentile_ms(lat, 50), "p99_ms": _percentile_ms(lat, 99),
        "max_abs_err": worst, "bit_identical_repeat": twice, "pinned_other_status": pinned,
        "kill_rows": len(kill_rows), "lost_rows": int(lost.sum()), "degraded_counted": shed,
        "lost_vs_fe_only": lost_err, "kept_err": kept_err,
        "csr_margins": launches.get("csr_margins", 0)}
    print(f"path 15c (a): {json.dumps(stats['in_process'])} card={card}", flush=True)
    if not worst <= SERVE_ATOL:
        bad.append(f"routed scores differ from the single engine by {worst}")
    if not twice:
        bad.append("two routed calls of the same rows differ")
    if pinned != 409:
        bad.append(f"a margin call pinned to v-00000002 answered {pinned}, not 409")
    if shed != int(lost.sum()) or not lost.any():
        bad.append(f"degraded rows {shed} for {int(lost.sum())} rows member 1 owns")
    if not (lost_err <= SERVE_ATOL and kept_err <= SERVE_ATOL):
        bad.append(f"after the stop: lost rows vs FE-only {lost_err}, kept rows {kept_err}")
    if launches.get("csr_margins", 0) == 0:
        bad.append("csr_margins not launched by the members")
    del engines, full
    torch.cuda.empty_cache()

    # (b) the subprocess fleet on the card
    spec = serving_fleet.ServingFleetSpec(
        workdir=os.path.join(work, "fleet"), model_dir=vdir, fleet_size=FLEET_SIZE,
        max_batch=SERVE_MAX_BATCH, device="cuda",
        hbm_budget_mb=(max(member_bytes) + stats["full_bytes"]) / 2 / 2**20,
        heartbeat_deadline_s=3.0, warm_timeout_s=240.0, timeout_s=420.0,
        member_timeout_s=3.0, rng_seed=seed + 154, check_rows=tuple(kill_rows),
        **FLEET_TRAFFIC)
    os.makedirs(spec.announce_dir(), exist_ok=True)
    os.makedirs(spec.fleet_dir(), exist_ok=True)
    lone = serving_fleet._launch_serving_member(spec, 0, 1, 99)
    t0 = time.perf_counter()
    try:
        run = serving_fleet.run_serving_fleet(spec)
        lone_rc = lone.proc.wait(timeout=240)
    finally:
        if lone.proc.poll() is None:
            lone.proc.kill()
            lone.proc.wait()
    run_s = time.perf_counter() - t0
    with open(lone.err_path) as fh:
        lone_refused = lone_rc != 0 and "ShardBudgetError" in fh.read()
    samples = run.pop("samples")
    kill = run.get("kill", {})
    t_rec = kill.get("t_kill", 0.0) + kill.get("recovery_s", float("inf"))
    in_kill = sum(s[3] for s in samples if kill.get("t_kill", 0.0) <= s[0] <= t_rec)
    after = sum(s[3] for s in samples if s[0] > t_rec)
    resizes = [ev["resize"] for ev in run["events"] if "resize" in ev]
    # kill_rows routed at every settled view, held against the single engine
    checked = [{"at": c["at"], "epoch": c["epoch"], "fleet_size": c["fleet_size"],
                "max_abs_err": float(np.max(np.abs(np.asarray(c["scores"])
                                                   - want[:SERVE_MAX_BATCH])))}
               for c in run["checks"]]
    stats["subprocess"] = {
        "run_s": run_s, "budget_mb": spec.hbm_budget_mb, "lone_rc": lone_rc,
        "lone_refused": lone_refused, "calls": len(samples), "failures": run["failures"][:5],
        "routed_rows": run["routed_rows"], "degraded_scores": run["degraded_scores"],
        "degraded_in_kill_window": in_kill, "degraded_after_recovery": after,
        "member_failures": run["member_failures"], "kill": kill,
        "resizes": resizes, "checks": checked, "epoch": run["epoch"],
        "fleet_size": run["fleet_size"],
        "quiet_latency": run["quiet_latency"], "members": run["members"]}
    print(f"path 15c (b): {json.dumps(stats['subprocess'])} card={card}", flush=True)
    if not lone_refused:
        bad.append(f"a 1-member fleet under the budget was not refused (rc {lone_rc})")
    if run["failures"]:
        bad.append(f"{len(run['failures'])} failed router calls: {run['failures'][:3]}")
    if not (in_kill > 0 and after == 0):
        bad.append(f"degraded rows {in_kill} in the kill window, {after} after the recovery")
    if [(r["from"], r["to"]) for r in resizes] != [(FLEET_SIZE, 2 * FLEET_SIZE),
                                                   (2 * FLEET_SIZE, FLEET_SIZE)]:
        bad.append(f"resizes {resizes}")
    if (run["epoch"], run["fleet_size"]) != (2, FLEET_SIZE):
        bad.append(f"ended at epoch {run['epoch']}, size {run['fleet_size']}")
    sizes_checked = [c["fleet_size"] for c in checked]
    if sizes_checked != [FLEET_SIZE, FLEET_SIZE, 2 * FLEET_SIZE, FLEET_SIZE]:
        bad.append(f"routed checks at fleet sizes {sizes_checked}")
    if not all(c["max_abs_err"] <= SERVE_ATOL for c in checked):
        bad.append(f"routed checks differ from the single engine: {checked}")
    for mem in run["members"]:
        # the device each member reports, in its banner and its drain line
        said = [(mem.get(k) or {}).get("device") for k in ("banner", "drained")]
        if mem["killed"]:
            said = said[:1]
        if not all(str(d).startswith("cuda") for d in said):
            bad.append(f"member {mem['member']} (epoch {mem['epoch']}) reports devices {said}")
        if mem["rc"] != 75 and not mem["killed"]:
            bad.append(f"member {mem['member']} (epoch {mem['epoch']}) exited {mem['rc']}")
    if sum(mem["killed"] for mem in run["members"]) != 1:
        bad.append("the killed member is not accounted for")
    stats["path_s"] = time.perf_counter() - t_path
    print(f"path 15c: path_s={stats['path_s']:.4f} launches={json.dumps(launches)} "
          f"card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 15c: bad result: {bad}")
    return launches, stats


def make_freshness_problem(seed: int):
    """bench_freshness.py:118-176's data, the same draws in the same order:
    config #4's GLMix rows (1M rows, 100K users, a 10K-feature fixed-effect
    shard of 20 nonzeros a row, 10 dense per-user features), labels from a
    planted model, the last 50,000 rows given to 5% of the users (the delta),
    and 50,000 validation rows. Returns the base, combined, delta and
    validation datasets on the card."""
    from photon_ml_tpu_torch.game import FeatureShard, build_game_dataset

    rng = np.random.default_rng(seed)
    nnz = N_ROWS * NNZ_PER_ROW
    fe_rows = np.repeat(np.arange(N_ROWS, dtype=np.int64), NNZ_PER_ROW)
    fe_cols = rng.integers(0, N_FEATURES, size=nnz)
    fe_vals = rng.normal(size=nnz)
    users = rng.integers(0, GAME_USERS, size=N_ROWS)
    Xu = rng.normal(size=(N_ROWS, GAME_RE_FEATURES))
    w_true = rng.normal(size=N_FEATURES) * 0.5
    wu_true = rng.normal(size=(GAME_USERS, GAME_RE_FEATURES)) * 0.5
    margins = np.bincount(fe_rows, weights=fe_vals * w_true[fe_cols], minlength=N_ROWS)
    margins += np.einsum("ij,ij->i", Xu, wu_true[users])
    y = (rng.random(N_ROWS) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    touched = rng.choice(GAME_USERS, size=max(int(GAME_USERS * FRESH_DELTA_FRACTION), 1),
                         replace=False)
    n_delta = N_ROWS // 20
    delta_lo = N_ROWS - n_delta
    users = users.copy()
    users[delta_lo:] = touched[rng.integers(0, len(touched), n_delta)]

    def build(vals, rows, cols, us, xu, labels):
        ru_rows, ru_cols = np.nonzero(xu)
        return build_game_dataset(labels, {
            "global": FeatureShard.from_coo(vals, rows, cols, N_FEATURES),
            "user": FeatureShard.from_coo(xu[ru_rows, ru_cols], ru_rows, ru_cols,
                                          GAME_RE_FEATURES)}, id_columns={"userId": us})

    def rows_of(lo, hi):
        a, b = lo * NNZ_PER_ROW, hi * NNZ_PER_ROW
        return build(fe_vals[a:b], fe_rows[a:b] - lo, fe_cols[a:b], users[lo:hi], Xu[lo:hi],
                     y[lo:hi])

    base, comb, delta = rows_of(0, delta_lo), rows_of(0, N_ROWS), rows_of(delta_lo, N_ROWS)
    nv = max(N_ROWS // 20, 1000)
    v_rows = np.repeat(np.arange(nv, dtype=np.int64), NNZ_PER_ROW)
    v_cols = rng.integers(0, N_FEATURES, size=nv * NNZ_PER_ROW)
    v_vals = rng.normal(size=nv * NNZ_PER_ROW)
    uv = rng.integers(0, GAME_USERS, nv)
    Xv = rng.normal(size=(nv, GAME_RE_FEATURES))
    mv = np.bincount(v_rows, weights=v_vals * w_true[v_cols], minlength=nv)
    mv += np.einsum("ij,ij->i", Xv, wu_true[uv])
    yv = (rng.random(nv) < 1.0 / (1.0 + np.exp(-mv))).astype(np.float64)
    return base, comb, delta, build(v_vals, v_rows, v_cols, uv, Xv, yv)


def freshness_config():
    """bench_freshness.py:178-196: LBFGS 20 for the fixed effect, NEWTON for
    the per-user effect, both at tolerance 1e-7 and L2 1, 2 coordinate-descent
    iterations, evaluated by auc."""
    import dataclasses

    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.optim.factory import OptimizerType

    opt = dataclasses.replace(solver_config("lbfgs", 20), tolerance=1e-7,
                              regularization_weight=1.0)
    re_opt = dataclasses.replace(opt, optimizer_type=OptimizerType.NEWTON)
    return GameConfig(task="logistic", num_iterations=GAME_CD_ITERATIONS, evaluators=["auc"],
                      coordinates={
                          "fixed": FixedEffectConfig(shard_name="global", optimizer=opt),
                          "perUser": RandomEffectConfig(shard_name="user", id_name="userId",
                                                        optimizer=re_opt)})


def entity_table(re_model, vocab, num_global: int):
    """A random effect's coefficients by entity value and global feature id,
    on the card: ``(table [len(vocab), num_global], present [len(vocab)])``,
    row e the entity ``vocab[e]`` (zeros where it has no model); the padding
    slots (the sentinel id num_global) are left out."""
    import torch

    from photon_ml_tpu_torch.game.models import map_vocab_codes

    dev = re_model.buckets[0].coefficients.device
    table = torch.zeros((len(vocab), num_global + 1), dtype=torch.float32, device=dev)
    present = torch.zeros(len(vocab), dtype=torch.bool, device=dev)
    for bm in re_model.buckets:
        codes = map_vocab_codes(np.asarray(vocab), np.asarray(re_model.vocab)[bm.entity_codes])
        if (codes < 0).any():
            raise RuntimeError("entity_table: an entity of the model is not in the vocabulary")
        rows = torch.from_numpy(codes).to(dev)
        table[rows.unsqueeze(1).expand_as(bm.projection), bm.projection] = bm.coefficients
        present[rows] = True
    return table[:, :num_global], present


def freshness_checks(label: str, base_model, res, comb, scan) -> tuple[dict, list, object]:
    """The refresh against its base on config #4's width: every untouched
    user's row bit for bit the base's, every touched user's row changed,
    ``lanes_solved`` twice (two CD iterations) the touched-or-new users and
    ``lanes_skipped`` twice the rest. Returns the numbers, the failures and
    the refreshed table (for path 16b)."""
    import torch

    vocab = comb.id_columns["userId"].vocab
    tb, pb = entity_table(base_model.models["perUser"], vocab, GAME_RE_FEATURES)
    ti, pi = entity_table(res.model.models["perUser"], vocab, GAME_RE_FEATURES)
    touched = torch.from_numpy(scan.for_id("userId").touched_mask(vocab)).to(tb.device)
    solved = (touched | ~pb) & pi
    untouched = pi & pb & ~touched
    same = (tb.view(torch.int32) == ti.view(torch.int32)).all(dim=1)
    n_untouched = int(untouched.sum())
    n_kept = int((same & untouched).sum())
    n_changed = int((~same & touched & pb).sum())
    n_touched_base = int((touched & pb).sum())
    want_solved = 2 * int(solved.sum())
    want_skipped = 2 * int(pi.sum()) - want_solved
    out = {"untouched_users": n_untouched, "untouched_bit_identical": n_kept,
           "touched_users_in_base": n_touched_base, "touched_users_changed": n_changed,
           "lanes_solved_expected": want_solved, "lanes_skipped_expected": want_skipped}
    bad = []
    if n_kept != n_untouched:
        bad.append(f"{n_untouched - n_kept} untouched users' rows differ from the base's")
    if n_changed != n_touched_base:
        bad.append(f"{n_touched_base - n_changed} touched users kept their base rows")
    if (res.lanes_solved, res.lanes_skipped) != (want_solved, want_skipped):
        bad.append(f"lanes solved/skipped {res.lanes_solved}/{res.lanes_skipped}, expected "
                   f"{want_solved}/{want_skipped}")
    return out, [f"{label}: {b}" for b in bad], (ti, solved)


def run_freshness_path(seed: int, card: str, work: str) -> tuple[dict, dict, dict]:
    """Path 16: bench_freshness.py's time-to-fresh model at config #4's full
    width on the port. The base fit over the first 950,000 rows checkpoints
    every step (untimed); the full retrain over the combined million rows is
    timed; then ``load_warm_start`` + ``scan_delta`` + ``fit_incremental``
    are timed together (``time_to_fresh_s``) with the launch counts zeroed
    just before; then three ``publish_incremental`` calls, each followed by a
    ``ModelRegistry.refresh`` hot swap (the staleness samples). Fails unless
    every untouched user's row is the base's bit for bit, every touched
    user's row changed, the validation AUC is within 0.02 of the retrain's,
    the lane counts are twice the touched-or-new users and twice the rest,
    the fixed-effect refresh launched ``csr_margins`` and ``csc_scatter``,
    and each publish swapped. Returns, for path 16b, the config, the
    combined data, the checkpoint, the scan and the refreshed table."""
    import torch

    from photon_ml_tpu_torch import kernels, telemetry
    from photon_ml_tpu_torch.game import CheckpointSpec, GameEstimator
    from photon_ml_tpu_torch.game.coordinate_descent import ValidationSpec, _evaluate
    from photon_ml_tpu_torch.incremental import (
        load_warm_start,
        publish_incremental,
        scan_delta,
    )
    from photon_ml_tpu_torch.serving.registry import ModelRegistry

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base_data, comb, delta, val = make_freshness_problem(seed)
    setup_s = time.perf_counter() - t0
    print(f"data: bench_freshness config #4 {N_ROWS} rows ({N_ROWS // 20} the delta's over "
          f"{int(GAME_USERS * FRESH_DELTA_FRACTION)} users), FE {N_FEATURES} x {NNZ_PER_ROW} "
          f"nnz/row, RE {GAME_RE_FEATURES} dense over {GAME_USERS} users, "
          f"{val.num_rows} validation rows, setup_s={setup_s:.2f}", flush=True)
    config = freshness_config()
    ckpt = os.path.join(work, "fresh-base-ckpt")
    t0 = time.perf_counter()
    base = GameEstimator(config).fit(base_data, checkpoint_spec=CheckpointSpec(
        directory=ckpt, resume=False))
    torch.cuda.synchronize()
    base_fit_s = time.perf_counter() - t0
    del base_data
    t0 = time.perf_counter()
    ref = GameEstimator(config).fit(comb)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    telemetry.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ws = load_warm_start(ckpt)
    scan = scan_delta(delta, {"userId": ws.model.models["perUser"].vocab})
    res = GameEstimator(config).fit_incremental(comb, ws, delta=scan)
    torch.cuda.synchronize()
    inc_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    counters = telemetry.snapshot()["counters"]
    peak = torch.cuda.max_memory_allocated()

    checks, bad, (table, solved) = freshness_checks("path 16", base.model, res, comb, scan)
    spec = ValidationSpec(data=val, evaluators=["auc"])
    auc_inc, auc_ref = _evaluate(res.model, spec)["auc"], _evaluate(ref.model, spec)["auc"]
    gap = abs(auc_inc - auc_ref)
    if not gap < FRESH_AUC_GAP:
        bad.append(f"path 16: incremental AUC {auc_inc} vs from scratch {auc_ref} (gap {gap})")
    missing = [k for k in ("csr_margins", "csc_scatter") if launches[k] == 0]
    if missing:
        bad.append(f"path 16: kernels not launched by the refresh: {missing}")

    registry_dir = os.path.join(work, "fresh-registry")
    index_maps = {"global": [f"g{i}" for i in range(N_FEATURES)],
                  "user": [f"u{i}" for i in range(GAME_RE_FEATURES)]}
    registry, samples, swaps = None, [], []
    try:
        for _ in range(FRESH_PUBLISHES):
            t_pub = time.perf_counter()
            publish_incremental(registry_dir, res.model, index_maps, res.lineage, delta=scan)
            if registry is None:
                registry = ModelRegistry(registry_dir, warm=False)
            swaps.append(registry.refresh())
            samples.append(inc_s + (time.perf_counter() - t_pub))
    finally:
        if registry is not None:
            registry.stop()
    if not all(swaps):
        bad.append(f"path 16: a publish did not hot-swap: {swaps}")
    cd = scan.for_id("userId")
    stats = {"card": card, "setup_s": setup_s, "base_fit_s": base_fit_s,
             "full_retrain_s": full_s, "time_to_fresh_s": inc_s,
             "fit_incremental_s": res.seconds, "full_over_fresh": full_s / inc_s,
             "lanes_solved": res.lanes_solved, "lanes_skipped": res.lanes_skipped,
             "bucket_solves": res.bucket_solves, "buckets_skipped": res.buckets_skipped,
             "new_entities": res.new_entities, "touched_fraction": cd.touched_fraction,
             "touched_entities": cd.touched_count, "delta_rows": scan.delta_rows,
             "auc_incremental": auc_inc, "auc_from_scratch": auc_ref, "auc_gap": gap,
             "host_syncs": counters.get("host_syncs", 0), "max_memory_allocated": peak,
             "staleness_samples_s": samples, "swaps": swaps, "launches": launches, **checks}
    print(f"path 16: full_retrain_s={full_s:.4f} time_to_fresh_s={inc_s:.4f} "
          f"full_over_fresh={full_s / inc_s:.4f} fit_incremental_s={res.seconds:.4f} "
          f"base_fit_s={base_fit_s:.4f} lanes_solved={res.lanes_solved} "
          f"lanes_skipped={res.lanes_skipped} bucket_solves={res.bucket_solves} "
          f"buckets_skipped={res.buckets_skipped} new_entities={res.new_entities} "
          f"touched_fraction={cd.touched_fraction:.6f} auc_incremental={auc_inc:.6f} "
          f"auc_from_scratch={auc_ref:.6f} auc_gap={gap:.3e} host_syncs="
          f"{stats['host_syncs']} max_memory_allocated={peak} staleness_samples_s="
          f"{[round(x, 4) for x in samples]} checks={json.dumps(checks)} "
          f"launches={json.dumps(launches)} card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 16: bad result: {bad}")
    keep = {"config": config, "comb": comb, "ckpt": ckpt, "scan": scan, "base": base.model,
            "table": table, "solved": solved, "counts": (res.lanes_solved, res.lanes_skipped,
                                                         res.bucket_solves,
                                                         res.buckets_skipped)}
    return launches, stats, keep


def run_mesh_freshness_path(card: str, keep: dict) -> tuple[dict, dict]:
    """Path 16b: path 16's refresh with the per-user effect over a ``model``
    axis of 4 (four cards when the machine has them, else cuda:0 repeated):
    the base restored onto the mesh, each owner solving its touched lanes of
    its own block. Fails unless every untouched row is the base's bit for
    bit, the solved rows are within rtol/atol 5e-3 of path 16's, the counts
    are path 16's, and the fixed effect launched its kernels."""
    import torch

    from photon_ml_tpu_torch import kernels
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.incremental import load_warm_start
    from photon_ml_tpu_torch.parallel import make_mesh

    devices, kind = mesh_devices(4)
    mesh = make_mesh({"model": 4}, devices)
    _sync(devices)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ws = load_warm_start(keep["ckpt"], mesh=mesh)
    res = GameEstimator(keep["config"]).fit_incremental(keep["comb"], ws, delta=keep["scan"],
                                                        mesh=mesh)
    _sync(devices)
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    checks, bad, (table, solved) = freshness_checks("path 16b", keep["base"], res, keep["comb"],
                                                    keep["scan"])
    ref = keep["table"]
    diff = (table[solved] - ref[solved]).abs()
    limit = MESH_GAME_TOL["atol"] + MESH_GAME_TOL["rtol"] * ref[solved].abs()
    worst = float(diff.max()) if diff.numel() else 0.0
    if not bool((diff <= limit).all()):
        bad.append(f"path 16b: solved rows differ from path 16's beyond {MESH_GAME_TOL} "
                   f"(largest {worst})")
    counts = (res.lanes_solved, res.lanes_skipped, res.bucket_solves, res.buckets_skipped)
    if counts != keep["counts"]:
        bad.append(f"path 16b: counts {counts} vs path 16's {keep['counts']}")
    missing = [k for k in ("csr_margins", "csc_scatter") if launches[k] == 0]
    if missing:
        bad.append(f"path 16b: kernels not launched: {missing}")
    stats = {"card": card, "devices": kind, "refresh_s": elapsed, "counts": counts,
             "solved_max_abs_diff": worst, "launches": launches, **checks}
    print(f"path 16b: model axis 4 ({kind}) refresh_s={elapsed:.4f} counts={counts} "
          f"solved_max_abs_diff_vs_path_16={worst:.3e} checks={json.dumps(checks)} "
          f"launches={json.dumps(launches)} card={card}", flush=True)
    if bad:
        raise RuntimeError(f"path 16b: bad result: {bad}")
    return launches, stats


def delta_users(rng) -> np.ndarray:
    """The users a delta touches (5% of them, sorted): the first draw of the
    delta's generator (or of a new one from the seed given)."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    return np.sort(rng.choice(GAME_USERS, size=int(GAME_USERS * FRESH_DELTA_FRACTION),
                              replace=False))


def write_delta_avro(seed: int, path: str, delta_seed: int | None = None) -> np.ndarray:
    """A 50,000-row delta of path 10's data: bench_game.py's generator with
    its planted model (drawn from ``seed`` as path 10's), the rows drawn from
    another seed (``delta_seed``, default ``seed + 1016``) over 5% of the
    users, written as TrainingExampleAvro with path 10's feature names and
    user vocabulary. Returns the users touched."""
    from photon_ml_tpu_torch.data.avro import write_training_examples_fast

    rng = np.random.default_rng(seed)
    rng.integers(0, N_FEATURES, size=N_ROWS * NNZ_PER_ROW)  # path 10's draws, in order
    rng.normal(size=N_ROWS * NNZ_PER_ROW)
    w_true = rng.normal(size=N_FEATURES) * 0.5
    rng.integers(0, GAME_USERS, size=N_ROWS)
    rng.normal(size=(N_ROWS, GAME_RE_FEATURES))
    wu_true = rng.normal(size=(GAME_USERS, GAME_RE_FEATURES)) * 0.5
    drng = np.random.default_rng(seed + 1016 if delta_seed is None else delta_seed)
    n = N_ROWS // 20
    touched = delta_users(drng)
    users = touched[drng.integers(0, len(touched), n)]
    cols = drng.integers(0, N_FEATURES, size=n * NNZ_PER_ROW)
    vals = drng.normal(size=n * NNZ_PER_ROW)
    Xu = drng.normal(size=(n, GAME_RE_FEATURES))
    margins = (vals * w_true[cols]).reshape(n, NNZ_PER_ROW).sum(axis=1)
    margins += np.einsum("ij,ij->i", Xu, wu_true[users])
    y = (drng.random(n) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float64)
    names = [f"f{j}" for j in range(N_FEATURES)] + [f"u{k}" for k in range(GAME_RE_FEATURES)]
    bags = {"global": (np.arange(n + 1, dtype=np.int64) * NNZ_PER_ROW, cols, vals),
            "user": (np.arange(n + 1, dtype=np.int64) * GAME_RE_FEATURES,
                     np.tile(np.arange(GAME_RE_FEATURES) + N_FEATURES, n), Xu.ravel())}
    write_training_examples_fast(path, y, bags, names,
                                 {"userId": (users, [str(u) for u in range(GAME_USERS)])})
    return touched


def run_refresh_cli_path(seed: int, card: str, work: str) -> tuple[dict, dict]:
    """Path 16c: ``cli refresh`` in a subprocess on path 10's Avro files and
    ``cli train`` output (its config and its step checkpoint): a 50,000-row
    delta over 5% of the users (``write_delta_avro``), published through the
    quality gate into a new registry, then the same delta again, which must
    be refused as stale with nothing published. Fails unless the first run
    published v-00000001 with the delta's digest in its lineage, solved
    twice the touched users' lanes, kept every untouched user's row of
    path 10's final model bit for bit, and the second run exited non-zero
    with ``StaleDeltaError``."""
    import subprocess

    import torch

    from photon_ml_tpu_torch.data.model_store import load_game_model
    from photon_ml_tpu_torch.game.models import map_vocab_codes
    from photon_ml_tpu_torch.incremental import delta_digest

    root = os.path.dirname(os.path.abspath(__file__))
    delta_dir = os.path.join(work, "delta16")
    os.makedirs(delta_dir)
    delta = os.path.join(delta_dir, "part-delta.avro")
    t0 = time.perf_counter()
    touched = write_delta_avro(seed, delta)
    write_s = time.perf_counter() - t0
    registry = os.path.join(work, "refresh-registry")
    argv = ["refresh", "--config", os.path.join(work, "train.json"), "--warm-start",
            os.path.join(work, "ckpt"), "--delta", delta, "--registry-dir", registry,
            "--output-dir", os.path.join(work, "refreshed")]
    summary, first_s = _run_cli_subprocess(argv, root, label="path 16c")
    fresh = summary["freshness"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.cli", *argv], cwd=root,
                          capture_output=True, text=True, timeout=600)
    stale_s = time.perf_counter() - t0
    bad = []
    versions = sorted(n for n in os.listdir(registry) if n.startswith("v-"))
    with open(os.path.join(registry, "v-00000001", "model-metadata.json")) as fh:
        lineage = json.load(fh)["extra"]["lineage"]
    # untouched users of path 10's final model, bit for bit in the refreshed one
    base = load_game_model(os.path.join(work, "model", "final")).models["per-user"]
    new = load_game_model(os.path.join(work, "refreshed", "final")).models["per-user"]
    vocab = np.asarray(new.vocab)
    tb, pb = entity_table(base, vocab, GAME_RE_FEATURES)
    tn, pn = entity_table(new, vocab, GAME_RE_FEATURES)
    mask = np.zeros(len(vocab), bool)
    codes = map_vocab_codes(vocab, np.asarray([str(u) for u in touched]))
    mask[codes[codes >= 0]] = True
    hit = torch.from_numpy(mask).to(tb.device)
    same = (tb.view(torch.int32) == tn.view(torch.int32)).all(dim=1)
    untouched = pb & pn & ~hit
    kept = int((same & untouched).sum())
    changed = int((~same & hit & pb).sum())
    checks = {"published": fresh.get("published_version", "").endswith("v-00000001"),
              "versions": versions == ["v-00000001"],
              "lineage_digest": lineage.get("delta_digest") == delta_digest([delta]),
              "gate": lineage.get("quality_gate", {}).get("decision") == "no_champion",
              "lanes": fresh["lanes_solved"] == 2 * int(len(touched)),
              "untouched_kept": kept == int(untouched.sum()),
              "touched_changed": changed == int((hit & pb).sum()),
              "stale_refused": proc.returncode != 0 and "StaleDeltaError" in proc.stderr}
    stats = {"card": card, "write_s": write_s, "refresh_s": first_s, "stale_run_s": stale_s,
             "time_to_fresh_s": fresh["time_to_fresh_s"], "lanes_solved": fresh["lanes_solved"],
             "lanes_skipped": fresh["lanes_skipped"], "bucket_solves": fresh["bucket_solves"],
             "buckets_skipped": fresh["buckets_skipped"], "new_entities": fresh["new_entities"],
             "touched": int(len(touched)), "untouched_users": int(untouched.sum()),
             "checks": checks}
    print(f"path 16c: write_s={write_s:.4f} refresh_s={first_s:.4f} (a subprocess) "
          f"time_to_fresh_s={fresh['time_to_fresh_s']} lanes_solved={fresh['lanes_solved']} "
          f"lanes_skipped={fresh['lanes_skipped']} bucket_solves={fresh['bucket_solves']} "
          f"buckets_skipped={fresh['buckets_skipped']} new_entities={fresh['new_entities']} "
          f"stale_run_s={stale_s:.4f} stale_rc={proc.returncode} checks={json.dumps(checks)} "
          f"card={card}", flush=True)
    if not all(checks.values()):
        bad.append(f"checks failed: {checks}; stale run stderr: {proc.stderr[-2000:]}")
    if bad:
        raise RuntimeError(f"path 16c: bad result: {bad}")
    return {}, stats


def _read_status(path: str) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _pipeline_cycles(log_path: str) -> list[dict]:
    """The cycle records a ``cli pipeline`` daemon logged (one JSON object a
    cycle, after ``pipeline cycle``)."""
    out = []
    with open(log_path, errors="replace") as fh:
        for line in fh:
            if " pipeline cycle {" in line:
                out.append(json.loads(line.split(" pipeline cycle ", 1)[1]))
    return out


def _model_bits(a, b) -> dict:
    """Where two GAME models of one config part: ``same`` when every tensor
    of ``_model_tensors`` is bit for bit equal, else the tensors that differ
    and the largest absolute difference."""
    import torch

    ta, tb = _model_tensors(a), _model_tensors(b)
    diff = {k: float((ta[k].float() - tb[k].float()).abs().max())
            if ta[k].shape == tb[k].shape else float("inf") for k in ta if k in tb}
    return {"same": sorted(ta) == sorted(tb) and all(torch.equal(ta[k], tb[k]) for k in ta),
            "differs": [k for k, d in diff.items() if d], "max_abs_diff": max(diff.values())}


#: path 19's daemon: ``cli pipeline`` through a runner that prints the kernel
#: launches of its process after the daemon's summary
_PIPELINE_RUNNER = (
    "import json, sys\n"
    "from photon_ml_tpu_torch import kernels\n"
    "from photon_ml_tpu_torch.cli.__main__ import main\n"
    "rc = main(['pipeline'] + sys.argv[1:])\n"
    "print(json.dumps({'launches': dict(kernels.LAUNCHES)}), flush=True)\n"
    "sys.exit(rc)\n")


def run_pipeline_cli_path(seed: int, card: str, work: str,
                          device: str = "cuda") -> tuple[dict, dict]:
    """Path 19: ``cli pipeline`` (the freshness conductor's daemon, a
    subprocess on the card) at config #4's width, on path 10's Avro files,
    ``train.json`` and step checkpoint ``ckpt`` and path 16c's delta.

    (a) a daemon armed to exit at ``pipeline.reconcile`` must exit 113 with
    ``ckpt``'s tree digest unchanged and nothing (no version, no ``.tmp-``
    debris) in its registry. (b) one daemon, ``--cycles 4 --interval-s 1
    --escalate-after-cycles 3``: cycle 1 publishes 16c's delta as
    v-00000001 (gate ``no_champion``), bit for bit 16c's refreshed model;
    cycle 2 idles; meanwhile the script writes a second shard (another seed,
    5% of the users) outside the delta directory, publishes a nearline
    version (4 events each for 256 users, half of them in that shard's
    touched set) and renames the shard in; cycle 3's incremental candidate
    is decided by the gate against v1 (published, or quarantined: either
    way its lineage's reconciliation names the nearline version, its touched
    rows are re-solved, not the nearline rows, and its untouched rows are
    the base's bit for bit); a third shard renamed in after cycle 3 lets
    cycle 4 escalate to a full retrain over 1,150,000 rows, decided by the
    gate against the champion. ``ckpt`` stays byte-identical, the daemon
    exits 0 and its status file shows the newest published version served
    and the counters."""
    import shutil
    import subprocess

    import torch

    from photon_ml_tpu_torch.data.model_store import (
        load_feature_index_maps,
        load_game_model,
        load_game_model_metadata,
    )
    from photon_ml_tpu_torch.incremental import load_warm_start
    from photon_ml_tpu_torch.serving.engine import ScoringEngine
    from photon_ml_tpu_torch.serving.nearline import NearlineUpdater
    from photon_ml_tpu_torch.tools import chaos

    root = os.path.dirname(os.path.abspath(__file__))
    t_path = time.perf_counter()
    cfg, ckpt = os.path.join(work, "train.json"), os.path.join(work, "ckpt")
    digest0 = chaos.tree_digest(ckpt)
    stats, bad = {"card": card}, []

    def daemon(tag: str, registry: str, *extra: str, plan: dict | None = None):
        wdir = os.path.join(work, f"pipeline-{tag}")
        os.makedirs(wdir, exist_ok=True)
        env = chaos.worker_env(plan)
        argv = chaos.pipeline_command(cfg, ckpt, delta_dir, registry,
                                      os.path.join(wdir, "work"), device, *extra)
        # the runner in place of -m: the same main(), then the launches
        argv = [sys.executable, "-c", _PIPELINE_RUNNER, *argv[4:]]
        out, err = os.path.join(wdir, "daemon.out"), os.path.join(wdir, "daemon.err")
        with open(out, "wb") as fo, open(err, "wb") as fe:
            proc = subprocess.Popen(argv, cwd=root, env=env, stdout=fo, stderr=fe)
        return proc, wdir, out, err

    delta_dir = os.path.join(work, "delta19")
    os.makedirs(delta_dir)
    shutil.copy(os.path.join(work, "delta16", "part-delta.avro"),
                os.path.join(delta_dir, "part-0001.avro"))

    # (a) a kill at pipeline.reconcile, after the cycle's reads
    reg_a = os.path.join(work, "pipeline-a-registry")
    t0 = time.perf_counter()
    proc, _wdir, _out, err_a = daemon("a", reg_a, "--cycles", "1", "--interval-s", "0",
                                      plan=chaos.exit_plan("pipeline.reconcile"))
    rc_a = proc.wait(timeout=600)
    stats["a"] = {"rc": rc_a, "seconds": time.perf_counter() - t0,
                  "ckpt_unchanged": chaos.tree_digest(ckpt) == digest0,
                  "registry": chaos.registry_debris(reg_a)}
    print(f"path 19 (a): rc={rc_a} seconds={stats['a']['seconds']:.4f} "
          f"ckpt_unchanged={stats['a']['ckpt_unchanged']} "
          f"registry={stats['a']['registry']['all']} card={card}", flush=True)
    if rc_a != chaos.EXIT_CODE:
        with open(err_a) as fh:
            bad.append(f"(a) exited {rc_a}, not 113: {fh.read()[-2000:]}")
    if not stats["a"]["ckpt_unchanged"]:
        bad.append("(a) the kill changed ckpt")
    if stats["a"]["registry"]["versions"] or stats["a"]["registry"]["tmp"]:
        bad.append(f"(a) the kill left {stats['a']['registry']['all']} in the registry")

    # (b) the supervised run; the shards of cycles 3 and 4 and the nearline
    # events are made while cycle 1 runs
    reg_b = os.path.join(work, "pipeline-b-registry")
    status = os.path.join(work, "pipeline-status.json")
    t_launch = time.perf_counter()
    proc, wdir, out_b, err_b = daemon("b", reg_b, "--cycles", "4", "--interval-s", "1",
                                      "--escalate-after-cycles", "3", "--status-file", status)
    try:
        outside = os.path.join(work, "delta19-staged")
        os.makedirs(outside)
        t0 = time.perf_counter()
        touched2 = write_delta_avro(seed, os.path.join(outside, "part-0002.avro"), seed + 1019)
        touched3 = write_delta_avro(seed, os.path.join(outside, "part-0003.avro"), seed + 1020)
        stats["shards_write_s"] = time.perf_counter() - t0
        touched1 = delta_users(seed + 1016)  # 16c's delta
        rng = np.random.default_rng(seed + 1900)
        others = np.setdiff1d(np.arange(GAME_USERS), np.union1d(np.union1d(touched1, touched2),
                                                                touched3))
        picked = np.concatenate([rng.choice(touched2, NEARLINE_USERS // 2, replace=False),
                                 rng.choice(others, NEARLINE_USERS // 2, replace=False)])
        events = [{"ids": {"userId": str(u)},
                   "features": {"global": [[int(c), float(v)] for c, v in zip(
                       rng.choice(N_FEATURES, NNZ_PER_ROW, replace=False),
                       rng.normal(size=NNZ_PER_ROW))],
                       "user": [[k, float(v)] for k, v in enumerate(
                           rng.normal(size=GAME_RE_FEATURES))]},
                   "label": float(rng.random() < 0.5), "offset": 0.0}
                  for u in picked.tolist() for _ in range(4)]

        def wait_for(pred, what: str, timeout_s: float = 300.0, poll_s: float = 0.02):
            deadline = time.perf_counter() + timeout_s
            while not pred():
                if proc.poll() is not None:
                    raise RuntimeError(f"path 19: the daemon exited {proc.returncode} while "
                                       f"waiting for {what}")
                if time.perf_counter() > deadline:
                    raise RuntimeError(f"path 19: no {what} within {timeout_s} s")
                time.sleep(poll_s)

        def logged(text: str) -> bool:
            with open(err_b, errors="replace") as fh:
                return text in fh.read()

        def generation() -> int:
            return int(_read_status(status).get("generation") or 0)

        wait_for(lambda: logged(f"pipeline daemon up on {device}"), "daemon start-up")
        stats["startup_s"] = time.perf_counter() - t_launch
        marks = stats["marks_s"] = {}

        def mark_at(name: str) -> None:
            marks[name] = time.perf_counter() - t_launch

        v1_dir = os.path.join(reg_b, "v-00000001")
        wait_for(lambda: os.path.isdir(v1_dir), "v-00000001")
        mark_at("v1_published")

        # the nearline engine on v1 and its 256 users' solve, beside the
        # daemon; published once v1 is served
        def nearline_solve():
            engine = ScoringEngine.load(v1_dir, device=device)
            updater = NearlineUpdater(engine, id_name="userId",
                                      config=re_optimizer("lbfgs", 20, 1e-7),
                                      publish_dir=reg_b,
                                      index_maps=load_feature_index_maps(v1_dir))
            accepted = updater.submit(events)
            flushed = updater.flush()
            mark_at("nearline_solved")
            return engine, updater, accepted, flushed

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as pool:
            solving = pool.submit(nearline_solve)
            wait_for(lambda: (_read_status(status).get("members", {}).get("0", {})
                              .get("pipeline", {}).get("served_version") == "v-00000001"),
                     "v-00000001 served")
            mark_at("v1_served")
            # with 1 s between cycles, cycle 3 starts ~2 s after v1 is
            # served: the shard goes in after cycle 2, and the nearline
            # version lands during cycle 3's reads, before its reconciliation
            wait_for(lambda: generation() >= 2, "cycle 2")
            mark_at("cycle2_done")
            os.rename(os.path.join(outside, "part-0002.avro"),
                      os.path.join(delta_dir, "part-0002.avro"))
            mark_at("shard2_in")
            engine, updater, accepted, flushed = solving.result()
        t0 = time.perf_counter()
        v2 = updater.publish()
        mark_at("nearline_published")
        stats["nearline"] = {"users": int(len(picked)), "events": accepted, "flush": flushed,
                             "publish_s": time.perf_counter() - t0,
                             "version": os.path.basename(v2 or ""),
                             "seq": int(engine.nearline_seq)}
        del engine, updater
        wait_for(lambda: generation() >= 3, "cycle 3", timeout_s=600)
        mark_at("cycle3_done")
        os.rename(os.path.join(outside, "part-0003.avro"),
                  os.path.join(delta_dir, "part-0003.avro"))
        mark_at("shard3_in")
        # cycle 3's candidate, published or quarantined: a refusal of the
        # same slot in cycle 4 would replace the quarantined evidence
        snap3 = None
        for name in ("v-00000003", "quarantined-v-00000003"):
            if os.path.isdir(os.path.join(reg_b, name)):
                snap3 = os.path.join(work, "pipeline-cycle3-candidate")
                shutil.copytree(os.path.join(reg_b, name), snap3)
                break
        rc_b = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stats["daemon_s"] = time.perf_counter() - t_launch
    with open(out_b) as fh:
        lines = fh.read().strip().splitlines()
    summary = json.loads(lines[-2]) if len(lines) >= 2 else {}
    launches = json.loads(lines[-1]).get("launches", {}) if lines else {}
    cycles = _pipeline_cycles(err_b)
    doc = _read_status(status)
    member = doc.get("members", {}).get("0", {}).get("pipeline", {})
    stats.update(rc=rc_b, summary=summary, launches=launches, cycles=cycles,
                 status={"outcome": doc.get("outcome"), "generation": doc.get("generation"),
                         "pipeline": member})
    for c in cycles:
        print(f"path 19 cycle {c['cycle']}: idle={c['idle']} "
              f"published={c.get('published_version')} escalated={c['escalated']} "
              f"cycle_s={c.get('cycle_s')} rows={c.get('rows')} "
              f"time_to_fresh_s={c.get('time_to_fresh_s')} "
              f"full_retrain_s={c.get('full_retrain_s')} lanes_solved={c.get('lanes_solved')} "
              f"lanes_skipped={c.get('lanes_skipped')} "
              f"staleness_p99_s={c.get('staleness_p99_s')} "
              f"gate={json.dumps(c.get('quality_gate'))} card={card}", flush=True)
    if rc_b != 0 or len(cycles) != 4:
        with open(err_b) as fh:
            raise RuntimeError(f"path 19: (b) exited {rc_b} after {len(cycles)} cycles: "
                               f"{fh.read()[-3000:]}")
    c1, c2, c3, c4 = cycles
    published = list(summary.get("published_versions") or [])

    def candidate(path: str) -> tuple[dict, dict]:
        """A cycle's candidate version, published or quarantined: its
        metadata and the gate's decision recorded with it."""
        m = load_game_model_metadata(path)
        return m, m.get("extra", {}).get("quality", {}).get("gate", {})

    for c in (c1, c3, c4):
        q = (c.get("quality_gate") or candidate(
            os.path.join(reg_b, c["published_version"]))[1]) if not c["idle"] else {}
        print(f"path 19 cycle {c['cycle']} gate: {q.get('decision')} "
              f"champion={q.get('champion_version')} reason={json.dumps(q.get('reason'))} "
              f"candidate_auc={(q.get('candidate') or {}).get('auc')} "
              f"champion_ci_low={(q.get('champion') or {}).get('auc_ci_low')}", flush=True)
    print(f"path 19 marks: {json.dumps(stats['marks_s'])}", flush=True)

    # cycle 1: 16c's refresh, bit for bit
    m1, g1 = candidate(v1_dir)
    v1 = load_game_model(v1_dir, device=device)
    ref16 = load_game_model(os.path.join(work, "refresh-registry", "v-00000001"),
                            device=device)
    parts = _model_bits(v1, ref16)
    stats["v1_vs_16c"] = parts
    print(f"path 19 v1 against 16c's refreshed model: {json.dumps(parts)}", flush=True)
    if not parts["same"]:
        bad.append(f"v-00000001 is not 16c's refreshed model bit for bit: {parts}")
    if not (c1["published_version"] == "v-00000001" and not c1["escalated"]
            and g1.get("decision") == "no_champion"):
        bad.append(f"cycle 1: {c1}")
    if not (c2["idle"] and c2["published_version"] is None):
        bad.append(f"cycle 2 did not idle: {c2}")

    # cycle 3: decided by the gate against v1; its candidate's
    # reconciliation names the nearline version, its touched rows are
    # re-solved (not the nearline rows), the rest the base's
    if snap3 is None or c3["idle"] or c3["escalated"]:
        raise RuntimeError(f"path 19: cycle 3 left no incremental candidate: {c3}")
    m3, g3 = candidate(snap3)
    rec = m3.get("extra", {}).get("lineage", {}).get("reconciliation", {})
    want_rec = {"rule": "retrain-wins-touched", "nearline_version": "v-00000002",
                "nearline_seq": stats["nearline"]["seq"], "nearline_base_version": "v-00000001"}
    if (g3.get("decision") not in ("published", "quarantined")
            or g3.get("champion_version") != "v-00000001"
            or any(rec.get(k) != v for k, v in want_rec.items())):
        bad.append(f"cycle 3: {c3}; reconciliation {rec}")
    if stats["nearline"]["version"] != "v-00000002":
        bad.append(f"the nearline version is {stats['nearline']['version']}")
    base = load_warm_start(ckpt, device=device).model.models["per-user"]
    nl = load_game_model(os.path.join(reg_b, "v-00000002"), device=device).models["per-user"]
    v3 = load_game_model(snap3, device=device).models["per-user"]
    vocab = np.asarray(v3.vocab)
    tb, pb = entity_table(base, vocab, GAME_RE_FEATURES)
    tn, pn = entity_table(nl, vocab, GAME_RE_FEATURES)
    t3, p3 = entity_table(v3, vocab, GAME_RE_FEATURES)

    def mask(users):
        from photon_ml_tpu_torch.game.models import map_vocab_codes

        m = np.zeros(len(vocab), bool)
        codes = map_vocab_codes(vocab, np.asarray([str(u) for u in users]))
        m[codes[codes >= 0]] = True
        return torch.from_numpy(m).to(tb.device)

    hit = mask(np.union1d(touched1, touched2))
    near = mask(picked)
    same_base = (tb.view(torch.int32) == t3.view(torch.int32)).all(dim=1)
    same_near = (tn.view(torch.int32) == t3.view(torch.int32)).all(dim=1)
    moved_near = ~(tn.view(torch.int32) == tb.view(torch.int32)).all(dim=1)
    untouched = pb & p3 & ~hit
    stats["cycle3_rows"] = {
        "untouched": int(untouched.sum()), "untouched_kept": int((same_base & untouched).sum()),
        "nearline_touched": int((near & hit).sum()),
        "nearline_touched_not_nearline_rows": int((near & hit & ~same_near).sum()),
        "nearline_untouched_base_rows": int((near & ~hit & same_base).sum()),
        "nearline_rows_moved": int((near & moved_near).sum())}
    print(f"path 19 cycle 3 rows: {json.dumps(stats['cycle3_rows'])}", flush=True)
    r = stats["cycle3_rows"]
    if r["untouched_kept"] != r["untouched"]:
        bad.append(f"cycle 3: untouched rows changed: {r}")
    if (r["nearline_touched_not_nearline_rows"] != r["nearline_touched"]
            or not r["nearline_touched"] or not r["nearline_rows_moved"]
            or r["nearline_untouched_base_rows"] != NEARLINE_USERS // 2):
        bad.append(f"cycle 3: the nearline rows were not superseded as the rule says: {r}")

    # cycle 4: the escalated full retrain over base and the three shards,
    # decided by the gate against the newest published version with stats
    m4, g4 = candidate(os.path.join(
        reg_b, c4.get("published_version") or c4.get("quarantined_version") or "-"))
    champion4 = "v-00000003" if c3["published_version"] else "v-00000001"
    if not (c4["escalated"] and c4.get("rows") == N_ROWS + 3 * (N_ROWS // 20)
            and m4.get("extra", {}).get("pipeline", {}).get("escalated") is True
            and g4.get("decision") in ("published", "quarantined")
            and g4.get("champion_version") == champion4):
        bad.append(f"cycle 4: {c4}; metadata {m4.get('extra', {}).get('pipeline')} {g4}")
    if not str(summary.get("base_dir", "")).startswith(os.path.join(wdir, "work", "base-gen-")):
        bad.append(f"the escalation re-based onto {summary.get('base_dir')}")
    if chaos.tree_digest(ckpt) != digest0:
        bad.append("(b) changed ckpt")
    if not (doc.get("outcome") == "completed" and doc.get("generation") == 4
            and member.get("served_version") == published[-1]
            and member.get("publishes") == len(published)
            and member.get("escalations") == 1 and member.get("idle_cycles") == 1):
        bad.append(f"the status file: {stats['status']}")
    for name in ("csr_margins", "csc_scatter"):
        if not launches.get(name):
            bad.append(f"the daemon launched no {name}: {launches}")
    stats["path_s"] = time.perf_counter() - t_path
    print(f"path 19: startup_s={stats['startup_s']:.4f} daemon_s={stats['daemon_s']:.4f} "
          f"(a)_s={stats['a']['seconds']:.4f} shards_write_s={stats['shards_write_s']:.4f} "
          f"nearline={json.dumps(stats['nearline'])} "
          f"summary={json.dumps(summary)} status={json.dumps(stats['status'])} "
          f"launches={json.dumps(launches)} path_s={stats['path_s']:.4f} card={card}",
          flush=True)
    if bad:
        raise RuntimeError(f"path 19: bad result: {bad}")
    return {k: v for k, v in launches.items() if v}, stats


def run_chaos_phase(card: str, work: str, device: str = "cuda") -> dict:
    """The crash matrices on the card (``photon_ml_tpu_torch/tools/chaos.py``
    with the workers on cuda:0): the write-path matrix (4 rows, 4 at once,
    beside the uninterrupted fit) and the pipeline row
    ``pipeline.cycle_start`` (its small base trained in this process), the
    two side by side. Every row must pass."""
    from concurrent.futures import ThreadPoolExecutor

    from photon_ml_tpu_torch.tools import chaos

    t0 = time.perf_counter()
    # the pipeline row's small base is trained in this process, on its main
    # thread (``cli train``'s run installs signal handlers): a subprocess's start-up
    # saved; the daemons are subprocesses
    pipe_dir = os.path.join(work, "chaos-pipeline")
    fixture = chaos.pipeline_fixture(pipe_dir, device, in_process=True)
    with ThreadPoolExecutor(2) as pool:
        wp = pool.submit(chaos.run_matrix, os.path.join(work, "chaos-write-path"),
                         device=device, jobs=4)
        pl = pool.submit(chaos.run_pipeline_matrix, pipe_dir, points=["pipeline.cycle_start"],
                         device=device, fixture=fixture)
        reports = {"write_path": wp.result(), "pipeline": pl.result()}
    stats = {"card": card, "seconds": time.perf_counter() - t0}
    for kind, report in reports.items():
        rows = {p: {k: e.get(k) for k in ("armed_rc", "resume_rc", "exact", "resumed_from_chunk",
                                           "published_versions", "seconds", "error")}
                for p, e in report["results"].items()}
        stats[kind] = {"ok": report["ok"], "elapsed_s": report["elapsed_s"], "rows": rows,
                       "skipped": report["skipped"]}
        print(f"chaos {kind}: ok={report['ok']} elapsed_s={report['elapsed_s']} "
              f"rows={json.dumps(rows)} card={card}", flush=True)
    print(f"chaos phase: seconds={stats['seconds']:.4f} card={card}", flush=True)
    failed = [k for k, r in reports.items()
              if not r["ok"] or r["skipped"] or not r["results"]]
    if failed:
        raise RuntimeError(f"chaos phase: {failed} failed: "
                           f"{json.dumps({k: stats[k] for k in failed})[:3000]}")
    return stats


_T_START = time.perf_counter()


def mark(label: str, train: dict | None = None) -> None:
    """Print (and keep in ``train["elapsed_s"]``) the seconds since the
    script started, at the end of a phase or path."""
    t = time.perf_counter() - _T_START
    print(f"elapsed: {label} ends at {t:.2f} s", flush=True)
    if train is not None:
        train.setdefault("elapsed_s", {})[label] = t


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from photon_ml_tpu_torch.kernels import build
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.tools.probe_ell import card_line
    from photon_ml_tpu_torch.training import train_glm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    build.load_library(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    values, rows, cols, y = make_problem(args.seed, N_ROWS, N_FEATURES, NNZ_PER_ROW)
    batch = CSRBatch.from_coo(values, rows, cols, y, N_FEATURES)
    print(f"data: {N_ROWS}x{N_FEATURES}, nnz={batch.nnz}, "
          f"setup_s={time.perf_counter() - t0:.2f}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    w = torch.randn(N_FEATURES, generator=gen, device="cuda") * 0.1
    v = torch.randn(N_FEATURES, generator=gen, device="cuda")
    offsets = torch.randn(N_ROWS, generator=gen, device="cuda") * 0.1
    probe = batch.with_offsets(offsets)
    z = probe.margins(w)
    s = torch.sigmoid(z)
    d2_row = s * (1.0 - s)
    skewed = skewed_rows(args.seed)
    s_vals, s_rows, s_cols, s_n = skewed
    skewed_csr = CSRBatch.from_coo(s_vals, s_rows, s_cols, np.zeros(s_n), N_FEATURES)
    power_law = CSRBatch.from_coo(values, rows, power_law_columns(args.seed, len(values)), y,
                                  N_FEATURES)
    kernel_rows = check_kernels(probe, w, s - batch.labels, d2_row, skewed_csr, power_law)
    kernel_rows += check_fused_kernels(probe, w, v, d2_row, skewed_csr, power_law)
    kernel_rows.append(check_ell_kernel(values, rows, cols, y, w, offsets, skewed,
                                        kernel_rows[0]["library_ms"]))
    kernel_rows += check_lane_kernels(probe, w)
    mark("phase 3")
    del probe, z, s, d2_row, skewed_csr, power_law
    # Phase 3's temporaries (the column-major views among them) leave cached
    # blocks behind; release them, so that the later paths' peaks depend on
    # the paths' own allocations only, not on which blocks they happen to reuse.
    torch.cuda.empty_cache()

    check_small_parity(args.seed)
    check_small_re_parity(args.seed)
    by_path, train, prof = {}, {}, {}
    mark("phase 4", train)
    refs = {}
    by_path["5"], train["5"] = run_path(
        "5", batch, "logistic", [10.0, 1.0], solver_config("lbfgs", 20),
        required=("csr_margins", "csc_scatter"), compute_variances=True, min_auc=0.6, keep=refs)
    if args.profile:
        prof["5"] = profile_solve("5", lambda: train_glm(
            batch, "logistic", [1.0], solver_config("lbfgs", 10))[0].result.iterations)
    mark("path 5", train)
    by_path["14"], train["14"] = run_mesh_glm_path(
        "14", batch, "logistic", [10.0, 1.0], solver_config("lbfgs", 20), refs.pop("5"),
        required=("csr_margins", "csc_scatter"), compute_variances=True)
    torch.cuda.empty_cache()
    mark("path 14", train)
    swept = {}
    by_path["12"], train["12"] = run_sweep_path(batch, card, keep=swept)
    mark("path 12", train)
    by_path["17c"], train["17c"] = run_mesh_sweep_path(batch, *swept.pop("12"), card)
    mark("path 17c", train)
    by_path["12c"], train["12c"] = run_bootstrap_path(args.seed, batch, card)
    mark("path 12c", train)
    del batch
    torch.cuda.empty_cache()

    run_suite_paths(args.seed, args.profile, by_path, train, prof)
    mark("paths 5b-5e", train)

    # paths 8 and 10 share this directory (path 8's LIBSVM files); it goes
    # when the run ends, whatever its outcome
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=build_dir)
    try:
        return _run_paths(args, card, kernel_rows, work, by_path, train, prof)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run_paths(args, card: str, kernel_rows: list, work: str, by_path: dict, train: dict,
               prof: dict) -> int:
    """Paths 8, 6, 14b, 9-9c, 11b and 17b, 15, 15b, 15c, 16, 16b, 10, 13, 13b, 14c, 18,
    12d, 16c, 19, the chaos phase, 12b, 11 with 17a, and 7,
    then the ``kernels`` line and the result line; ``work`` holds path 8's
    files for paths 10 and 12d, path 10's for 12d and 16c, and path 16's
    checkpoint for 16b."""
    import torch

    from photon_ml_tpu_torch.tools.probe_ell import card_line

    by_path["8"], train["8"], glm_ref = run_data_plane_path(args.seed, card, work)
    torch.cuda.empty_cache()
    mark("path 8", train)

    by_path["6"], train["6"], game_prof, gds, game_ref = run_game_path(args.seed, args.profile)
    if game_prof is not None:
        prof["6"] = game_prof
    mark("path 6", train)
    by_path["14b"], train["14b"] = run_mesh_game_path(gds, *game_ref, train["6"], by_path["6"],
                                                      work)
    models = {"6": game_ref[1]}  # path 15's version 1
    del game_ref
    torch.cuda.empty_cache()
    mark("path 14b", train)
    t0 = time.perf_counter()
    re_launches, train["9"], re_prof = run_re_path(gds, args.seed, args.profile,
                                                   train["6"]["fe_only_auc"], card, keep=models)
    train["9"]["paths_s"] = time.perf_counter() - t0
    print(f"paths 9-9c: {train['9']['paths_s']:.2f} s", flush=True)
    mark("paths 9-9c, 11b", train)
    by_path.update(re_launches)
    if re_prof is not None:
        prof["9"] = re_prof
    torch.cuda.empty_cache()
    by_path["15"], train["15"], serve_prof, (registry, probe_rows) = run_serving_path(
        gds, models["6"], models["9"], args.seed, card, work, args.profile)
    if serve_prof is not None:
        prof["15"] = serve_prof
    mark("path 15", train)
    by_path["15b"], train["15b"] = run_mesh_serving_path(registry, probe_rows, card)
    del models, registry, probe_rows
    torch.cuda.empty_cache()
    mark("path 15b", train)
    probes = {"before 15c": host_probe("before path 15c")}
    by_path["15c"], train["15c"] = run_fleet_path(gds, os.path.join(work, "registry"),
                                                  args.seed, card, work)
    del gds
    torch.cuda.empty_cache()
    mark("path 15c", train)
    probes["after 15c"] = host_probe("after path 15c")
    train["15c"]["probes"] = probes
    if probes["after 15c"]["children"]:
        raise RuntimeError(f"path 15c left processes running: "
                           f"{probes['after 15c']['children']}")
    by_path["16"], train["16"], fresh = run_freshness_path(args.seed, card, work)
    mark("path 16", train)
    by_path["16b"], train["16b"] = run_mesh_freshness_path(card, fresh)
    del fresh
    torch.cuda.empty_cache()
    mark("path 16b", train)
    t0 = time.perf_counter()
    by_path["10"], train["10"], handover = run_cli_path(args.seed, card, work, train["6"],
                                                        glm_ref)
    train["10"]["path_s"] = time.perf_counter() - t0
    print(f"path 10: {train['10']['path_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    mark("path 10", train)
    t0 = time.perf_counter()
    by_path["13"], train["13"] = run_ingest_path(card, work, handover, train["10"])
    train["13"]["path_s"] = time.perf_counter() - t0
    print(f"path 13: {train['13']['path_s']:.2f} s", flush=True)
    del handover
    torch.cuda.empty_cache()
    mark("path 13", train)
    t0 = time.perf_counter()
    scale_ref = {}
    by_path["13b"], train["13b"], scale_prof = run_scale_path(args.seed, card, work,
                                                              args.profile, keep=scale_ref)
    train["13b"]["path_s"] = time.perf_counter() - t0
    if scale_prof is not None:
        prof["13b"] = scale_prof
    print(f"path 13b: {train['13b']['path_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    mark("path 13b", train)
    by_path["14c"], train["14c"] = run_mesh_scale_path(args.seed, card,
                                                       scale_ref.pop("per_user_re"))
    torch.cuda.empty_cache()
    mark("path 14c", train)
    by_path["18"], train["18"] = run_training_fleet_path(args.seed, card, work)
    torch.cuda.empty_cache()
    mark("path 18", train)
    t0 = time.perf_counter()
    by_path["12d"], train["12d"] = run_sweep_cli_path(card, work, glm_ref)
    train["12d"]["path_s"] = time.perf_counter() - t0
    print(f"path 12d: {train['12d']['path_s']:.2f} s", flush=True)
    mark("path 12d", train)
    by_path["16c"], train["16c"] = run_refresh_cli_path(args.seed, card, work)
    mark("path 16c", train)
    torch.cuda.empty_cache()
    by_path["19"], train["19"] = run_pipeline_cli_path(args.seed, card, work)
    torch.cuda.empty_cache()
    mark("path 19", train)
    train["chaos"] = run_chaos_phase(card, work)
    mark("chaos phase", train)
    t0 = time.perf_counter()
    by_path["12b"], train["12b"] = run_sweep_game_path(args.seed, card)
    train["12b"]["path_s"] = time.perf_counter() - t0
    print(f"path 12b: {train['12b']['path_s']:.2f} s", flush=True)
    mark("path 12b", train)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    northstar = {}
    by_path["11"], train["11"] = run_northstar_path(args.seed, card, keep=northstar)
    by_path["17a"], train["17a"] = northstar.pop("17a")
    train["11"]["path_s"] = time.perf_counter() - t0
    print(f"path 11: {train['11']['path_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    mark("path 11", train)
    by_path["7"], train["7"] = run_probe_path(args.seed)
    mark("path 7", train)

    for row in kernel_rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()
                                   if c.get(row["name"])}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["name"] in train["9"]["largest_coo_bucket"]:
            row["re_largest_coo_bucket"] = train["9"]["largest_coo_bucket"][row["name"]]
        if row["name"] == "csr_margins":
            row["serving_request_batch"] = train["15"]["request_batch_kernel"]
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, "kernels": kernel_rows, "train": train,
                       "profile": prof}, fh, indent=1)

    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
