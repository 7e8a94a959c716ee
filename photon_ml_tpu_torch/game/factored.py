"""Factored random effects (the matrix-factorization coordinate), the random
projector, and the matrix-factorization scoring model.

Counterpart of ``photon_ml_tpu/game/factored.py`` (its one-device path).
Each entity's model is a latent vector c_e of K entries plus one latent
matrix A [K, d] shared by all entities; a row x of entity e scores
(A x) . c_e. ``update_model`` alternates ``mf_iterations`` times:

  1. the latent-space solves: each bucket's latent design X~ [E, R, K]
     (row r of entity e projected through A) goes to the lane solvers as a
     ``DenseBatch``, warm-started from the bucket's slice of the latent
     table;
  2. the latent matrix refit: with the c_e fixed, vec(A) is refit as one
     GLM over the Kronecker features: a nonzero (row i, column j, value v)
     of entity e becomes the K nonzeros (i, j*K + l, v * c_e[l]).

The Kronecker structure never changes, so it is built once on the host as a
``CSRBatch`` of ``num_rows`` rows and d*K columns (``refreshable``), and each
refit only refreshes its values (``CSRBatch.with_values``: the base values
times a gather of the latent table, the mirror gathered from them) and its
offsets; the refit is the margin-carrying LBFGS (or the configured
optimizer) on the margins and scatter kernels. Active rows carry their
bucket's label and weight (the active-data cap's rescale included), passive
rows weight 0. The buckets' padding nonzeros (value 0) are left out of the
structure: they would add nothing, and the reference's convention of
sending them to the last row would give that row millions of zeros to sum.

A bucket's latent design is computed as suits the card: for a dense bucket
one ``torch.bmm`` of its design [E, R, K_local] with A gathered through the
bucket's projection [E, K_local, K]; for a COO bucket K launches of the
margins kernel over its block-diagonal batch, one per row of A gathered into
[E, K_local], so the bucket is never densified. The reference's TPU layout
devices (transposed gathers, one-hot contractions, pre-permuted flat takes,
chunking) are not carried over.

With ``refit_projection=False`` the coordinate is the random projector: the
per-entity solves in a fixed Gaussian space, with no refit and no Kronecker
structure. Scores sum every row's terms in a fixed order
(``torch.segment_reduce``, and each active row written to its own place), so
two scorings agree bit for bit. The reference's mesh branches are not
ported (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.projection import (
    ProjectionMatrix,
    build_gaussian_projection_matrix,
)
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.game.models import map_vocab_codes
from photon_ml_tpu_torch.game.random_effect_data import (
    DenseBucket,
    RandomEffectDataset,
    _with_residual,
)
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    build_objective,
    dispatch_solve,
    solve,
)
from photon_ml_tpu_torch.optim.trackers import (
    FactoredRandomEffectOptimizationTracker,
    FixedEffectOptimizationTracker,
    RandomEffectOptimizationTracker,
)

Tensor = torch.Tensor


def _row_segments(rows: np.ndarray, device: torch.device) -> tuple[Tensor, Tensor]:
    """(first row of each run, run lengths) of a non-decreasing row array."""
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    lengths = np.diff(np.r_[starts, len(rows)])
    return (torch.from_numpy(rows[starts]).to(device),
            torch.from_numpy(lengths).to(device))


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectModel:
    """The latent table and the shared projection. ``latent`` [n_flat, K]
    holds the entities of every bucket in order; ``entity_flat`` maps a
    training entity code to its row of the table (-1: no latent vector)."""

    id_name: str
    shard_name: str
    projection: ProjectionMatrix  # A: [K, d]
    latent: Tensor  # f32[n_flat, K]
    entity_flat: np.ndarray  # host i64[num_entities]
    vocab: np.ndarray  # training id vocabulary

    @property
    def latent_dim(self) -> int:
        return self.latent.shape[1]

    def score(self, data: GameDataset) -> Tensor:
        """Scores for every row: sum over the row's nonzeros of
        v * (c_e . A[:, col]); an entity without a latent vector, or a
        feature past the training dimension, scores 0."""
        if data.id_columns.get(self.id_name) is None:
            raise KeyError(f"scoring data lacks id column '{self.id_name}'")
        shard = data.shard(self.shard_name)
        dev = data.device
        idc = data.id_columns[self.id_name]
        codes = map_vocab_codes(self.vocab, idc.vocab[idc.codes])
        flat_of_row = np.where(codes >= 0, self.entity_flat[np.maximum(codes, 0)], -1)
        sel = np.flatnonzero((shard.values != 0) & (flat_of_row[shard.rows] >= 0)
                             & (shard.cols < self.projection.original_dim))
        scores = torch.zeros(data.num_rows, dtype=torch.float32, device=dev)
        if not len(sel):
            return scores
        rows = shard.rows[sel]  # non-decreasing: the shard is sorted by row
        at, lengths = _row_segments(rows, dev)
        v = torch.from_numpy(shard.values[sel]).to(dev)
        c = self.latent.index_select(0, torch.from_numpy(flat_of_row[rows]).to(dev))
        a = self.projection.matrix.T.index_select(0, torch.from_numpy(shard.cols[sel]).to(dev))
        terms = (v * (c * a).sum(dim=1)).unsqueeze(1)
        scores[at] = torch.segment_reduce(terms, "sum", lengths=lengths)[:, 0]
        return scores

    def to_summary_string(self) -> str:
        n_models = int(np.sum(self.entity_flat >= 0))
        return (f"FactoredRandomEffectModel(id={self.id_name}, shard={self.shard_name}, "
                f"entities={n_models}/{len(self.vocab)}, latent_dim={self.latent_dim}, "
                f"original_dim={self.projection.original_dim})")

    def effective_coefficients(self, entity_value) -> Optional[Tensor]:
        """The original-space coefficients A^T c_e of one entity, or None for
        an entity without a latent vector."""
        code = map_vocab_codes(self.vocab, np.asarray([entity_value]))[0]
        if code < 0 or self.entity_flat[code] < 0:
            return None
        return self.projection.project_coefficients(self.latent[int(self.entity_flat[code])])


@dataclasses.dataclass(frozen=True)
class MatrixFactorizationModel:
    """Row and column latent factors: score = row_factors[row id] .
    col_factors[col id]; a row or column unseen in its vocabulary scores 0."""

    row_effect: str
    col_effect: str
    row_factors: Tensor  # f32[n_row_entities, K]
    col_factors: Tensor  # f32[n_col_entities, K]
    row_vocab: np.ndarray
    col_vocab: np.ndarray

    @property
    def num_latent_factors(self) -> int:
        return self.row_factors.shape[1]

    def score(self, data: GameDataset) -> Tensor:
        for eff in (self.row_effect, self.col_effect):
            if data.id_columns.get(eff) is None:
                raise KeyError(f"scoring data lacks id column '{eff}'")
        rc = data.id_columns[self.row_effect]
        cc = data.id_columns[self.col_effect]
        r_codes = map_vocab_codes(self.row_vocab, rc.vocab[rc.codes])
        c_codes = map_vocab_codes(self.col_vocab, cc.vocab[cc.codes])
        dev = self.row_factors.device
        ok = torch.from_numpy((r_codes >= 0) & (c_codes >= 0)).to(dev)
        rf = self.row_factors.index_select(0, torch.from_numpy(np.maximum(r_codes, 0)).to(dev))
        cf = self.col_factors.index_select(0, torch.from_numpy(np.maximum(c_codes, 0)).to(dev))
        return torch.where(ok, (rf * cf).sum(dim=1), 0.0)


@dataclasses.dataclass
class FactoredRandomEffectCoordinate:
    """The alternating latent-space solves and latent matrix refit.
    ``latent_dim`` is K, ``mf_iterations`` the alternation count,
    ``re_config``/``latent_config`` the per-entity and latent-matrix
    optimizers; ``refit_projection=False`` is the random projector, with
    ``projection_intercept_index`` passing the intercept through A."""

    name: str
    data: GameDataset
    re_data: RandomEffectDataset
    loss_name: str
    re_config: OptimizerConfig
    latent_config: OptimizerConfig
    latent_dim: int
    mf_iterations: int = 1
    seed: int = 0
    refit_projection: bool = True
    projection_intercept_index: Optional[int] = None

    def __post_init__(self):
        if self.latent_dim < 1:
            raise ValueError("latent_dim must be >= 1")
        if self.mf_iterations < 1:
            raise ValueError("mf_iterations must be >= 1")
        if self.projection_intercept_index is not None and self.refit_projection:
            raise ValueError(
                "projection_intercept_index requires refit_projection=False (the MF refit "
                "would overwrite the passthrough row; the reference's MF init uses "
                "isKeepingInterceptTerm=false)")
        self.re_config.validate(self.loss_name)
        self.latent_config.validate(self.loss_name)
        if self.re_config.box_constraints or self.latent_config.box_constraints:
            raise ValueError("box constraints are not supported in latent/projected spaces")
        dev = self.data.device
        dense = self.re_data.dense_buckets(dev)
        coo = self.re_data.coo_buckets(dev)
        self._buckets = tuple(d if d is not None else c for d, c in zip(dense, coo))
        self._proj = tuple(torch.from_numpy(b.projection.astype(np.int64)).to(dev)
                           for b in self.re_data.buckets)
        # rows of A, the intercept passthrough included
        self._proj_rows = self.latent_dim + (self.projection_intercept_index is not None)
        sizes = [b.num_entities for b in self.re_data.buckets]
        self._flat_offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self._n_flat = int(self._flat_offsets[-1])
        eb, ep = self.re_data.entity_bucket, self.re_data.entity_pos
        self._entity_flat = np.where(eb >= 0, self._flat_offsets[np.maximum(eb, 0)] + ep,
                                     -1).astype(np.int64)
        self._re_obj = build_objective(self.loss_name, self.re_config)
        self._re_l1 = self.re_config.regularization.l1_weight(
            self.re_config.regularization_weight)
        self.last_results: list = []
        self.last_tracker = None
        self.kron_nnz = 0
        if self.refit_projection:
            with telemetry.span("factored_kron_structure"):
                self._build_kron()

    def _build_kron(self) -> None:
        """The Kronecker structure, on the host once: every live nonzero of
        every bucket times the K latent columns, sorted by row; the labels,
        weights and base offsets of the active rows."""
        k = self.latent_dim
        d = self.re_data.num_global_features
        n = self.data.num_rows
        g_rows, g_cols, g_vals, g_ent = [], [], [], []
        lab, wgt, off = np.zeros(n), np.zeros(n), np.zeros(n)
        for b_idx, b in enumerate(self.re_data.buckets):
            live = b.values != 0  # padding nonzeros add nothing
            ent, slot = np.nonzero(live)
            g_rows.append(b.row_index[ent, b.rows[ent, slot]].astype(np.int64))
            g_cols.append(b.projection[ent, b.cols[ent, slot]].astype(np.int64))
            g_vals.append(b.values[ent, slot])
            g_ent.append(self._flat_offsets[b_idx] + ent)
            valid = b.row_index >= 0
            ri = b.row_index[valid]
            lab[ri], wgt[ri], off[ri] = b.labels[valid], b.weights[valid], b.offsets[valid]
        g_rows = np.concatenate(g_rows) if g_rows else np.zeros(0, np.int64)
        g_cols = np.concatenate(g_cols) if g_cols else np.zeros(0, np.int64)
        g_vals = np.concatenate(g_vals) if g_vals else np.zeros(0, np.float32)
        g_ent = np.concatenate(g_ent) if g_ent else np.zeros(0, np.int64)
        # one stable sort by row; entry (base, l) of the expansion sits at
        # base * k + l before it
        o = np.argsort(np.repeat(g_rows, k), kind="stable")
        base, lcol = o // k, o % k
        dev = self.data.device
        self._kron_base = torch.from_numpy(g_vals[base].astype(np.float32)).to(dev)
        self._kron_latent_idx = torch.from_numpy(g_ent[base] * k + lcol).to(dev)
        self._kron = CSRBatch.from_coo(
            np.zeros(len(o), np.float32), g_rows[base], g_cols[base] * k + lcol, lab, d * k,
            offsets=off, weights=wgt, device=dev, refreshable=True)
        self.kron_nnz = len(o)

    # -- model plumbing ------------------------------------------------------

    def initialize_model(self) -> FactoredRandomEffectModel:
        """Zero latent vectors and the Gaussian projection of ``seed``."""
        dev = self.data.device
        proj = build_gaussian_projection_matrix(
            self.latent_dim, self.re_data.num_global_features,
            intercept_index=self.projection_intercept_index, seed=self.seed, device=dev)
        return FactoredRandomEffectModel(
            id_name=self.re_data.id_name, shard_name=self.re_data.shard_name,
            projection=proj,
            latent=torch.zeros((self._n_flat, self._proj_rows), dtype=torch.float32,
                               device=dev),
            entity_flat=self._entity_flat,
            vocab=self.data.id_columns[self.re_data.id_name].vocab)

    def _latent_design(self, i: int, a_ext: Tensor) -> Tensor:
        """Bucket ``i``'s rows projected through A: X~ [E, R, K]."""
        b, proj = self._buckets[i], self._proj[i]
        n_ent, k_local = proj.shape
        if isinstance(b, DenseBucket):
            g = a_ext.T.index_select(0, proj.reshape(-1)).view(n_ent, k_local, -1)
            return torch.bmm(b.x, g)
        return torch.stack([b.block.dot_rows(row.index_select(0, proj.reshape(-1))
                                             .view(n_ent, k_local))
                            for row in a_ext], dim=-1)

    def _latent_batch(self, i: int, x: Tensor, residual: Optional[Tensor]) -> DenseBatch:
        b = self._buckets[i]
        rows = b if isinstance(b, DenseBucket) else b.block
        return DenseBatch(x=x, labels=rows.labels,
                          offsets=_with_residual(rows.offsets, b.row_index, residual),
                          weights=rows.weights)

    def _latent_re_step(self, latent: Tensor, a_ext: Tensor, residual: Optional[Tensor]):
        """One pass of per-entity solves in latent space over all buckets:
        ``(latent', per-bucket lane results)``."""
        parts, results = [], []
        for i in range(len(self._buckets)):
            lo, hi = int(self._flat_offsets[i]), int(self._flat_offsets[i + 1])
            batch = self._latent_batch(i, self._latent_design(i, a_ext), residual)
            res = dispatch_solve(glm_adapter(self._re_obj, batch), latent[lo:hi],
                                 self.re_config, self._re_l1, device=self.data.device)
            parts.append(res.w)
            results.append(res)
        return (torch.cat(parts, dim=0) if parts else latent), results

    def _latent_matrix_step(self, latent: Tensor, a: Tensor, residual: Optional[Tensor]):
        """Refit vec(A) as one GLM over the Kronecker structure with refreshed
        values: ``(A' [K, d], SolveResult)``."""
        vals = self._kron_base * latent.reshape(-1).index_select(0, self._kron_latent_idx)
        batch = self._kron.with_values(vals)
        if residual is not None:
            batch = batch.with_offsets(self._kron.offsets + residual)
        w0 = a.T.reshape(-1)  # vec layout: column j*K + l
        res = solve(self.loss_name, batch, self.latent_config, w0, device=self.data.device)
        return res.w.reshape(-1, self.latent_dim).T.contiguous(), res

    def update_model(self, model: FactoredRandomEffectModel,
                     residual_scores: Optional[Tensor]) -> FactoredRandomEffectModel:
        latent, a = model.latent, model.projection.matrix
        if not self.refit_projection:
            latent, re_results = self._latent_re_step(latent, model.projection.extended(),
                                                      residual_scores)
            self.last_results = re_results
            self.last_tracker = FactoredRandomEffectOptimizationTracker(
                steps=((RandomEffectOptimizationTracker.from_results(re_results), None),))
            return dataclasses.replace(model, latent=latent)
        raw_steps = []
        for _ in range(self.mf_iterations):
            latent, re_results = self._latent_re_step(
                latent, ProjectionMatrix(matrix=a).extended(), residual_scores)
            a, lat_res = self._latent_matrix_step(latent, a, residual_scores)
            raw_steps.append((re_results, lat_res))
        # the trackers' fetches come after the alternation, one per part
        self.last_results = [r for re_results, lat_res in raw_steps
                             for r in (*re_results, lat_res)]
        self.last_tracker = FactoredRandomEffectOptimizationTracker(steps=tuple(
            (RandomEffectOptimizationTracker.from_results(rr),
             FixedEffectOptimizationTracker.from_result(lr))
            for rr, lr in raw_steps))
        return dataclasses.replace(model, latent=latent, projection=ProjectionMatrix(matrix=a))

    def score(self, model: FactoredRandomEffectModel) -> Tensor:
        """Training-data scores: the buckets' latent designs for active rows,
        the model's own scoring for passive rows."""
        a_ext = model.projection.extended()
        scores = torch.zeros(self.data.num_rows, dtype=torch.float32, device=self.data.device)
        for i, b in enumerate(self._buckets):
            lo, hi = int(self._flat_offsets[i]), int(self._flat_offsets[i + 1])
            margins = torch.einsum("erk,ek->er", self._latent_design(i, a_ext),
                                   model.latent[lo:hi])
            # each active row sits in exactly one bucket slot: exact in any order
            scores.index_put_((b.slot_rows,), margins.reshape(-1).index_select(0, b.slots))
        if len(self.re_data.passive_rows):
            passive = torch.from_numpy(self.re_data.passive_rows).to(self.data.device)
            scores[passive] = model.score(self.data).index_select(0, passive)
        return scores
