"""Designs shared by G lanes: the written-out ``vmap`` of a sweep or a
bootstrap.

The reference runs G regularization configs, or B weight resamples, as
``jax.vmap(glm_adapter(obj, batch))`` over one design
(``photon_ml_tpu/sweep/runner.py:91-173``,
``photon_ml_tpu/diagnostics/bootstrap.py:92-104``); Pallas's batching rule
then runs the margins and scatter kernels once per lane. Here the lane axis
is written out, and each class below is a batch of G problems over one
design, with the ``lane_adapter`` duck type (``optim/adapter.py``):
coefficients ``[L, K]``, per-row arrays ``[L, R]``, one value per lane.

- ``SharedDesign``: one ``CSRBatch`` shared by G lanes, each with its own
  offsets and weights (``[G, N]``, or one ``[N]`` for all). Its margins are
  one ``csr_margins_lanes`` launch and its scatters one
  ``csc_scatter_lanes`` launch (``kernels``), which read the design once per
  chunk of lanes; every lane is bit for bit the single-vector kernel on its
  vector. The fused ``value_grad``, ``hv`` and ``hv_at`` have no lane form:
  their work goes through the two lane kernels (a value and gradient is a
  margins launch, the per-row loss, and a scatter launch).
- ``DenseLanes``: a dense random-effect bucket ``x [E, R, K]`` shared by G
  configs or B resamples, as G*E lanes (lane g*E + e is entity e of config
  g). Its sweeps contract the design against ``[G, E, K]`` with batched
  GEMMs over the entities (cuBLAS on the card), as ``DenseBatch`` does.
- ``BlockDiagonalLanes``: a COO bucket's block-diagonal batch shared by G
  configs: the lane kernels over its CSR with ``W [G, E*K]``, whose 11.7M
  columns a lane at the widest take the margins kernel's global-gather route.

A lane's sums over its rows are ``[L, R].sum(-1)``, and its losses take
their position-independent form (``ops/losses.get_loss(lane_exact=True)``):
nothing a lane computes depends on the other lanes, so the lanes of a
gathered subset of entities are bit for bit the full run's. The NEWTON solver's
Hessians of a bucket come from ``weighted_gram``: the products
x_r x_r^T of each entity's rows, built once, contracted against each lane's
row curvature.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch import kernels
from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch, _no_shift
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.losses import get_loss

Tensor = torch.Tensor


def _per_lane_shift(shift):
    """A per-lane margin shift as the lane kernels take it: a contiguous
    ``[G]`` tensor, or a host number."""
    if isinstance(shift, Tensor):
        return shift.reshape(-1).to(torch.float32).contiguous()
    return float(shift)


def _fused_passes(batch, loss_name: str, z: Tensor):
    """(sum wgt*l(z), raw gradient, sum wgt*dz) per lane at the margins z."""
    l, dz = get_loss(loss_name, lane_exact=True).loss_and_dz(z, batch.labels)
    wdz = batch.weights * dz
    return (torch.sum(batch.weights * l, dim=-1), batch.scatter_features(wdz),
            torch.sum(wdz, dim=-1))


@dataclasses.dataclass(frozen=True)
class SharedDesign:
    """One ``CSRBatch`` shared by ``num_lanes`` lanes; ``lane_offsets`` and
    ``lane_weights`` are ``[G, N]`` or one ``[N]`` for every lane."""

    batch: CSRBatch
    num_lanes: int
    lane_offsets: Tensor
    lane_weights: Tensor
    lane_exact = True  # the losses' position-independent form (ops/losses.py)

    @staticmethod
    def of(batch: CSRBatch, num_lanes: int, offsets: Optional[Tensor] = None,
           weights: Optional[Tensor] = None) -> "SharedDesign":
        """``batch`` for ``num_lanes`` lanes, with per-lane ``offsets`` or
        ``weights`` (``[G, N]``) in place of the batch's own."""
        if not isinstance(batch, CSRBatch):
            raise TypeError(f"a shared design is a CSRBatch, got {type(batch).__name__}")
        n, g = batch.num_rows, int(num_lanes)
        if g < 1:
            raise ValueError(f"a shared design needs at least one lane, got {g}")

        def lanes(a, name):
            a = a.to(device=batch.device, dtype=torch.float32).contiguous()
            if a.shape not in ((n,), (g, n)):
                raise ValueError(f"{name} must be [{n}] or [{g}, {n}], got {tuple(a.shape)}")
            return a

        return SharedDesign(
            batch=batch, num_lanes=g,
            lane_offsets=lanes(batch.offsets if offsets is None else offsets, "offsets"),
            lane_weights=lanes(batch.weights if weights is None else weights, "weights"))

    @property
    def num_features(self) -> int:
        return self.batch.num_features

    @property
    def num_rows(self) -> int:
        return self.batch.num_rows

    @property
    def device(self) -> torch.device:
        return self.batch.device

    def _lanes(self, a: Tensor) -> Tensor:
        return a.expand(self.num_lanes, self.num_rows)

    @property
    def labels(self) -> Tensor:
        return self._lanes(self.batch.labels)

    @property
    def offsets(self) -> Tensor:
        return self._lanes(self.lane_offsets)

    @property
    def weights(self) -> Tensor:
        return self._lanes(self.lane_weights)

    def _w(self, w: Tensor) -> Tensor:
        if tuple(w.shape) != (self.num_lanes, self.num_features):
            raise ValueError(f"coefficients must be [{self.num_lanes}, {self.num_features}], "
                             f"got {tuple(w.shape)}")
        return w.contiguous()

    def _per_row(self, r: Tensor) -> Tensor:
        if tuple(r.shape) != (self.num_lanes, self.num_rows):
            raise ValueError(f"per-row values must be [{self.num_lanes}, {self.num_rows}], "
                             f"got {tuple(r.shape)}")
        return r.contiguous()

    # -- sweeps (the lane_adapter duck type) -----------------------------------

    def dot_rows(self, w: Tensor) -> Tensor:
        """x_i . w[g] -> [G, N] (lane margins kernel)."""
        return kernels.csr_margins_lanes(*self.batch._csr, self._w(w), self.lane_offsets, 0.0,
                                         False)

    def margins(self, w: Tensor, shift=0.0) -> Tensor:
        """x_i . w[g] + shift[g] + offsets[g, i] -> [G, N] (lane margins kernel)."""
        return kernels.csr_margins_lanes(*self.batch._csr, self._w(w), self.lane_offsets,
                                         _per_lane_shift(shift), True)

    def margins_pair(self, w, shift, p, p_shift) -> tuple[Tensor, Tensor]:
        """(margins(w, shift), dot_rows(p) + p_shift): two lane launches."""
        u = kernels.csr_margins_lanes(*self.batch._csr, self._w(p), self.lane_offsets,
                                      _per_lane_shift(p_shift), False)
        return self.margins(w, shift), u

    def scatter_features(self, per_row: Tensor) -> Tensor:
        """sum_i per_row[g, i] * x_i -> [G, F] (lane scatter kernel)."""
        return kernels.csc_scatter_lanes(*self.batch._csc, self._per_row(per_row), False,
                                         self.batch.tiles)

    def scatter_features_sq(self, per_row: Tensor) -> Tensor:
        """sum_i per_row[g, i] * x_i**2 -> [G, F] (lane scatter kernel, square)."""
        return kernels.csc_scatter_lanes(*self.batch._csc, self._per_row(per_row), True,
                                         self.batch.tiles)

    def fused_value_grad(self, w, shift, loss_name: str) -> tuple[Tensor, Tensor, Tensor]:
        """Per lane: (sum wgt*l(z), raw gradient, sum wgt*dz); two lane launches."""
        return _fused_passes(self, loss_name, self.margins(w, shift))

    def fused_hessian_vector(self, w, shift, v, v_shift, loss_name: str) -> tuple[Tensor, Tensor]:
        """Per lane: (raw Hv, sum of the row terms q), q = wgt*l''(z)*(x.v + v_shift)."""
        z, u = self.margins_pair(w, shift, v, v_shift)
        q = self.weights * get_loss(loss_name, lane_exact=True).d2z(z, self.labels) * u
        return self.scatter_features(q), torch.sum(q, dim=-1)

    def fused_hv_at(self, d2_row: Tensor, v: Tensor, v_shift) -> tuple[Tensor, Tensor]:
        """Per lane: (raw Hv with the row curvature d2 given, sum q), q = d2*(x.v + v_shift)."""
        u = kernels.csr_margins_lanes(*self.batch._csr, self._w(v), self.lane_offsets,
                                      _per_lane_shift(v_shift), False)
        q = d2_row * u
        return self.scatter_features(q), torch.sum(q, dim=-1)


def _lane_rows(a: Tensor, groups: int, n_ent: int, n_rows: int, device) -> Tensor:
    """Per-row values ``[E, R]`` shared by the groups or ``[G, E, R]`` as the
    lanes' ``[G*E, R]``."""
    a = a.to(device=device, dtype=torch.float32)
    if a.shape == (n_ent, n_rows):
        a = a.unsqueeze(0).expand(groups, n_ent, n_rows)
    if a.shape != (groups, n_ent, n_rows):
        raise ValueError(f"per-row values must be [{n_ent}, {n_rows}] or "
                         f"[{groups}, {n_ent}, {n_rows}], got {tuple(a.shape)}")
    return a.reshape(groups * n_ent, n_rows).contiguous()


class _BucketLanes:
    """What both bucket lane batches share: G groups (configs or resamples)
    of E entities as G*E lanes, with per-lane labels, offsets and weights
    ``[G*E, R]``."""

    lane_exact = True  # the losses' position-independent form (ops/losses.py)

    @property
    def num_lanes(self) -> int:
        return self.num_groups * self.num_entities

    def _by_group(self, w: Tensor) -> Tensor:
        """Lane coefficients ``[G*E, K]`` as ``[G, E, K]``."""
        want = (self.num_lanes, self.num_local_features)
        if tuple(w.shape) != want:
            raise ValueError(f"coefficients must be {list(want)}, got {tuple(w.shape)}")
        return w.reshape(self.num_groups, self.num_entities, self.num_local_features)

    def _rows_by_group(self, r: Tensor) -> Tensor:
        return r.reshape(self.num_groups, self.num_entities, self.rows_per_entity)

    def margins(self, w: Tensor, shift=0.0) -> Tensor:
        """x_er . w_l + offsets_l -> [G*E, R]."""
        _no_shift(shift)
        return self.dot_rows(w) + self.offsets

    def margins_pair(self, w, shift, p, p_shift) -> tuple[Tensor, Tensor]:
        _no_shift(shift)
        _no_shift(p_shift)
        return self.margins(w), self.dot_rows(p)

    def fused_value_grad(self, w, shift, loss_name: str) -> tuple[Tensor, Tensor, Tensor]:
        return _fused_passes(self, loss_name, self.margins(w, shift))

    def fused_hv_at(self, d2_row: Tensor, v: Tensor, v_shift) -> tuple[Tensor, Tensor]:
        _no_shift(v_shift)
        q = d2_row * self.dot_rows(v)
        return self.scatter_features(q), torch.sum(q, dim=-1)

    def fused_hessian_vector(self, w, shift, v, v_shift, loss_name: str) -> tuple[Tensor, Tensor]:
        d2 = self.weights * get_loss(loss_name, lane_exact=True).d2z(self.margins(w, shift),
                                                                     self.labels)
        return self.fused_hv_at(d2, v, v_shift)

    def _outer(self) -> Tensor:
        """x_er x_er^T of every entity's rows, ``[E, R, K*K]``, built once."""
        cached = self.__dict__.get("_outer_products")
        if cached is None:
            x = self._design()
            k = x.shape[-1]
            cached = (x.unsqueeze(-1) * x.unsqueeze(-2)).reshape(*x.shape[:2], k * k)
            self.__dict__["_outer_products"] = cached
        return cached

    def weighted_gram(self, d2: Tensor) -> Tensor:
        """sum_r d2[l, r] x_er x_er^T -> [G*E, K, K]: one batched GEMM over the
        entities against the cached outer products."""
        k = self.num_local_features
        h = torch.einsum("ger,erq->geq", self._rows_by_group(d2), self._outer())
        return h.reshape(self.num_lanes, k, k)


@dataclasses.dataclass(frozen=True, eq=False)
class DenseLanes(_BucketLanes):
    """A dense bucket design ``x [E, R, K]`` shared by ``num_groups`` groups."""

    x: Tensor
    num_groups: int
    labels: Tensor  # [G*E, R]
    offsets: Tensor
    weights: Tensor

    @staticmethod
    def of(x: Tensor, labels: Tensor, offsets: Tensor, weights: Tensor,
           num_groups: int) -> "DenseLanes":
        """``labels``, ``offsets`` and ``weights`` are ``[E, R]`` for every
        group or ``[G, E, R]``."""
        n_ent, n_rows, _ = x.shape
        g, dev = int(num_groups), x.device
        return DenseLanes(x=x, num_groups=g,
                          labels=_lane_rows(labels, g, n_ent, n_rows, dev),
                          offsets=_lane_rows(offsets, g, n_ent, n_rows, dev),
                          weights=_lane_rows(weights, g, n_ent, n_rows, dev))

    @property
    def num_entities(self) -> int:
        return self.x.shape[0]

    @property
    def rows_per_entity(self) -> int:
        return self.x.shape[1]

    @property
    def num_local_features(self) -> int:
        return self.x.shape[2]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def _design(self) -> Tensor:
        return self.x

    def dot_rows(self, w: Tensor) -> Tensor:
        """x_er . w_l -> [G*E, R]."""
        z = bucket_dot_rows(self.x, self._by_group(w))
        return z.reshape(self.num_lanes, self.rows_per_entity)

    def scatter_features(self, per_row: Tensor) -> Tensor:
        """sum_r per_row[l, r] * x_er -> [G*E, K]."""
        out = torch.einsum("ger,erk->gek", self._rows_by_group(per_row), self.x)
        return out.reshape(self.num_lanes, self.num_local_features)

    def scatter_features_sq(self, per_row: Tensor) -> Tensor:
        """sum_r per_row[l, r] * x_er**2 -> [G*E, K]."""
        out = torch.einsum("ger,erk->gek", self._rows_by_group(per_row), self.x * self.x)
        return out.reshape(self.num_lanes, self.num_local_features)


@dataclasses.dataclass(frozen=True, eq=False)
class BlockDiagonalLanes(_BucketLanes):
    """A COO bucket's block-diagonal batch shared by ``num_groups`` groups:
    lane g*E + e is entity e's block of group g, whose coefficients are
    columns e*K..e*K+K-1 of the group's ``W [G, E*K]``."""

    block: BlockDiagonalBatch
    num_groups: int
    labels: Tensor  # [G*E, R]
    offsets: Tensor
    weights: Tensor

    @staticmethod
    def of(block: BlockDiagonalBatch, offsets: Tensor, weights: Tensor,
           num_groups: int) -> "BlockDiagonalLanes":
        g, dev = int(num_groups), block.device
        n_ent, n_rows = block.num_entities, block.rows_per_entity
        return BlockDiagonalLanes(
            block=block, num_groups=g,
            labels=_lane_rows(block.labels, g, n_ent, n_rows, dev),
            offsets=_lane_rows(offsets, g, n_ent, n_rows, dev),
            weights=_lane_rows(weights, g, n_ent, n_rows, dev))

    @property
    def num_entities(self) -> int:
        return self.block.num_entities

    @property
    def rows_per_entity(self) -> int:
        return self.block.rows_per_entity

    @property
    def num_local_features(self) -> int:
        return self.block.num_local_features

    @property
    def device(self) -> torch.device:
        return self.block.device

    def weighted_gram(self, d2: Tensor) -> Tensor:
        """sum_r d2[l, r] x_er x_er^T -> [G*E, K, K] from the block's dense
        rows (a COO bucket is wide: no [E, R, K*K] products are kept)."""
        x = self.block.dense_rows()
        xd = x.unsqueeze(0) * self._rows_by_group(d2).unsqueeze(-1)
        k = self.num_local_features
        return (xd.transpose(-1, -2) @ x.unsqueeze(0)).reshape(self.num_lanes, k, k)

    def dot_rows(self, w: Tensor) -> Tensor:
        """x_er . w_l -> [G*E, R] (lane margins kernel over the block CSR)."""
        z = bucket_dot_rows(self.block, self._by_group(w))
        return z.reshape(self.num_lanes, self.rows_per_entity)

    def _scatter(self, per_row: Tensor, square: bool) -> Tensor:
        c = self.block.csr
        r = self._rows_by_group(per_row).reshape(self.num_groups, -1).contiguous()
        out = kernels.csc_scatter_lanes(*c._csc, r, square, c.tiles)
        return out.reshape(self.num_lanes, self.num_local_features)

    def scatter_features(self, per_row: Tensor) -> Tensor:
        """sum_r per_row[l, r] * x_er -> [G*E, K] (lane scatter kernel)."""
        return self._scatter(per_row, False)

    def scatter_features_sq(self, per_row: Tensor) -> Tensor:
        """sum_r per_row[l, r] * x_er**2 -> [G*E, K] (lane scatter kernel, square)."""
        return self._scatter(per_row, True)


def bucket_dot_rows(design, w: Tensor) -> Tensor:
    """x_er . w[g, e] -> [G, E, R] for each group's coefficients ``w
    [G, E, K]`` over a bucket's design: a dense ``[E, R, K]`` tensor (one
    batched GEMM over the entities) or a ``BlockDiagonalBatch`` (one lane
    margins launch with ``W [G, E*K]``)."""
    if isinstance(design, BlockDiagonalBatch):
        c = design.csr
        z = kernels.csr_margins_lanes(*c._csr, w.reshape(w.shape[0], -1).contiguous(),
                                      c.offsets, 0.0, False)
        return z.reshape(w.shape[0], design.num_entities, design.rows_per_entity)
    return torch.einsum("erk,gek->ger", design, w)


def bucket_lanes(batch, num_groups: int, offsets: Optional[Tensor] = None,
                 weights: Optional[Tensor] = None):
    """A bucket's batch (``DenseBatch`` or ``BlockDiagonalBatch``) for
    ``num_groups`` groups, with per-group ``offsets`` or ``weights``
    (``[G, E, R]``) in place of its own."""
    off = batch.offsets if offsets is None else offsets
    wgt = batch.weights if weights is None else weights
    if isinstance(batch, BlockDiagonalBatch):
        return BlockDiagonalLanes.of(batch, off, wgt, num_groups)
    return DenseLanes.of(batch.x, batch.labels, off, wgt, num_groups)
