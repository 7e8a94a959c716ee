"""Random-effect datasets: per-entity grouping, size buckets and per-entity
feature projection.

A host numpy copy of ``photon_ml_tpu/game/random_effect_data.py:47-522``:
with the same data and seed the buckets are equal to the reference's, array
for array. Entities are grouped into geometry buckets keyed by (rows,
local features, nonzeros), each rounded up to a power of two, and each
entity's observed global features become local ids 0..K-1 through its
sorted ``projection``. Active-data caps use reservoir sampling with weight
rescaling; rows beyond a cap are passive (scored, not trained on).

A bucket whose dense design costs at most ``_DENSE_BYTES_FACTOR`` times its
padded COO (``photon_ml_tpu/game/coordinates.py:517-548``) is solved on
that dense design; ``dense_buckets`` uploads those once per device. The
others are solved on their block-diagonal batch (``ops/block_diagonal.py``),
which ``coo_buckets`` builds and uploads once per device. ``take`` gives
either kind's bucket over some of its entities (the incremental refresh's
touched lanes): a dense one gathered on the device, a COO one built anew
from the entities' host arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.ops.block_diagonal import BlockDiagonalBatch
from photon_ml_tpu_torch.ops.dense import DenseBatch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EntityBucket:
    """A stack of E same-geometry per-entity sparse problems (LOCAL feature
    ids), host numpy. Padding: rows -> R-1 with value 0; weights 0 on padded
    rows; projection -> num_global (a sentinel past any feature id)."""

    values: np.ndarray  # f32[E, nnz]
    rows: np.ndarray  # i32[E, nnz] local row ids
    cols: np.ndarray  # i32[E, nnz] LOCAL feature ids
    labels: np.ndarray  # f32[E, R]
    offsets: np.ndarray  # f32[E, R] base offsets
    weights: np.ndarray  # f32[E, R]
    projection: np.ndarray  # i32[E, K] sorted global feature id per local id
    entity_codes: np.ndarray  # i32[E]
    row_index: np.ndarray  # i32[E, R] global example row; -1 padding
    num_local_features: int
    num_global_features: int

    @property
    def num_entities(self) -> int:
        return self.entity_codes.shape[0]

    @property
    def rows_per_entity(self) -> int:
        return self.labels.shape[1]


def _with_residual(offsets: Tensor, row_index: Tensor, residual: Optional[Tensor]) -> Tensor:
    """A bucket's offsets [E, R] plus residual scores (a global per-row
    vector) gathered through ``row_index`` (``with_extra_offsets``,
    ``random_effect_data.py:84-93``); padding rows get nothing."""
    if residual is None:
        return offsets
    extra = residual.index_select(0, row_index.clamp(min=0).reshape(-1))
    return offsets + torch.where(row_index >= 0, extra.view_as(offsets), 0.0)


@dataclasses.dataclass(frozen=True)
class DenseBucket:
    """A dense-routed bucket on the device: its design, per-row arrays, and
    the (slot, example row) pairs of its active rows, precomputed so that
    scoring and residual gathers need no host round trip."""

    x: Tensor  # f32[E, R, K]
    labels: Tensor  # f32[E, R]
    offsets: Tensor  # f32[E, R]
    weights: Tensor  # f32[E, R]
    row_index: Tensor  # i64[E, R], -1 padding
    slots: Tensor  # i64[m] flat [E*R] positions of the active rows
    slot_rows: Tensor  # i64[m] their example rows

    def batch(self, residual: Optional[Tensor] = None) -> DenseBatch:
        """The bucket's problems, with residual scores added to the offsets."""
        return DenseBatch(x=self.x, labels=self.labels,
                          offsets=_with_residual(self.offsets, self.row_index, residual),
                          weights=self.weights)

    def take(self, positions) -> "DenseBucket":
        """The bucket of the entities at ``positions`` (in that order): every
        array gathered on the device by ``index_select``, the active rows'
        slots recomputed, so ``batch`` and scoring work on it unchanged."""
        idx = torch.as_tensor(np.asarray(positions, np.int64), device=self.x.device)
        row_index = self.row_index.index_select(0, idx)
        flat = row_index.reshape(-1)
        slots = torch.nonzero(flat >= 0).squeeze(1)
        return DenseBucket(x=self.x.index_select(0, idx), labels=self.labels.index_select(0, idx),
                           offsets=self.offsets.index_select(0, idx),
                           weights=self.weights.index_select(0, idx), row_index=row_index,
                           slots=slots, slot_rows=flat.index_select(0, slots))


@dataclasses.dataclass(frozen=True)
class CooBucket:
    """A COO-routed bucket on the device: its block-diagonal batch (whose
    labels, offsets and weights are [E, R]) and the same row placement as a
    ``DenseBucket``."""

    block: BlockDiagonalBatch
    row_index: Tensor  # i64[E, R], -1 padding
    slots: Tensor  # i64[m] flat [E*R] positions of the active rows
    slot_rows: Tensor  # i64[m] their example rows
    # the host arrays the block was built from (``take`` builds from them)
    source: Optional["EntityBucket"] = dataclasses.field(default=None, repr=False,
                                                         compare=False)

    def batch(self, residual: Optional[Tensor] = None) -> BlockDiagonalBatch:
        """The bucket's problems, with residual scores added to the offsets."""
        if residual is None:
            return self.block
        return self.block.with_offsets(
            _with_residual(self.block.offsets, self.row_index, residual))

    def take(self, positions) -> "CooBucket":
        """The bucket of the entities at ``positions`` (in that order): their
        host arrays as one new ``BlockDiagonalBatch`` built on the block's
        device (on a CUDA device with its tile index, which ``csc_scatter``
        needs), and their row placement."""
        if self.source is None:
            raise ValueError("this COO bucket keeps no host arrays to gather from")
        sub = _take_entities(self.source, positions)
        dev = self.block.device
        return CooBucket(block=BlockDiagonalBatch.from_bucket(
            sub.values, sub.rows, sub.cols, sub.labels, sub.offsets, sub.weights,
            sub.num_local_features, device=dev), source=sub, **_placement(sub, dev))


def _take_entities(b: "EntityBucket", positions) -> "EntityBucket":
    """The entities of ``b`` at ``positions``, host arrays gathered."""
    pos = np.asarray(positions, np.int64)
    return dataclasses.replace(
        b, values=b.values[pos], rows=b.rows[pos], cols=b.cols[pos], labels=b.labels[pos],
        offsets=b.offsets[pos], weights=b.weights[pos], projection=b.projection[pos],
        entity_codes=b.entity_codes[pos], row_index=b.row_index[pos])


def _placement(b: "EntityBucket", device: torch.device) -> dict:
    """``row_index``, ``slots`` and ``slot_rows`` of a bucket on ``device``."""
    ri = b.row_index.astype(np.int64)
    slots = np.flatnonzero(ri.reshape(-1) >= 0)
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device) for k, a in (
        ("row_index", ri), ("slots", slots), ("slot_rows", ri.reshape(-1)[slots]))}


@dataclasses.dataclass(frozen=True)
class RandomEffectDataset:
    """All buckets of one random-effect coordinate plus entity placement:
    ``entity_bucket``/``entity_pos`` map an entity code to (bucket, position),
    -1 for entities with no active data."""

    id_name: str
    shard_name: str
    buckets: tuple[EntityBucket, ...]
    num_entities: int
    entity_bucket: np.ndarray  # i32[num_entities]
    entity_pos: np.ndarray  # i32[num_entities]
    passive_rows: np.ndarray  # i64[num_passive] global example rows
    num_global_features: int

    def dense_designs(self) -> tuple[Optional[np.ndarray], ...]:
        """Per-bucket host dense designs [E, R, K], or None where the COO
        layout is the better trade; built once and cached."""
        cached = self.__dict__.get("_dense_designs")
        if cached is None:
            cached = tuple(_bucket_dense_design(b) for b in self.buckets)
            object.__setattr__(self, "_dense_designs", cached)
        return cached

    def dense_buckets(self, device: torch.device) -> tuple[Optional[DenseBucket], ...]:
        """The dense-routed buckets uploaded to ``device`` once (None for a
        COO-routed bucket); every coordinate and fit over this dataset
        shares the copy."""
        cache = self.__dict__.setdefault("_dense_buckets", {})
        key = str(device)
        if key not in cache:
            out = []
            for b, x in zip(self.buckets, self.dense_designs()):
                if x is None:
                    out.append(None)
                    continue

                def up(a):
                    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

                out.append(DenseBucket(x=up(x), labels=up(b.labels), offsets=up(b.offsets),
                                       weights=up(b.weights), **_placement(b, device)))
            cache[key] = tuple(out)
        return cache[key]

    def coo_buckets(self, device: torch.device) -> tuple[Optional[CooBucket], ...]:
        """The COO-routed buckets on ``device`` (None for a dense-routed
        one), each as one ``BlockDiagonalBatch`` whose CSR, CSC and tile
        layout is built on the host and uploaded once; cached like
        ``dense_buckets``. The host build is timed in the telemetry span
        ``re_coo_layout``."""
        cache = self.__dict__.setdefault("_coo_buckets", {})
        key = str(device)
        if key not in cache:
            with telemetry.span("re_coo_layout"):
                cache[key] = tuple(
                    None if x is not None else CooBucket(
                        block=BlockDiagonalBatch.from_bucket(
                            b.values, b.rows, b.cols, b.labels, b.offsets, b.weights,
                            b.num_local_features, device=device),
                        source=b, **_placement(b, device))
                    for b, x in zip(self.buckets, self.dense_designs()))
        return cache[key]

    def owner_datasets(self, owners: int) -> tuple["RandomEffectDataset", ...]:
        """The buckets split over ``owners`` devices of a model axis: each
        bucket's entities padded to a multiple of ``owners`` with all-zero
        problems (weight 0, the sentinel projection, no rows) and cut into
        equal contiguous blocks, block d the d-th dataset's bucket. Each
        block keeps its bucket's layout (dense or COO). Cached per count."""
        from photon_ml_tpu_torch.parallel.sharding import split_by_owner

        cache = self.__dict__.setdefault("_owner_datasets", {})
        if owners not in cache:
            splits = [split_by_owner(b.num_entities, owners) for b in self.buckets]
            out = []
            for d in range(owners):
                parts = [(_owner_block(b, *sp[d]), None if x is None else _pad_lanes(
                    x[sp[d][0]:sp[d][1]], sp[d][2])) for b, x, sp in
                    zip(self.buckets, self.dense_designs(), splits)]
                sub = dataclasses.replace(self, buckets=tuple(b for b, _ in parts),
                                          num_entities=sum(b.num_entities for b, _ in parts))
                # the parent's layout decision, not one made again on the block
                object.__setattr__(sub, "_dense_designs", tuple(x for _, x in parts))
                out.append(sub)
            cache[owners] = (tuple(out), splits)
        return cache[owners][0]

    def owner_splits(self, owners: int) -> list[list[tuple[int, int, int]]]:
        """Per bucket, per owner, ``(lo, hi, pad)``: the bucket's entities
        [lo, hi) then ``pad`` padding problems (``owner_datasets``)."""
        self.owner_datasets(owners)
        return self.__dict__["_owner_datasets"][owners][1]


def _pad_lanes(a: np.ndarray, pad: int, fill=0) -> np.ndarray:
    """``a`` with ``pad`` more entries of ``fill`` along its first axis."""
    if not pad:
        return a
    return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])


def _owner_block(b: EntityBucket, lo: int, hi: int, pad: int) -> EntityBucket:
    """Entities [lo, hi) of ``b`` and ``pad`` all-zero problems: no nonzeros
    (value 0 at row R-1, column 0), weight 0, the sentinel projection, no
    example rows (-1)."""
    r = b.rows_per_entity
    return dataclasses.replace(
        b, values=_pad_lanes(b.values[lo:hi], pad), rows=_pad_lanes(b.rows[lo:hi], pad, r - 1),
        cols=_pad_lanes(b.cols[lo:hi], pad), labels=_pad_lanes(b.labels[lo:hi], pad),
        offsets=_pad_lanes(b.offsets[lo:hi], pad), weights=_pad_lanes(b.weights[lo:hi], pad),
        projection=_pad_lanes(b.projection[lo:hi], pad, b.num_global_features),
        entity_codes=_pad_lanes(b.entity_codes[lo:hi], pad, -1),
        row_index=_pad_lanes(b.row_index[lo:hi], pad, -1))


_PEARSON_STD_EPS = 1e-8  # MathConst.MEDIUM_PRECISION_TOLERANCE_THRESHOLD


def _pearson_keep_mask(
    nv: np.ndarray,
    nc: np.ndarray,
    ne: np.ndarray,
    y_of_nnz: np.ndarray,
    y_act: np.ndarray,
    ent_of_row: np.ndarray,
    act_counts: np.ndarray,
    num_global: int,
    ratio: float,
) -> np.ndarray:
    """Keep mask over nnz: per entity, the top ceil(ratio * rows) features
    by |Pearson(feature, label)|; the first near-constant feature of an
    entity scores 1 (it acts as the intercept), later ones 0."""
    n_ent = len(act_counts)
    pair_key = ne * np.int64(num_global) + nc
    uniq, inv = np.unique(pair_key, return_inverse=True)
    s_v = np.bincount(inv, weights=nv, minlength=len(uniq))
    s_vv = np.bincount(inv, weights=nv * nv, minlength=len(uniq))
    s_vy = np.bincount(inv, weights=nv * y_of_nnz, minlength=len(uniq))
    p_ent = (uniq // np.int64(num_global)).astype(np.int64)

    n_e = act_counts.astype(np.float64)
    ly = np.bincount(ent_of_row, weights=y_act, minlength=n_ent)
    lyy = np.bincount(ent_of_row, weights=y_act * y_act, minlength=n_ent)

    n_p = n_e[p_ent]
    numerator = n_p * s_vy - s_v * ly[p_ent]
    std = np.sqrt(np.abs(n_p * s_vv - s_v * s_v))
    denominator = std * np.sqrt(np.maximum(n_p * lyy[p_ent] - ly[p_ent] ** 2, 0.0))
    score = np.abs(numerator / (denominator + 1e-12))
    constant = std < _PEARSON_STD_EPS
    if np.any(constant):
        c_idx = np.nonzero(constant)[0]
        first = np.zeros(len(uniq), bool)
        is_first = np.ones(len(c_idx), bool)
        is_first[1:] = p_ent[c_idx[1:]] != p_ent[c_idx[:-1]]
        first[c_idx[is_first]] = True
        score = np.where(constant, np.where(first, 1.0, 0.0), score)

    order = np.lexsort((-score, p_ent))
    starts = np.searchsorted(p_ent[order], np.arange(n_ent))
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq)) - starts[p_ent[order]]
    k_e = np.ceil(ratio * n_e).astype(np.int64)
    keep_pair = rank < k_e[p_ent]
    return keep_pair[inv]


def build_random_effect_dataset(
    data: GameDataset,
    id_name: str,
    shard_name: str,
    active_rows_per_entity: Optional[int] = None,
    min_rows_per_entity: int = 1,
    features_to_samples_ratio: Optional[float] = None,
    seed: int = 0,
) -> RandomEffectDataset:
    """Group, cap, project and bucket one random-effect coordinate's data:
    vectorized numpy over the whole shard, with one loop over geometry
    classes (tens), never over entities."""
    if id_name not in data.id_columns:
        raise KeyError(f"unknown id column '{id_name}'; have {sorted(data.id_columns)}")
    idc = data.id_columns[id_name]
    shard = data.shard(shard_name)
    n = data.num_rows
    num_global = shard.num_features
    rng = np.random.default_rng(seed)

    vals, rows, cols = shard.values, shard.rows, shard.cols
    live = vals != 0
    vals, rows, cols = vals[live], rows[live], cols[live]

    codes = np.asarray(idc.codes)

    # --- active/passive rows: a uniform sample per entity under a cap ---
    rand_key = rng.random(n)
    grp_order = np.lexsort((rand_key, codes))
    g_codes = codes[grp_order]
    uniq_codes, grp_starts, grp_counts = np.unique(
        g_codes, return_index=True, return_counts=True
    )
    ent_of_pos = np.searchsorted(uniq_codes, g_codes)
    rank_in_ent = np.arange(n) - grp_starts[ent_of_pos]

    counts_of_pos = grp_counts[ent_of_pos]
    active_pos = counts_of_pos >= min_rows_per_entity
    weights = data.weight.copy()
    cap = active_rows_per_entity
    if cap is not None:
        capped = counts_of_pos > cap
        active_pos &= ~capped | (rank_in_ent < cap)
        resc = capped & (rank_in_ent < cap)
        weights[grp_order[resc]] *= counts_of_pos[resc] / cap
    act_rows_unsorted = grp_order[active_pos]
    passive_rows = np.sort(grp_order[~active_pos])

    # --- active rows regrouped by (entity, row id) ---
    act_codes_u = codes[act_rows_unsorted]
    o = np.lexsort((act_rows_unsorted, act_codes_u))
    act_rows = act_rows_unsorted[o]
    act_codes = act_codes_u[o]
    act_uniq, act_starts, act_counts = np.unique(
        act_codes, return_index=True, return_counts=True
    )
    n_act = len(act_rows)
    n_ent = len(act_uniq)
    ent_of_row = np.searchsorted(act_uniq, act_codes)
    local_row = np.arange(n_act) - act_starts[ent_of_row]

    row_local = np.full(n, -1, np.int64)
    row_local[act_rows] = local_row
    row_ent = np.full(n, -1, np.int64)
    row_ent[act_rows] = ent_of_row

    # --- nonzeros of active rows, sorted by (entity, local row) ---
    keep_nnz = row_ent[rows] >= 0
    nv, nr, nc = vals[keep_nnz], rows[keep_nnz], cols[keep_nnz]
    ne = row_ent[nr]
    nlr = row_local[nr]
    o2 = np.lexsort((nlr, ne))
    nv, nc, ne, nlr, ngr = nv[o2], nc[o2], ne[o2], nlr[o2], nr[o2]

    if features_to_samples_ratio is not None:
        keep = _pearson_keep_mask(
            nv, nc, ne,
            y_of_nnz=np.asarray(data.response)[ngr],
            y_act=np.asarray(data.response)[act_rows],
            ent_of_row=ent_of_row,
            act_counts=act_counts,
            num_global=num_global,
            ratio=float(features_to_samples_ratio),
        )
        nv, nc, ne, nlr = nv[keep], nc[keep], ne[keep], nlr[keep]

    nnz_counts = np.bincount(ne, minlength=n_ent).astype(np.int64)
    nnz_starts = np.concatenate([[0], np.cumsum(nnz_counts)[:-1]])
    slot = np.arange(len(nv)) - nnz_starts[ne]

    # --- per-entity projection: the entity's observed global columns ---
    pair_key = ne * np.int64(num_global) + nc
    uniq_pairs = np.unique(pair_key)
    proj_ent = uniq_pairs // num_global
    proj_col = (uniq_pairs % num_global).astype(np.int64)
    proj_counts = np.bincount(proj_ent, minlength=n_ent).astype(np.int64)
    proj_starts = np.concatenate([[0], np.cumsum(proj_counts)[:-1]])
    proj_slot = np.arange(len(uniq_pairs)) - proj_starts[proj_ent]
    local_col = np.searchsorted(uniq_pairs, pair_key) - proj_starts[ne]

    # --- geometry classes, ordered by (R, K, NZ) ---
    Rs = _next_pow2_arr(act_counts)
    Ks = _next_pow2_arr(np.maximum(proj_counts, 1))
    NZs = _next_pow2_arr(np.maximum(nnz_counts, 1))
    geom = np.stack([Rs, Ks, NZs], axis=1)
    classes, class_of_ent = np.unique(geom, axis=0, return_inverse=True)
    class_of_ent = class_of_ent.reshape(-1)
    class_order = np.lexsort((classes[:, 2], classes[:, 1], classes[:, 0]))
    class_rank = np.empty(len(classes), np.int64)
    class_rank[class_order] = np.arange(len(classes))
    class_of_ent = class_rank[class_of_ent]
    classes = classes[class_order]

    # position of each entity in its bucket: ascending entity code
    ent_pos = np.zeros(n_ent, np.int64)
    for b_idx in range(len(classes)):
        sel = class_of_ent == b_idx
        ent_pos[sel] = np.arange(int(sel.sum()))

    num_entities = idc.num_entities
    entity_bucket = np.full(num_entities, -1, np.int32)
    entity_pos = np.full(num_entities, -1, np.int32)
    entity_bucket[act_uniq] = class_of_ent
    entity_pos[act_uniq] = ent_pos

    response = data.response
    offset = data.offset

    buckets = []
    for b_idx, (R, K, NZ) in enumerate(classes):
        R, K, NZ = int(R), int(K), int(NZ)
        esel = class_of_ent == b_idx
        E = int(esel.sum())
        bcode = act_uniq[esel].astype(np.int32)

        bv = np.zeros((E, NZ))
        br = np.full((E, NZ), R - 1, np.int32)
        bc = np.zeros((E, NZ), np.int32)
        bl = np.zeros((E, R))
        bo = np.zeros((E, R))
        bw = np.zeros((E, R))
        bp = np.full((E, K), num_global, np.int32)
        brix = np.full((E, R), -1, np.int32)

        rsel = esel[ent_of_row]
        d_e = ent_pos[ent_of_row[rsel]]
        d_r = local_row[rsel]
        src = act_rows[rsel]
        bl[d_e, d_r] = response[src]
        bo[d_e, d_r] = offset[src]
        bw[d_e, d_r] = weights[src]
        brix[d_e, d_r] = src

        zsel = esel[ne]
        z_e = ent_pos[ne[zsel]]
        z_s = slot[zsel]
        bv[z_e, z_s] = nv[zsel]
        br[z_e, z_s] = nlr[zsel]
        bc[z_e, z_s] = local_col[zsel]

        psel = esel[proj_ent]
        p_e = ent_pos[proj_ent[psel]]
        p_s = proj_slot[psel]
        bp[p_e, p_s] = proj_col[psel]

        buckets.append(
            EntityBucket(
                values=bv.astype(np.float32),
                rows=br,
                cols=bc,
                labels=bl.astype(np.float32),
                offsets=bo.astype(np.float32),
                weights=bw.astype(np.float32),
                projection=bp,
                entity_codes=bcode,
                row_index=brix,
                num_local_features=K,
                num_global_features=num_global,
            )
        )

    return RandomEffectDataset(
        id_name=id_name,
        shard_name=shard_name,
        buckets=tuple(buckets),
        num_entities=num_entities,
        entity_bucket=entity_bucket,
        entity_pos=entity_pos,
        passive_rows=passive_rows.astype(np.int64),
        num_global_features=num_global,
    )


def _next_pow2_arr(x: np.ndarray) -> np.ndarray:
    """The power of two >= x, elementwise (1 for x <= 1)."""
    x = np.asarray(x, np.int64)
    out = np.ones_like(x)
    nz = x > 1
    out[nz] = 1 << np.ceil(np.log2(x[nz])).astype(np.int64)
    return out


# Route a bucket's solves through its dense local design when that design is
# at most this factor of the padded-COO footprint (or under 64 MB).
_DENSE_BYTES_FACTOR = 3.0


def _bucket_dense_design(b: EntityBucket) -> Optional[np.ndarray]:
    """Host dense design [E, R, K] of a bucket, or None when the COO layout
    is the better trade (large K, very sparse locals)."""
    E, R, K = b.num_entities, b.rows_per_entity, b.num_local_features
    nz = b.values.shape[1]
    dense_bytes = E * R * K * 4
    coo_bytes = E * nz * 12
    if dense_bytes > max(64 << 20, _DENSE_BYTES_FACTOR * coo_bytes):
        return None
    rows = b.rows.astype(np.int64)
    e_idx = np.broadcast_to(np.arange(E, dtype=np.int64)[:, None] * (R * K), rows.shape)
    flat = (e_idx + rows * K + b.cols.astype(np.int64)).ravel()
    # padded nonzeros carry value 0 and add nothing
    x = np.bincount(flat, weights=b.values.ravel(), minlength=E * R * K).astype(np.float32)
    return x.reshape(E, R, K)
