"""Billion-coefficient random effects: a resident coefficient table and
streamed entity chunks.

Counterpart of ``photon_ml_tpu/game/streaming.py``:

- the coefficient table ``[N, K]`` stays in device memory for the whole fit
  (``ShardedCoefficientTable``; 4 GB a billion float32 coefficients) and a
  chunk's solve writes its rows in place (``copy_`` into a view), so the
  table is never held twice;
- the training data does not have to fit: per-entity problems are
  independent, so entities stream through in chunks, each one lane solve
  over a dense ``[E, R, K]`` design (``ops/dense.py``'s ``DenseBatch``,
  whose sweeps are cuBLAS batched GEMMs) by the lane solvers the random-effect
  coordinate uses for a dense bucket (``optim/factory.py``
  ``dispatch_solve`` with a 2-D ``w0``);
- chunk i+1 is fed (an on-device generator, or host arrays copied from
  pinned memory on a side stream) by a background thread while chunk i is
  solved (``ingest/prefetch.py`` ``double_buffered``).

With a ``mesh`` (one process, ``parallel/``; :103-172, :271-350, :427-443)
the table's rows are split into equal blocks over the model axis, one on
each device (an ``EntityShards``), and every chunk is cut into equal
pieces, piece j solved on the axis's j-th device: its warm start read from
the blocks that hold its rows and its result written back to them. A chunk
whose size does not divide by the axis is refused.

Across a fleet of processes (``multihost.global_mesh``, :217-230, :354) each
member holds the table's blocks of its own devices (the others' are shapes
only) and solves only its pieces: a ``LocalChunk`` carries just this
process's ``process_slice`` of the chunk, so no member holds a whole chunk.
The per-entity solves need no collective; the guard's verdict on a chunk,
the end-of-fit summaries and ``to_numpy`` (``gather_to_host``) are the
fleet's agreements.

Fault points: ``streaming.solve.result`` poisons a piece's solved ``w``
(``faults.corrupt_array``; a ``nan`` rule drives the guard's retries and
rollback), ``streaming.chunk.boundary`` fires between a chunk's solve and
its checkpoint and stop handling, and in a fleet of processes
``parallel.collective.entry`` fires before each chunk solve.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.device import check_on, resolve_device
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.game.coordinates import re_solve
from photon_ml_tpu_torch.optim.factory import OptimizerConfig, build_objective
from photon_ml_tpu_torch.optim.guard import GuardSpec, damped_objective, solve_health
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.distributed import FP_COLLECTIVE_ENTRY
from photon_ml_tpu_torch.parallel.mesh import Mesh
from photon_ml_tpu_torch.parallel.sharding import EntityShards, model_axis, place_entities
from photon_ml_tpu_torch.telemetry.executables import instrumented, record_collective

Tensor = torch.Tensor

logger = logging.getLogger("photon_ml_tpu_torch.game.streaming")

# a chunk solve whose result a `nan` rule poisons (the guard's retries and
# rollback on demand), and the chunk boundary where the checkpoint and the
# stop handling run (an injected raise leaves a resumable directory)
_FP_SOLVE_RESULT = faults.register_point(
    "streaming.solve.result",
    description="chunk solve output (nan action poisons w for the guard)",
)
_FP_CHUNK_BOUNDARY = faults.register_point(
    "streaming.chunk.boundary",
    description="between a chunk solve and its checkpoint/stop handling",
)

# DistributedOptimizationProblem.computeVariances adds this to the Hessian
# diagonal before inverting (as the random-effect coordinate does)
_VARIANCE_EPS = 1e-12


@instrumented(name="streaming_table_init")
def _table_block(shape: tuple, dtype: torch.dtype, device) -> Tensor:
    """One block of a table (or the whole table) of zeros on ``device``."""
    return torch.zeros(shape, dtype=dtype, device=device)


@instrumented(name="streaming_chunk_write")
def _write_rows(block: Tensor, lo: int, w: Tensor) -> None:
    """Rows ``[lo, lo + len(w))`` of ``block`` := ``w``, in place."""
    block[lo:lo + w.shape[0]].copy_(w)


def _entity_axis(mesh: Mesh, axis: Optional[str]) -> str:
    axis = axis or model_axis(mesh)
    if axis is None:
        raise ValueError(f"mesh {mesh.shape} has no model/entity axis to shard entities over")
    return axis


@dataclasses.dataclass(frozen=True)
class LocalChunk:
    """A chunk given as this process's rows of a fleet: ``batch`` holds only
    the entities of this process's ``process_slice`` of the chunk's
    ``global_size`` (host arrays, or tensors on this process's device), and
    the trainer places them on this process's devices alone."""

    batch: DenseBatch
    global_size: int


class ShardedCoefficientTable:
    """A device-resident ``[N, K]`` coefficient table, updated a chunk of
    rows at a time in place. With ``mesh`` its rows are split into equal
    blocks over the model axis (``axis``, default the mesh's model/entity
    axis), one block on each of its devices: ``coefficients`` is then an
    ``EntityShards`` and ``sharding`` its record (mesh axes and spec)."""

    def __init__(self, num_entities: int, dim: int, mesh: Optional[Mesh] = None,
                 axis: Optional[str] = None, dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        self.num_entities = int(num_entities)
        self.dim = int(dim)
        self.mesh = mesh
        self.sharding = None
        if mesh is None:
            self.device = resolve_device(device)
            self.axis = axis
            self.coefficients = _table_block((self.num_entities, self.dim), dtype,
                                             self.device)
            return
        self.axis = _entity_axis(mesh, axis)
        devices = mesh.axis_devices(self.axis)
        if self.num_entities % len(devices):
            raise ValueError(f"num_entities={self.num_entities} must divide over the "
                             f"{len(devices)}-device '{self.axis}' axis (pad the entity count)")
        per = self.num_entities // len(devices)
        # a fleet member allocates its own blocks; the others' are shapes only
        self._set(EntityShards(parts=tuple(
            _table_block((per, self.dim), dtype,
                         d if owner == mesh.process else torch.device("meta"))
            for d, owner in zip(devices, mesh.axis_owners(self.axis))), mesh=mesh,
            axis=self.axis))

    def _set(self, shards: EntityShards) -> None:
        self.coefficients = shards
        self.device = shards.local_blocks()[0][1].device
        self.sharding = shards.sharding_record()

    @classmethod
    def from_coefficients(cls, coefficients, mesh: Optional[Mesh] = None,
                          axis: Optional[str] = None) -> "ShardedCoefficientTable":
        """Wrap a table already on its devices (a restored checkpoint): an
        ``[N, K]`` tensor, or an ``EntityShards`` (placed again when ``mesh``
        asks for another placement), without the zero init and overwrite of
        a construct-then-write resume; the table is those tensors."""
        if isinstance(coefficients, Tensor) and mesh is not None:
            coefficients = place_entities(coefficients, mesh, _entity_axis(mesh, axis))
        if isinstance(coefficients, EntityShards):
            if mesh is not None and (mesh.key(), _entity_axis(mesh, axis)) != (
                    coefficients.mesh.key(), coefficients.axis):
                coefficients = place_entities(torch.cat([p.to(mesh.first_device)
                                                         for p in coefficients.parts]),
                                              mesh, _entity_axis(mesh, axis))
            table = cls.__new__(cls)
            table.num_entities, table.dim = coefficients.shape
            table.mesh, table.axis = coefficients.mesh, coefficients.axis
            table._set(coefficients)
            return table
        if not isinstance(coefficients, Tensor) or coefficients.dim() != 2:
            raise ValueError("coefficients must be an [N, K] tensor")
        table = cls.__new__(cls)
        table.device = coefficients.device
        table.num_entities, table.dim = (int(d) for d in coefficients.shape)
        table.mesh, table.axis, table.sharding = None, axis, None
        table.coefficients = coefficients
        return table

    @property
    def nbytes(self) -> int:
        size = (self.coefficients.parts[0] if self.mesh is not None
                else self.coefficients).element_size()
        return self.num_entities * self.dim * size

    def shard_nbytes(self) -> list[int]:
        """The bytes each of this process's devices holds (one entry without
        a mesh)."""
        parts = ([p for _, p in self.coefficients.local_blocks()] if self.mesh is not None
                 else (self.coefficients,))
        return [p.numel() * p.element_size() for p in parts]

    def _check_bounds(self, start: int, size: int) -> None:
        if start < 0 or size < 0 or start + size > self.num_entities:
            raise ValueError(f"chunk [{start}, {start + size}) out of bounds for table "
                             f"of {self.num_entities} entities")

    def _spans(self, start: int, size: int):
        """(block, first row in it, end row in it, offset in the chunk) of
        rows [start, start + size) over a mesh table's blocks."""
        per = self.coefficients.rows_per_part
        row = start
        while row < start + size:
            block = row // per
            lo, hi = row - block * per, min(per, start + size - block * per)
            yield block, lo, hi, row - start
            row = block * per + hi

    def write_chunk(self, start: int, w: Tensor) -> None:
        """Rows ``[start, start + E)`` := ``w``, in place (on a mesh, each
        piece into the block that holds it)."""
        self._check_bounds(start, int(w.shape[0]))
        if self.mesh is None:
            _write_rows(self.coefficients, start, w)
            return
        parts = self.coefficients.parts
        for block, lo, hi, off in self._spans(start, int(w.shape[0])):
            if parts[block].device.type == "meta":
                raise ValueError(f"rows [{start}, {start + int(w.shape[0])}) reach a block "
                                 "another fleet member holds")
            _write_rows(parts[block], lo, w[off:off + hi - lo])

    def read_chunk(self, start: int, size: int,
                   device: Optional[torch.device] = None) -> Tensor:
        """A copy of rows ``[start, start + size)``, on ``device`` (default the
        table's first device)."""
        self._check_bounds(start, size)
        if self.mesh is None:
            return self.coefficients[start:start + size].clone()
        dev = self.device if device is None else device
        parts = self.coefficients.parts
        return torch.cat([parts[block][lo:hi].to(dev)
                          for block, lo, hi, _ in self._spans(start, size)])

    def _piece_spans(self, start: int, per: int):
        """(piece, block, first row in it, end row in it, offset in the piece)
        of every piece of the chunk at ``start`` cut in pieces of ``per`` rows
        over the axis, in one order every fleet member computes alike."""
        for j in range(len(self.coefficients.parts)):
            for block, lo, hi, off in self._spans(start + j * per, per):
                yield j, block, lo, hi, off

    def read_pieces(self, start: int, per: int, devices, mine) -> list[Tensor]:
        """Copies of this process's pieces (positions ``mine``) of the chunk
        at ``start``, piece j on ``devices[j]``. Across a fleet the rows of a
        block another member holds are sent by it (``multihost.exchange``)."""
        if self.mesh is None or not self.mesh.is_multiprocess:
            return [self.read_chunk(start + j * per, per, device=devices[j]) for j in mine]
        owners, me = self.mesh.axis_owners(self.axis), self.mesh.process
        parts = self.coefficients.parts
        out = {j: torch.empty((per, self.dim), dtype=self.coefficients.dtype, device=devices[j])
               for j in mine}
        sends, recvs = [], []
        for j, block, lo, hi, off in self._piece_spans(start, per):
            if owners[block] == me and owners[j] == me:
                out[j][off:off + hi - lo].copy_(parts[block][lo:hi])
            elif owners[block] == me:
                sends.append((owners[j], parts[block][lo:hi]))
            elif owners[j] == me:
                recvs.append((owners[block], out[j][off:off + hi - lo]))
        multihost.exchange(sends, recvs)
        return [out[j] for j in mine]

    def write_pieces(self, start: int, per: int, pieces: dict) -> None:
        """Rows of this process's pieces (``pieces``: position -> [per, K]) of
        the chunk at ``start`` written into the blocks that hold them; across
        a fleet the rows of another member's block are sent to it, and the
        rows other members solved for this member's blocks received."""
        if self.mesh is None or not self.mesh.is_multiprocess:
            for j, w in pieces.items():
                self.write_chunk(start + j * per, w)
            return
        owners, me = self.mesh.axis_owners(self.axis), self.mesh.process
        parts = self.coefficients.parts
        sends, recvs = [], []
        for j, block, lo, hi, off in self._piece_spans(start, per):
            if owners[block] == me and owners[j] == me:
                parts[block][lo:hi].copy_(pieces[j][off:off + hi - lo])
            elif owners[j] == me:
                sends.append((owners[block], pieces[j][off:off + hi - lo]))
            elif owners[block] == me:
                recvs.append((owners[j], parts[block][lo:hi]))
        multihost.exchange(sends, recvs)

    def to_numpy(self) -> np.ndarray:
        """The whole table on the host (models, summaries, tests); across a
        fleet every member takes part (``gather_to_host``)."""
        if self.mesh is not None:
            return self.coefficients.numpy()
        return self.coefficients.cpu().numpy()


@dataclasses.dataclass
class ChunkResult:
    """Per-chunk solve telemetry, kept on the device until summarized."""

    start: int
    size: int
    iterations: Tensor  # i32[E]
    values: Tensor  # f32[E]
    reasons: Tensor  # i32[E] convergence reason codes
    initial_values: Tensor  # f32[E] each lane's objective at its warm start


@dataclasses.dataclass
class StreamingTrainStats:
    total_entities: int
    total_coefficients: int
    num_chunks: int
    mean_iterations: float
    total_final_value: float
    #: lanes whose final objective is above the one at their warm start (the
    #: line searches are monotone, so 0 unless a solve went wrong)
    lanes_rose: int = 0
    #: per-entity solve telemetry (one packed host fetch) with with_tracker
    tracker: Optional["RandomEffectOptimizationTracker"] = None  # noqa: F821


def _piece(batch: DenseBatch, lo: int, n: int, device: torch.device) -> DenseBatch:
    """Entities [lo, lo + n) of a chunk on ``device``."""
    return DenseBatch(*(torch.as_tensor(t)[lo:lo + n].to(device)
                        for t in (batch.x, batch.labels, batch.offsets, batch.weights)))


def _pinned(leaf) -> Tensor:
    t = leaf if isinstance(leaf, Tensor) else torch.from_numpy(np.asarray(leaf))
    t = t.to(torch.float32).contiguous()
    return t if t.is_pinned() else t.pin_memory()


class StreamingRandomEffectTrainer:
    """Drive a ``ShardedCoefficientTable`` through streamed chunks on
    ``device`` (default cuda).

    ``chunks`` yields ``(start, source)`` where ``source`` is a
    ``DenseBatch`` of host arrays (numpy, or CPU tensors; on a CUDA device
    copied from pinned memory on a side stream, one chunk ahead of the
    solve) or a zero-argument callable returning a ``DenseBatch`` on the
    device (an on-device generator). With ``mesh`` each chunk is cut into
    equal pieces over the model axis (``axis``), piece j fed to and solved on
    the axis's j-th device; ``device`` is then the first of them.
    """

    # retryable feed failures: storage I/O and runtime transfer errors;
    # programming errors (TypeError, ValueError, shapes) raise at once
    _TRANSIENT_FEED_ERRORS = (OSError, RuntimeError, ConnectionError, TimeoutError)

    def __init__(
        self,
        loss_name: str,
        config: OptimizerConfig,
        mesh=None,
        axis: Optional[str] = None,
        compute_variances: bool = False,
        prefetch: bool = True,
        prefetch_depth: int = 1,
        guard: Optional[GuardSpec] = None,
        feed_retries: int = 2,
        device: torch.device | str | None = None,
    ):
        config.validate(loss_name)
        if compute_variances and not get_loss(loss_name).has_hessian:
            raise ValueError("coefficient variances need a twice-differentiable loss; "
                             f"'{loss_name}' is not")
        self.mesh = mesh
        # the devices a chunk's pieces are solved on, in piece order, and
        # the pieces this process solves (every one outside a fleet)
        if mesh is None:
            self._devices, self._mine = (resolve_device(device),), [0]
        else:
            self._devices = mesh.axis_devices(_entity_axis(mesh, axis))
            self._mine = mesh.local_positions(_entity_axis(mesh, axis))
        self.device = self._devices[self._mine[0]]
        self.loss_name = loss_name
        self.config = config
        self.compute_variances = compute_variances
        # feeding runs through ingest.double_buffered: a background thread
        # prepares up to prefetch_depth chunks ahead of the solve; False is
        # fully synchronous, the control arm
        self.prefetch = prefetch
        if prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        self.prefetch_depth = int(prefetch_depth)
        # the per-chunk divergence guard: one boolean fetch a chunk
        self._guard = guard
        if feed_retries < 0:
            raise ValueError("feed_retries must be >= 0")
        self._feed_retries = feed_retries
        self._obj = build_objective(loss_name, config)
        self._l1 = config.regularization.l1_weight(config.regularization_weight)
        # one side stream per distinct device for the host chunks' copies
        self._upload_streams = {str(self._devices[j]): torch.cuda.Stream(self._devices[j])
                                for j in self._mine if self._devices[j].type == "cuda"}

    def _pieces(self, size: int) -> list[tuple[int, int]]:
        """(first entity, entities) of each of this process's pieces of a
        chunk of ``size``."""
        n_dev = len(self._devices)
        if size % n_dev:
            raise ValueError(f"chunk of {size} entities must divide over the {n_dev}-device "
                             "mesh (pad the chunk)")
        per = size // n_dev
        return [(j * per, per) for j in self._mine]

    def _mine_devices(self) -> list[torch.device]:
        return [self._devices[j] for j in self._mine]

    def _prepare(self, source) -> list[tuple[DenseBatch, Optional["torch.cuda.Event"]]]:
        """This process's pieces of the chunk on their devices, each with the
        event that marks its copy done for a host chunk copied on a side
        stream (else None)."""
        if isinstance(source, LocalChunk):
            # the rows of this process's pieces, in piece order
            pieces = self._pieces(int(source.global_size))
            n_local = int(np.shape(source.batch.labels)[0])
            if n_local != sum(n for _, n in pieces):
                raise ValueError(f"a LocalChunk of {n_local} rows for this process's "
                                 f"{sum(n for _, n in pieces)} of a {source.global_size}-entity "
                                 "chunk")
            first = pieces[0][0] if pieces else 0
            return self._place(source.batch, [(lo - first, n) for lo, n in pieces])
        if callable(source):
            batch = source()
            if isinstance(batch, LocalChunk):  # this process's rows, made on demand
                return self._prepare(batch)
            if not isinstance(batch, DenseBatch):
                raise TypeError(f"chunk generator returned {type(batch).__name__}, "
                                "not a DenseBatch")
            if self.mesh is None:
                check_on(self.device, batch.x, batch.labels, batch.offsets, batch.weights)
                return [(batch, None)]
            return [(_piece(batch, lo, n, d), None)
                    for (lo, n), d in zip(self._pieces(int(batch.labels.shape[0])),
                                          self._mine_devices())]
        if not isinstance(source, DenseBatch):
            raise TypeError(f"chunk source {type(source).__name__}")
        leaves = (source.x, source.labels, source.offsets, source.weights)
        on_device = all(isinstance(t, Tensor) and t.device.type == self.device.type
                        for t in leaves)
        if on_device and self.mesh is None:
            check_on(self.device, *leaves)
            return [(source, None)]
        return self._place(source, self._pieces(int(np.shape(source.labels)[0])))

    def _place(self, source: DenseBatch, pieces: list[tuple[int, int]]):
        """Rows ``[lo, lo + n)`` of ``source`` for each of this process's
        pieces, on its device (host rows copied from pinned memory on a side
        stream where the device is a card)."""
        leaves = (source.x, source.labels, source.offsets, source.weights)
        on_device = all(isinstance(t, Tensor) and t.device.type == self.device.type
                        for t in leaves)
        if on_device or not self._upload_streams:
            if not on_device:
                source = DenseBatch(*(torch.as_tensor(np.asarray(t, np.float32)) if not
                                      isinstance(t, Tensor) else t.to(torch.float32)
                                      for t in leaves))
            return [(_piece(source, lo, n, d), None)
                    for (lo, n), d in zip(pieces, self._mine_devices())]
        host = [_pinned(t) for t in leaves]
        out = []
        for (lo, n), d in zip(pieces, self._mine_devices()):
            stream = self._upload_streams[str(d)]
            with torch.cuda.stream(stream):
                on_dev = [t[lo:lo + n].to(d, non_blocking=True) for t in host]
                ready = torch.cuda.Event()
                ready.record(stream)
            out.append((DenseBatch(*on_dev), ready))
        return out

    def _feed(self, source):
        """``_prepare`` with bounded retry: transient feed failures are tried
        again up to ``feed_retries`` times before they surface. A chunk given
        as host arrays gets a headroom check before its upload."""
        if not callable(source):
            predicted = telemetry.memory.estimate_batch_bytes(source)
            if predicted:
                telemetry.memory.check_headroom(predicted, label="streaming chunk upload",
                                                device=self.device)
        last_err: Optional[Exception] = None
        for attempt in range(self._feed_retries + 1):
            if attempt:
                telemetry.counter("streaming.feed_retries").inc()
                logger.warning("chunk feed failed (%s); retry %d/%d", last_err, attempt,
                               self._feed_retries)
            try:
                return self._prepare(source)
            except self._TRANSIENT_FEED_ERRORS as e:
                last_err = e
        assert last_err is not None
        raise last_err

    def _solve(self, table: ShardedCoefficientTable, start: int, fed,
               variance_table: Optional[ShardedCoefficientTable] = None) -> ChunkResult:
        for batch, ready in fed:
            if ready is not None:
                # the side stream's copy must land before the solve reads it,
                # and the allocator must not recycle the chunk while it runs
                current = torch.cuda.current_stream(batch.x.device)
                current.wait_event(ready)
                for t in (batch.x, batch.labels, batch.offsets, batch.weights):
                    t.record_stream(current)
        sizes = [int(batch.labels.shape[0]) for batch, _ in fed]
        # each piece's place in the chunk: piece j of a chunk cut in equal
        # pieces over the axis starts at j * size
        size = sizes[0] * len(self._devices) if self.mesh is not None else sizes[0]
        devices = self._mine_devices()
        w0s = table.read_pieces(start, sizes[0], self._devices, self._mine)
        # one [K] box shared by every entity (it broadcasts over the lanes):
        # the streamed table's local space is dense, its projection the identity
        boxes = [self.config.build_box_constraints(table.dim, d) for d in devices]
        rolled_back = False
        if self.mesh is not None:
            # the lanes are independent: the only collective is the
            # one-scalar convergence test, once an iteration
            record_collective("streaming_chunk_solve", "psum", len(self._devices), 4,
                              count=max(int(self.config.max_iterations), 1))
        with telemetry.span("streaming_chunk", start=start, size=size):
            attempt = 0
            while True:
                obj = self._obj
                if attempt:
                    telemetry.counter("solves.retried").inc()
                    obj = damped_objective(obj, self._guard.damping_for(attempt))
                if multihost.process_count() > 1:
                    faults.fault_point(FP_COLLECTIVE_ENTRY)
                results = [re_solve(obj, batch, w0, self.config, self._l1, cons, device=d)
                           for (batch, _), w0, cons, d in zip(fed, w0s, boxes, devices)]
                ws = [faults.corrupt_array(_FP_SOLVE_RESULT, r.w) for r in results]
                if self._guard is None:
                    break
                # every piece's health on this process's first device, fetched
                # once; across a fleet the chunk is healthy only where it is
                # healthy on every member
                telemetry.counter("host_syncs").inc()
                healths = [solve_health(r, w).to(self.device) for r, w in zip(results, ws)]
                if not multihost.fleet_any(not bool(torch.stack(healths).all())):
                    break
                telemetry.counter("solves.diverged").inc()
                if attempt >= self._guard.max_retries:
                    # rollback: the chunk's rows keep their pre-solve
                    # coefficients; the summary's values are sanitized
                    telemetry.counter("solves.rolled_back").inc()
                    logger.warning("chunk [%d, %d) still diverging after %d damped retries; "
                                   "keeping previous coefficients", start, start + size,
                                   self._guard.max_retries)
                    rolled_back = True
                    break
                attempt += 1
            if not rolled_back:
                table.write_pieces(start, sizes[0], dict(zip(self._mine, ws)))
        telemetry.counter("streaming_chunks").inc()
        telemetry.counter("streaming_entities").inc(sum(sizes))
        telemetry.counter("progress.rows").inc(sum(int(b.labels.numel()) for b, _ in fed))
        telemetry.counter("progress.coeffs").inc(sum(sizes) * table.dim)
        telemetry.memory.record_phase_memory("streaming_chunk", device=self.device)
        if self.compute_variances and not rolled_back:
            if variance_table is None:
                raise ValueError("compute_variances=True needs a variance_table to write into "
                                 "(train(..., variance_table=...))")
            variance_table.write_pieces(start, sizes[0], {
                j: 1.0 / (obj.hessian_diagonal(w, batch) + _VARIANCE_EPS)
                for j, w, (batch, _) in zip(self._mine, ws, fed)})

        def joined(field):
            return torch.cat([field(r).to(self.device) for r in results])

        values = joined(lambda r: r.value)
        if rolled_back:
            values = torch.where(torch.isfinite(values), values, torch.zeros_like(values))
        return ChunkResult(start=start, size=size, iterations=joined(lambda r: r.iterations),
                           values=values, reasons=joined(lambda r: r.reason),
                           initial_values=joined(lambda r: r.values[:, 0]))

    def _after_chunk(self, chunk_index: int, table: ShardedCoefficientTable,
                     variance_table: Optional[ShardedCoefficientTable], checkpointer,
                     should_stop) -> None:
        """Chunk-boundary bookkeeping: the periodic checkpoint, and on a stop
        request save-then-raise (the deterministic chunk order makes
        ``next_chunk`` enough to resume)."""
        from photon_ml_tpu_torch.game.checkpoint import (
            StreamCheckpointState,
            TrainingInterrupted,
        )

        faults.fault_point(_FP_CHUNK_BOUNDARY)
        stop = should_stop is not None and should_stop()
        path = None
        if checkpointer is not None and (stop or checkpointer.should_save(chunk_index)):
            path = checkpointer.save(StreamCheckpointState(
                next_chunk=chunk_index + 1, coefficients=table.coefficients,
                variances=None if variance_table is None else variance_table.coefficients))
        if stop:
            raise TrainingInterrupted(chunk_index, path)

    def train(
        self,
        table: ShardedCoefficientTable,
        chunks: Iterable[tuple[int, DenseBatch | Callable[[], DenseBatch]]],
        variance_table: Optional[ShardedCoefficientTable] = None,
        with_tracker: bool = False,
        should_stop: Optional[Callable[[], bool]] = None,
        checkpointer=None,
        start_chunk: int = 0,
    ) -> StreamingTrainStats:
        """Solve every chunk into ``table``; feeding runs ``prefetch_depth``
        chunks ahead of the solve in a background thread.

        ``variance_table`` (required with ``compute_variances``) receives
        1 / (diag H + 1e-12) at each entity's optimum. ``with_tracker`` also
        returns the per-entity ``RandomEffectOptimizationTracker`` (one more
        packed fetch). With a ``checkpointer`` (``StreamingCheckpointManager``)
        the table is saved every ``every`` chunk boundaries and once at the
        end; a ``should_stop`` request finishes the current chunk, saves and
        raises ``TrainingInterrupted``. Resume by restoring the table and
        passing the restored ``next_chunk`` as ``start_chunk``: the chunk
        order is deterministic, so the replayed stream is the remainder.
        """
        if self.compute_variances and variance_table is None:
            raise ValueError("compute_variances=True needs a variance_table")
        if start_chunk < 0:
            raise ValueError("start_chunk must be >= 0")
        if self.mesh is None:
            check_on(self.device, table.coefficients)
        results: list[ChunkResult] = []
        # a resume skips the solved chunks without feeding them
        chunk_iter = itertools.islice(iter(chunks), start_chunk, None)
        index = start_chunk - 1
        if self.prefetch:
            from photon_ml_tpu_torch.ingest.prefetch import double_buffered

            fed_chunks = ((start, fed) for (start, _source), fed in double_buffered(
                chunk_iter, lambda item: self._feed(item[1]), depth=self.prefetch_depth,
                name="streaming_chunk"))
        else:
            fed_chunks = ((start, self._feed(source)) for start, source in chunk_iter)
        for start, fed in fed_chunks:
            index += 1
            results.append(self._solve(table, start, fed, variance_table=variance_table))
            # the solved chunk goes before the next is fed: without prefetch
            # one chunk is resident at a time
            del fed
            if not self.prefetch and self.device.type == "cuda":
                # the control arm: transfer and compute fully serialized
                torch.cuda.synchronize(self.device)
            self._after_chunk(index, table, variance_table, checkpointer, should_stop)
        if checkpointer is not None and results:
            # the terminal checkpoint: a crash after the stream must not
            # replay its tail
            from photon_ml_tpu_torch.game.checkpoint import StreamCheckpointState

            checkpointer.save(StreamCheckpointState(
                next_chunk=index + 1, coefficients=table.coefficients,
                variances=None if variance_table is None else variance_table.coefficients))
        if not results:
            return StreamingTrainStats(0, 0, 0, 0.0, 0.0)
        # one device->host fetch for the scalar summaries
        telemetry.counter("host_syncs").inc()
        its, vals, rose = torch.stack([
            torch.stack([r.iterations.double().sum() for r in results]).sum(),
            torch.stack([r.values.double().sum() for r in results]).sum(),
            torch.stack([(r.values > r.initial_values).sum().double()
                         for r in results]).sum()]).tolist()
        if self.mesh is not None and self.mesh.is_multiprocess:
            # a member solved its own lanes: the fleet's sums (the tracker
            # stays this member's lanes)
            its, vals, rose = multihost.fleet_sum([its, vals, rose])
        tracker = None
        if with_tracker:
            from photon_ml_tpu_torch.optim.trackers import RandomEffectOptimizationTracker

            tracker = RandomEffectOptimizationTracker.from_device_parts(
                [r.iterations for r in results], [r.reasons for r in results],
                [r.values for r in results])
        total_e = sum(r.size for r in results)
        return StreamingTrainStats(total_entities=total_e,
                                   total_coefficients=total_e * table.dim,
                                   num_chunks=len(results),
                                   mean_iterations=its / max(total_e, 1),
                                   total_final_value=vals, lanes_rose=int(rose),
                                   tracker=tracker)
