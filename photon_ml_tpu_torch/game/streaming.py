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

A mesh (``mesh=``, the reference's entity-sharded table and chunks, and its
process-local ``LocalChunk``) is refused, naming ROADMAP.md Queue 1 item
12; so are the reference's fault-injection points (item 14c), which the
guard's rollback and the feed retries do not need.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.device import check_on, resolve_device
from photon_ml_tpu_torch.game.coordinates import NOT_PORTED
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.factory import OptimizerConfig, build_objective, dispatch_solve
from photon_ml_tpu_torch.optim.guard import GuardSpec, damped_objective, solve_health

Tensor = torch.Tensor

logger = logging.getLogger("photon_ml_tpu_torch.game.streaming")

# DistributedOptimizationProblem.computeVariances adds this to the Hessian
# diagonal before inverting (as the random-effect coordinate does)
_VARIANCE_EPS = 1e-12


def _refuse_mesh(what: str):
    raise NotImplementedError(NOT_PORTED.format(what, 12))


class ShardedCoefficientTable:
    """A device-resident ``[N, K]`` coefficient table, updated a chunk of
    rows at a time in place. ``mesh`` (an entity-sharded table) is refused:
    ROADMAP.md Queue 1 item 12."""

    def __init__(self, num_entities: int, dim: int, mesh=None, axis: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        if mesh is not None:
            _refuse_mesh("a mesh-sharded coefficient table (mesh)")
        self.device = resolve_device(device)
        self.num_entities = int(num_entities)
        self.dim = int(dim)
        self.mesh = None
        self.axis = axis
        self.coefficients = torch.zeros((self.num_entities, self.dim), dtype=dtype,
                                        device=self.device)

    @classmethod
    def from_coefficients(cls, coefficients: Tensor, mesh=None,
                          axis: Optional[str] = None) -> "ShardedCoefficientTable":
        """Wrap an ``[N, K]`` tensor already on its device (a restored
        checkpoint) without the zero init and overwrite of a construct-then-
        write resume; the table is that tensor."""
        if mesh is not None:
            _refuse_mesh("a mesh-sharded coefficient table (mesh)")
        if not isinstance(coefficients, Tensor) or coefficients.dim() != 2:
            raise ValueError("coefficients must be an [N, K] tensor")
        table = cls.__new__(cls)
        table.device = coefficients.device
        table.num_entities, table.dim = (int(d) for d in coefficients.shape)
        table.mesh = None
        table.axis = axis
        table.coefficients = coefficients
        return table

    @property
    def nbytes(self) -> int:
        return self.num_entities * self.dim * self.coefficients.element_size()

    def _check_bounds(self, start: int, size: int) -> None:
        if start < 0 or size < 0 or start + size > self.num_entities:
            raise ValueError(f"chunk [{start}, {start + size}) out of bounds for table "
                             f"of {self.num_entities} entities")

    def write_chunk(self, start: int, w: Tensor) -> None:
        """Rows ``[start, start + E)`` := ``w``, in place."""
        self._check_bounds(start, int(w.shape[0]))
        self.coefficients[start:start + w.shape[0]].copy_(w)

    def read_chunk(self, start: int, size: int) -> Tensor:
        """A copy of rows ``[start, start + size)``."""
        self._check_bounds(start, size)
        return self.coefficients[start:start + size].clone()

    def to_numpy(self) -> np.ndarray:
        """The whole table on the host (models, summaries, tests)."""
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
    device (an on-device generator). ``mesh`` is refused: ROADMAP.md Queue 1
    item 12.
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
        if mesh is not None:
            _refuse_mesh("the entity-sharded streamed random effect (mesh)")
        config.validate(loss_name)
        if compute_variances and not get_loss(loss_name).has_hessian:
            raise ValueError("coefficient variances need a twice-differentiable loss; "
                             f"'{loss_name}' is not")
        self.device = resolve_device(device)
        self.loss_name = loss_name
        self.config = config
        self.mesh = None
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
        self._upload_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                               else None)

    def _prepare(self, source) -> tuple[DenseBatch, Optional["torch.cuda.Event"]]:
        """The chunk on the device and, for a host chunk copied on the side
        stream, the event that marks the copy done."""
        if callable(source):
            batch = source()
            if not isinstance(batch, DenseBatch):
                raise TypeError(f"chunk generator returned {type(batch).__name__}, "
                                "not a DenseBatch")
            check_on(self.device, batch.x, batch.labels, batch.offsets, batch.weights)
            return batch, None
        if not isinstance(source, DenseBatch):
            raise TypeError(f"chunk source {type(source).__name__}")
        leaves = (source.x, source.labels, source.offsets, source.weights)
        if all(isinstance(t, Tensor) and t.device.type == self.device.type for t in leaves):
            check_on(self.device, *leaves)
            return source, None
        if self._upload_stream is None:
            return DenseBatch(*(torch.as_tensor(np.asarray(t, np.float32)) if not isinstance(
                t, Tensor) else t.to(torch.float32) for t in leaves)), None
        host = [_pinned(t) for t in leaves]
        with torch.cuda.stream(self._upload_stream):
            on_device = [t.to(self.device, non_blocking=True) for t in host]
            ready = torch.cuda.Event()
            ready.record(self._upload_stream)
        return DenseBatch(*on_device), ready

    def _feed(self, source):
        """``_prepare`` with bounded retry: transient feed failures are tried
        again up to ``feed_retries`` times before they surface."""
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
        batch, ready = fed
        if ready is not None:
            # the side stream's copy must land before the solve reads it, and
            # the allocator must not recycle the chunk while the solve runs
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in (batch.x, batch.labels, batch.offsets, batch.weights):
                t.record_stream(current)
        size = int(batch.labels.shape[0])
        w0 = table.read_chunk(start, size)
        # one [K] box shared by every entity (it broadcasts over the lanes):
        # the streamed table's local space is dense, its projection the identity
        cons = self.config.build_box_constraints(table.dim, self.device)
        rolled_back = False
        with telemetry.span("streaming_chunk", start=start, size=size):
            attempt = 0
            while True:
                obj = self._obj
                if attempt:
                    telemetry.counter("solves.retried").inc()
                    obj = damped_objective(obj, self._guard.damping_for(attempt))
                res = dispatch_solve(glm_adapter(obj, batch), w0, self.config, self._l1, cons,
                                     device=self.device)
                if self._guard is None:
                    break
                telemetry.counter("host_syncs").inc()
                if bool(solve_health(res, res.w)):
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
                table.write_chunk(start, res.w)
        telemetry.counter("streaming_chunks").inc()
        telemetry.counter("streaming_entities").inc(size)
        telemetry.counter("progress.rows").inc(int(batch.labels.numel()))
        telemetry.counter("progress.coeffs").inc(size * table.dim)
        if self.compute_variances and not rolled_back:
            if variance_table is None:
                raise ValueError("compute_variances=True needs a variance_table to write into "
                                 "(train(..., variance_table=...))")
            variance_table.write_chunk(
                start, 1.0 / (obj.hessian_diagonal(res.w, batch) + _VARIANCE_EPS))
        values = res.value
        if rolled_back:
            values = torch.where(torch.isfinite(values), values, torch.zeros_like(values))
        return ChunkResult(start=start, size=size, iterations=res.iterations, values=values,
                           reasons=res.reason, initial_values=res.values[:, 0])

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
