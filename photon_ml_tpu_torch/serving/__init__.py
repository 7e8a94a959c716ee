"""Online serving: a device-resident scoring engine, micro-batching, a
hot-swappable model registry with its quality gate, HTTP/asyncio/stdio front
ends and nearline per-entity updates.

Counterpart of ``photon_ml_tpu/serving`` without the fleet (``shard.py``,
``router.py``: ROADMAP Queue 1 item 14a (ii)):

- :mod:`photon_ml_tpu_torch.serving.engine` — :class:`ScoringEngine`
  uploads a trained :class:`GameModel` once and scores request batches in
  padded batch-size buckets (the fixed effect on the ``csr_margins``
  kernel), all warmed at start-up. Unseen entities fall back to
  fixed-effect-only scores;
- :mod:`photon_ml_tpu_torch.serving.batcher` — :class:`MicroBatcher`
  (deadline coalescing) and :class:`ContinuousBatcher` (dispatch at once),
  with queue-depth admission control (:class:`Overloaded`);
- :mod:`photon_ml_tpu_torch.serving.registry` — :class:`ModelRegistry`
  watches a versioned models directory and hot-swaps to the newest valid
  version; :func:`publish_version` writes one, gated on quality;
- :mod:`photon_ml_tpu_torch.serving.server` / ``.aio`` — the threading
  and asyncio HTTP front ends and the stdio JSONL loop;
- :mod:`photon_ml_tpu_torch.serving.nearline` — :class:`NearlineUpdater`
  re-solves just the entities that feedback events name and swaps their
  rows into the live tables.

With ``mesh=`` the random-effect tables are split over the mesh's model
axis (``parallel.sharding``). Wired to the CLI as ``python -m
photon_ml_tpu_torch.cli serve``.
"""

from photon_ml_tpu_torch.serving.aio import AsyncScoringServer  # noqa: F401
from photon_ml_tpu_torch.serving.batcher import (  # noqa: F401
    ContinuousBatcher,
    Draining,
    MicroBatcher,
    Overloaded,
)
from photon_ml_tpu_torch.serving.engine import BadRequest, ScoringEngine  # noqa: F401
from photon_ml_tpu_torch.serving.nearline import NearlineUpdater  # noqa: F401
from photon_ml_tpu_torch.serving.registry import (  # noqa: F401
    ModelRegistry,
    publish_version,
    scan_versions,
)
from photon_ml_tpu_torch.serving.server import (  # noqa: F401
    ScoringServer,
    ScoringService,
    serve_stdio,
)

__all__ = [
    "ScoringEngine",
    "BadRequest",
    "MicroBatcher",
    "ContinuousBatcher",
    "Overloaded",
    "Draining",
    "ModelRegistry",
    "NearlineUpdater",
    "publish_version",
    "scan_versions",
    "ScoringService",
    "ScoringServer",
    "AsyncScoringServer",
    "serve_stdio",
]
