"""Training lifecycle events: a typed publish/subscribe bus.

Counterpart of ``photon_ml_tpu/utils/events.py``: ``SetupEvent``,
``TrainingStartEvent``, ``OptimizationLogEvent`` (one per coordinate
update) and ``TrainingFinishEvent``; listeners are plain callables,
registered on an ``EventEmitter`` or loaded by dotted path
(``load_listener(s)``, the train driver's ``event_listeners`` key). Every
send counts ``events.<EventClassName>`` in the telemetry shim.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import logging
from typing import Any, Callable, Mapping, Optional

from photon_ml_tpu_torch import telemetry

logger = logging.getLogger("photon_ml_tpu_torch.events")


@dataclasses.dataclass(frozen=True)
class Event:
    pass


@dataclasses.dataclass(frozen=True)
class SetupEvent(Event):
    """Emitted once with the parsed config."""

    config: Mapping[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainingStartEvent(Event):
    num_rows: int


@dataclasses.dataclass(frozen=True)
class TrainingFinishEvent(Event):
    """End of training; ``metrics_snapshot`` is ``telemetry.snapshot()`` at
    that moment (the counters are cumulative over the process)."""

    best_metric: Optional[float]
    seconds: float
    metrics_snapshot: Optional[Mapping[str, Any]] = None


@dataclasses.dataclass(frozen=True)
class OptimizationLogEvent(Event):
    """One per (coordinate-descent iteration, coordinate) update."""

    iteration: int
    coordinate: str
    seconds: float
    metrics: Optional[Mapping[str, float]] = None


def load_listener(spec: str) -> Callable[[Event], None]:
    """Import one listener from ``"pkg.mod:name"`` or ``"pkg.mod.name"``: a
    callable taking one event, or a class without arguments whose instance
    is the listener."""
    if ":" in spec:
        mod_name, attr = spec.split(":", 1)
    else:
        mod_name, _, attr = spec.rpartition(".")
    if not mod_name or not attr:
        raise ValueError(f"listener spec '{spec}' is not a dotted path")
    try:
        target = getattr(importlib.import_module(mod_name), attr)
        if inspect.isclass(target):
            target = target()
    except (ImportError, AttributeError, TypeError) as e:
        raise ValueError(f"cannot load event listener '{spec}': {e}") from e
    if not callable(target):
        raise ValueError(f"event listener '{spec}' is not callable")
    return target


def load_listeners(specs) -> list[Callable[[Event], None]]:
    """Every listener named by ``specs``, a sequence of dotted paths."""
    return [load_listener(s) for s in specs]


class EventEmitter:
    """Listener registry. ``register`` is idempotent; a listener that raises
    is logged and skipped, so observing never fails training."""

    def __init__(self):
        self._listeners: list[Callable[[Event], None]] = []

    def register(self, listener: Callable[[Event], None]) -> None:
        if listener not in self._listeners:
            self._listeners.append(listener)

    def send(self, event: Event) -> None:
        telemetry.counter(f"events.{type(event).__name__}").inc()
        for listener in self._listeners:
            try:
                listener(event)
            except Exception:  # noqa: BLE001
                logger.exception("event listener %r failed on %s", listener,
                                 type(event).__name__)
