"""Phase timers and logging setup.

Counterpart of ``photon_ml_tpu/utils/timing.py``: named duration blocks
logged around every driver phase (``timed``), a monotonic stopwatch
(``Timer``) and one logger tree configured once per process
(``setup_logging``, to the standard error; the reference's log file is
left out, as no driver of the port writes one). ``timed`` also records its block as a span of the
port's telemetry shim, under the same name.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Iterator, Optional

from photon_ml_tpu_torch import telemetry

logger = logging.getLogger("photon_ml_tpu_torch")


def setup_logging(level: int = logging.INFO) -> None:
    """Configure the ``photon_ml_tpu_torch`` logger tree to log to the
    standard error; repeated calls add no second handler."""
    root = logging.getLogger("photon_ml_tpu_torch")
    root.setLevel(level)
    if any(type(h) is logging.StreamHandler for h in root.handlers):
        return
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
    root.addHandler(handler)


class Timer:
    """A stopwatch on the monotonic clock."""

    def __init__(self):
        self._start: Optional[float] = None
        self.seconds: float = 0.0

    def start(self) -> "Timer":
        self._start = time.monotonic()
        return self

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("Timer.stop() before start()")
        self.seconds = time.monotonic() - self._start
        self._start = None
        return self.seconds


@contextmanager
def timed(name: str, log: logging.Logger = logger) -> Iterator[Timer]:
    """Log the wall-clock duration of a named phase and record it as a
    telemetry span of the same name."""
    with telemetry.span(name):
        t = Timer().start()
        try:
            yield t
        finally:
            t.stop()
            log.info("%s: %.3fs", name, t.seconds)
