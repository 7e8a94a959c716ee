"""Deterministic, seed-driven fault injection.

Counterpart of ``photon_ml_tpu/faults/plan.py``, copied: named seams
registered at import time (:func:`register_point`) with a no-op call site
(:func:`fault_point`); a seeded :class:`FaultPlan` fires on the nth hit or
with a per-hit probability, raising a typed :class:`InjectedFault` /
:class:`InjectedIOError`, corrupting a value with NaN (:func:`corrupt_array`
/ :func:`corrupt_health` sites), or calling ``os._exit`` for true crash
semantics (no ``finally`` blocks, no atexit flushes). Plans cross process
boundaries through the ``PHOTON_FAULT_PLAN`` environment variable (JSON, or
``@/path/to/plan.json``).

Nth-hit counters are process-global and probability draws come from
``random.Random(seed ^ crc32(point))``, so the same plan against the same
run injects the same faults. The seams do nothing unless a plan is armed.

Telemetry: every triggered injection counts ``faults.injected`` (and
``faults.injected.<point>``); exits are logged before dying.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import threading
import zlib
from typing import Mapping, Optional, Sequence, Union

logger = logging.getLogger("photon_ml_tpu_torch.faults")

ENV_VAR = "PHOTON_FAULT_PLAN"

#: Exit code injected crashes die with (distinct from the graceful-stop 75
#: and common signal codes, so a chaos harness can assert the process died
#: AT the injection point and not for some other reason).
DEFAULT_EXIT_CODE = 113

_ACTIONS = ("raise", "io", "exit", "nan")


class InjectedFault(RuntimeError):
    """A fault-injection rule fired at ``point`` (action ``raise``)."""

    def __init__(self, point: str, detail: str = ""):
        self.point = point
        super().__init__(
            f"injected fault at '{point}'" + (f": {detail}" if detail else "")
        )


class InjectedIOError(InjectedFault, OSError):
    """Action ``io``: an injected fault that IS an OSError, so transient-
    IO retry paths (ingest decode, registry load) treat it exactly like a
    real flaky read."""


class FaultPlanError(ValueError):
    """A plan document that cannot work: unknown action, conflicting
    triggers, malformed JSON."""


@dataclasses.dataclass(frozen=True)
class FaultPointInfo:
    """Registry metadata for one injection seam."""

    name: str
    write_path: bool  # checkpoint/publish write protocol: chaos-matrix set
    description: str
    distributed: bool = False  # multi-process seam: fleet crash-matrix set


_REGISTRY: dict[str, FaultPointInfo] = {}
_REGISTRY_LOCK = threading.Lock()


def register_point(
    name: str,
    *,
    write_path: bool = False,
    distributed: bool = False,
    description: str = "",
) -> str:
    """Declare an injection seam (module level, import time). Idempotent;
    re-registering with a DIFFERENT write_path/distributed classification
    is a programming error. Returns ``name`` so call sites bind it to a
    module constant."""
    with _REGISTRY_LOCK:
        existing = _REGISTRY.get(name)
        if existing is not None:
            if existing.write_path != write_path:
                raise ValueError(
                    f"fault point '{name}' already registered with "
                    f"write_path={existing.write_path}"
                )
            if existing.distributed != distributed:
                raise ValueError(
                    f"fault point '{name}' already registered with "
                    f"distributed={existing.distributed}"
                )
            return name
        _REGISTRY[name] = FaultPointInfo(
            name=name,
            write_path=write_path,
            description=description,
            distributed=distributed,
        )
    return name


def registered_points() -> dict[str, FaultPointInfo]:
    """Snapshot of every registered fault point (import the package
    first: registration happens at module import)."""
    with _REGISTRY_LOCK:
        return dict(_REGISTRY)


def write_path_points() -> list[str]:
    """The checkpoint/publish write-protocol points, sorted."""
    with _REGISTRY_LOCK:
        return sorted(n for n, i in _REGISTRY.items() if i.write_path)


def distributed_points() -> list[str]:
    """The multi-process seams, sorted."""
    with _REGISTRY_LOCK:
        return sorted(n for n, i in _REGISTRY.items() if i.distributed)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """When and how one point fires.

    Exactly one trigger: ``nth`` (fire on the nth hit, 1-based; default
    1) or ``probability`` (seeded per-hit coin). ``action``: ``raise``
    (typed InjectedFault), ``io`` (InjectedIOError — an OSError, for
    transient-retry paths), ``exit`` (``os._exit(exit_code)`` — a true
    crash), or ``nan`` (value corruption at :func:`corrupt_array` /
    :func:`corrupt_health` sites; at a plain :func:`fault_point` site it
    degrades to ``raise``).
    """

    point: str
    action: str = "raise"
    nth: Optional[int] = None
    probability: Optional[float] = None
    exit_code: int = DEFAULT_EXIT_CODE

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise FaultPlanError(
                f"unknown fault action {self.action!r} (known: {_ACTIONS})"
            )
        if self.nth is not None and self.probability is not None:
            raise FaultPlanError(
                f"rule for '{self.point}': nth and probability are "
                "mutually exclusive"
            )
        if self.nth is not None and self.nth < 1:
            raise FaultPlanError(
                f"rule for '{self.point}': nth must be >= 1 (1-based hit)"
            )
        if self.probability is not None and not (
            0.0 < self.probability <= 1.0
        ):
            raise FaultPlanError(
                f"rule for '{self.point}': probability must be in (0, 1]"
            )

    def to_json(self) -> dict:
        out: dict = {"point": self.point, "action": self.action}
        if self.nth is not None:
            out["nth"] = self.nth
        if self.probability is not None:
            out["probability"] = self.probability
        if self.exit_code != DEFAULT_EXIT_CODE:
            out["exit_code"] = self.exit_code
        return out


class FaultPlan:
    """A seeded schedule of :class:`FaultRule`; thread-safe hit counting.

    Determinism contract: nth-hit counters are process-global per point,
    and probability draws come from a per-point ``random.Random`` seeded
    ``seed ^ crc32(point)`` — independent of dict order, hashing, or
    which other points fire.
    """

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.seed = int(seed)
        self._rules: dict[str, FaultRule] = {}
        for rule in rules:
            if rule.point in self._rules:
                raise FaultPlanError(
                    f"duplicate rule for point '{rule.point}'"
                )
            self._rules[rule.point] = rule
        self._hits: dict[str, int] = {}
        self._rngs: dict[str, random.Random] = {
            p: random.Random(self.seed ^ zlib.crc32(p.encode("utf-8")))
            for p, r in self._rules.items()
            if r.probability is not None
        }
        self._lock = threading.Lock()

    @property
    def points(self) -> list[str]:
        return sorted(self._rules)

    def hit(self, point: str) -> Optional[FaultRule]:
        """Record one hit of ``point``; the rule when this hit fires."""
        rule = self._rules.get(point)
        if rule is None:
            return None
        with self._lock:
            count = self._hits.get(point, 0) + 1
            self._hits[point] = count
            if rule.probability is not None:
                fire = self._rngs[point].random() < rule.probability
            else:
                fire = count == (rule.nth or 1)
        return rule if fire else None

    def hit_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._hits)

    def unregistered_points(self) -> list[str]:
        """Rules naming no REGISTERED point (typo'd plans inject nothing;
        the chaos harness refuses them)."""
        registry = registered_points()
        return sorted(p for p in self._rules if p not in registry)

    def to_json(self) -> dict:
        return {
            "seed": self.seed,
            "rules": [r.to_json() for r in self._rules.values()],
        }

    @classmethod
    def from_json(cls, doc: Union[str, Mapping]) -> "FaultPlan":
        if isinstance(doc, str):
            try:
                doc = json.loads(doc)
            except ValueError as e:
                raise FaultPlanError(f"malformed fault-plan JSON: {e}") from None
        if not isinstance(doc, Mapping):
            raise FaultPlanError(
                f"fault plan must be an object, got {type(doc).__name__}"
            )
        unknown = set(doc) - {"seed", "rules"}
        if unknown:
            raise FaultPlanError(
                f"unknown fault-plan keys: {sorted(unknown)}"
            )
        raw_rules = doc.get("rules") or []
        rules = []
        known = {f.name for f in dataclasses.fields(FaultRule)}
        for raw in raw_rules:
            if not isinstance(raw, Mapping) or "point" not in raw:
                raise FaultPlanError(
                    f"each rule needs at least a 'point': {raw!r}"
                )
            bad = set(raw) - known
            if bad:
                raise FaultPlanError(
                    f"unknown rule keys for '{raw['point']}': {sorted(bad)}"
                )
            rules.append(FaultRule(**raw))
        return cls(rules, seed=int(doc.get("seed", 0)))


# ---------------------------------------------------------------------------
# process-global activation
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def _plan_from_env() -> Optional[FaultPlan]:
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:], encoding="utf-8") as fh:
            raw = fh.read()
    return FaultPlan.from_json(raw)


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Activate ``plan`` process-wide (None deactivates); returns it."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def install_from_env() -> Optional[FaultPlan]:
    """(Re)read ``PHOTON_FAULT_PLAN`` and activate the plan it carries —
    called once at package import, so subprocesses armed via env inject
    without any code path cooperating."""
    return install_plan(_plan_from_env())


def clear_plan() -> None:
    install_plan(None)


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def warn_if_armed() -> bool:
    """Log loudly when a fault plan is active (drivers call this at
    startup: an armed production run should never be a surprise)."""
    plan = _ACTIVE
    if plan is None:
        return False
    logger.warning(
        "FAULT INJECTION ARMED: plan seed=%d rules=%s — this process WILL "
        "fail on purpose", plan.seed, plan.points,
    )
    return True


# ---------------------------------------------------------------------------
# call-site API
# ---------------------------------------------------------------------------


def _record_injection(point: str, rule: FaultRule) -> None:
    # lazy import: telemetry must stay importable without faults and
    # vice versa
    from photon_ml_tpu_torch import telemetry

    telemetry.counter("faults.injected").inc()
    telemetry.counter(f"faults.injected.{point}").inc()
    logger.warning(
        "injecting fault at '%s' (action=%s)", point, rule.action
    )


def _trigger(point: str, rule: FaultRule):
    _record_injection(point, rule)
    if rule.action == "exit":
        # true crash semantics: no exception unwinding, no finally
        # blocks, no atexit — flush logging first so the crash site is
        # visible in the log tail, then die
        logging.shutdown()
        os._exit(rule.exit_code)
    if rule.action == "io":
        raise InjectedIOError(point)
    raise InjectedFault(point)


def fault_point(point: str) -> None:
    """The no-op-by-default injection seam. With no active plan this is
    one global read and a dict miss; with a plan whose rule fires it
    raises the typed error or crashes the process."""
    plan = _ACTIVE
    if plan is None:
        return
    rule = plan.hit(point)
    if rule is not None:
        _trigger(point, rule)


def corrupt_array(point: str, array):
    """Value-corruption seam: returns ``array`` untouched, or with its
    first element poisoned to NaN when the plan fires a ``nan`` rule here
    (``raise``/``io``/``exit`` rules behave as at :func:`fault_point`).
    Used on solve results so the guard's divergence recovery is testable
    on demand."""
    plan = _ACTIVE
    if plan is None:
        return array
    rule = plan.hit(point)
    if rule is None:
        return array
    if rule.action != "nan":
        _trigger(point, rule)
    _record_injection(point, rule)
    import numpy as np

    if isinstance(array, np.ndarray):
        out = array.copy()
        out.reshape(-1)[0] = np.nan
        return out
    # a tensor: an out-of-place copy with its first element poisoned
    out = array.clone()
    out.reshape(-1)[0] = float("nan")
    return out


def corrupt_health(point: str, health):
    """Health-flip seam: returns the device/bool health value, forced
    falsy when a ``nan`` rule fires (other actions raise/crash as at
    :func:`fault_point`). Lets the coordinate-descent guard path — whose
    solve results are model objects, not a single array — inject a
    divergence without touching model internals."""
    plan = _ACTIVE
    if plan is None:
        return health
    rule = plan.hit(point)
    if rule is None:
        return health
    if rule.action != "nan":
        _trigger(point, rule)
    _record_injection(point, rule)
    import torch

    # on the health's own device, so a loop that combines it with device
    # tensors sees no device mismatch
    if isinstance(health, torch.Tensor):
        return torch.zeros_like(health, dtype=torch.bool)
    return torch.tensor(False)


# arm from the environment at import: chaos subprocesses set
# PHOTON_FAULT_PLAN before exec and need no further cooperation
install_from_env()
