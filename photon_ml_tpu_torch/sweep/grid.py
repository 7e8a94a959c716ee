"""Typed sweep-grid specs: the ``--sweep lambda=...`` grammar.

A host-Python copy of ``photon_ml_tpu/sweep/grid.py`` (the same grammar,
order and messages). Reference analog: photon-client GameParams' per-coordinate
``regularization-weights`` lists (GameParams.scala:318-334) — the
GameEstimator trains one CoordinateDescent run per weight combination.
Here the grid is a first-class typed object with a compact string grammar:

    lambda=1e-4:1e2:log16       16 log-spaced points in [1e-4, 1e2]
    lambda=0.5:2.5:lin5         5 linearly spaced points
    lambda=0.01,0.1,1,10        explicit list
    lambda.fixed=0.1,1          per-coordinate override for GLMix
                                (coordinate name after the dot)

Points are deduplicated and ordered DESCENDING deterministically — the
warm-started regularization path trains most-regularized first
(ModelTraining.scala:166 ``sortWith(_ >= _)``), and the sweep runner's
config axis g is exactly this order (lane g-1 is the more regularized
neighbor lane g warm-starts from).

Per-coordinate overrides do NOT form a cartesian product: every
coordinate's grid must have the same length G (or length 1, broadcast),
because the config axis is ONE shared lane axis — lane g uses
``lambda.fixed[g]`` for the FE block and ``lambda.perUser[g]`` for the RE
block. Cartesian sweeps remain ``GameEstimator.fit_grid``'s job.

Malformed specs raise :class:`SweepSpecError` naming the offending token —
a typo must never silently train the default grid.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np

__all__ = ["SweepSpecError", "SweepGrid", "parse_sweep_spec", "parse_range"]


class SweepSpecError(ValueError):
    """A sweep spec failed to parse; the message names the offending token."""

    def __init__(self, token: str, message: str):
        super().__init__(f"bad sweep spec {token!r}: {message}")
        self.token = token


def _parse_float(token: str, context: str) -> float:
    try:
        value = float(token)
    except ValueError:
        raise SweepSpecError(context, f"{token!r} is not a number") from None
    if not np.isfinite(value):
        raise SweepSpecError(context, f"{token!r} is not finite")
    if value < 0:
        raise SweepSpecError(
            context, f"negative regularization weight {token!r}"
        )
    return value


def parse_range(text: str, context: Optional[str] = None) -> tuple[float, ...]:
    """One grid value: ``lo:hi:logN`` / ``lo:hi:linN`` / ``a,b,c`` —
    returns the DESCENDING deduplicated point tuple."""
    context = context if context is not None else text
    text = text.strip()
    if not text:
        raise SweepSpecError(context, "empty grid (no points)")
    if ":" in text:
        parts = text.split(":")
        if len(parts) != 3:
            raise SweepSpecError(
                context, "ranges are 'lo:hi:logN' or 'lo:hi:linN'"
            )
        lo = _parse_float(parts[0], context)
        hi = _parse_float(parts[1], context)
        kind = parts[2].strip().lower()
        if kind.startswith("log"):
            scale, count_text = "log", kind[3:]
        elif kind.startswith("lin"):
            scale, count_text = "lin", kind[3:]
        else:
            raise SweepSpecError(
                context,
                f"spacing {parts[2]!r} must be 'logN' or 'linN'",
            )
        try:
            count = int(count_text)
        except ValueError:
            raise SweepSpecError(
                context, f"point count {count_text!r} is not an integer"
            ) from None
        if count <= 0:
            raise SweepSpecError(context, f"zero/negative point count {count}")
        if lo > hi:
            raise SweepSpecError(
                context, f"inverted range (lo {lo:g} > hi {hi:g})"
            )
        if count == 1:
            points = np.asarray([hi])
        elif scale == "log":
            if lo <= 0:
                raise SweepSpecError(
                    context, f"log spacing needs lo > 0, got {lo:g}"
                )
            points = np.logspace(np.log10(lo), np.log10(hi), count)
        else:
            points = np.linspace(lo, hi, count)
    else:
        points = np.asarray(
            [_parse_float(p, context) for p in text.split(",") if p.strip()]
        )
        if points.size == 0:
            raise SweepSpecError(context, "empty grid (no points)")
    # deterministic descending path order, exact duplicates removed
    points = np.unique(points.astype(np.float64))[::-1]
    return tuple(float(v) for v in points)


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """A parsed sweep: the default λ grid plus per-coordinate overrides.

    ``default`` and every override are DESCENDING tuples. ``size`` is the
    shared config-axis length G; overrides of length 1 broadcast to G.
    """

    default: Optional[tuple[float, ...]] = None
    per_coordinate: Mapping[str, tuple[float, ...]] = dataclasses.field(
        default_factory=dict
    )

    def __post_init__(self):
        lengths = {
            len(v) for v in self.per_coordinate.values() if len(v) > 1
        }
        if self.default is not None and len(self.default) > 1:
            lengths.add(len(self.default))
        if len(lengths) > 1:
            raise SweepSpecError(
                "grid",
                "per-coordinate grids must share one config-axis length "
                f"(or be length 1); got lengths {sorted(lengths)} — the "
                "sweep axis is one shared vmap lane, not a cartesian "
                "product (use GameEstimator.fit_grid for products)",
            )
        if self.default is None and not self.per_coordinate:
            raise SweepSpecError("grid", "no lambda grid given")

    @property
    def size(self) -> int:
        sizes = [len(v) for v in self.per_coordinate.values()]
        if self.default is not None:
            sizes.append(len(self.default))
        return max(sizes)

    def for_coordinate(self, name: str) -> tuple[float, ...]:
        """Coordinate ``name``'s λ per config lane (length ``size``)."""
        points = self.per_coordinate.get(name, self.default)
        if points is None:
            raise SweepSpecError(
                f"lambda.{name}",
                "coordinate has no grid and no default `lambda=` was given",
            )
        if len(points) == 1 and self.size > 1:
            points = points * self.size
        return points

    def to_json(self) -> dict:
        out: dict = {}
        if self.default is not None:
            out["lambda"] = list(self.default)
        for name, points in self.per_coordinate.items():
            out[f"lambda.{name}"] = list(points)
        return out


def parse_sweep_spec(specs: str | Sequence[str]) -> SweepGrid:
    """Parse one or more ``lambda[.coordinate]=<grid>`` tokens.

    ``specs`` may be a single string (tokens separated by whitespace
    and/or ``;``) or a sequence of tokens (one per ``--sweep`` flag).
    """
    if isinstance(specs, str):
        tokens = [t for t in specs.replace(";", " ").split() if t]
    else:
        tokens = [t for raw in specs for t in str(raw).replace(";", " ").split()]
    if not tokens:
        raise SweepSpecError("<empty>", "no sweep tokens given")
    default: Optional[tuple[float, ...]] = None
    per_coordinate: dict[str, tuple[float, ...]] = {}
    for token in tokens:
        key, eq, value = token.partition("=")
        key = key.strip()
        if not eq:
            raise SweepSpecError(token, "expected 'lambda[.coordinate]=grid'")
        if not value.strip():
            raise SweepSpecError(token, "empty grid (no points)")
        if key == "lambda":
            if default is not None:
                raise SweepSpecError(token, "duplicate 'lambda=' token")
            default = parse_range(value, context=token)
        elif key.startswith("lambda.") and len(key) > len("lambda."):
            coord = key[len("lambda."):]
            if coord in per_coordinate:
                raise SweepSpecError(token, f"duplicate grid for '{coord}'")
            per_coordinate[coord] = parse_range(value, context=token)
        else:
            raise SweepSpecError(
                token, f"unknown key {key!r} (expected 'lambda' or "
                "'lambda.<coordinate>')"
            )
    return SweepGrid(default=default, per_coordinate=per_coordinate)
