"""Nearline-vs-delta reconciliation for the freshness conductor.

Counterpart of ``photon_ml_tpu/pipeline/reconcile.py``, copied: the same
rule, record and degradation on an unreadable newest version.

The registry accumulates versions from two writers at two timescales:
the nearline updater (per-entity residual solves, seconds) and the
incremental retrain path (masked coordinate-descent re-solves over the
combined history, minutes).  When the conductor publishes an
incremental version, any entity that the nearline tier touched since
the base AND that appears in the delta's touched set has two candidate
rows.  Somebody has to win, and the loser has to stay auditable.

The rule here is **retrain-wins-touched**: for every entity in the
delta's touched set, the masked re-solve wins.  Rationale: the masked
solve optimizes the full objective over the entity's complete combined
history, while a nearline solve is a residual mini-batch update over a
handful of recent events — strictly less evidence.  Nearline rows for
entities OUTSIDE the touched set are not carried either, because the
incremental fit warm-starts from the *base checkpoint*, not from the
nearline-published model; those entities keep their base rows
bit-identically (that invariant is what makes masked retrains cheap to
verify).  The nearline tier immediately resumes layering fresh events
on top of the newly served version, so its updates are superseded, not
lost.

Auditability: the superseded nearline version stays in the registry
with its ``nearline_seq`` / ``nearline_base_version`` metadata, and the
decision record produced here is embedded in the incremental version's
lineage (``lineage["reconciliation"]``), naming the superseded version
and sequence number.  ``/healthz`` serves the lineage of whatever
version the engine runs, so the decision round-trips to operators.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

from photon_ml_tpu_torch.data.model_store import load_game_model_metadata
from photon_ml_tpu_torch.serving.registry import scan_versions

RECONCILE_RULE = "retrain-wins-touched"

__all__ = [
    "RECONCILE_RULE",
    "newest_version_metadata",
    "reconcile_nearline",
]


def newest_version_metadata(
    registry_dir: str,
) -> Tuple[Optional[str], Optional[Dict[str, Any]]]:
    """Return ``(version_name, metadata)`` for the newest registry
    version, or ``(None, None)`` when the registry is empty or absent.

    An unreadable newest version (mid-publish crash debris that escaped
    the atomic-rename protocol, manual tampering) degrades to
    ``(name, None)`` rather than raising: the conductor must keep
    cycling past a corrupt tail, not wedge on it.
    """
    if not registry_dir or not os.path.isdir(registry_dir):
        return None, None
    versions = scan_versions(registry_dir)
    if not versions:
        return None, None
    _, path = versions[-1]
    name = os.path.basename(path)
    try:
        meta = load_game_model_metadata(path)
    except (OSError, ValueError, KeyError):
        return name, None
    return name, meta


def reconcile_nearline(registry_dir: str, delta_scan: Any) -> Dict[str, Any]:
    """Build the reconciliation decision record for one conductor cycle.

    ``delta_scan`` is the :class:`DeltaScan` for the cycle's delta.  The
    record is embedded verbatim into the published version's lineage so
    the decision is auditable from the registry alone.  A record is
    produced every cycle — ``nearline_version`` is ``None`` when the
    newest registry version carries no nearline metadata — so consumers
    never have to distinguish "no decision recorded" from "nothing to
    reconcile".
    """
    name, meta = newest_version_metadata(registry_dir)
    extra = (meta or {}).get("extra") or {}
    decision: Dict[str, Any] = {
        "rule": RECONCILE_RULE,
        "nearline_version": None,
        "nearline_seq": None,
        "nearline_base_version": None,
        "touched_count": sum(
            c.touched_count for c in getattr(delta_scan, "coordinates", {}).values()
        ),
    }
    if name is not None and extra.get("nearline_seq"):
        decision["nearline_version"] = name
        decision["nearline_seq"] = int(extra["nearline_seq"])
        base = extra.get("nearline_base_version")
        decision["nearline_base_version"] = (
            str(base) if base is not None else None
        )
    return decision
