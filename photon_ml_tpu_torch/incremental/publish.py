"""Registry publishing with lineage: a served version names its training
ancestor.

Counterpart of ``photon_ml_tpu/incremental/publish.py``. Every version
published here carries a ``lineage`` block in its ``model-metadata.json``:

    {"lineage": {"base_version": "v-00000003",
                 "warm_start_checkpoint": "/ckpt/base",
                 "base_kind": "step", "base_step": 1,
                 "base_digest": "sha256...",
                 "delta_digest": "sha256...",
                 "delta_rows": 50000, "touched_fraction": 0.05}}

``serving.registry.publish_version(lineage=...)`` stores it (through the
quality gate when ``quality`` is given), ``ScoringEngine`` loads it and the
server's ``/healthz`` serves it.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

from photon_ml_tpu_torch import faults, telemetry

# fires before the registry version is assembled: a kill here (or anywhere
# in publish_version's tmp-then-rename) leaves no partial version and the
# warm-start base untouched
FP_PUBLISH = faults.register_point(
    "incremental.publish",
    description="before an incremental retrain assembles its registry "
    "version (tmp-then-rename; a kill leaves no partial version)",
)


class StaleDeltaError(ValueError):
    """A delta whose digest the newest published version already trained
    on: publishing it again would add a version with nothing new (a stuck
    cron job). ``--force`` republishes on purpose."""


def check_delta_freshness(registry_dir: str, delta_digest: str, force: bool = False) -> None:
    """Raise ``StaleDeltaError`` when ``delta_digest`` is the
    ``lineage.delta_digest`` of the newest version in ``registry_dir``
    (unless ``force``). An absent or empty registry, or a newest version
    without a delta in its lineage, passes."""
    if force or not registry_dir or not os.path.isdir(registry_dir):
        return
    from photon_ml_tpu_torch.data.model_store import load_game_model_metadata
    from photon_ml_tpu_torch.serving.registry import scan_versions

    versions = scan_versions(registry_dir)
    if not versions:
        return
    _, path = versions[-1]
    try:
        meta = load_game_model_metadata(path)
    except (OSError, ValueError, KeyError):
        return  # unreadable metadata cannot prove staleness
    recorded = ((meta.get("extra") or {}).get("lineage") or {}).get("delta_digest")
    if recorded is not None and recorded == delta_digest:
        raise StaleDeltaError(
            f"delta digest {delta_digest[:16]}... matches the digest already published as "
            f"{os.path.basename(path)} in {registry_dir} — re-running on an unchanged delta "
            "would publish a no-op version; pass --force to republish anyway")


def lineage_record(lineage, delta=None, base_version: Optional[str] = None,
                   reconciliation: Optional[dict] = None) -> dict:
    """The JSON-safe lineage block of a version's metadata."""
    out: dict = {"warm_start_checkpoint": lineage.checkpoint_dir, "base_kind": lineage.kind}
    if base_version is not None:
        out["base_version"] = base_version
    if lineage.step is not None:
        out["base_step"] = int(lineage.step)
    if lineage.next_chunk is not None:
        out["base_next_chunk"] = int(lineage.next_chunk)
    if lineage.digest is not None:
        out["base_digest"] = lineage.digest
    if delta is not None:
        out["delta_digest"] = delta.digest
        out["delta_rows"] = int(delta.delta_rows)
        out["delta_paths"] = list(delta.paths)
        fractions = [c.touched_fraction for c in delta.coordinates.values()]
        if fractions:
            out["touched_fraction"] = round(max(fractions), 6)
    if reconciliation is not None:
        out["reconciliation"] = dict(reconciliation)
    return out


def publish_incremental(registry_dir: str, model, index_maps: Mapping, lineage, delta=None,
                        base_version: Optional[str] = None,
                        extra_metadata: Optional[dict] = None, selection=None,
                        reconciliation: Optional[dict] = None,
                        quality: Optional[dict] = None, gate_override: bool = False) -> str:
    """Publish an incremental retrain's model as the registry's next version,
    atomically, its lineage in the metadata; returns the version's path.
    ``base_version`` names the version the base was serving as, when known;
    ``selection`` (the local λ sweep's ``SweepSelection``) is recorded as
    the sweep exporter records it; ``quality`` / ``gate_override`` arm the
    champion/challenger gate of ``publish_version``, whose refusal raises
    ``QualityGateRefused`` with the candidate in quarantine."""
    from photon_ml_tpu_torch.serving.registry import publish_version

    faults.fault_point(FP_PUBLISH)
    meta = dict(extra_metadata or {})
    if selection is not None:
        meta["sweep_selection"] = selection.to_json()
    path = publish_version(
        registry_dir, model, index_maps, extra_metadata=meta,
        lineage=lineage_record(lineage, delta=delta, base_version=base_version,
                               reconciliation=reconciliation),
        quality=quality, gate_override=gate_override)
    telemetry.counter("incremental.published_versions").inc()
    return path
