"""Date-range input path expansion.

Counterpart of ``photon_ml_tpu/data/paths.py`` (:17-93): training inputs
laid out as daily directories ``root/yyyy/MM/dd``, selected by a
"yyyymmdd-yyyymmdd" range or a "start-end" days-ago pair. Missing days are
skipped unless ``error_on_missing``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence


def parse_date_range(spec: str) -> tuple[datetime.date, datetime.date]:
    """Parse "yyyymmdd-yyyymmdd"."""
    try:
        start_s, end_s = spec.split("-")
        start = datetime.datetime.strptime(start_s, "%Y%m%d").date()
        end = datetime.datetime.strptime(end_s, "%Y%m%d").date()
    except ValueError as e:
        raise ValueError(f"bad date range '{spec}' (want yyyymmdd-yyyymmdd)") from e
    if start > end:
        raise ValueError(f"invalid range: start {start} after end {end}")
    return start, end


def parse_days_ago(spec: str, today: Optional[datetime.date] = None
                   ) -> tuple[datetime.date, datetime.date]:
    """Parse "start-end" days ago: "90-1" is from 90 days ago through
    yesterday."""
    today = today or datetime.date.today()
    try:
        start_ago_s, end_ago_s = spec.split("-")
        start_ago, end_ago = int(start_ago_s), int(end_ago_s)
    except ValueError as e:
        raise ValueError(f"bad days-ago range '{spec}' (want e.g. 90-1)") from e
    start = today - datetime.timedelta(days=start_ago)
    end = today - datetime.timedelta(days=end_ago)
    if start > end:
        raise ValueError(f"invalid range: {spec} starts after it ends")
    return start, end


def daily_paths(root: str, start: datetime.date, end: datetime.date,
                error_on_missing: bool = False) -> list[str]:
    """The existing ``root/yyyy/MM/dd`` directories within [start, end]."""
    out = []
    day = start
    while day <= end:
        p = os.path.join(root, f"{day.year:04d}", f"{day.month:02d}", f"{day.day:02d}")
        if os.path.isdir(p):
            out.append(p)
        elif error_on_missing:
            raise FileNotFoundError(f"missing daily input dir {p}")
        day += datetime.timedelta(days=1)
    return out


def expand_input_paths(
    paths: Sequence[str],
    date_range: Optional[str] = None,
    date_range_days_ago: Optional[str] = None,
    error_on_missing: bool = False,
    today: Optional[datetime.date] = None,
) -> list[str]:
    """Input roots expanded by an optional date range; without one the paths
    pass through unchanged."""
    if date_range and date_range_days_ago:
        raise ValueError("give date_range OR date_range_days_ago, not both")
    if not date_range and not date_range_days_ago:
        return list(paths)
    if date_range:
        start, end = parse_date_range(date_range)
    else:
        start, end = parse_days_ago(date_range_days_ago, today=today)
    out: list[str] = []
    for root in paths:
        out.extend(daily_paths(root, start, end, error_on_missing))
    if not out:
        raise FileNotFoundError(f"no daily input dirs under {list(paths)} in [{start}, {end}]")
    return out
