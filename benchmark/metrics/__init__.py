"""One reader a per-layer metric, ``<metric>.py`` with ``read(ctx)``.

``ctx`` is ``harness.Window``: the traced window's calls and seconds, the
device trace, the program's counters, and the cell's session. A reader
that finds nothing to read returns None, and the metric is left out.
"""
