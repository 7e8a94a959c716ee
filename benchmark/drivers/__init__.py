"""One driver a kind of entry: ``prepare(bench)`` returns a session whose
``call()`` is one timed call of the entry (``harness.py``)."""
