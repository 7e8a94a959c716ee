"""Measurement tools of the port (counterpart of the repository's ``tools/``)."""
