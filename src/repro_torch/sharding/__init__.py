"""Logical-axis sharding specs (``spec.py``)."""
