"""Utilities of the port: the phase timer (``timing.py``)."""
