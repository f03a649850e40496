"""Utilities of the port: the phase timer (``timing.py``) and the profiler
reading (``profiling.py``)."""
