"""Host I/O of the port: receiver state persistence (``state.py``)."""
