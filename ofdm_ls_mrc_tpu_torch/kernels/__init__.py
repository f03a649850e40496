"""Build and load of the CUDA kernels in ``csrc/`` (see ``build.py``)."""
