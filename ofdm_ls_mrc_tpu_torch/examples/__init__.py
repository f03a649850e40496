"""Runnable entry points into each layer of the port (``python -m
ofdm_ls_mrc_tpu_torch.examples.<name>``): ``loopback_demod``,
``ring_pipeline``, ``sharded_mesh`` and ``downlink_zf``.  Importing one runs
nothing."""
