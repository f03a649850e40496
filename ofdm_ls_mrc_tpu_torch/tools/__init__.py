"""Command-line tools of the port (run with ``python -m``): ``dma_probe``
(the card's io floor), ``gate`` (the accuracy gate), ``accuracy_sweep``
(every demod body against the golden), ``latency_probe`` (per-symbol
latency of the streaming bodies), ``waterfall`` (EVM and SER against SNR),
``ring_bench`` (the shm ring's host legs), ``soak`` (the three processes
under pressure), ``scaling_bench`` (the sharded receiver over ranks and its
collective structure) and ``call_cost.py``; ``ranks`` starts a tool's
ranks as processes."""
