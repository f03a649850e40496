"""Synthetic channel and constellations (hardware stand-ins).

The port's own copy of ``ofdm_ls_mrc_tpu.sim.channel``; tests hold the two
equal.  PN frame sync comes with the correlation slice.
"""

from .channel import (
    CONSTELLATIONS,
    ChannelModel,
    demap_symbols,
    evm_db,
    make_tx_frame,
    map_symbols,
    random_symbols,
)

__all__ = [
    "CONSTELLATIONS",
    "ChannelModel",
    "demap_symbols",
    "evm_db",
    "make_tx_frame",
    "map_symbols",
    "random_symbols",
]
