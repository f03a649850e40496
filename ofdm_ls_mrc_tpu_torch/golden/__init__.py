"""Golden NumPy oracle for the OFDM LS+MRC chain (reference: cpuLS.hpp).

The port's own copy of ``ofdm_ls_mrc_tpu.golden``; tests hold the two equal.
"""

from .dsp import (
    PILOT_FILL,
    add_cyclic_prefix,
    apply_precoder,
    demod_frame,
    demod_symbol,
    drop_cyclic_prefix,
    estimate_channel,
    modulate_pilot_symbol,
    modulate_symbol,
    output_shift,
    pilot_shift,
    rot_cube,
    tx_shift,
    zf_precoder,
)
from .io import (
    append_output,
    load_pilot,
    load_times,
    read_output,
    store_times,
    write_pilot,
)

__all__ = [
    "PILOT_FILL",
    "add_cyclic_prefix",
    "apply_precoder",
    "append_output",
    "demod_frame",
    "demod_symbol",
    "drop_cyclic_prefix",
    "estimate_channel",
    "load_pilot",
    "load_times",
    "modulate_pilot_symbol",
    "modulate_symbol",
    "output_shift",
    "pilot_shift",
    "read_output",
    "rot_cube",
    "store_times",
    "tx_shift",
    "write_pilot",
    "zf_precoder",
]
