"""Minimal end-to-end demod: synthetic channel -> LS + MRC receiver -> EVM
(the port's counterpart of the repo's ``examples/01_loopback_demod.py``,
whose geometry, seeds, lines and threshold it keeps).

One frame at the reference geometry (16 antennas x 1024-point FFT x 101
symbols, cp 72) of 16-QAM through a 16-tap channel goes through
``UplinkReceiver``: on the card its two CUDA kernels (pipeline 'fused').

  python -m ofdm_ls_mrc_tpu_torch.examples.loopback_demod [--device cpu]
"""

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or 'cpu'")
    ap.add_argument("--snr", type=float, default=25.0)
    args = ap.parse_args(argv)

    from ofdm_ls_mrc_tpu_torch import FrameConfig
    from ofdm_ls_mrc_tpu_torch.models import UplinkReceiver
    from ofdm_ls_mrc_tpu_torch.sim import ChannelModel, evm_db, make_tx_frame, random_symbols
    from ofdm_ls_mrc_tpu_torch.utils import profiling

    # Reference geometry: 16 antennas x 1024-point FFT x 101 symbols
    # (1 pilot + 100 data), 72-sample cyclic prefix (rx_and_corr.cpp:120).
    cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=72, frame_len=101)
    rng = np.random.default_rng(7)

    # TX side: random 16-QAM grid + constant-modulus pilot.
    data, _ = random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers), "16qam")
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    tx = make_tx_frame(data, pilot, cfg.cyclic_prefix)

    # 16-antenna frequency-selective Rayleigh channel + AWGN.
    chan = ChannelModel(cfg.num_antennas, cfg.fft_size, num_taps=16, snr_db=args.snr, seed=9)
    rx_frame = chan.apply(tx, cfg.cyclic_prefix)   # [S, A, F+cp] complex64

    # RX side: one object, one call.
    profiling.reset_kernel_launches()
    rx = UplinkReceiver(cfg, pilot, device=args.device)
    out = rx.demod_frame(rx_frame).to_numpy()      # [S-1, F-1] complex64

    # The output is in the reference's layout (final fftshift applied,
    # cpuLS.hpp:368); undo it to compare against the sent grid.
    evm = evm_db(np.fft.fftshift(out, axes=-1), data)
    print(f"pipeline={rx.pipeline}  EVM={evm:.1f} dB "
          f"(channel SNR {args.snr:.0f} dB + MRC array gain)")
    print(profiling.LAUNCH_LINE + json.dumps(profiling.kernel_launches()))
    ok = evm < -(args.snr)  # array gain must at least beat the channel SNR
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
