"""Producer/consumer shared-memory ring: the reference's runtime topology
(the port's counterpart of the repo's ``examples/02_ring_pipeline.py``,
whose geometry, seeds, lines and threshold it keeps).

Spawns a producer process (the rx_and_corr.cpp role: strips the cyclic
prefix and writes symbols into the POSIX shm ring) and consumes them in
this process through ``RingFeed`` -> ``UplinkReceiver`` (the cpuLS_main.cpp
/ gpuLS_main.cu role): master/slave attach, the native CP drop and planar
deinterleave on copy-out, the double-buffered reader thread, the pinned
host frames and their copy to the card, and a clean drain/shutdown.

  python -m ofdm_ls_mrc_tpu_torch.examples.ring_pipeline [--device cpu]
"""

import argparse
import json
import multiprocessing as mp
import os
import sys
import tempfile
import uuid

import numpy as np


def tx_grid(frame_idx: int, cfg, scheme="qpsk"):
    """Deterministic per-frame TX grid, so producer and consumer agree on
    the sent data without sharing state (frame identity is not on the
    wire, as in the reference)."""
    from ofdm_ls_mrc_tpu_torch.sim import random_symbols

    return random_symbols(np.random.default_rng(5000 + frame_idx),
                          (cfg.num_data_symbols, cfg.num_subcarriers), scheme)[0]


def produce(uid: str, pilot_path: str, frames: int, seed: int, snr_db: float) -> None:
    """Producer process: synthesize frames and write them a frame-sized
    burst at a time, like the RX app's writer thread (rx_and_corr.cpp:64-87)."""
    from ofdm_ls_mrc_tpu_torch import FrameConfig
    from ofdm_ls_mrc_tpu_torch.io.ring import SymbolRing
    from ofdm_ls_mrc_tpu_torch.sim import ChannelModel, make_tx_frame

    cfg = FrameConfig(num_antennas=4, fft_size=256, cyclic_prefix=32, frame_len=9)
    rng = np.random.default_rng(seed)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    np.save(pilot_path, pilot)
    chan = ChannelModel(cfg.num_antennas, cfg.fft_size, num_taps=8, snr_db=snr_db, seed=seed)
    # The master creates the segment; the writer strips the CP before the
    # ring (rx_and_corr.cpp:71-84), so slots hold CP-free [A, F] symbols.
    with SymbolRing(uid, cfg.num_antennas, cfg.fft_size, length=32, master=True,
                    timeout=30.0) as ring:
        for i in range(frames):
            rx = chan.apply(make_tx_frame(tx_grid(i, cfg), pilot, cfg.cyclic_prefix),
                            cfg.cyclic_prefix)      # [S, A, F+cp]
            ring.write_batch(np.ascontiguousarray(rx[:, :, cfg.cyclic_prefix:]))
        ring.wait_drained(timeout=30.0)
        ring.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or 'cpu'")
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)

    from ofdm_ls_mrc_tpu_torch import FrameConfig
    from ofdm_ls_mrc_tpu_torch.io.feed import RingFeed
    from ofdm_ls_mrc_tpu_torch.io.ring import SymbolRing
    from ofdm_ls_mrc_tpu_torch.models import UplinkReceiver
    from ofdm_ls_mrc_tpu_torch.ops.cplx import resolve_device
    from ofdm_ls_mrc_tpu_torch.sim import evm_db
    from ofdm_ls_mrc_tpu_torch.utils import profiling

    device = resolve_device(args.device, "ring_pipeline")
    # Unique per run: concurrent runs must not attach to each other's
    # segment or pilot file.
    tag = uuid.uuid4().hex[:8]
    ring_uid = f"/ofdm_example_{tag}"
    pilot_path = os.path.join(tempfile.gettempdir(), f"ofdm_example_pilot_{tag}.npy")
    proc = mp.get_context("spawn").Process(
        target=produce, args=(ring_uid, pilot_path, args.frames, 11, 28.0), daemon=True)
    proc.start()

    # Ring symbols are already CP-free, so the receiver runs cyclic_prefix=0
    # (the demod processes' own geometry, ShMemSymBuff.hpp:46 prefix=0).
    cfg = FrameConfig(num_antennas=4, fft_size=256, cyclic_prefix=0, frame_len=9)
    profiling.reset_kernel_launches()
    try:
        # The slave attaches to the producer's segment (cpuLS_main.cpp:76).
        with SymbolRing(ring_uid, cfg.num_antennas, cfg.symbol_len, length=32, master=False,
                        timeout=30.0) as ring:
            feed = RingFeed(ring, cfg, device=device)  # reader thread + rotating host frames
            rx = None
            got, worst_evm = 0, -1000.0
            for frame in feed.frames(max_frames=args.frames):   # CArray on the device
                if rx is None:
                    rx = UplinkReceiver(cfg, np.load(pilot_path), device=device)
                out = rx.demod_frame(frame).to_numpy()
                evm = evm_db(np.fft.fftshift(out, axes=-1), tx_grid(got, cfg))
                worst_evm = max(worst_evm, evm)
                got += 1
                print(f"frame {got}: {out.shape[0]} symbols, EVM {evm:.1f} dB")
            feed.stop()
            print(ring.info())
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
        if os.path.exists(pilot_path):
            os.unlink(pilot_path)
    print(profiling.LAUNCH_LINE + json.dumps(profiling.kernel_launches()))
    ok = got == args.frames and worst_evm < -25.0
    print("OK" if ok else f"FAIL: {got}/{args.frames} frames")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
