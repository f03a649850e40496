"""Multi-user zero-forcing downlink: precode 4 user streams onto 16
antennas (the port's counterpart of the repo's ``examples/04_downlink_zf.py``,
whose geometry, seed, lines and threshold it keeps).

The reference's CPU-only downlink path (createZeroForcingMatrix /
multiplyWithChannelInv, cpuLS.hpp:415-463) as batched per-subcarrier
solves, W = H^H (H H^H)^-1 per bin, on ``DownlinkTransmitter``; verified by
pushing the precoded antenna rows back through the channel: each user must
see only its own stream (inter-user leakage below -25 dB).

  python -m ofdm_ls_mrc_tpu_torch.examples.downlink_zf [--device cpu]
"""

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or 'cpu'")
    ap.add_argument("--users", type=int, default=4)
    ap.add_argument("--antennas", type=int, default=16)
    args = ap.parse_args(argv)

    from ofdm_ls_mrc_tpu_torch import FrameConfig
    from ofdm_ls_mrc_tpu_torch.models import DownlinkTransmitter
    from ofdm_ls_mrc_tpu_torch.sim import evm_db, random_symbols

    u, a = args.users, args.antennas
    cfg = FrameConfig(num_antennas=a, fft_size=256, cyclic_prefix=32, frame_len=9)
    rng = np.random.default_rng(4)
    nsc = cfg.num_subcarriers

    # Downlink channel per subcarrier: [F-1, U, A] (e.g. estimated uplink
    # channels under TDD reciprocity).
    h = (rng.standard_normal((nsc, u, a))
         + 1j * rng.standard_normal((nsc, u, a))).astype(np.complex64)
    user_syms, _ = random_symbols(rng, (u, nsc))

    tx = DownlinkTransmitter(cfg, device=args.device)
    ant_rows = tx.precode(h, user_syms).to_numpy()    # [A, F-1]

    # Verify through the channel: y_u[k] = sum_a H[k,u,a] * x_a[k].
    received = np.einsum("kua,ak->uk", h, ant_rows)
    evm = evm_db(received, user_syms)
    print(f"{u} users x {a} antennas: per-user recovery EVM {evm:.1f} dB")

    # Inter-user leakage: zero one user's stream; its receive port must go
    # quiet while the others are untouched.
    muted = user_syms.copy()
    muted[0] = 0
    ant2 = tx.precode(h, muted).to_numpy()
    rx2 = np.einsum("kua,ak->uk", h, ant2)
    leak = 10 * np.log10(np.mean(np.abs(rx2[0]) ** 2)
                         / np.mean(np.abs(user_syms[0]) ** 2) + 1e-30)
    print(f"muted-user leakage: {leak:.1f} dB")
    ok = evm < -25.0 and leak < -25.0
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
