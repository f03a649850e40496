"""SNR waterfall: EVM and symbol-error-rate curves of the full receiver
chain (the port's counterpart of the repo's ``tools/waterfall.py``, whose
seeds, fields and checks it keeps).

Sweeps Es/N0 through the synthetic multipath channel (``sim/channel.py``)
and, at each point, scores every selected pipeline (the NumPy golden and
the port's ``UplinkReceiver`` under 'fused', 'fast' and 'composed') on

  * post-MRC EVM (dB) against the sent constellation grid, and
  * the hard-decision symbol error rate,

then holds the measured SER beside the closed-form AWGN SER at the
measured post-combining SNR (1/EVM) of each (realization, bin).  'fast'
runs ``fft_impl="four_step"`` (on the library FFT it would be 'composed').

Prints one line a point and a JSON summary line; ``--out FILE`` also
writes the whole record (there is no default file).  ``--fail-above-db DB``
exits 1 when the pipelines disagree by more than DB at any point.

Run:  python -m ofdm_ls_mrc_tpu_torch.tools.waterfall                    # on the card
      python -m ofdm_ls_mrc_tpu_torch.tools.waterfall --scheme 64qam --snrs 10,15,20,25,30 \\
          --seeds 1 --pipelines golden,fused,fast,composed --fail-above-db 0.5
      python -m ofdm_ls_mrc_tpu_torch.tools.waterfall --device cpu --antennas 4 --fft 64 --symbols 9 --cp 8
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

PIPELINES = ("golden", "fast", "fused", "composed")


def _erfc_np(x):
    # scipy may be absent; math.erfc on a vectorized view is exact and cheap
    return np.vectorize(math.erfc)(np.asarray(x, dtype=np.float64))


def ser_awgn(snr_lin: np.ndarray, scheme: str) -> np.ndarray:
    """Closed-form symbol error rate on AWGN at Es/N0 = snr_lin.

    QPSK:  Ps = erfc(sqrt(rho/2)) - erfc^2(sqrt(rho/2))/4
    M-QAM: Ps = 1 - (1 - Pr)^2,  Pr = (1-1/sqrt(M)) erfc(sqrt(3 rho/(2(M-1))))
    (per-rail independence of square QAM; standard results.)
    """
    rho = np.maximum(np.asarray(snr_lin, dtype=np.float64), 0.0)
    if scheme == "qpsk":
        e = _erfc_np(np.sqrt(rho / 2.0))
        return e - e * e / 4.0
    m = {"16qam": 16, "64qam": 64}[scheme]
    pr = (1.0 - 1.0 / math.sqrt(m)) * _erfc_np(np.sqrt(3.0 * rho / (2.0 * (m - 1))))
    return 1.0 - (1.0 - pr) ** 2


def _demod(pipeline, rx_frame, pilot, cp, receivers):
    """One received frame through the named pipeline -> [S-1, F-1]
    complex64 in the reference output layout."""
    from ..golden import dsp

    if pipeline == "golden":
        return dsp.demod_frame(rx_frame, pilot, cp)
    return receivers[pipeline].demod_frame(rx_frame).to_numpy()


def run_sweep(antennas: int, fft: int, symbols: int, cp: int, scheme: str,
              snrs, seeds: int, pipelines, num_taps: int = 8,
              progress=None, device="cuda") -> dict:
    from ..config import FrameConfig
    from ..models import UplinkReceiver
    from ..sim import ChannelModel, demap_symbols, make_tx_frame, random_symbols

    cfg = FrameConfig(num_antennas=antennas, fft_size=fft, cyclic_prefix=cp,
                      frame_len=symbols)
    rng = np.random.default_rng(2019)  # ICNC 2019
    pilot = np.exp(2j * np.pi * rng.random(fft - 1)).astype(np.complex64)
    receivers = {p: UplinkReceiver(cfg, pilot, pipeline=p,
                                   fft_impl="four_step" if p == "fast" else None, device=device)
                 for p in pipelines if p != "golden"}

    rows = []
    worst_gap_db = 0.0
    for snr_db in snrs:
        # The channel is frequency selective and re-drawn per seed, so the
        # post-MRC SNR differs per (realization, bin); SER is convex in SNR,
        # so theory is evaluated at each operating point and averaged.
        evm_total = {p: 0.0 for p in pipelines}
        ser_theory = {p: 0.0 for p in pipelines}
        sym_errors = {p: 0 for p in pipelines}
        n_syms = 0
        for seed in range(seeds):
            data, idx = random_symbols(
                np.random.default_rng(1000 + seed), (symbols - 1, fft - 1), scheme)
            tx = make_tx_frame(data, pilot, cp)
            chan = ChannelModel(num_antennas=antennas, fft_size=fft, num_taps=num_taps,
                                snr_db=float(snr_db), seed=100 + seed)
            rx_frame = chan.apply(tx, cp)
            sig_bin = np.mean(np.abs(data) ** 2, axis=0)
            n_syms += idx.size
            for p in pipelines:
                out = _demod(p, rx_frame, pilot, cp, receivers)
                # The output layout carries the final fftshift (cpuLS.hpp:368);
                # undo it to compare on natural bins.
                nat = np.fft.fftshift(out, axes=-1)
                evm_bin = (np.mean(np.abs(nat - data) ** 2, axis=0)
                           / np.maximum(sig_bin, 1e-30))
                evm_total[p] += float(np.mean(evm_bin))
                ser_theory[p] += float(np.mean(ser_awgn(
                    1.0 / np.maximum(evm_bin, 1e-30), scheme)))
                sym_errors[p] += int(np.sum(demap_symbols(nat, scheme) != idx))
        row = {"snr_db": float(snr_db), "n_syms": n_syms}
        for p in pipelines:
            evm = 10.0 * math.log10(evm_total[p] / seeds + 1e-30)
            row[f"evm_db_{p}"] = round(evm, 2)
            row[f"ser_{p}"] = sym_errors[p] / n_syms
            row[f"ser_theory_{p}"] = ser_theory[p] / seeds
        evms = [row[f"evm_db_{p}"] for p in pipelines]
        worst_gap_db = max(worst_gap_db, max(evms) - min(evms))
        rows.append(row)
        if progress:
            progress(row)

    return {
        "metric": "snr_waterfall",
        "scheme": scheme,
        "config": {"antennas": antennas, "fft": fft, "symbols": symbols,
                   "cp": cp, "num_taps": num_taps, "seeds": seeds},
        "pipelines": list(pipelines),
        # What each requested pipeline resolved to (rx.pipeline).
        "effective_pipelines": {p: (receivers[p].pipeline if p in receivers else p)
                                for p in pipelines},
        "pipelines_agree_db": round(worst_gap_db, 3),
        "device": str(device),
        "note": ("ser_theory is the closed-form AWGN SER at the measured "
                 "per-(realization,bin) post-MRC EVM. Measured SER sits "
                 "ABOVE it when LS-estimate error dominates at low SNR "
                 "(the error is one fixed multiplicative perturbation per "
                 "bin, not fresh noise) and BELOW it at high antenna "
                 "counts/mid SNR (a fixed small rotation produces no "
                 "symbol errors until it exceeds the angular margin)."),
        "rows": rows,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--fft", type=int, default=1024)
    ap.add_argument("--symbols", type=int, default=101)
    ap.add_argument("--cp", type=int, default=72)
    ap.add_argument("--num-taps", type=int, default=8)
    ap.add_argument("--scheme", choices=("qpsk", "16qam", "64qam"), default="qpsk")
    ap.add_argument("--snrs", default="-10,-5,0,5,10,15,20",
                    help="comma-separated Es/N0 points in dB (pre-combining, per antenna)")
    ap.add_argument("--seeds", type=int, default=3,
                    help="channel/noise realizations averaged per point")
    ap.add_argument("--pipelines", default="golden,fast",
                    help="comma list of golden,fast,fused,composed")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the whole record to FILE (no default)")
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or 'cpu'")
    ap.add_argument("--fail-above-db", type=float, default=None, metavar="DB",
                    help="exit nonzero when pipelines disagree by more than DB at any "
                         "operating point")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    snrs = [float(s) for s in args.snrs.split(",") if s]
    pipelines = [p for p in args.pipelines.split(",") if p]
    for p in pipelines:
        if p not in PIPELINES:
            raise SystemExit(f"unknown pipeline {p!r}")

    from ..ops.cplx import resolve_device
    from ..utils import profiling

    device = resolve_device(args.device, "waterfall")

    def progress(row):
        parts = " ".join(
            f"{p}: {row[f'evm_db_{p}']:+.2f} dB ser {row[f'ser_{p}']:.2e} "
            f"(theory {row[f'ser_theory_{p}']:.2e})" for p in pipelines)
        print(f"[waterfall] snr {row['snr_db']:+5.1f} dB  {parts}", flush=True)

    profiling.reset_kernel_launches()
    result = run_sweep(args.antennas, args.fft, args.symbols, args.cp, args.scheme, snrs,
                       args.seeds, pipelines, num_taps=args.num_taps, progress=progress,
                       device=device)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
            fh.write("\n")
    print(profiling.LAUNCH_LINE + json.dumps(profiling.kernel_launches()))
    print(json.dumps({"metric": "snr_waterfall", "scheme": result["scheme"],
                      "points": len(result["rows"]),
                      "pipelines_agree_db": result["pipelines_agree_db"],
                      "effective_pipelines": result["effective_pipelines"],
                      "out": args.out}))
    if args.fail_above_db is not None and result["pipelines_agree_db"] > args.fail_above_db:
        print(f"[waterfall] FAIL: pipelines disagree by {result['pipelines_agree_db']} dB "
              f"(> {args.fail_above_db})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
