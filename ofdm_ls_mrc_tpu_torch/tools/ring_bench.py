"""Shared-memory ring ingest throughput: producer process -> consumer process
(the port's counterpart of the repo's ``tools/ring_bench.py``, whose flags
and JSON lines it keeps), on the port's ``io/ring.py``.

The ingest side of the real-time budget: how fast symbols move through the
POSIX shm ring, the consumer-side CP drop and planar deinterleave included
(and the sc16 -> float conversion with ``--dtype sc16``, none with
``--i16``).  The reference's analogue is its per-symbol read timer
(ShMemSymBuff.hpp:150).  Prints one JSON line,
``ring_symbols_per_sec[<dtype>]``; ``--decompose`` instead times the
write leg and the read leg apart in one process,
``ring_leg_us_per_symbol[<dtype>]``.

Host-only by nature: the ring lives in host memory and no byte of it
reaches the card here, so the tool takes no ``--device``.

Run:  python -m ofdm_ls_mrc_tpu_torch.tools.ring_bench --antennas 16 --fft 1024 --cp 72 --dtype sc16 --batch --i16
      python -m ofdm_ls_mrc_tpu_torch.tools.ring_bench --dtype sc16 --batch --i16 --decompose
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time
import uuid

import numpy as np

from ..io.ring import SymbolRing


def _symbol(rows: int, cols: int, dtype: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if dtype == "sc16":
        return rng.integers(-30000, 30000, size=(rows, 2 * cols), dtype=np.int16)
    return (rng.standard_normal((rows, cols))
            + 1j * rng.standard_normal((rows, cols))).astype(np.complex64)


def _producer(uid, rows, cols, length, n, dtype, batch_write):
    w = SymbolRing(uid, rows, cols, length, master=True, timeout=60.0, dtype=dtype)
    sym = _symbol(rows, cols, dtype)
    if batch_write:
        # One native call per frame-sized burst (rx_app's writer shape).
        chunk = np.ascontiguousarray(np.broadcast_to(sym, (length - 1,) + sym.shape))
        left = n
        while left > 0:
            m = min(left, length - 1)
            w.write_batch(chunk[:m], wait=True, timeout=60.0)
            left -= m
    else:
        for _ in range(n):
            w.write(sym, wait=True, timeout=60.0)
    w.wait_drained(60.0)
    w.close()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--fft", type=int, default=1024)
    ap.add_argument("--cp", type=int, default=72)
    ap.add_argument("--len", type=int, default=101, dest="length")
    ap.add_argument("--symbols", type=int, default=20000)
    ap.add_argument("--dtype", default="complex64", choices=["complex64", "sc16"])
    ap.add_argument("--batch", action="store_true",
                    help="consume via the one-call-per-frame batch read")
    ap.add_argument("--i16", action="store_true",
                    help="sc16-native consumer: planar int16 copy-out without float "
                         "conversion (read_frame_planar_i16; requires --dtype sc16 and "
                         "--batch)")
    ap.add_argument("--batch-write", action="store_true",
                    help="producer writes frame-sized bursts via the one-call "
                         "write_batch (the rx_app writer shape)")
    ap.add_argument("--decompose", action="store_true",
                    help="single-process write-leg/read-leg split instead of the "
                         "concurrent end-to-end number")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.i16 and (args.dtype != "sc16" or not args.batch):
        raise SystemExit("--i16 requires --dtype sc16 --batch")
    if args.decompose:
        return _decompose(args)

    cols = args.fft + args.cp
    uid = f"/ringbench_{uuid.uuid4().hex[:8]}"
    p = mp.get_context("spawn").Process(target=_producer, args=(
        uid, args.antennas, cols, args.length, args.symbols, args.dtype, args.batch_write))
    p.start()
    try:
        r = SymbolRing(uid, args.antennas, cols, args.length, master=False, timeout=60.0,
                       dtype=args.dtype)
        # Warm both sides, then time steady-state reads.
        r.read_next_planar(cp=args.cp)
        n_timed = args.symbols - 1
        t0 = time.perf_counter()
        if args.batch:
            keep = cols - args.cp
            bre = np.empty((args.length, args.antennas, keep),
                           np.int16 if args.i16 else np.float32)
            bim = np.empty_like(bre)
            read = r.read_frame_planar_i16 if args.i16 else r.read_frame_planar
            left = n_timed
            while left > 0:
                chunk = min(left, args.length)
                read(chunk, cp=args.cp, out_re=bre[:chunk], out_im=bim[:chunk])
                left -= chunk
        else:
            for _ in range(n_timed):
                r.read_next_planar(cp=args.cp)
        dt = time.perf_counter() - t0
        p.join(timeout=60)
        r.close()
    finally:
        if p.is_alive():
            p.kill()
            p.join()

    sps = (args.symbols - 1) / dt
    elem = 4 if args.dtype == "sc16" else 8
    print(json.dumps({
        "metric": f"ring_symbols_per_sec[{args.dtype}]",
        "value": round(sps, 1),
        "unit": "symbols/s",
        "shm_GB_per_s": round(sps * args.antennas * cols * elem / 1e9, 2),
        "geometry": f"{args.antennas}x{cols}x{args.length}",
    }))
    return 0


def _decompose(args) -> int:
    """Alternate fill/drain passes over one ring in one process, timing the
    write leg (per symbol and as one batch) and the preallocated batch-read
    leg apart (steady state: the last of four passes, after the shm pages
    and buffers are warm).  The end-to-end ``--batch`` number minus these
    legs is producer/consumer contention."""
    cols = args.fft + args.cp
    keep = cols - args.cp
    uid = f"/ringdec_{uuid.uuid4().hex[:8]}"
    w = SymbolRing(uid, args.antennas, cols, args.length, master=True, timeout=60.0,
                   dtype=args.dtype)
    r = SymbolRing(uid, args.antennas, cols, args.length, master=False, timeout=60.0,
                   dtype=args.dtype)
    sym = _symbol(args.antennas, cols, args.dtype)
    n = args.length - 1  # leave one slot free: wait-mode writes never block
    bre = np.empty((n, args.antennas, keep), np.int16 if args.i16 else np.float32)
    bim = np.empty_like(bre)
    read = r.read_frame_planar_i16 if args.i16 else r.read_frame_planar
    batch = np.ascontiguousarray(np.broadcast_to(sym, (n,) + sym.shape))
    tw = twb = tr = None
    for _ in range(4):
        t0 = time.perf_counter()
        for _ in range(n):
            w.write(sym, wait=True, timeout=60.0)
        tw = (time.perf_counter() - t0) / n
        read(n, cp=args.cp, out_re=bre, out_im=bim)  # drain
        t0 = time.perf_counter()
        w.write_batch(batch, wait=True, timeout=60.0)
        twb = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        read(n, cp=args.cp, out_re=bre, out_im=bim)
        tr = (time.perf_counter() - t0) / n
    r.close()
    w.close()
    sz = args.antennas * cols * (4 if args.dtype == "sc16" else 8)
    print(json.dumps({
        "metric": f"ring_leg_us_per_symbol[{args.dtype}]",
        "write_us": round(tw * 1e6, 1),
        "write_batch_us": round(twb * 1e6, 1),
        "read_prealloc_us": round(tr * 1e6, 1),
        "write_GB_per_s": round(sz / tw / 1e9, 2),
        "write_batch_GB_per_s": round(sz / twb / 1e9, 2),
        "read_GB_per_s": round(sz / tr / 1e9, 2),
        "geometry": f"{args.antennas}x{cols}x{args.length}",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
