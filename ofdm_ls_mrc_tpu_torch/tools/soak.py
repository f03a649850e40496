"""One-command sustained-pressure soak of the three-process topology (the
port's counterpart of the repo's ``tools/soak.py``, whose flags, pressure
and verdict it keeps), from the port alone.

The port's ``tx_app`` makes a PN-preambled capture, its ``rx_app`` loops it
as a rate-paced continuous ring producer (no-wait writes, like live RX),
and its ``demod_app`` (on ``--device``) consumes in catch-up mode until the
deadline; then the output is scored per frame against the sent grid through
the frame-provenance index (clean frames gate the EVM bound; best-effort
dirty frames are reported apart).  With ``--num-frames N > 1`` the producer
cycles N distinct frames and each delivered block is scored against its
own sent grid through the index's writer-seq column.

``--distributed N`` splits the capture into N antenna blocks, one
``rx_app`` ring each, and N ``demod_app --distributed`` ranks demodulate in
lockstep on a ``file://`` store over gloo (all ranks on one card or the
CPU: NCCL refuses two ranks a device); rank 0 writes the output and index.

Differences from the JAX tool, both repairs: ``rx_rc`` and ``demod_rc``
report the worst child (a signal, a negative rc, before any other nonzero
rc, and that before 0; the JAX tool's ``max`` reports 0 beside a child
killed by SIGKILL), and the record carries ``clean_fraction`` = clean /
(clean + dirty).  The verdict is the JAX rule: at least ``--min-frames``
clean frames, each within ``--evm-db``, every child exited 0.  The record
also carries the consumer's ``kernel launches``.

Run:  python -m ofdm_ls_mrc_tpu_torch.tools.soak --seconds 30                 # 4x64x9, on the card
      python -m ofdm_ls_mrc_tpu_torch.tools.soak --seconds 120 --antennas 16 --fft-size 1024 \\
          --frame-len 101 --ring-dtype sc16 --sc16-native --rate 4e6
      python -m ofdm_ls_mrc_tpu_torch.tools.soak --device cpu --seconds 3

Prints one JSON line and exits 0 iff the verdict passes (2 on a refused
combination of flags or a failed capture).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
APPS = "ofdm_ls_mrc_tpu_torch.apps"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="producer run time before SIGINT (counted from the first frame)")
    ap.add_argument("--antennas", type=int, default=4)
    ap.add_argument("--fft-size", type=int, default=64)
    ap.add_argument("--cp-size", type=int, default=8)
    ap.add_argument("--frame-len", type=int, default=9)
    ap.add_argument("--rate", default="1e6", help="producer pacing (samples/s; live-RX shape)")
    ap.add_argument("--snr", default="40", help="channel sim SNR (dB)")
    ap.add_argument("--channel-taps", default="4")
    ap.add_argument("--modulation", default="16qam")
    ap.add_argument("--num-frames", type=int, default=1,
                    help="distinct transmitted frames the producer cycles; each delivered "
                         "frame is scored against its own sent grid")
    ap.add_argument("--ring-dtype", default="cf32", choices=["cf32", "sc16"])
    ap.add_argument("--consumer", default="whole-frame", choices=["whole-frame", "per-symbol"],
                    help="whole-frame: catch-up consumer under a no-wait producer (overrun "
                         "pressure); per-symbol: the reference's per-symbol loop under a "
                         "backpressured producer (--wait-writes); requires --num-frames 1")
    ap.add_argument("--continuous-sync", action="store_true",
                    help="producer runs the rolling receive loop with a PN before every "
                         "frame; requires --num-frames 1")
    ap.add_argument("--sc16-native", action="store_true",
                    help="consumer keeps int16 end to end (fused kernels)")
    ap.add_argument("--distributed", type=int, default=0, metavar="N",
                    help="N antenna blocks, one producer ring each, and N demod_app "
                         "--distributed ranks in lockstep; --antennas divisible by N")
    ap.add_argument("--mesh", default=None, metavar="ANTxTIME",
                    help="consumer demodulates on a sharded mesh")
    ap.add_argument("--pipeline", default=None,
                    help="consumer pipeline override (fused/fast/composed)")
    ap.add_argument("--device", default="cuda",
                    help="where demod_app computes: the card (default; raises without "
                         "one) or 'cpu'")
    ap.add_argument("--evm-db", type=float, default=-25.0, help="per-clean-frame EVM bound (dB)")
    ap.add_argument("--min-frames", type=int, default=2, help="fail if fewer clean frames")
    ap.add_argument("--dir", default=None, help="work directory (default: a fresh temp dir)")
    ap.add_argument("--pilots", default="SoakPilots.dat",
                    help="pilot file (missing -> both apps use the same deterministic "
                         "fallback)")
    ap.add_argument("--keep", action="store_true", help="keep the work directory")
    ap.add_argument("--timeout", default="60",
                    help="ring spin deadline passed to both apps; also the warm-start "
                         "deadline")
    return ap


def refusal(args):
    """The message of a refused flag combination, or None."""
    per_symbol = args.consumer == "per-symbol"
    if args.continuous_sync and args.num_frames != 1:
        return ("--continuous-sync requires --num-frames 1 (re-acquisition after the "
                "capture-cycle discontinuity breaks per-frame attribution of distinct "
                "sent grids)")
    if per_symbol and args.num_frames != 1:
        return "--consumer per-symbol requires --num-frames 1 (scoring needs one sent grid)"
    if args.sc16_native and args.ring_dtype != "sc16":
        return "--sc16-native requires --ring-dtype sc16"
    if args.distributed and (per_symbol or args.mesh):
        return ("--distributed composes with the whole-frame consumer "
                "(not --consumer per-symbol/--mesh)")
    if args.distributed and args.antennas % args.distributed:
        return f"--distributed {args.distributed}: {args.antennas} antennas not divisible"
    if per_symbol and args.mesh and args.mesh.lower().split("x")[-1] != "1":
        return ("--consumer per-symbol shards over the ant axis only "
                "(ANTx1 mesh -- parallel/streaming.py)")
    return None


def worst_rc(rcs) -> int:
    """The worst of the children's return codes: a signal (negative) first,
    then any other nonzero code, then 0."""
    rcs = list(rcs)
    signals = [rc for rc in rcs if rc < 0]
    if signals:
        return min(signals)
    return max(rcs, default=0)


def _frame_evm(block: np.ndarray, ref: np.ndarray) -> float:
    got = np.fft.fftshift(block, axes=-1)
    return float(10 * np.log10(np.mean(np.abs(got - ref) ** 2)
                               / np.mean(np.abs(ref) ** 2) + 1e-30))


def score(out_path: str, sent: np.ndarray, fft_size: int, frame_len: int):
    """Per delivered frame, the EVM (dB) against its sent grid, keyed by the
    provenance index next to the output (``<out>.index``: ``seq status lo
    hi [wseq ...]``); returns (clean EVMs, dirty EVMs).

    ``sent`` is [N, frame_len - 1, fft_size - 1]; a line's writer-seq picks
    grid wseq mod N.  A truncated line (a consumer killed mid-write) and a
    block past the rows written are skipped; a line without a writer-seq
    scores against grid 0 when N == 1 and is skipped otherwise.  Without an
    index (N == 1 only) every whole frame of rows counts as clean."""
    f, s = fft_size, frame_len
    nsent = len(sent)
    rows = (np.fromfile(out_path, dtype=np.complex64) if os.path.exists(out_path)
            else np.zeros(0, np.complex64))
    rows = rows[: rows.size // (f - 1) * (f - 1)].reshape(-1, f - 1)
    statuses = []
    try:
        with open(out_path + ".index") as idx:
            statuses = [ln.split() for ln in idx if ln.strip()]
    except OSError:
        pass
    clean, dirty = [], []
    for p in statuses:
        if len(p) < 4:
            continue
        status, lo, hi = p[1], int(p[2]), int(p[3])
        wseq = int(p[4]) if len(p) > 4 else -1
        if lo < 0 or hi > len(rows):
            continue
        if wseq < 0:
            if nsent > 1:
                continue
            wseq = 0
        (clean if status == "clean" else dirty).append(
            _frame_evm(rows[lo:hi], sent[wseq % nsent]))
    if not statuses and len(rows) and nsent == 1:
        clean = [_frame_evm(rows[i:i + s - 1], sent[0])
                 for i in range(0, len(rows) - (s - 2), s - 1)]
    return clean, dirty


def _spawn(mod, args, env, log_base):
    # Logs to files, not pipes: a paced soak can emit thousands of
    # per-event stderr lines (drop notices), and an undrained pipe fills at
    # ~64 KB and wedges the child mid-soak: the verdict would then measure a
    # blocked consumer, not the configured pressure.
    out_f = open(log_base + ".out", "w+")
    err_f = open(log_base + ".err", "w+")
    p = subprocess.Popen([sys.executable, "-m", f"{APPS}.{mod}"] + args, cwd=REPO, env=env,
                         stdout=out_f, stderr=err_f, text=True)
    p.soak_logs = (out_f, err_f)
    return p


def _finish(p, timeout, interrupt=False):
    """Wait for a child (escalating SIGINT -> SIGKILL where ``interrupt``,
    else SIGKILL at the timeout) and return its (stdout, stderr)."""
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        if interrupt:
            p.send_signal(signal.SIGINT)
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        else:
            p.kill()
            p.wait()
    texts = []
    for fh in p.soak_logs:
        fh.flush()
        fh.seek(0)
        texts.append(fh.read())
        fh.close()
    return texts


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    msg = refusal(args)
    if msg:
        print(msg, file=sys.stderr)
        return 2
    from ..ops.cplx import resolve_device
    from ..utils import profiling

    device = str(resolve_device(args.device, "soak"))
    if device.startswith("cuda"):
        from ..kernels import build

        build.load_library()     # once, before the consumers load it
    per_symbol = args.consumer == "per-symbol"
    workdir = args.dir or tempfile.mkdtemp(prefix="ofdm_soak_")
    os.makedirs(workdir, exist_ok=True)
    cap = os.path.join(workdir, "capture.dat")
    sent_path = os.path.join(workdir, "sent.dat")
    out = os.path.join(workdir, "Output_gpu.dat")
    uid = f"/ofdm_soak_{uuid.uuid4().hex[:8]}"
    pp = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO)] + pp)}

    geom = ["--antennas", str(args.antennas), "--fft-size", str(args.fft_size),
            "--cp-size", str(args.cp_size), "--frame-len", str(args.frame_len)]
    sc16 = args.ring_dtype == "sc16"

    # 1. The sent frames; the producer cycles them.
    pn_mode = "--pn-every-frame" if args.continuous_sync else "--pn-preamble"
    tx = subprocess.run(
        [sys.executable, "-m", f"{APPS}.tx_app", "--out", cap, "--data-out", sent_path,
         pn_mode, "--snr", args.snr, "--channel-taps", args.channel_taps, "--modulation",
         args.modulation, "--pilots", args.pilots, "--num-frames", str(args.num_frames)]
        + (["--out-format", "sc16"] if sc16 else []) + geom,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    if tx.returncode != 0:
        print(tx.stderr, file=sys.stderr)
        return 2

    ring = ["--ring-dtype", args.ring_dtype] if sc16 else []
    dm_extra = ["--device", device]
    if args.sc16_native:
        dm_extra += ["--sc16-native"]
    if args.mesh:
        dm_extra += ["--mesh", args.mesh]
    if args.pipeline:
        dm_extra += ["--pipeline", args.pipeline]
    rx_common = (["--num-frames", "0", "--rate", args.rate, "--thres", "0.05",
                  "--timeout", args.timeout]
                 + (["--continuous-sync"] if args.continuous_sync else [])
                 + (["--file-format", "sc16"] if sc16 else []) + ring)
    if args.distributed:
        # Antenna blocks of the capture's rows (row-major per antenna in
        # both formats), one producer ring each; the ranks meet on a
        # file:// store in the work directory.
        nproc = args.distributed
        a_local = args.antennas // nproc
        rows = np.fromfile(cap, dtype=np.int16 if sc16 else np.complex64).reshape(
            args.antennas, -1)
        geom_local = ["--antennas", str(a_local)] + geom[2:]
        rxs, dms = [], []
        for i in range(nproc):
            host_cap = os.path.join(workdir, f"capture_h{i}.dat")
            rows[i * a_local:(i + 1) * a_local].tofile(host_cap)
            rxs.append(_spawn("rx_app", ["--file", host_cap, "--shm-uid", f"{uid}_{i}"]
                              + rx_common + geom_local, env,
                              os.path.join(workdir, f"rx{i}")))
        store = f"file://{os.path.join(workdir, 'store')}"
        for i in range(nproc):
            dms.append(_spawn("demod_app",
                              ["--distributed", store, "--num-processes", str(nproc),
                               "--process-id", str(i), "--backend", "gloo",
                               "--shm-uid", f"{uid}_{i}", "--output", out,
                               "--num-frames", "0", "--no-timer", "--catch-up",
                               "--pilots", args.pilots, "--timeout", args.timeout]
                              + ring + dm_extra + geom, env,
                              os.path.join(workdir, f"demod{i}")))
    else:
        rxs = [_spawn("rx_app", ["--file", cap, "--shm-uid", uid] + rx_common
                      + (["--wait-writes"] if per_symbol else []) + geom, env,
                      os.path.join(workdir, "rx"))]
        dm_mode = ["--per-symbol"] if per_symbol else ["--catch-up"]
        dms = [_spawn("demod_app", ["--shm-uid", uid, "--output", out, "--num-frames", "0",
                                    "--no-timer", "--pilots", args.pilots,
                                    "--timeout", args.timeout] + dm_mode + ring + dm_extra
                      + geom, env, os.path.join(workdir, "demod"))]

    # --seconds measures steady-state pressure: the countdown starts once
    # the consumer has written its first frame (its index or output), not
    # while it is still starting; bounded by --timeout.
    warm_deadline = time.time() + float(args.timeout)
    first_out = out if per_symbol else out + ".index"
    while time.time() < warm_deadline:
        if any(p.poll() is not None for p in rxs + dms):
            break
        if os.path.exists(first_out) and os.path.getsize(first_out):
            break
        time.sleep(0.2)
    deadline = time.time() + args.seconds
    while time.time() < deadline:
        if any(p.poll() is not None for p in rxs + dms):
            break          # early death: report below instead of hanging
        time.sleep(0.5)
    for p in rxs:
        if p.poll() is None:
            p.send_signal(signal.SIGINT)  # master drains + shutdown sentinel
    rx_out, rx_err = "", ""
    for p in rxs:
        o, e = _finish(p, timeout=120)
        rx_out, rx_err = rx_out + o, rx_err + e
    # The consumers end on the ring's shutdown (the distributed ones on the
    # lockstep END sentinel); SIGINT only as the escalation.
    dm_out, dm_err = "", ""
    for p in dms:
        o, e = _finish(p, timeout=300, interrupt=True)
        dm_out, dm_err = dm_out + o, dm_err + e

    # 2. Score per delivered frame, keyed by the provenance index.
    f, s = args.fft_size, args.frame_len
    sent = np.fromfile(sent_path, dtype=np.complex64).reshape(args.num_frames, s - 1, f - 1)
    evm_clean, evm_dirty = score(out, sent, f, s)

    extra = {}
    for ln in dm_err.splitlines():
        if "writer overruns" in ln:
            extra = {"raw": ln.strip()}
    for ln in rx_out.splitlines():
        if ln.startswith("continuous sync:"):   # producer-side sync summary
            extra["producer_sync"] = ln.strip()
    rx_rc = worst_rc(p.returncode for p in rxs)
    demod_rc = worst_rc(p.returncode for p in dms)
    ok = (len(evm_clean) >= args.min_frames
          and (max(evm_clean) if evm_clean else 0.0) <= args.evm_db
          and all(p.returncode == 0 for p in rxs + dms))
    n_scored = len(evm_clean) + len(evm_dirty)
    rec = {
        "metric": "soak",
        "seconds": args.seconds,
        "geometry": f"{args.antennas}x{args.fft_size}x{args.frame_len}",
        "ring_dtype": args.ring_dtype,
        "rate": args.rate,
        "sync": "continuous" if args.continuous_sync else "one-shot",
        "consumer": (f"distributed-{args.distributed}" if args.distributed
                     else args.consumer),
        "device": device,
        "sent_frames": args.num_frames,
        "clean_frames": len(evm_clean),
        "dirty_frames": len(evm_dirty),
        "clean_fraction": len(evm_clean) / n_scored if n_scored else None,
        "evm_clean_db": {
            "min": min(evm_clean) if evm_clean else None,
            "median": float(np.median(evm_clean)) if evm_clean else None,
            "max": max(evm_clean) if evm_clean else None,
        },
        "evm_dirty_max_db": max(evm_dirty) if evm_dirty else None,
        "threshold_db": args.evm_db,
        "rx_rc": rx_rc,
        "demod_rc": demod_rc,
        "launches": profiling.summed_launch_lines(dm_out),
        **extra,
        "pass": ok,
    }
    print(json.dumps(rec))
    if not ok:
        print(f"rx stderr tail: {rx_err[-2000:]}", file=sys.stderr)
        print(f"demod stderr tail: {dm_err[-2000:]}", file=sys.stderr)
    if not args.keep and ok and args.dir is None:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
