"""Demodulator process: ring slave -> LS+MRC on the card -> Output file (the
port's counterpart of ``ofdm_ls_mrc_tpu.apps.demod_app``).

The equivalent of the reference's ``cpu``/``gpu`` entry mains
(cpuLS_main.cpp:57-106, gpuLS_main.cu:66-145): attach to the symbol ring as
slave, run ``num_times x (channel-estimate + demod)`` over frames, append
demodulated symbols to the output file, and print/store the phase-timing
report.  Flags and output formats are the JAX app's: ``Output_*.dat`` rows,
the ``.index`` provenance lines and the ``PhaseTimer`` table; ``--device``
picks where to compute (the card unless ``cpu`` is asked for).

Modes: whole frame (one ``UplinkReceiver.demod_frame`` a frame, ``--pipeline
fused|composed``), ``--batch-frames K`` (one ``demod_capture`` for K
frames), ``--per-symbol`` (``StreamingDemodulator``), and
``--ring-dtype sc16 --sc16-native`` (int16 planes from the ring straight into
the kernels).  ``--mesh 1x1`` runs each mode on the sharded modules
(``parallel/``) over a process group of one in this process; a larger
mesh needs one process a rank: ``--distributed HOST:PORT --num-processes N
--process-id i`` (each rank reads its own ring of its antennas, rank 0
writes the output).  ``--kernel-precision bf16`` runs the fused whole-frame
modes (whole frame, ``--batch-frames``, ``--mesh``, ``--distributed``) in
the bf16 speed mode (``csrc/fft_mrc_bf16.cu``; F = 256 to 32768, exact
below, as the JAX app); ``--per-symbol`` keeps the exact kernels, as the
JAX loop does, and says so on stderr.  ``--pipeline fast`` and ``--fft-impl
{xla,matmul,four_step}`` select the receivers' pipelines as in the JAX app
(``models/uplink.py``: an F the fused kernels do not take falls back to
'fast' with a warning on stderr, 'fast' on the 'xla' FFT to 'composed';
``--per-symbol`` without a mesh runs 'composed' for 'fast', with a note).
Not ported, refused with exit status 2: ``--compile-cache`` (JAX only).

Besides the JAX app's output, a run prints the kernel launches of its frame
loop, its throughput (frames/s and samples/s from ring to output file), the
feed's time split (whole-frame modes) and the per-symbol latency p50/p99
(``--per-symbol``).

Run:  python -m ofdm_ls_mrc_tpu_torch.apps.demod_app --antennas 16 \\
          --fft-size 1024 --cp-size 72 --frame-len 101 --num-frames 4
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shm-uid", default="/ofdm_ring",
                    help="shared-memory ring name (reference shmemID '/blah')")
    ap.add_argument("--antennas", type=int, default=16, help="numOfRows")
    ap.add_argument("--fft-size", type=int, default=1024, help="dimension")
    ap.add_argument("--cp-size", type=int, default=0, help="cyclic prefix length")
    ap.add_argument("--frame-len", type=int, default=101,
                    help="symbols per frame incl. pilot (lenOfBuffer)")
    ap.add_argument("--pilots", default="Pilots.dat",
                    help="pilot file (complex64, fftshift-ed on load)")
    ap.add_argument("--output", default="Output_gpu.dat",
                    help="demodulated output (raw complex64 rows)")
    ap.add_argument("--num-frames", type=int, default=1,
                    help="frames to process (numTimes); 0 = run until the "
                         "ring shuts down or SIGINT (live mode)")
    ap.add_argument("--device", default="cuda",
                    help="where to compute: the card (default; raises without "
                         "one) or 'cpu'")
    ap.add_argument("--pipeline", default="fused",
                    choices=["fused", "fast", "composed"],
                    help="demod path: fused = the CUDA kernels (an FFT size "
                         "they do not take falls back to fast, with a warning), "
                         "fast = the permuted-order four-step pipeline on GEMMs "
                         "(needs --fft-impl four_step or matmul, else composed), "
                         "composed = plain torch ops")
    ap.add_argument("--kernel-precision", default="exact",
                    choices=["exact", "bf16"],
                    help="fused-kernel numerics of the whole-frame modes: exact = "
                         "fp32-grade; bf16 = the bf16 speed mode (stage 2 of the "
                         "FFT on the tensor cores in bf16, ~1e-2 relative error; "
                         "F = 256 to 32768); --per-symbol stays exact")
    ap.add_argument("--batch-frames", type=int, default=1,
                    help="demodulate N whole frames per launch of each kernel "
                         "(UplinkReceiver.demod_capture); a short trailing "
                         "batch is flushed frame by frame; disables the "
                         "per-slot timing table")
    ap.add_argument("--per-symbol", action="store_true",
                    help="per-symbol streaming mode: ring -> "
                         "StreamingDemodulator -> output row per symbol, with "
                         "per-slot read/chanest/decode timing rows (the "
                         "reference's main runtime loop, cpuLS_main.cpp:80-93, "
                         "gpuLS.cu:410-473)")
    ap.add_argument("--link-quality", default=None, metavar="SCHEME",
                    help="report decision-directed EVM per emitted block and "
                         "overall (error vector to the NEAREST constellation "
                         "point of SCHEME, e.g. qpsk/16qam/64qam; trustworthy "
                         "while the symbol error rate is low)")
    ap.add_argument("--catch-up", action="store_true",
                    help="real-time mode: skip stale queued frames instead of "
                         "draining backlog (readLastSymbol semantics); in "
                         "--per-symbol mode data symbols are read with "
                         "readLastSymbol semantics like the reference GPU "
                         "loop (gpuLS.cu:419-424)")
    ap.add_argument("--ring-dtype", default="complex64",
                    choices=["complex64", "sc16"],
                    help="shm element format (must match the RX master)")
    ap.add_argument("--mesh", default=None, metavar="ANTxTIME",
                    help="demodulate on the SHARDED modules (antenna-sharded MRC "
                         "with one all-reduce a frame; parallel/sharded.py) over "
                         "an (ant, time) mesh of ranks: 1x1 runs in this process "
                         "on a group of one; a larger mesh takes one process a "
                         "rank (--distributed)")
    ap.add_argument("--sc16-native", action="store_true",
                    help="feed the card planar INT16 straight from an sc16 "
                         "ring (half the host and H2D bytes; the kernels "
                         "widen on load).  Requires --ring-dtype sc16 and the "
                         "fused pipeline; disables the per-slot timer")
    ap.add_argument("--drop-dirty", action="store_true",
                    help="exclude BEST-EFFORT (possibly misaligned) frames "
                         "delivered under sustained writer overrun from the "
                         "output file (still recorded in the frame index as "
                         "dropped-dirty)")
    ap.add_argument("--frame-index", default=None, metavar="FILE",
                    help="per-frame provenance index (default <output>.index; "
                         "'none' disables).  One line per delivered frame: "
                         "'<seq> <status> <row_start> <row_end> <writer_seq> "
                         "[<dd_evm_db>]' -- status clean, dirty (best-effort: "
                         "possibly misaligned), dropped-dirty or caught-up; "
                         "the row range into the output file (-1 -1 when not "
                         "emitted); the writer-stream frame ordinal; under "
                         "--link-quality the frame's decision-directed EVM")
    ap.add_argument("--timeout", type=float, default=30.0,
                    help="ring spin-wait timeout seconds")
    ap.add_argument("--store-times", default=None,
                    help="write binary 5-word timing dump (time_*.dat layout)")
    ap.add_argument("--save-state", default=None, metavar="FILE",
                    help="per-symbol mode: checkpoint the channel estimate "
                         "after every frame (io/state layout, readable by "
                         "both packages)")
    ap.add_argument("--resume", default=None, metavar="FILE",
                    help="per-symbol mode: restore a checkpointed channel "
                         "estimate before the first frame (restart-resume)")
    ap.add_argument("--dump-symbols", default=None, metavar="FILE",
                    help="debug tap: append every symbol read from the ring "
                         "as raw complex64 (the reference's Sym_copy_sh_mem.dat "
                         "dump, ShMemSymBuff.hpp:355-362)")
    ap.add_argument("--no-timer", action="store_true")
    ap.add_argument("--fft-impl", default=None,
                    choices=[None, "xla", "matmul", "four_step"],
                    help="FFT of the fast and composed pipelines: xla = torch.fft "
                         "(the default), matmul or four_step = float32 GEMMs")
    ap.add_argument("--compile-cache", nargs="?", const="default", default=None,
                    metavar="DIR", help="JAX's compilation cache: not ported")
    ap.add_argument("--distributed", default=None, metavar="HOST:PORT",
                    help="multi-process antenna-sharded run (torch.distributed "
                         "rendezvous: HOST:PORT, tcp://... or file://...): each "
                         "process reads ITS antennas' symbols from its own ring "
                         "(--antennas is the GLOBAL count) and the MRC "
                         "all-reduce is the only traffic between processes")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="--distributed: total process count")
    ap.add_argument("--process-id", type=int, default=None,
                    help="--distributed: this process's rank (0-based; rank 0 "
                         "writes the output file)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="--mesh/--distributed process-group backend (default "
                         "nccl on the card, gloo on the CPU; several ranks on "
                         "one card take gloo: NCCL refuses two ranks a device)")
    return ap


# (flag, test on the parsed args, where the work is queued)
_NOT_PORTED = (
    ("--compile-cache", lambda a: a.compile_cache is not None, "JAX only"),
)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def _reset_launch_counts() -> None:
    from ..parallel import collectives
    from ..utils import profiling
    profiling.reset_kernel_launches()
    collectives.reset()


def _report_run(frames: int, seconds: float, samples_per_frame: int,
                sharded: bool = False) -> None:
    """The frame loop's kernel launches (and, sharded, its all-reduces) and
    throughput, one line each."""
    from ..utils import profiling
    print(f"kernel launches {json.dumps(profiling.kernel_launches())}")
    if sharded:
        from ..parallel import collectives
        print(f"all-reduce {json.dumps(collectives.counts)}")
    if frames and seconds > 0:
        print(f"throughput: {frames} frame(s) in {seconds:.6f} s: "
              f"{frames / seconds:.3f} frames/s, "
              f"{frames * samples_per_frame / seconds:.6g} samples/s "
              f"(ring -> feed -> demod -> output file)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    for flag, given, where in _NOT_PORTED:
        if given(args):
            print(f"{flag} is not ported to the PyTorch/CUDA package ({where})",
                  file=sys.stderr)
            return 2

    if args.link_quality is not None:
        from ..sim.channel import CONSTELLATIONS
        if args.link_quality not in CONSTELLATIONS:
            print(f"--link-quality {args.link_quality!r}: unknown scheme "
                  f"(choices: {', '.join(sorted(CONSTELLATIONS))})",
                  file=sys.stderr)
            return 2
    if args.distributed is not None:
        return _run_distributed(args)
    if args.num_processes is not None or args.process_id is not None:
        print("--num-processes and --process-id go with --distributed HOST:PORT",
              file=sys.stderr)
        return 2
    if args.mesh is not None:
        try:
            n_ant, n_time = (int(v) for v in args.mesh.lower().split("x"))
            if n_ant < 1 or n_time < 1:
                raise ValueError
        except ValueError:
            print(f"--mesh {args.mesh!r}: expected ANTxTIME, e.g. 1x1 or 4x2",
                  file=sys.stderr)
            return 2
        if n_ant * n_time > 1:
            print(f"--mesh {args.mesh}: a process of the port drives one rank of the "
                  f"mesh; run {n_ant * n_time} processes with --distributed HOST:PORT "
                  f"--num-processes {n_ant * n_time} --process-id i", file=sys.stderr)
            return 2

    if args.sc16_native:
        if args.ring_dtype != "sc16":
            print("--sc16-native requires --ring-dtype sc16", file=sys.stderr)
            return 2
        if args.pipeline != "fused" and not args.per_symbol:
            print("--sc16-native requires the fused pipeline", file=sys.stderr)
            return 2
    if args.batch_frames > 1 and args.per_symbol:
        print("note: --batch-frames has no effect in --per-symbol mode",
              file=sys.stderr)
    if args.per_symbol and args.drop_dirty:
        # --drop-dirty is RingFeed machinery (best-effort frame exclusion
        # under sustained overrun); the per-symbol loop's deliberate-loss
        # mode is --catch-up, whose skips the index records as caught-up.
        print("--drop-dirty is a whole-frame provenance mode "
              "(not --per-symbol)", file=sys.stderr)
        return 2

    from ..io.ring import SymbolRing
    from ..utils.timing import PhaseTimer

    device, cfg, pilot = _geometry(args)
    continuous = args.num_frames <= 0
    timer = None if (args.no_timer or continuous
                     or (args.sc16_native and not args.per_symbol)
                     or (args.batch_frames > 1 and not args.per_symbol)
                     ) else PhaseTimer(
        num_slots=args.frame_len, num_times=args.num_frames)

    mesh = None
    if args.mesh is not None:
        from ..parallel import initialize_single, make_mesh
        initialize_single(_backend(args, device))
    try:
        if args.mesh is not None:
            mesh = make_mesh(1, 1)
        ring = SymbolRing(args.shm_uid, args.antennas, args.fft_size + args.cp_size,
                          args.frame_len, master=False, timeout=args.timeout,
                          dtype=args.ring_dtype)
        if args.per_symbol:
            return _run_per_symbol(args, cfg, pilot, ring, timer, continuous, device, mesh)
        return _run_frames(args, cfg, pilot, ring, timer, continuous, device, mesh)
    finally:
        if args.mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _geometry(args):
    """(device, cfg, pilot) of a run.  The ring drops the CP during
    copy-out, so the pipeline sees CP-free symbols (cyclic_prefix=0 here;
    --cp-size shapes the ring)."""
    from ..config import FrameConfig
    from ..golden.io import load_pilot
    from ..ops.cplx import resolve_device

    device = resolve_device(args.device, "demod_app")
    cfg = FrameConfig(num_antennas=args.antennas, fft_size=args.fft_size,
                      cyclic_prefix=0, frame_len=args.frame_len)
    return device, cfg, load_pilot(args.pilots, cfg.num_subcarriers)


def _exact(args) -> bool:
    """False under --kernel-precision bf16 (the speed mode)."""
    return args.kernel_precision == "exact"


def _backend(args, device) -> str:
    """The process group's backend: --backend, else nccl on the card and
    gloo on the CPU (no switch after a failed init: that raises)."""
    return args.backend or ("nccl" if device.type == "cuda" else "gloo")


def _run_frames(args, cfg, pilot, ring, timer, continuous, device, mesh=None) -> int:
    """Whole-frame and --batch-frames modes over the pinned RingFeed; with a
    mesh (--mesh 1x1) on ShardedUplinkReceiver."""
    import torch

    from ..golden.io import SC16_FULL_SCALE, append_output
    from ..models import UplinkReceiver
    from ..ops.cplx import CArray

    if mesh is not None:
        from ..parallel import ShardedUplinkReceiver
        rx = ShardedUplinkReceiver(cfg, pilot, mesh, pipeline=args.pipeline,
                                   fft_impl=args.fft_impl, exact=_exact(args), device=device)
    else:
        rx = UplinkReceiver(cfg, pilot, pipeline=args.pipeline, fft_impl=args.fft_impl,
                            exact=_exact(args), device=device)
    if args.sc16_native and rx.pipeline != "fused":
        print(f"--sc16-native requires the fused kernels, but fft_size={args.fft_size} is "
              f"not one they take (the pipeline fell back to {rx.pipeline!r})",
              file=sys.stderr)
        return 2
    feed = _make_feed(ring, cfg, args.cp_size, timer, catch_up=args.catch_up,
                      int16=args.sc16_native, device=device)

    # Warm at the exact shape and dtype the feed will deliver (on the card
    # this builds and loads the kernels before the ring goes live).
    shape = (cfg.frame_len, cfg.num_antennas, cfg.fft_size)
    dtype = torch.int16 if args.sc16_native else torch.float32
    one = torch.ones(shape, dtype=dtype, device=device)
    rx.demod_frame(CArray(one, one))
    if args.batch_frames > 1:
        ones = one.expand(args.batch_frames, *shape)
        rx.demod_capture(CArray(ones, ones))
    _sync(device)
    del one
    _reset_launch_counts()

    n = 0
    wrote_any = False
    batch = []          # [(frame, dirty, wseq)] pending in --batch-frames mode
    dropped_dirty = 0
    rows_per_frame = cfg.num_data_symbols
    index_path = (None if args.frame_index == "none"
                  else (args.frame_index or args.output + ".index"))
    index_f = open(index_path, "w") if index_path else None
    emitted_rows = 0
    seq = 0             # delivered-frame ordinal (incl. dropped-dirty)
    lq = _LinkQuality(args.link_quality) if args.link_quality else None

    def index_record(status, nrows, wseq=-1, rows=None):
        """One provenance line per delivered frame: delivered seq, status,
        the emitted row range in the output file (-1 -1 when not emitted),
        and the writer-stream frame ordinal (-1 when unknown); under
        --link-quality a sixth column with the frame's dd-EVM in dB."""
        nonlocal emitted_rows, seq
        evm = (lq.update(rows) if (lq is not None and rows is not None)
               else None)
        if index_f is not None:
            lo, hi = ((emitted_rows, emitted_rows + nrows) if nrows
                      else (-1, -1))
            tail = "" if evm is None else f" {evm:.2f}"
            index_f.write(f"{seq} {status} {lo} {hi} {wseq}{tail}\n")
            index_f.flush()
        emitted_rows += nrows
        seq += 1

    def emit(arr):
        nonlocal wrote_any
        append_output(args.output, arr, truncate=not wrote_any)
        wrote_any = True

    def demod_batch(frames):
        stacked = CArray(torch.stack([f.re for f in frames]),
                         torch.stack([f.im for f in frames]))
        o = rx.demod_capture(stacked).to_numpy()          # [K, S-1, F-1]
        return o.reshape(-1, o.shape[-1])

    dump_f = open(args.dump_symbols, "wb") if args.dump_symbols else None

    def dump_frame(fr):
        re, im = fr.re.cpu().numpy(), fr.im.cpu().numpy()
        if re.dtype != np.float32:        # sc16-native planes -> full scale
            re = re.astype(np.float32) / SC16_FULL_SCALE
            im = im.astype(np.float32) / SC16_FULL_SCALE
        (re + 1j * im).astype(np.complex64).tofile(dump_f)

    def flush_batch():
        """Emit a full batch with one launch of each kernel + index rows.
        Dropped-dirty tombstones (frame is None) ride the queue so index
        lines come out in DELIVERY order."""
        nonlocal batch
        rows = demod_batch([f for f, _, _ in batch if f is not None])
        emit(rows)
        j = 0   # emitted-frame ordinal within this batch
        for fr, was_dirty, wseq in batch:
            if fr is None:
                index_record("dropped-dirty", 0, wseq)
            else:
                index_record("dirty" if was_dirty else "clean",
                             rows_per_frame, wseq,
                             rows=rows[j * rows_per_frame:
                                       (j + 1) * rows_per_frame])
                j += 1
        batch = []

    t_start = time.perf_counter()
    try:
        for frame in feed.frames(max_frames=None if continuous
                                 else args.num_frames):
            dirty = feed.last_frame_dirty
            wseq = feed.last_frame_writer_seq
            if dump_f is not None:
                dump_frame(frame)
            if dirty and args.drop_dirty:
                dropped_dirty += 1
                if args.batch_frames > 1 and batch:
                    # Keep index lines in delivery order: queue a tombstone
                    # behind the frames already pending in this batch.
                    batch.append((None, True, wseq))
                else:
                    index_record("dropped-dirty", 0, wseq)
                continue
            if args.batch_frames > 1:
                batch.append((frame, dirty, wseq))
                n += 1
                if sum(1 for f, _, _ in batch
                       if f is not None) == args.batch_frames:
                    flush_batch()
                continue
            if timer:
                # Frame 0 lands in slot 0 -- EXCLUDED from the table's
                # stats, like the reference's &decode[1] averaging -- so
                # first-launch overhead doesn't pollute the steady state;
                # later frames cycle slots 1..L-1.  A single-frame run has
                # no steady state, so its one frame goes to slot 1.  FFT and
                # Drop rows are structurally zero here: the FFT is fused
                # into the decode and the CP drop happens inside the ring's
                # native copy-out (counted in Read).  The phase ends when
                # the device has finished.
                if args.num_frames == 1:
                    slot = 1
                elif n == 0:
                    slot = 0
                else:
                    slot = 1 + ((n - 1) % max(args.frame_len - 1, 1))
                with timer.phase("decode", slot):
                    out = rx.demod_frame(frame)
                    _sync(device)
            else:
                out = rx.demod_frame(frame)
            o = out.to_numpy()
            emit(o)
            index_record("dirty" if dirty else "clean", rows_per_frame, wseq,
                         rows=o)
            n += 1
    except KeyboardInterrupt:
        print(f"SIGINT: stopping after {n} frame(s)")
    # Flush a short trailing batch frame by frame.
    for fr, was_dirty, wseq in batch:
        if fr is None:
            index_record("dropped-dirty", 0, wseq)
            continue
        o = rx.demod_frame(fr).to_numpy()
        emit(o)
        index_record("dirty" if was_dirty else "clean", rows_per_frame, wseq,
                     rows=o)
    seconds = time.perf_counter() - t_start
    if dump_f is not None:
        dump_f.close()
    if index_f is not None:
        index_f.close()
    print(f"demodulated {n} frame(s) -> {args.output}")
    _report_run(n, seconds, cfg.frame_len * cfg.num_antennas * (cfg.fft_size + args.cp_size),
                sharded=mesh is not None)
    if n:
        print(f"feed per frame (s): ring read {feed.read_seconds / n:.6e}, "
              f"host buffer wait {feed.buffer_wait_seconds / n:.6e}, "
              f"frame wait {feed.frame_wait_seconds / n:.6e}, "
              f"H2D copy {feed.h2d_seconds / n:.6e}, "
              f"copy wait {feed.copy_wait_seconds / n:.6e}")
    if lq is not None and lq.blocks:
        print(f"link quality ({lq.scheme} decision-directed EVM): "
              f"{lq.overall_db():.1f} dB overall, worst block "
              f"{lq.worst_db:.1f} dB over {lq.blocks} block(s)")
    if feed.drop_events:
        print(f"writer overruns: {feed.drop_events} event(s), "
              f"{feed.resynced_frames} boundary resync(s), "
              f"{feed.dirty_frames} BEST-EFFORT (possibly misaligned) "
              f"frame(s) delivered under sustained pressure"
              + (f", {dropped_dirty} excluded from the output "
                 f"(--drop-dirty)" if dropped_dirty else ""),
              file=sys.stderr)

    if timer:
        timer.print_times()
        if args.store_times:
            timer.store_times(args.store_times)
    feed.stop()   # join the reader thread before unmapping the segment
    ring.close()
    return 0


def _lockstep(held, next_frame, gather):
    """The ranks' per-frame agreement of the distributed loop.

    ``held`` is this rank's (frame, writer seq, dirty), frame None at the
    end of its stream; ``next_frame()`` reads its next one; ``gather(v)``
    returns every rank's int64 pair (writer seq or -2 at the end, dirty) as
    an [n, 2] array.  Ranks behind the newest writer frame any rank holds
    drop frames until they reach it; all ranks end when any has ended (each
    round is one gather on every rank, so none blocks).  Returns (frame,
    writer seq, dirty on any rank, frames this rank dropped): a frame counts
    as dropped when it is replaced for lying behind the target, never the
    one that reaches it."""
    fr, wseq, dirty = held
    dropped = 0
    while True:
        g = gather(np.array([wseq if fr is not None else -2, int(bool(dirty))], np.int64))
        if (g[:, 0] == -2).any():
            return None, -1, False, dropped
        tgt = int(g[:, 0].max())
        if (g[:, 0] == tgt).all():
            return fr, wseq, bool(g[:, 1].any()), dropped
        while fr is not None and wseq < tgt:
            dropped += 1
            fr, wseq, dirty = next_frame()


def _run_distributed(args) -> int:
    """Antennas across processes: N ranks, each reading ITS antennas'
    symbols (all frame slots) from its OWN ring -- BASELINE config 5's
    64-antenna split (the JAX app's ``_run_distributed``).  The
    ShardedUplinkReceiver's all-reduce (2 (S-1)(F-1) + F fp32 words a frame)
    is the only traffic between ranks besides the lockstep.

    Each rank runs the RingFeed of the single-rank consumer (reader thread,
    overrun resync, dirty provenance, catch-up, sc16-native int16 frames,
    continuous --num-frames 0), and every frame the ranks agree in a small
    ``all_gather`` of (writer seq | -2, dirty) as CPU int64 tensors
    (``_lockstep``): ranks behind drop frames until all hold the SAME writer
    frame, since independent drops would otherwise MRC-combine different
    transmitted frames.  Under nccl the agreement runs on a gloo group of
    its own.  Rank 0 writes the output, the merged index (dirty if ANY
    rank's frame was) and the link quality."""
    import torch
    import torch.distributed as dist

    from ..config import FrameConfig
    from ..golden.io import append_output
    from ..io.ring import SymbolRing
    from ..ops.cplx import CArray
    from ..parallel import ShardedUplinkReceiver, initialize, make_multihost_mesh

    if args.per_symbol or args.mesh:
        print("--distributed is a whole-frame mode (not --per-symbol/--mesh)",
              file=sys.stderr)
        return 2
    if args.sc16_native and args.ring_dtype != "sc16":
        print("--sc16-native requires --ring-dtype sc16", file=sys.stderr)
        return 2
    if args.drop_dirty:
        print("--drop-dirty is not supported under --distributed (the merged index "
              "records dirty frames; excluding them would desync rank 0's row "
              "accounting)", file=sys.stderr)
        return 2
    if args.num_processes and args.antennas % args.num_processes:
        print(f"{args.antennas} global antennas not divisible by {args.num_processes} "
              f"processes", file=sys.stderr)
        return 2
    device, cfg, pilot = _geometry(args)
    continuous = args.num_frames <= 0
    backend = _backend(args, device)
    initialize(args.distributed, args.num_processes, args.process_id, backend)
    ring = feed = index_f = None
    try:
        nproc, pid = dist.get_world_size(), dist.get_rank()
        if cfg.num_antennas % nproc:
            print(f"{cfg.num_antennas} global antennas not divisible by {nproc} "
                  f"processes", file=sys.stderr)
            return 2
        a_local = cfg.num_antennas // nproc
        mesh = make_multihost_mesh(ant_shards=nproc, time_shards=1)
        rx = ShardedUplinkReceiver(cfg, pilot, mesh, pipeline=args.pipeline,
                                   fft_impl=args.fft_impl, exact=_exact(args), device=device)
        if args.sc16_native and rx.pipeline != "fused":
            print("--sc16-native requires the fused pipeline", file=sys.stderr)
            return 2
        lock_group = dist.new_group(backend="gloo") if backend != "gloo" else None

        def gather(v):
            parts = [torch.empty(2, dtype=torch.int64) for _ in range(nproc)]
            dist.all_gather(parts, torch.from_numpy(v), group=lock_group)
            return torch.stack(parts).numpy()

        # Warm at the live shape and dtype before touching the ring (on the
        # card this builds and loads the kernels); collective.
        dtype = torch.int16 if args.sc16_native else torch.float32
        one = torch.ones((cfg.frame_len, a_local, cfg.fft_size), dtype=dtype, device=device)
        rx.demod_frame(CArray(one, one))
        _sync(device)
        del one
        _reset_launch_counts()

        ring = SymbolRing(args.shm_uid, a_local, args.fft_size + args.cp_size,
                          cfg.frame_len, master=False, timeout=args.timeout,
                          dtype=args.ring_dtype)
        cfg_local = FrameConfig(num_antennas=a_local, fft_size=cfg.fft_size,
                                cyclic_prefix=0, frame_len=cfg.frame_len)
        feed = _make_feed(ring, cfg_local, args.cp_size, None, catch_up=args.catch_up,
                          int16=args.sc16_native, device=device)
        gen = feed.frames()

        def next_frame():
            try:
                fr = next(gen)
                return fr, int(feed.last_frame_writer_seq), feed.last_frame_dirty
            except StopIteration:
                return None, -1, False

        lq = _LinkQuality(args.link_quality) if (args.link_quality and pid == 0) else None
        index_path = (None if args.frame_index == "none"
                      else (args.frame_index or args.output + ".index"))
        index_f = open(index_path, "w") if (index_path and pid == 0) else None
        rows = k = skipped = 0
        t_start = time.perf_counter()
        held = next_frame()
        try:
            while True:
                fr, wseq, dirty, n_drop = _lockstep(held, next_frame, gather)
                skipped += n_drop
                if fr is None:
                    break
                o = rx.demod_frame(fr).to_numpy()
                if pid == 0:
                    append_output(args.output, o, truncate=(k == 0))
                    evm = lq.update(o) if lq is not None else None
                    if index_f is not None:
                        tail = "" if evm is None else f" {evm:.2f}"
                        index_f.write(f"{k} {'dirty' if dirty else 'clean'} {rows} "
                                      f"{rows + o.shape[0]} {wseq}{tail}\n")
                        index_f.flush()
                rows += o.shape[0]
                k += 1
                if not continuous and k >= args.num_frames:
                    break
                held = next_frame()
        except KeyboardInterrupt:
            print(f"[proc {pid}] SIGINT: stopping after {k} frame(s)", file=sys.stderr)
        seconds = time.perf_counter() - t_start
        print(f"[proc {pid}] demodulated {rows} data symbols over {k} frame(s) across "
              f"{nproc} processes x {a_local} antennas ({rx.pipeline} pipeline, {backend}"
              + (", sc16-native" if args.sc16_native else "")
              + (f", {skipped} frame(s) dropped in lockstep catch-up" if skipped else "")
              + ")", file=sys.stderr)
        _report_run(k, seconds, cfg.frame_len * a_local * (cfg.fft_size + args.cp_size),
                    sharded=True)
        if feed.drop_events:
            print(f"[proc {pid}] writer overruns: {feed.drop_events} event(s), "
                  f"{feed.resynced_frames} boundary resync(s), "
                  f"{feed.dirty_frames} best-effort frame(s)", file=sys.stderr)
        if lq is not None and lq.blocks:
            print(f"link quality ({lq.scheme} decision-directed EVM): "
                  f"{lq.overall_db():.1f} dB overall, worst block "
                  f"{lq.worst_db:.1f} dB over {lq.blocks} block(s)")
        return 0
    finally:
        if feed is not None:
            feed.stop()
        if ring is not None:
            ring.close()
        if index_f is not None:
            index_f.close()
        dist.destroy_process_group()


class _LinkQuality:
    """Decision-directed EVM over emitted output blocks: the error vector to
    the NEAREST constellation point, so live link quality needs no ground
    truth.  Reliable while the symbol error rate is low -- hard-decision
    errors snap to the wrong point and understate the error power past
    roughly the scheme's working SER."""

    def __init__(self, scheme: str):
        from ..sim.channel import CONSTELLATIONS

        self.scheme = scheme
        self._const = CONSTELLATIONS[scheme]
        self._err_pow = 0.0
        self._ref_pow = 0.0
        self.blocks = 0
        self.worst_db = float("-inf")

    def update(self, rows: np.ndarray) -> float:
        """rows: [N, F-1] reference-layout output; returns this block's
        dd-EVM in dB and folds it into the running totals."""
        from ..sim.channel import demap_symbols

        # Nearest-point demap is invariant to column permutations, so the
        # reference layout's ifftshift needs no undoing here.
        ref = self._const[demap_symbols(rows, self.scheme)]
        err = float(np.sum(np.abs(rows - ref) ** 2))
        refp = float(np.sum(np.abs(ref) ** 2))
        self._err_pow += err
        self._ref_pow += refp
        self.blocks += 1
        block_db = 10.0 * math.log10(err / max(refp, 1e-30) + 1e-30)
        self.worst_db = max(self.worst_db, block_db)
        return block_db

    def overall_db(self) -> float:
        return 10.0 * math.log10(
            self._err_pow / max(self._ref_pow, 1e-30) + 1e-30)


class _SymbolProvenance:
    """Writer ordinal and status of one frame of the per-symbol loop, from
    the ring's counters read before the frame's pilot (begin) and before the
    next frame's pilot (end).

    The writer-stream ordinal is (consumed + dropped) // frame_len, as the
    feed computes it: consumed alone runs behind the writer by every symbol
    the writer dropped.  The frame is ``dirty`` (best-effort, possibly
    misaligned) when the ring's drop count changed during it, or when it
    began off a writer frame boundary (an earlier drop, or a catch-up read,
    left the pilot slot on a data symbol); else ``caught-up`` when
    --catch-up skipped symbols inside it; else ``clean``."""

    def __init__(self, frame_len: int):
        self.frame_len = frame_len
        self._start = (0, 0)

    def begin(self, consumed: int, dropped: int) -> None:
        self._start = (consumed, dropped)

    def end(self, consumed: int, dropped: int):
        """(status, writer ordinal) of the frame since ``begin``."""
        c0, d0 = self._start
        fl = self.frame_len
        if dropped != d0 or (c0 + d0) % fl:
            status = "dirty"
        elif consumed - c0 != fl:
            status = "caught-up"
        else:
            status = "clean"
        return status, (c0 + d0) // fl


def _run_per_symbol(args, cfg, pilot, ring, timer, continuous, device, mesh=None) -> int:
    """Per-symbol streaming loop: the reference's main runtime shape
    (firstVector + per-symbol demodOneSymbol, cpuLS_main.cpp:80-93,
    gpuLS.cu:410-473) -- read a symbol from the ring, refresh the estimate on
    slot 0, demod and append an output row on slots 1..L-1, with per-slot
    read (here) / chanest / decode (inside StreamingDemodulator) timers.

    Unlike the reference loop, it realigns after a writer drop: when the
    ring's drop count changes during a frame, the symbol just read is
    discarded, the frame's index line closes ``dirty``, and the next frame
    starts on the next writer-frame boundary (``resync``, the rule of
    ``io/feed.py`` ``RingFeed._resync``).  Before each pilot it also
    discards to the boundary when the cursor sits off one, as --catch-up
    reads leave it: ``read_last`` advances the ring's consumed count past
    every symbol it skips and drains the ring, so consumed + dropped is the
    writer index of the next symbol there too.  Discarded symbols give no
    output row.  With a mesh (--mesh 1x1) ShardedStreamingDemodulator runs
    the symbols (one all-reduce a pilot and a symbol)."""
    import torch

    from ..golden.io import SC16_FULL_SCALE, append_output
    from ..io.ring import RingShutdown, RingTimeout
    from ..models.streaming import StreamingDemodulator
    from ..ops.cplx import CArray

    if not _exact(args):
        print("note: --per-symbol runs the exact kernels; --kernel-precision bf16 "
              "covers the whole-frame modes (as the JAX app's per-symbol loop)",
              file=sys.stderr)
    if mesh is not None:
        from ..parallel import ShardedStreamingDemodulator
        sd = ShardedStreamingDemodulator(cfg, pilot, mesh, fft_impl=args.fft_impl, timer=timer,
                                         pipeline=args.pipeline, device=device)
    else:
        pipeline = "fused" if args.pipeline == "fused" else "composed"
        if args.pipeline != pipeline:
            print(f"note: --per-symbol has no {args.pipeline!r} variant; using 'composed' "
                  "(the reference per-symbol semantics, as the JAX app)", file=sys.stderr)
        sd = StreamingDemodulator(cfg, pilot, fft_impl=args.fft_impl, timer=timer,
                                  pipeline=pipeline, device=device)
    sd.warmup(int16=args.sc16_native)
    if args.resume and os.path.exists(args.resume):
        idx = sd.resume(args.resume)
        print(f"resumed channel estimate from {args.resume} (frame {idx})")
    _sync(device)
    _reset_launch_counts()

    cp = args.cp_size
    n_sym = 0
    frames_done = 0
    first_write = True
    dump_f = open(args.dump_symbols, "wb") if args.dump_symbols else None

    # Live observability: decision-directed EVM over the emitted rows and a
    # per-frame provenance line in the SAME index format as the whole-frame
    # consumer (see _SymbolProvenance for the writer ordinal and status).
    lq = _LinkQuality(args.link_quality) if args.link_quality else None
    index_path = (None if args.frame_index == "none"
                  else (args.frame_index or args.output + ".index"))
    index_f = open(index_path, "w") if index_path else None
    prov = _SymbolProvenance(args.frame_len)
    cur_rows = []           # this frame's emitted rows (for lq + index)
    emitted_rows = 0
    frame_rows = 0          # rows appended for the current frame
    seq = 0
    latencies = []          # ring read done -> row appended, per data symbol

    # Writer drops (see the docstring).  Attaching to a ring that already
    # overran: its backlog predates the drops, so resync before the first
    # frame, as the feed does.
    fl = args.frame_len
    read_in_order = ring.read_next_planar_i16 if args.sc16_native else ring.read_next_planar
    seen_dropped = ring.dropped
    resync_pending = seen_dropped > 0
    drop_events = resyncs = discarded = 0

    def align():
        """Blocking read-and-discard (backpressure holds) up to the next
        writer-frame boundary of consumed + dropped."""
        nonlocal discarded
        for _ in range((fl - (ring.consumed + ring.dropped) % fl) % fl):
            read_in_order(cp=cp)
            discarded += 1

    def resync():
        """The gap lies in the queued backlog (drops happen at the ring's
        head): drain the backlog, then align.  Repeats while fresh drops
        land, at most three times; on give-up the next frame starts off a
        boundary and its index line says dirty."""
        nonlocal seen_dropped, resyncs, discarded
        for _ in range(3):
            discarded += ring.skip(ring.available)
            dropped = ring.dropped
            align()
            if ring.dropped == dropped:
                break
        seen_dropped = ring.dropped
        resyncs += 1

    def index_record(counters):
        """Emit the completed frame's index line + fold its rows into lq;
        ``counters`` are the ring's (consumed, dropped) where it ended."""
        nonlocal cur_rows, emitted_rows, seq
        if not cur_rows:
            return
        status, wseq = prov.end(*counters)
        rows = np.stack(cur_rows)
        evm = lq.update(rows) if lq is not None else None
        if index_f is not None:
            lo = emitted_rows
            tail = "" if evm is None else f" {evm:.2f}"
            index_f.write(f"{seq} {status} {lo} {lo + len(cur_rows)} "
                          f"{wseq}{tail}\n")
            index_f.flush()
        emitted_rows += len(cur_rows)
        seq += 1
        cur_rows = []

    # One-deep streaming pipeline: the demod of symbol k is launched
    # (push_symbol_async) and left in flight while the ring read of symbol
    # k+1 proceeds; only then is k's output waited for and appended.  The
    # decode column records the WAIT, not the overlapped span.
    pending = None          # (out, slot, event, read time) of the in-flight symbol

    def flush_pending():
        nonlocal pending, first_write, frame_rows
        if pending is None:
            return
        out, pslot, done, t_read = pending
        pending = None
        if timer:
            with timer.phase("decode", pslot):
                if done is not None:
                    done.synchronize()
        o = out.to_numpy()
        append_output(args.output, o, truncate=first_write)
        first_write = False
        latencies.append(time.perf_counter() - t_read)
        frame_rows += 1
        if lq is not None or index_f is not None:
            cur_rows.append(o)

    t_start = time.perf_counter()
    try:
        f = 0
        while continuous or f < args.num_frames:
            # The previous frame ends here; its index line closes at the
            # next pilot's read (after its last row is flushed).
            closing = (ring.consumed, ring.dropped)
            if resync_pending or closing[1] != seen_dropped:
                resync()
                resync_pending = False
            elif sum(closing) % fl:
                align()
            counters = (ring.consumed, ring.dropped)
            aborted = False
            for slot in range(fl):
                # Data symbols honor readLastSymbol semantics under
                # --catch-up (gpuLS.cu:419-424); the pilot always reads in
                # order.  sc16-native reads deliver planar INT16 straight
                # off the wire format (the kernels widen on the card).
                if args.sc16_native:
                    read = (ring.read_last_planar_i16
                            if (args.catch_up and slot > 0)
                            else ring.read_next_planar_i16)
                else:
                    read = (ring.read_last_planar
                            if (args.catch_up and slot > 0)
                            else ring.read_next_planar)
                if timer:
                    with timer.phase("read", slot):
                        re, im = read(cp=cp)
                else:
                    re, im = read(cp=cp)
                t_read = time.perf_counter()
                flush_pending()      # symbol k-1's wait, AFTER k's read
                if slot == 0:
                    # Previous frame fully flushed: emit its index line
                    # (its span ends where this frame's alignment began).
                    index_record(closing)
                    prov.begin(*counters)
                    frame_rows = 0
                if ring.dropped != seen_dropped:
                    # The writer dropped symbols: this one may lie past the
                    # gap (a --catch-up read takes the newest).  Discard it,
                    # close the frame dirty, resync before the next pilot.
                    index_record((ring.consumed, ring.dropped))
                    drop_events += 1
                    resync_pending = aborted = True
                    print(f"demod_app: writer dropped {ring.dropped - seen_dropped} "
                          f"symbol(s) in slot {slot}; closing the frame and resyncing",
                          file=sys.stderr)
                    break
                if dump_f is not None:
                    if re.dtype != np.float32:   # sc16 planes -> full scale
                        (re.astype(np.float32) / SC16_FULL_SCALE
                         + 1j * im.astype(np.float32) / SC16_FULL_SCALE
                         ).astype(np.complex64).tofile(dump_f)
                    else:
                        (re + 1j * im).astype(np.complex64).tofile(dump_f)
                sym = CArray(torch.from_numpy(re).to(device),
                             torch.from_numpy(im).to(device))
                if slot == 0:
                    sd.push_pilot(sym, slot=slot)
                else:
                    out = sd.push_symbol_async(sym, slot=slot)
                    done = None
                    if device.type == "cuda":
                        done = torch.cuda.Event()
                        done.record()
                    pending = (out, slot, done, t_read)
                n_sym += 1
            if aborted and not frame_rows:
                continue             # no row, no index line: not a frame
            frames_done += 1
            if args.save_state:
                flush_pending()      # frame fully materialized before ckpt
                sd.save_state(args.save_state, frame_index=frames_done)
            f += 1
    except KeyboardInterrupt:
        print(f"SIGINT: stopping after {frames_done} frame(s), {n_sym} symbols")
    except (RingShutdown, RingTimeout) as e:
        print(f"ring ended ({type(e).__name__}) after {frames_done} frame(s), "
              f"{n_sym} symbols")
    flush_pending()
    index_record((ring.consumed, ring.dropped))
    seconds = time.perf_counter() - t_start
    if index_f is not None:
        index_f.close()
    if dump_f is not None:
        dump_f.close()
    print(f"demodulated {frames_done} frame(s) per-symbol -> {args.output}")
    if drop_events or discarded:
        print(f"writer overruns: {drop_events} event(s), {resyncs} resync(s), "
              f"{discarded} symbol(s) discarded to reach a writer-frame boundary",
              file=sys.stderr)
    _report_run(frames_done, seconds,
                cfg.frame_len * cfg.num_antennas * (cfg.fft_size + args.cp_size),
                sharded=mesh is not None)
    if latencies:
        us = np.asarray(latencies) * 1e6
        print(f"per-symbol latency (ring read done -> row appended, "
              f"{len(us)} symbols): p50 {np.percentile(us, 50):.2f} us, "
              f"p99 {np.percentile(us, 99):.2f} us")
    if lq is not None and lq.blocks:
        print(f"link quality ({lq.scheme} decision-directed EVM): "
              f"{lq.overall_db():.1f} dB overall, worst block "
              f"{lq.worst_db:.1f} dB over {lq.blocks} block(s)")
    if timer:
        timer.print_times()
        if args.store_times:
            timer.store_times(args.store_times)
    ring.close()
    return 0


def _make_feed(ring, cfg, cp_size, timer, catch_up=False, int16=False,
               device="cuda"):
    """RingFeed wired for a CP-carrying ring feeding a CP-free pipeline."""
    from ..io.feed import RingFeed

    class _CpRingView:
        """Presents the ring with CP-dropping reads as CP-free geometry."""

        def __init__(self, ring, cp):
            self._ring = ring
            self._cp = cp
            self.rows = ring.rows
            self.cols = ring.cols - cp

        def read_next_planar(self, cp=0):
            return self._ring.read_next_planar(cp=self._cp)

        def read_frame_planar(self, n, cp=0, out_re=None, out_im=None):
            return self._ring.read_frame_planar(n, cp=self._cp,
                                                out_re=out_re, out_im=out_im)

        def read_frame_planar_i16(self, n, cp=0, out_re=None, out_im=None):
            return self._ring.read_frame_planar_i16(n, cp=self._cp,
                                                    out_re=out_re,
                                                    out_im=out_im)

        @property
        def available(self):
            return self._ring.available

        @property
        def dropped(self):
            return self._ring.dropped

        @property
        def consumed(self):
            return self._ring.consumed

        @property
        def dtype(self):
            return self._ring.dtype

        def skip(self, n):
            return self._ring.skip(n)

        def shutdown(self):
            self._ring.shutdown()

    return RingFeed(_CpRingView(ring, cp_size), cfg, timer=timer,
                    catch_up=catch_up, int16=int16, device=device)


if __name__ == "__main__":
    sys.exit(main())
