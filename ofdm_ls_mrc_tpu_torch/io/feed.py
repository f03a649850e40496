"""Streaming ingest: shm ring -> pinned host frames -> card (the port's
counterpart of ``ofdm_ls_mrc_tpu.io.feed``).

The reference couples its ring reads to compute synchronously (spin-read a
symbol, cudaMemcpy, demod, repeat -- gpuLS.cu:410-473).  Here a background
thread drains the ring into ``depth`` pre-allocated planar host frames while
the card works on the previous frame.  On the card the host frames are
pinned (page-locked at construction, never per frame), each delivered frame
is copied to the device with a ``non_blocking`` copy on a side stream, an
event is recorded after the copy, and the consumer's stream waits on that
event before it computes: the copy of frame k overlaps the ring reads of
frame k+1 and whatever the consumer still has queued.  A host frame goes
back to the reader only once its copy event has completed.

The reader thread's overrun, resync and best-effort logic and the writer
ordinal are the JAX feed's, line for line: they are the feed's correctness.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import FrameConfig
from ..ops.cplx import CArray, DeviceLike, resolve_device
from ..utils.timing import PhaseTimer
from .ring import RingShutdown, RingTimeout, SymbolRing


class FrameAssembler:
    """Collects per-symbol planar reads into a [S, A, F] planar frame pair.

    dtype float32 by default; int16 for the sc16-native feed (half the host
    buffer and H2D bytes; the kernels widen on load).  ``re``/``im`` are
    numpy views of the torch tensors ``re_t``/``im_t``, pinned when ``pin``
    is set: the ring's copy-out writes straight into the page-locked
    memory the H2D copy reads."""

    def __init__(self, cfg: FrameConfig, dtype=np.float32, pin: bool = False):
        self.cfg = cfg
        s, a, f = cfg.frame_len, cfg.num_antennas, cfg.fft_size
        tdtype = torch.int16 if np.dtype(dtype) == np.int16 else torch.float32
        # CP is dropped by the ring's copy-out, so frames are CP-free here.
        self.re_t = torch.empty((s, a, f), dtype=tdtype, pin_memory=pin)
        self.im_t = torch.empty((s, a, f), dtype=tdtype, pin_memory=pin)
        self.re = self.re_t.numpy()
        self.im = self.im_t.numpy()
        self._slot = 0

    @property
    def full(self) -> bool:
        return self._slot >= self.cfg.frame_len

    def push(self, re: np.ndarray, im: np.ndarray) -> None:
        self.re[self._slot] = re
        self.im[self._slot] = im
        self._slot += 1

    def mark_full(self) -> None:
        """The batch read path fills re/im directly (read_frame_planar)."""
        self._slot = self.cfg.frame_len

    def reset(self) -> None:
        self._slot = 0


class RingFeed:
    """Iterates planar frames on ``device`` read from a SymbolRing.

    ``depth`` host assemblers rotate: while the consumer holds frame k
    (already copied or copying to the card), the reader thread fills frame
    k+1 from the ring.  Ring CP-drop and (re,im) deinterleave happen inside
    the native copy-out, so the host never touches interleaved data.

    On CPU the yielded frame is a copy of the host buffer (which is about to
    be reused), not a view of it.

    Timing (seconds, totals over the delivered frames): ``read_seconds``
    the reader's ring reads (spin-waits for the producer included),
    ``buffer_wait_seconds`` the reader waiting for a free host buffer (the
    consumer is behind), ``frame_wait_seconds`` the consumer waiting for a
    filled frame (the ring is behind), ``h2d_seconds`` the H2D copies on the
    card (CUDA events), ``copy_wait_seconds`` the host waiting for a copy
    before recycling its buffer.

    Usage:
      feed = RingFeed(ring, cfg, timer=timer)
      for frame in feed.frames():          # CArray [S, A, F] on the device
          out = receiver.demod_frame(frame)
    """

    def __init__(self, ring: SymbolRing, cfg: FrameConfig,
                 timer: Optional[PhaseTimer] = None, depth: int = 2,
                 catch_up: bool = False, int16: bool = False,
                 device: DeviceLike = "cuda"):
        if ring.cols != cfg.symbol_len:
            raise ValueError(f"ring cols {ring.cols} != symbol_len {cfg.symbol_len}")
        if ring.rows != cfg.num_antennas:
            raise ValueError(f"ring rows {ring.rows} != antennas {cfg.num_antennas}")
        self.ring = ring
        self.cfg = cfg
        self.timer = timer
        self.device = resolve_device(device, "RingFeed")
        # Real-time mode: when the consumer falls behind, skip whole queued
        # frames and resume at the freshest frame boundary -- the frame-level
        # analogue of the reference's readLastSymbol path (gpuLS.cu:419-424
        # reads the LATEST symbol for every data symbol after the first,
        # silently dropping backlog).  Skipping in frame_len multiples keeps
        # pilot/data alignment; skipped_frames counts what was dropped.
        self.catch_up = catch_up
        self.skipped_frames = 0
        # Overrun-drop detection: the default live writer (ring_write wait=0)
        # silently drops symbols on overrun, and one mid-stream drop would
        # permanently shift the consumer's pilot/data slot alignment.  The
        # reader snapshots the ring's dropped counter per frame; on a delta
        # the in-flight frame is discarded (its read may have spanned the
        # drop instant and straddled the gap) and a resync drains the
        # backlog containing the gap, then discards to the next
        # writer-stream frame boundary before re-reading (see _resync).
        self.drop_events = 0
        self.resynced_frames = 0
        self.dirty_frames = 0
        # Provenance of the MOST RECENTLY yielded frame: True when it was
        # delivered best-effort under sustained overrun (possibly
        # misaligned).  Consumers that persist output must record or drop
        # dirty frames -- a dirty frame in the same output stream as clean
        # ones is otherwise indistinguishable downstream (the observable
        # form of readLastSymbol's deliberate-loss semantics, reference
        # ShMemSymBuff.hpp:300-331).
        self.last_frame_dirty = False
        # Writer-stream ordinal of the last delivered frame: derived from
        # symbols consumed + symbols dropped, so under catch-up skips and
        # overrun drops the output can still be mapped back to WHICH
        # transmitted frame each demodulated block came from (approximate
        # for best-effort dirty frames, which are possibly misaligned).
        self.last_frame_writer_seq = -1
        self._consumed_symbols = 0
        self._pending_resync = False
        self._just_resynced = False
        # sc16-native mode: frames flow as planar int16 end to end (ring
        # copy-out -> host buffer -> H2D -> widen on load); requires the
        # ring's sc16 batch read, which the per-symbol timer path lacks.
        self.int16 = int16
        if int16 and timer is not None:
            raise ValueError("int16 feed uses the bulk read path; "
                             "per-slot read timing is unavailable")
        if int16 and (not hasattr(ring, "read_frame_planar_i16")
                      or getattr(ring, "dtype", "sc16") != "sc16"):
            # Catch the dtype mismatch HERE, not as a RingError on the
            # reader thread at first read: every SymbolRing has the i16
            # entry point, only sc16 rings can serve it.  (getattr default
            # keeps duck-typed test rings usable.)
            raise ValueError("int16 feed requires an sc16 ring "
                             "(read_frame_planar_i16)")
        cuda = self.device.type == "cuda"
        self._buffers = [FrameAssembler(cfg, np.int16 if int16 else np.float32, pin=cuda)
                         for _ in range(depth)]
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._ready: "queue.Queue" = queue.Queue(maxsize=depth - 1 or 1)
        self._free: "queue.Queue" = queue.Queue()
        for b in self._buffers:
            self._free.put(b)
        self._stop = threading.Event()
        self._reader: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.read_seconds = 0.0
        self.buffer_wait_seconds = 0.0
        self.frame_wait_seconds = 0.0
        self.h2d_seconds = 0.0
        self.copy_wait_seconds = 0.0

    # -- reader thread -----------------------------------------------------------
    def _resync(self, cp: int, fl: int) -> None:
        """Post-overrun recovery.  The gap lies somewhere inside the queued
        backlog (drops happen at the ring HEAD), so: drain the backlog, then
        discard to the next writer-stream frame boundary (stream index =
        symbols consumed + symbols dropped; the writer emits aligned frames
        from index 0).  Loses at most ring-capacity + frame_len symbols and
        repeats if further drops land while resyncing."""
        for _ in range(3):   # bounded: fresh drops can land on EVERY pass
            # The drop count is read BEFORE the drain: a drop counted after
            # it may lie behind symbols the drain leaves queued (the ring
            # refills and overruns again), and counting it would label the
            # next clean frame a whole frame ahead.  Drops that land between
            # this read and the drain change ``now`` below and retry.
            dropped = getattr(self.ring, "dropped", self._dropped_seen)
            drained = self.ring.skip(self.ring.available)
            self._consumed_symbols += drained
            mis = (self._consumed_symbols + dropped) % fl
            # Blocking read-and-discard (not skip) keeps correct
            # backpressure when the boundary symbols haven't arrived yet.
            for _ in range((fl - mis) % fl):
                self.ring.read_next_planar(cp=cp)
                self._consumed_symbols += 1
            now = getattr(self.ring, "dropped", dropped)
            if now == dropped:
                # Keep the count the alignment used: a drop since then is
                # caught by the next frame's check, not folded in unseen.
                break
        else:
            # On give-up (drops every pass: producer faster than even our
            # discard reads), fall through -- the read loop's best-effort
            # path delivers frames instead of spinning here forever, dirty
            # while the cursor sits off a writer frame boundary.
            dropped = getattr(self.ring, "dropped", dropped)
        self._dropped_seen = dropped
        self._pending_resync = False
        self._just_resynced = True
        self.resynced_frames += 1

    def _read_loop(self) -> None:
        cp = self.cfg.cyclic_prefix
        fl = self.cfg.frame_len
        self._dropped_seen = getattr(self.ring, "dropped", 0)
        # Seed the consumed counter from the ring's monotonic tail, not 0:
        # attaching to a ring a PREVIOUS consumer already read from (e.g. a
        # second demod_app against a long-running rx_app) would otherwise
        # shift every writer_seq low by the prior consumption, mis-mapping
        # output blocks to transmitted frames in the provenance index.
        self._consumed_symbols = getattr(self.ring, "consumed", 0)
        # Attaching to a ring that ALREADY overran: the backlog predates the
        # drops (the writer drops NEW symbols when full), so it is stale, its
        # frame alignment is not guaranteed, and the writer-seq identity
        # (consumed + dropped = attempt cursor) only holds once the reader
        # has drained to the write head with all drops behind it.  Start with
        # the same recovery as a mid-stream overrun: resync before the first
        # frame (costs at most ring-capacity + frame_len stale symbols).
        if self._dropped_seen:
            self._pending_resync = True
        try:
            if not self._pending_resync and (self._consumed_symbols % fl):
                # A previous consumer exited mid-frame (no drops): the
                # buffered data is good, but reads must start on a writer-
                # stream frame boundary.  Discard only up to the boundary --
                # no backlog drain.
                for _ in range(fl - self._consumed_symbols % fl):
                    self.ring.read_next_planar(cp=cp)
                    self._consumed_symbols += 1
            while not self._stop.is_set():
                t0 = time.perf_counter()
                buf = self._free.get()
                if buf is None:  # stop() sentinel
                    return
                t1 = time.perf_counter()
                self.buffer_wait_seconds += t1 - t0
                dirty = False
                while True:  # re-runs after an overrun resync
                    buf.reset()
                    if self._pending_resync:
                        self._resync(cp, fl)
                    if self.catch_up:
                        # Leave the freshest (possibly partial) frame in the
                        # ring and discard everything older, whole frames at a
                        # time (O(1) native cursor advance, no copies).
                        behind = (self.ring.available // fl) - 1
                        if behind > 0:
                            skipped = self.ring.skip(behind * fl)
                            self.skipped_frames += skipped // fl
                            self._consumed_symbols += skipped
                    if self.int16:
                        self.ring.read_frame_planar_i16(fl, cp=cp,
                                                        out_re=buf.re,
                                                        out_im=buf.im)
                        buf.mark_full()
                    elif self.timer is None and hasattr(self.ring,
                                                        "read_frame_planar"):
                        # Bulk path: one native call spin-waits and copies the
                        # whole frame straight into the assembler's planes.
                        self.ring.read_frame_planar(fl, cp=cp,
                                                    out_re=buf.re,
                                                    out_im=buf.im)
                        buf.mark_full()
                    else:
                        for slot in range(fl):
                            if self.timer:
                                with self.timer.phase("read", slot):
                                    re, im = self.ring.read_next_planar(cp=cp)
                            else:
                                re, im = self.ring.read_next_planar(cp=cp)
                            buf.push(re, im)
                    self._consumed_symbols += fl
                    dropped_now = getattr(self.ring, "dropped",
                                          self._dropped_seen)
                    if dropped_now == self._dropped_seen:
                        self._just_resynced = False
                        break
                    # The writer overran the ring.  Drops happen at the ring
                    # HEAD -- ahead of the reader -- but a frame whose read
                    # SPANNED the drop instant can straddle the gap (its
                    # tail symbols were written after the dropped one), so
                    # the triggering frame is conservatively discarded (at
                    # most one possibly-good frame lost), then a resync
                    # drains the backlog containing the gap and discards to
                    # the next writer-stream frame boundary before re-reading.
                    #
                    # EXCEPT under sustained overrun (drops landed again on
                    # the very first frame after a resync): the producer is
                    # systematically faster than the consumer, and repeating
                    # discard+resync would livelock with zero delivered
                    # frames.  Deliver best-effort frames instead (counted
                    # in ``dirty_frames``); clean recovery resumes as soon
                    # as a post-resync frame reads without new drops.
                    n_new = dropped_now - self._dropped_seen
                    self._dropped_seen = dropped_now
                    self.drop_events += 1
                    if self._just_resynced:
                        self.dirty_frames += 1
                        dirty = True
                        if self.dirty_frames == 1:
                            print("RingFeed: sustained overrun -- delivering "
                                  "BEST-EFFORT (possibly misaligned) frames; "
                                  "see the dirty-frame count in the summary",
                                  file=sys.stderr)
                        self._pending_resync = True
                        break   # deliver best-effort
                    print(f"RingFeed: writer dropped {n_new} symbol(s); "
                          f"discarding the in-flight frame and resyncing",
                          file=sys.stderr)
                    self._pending_resync = True
                if (self._consumed_symbols + self._dropped_seen) % fl:
                    # A resync gave up (fresh drops on every pass): the
                    # cursor sits OFF a writer frame boundary, so this frame
                    # is misaligned regardless of what the drop counter did
                    # during its read.  Deliver it dirty -- never clean --
                    # and keep trying to realign; without this, a burst that
                    # outruns all resync passes and then stops would stream
                    # permanently misaligned frames flagged clean.
                    if not dirty:
                        self.dirty_frames += 1
                        dirty = True
                    self._pending_resync = True
                wseq = (self._consumed_symbols + self._dropped_seen) // fl - 1
                self.read_seconds += time.perf_counter() - t1
                self._ready.put((buf, dirty, wseq))
        except (RingShutdown, RingTimeout) as e:
            self._error = e
            self._ready.put(None)  # wake the consumer
        except BaseException as e:  # propagate unexpected errors too
            self._error = e
            self._ready.put(None)

    # -- host -> device ------------------------------------------------------------
    def _to_device(self, buf: FrameAssembler):
        """The frame on the device, and the event its copy completes on
        (None on CPU, where the frame is a copy made here)."""
        if self._copy_stream is None:
            return CArray(buf.re_t.clone(), buf.im_t.clone()), None, None
        consumer = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._copy_stream):
            # Allocated on the copy stream, read on the consumer's:
            # record_stream keeps the caching allocator from handing the
            # memory out again before the consumer's queued work is done.
            start.record()
            re = buf.re_t.to(self.device, non_blocking=True)
            im = buf.im_t.to(self.device, non_blocking=True)
            done.record()
        re.record_stream(consumer)
        im.record_stream(consumer)
        consumer.wait_event(done)
        return CArray(re, im), start, done

    # -- consumer side -------------------------------------------------------------
    def frames(self, max_frames: Optional[int] = None) -> Iterator[CArray]:
        """Yield planar frames on the device until shutdown/timeout.

        One-shot: the feed owns one reader thread and its stop sentinel, so
        a second call would hang on a drained queue -- fail loud instead."""
        if self._reader is not None:
            raise RuntimeError("RingFeed.frames() was already consumed; "
                               "create a new RingFeed to keep reading")
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        n = 0
        try:
            while max_frames is None or n < max_frames:
                t0 = time.perf_counter()
                item = self._ready.get()
                self.frame_wait_seconds += time.perf_counter() - t0
                if item is None:
                    if isinstance(self._error, (RingShutdown, RingTimeout)):
                        return  # clean end-of-stream
                    raise self._error
                buf, self.last_frame_dirty, self.last_frame_writer_seq = item
                frame, start, done = self._to_device(buf)
                yield frame
                # The H2D copy must complete before the assembler is
                # recycled; by now the consumer has queued its work on the
                # frame, so this wait overlaps compute rather than
                # serializing it.
                if done is not None:
                    t0 = time.perf_counter()
                    done.synchronize()
                    self.copy_wait_seconds += time.perf_counter() - t0
                    self.h2d_seconds += start.elapsed_time(done) * 1e-3
                self._free.put(buf)
                n += 1
        finally:
            self._stop.set()

    def stop(self) -> None:
        """Stop the reader thread and join it BEFORE the ring is closed --
        the native spin loops must not touch an unmapped segment."""
        self._stop.set()
        self.ring.shutdown()      # unblocks a reader stuck in ring_read
        self._free.put(None)      # unblocks a reader stuck waiting for a buffer
        if self._reader is not None:
            self._reader.join(timeout=10.0)
