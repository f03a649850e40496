"""The port's RingFeed against the JAX package's, on the same ring contents.

The reader thread's overrun, resync and best-effort logic and the writer
ordinal were carried over line for line, but for where the resync reads the
drop count (before its drain, not after: see
``test_drop_after_the_drain_is_not_counted_ahead_of_the_queue``); these
tests hold the two feeds to the same frames, bit for bit, and the same
provenance after every frame
(``last_frame_dirty``, ``last_frame_writer_seq``) and at the end
(``drop_events``, ``resynced_frames``, ``dirty_frames``,
``skipped_frames``).  Scripted rings pin where drops land (a real no-wait
overrun cannot); real rings cover the bulk reads, catch-up, a reader that
attaches after an overrun or after another consumer, and the int16 feed.
On the CPU (here) the port's frames are copies of its host buffers, which
these tests check by holding every frame until the end.
"""

import threading
import uuid

import numpy as np
import pytest

from ofdm_ls_mrc_tpu import FrameConfig as JaxFrameConfig
from ofdm_ls_mrc_tpu.io import ring as jring
from ofdm_ls_mrc_tpu.io.feed import RingFeed as JaxRingFeed
from ofdm_ls_mrc_tpu_torch import FrameConfig
from ofdm_ls_mrc_tpu_torch.io import ring as pring
from ofdm_ls_mrc_tpu_torch.io.feed import RingFeed
from ofdm_ls_mrc_tpu_torch.utils.timing import PhaseTimer

ROWS, COLS = 4, 256
PACKAGES = {
    "jax": (JaxRingFeed, JaxFrameConfig, jring, {}),
    "port": (RingFeed, FrameConfig, pring, {"device": "cpu"}),
}
COUNTERS = ("drop_events", "resynced_frames", "dirty_frames", "skipped_frames")


class _ScriptedRing:
    """Duck-typed ring delivering a scripted consumer stream: each entry is
    (writer_stream_idx, dropped_total_after_this_read); ``queued`` of the
    upcoming entries sit in the ring when the feed resyncs (the drain skips
    exactly those).  The symbol's planes hold its writer index (re) and a
    value from it (im)."""

    def __init__(self, stream, shutdown_error, queued=0):
        self.rows, self.cols = ROWS, COLS
        self._stream = list(stream)
        self._dropped = 0
        self._queued = queued
        self._shutdown_error = shutdown_error

    def read_next_planar(self, cp=0):
        if not self._stream:
            raise self._shutdown_error("stream exhausted")
        idx, dropped = self._stream.pop(0)
        self._dropped = dropped
        self._queued = max(self._queued - 1, 0)
        re = np.full((self.rows, self.cols), float(idx), np.float32)
        return re, np.sqrt(re + np.arange(self.cols, dtype=np.float32))

    @property
    def dropped(self):
        return self._dropped

    @property
    def available(self):
        return min(self._queued, len(self._stream))

    def skip(self, n):
        k = min(n, self.available)
        for _ in range(k):
            self.read_next_planar()
        return k

    def shutdown(self):
        self._stream = []


class _RefillingRing(_ScriptedRing):
    """A scripted ring whose writer, right after the resync's first drain,
    refills ``refill`` symbols and then drops a whole frame: the count rises
    to ``dropped_after`` before the feed can read it."""

    def __init__(self, stream, shutdown_error, queued, refill, dropped_after):
        super().__init__(stream, shutdown_error, queued)
        self._refill, self._dropped_after = refill, dropped_after

    def skip(self, n):
        k = super().skip(n)
        if self._refill:
            self._queued, self._dropped = self._refill, self._dropped_after
            self._refill = 0
        return k


def _drive(pkg, ring, fl, max_frames, **kw):
    """Run one package's feed; returns per-frame (re, im, dirty, wseq) with
    the frames held until the end, and the feed's counters."""
    feed_cls, cfg_cls, _, extra = PACKAGES[pkg]
    cfg = cfg_cls(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0, frame_len=fl)
    feed = feed_cls(ring, cfg, **kw, **extra)
    held = []
    for frame in feed.frames(max_frames=max_frames):
        held.append((frame, feed.last_frame_dirty, feed.last_frame_writer_seq))
    feed.stop()
    frames = [(np.asarray(f.re), np.asarray(f.im), d, w) for f, d, w in held]
    return frames, {name: getattr(feed, name) for name in COUNTERS}


def _assert_same(jax_run, port_run):
    (jframes, jcount), (pframes, pcount) = jax_run, port_run
    assert pcount == jcount
    assert len(pframes) == len(jframes)
    for (pre, pim, pd, pw), (jre, jim, jd, jw) in zip(pframes, jframes):
        assert (pd, pw) == (jd, jw)
        assert pre.dtype == jre.dtype and pre.shape == jre.shape
        np.testing.assert_array_equal(pre, jre)
        np.testing.assert_array_equal(pim, jim)


# (stream, queued, frame_len, frames to take, expected (first re column of
# each frame, dirty flags), expected counters) -- the JAX package's own
# scripted cases (tests/test_ring.py) and a sustained-overrun burst.
SCRIPTS = {
    "drop-discards-in-flight-frame": (
        [(0, 0), (1, 1), (2, 1), (3, 1), (5, 1), (6, 1), (7, 1), (8, 1),
         (9, 1), (10, 1), (11, 1)], 0, 3, 2,
        ([6, 9], [False, False]), (1, 1, 0, 0)),
    "resync-drains-backlog-first": (
        [(0, 0), (1, 1), (2, 1), (3, 1), (4, 1), (5, 1), (6, 1), (8, 1),
         (9, 1), (10, 1), (11, 1)], 8, 3, 1,
        ([9], [False]), (1, 1, 0, 0)),
    "whole-frame-drop-realigns": (
        [(0, 0), (1, 0), (2, 3), (6, 3), (7, 3), (8, 3)], 0, 3, 1,
        ([6], [False]), (1, 1, 0, 0)),
    "resync-gives-up-misaligned-dirty": (
        [(0, 0), (1, 0), (2, 1), (3, 2), (4, 2), (5, 3), (6, 3), (7, 4), (8, 4)]
        + [(9 + i, 4) for i in range(8)], 0, 3, 2,
        ([9, 14], [True, False]), (1, 2, 1, 0)),
    "sustained-overrun-best-effort": (
        [(0, 0), (1, 0), (2, 1), (4, 1), (5, 1), (6, 1), (7, 2), (8, 2),
         (10, 2), (11, 2), (12, 2), (13, 2), (14, 2)], 0, 3, 2,
        ([6, 12], [True, False]), (2, 2, 1, 0)),
    "clean-stream": (
        [(i, 0) for i in range(12)], 0, 4, 3,
        ([0, 4, 8], [False, False, False]), (0, 0, 0, 0)),
}


@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_scripted_ring_same_frames_and_provenance(case, timed):
    stream, queued, fl, n, (starts, dirty), counts = SCRIPTS[case]
    runs = {}
    for pkg in ("jax", "port"):
        ring = _ScriptedRing(stream, PACKAGES[pkg][2].RingShutdown, queued=queued)
        kw = {"timer": PhaseTimer(num_slots=fl)} if timed else {}
        runs[pkg] = _drive(pkg, ring, fl, n, **kw)
    _assert_same(runs["jax"], runs["port"])
    frames, got = runs["port"]
    assert [int(re[0, 0, 0]) for re, _, _, _ in frames] == starts
    assert [d for _, _, d, _ in frames] == dirty
    assert tuple(got[name] for name in COUNTERS) == counts


def _rings(pkg, length, dtype="complex64"):
    rmod = PACKAGES[pkg][2]
    uid = f"/ofdm_tfeed_{uuid.uuid4().hex[:12]}"
    w = rmod.SymbolRing(uid, ROWS, COLS, length, master=True, timeout=10.0, dtype=dtype)
    r = rmod.SymbolRing(uid, ROWS, COLS, length, master=False, timeout=10.0, dtype=dtype)
    return w, r


def _frame_syms(k, fl, seed=0):
    """Writer frame k: [fl, ROWS, COLS] complex64, distinct per frame."""
    rng = np.random.default_rng(1000 * seed + k)
    z = 0.1 * (rng.standard_normal((fl, ROWS, COLS)) + 1j * rng.standard_normal((fl, ROWS, COLS)))
    return z.astype(np.complex64)


def _real_ring_run(pkg, scenario, fl=3):
    """One package's feed over a real ring driven by ``scenario``."""
    threads = []
    if scenario == "catch-up":
        w, r = _rings(pkg, 4 * fl)
        for k in range(3):                     # the producer raced 3 frames ahead
            w.write_batch(_frame_syms(k, fl))
        kw, n = {"catch_up": True}, 1
    elif scenario == "catch-up-keeping-up":
        w, r = _rings(pkg, 2 * fl)
        w.write_batch(_frame_syms(0, fl))
        kw, n = {"catch_up": True}, 1
    elif scenario == "prior-consumer":
        w, r = _rings(pkg, 4 * fl)
        for k in range(3):
            w.write_batch(_frame_syms(k, fl))
        assert r.skip(fl) == fl                # a consumer read frame 0 and left
        kw, n = {}, 2
    elif scenario == "prior-consumer-mid-frame":
        w, r = _rings(pkg, 4 * fl)
        for k in range(3):
            w.write_batch(_frame_syms(k, fl))
        assert r.skip(fl + 1) == fl + 1        # ... and stopped inside frame 1
        kw, n = {}, 1
    elif scenario == "attach-after-overrun":
        w, r = _rings(pkg, fl)                 # one-frame ring: overruns at once
        for k in (0, 1):                       # frame 0 stored, frame 1 dropped
            assert w.write_batch(_frame_syms(k, fl), wait=False) == (fl if k == 0 else 0)
        threads.append(threading.Thread(target=lambda: w.write_batch(_frame_syms(2, fl))))
        kw, n = {}, 1
    elif scenario == "depth-3":
        w, r = _rings(pkg, 2 * fl)
        threads.append(threading.Thread(target=lambda: [w.write_batch(_frame_syms(k, fl))
                                                        for k in range(5)]))
        kw, n = {"depth": 3}, 5
    else:  # int16
        w, r = _rings(pkg, 2 * fl, dtype="sc16")
        threads.append(threading.Thread(target=lambda: [w.write_batch(_frame_syms(k, fl))
                                                        for k in range(4)]))
        kw, n = {"int16": True}, 4
    for t in threads:
        t.start()
    try:
        return _drive(pkg, r, fl, n, **kw)
    finally:
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
        r.close()
        w.close()


REAL_SCENARIOS = {
    # scenario: (first frame's writer ordinals, counters)
    "catch-up": ([2], (0, 0, 0, 2)),
    "catch-up-keeping-up": ([0], (0, 0, 0, 0)),
    "prior-consumer": ([1, 2], (0, 0, 0, 0)),
    "prior-consumer-mid-frame": ([2], (0, 0, 0, 0)),
    "attach-after-overrun": ([2], (0, 1, 0, 0)),
    "depth-3": ([0, 1, 2, 3, 4], (0, 0, 0, 0)),
    "int16": ([0, 1, 2, 3], (0, 0, 0, 0)),
}


@pytest.mark.parametrize("scenario", sorted(REAL_SCENARIOS))
def test_real_ring_same_frames_and_provenance(scenario):
    runs = {pkg: _real_ring_run(pkg, scenario) for pkg in ("jax", "port")}
    _assert_same(runs["jax"], runs["port"])
    frames, got = runs["port"]
    wseqs, counts = REAL_SCENARIOS[scenario]
    assert [w for _, _, _, w in frames] == wseqs
    assert not any(d for _, _, d, _ in frames)
    assert tuple(got[name] for name in COUNTERS) == counts
    # The frames are the writer's frames (held to the end: copies, not
    # views of recycled host buffers).
    from ofdm_ls_mrc_tpu_torch.golden.io import complex_to_sc16
    for re, im, _, wseq in frames:
        want = _frame_syms(wseq, 3)
        if scenario == "int16":
            iq = complex_to_sc16(want)
            np.testing.assert_array_equal(re, iq[..., 0::2])
            np.testing.assert_array_equal(im, iq[..., 1::2])
        else:
            np.testing.assert_array_equal(re, want.real)
            np.testing.assert_array_equal(im, want.imag)


def test_drop_after_the_drain_is_not_counted_ahead_of_the_queue():
    """Frame 0 reads clean; symbol 3 drops while frame 1 is read, so frame 1
    is discarded and the feed resyncs over the queued 7-9.  Right after that
    drain the writer queues 10-12 and drops 13-15.  The port read the count
    before the drain, so the drop shows up as a change, it resyncs again and
    the next frames are the writer's frames 6 and 7.  The JAX package reads
    the count after the drain and delivers 12, 16, 17 as a clean frame 5."""
    fl = 3
    stream = ([(i, 0) for i in range(3)] + [(i, 1) for i in range(4, 10)]
              + [(i, 4) for i in (10, 11, 12)] + [(i, 4) for i in range(16, 24)])

    def run(pkg, n):                 # n: the frames the script holds for pkg
        ring = _RefillingRing(stream, PACKAGES[pkg][2].RingShutdown, queued=9,
                              refill=3, dropped_after=4)
        return _drive(pkg, ring, fl, n)

    frames, counts = run("port", 3)
    assert [(int(re[0, 0, 0]), d, w) for re, _, d, w in frames] == [
        (0, False, 0), (18, False, 6), (21, False, 7)]
    for re, _, _, w in frames:                  # every symbol its own frame's
        np.testing.assert_array_equal(re[:, 0, 0], np.arange(fl) + fl * w)
    assert tuple(counts[name] for name in COUNTERS) == (1, 1, 0, 0)
    jframes, _ = run("jax", 4)
    assert [(re[:, 0, 0].tolist(), d, w) for re, _, d, w in jframes[1:2]] == [
        ([12.0, 16.0, 17.0], False, 5)]


def test_port_feed_rejects_what_the_jax_feed_rejects():
    cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0, frame_len=3)
    w, r = _rings("port", 6)
    try:
        with pytest.raises(ValueError, match="sc16"):
            RingFeed(r, cfg, int16=True, device="cpu")
        with pytest.raises(ValueError, match="per-slot"):
            RingFeed(r, cfg, int16=True, timer=PhaseTimer(num_slots=3), device="cpu")
        with pytest.raises(ValueError, match="cols"):
            RingFeed(r, FrameConfig(num_antennas=ROWS, fft_size=128, frame_len=3),
                     device="cpu")
        feed = RingFeed(_ScriptedRing([(i, 0) for i in range(6)], pring.RingShutdown),
                        cfg, device="cpu")
        next(feed.frames(max_frames=1))
        with pytest.raises(RuntimeError, match="already consumed"):
            next(feed.frames(max_frames=1))
        feed.stop()
    finally:
        r.close()
        w.close()


def test_port_feed_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = FrameConfig(num_antennas=ROWS, fft_size=COLS, cyclic_prefix=0, frame_len=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RingFeed(_ScriptedRing([], pring.RingShutdown), cfg)
