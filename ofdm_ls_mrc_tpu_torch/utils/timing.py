"""Phase-timing benchmark harness (reference C14); the port's copy of
``ofdm_ls_mrc_tpu.utils.timing``, writing through the port's ``golden.io``.

Replicates the reference's instrumentation contract: per-symbol wall timers
around read / FFT / channel-estimation / decode / prefix-drop phases
(ShMemSymBuff.hpp:77-83; cpuLS.hpp:273-316; gpuLS.cu:361-401), avg+variance
summarization (findAvgAndVar, ShMemSymBuff.hpp:125-147), the console table
(printTimes, ShMemSymBuff.hpp:149-164, frame-latency line
ShMemSymBuff_cucomplex.hpp:166-172), and the binary 5-word dump
(storeTimes, ShMemSymBuff.hpp:166-189) via golden.io.store_times.

Normalization: the reference accumulates into each slot exactly ``numTimes``
times and divides once at report time (cpuLS.hpp:284 ``fft[it] += ...``;
printTimes /numTimes, ShMemSymBuff.hpp:154-157).  This class generalizes
that contract to NON-uniform slot occupancy -- e.g. demod_app's whole-frame
mode, where frames cycle decode slots 1..L-1 so each slot receives ~N/(L-1)
samples -- by tracking a per-slot occurrence count and dividing each slot's
accumulated total by its OWN count.  When every slot is hit exactly
``numTimes`` times (the reference pattern), the reported AVERAGES are
identical to the reference's.  The reported variance matches printTimes
semantics too: the reference computes the population variance of the
per-slot accumulated TOTALS and divides it once by numTimes
(ShMemSymBuff.hpp:136-140,154), i.e. var(totals)/numTimes =
var(per-slot means) * numTimes under uniform occupancy -- so the summary
scales the variance of the per-slot means by the mean occurrence count of
the occupied slots (exactly numTimes in the reference pattern).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from ..golden.io import store_times as _store_times_file

PHASES = ("read", "fft", "chanest", "decode", "drop")


def find_avg_and_var(times: np.ndarray) -> Tuple[float, float]:
    """Mean and population variance, matching findAvgAndVar
    (ShMemSymBuff.hpp:125-147)."""
    t = np.asarray(times, dtype=np.float64)
    if t.size == 0:
        return 0.0, 0.0
    avg = float(t.mean())
    var = float(((t - avg) ** 2).mean())
    return avg, var


@dataclass
class PhaseTimer:
    """Accumulates per-symbol (or per-frame) phase times by frame slot.

    ``num_times`` is informational (the configured outer repetition count);
    all statistics divide by the actual per-slot occurrence counts, so
    unevenly-filled slots (whole-frame mode) and the uniform reference
    pattern both report faithful per-occurrence times.
    """

    num_slots: int
    num_times: int = 1
    data: Dict[str, np.ndarray] = field(default_factory=dict)
    counts: Dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        for p in PHASES:
            self.data[p] = np.zeros(self.num_slots, dtype=np.float64)
            self.counts[p] = np.zeros(self.num_slots, dtype=np.int64)

    @contextlib.contextmanager
    def phase(self, name: str, slot: int):
        t0 = time.perf_counter()
        yield
        self.data[name][slot] += time.perf_counter() - t0
        self.counts[name][slot] += 1

    def add(self, name: str, slot: int, seconds: float) -> None:
        self.data[name][slot] += seconds
        self.counts[name][slot] += 1

    # -- reporting -----------------------------------------------------------
    def slot_means(self, name: str) -> np.ndarray:
        """Per-slot mean seconds per occurrence (0 for slots never hit)."""
        c = self.counts[name]
        return np.divide(self.data[name], c, out=np.zeros(self.num_slots),
                         where=c > 0)

    def _stats(self, name: str, skip_slot0: bool = False) -> Tuple[float, float]:
        means = self.slot_means(name)
        hit = self.counts[name] > 0
        counts = self.counts[name]
        if skip_slot0 and self.num_slots > 1:
            means, hit, counts = means[1:], hit[1:], counts[1:]
        avg, var = find_avg_and_var(means[hit])
        # printTimes-parity variance scale: the reference reports
        # var(per-slot TOTALS)/numTimes (ShMemSymBuff.hpp:136-140,154),
        # which equals var(per-slot means) * numTimes when every slot is
        # hit numTimes times; generalize to the mean occurrence count.
        if hit.any():
            var *= float(counts[hit].mean())
        return avg, var

    def summary(self) -> Dict[str, Tuple[float, float]]:
        """Phase -> (avg, var) per occurrence across occupied slots.

        'chanest' is slot 0 of decode in the reference (decode[0],
        ShMemSymBuff.hpp:155); here it is its own phase array, and 'decode'
        statistics skip slot 0 to mirror &decode[1] (ShMemSymBuff.hpp:151).
        """
        out = {}
        out["read"] = self._stats("read")
        ce = self.slot_means("chanest")
        ce_hit = self.counts["chanest"] > 0
        out["chanest"] = (float(ce[ce_hit].mean()) if ce_hit.any() else 0.0, 0.0)
        out["decode"] = self._stats("decode", skip_slot0=True)
        out["fft"] = self._stats("fft")
        out["drop"] = self._stats("drop")
        return out

    def frame_latency(self) -> float:
        """(FFT + read + decode) * (num_slots - 1), the derived frame-latency
        line of ShMemSymBuff_cucomplex.hpp:170."""
        s = self.summary()
        return (s["fft"][0] + s["read"][0] + s["decode"][0]) * (self.num_slots - 1)

    def print_times(self, include_drop: bool = True) -> str:
        """Console table in the reference's printTimes layout."""
        s = self.summary()
        lines = ["\t \t Avg Time(s) \t Variance (s^2)"]
        lines.append(f"Read: \t \t {s['read'][0]:e} \t {s['read'][1]:e}")
        lines.append(f"ChanEst: \t {s['chanest'][0]:e}")
        lines.append(f"Decode: \t {s['decode'][0]:e} \t {s['decode'][1]:e}")
        lines.append(f"FFT: \t \t {s['fft'][0]:e} \t {s['fft'][1]:e}")
        if include_drop:
            lines.append(f"Drop: \t \t {s['drop'][0]:e} \t {s['drop'][1]:e}")
        lines.append(f"Frame latency: \t {self.frame_latency():e}")
        text = "\n".join(lines)
        print(text)
        return text

    def store_times(self, path: str) -> None:
        """Binary 5-word dump, layout-compatible with time_{cpu,gpu}.dat."""
        s = self.summary()
        _store_times_file(path, s["read"][0], s["chanest"][0], s["decode"][0],
                          s["fft"][0], s["drop"][0])
