"""The one generator of traffic: the loop that drives the entry in the window.

A traffic file gives "loop" and its parameters:

  closed  captures of ``frames_per_call`` frames issued back to back, at
          most ``in_flight`` in flight (the live feed's double buffer),
          over ``buffers`` distinct captures in turn;
  open    every ``period_us`` a batch of ``slots_per_sector`` slots of each
          of ``sectors`` sectors is due, handed over as one call, over
          ``buffers`` distinct batches in turn; a batch is done when the
          host sees its event complete.

Each loop keeps, from the seed, a uniform sample of ``sample_calls`` calls'
outputs (reservoir sampling) for the check after the window, and records
the host spans that the trace reader labels the device's idle gaps with:
``portbench.issue`` (inside the entry), ``portbench.wait`` (waiting for the
card) and ``portbench.due`` (waiting for the next batch to fall due).
"""

from __future__ import annotations

import collections
import dataclasses
import random
import time
from typing import Callable, List, Optional, Tuple

import torch

DRAIN_S = 60.0      # how long the loop waits for the last calls after the window
# The open loop asks the card whether the oldest batch is done at most this
# often: a completion is seen within it, and a trace of the window holds one
# query of the runtime per poll, not one per turn of the loop.
POLL_NS = 10_000


class _Done:
    """An event on the CPU, where every call has ended when it returns."""

    def record(self) -> None:
        pass

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


def new_event(device: torch.device):
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
        return ev
    return _Done()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class LoopRecord:
    calls: int = 0                       # calls issued in the window
    done: int = 0                        # calls seen complete
    window_s: float = 0.0                # first issue (or due time) to the last completion
    call_ns: List[int] = dataclasses.field(default_factory=list)     # host time in the entry
    due_ns: List[int] = dataclasses.field(default_factory=list)      # open loop: due times
    issue_ns: List[int] = dataclasses.field(default_factory=list)    # open loop: issue times
    done_ns: List[Optional[int]] = dataclasses.field(default_factory=list)  # completion seen
    kept: List[Tuple[int, int, object]] = dataclasses.field(default_factory=list)  # (call, buffer, out)
    spans: List[Tuple[str, int, int]] = dataclasses.field(default_factory=list)    # epoch ns
    epoch_ns: Tuple[int, int] = (0, 0)   # the window on the profiler's clock


class _Sample:
    """Reservoir of ``size`` (call, buffer, output), uniform over the calls."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.items: List[Tuple[int, int, object]] = []

    def offer(self, i: int, buf: int, out) -> None:
        if i < self.size:
            self.items.append((i, buf, out))
            return
        j = self.rng.randrange(i + 1)
        if j < self.size:
            self.items[j] = (i, buf, out)


def closed_loop(entry: Callable, bufs: list, traffic: dict, seconds: float, seed: int,
                device: torch.device, spans: bool) -> LoopRecord:
    rec = LoopRecord()
    sample = _Sample(int(traffic["sample_calls"]), seed)
    in_flight = int(traffic["in_flight"])
    pending = collections.deque()
    nbuf = len(bufs)
    clock = time.perf_counter_ns
    wall = time.time_ns if spans else None
    synchronize(device)
    e0 = wall() if spans else 0
    t0 = clock()
    end = t0 + int(seconds * 1e9)
    while clock() < end:
        i = rec.calls
        w0 = wall() if spans else 0
        c0 = clock()
        out = entry(bufs[i % nbuf])
        c1 = clock()
        if spans:
            rec.spans.append(("portbench.issue", w0, w0 + (c1 - c0)))
        pending.append(new_event(device))
        rec.call_ns.append(c1 - c0)
        sample.offer(i, i % nbuf, out)
        rec.calls += 1
        while len(pending) >= in_flight:
            w0 = wall() if spans else 0
            pending.popleft().synchronize()
            if spans:
                rec.spans.append(("portbench.wait", w0, wall()))
    w0 = wall() if spans else 0
    synchronize(device)
    t1 = clock()
    if spans:
        e1 = wall()
        rec.spans.append(("portbench.wait", w0, e1))
        rec.epoch_ns = (e0, e1)
    rec.done = rec.calls
    rec.window_s = (t1 - t0) / 1e9
    rec.kept = sample.items
    return rec


def open_loop(entry: Callable, bufs: list, traffic: dict, seconds: float, seed: int,
              device: torch.device, spans: bool) -> LoopRecord:
    rec = LoopRecord()
    sample = _Sample(int(traffic["sample_calls"]), seed)
    period = int(float(traffic["period_us"]) * 1e3)
    n_due = max(1, int(seconds * 1e9) // period)
    nbuf = len(bufs)
    pending = collections.deque()       # (call, event)
    rec.done_ns = [None] * n_due
    clock = time.perf_counter_ns
    wall = time.time_ns if spans else None
    synchronize(device)
    e0 = wall() if spans else 0
    t0 = clock() + period               # the first batch falls due one period from now
    w_due = e0
    i = 0
    poll = 0
    while i < n_due:
        due = t0 + i * period
        now = clock()
        if now >= poll:
            while pending and pending[0][1].query():
                rec.done_ns[pending.popleft()[0]] = now
                rec.done += 1
            poll = now + POLL_NS
        if now < due:
            continue
        w0 = wall() if spans else 0
        c0 = clock()
        out = entry(bufs[i % nbuf])
        c1 = clock()
        pending.append((i, new_event(device)))
        if spans:
            rec.spans.append(("portbench.due", w_due, w0))
            w_due = w0 + (c1 - c0)
            rec.spans.append(("portbench.issue", w0, w_due))
        rec.due_ns.append(due)
        rec.issue_ns.append(c0)
        rec.call_ns.append(c1 - c0)
        sample.offer(i, i % nbuf, out)
        i += 1
    rec.calls = n_due
    w0 = wall() if spans else 0
    give_up = clock() + int(DRAIN_S * 1e9)
    while pending and clock() < give_up:
        now = clock()
        if now < poll:
            continue
        poll = now + POLL_NS
        if pending[0][1].query():
            rec.done_ns[pending.popleft()[0]] = now
            rec.done += 1
    last = max((d for d in rec.done_ns if d is not None), default=clock())
    if spans:
        e1 = wall()
        rec.spans.append(("portbench.wait", w0, e1))
        rec.epoch_ns = (e0, e1)
    synchronize(device)
    rec.window_s = (last - (t0 - period)) / 1e9
    rec.kept = sample.items
    return rec


LOOPS = {"closed": closed_loop, "open": open_loop}
