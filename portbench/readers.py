"""Arithmetic that several metric readers share."""

from __future__ import annotations

import math
from typing import Optional, Sequence

from portbench import trace


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile; None for no values."""
    if not values:
        return None
    ranked = sorted(values)
    return ranked[max(0, math.ceil(q / 100.0 * len(ranked)) - 1)]


def idle_pct(run) -> Optional[float]:
    """Share of the traced window in which nothing ran on the card."""
    if not run.ops:
        return None
    window = run.loop.epoch_ns[1] - run.loop.epoch_ns[0]
    busy_ns, _ = trace.busy(run.ops, run.loop.epoch_ns)
    return 100.0 * (window - busy_ns) / window


def host_call_us(run) -> Optional[float]:
    """Mean host time of one call of the entry, to its return."""
    ns = run.loop.call_ns
    return sum(ns) / len(ns) / 1e3 if ns else None
