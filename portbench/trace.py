"""The device trace of a window: ``torch.profiler`` on the card's activity.

Late in a process the profiler loses the first device events of a trace,
so the trace opens with ``PAD`` spin kernels that are left out by name
(``ofdm_ls_mrc_tpu_torch/utils/profiling.py``'s pad, copied).  The window
is the host's, on the profiler's clock (epoch nanoseconds); the reader
keeps each device operation inside it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Dict, List, Tuple

import torch

PAD = 64
PAD_KERNEL = "spin_kernel"
Op = Tuple[str, int, int]          # (name, start ns, end ns)


@contextlib.contextmanager
def profiled(device: torch.device):
    """Profile the block; yields a list that holds the device operations
    ([] on the CPU) once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    ops: List[Op] = []
    cuda = device.type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
    with prof:
        if cuda:
            for _ in range(PAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize(device)
        yield ops
    if cuda:
        ops.extend(device_ops(prof))


def device_ops(prof) -> List[Op]:
    """Every operation the trace holds on the card, the pad left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or _annotation(e):
            continue
        name = e.name()
        if PAD_KERNEL in name:
            continue
        start = int(e.start_ns())
        out.append((name, start, start + int(e.duration_ns())))
    return out


def _annotation(e) -> bool:
    """A range the profiler marks on the device's track, not an operation
    (the event's API differs between torch versions)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None and "annotation" in str(kind()):
        return True
    return bool(getattr(e, "is_user_annotation", lambda: False)())


def within(ops: List[Op], window: Tuple[int, int]) -> List[Op]:
    lo, hi = window
    return sorted((o for o in ops if o[2] > lo and o[1] < hi), key=lambda o: o[1])


def kernel_name(name: str) -> str:
    """``void ofdm::pilot_ls_push_kernel<4096, 4, true>(...)`` ->
    ``pilot_ls_push_kernel``."""
    base = name[5:] if name.startswith("void ") else name
    base = base.split("(")[0].split("<")[0]
    return base.split("::")[-1].strip()


def busy(ops: List[Op], window: Tuple[int, int]) -> Tuple[int, List[Tuple[int, int]]]:
    """Nanoseconds in which some operation ran, inside the window, and the
    idle gaps between (start, end)."""
    lo, hi = window
    total, gaps, cur_s, cur_e = 0, [], None, None
    for _, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None:
            gaps.append((lo, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is None:
        return 0, [(lo, hi)]
    total += cur_e - cur_s
    gaps.append((cur_e, hi))
    return total, [g for g in gaps if g[1] > g[0]]


def label_gaps(gaps: List[Tuple[int, int]], spans: List[Tuple[str, int, int]]
               ) -> Dict[str, Tuple[int, int]]:
    """{host span open at a gap's start: (idle ns, gaps)}; "portbench.loop"
    where none was (the harness between spans)."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out: Dict[str, List[int]] = collections.defaultdict(lambda: [0, 0])
    for g0, g1 in gaps:
        j = bisect.bisect_right(starts, g0) - 1
        label = spans[j][0] if j >= 0 and spans[j][2] > g0 else "portbench.loop"
        out[label][0] += g1 - g0
        out[label][1] += 1
    return {k: (v[0], v[1]) for k, v in out.items()}


def top_ops(ops: List[Op], n: int = 10) -> List[Tuple[str, float]]:
    """The n operations that took most device time, by name, in seconds."""
    tot: Dict[str, int] = collections.defaultdict(int)
    for name, s, e in ops:
        tot[name.split("(")[0][:160]] += e - s
    return [(k, v / 1e9) for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def stage_ns(ops: List[Op]) -> Tuple[int, int]:
    """(pilot ns, other ns): the pilot stage is the kernels named
    ``pilot_*``; the data stage every other operation."""
    pilot = other = 0
    for name, s, e in ops:
        if kernel_name(name).startswith("pilot_"):
            pilot += e - s
        else:
            other += e - s
    return pilot, other
