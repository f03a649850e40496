"""On the card: the program's spans against the device trace, for both
cells' shapes at a short window."""

import time

import pytest
import torch

from ofdm_ls_mrc_tpu_torch.utils import profiling
from portbench import harness, spec, trace

CELLS = ("orbit16.capture", "nr64.capture")
# The profiler maps the card's timestamps onto the host's clock; on an H100
# a kernel issued into an idle stream read as starting up to 1.3 us before
# the host span that launched it (one kernel of ~170,000), so the order of
# a launch and its kernel holds to this much.
CLOCK_SLACK_NS = 5_000


def _traced_run(name, card, monkeypatch):
    """A traced run of the cell: (its result, the Run its readers read)."""
    cell = spec.find_cell(spec.load_spec(spec.BENCH_DIR.parent), name)
    runs = []
    real = spec.read_metrics

    def keep(metrics, run, *args, **kwargs):
        runs.append(run)
        return real(metrics, run, *args, **kwargs)

    monkeypatch.setattr(spec, "read_metrics", keep)
    profiling.clear_spans()
    out = harness.run_cell(cell, 2**31 + 103, 1.0, True, device=card,
                           started=time.perf_counter())
    return out["result"], runs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_call_launches_two_kernels_after_their_launch_spans(card, name, monkeypatch):
    res, run = _traced_run(name, card, monkeypatch)
    assert res["correct"]
    lo, hi = run.loop.epoch_ns
    inside = [r for r in profiling.spans() if lo <= r.start_ns and r.end_ns <= hi]
    launch = sorted((r for r in inside if r.name.endswith(".launch")), key=lambda r: r.start_ns)
    assert len(launch) == 2 * run.loop.calls
    assert sum(r.name == profiling.LAUNCH for r in inside) == len(launch)
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    assert metrics["launches_per_call"] == 2.0
    assert metrics["host_prepare_us"] + metrics["host_launch_us"] <= metrics["host_call_us"]
    assert metrics["host_tables_per_call"] == (0.0 if name == "orbit16.capture" else 1.0)
    assert 0 <= metrics["device_idle_prepare_pct"] <= metrics["device_idle_pct"]
    kernels = sorted(run.ops, key=lambda o: o[1])
    assert len(kernels) == len(launch)
    for (kname, start, _), span in zip(kernels, launch):
        pilot = trace.kernel_name(kname).startswith("pilot_")
        assert pilot == (span.name == "pilot.launch")
    lead = min(start - span.start_ns for (_, start, _), span in zip(kernels, launch))
    assert lead >= -CLOCK_SLACK_NS, f"a kernel began {-lead} ns before its launch span"


@pytest.mark.cuda
def test_a_synchronized_kernel_lies_inside_its_span_on_the_trace_clock(card):
    from torch.profiler import ProfilerActivity, profile

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(trace.PAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize(card)
        with profiling.annotate("probe"):
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize(card)
    span, = [r for r in profiling.spans() if r.name == "probe"]
    from torch.autograd import DeviceType

    sleeps = [(int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and trace.PAD_KERNEL in e.name()]
    start, end = max(sleeps, key=lambda s: s[1] - s[0])
    assert span.start_ns <= start < end <= span.end_ns
    assert end - start > (span.end_ns - span.start_ns) // 2     # the long sleep, not a pad kernel
    profiling.clear_spans()
