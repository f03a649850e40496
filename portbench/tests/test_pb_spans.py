"""The readers of the program's spans and counters (host_prepare_us,
host_launch_us, host_tables_per_call, launches_per_call,
device_idle_prepare_pct) on hand-made spans and device operations, on a
program without spans, and on a traced CPU run of the tiny cell."""

import pytest

from conftest import run_tiny
from ofdm_ls_mrc_tpu_torch.utils import profiling
from ofdm_ls_mrc_tpu_torch.utils.profiling import Span
from portbench import harness, loops, spec

NEW = ("host_prepare_us", "host_launch_us", "host_tables_per_call", "launches_per_call",
       "device_idle_prepare_pct")


def _call(call, t):
    """The records of one call that starts at t (ns), as the program closes
    them: pilot.prepare 40, pilot.launch 20, data.prepare 100 (computing
    one table), data.launch 20."""
    root = "rx.demod_capture"
    return [Span("pilot.prepare", call, root, t + 10, t + 50),
            Span("kernel.launched", call, "pilot.launch", t + 60, t + 60),
            Span("pilot.launch", call, root, t + 50, t + 70),
            Span("plan.table", call, "data.prepare", t + 80, t + 80),
            Span("data.prepare", call, root, t + 70, t + 170),
            Span("kernel.launched", call, "data.launch", t + 180, t + 180),
            Span("data.launch", call, root, t + 170, t + 190),
            Span(root, call, None, t, t + 200)]


def _run(ops=None, calls=2):
    rec = loops.LoopRecord(calls=calls, epoch_ns=(1000, 2000))
    return harness.Run({}, {"loop": "closed"}, 64, 1.0, rec, ops)


@pytest.fixture
def records(monkeypatch):
    """Two calls inside the window (1000, 2000) and one on either side of it."""
    recs = _call(1, 500) + _call(2, 1010) + _call(3, 1500) + _call(4, 1990)
    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    return recs


def read(name, run):
    return spec.metric_reader(name)(run)


def test_host_readers_on_hand_made_spans(records):
    run = _run()
    assert read("host_prepare_us", run) == pytest.approx((40 + 100) / 1e3)
    assert read("host_launch_us", run) == pytest.approx((20 + 20) / 1e3)
    assert read("host_tables_per_call", run) == 1.0
    assert read("launches_per_call", run) == 2.0


def test_idle_while_preparing_counts_only_the_overlap(records):
    # busy [1000, 1040) and [1060, 2000): one gap, (1040, 1060), over the
    # second half of the first call's pilot.prepare (1020, 1060)
    ops = [("k", 1000, 1040), ("k", 1060, 1700), ("k", 1650, 2000)]
    assert read("device_idle_prepare_pct", _run(ops)) == pytest.approx(100.0 * 20 / 1000)
    # a gap across the data.prepare (1080, 1180) and the launch after it
    ops = [("k", 1000, 1100), ("k", 1190, 2000)]
    assert read("device_idle_prepare_pct", _run(ops)) == pytest.approx(100.0 * 80 / 1000)
    # a gap inside no prepare span
    ops = [("k", 1000, 1190), ("k", 1205, 2000)]
    assert read("device_idle_prepare_pct", _run(ops)) == 0.0
    assert read("device_idle_prepare_pct", _run(None)) is None


def test_no_launch_span_in_the_window_reads_none(monkeypatch):
    root_only = [Span("rx.demod_capture", 1, None, 1100, 1200)]
    monkeypatch.setattr(profiling, "spans", lambda: root_only)
    ops = [("k", 1000, 1500)]
    assert all(read(name, _run(ops)) is None for name in NEW)


def test_a_program_without_spans_reads_none(records, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    ops = [("k", 1000, 1500)]
    assert all(read(name, _run(ops)) is None for name in NEW)


def test_traced_cpu_run_has_one_root_a_call_and_no_new_metric(tiny):
    profiling.clear_spans()
    out = run_tiny(*tiny, traced=True)
    lo, hi = out["record"].epoch_ns
    inside = [r for r in profiling.spans() if lo <= r.start_ns and r.end_ns <= hi]
    assert out["record"].calls > 0
    assert [r.name for r in inside] == ["rx.demod_capture"] * out["record"].calls
    assert len({r.call for r in inside}) == out["record"].calls
    assert not set(NEW) & set(out["result"]["metrics"])
    profiling.clear_spans()
