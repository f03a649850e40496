"""The port's spans and counters (``utils/profiling.annotate``, ``mark``,
``counts``, ``launched``, ``spans``, ``breakdown``) on the CPU.

* off (no profiler running): ``annotate`` is one shared no-op and nothing
  is recorded;
* on (``torch.profiler`` over the CPU): spans nest with their parent and
  their call id, self time is the duration less the children's, the
  clock is the profiler's (an ``aten::add`` inside a span lies inside it);
* ``plan.table`` counts one a computed table, a nested build once, a
  cached table none;
* the receiver's card route, on a library that launches nothing: per call one root,
  the two prepare and two launch spans, two launches, and the tables of
  the benchmark's two shapes (none at 16 x 1024, the side form's one at
  64 x 4096); the CPU route records the root alone.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ofdm_ls_mrc_tpu_torch.config import FrameConfig
from ofdm_ls_mrc_tpu_torch.kernels import build
from ofdm_ls_mrc_tpu_torch.models.uplink import UplinkReceiver
from ofdm_ls_mrc_tpu_torch.ops import fft_plan as fp
from ofdm_ls_mrc_tpu_torch.ops import fused_mrc
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
from ofdm_ls_mrc_tpu_torch.utils import profiling

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_annotate_is_the_shared_noop_and_records_nothing():
    assert profiling.annotate("a") is profiling.annotate("b")
    with profiling.annotate("a"):
        with profiling.annotate("b"):
            profiling.mark(profiling.TABLE)
    fp.side_twiddles_np(256)
    assert profiling.spans() == []


def test_on_spans_nest_with_their_parent_and_call_id():
    with traced():
        for _ in range(2):
            with profiling.annotate("root"):
                with profiling.annotate("a"):
                    torch.ones(8).sum()
                with profiling.annotate("b"):
                    with profiling.annotate("c"):
                        profiling.mark(profiling.LAUNCH)
    recs = profiling.spans()
    assert [r.name for r in recs] == ["a", "kernel.launched", "c", "b", "root"] * 2
    first, second = recs[:5], recs[5:]
    assert len({r.call for r in first}) == 1 and len({r.call for r in second}) == 1
    assert second[0].call == first[0].call + 1
    parents = {r.name: r.parent for r in first}
    assert parents == {"root": None, "a": "root", "b": "root", "c": "b",
                       "kernel.launched": "c"}
    by = {r.name: r for r in first}
    for r in first:
        if r.parent is not None:
            assert by[r.parent].start_ns <= r.start_ns <= r.end_ns <= by[r.parent].end_ns
    mark = by["kernel.launched"]
    assert mark.start_ns == mark.end_ns


def test_breakdown_self_time_is_the_duration_less_the_children():
    with traced():
        with profiling.annotate("root"):
            with profiling.annotate("a"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            with profiling.annotate("b"):
                with profiling.annotate("c"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    recs = profiling.spans()
    dur = {r.name: r.end_ns - r.start_ns for r in recs}
    got = profiling.breakdown(recs)
    assert set(got) == {"root", "a", "b", "c"}     # the marks are no spans
    assert got["root"] == (1, dur["root"], dur["root"] - dur["a"] - dur["b"])
    assert got["b"] == (1, dur["b"], dur["b"] - dur["c"])
    assert got["a"] == (1, dur["a"], dur["a"])
    assert all(v[2] >= 0 for v in got.values())


def test_a_kineto_cpu_event_falls_inside_its_span():
    x = torch.ones(256)
    with traced() as prof:
        with profiling.annotate("add"):
            torch.add(x, x)
    span, = profiling.spans()
    adds = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add"]
    assert len(adds) == 1
    start = adds[0].start_ns()
    assert span.start_ns <= start <= start + adds[0].duration_ns() <= span.end_ns


def test_clear_spans_empties_the_buffer():
    with traced():
        with profiling.annotate("a"):
            pass
        assert len(profiling.spans()) == 1
        profiling.clear_spans()
        assert profiling.spans() == []
        with profiling.annotate("b"):
            pass
    assert [r.name for r in profiling.spans()] == ["b"]


@pytest.mark.parametrize("build_table,tables", [
    (lambda: fp.side_twiddles_np(4096), 1),
    (lambda: fp.pass_twiddles_np(1024), 1),
    (lambda: fp.split_tables_np(16384), 1),           # pass twiddles x 2 + four-step: one table
    (lambda: fp.speed_w_image_np(), 1),                # built from speed_w_np: one table
    (lambda: (fp.speed_w_np(), fp.speed_twiddles_np(256, True)), 2),
    (lambda: fp.side_plan(832, 64, 4096), 1),          # side_smem_bytes rebuilds the table
    (lambda: fp.pass_twiddles(1024, CPU), 0),          # cached: warmed below
    (lambda: fp.side_twiddles(4096, CPU), 0),
])
def test_plan_table_counts_each_computed_table(build_table, tables):
    build_table()                                      # fills any cache, off the record
    with traced():
        build_table()
    recs = profiling.spans()
    assert all(r.name == profiling.TABLE and r.start_ns == r.end_ns for r in recs)
    assert len(recs) == tables


class _Lib:
    """A kernel library that launches nothing and reports success."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers' card route on CPU tensors, with no card: a library, a
    stream and a device context that do nothing."""
    monkeypatch.setattr(pipe, "_device_route", lambda x, name: True)
    monkeypatch.setattr(fused_mrc, "_device_route", lambda x, name: True)
    monkeypatch.setattr(build, "load_library", lambda: _Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {
        "cuda_stream": 4321})())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(pipe, "_spread_counts", {})
    monkeypatch.setattr(pipe, "_pilot_counts", {})


def _receiver(a, f, s):
    cfg = FrameConfig(num_antennas=a, fft_size=f, cyclic_prefix=0, frame_len=s)
    pilot = np.exp(1j * np.arange(cfg.num_subcarriers)).astype(np.complex64)
    return UplinkReceiver(cfg, pilot, device="cpu")


def _capture(k, s, a, f):
    """[K, S, A, F] int16 planes of one row read K S A times (the wrappers
    take any strides with contiguous rows)."""
    row = torch.zeros(f, dtype=torch.int16)
    x = row.as_strided((k, s, a, f), (0, 0, 0, 1))
    return CArray(x, x)


@pytest.mark.parametrize("a,f,s,tables", [(16, 1024, 101, 0), (64, 4096, 14, 1)])
def test_the_card_route_records_its_spans_and_counters(card_route, a, f, s, tables):
    """The benchmark's two shapes (captures of 64 frames): per call one
    root, pilot.prepare/launch then data.prepare/launch inside it, two
    launches, and the tables the call computes once warm."""
    k, calls = 64, 3
    rx = _receiver(a, f, s)
    frames = _capture(k, s, a, f)
    rx.demod_capture(frames)                           # warm: plans and tables cached
    launches = dict(profiling.kernel_launches())
    with traced():
        for _ in range(calls):
            rx.demod_capture(frames)
    recs = profiling.spans()
    roots = [r for r in recs if r.name == "rx.demod_capture"]
    assert len(roots) == calls and len({r.call for r in recs}) == calls
    for root in roots:
        mine = [r for r in recs if r.call == root.call]
        spans = sorted((r for r in mine if r.end_ns > r.start_ns and r is not root),
                       key=lambda r: r.start_ns)
        assert [r.name for r in spans] == ["pilot.prepare", "pilot.launch", "data.prepare",
                                           "data.launch"]
        assert all(r.parent == "rx.demod_capture" for r in spans)
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in spans)
        marks = [r for r in mine if r.start_ns == r.end_ns]
        assert sorted((r.name, r.parent) for r in marks if r.name == profiling.LAUNCH) == [
            ("kernel.launched", "data.launch"), ("kernel.launched", "pilot.launch")]
        assert [r.parent for r in marks if r.name == profiling.TABLE] == ["data.prepare"] * tables
    now = profiling.kernel_launches()
    assert now["pilot_ls"] - launches["pilot_ls"] == calls
    assert now["fft_mrc"] - launches["fft_mrc"] == calls


def test_the_split_phase_data_wrapper_records_its_spans(card_route):
    y = _capture(1, 13, 4, 256)[0]
    h = CArray(torch.zeros((4, 256)), torch.zeros((4, 256)))
    fused_mrc.fused_demod(y, h, torch.ones(256))
    with traced():
        fused_mrc.fused_demod(y, h, torch.ones(256))
    got = [(r.name, r.parent) for r in profiling.spans()]
    assert got == [("plan.table", "data.prepare"), ("data.prepare", None),   # the side form
                   ("kernel.launched", "data.launch"), ("data.launch", None)]


def test_the_cpu_route_records_the_root_alone():
    a, f, s = 4, 256, 5
    rx = _receiver(a, f, s)
    frames = CArray(torch.zeros((2, s, a, f)), torch.zeros((2, s, a, f)))
    with traced():
        rx.demod_capture(frames)
    assert [(r.name, r.parent) for r in profiling.spans()] == [("rx.demod_capture", None)]
