"""A configuration, a traffic mix and a metric are added by adding files
and entries: the harness finds them by name and no file of it changes."""

import json

from conftest import run_tiny
from portbench import spec

EXTRA_METRIC = '''
def read(run):
    return float(run.loop.calls)
'''


def test_added_files_are_found_without_edits(tiny):
    root, bench = tiny
    config = json.loads((bench / "configs" / "tiny.json").read_text())
    config.update(num_antennas=2, fft_size=128, frame_len=3)
    (bench / "configs" / "tiny_two.json").write_text(json.dumps(config))
    (bench / "traffic" / "tiny_burst.json").write_text(json.dumps(
        {"loop": "closed", "frames_per_call": 2, "in_flight": 1, "buffers": 3,
         "backoff_db": 15, "sample_calls": 2}))
    (bench / "metrics" / "calls_in_window.py").write_text(EXTRA_METRIC)
    bm = json.loads((root / "BENCHMARK.json").read_text())
    bm["configs"].append({"name": "tiny_two", "source": "test",
                          "file": "bench/configs/tiny_two.json", "reduced": [], "why": "test"})
    bm["workloads"].append({"name": "tiny_two.burst", "config": "tiny_two",
                            "traffic": "tiny_burst", "chips": 1, "why": "test"})
    bm["end_to_end"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                             "bound": 0.25, "source": "host_clock",
                             "workloads": ["tiny_two.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bm))

    cell = spec.find_cell(spec.load_spec(root), "tiny_two.burst", bench)
    assert cell.config["fft_size"] == 128 and cell.traffic["buffers"] == 3
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "calls_in_window"]
    out = run_tiny(root, bench, "tiny_two.burst")
    metrics = out["result"]["metrics"]
    assert set(metrics) == {"setup_s", "calls_in_window"}
    assert metrics["calls_in_window"]["value"] == out["result"]["attempted"] > 0
    assert out["result"]["correct"]


def test_a_metric_without_a_workloads_list_follows_what_it_moves(tiny):
    root, _ = tiny
    bm = spec.load_spec(root)
    e2e = bm["end_to_end"]
    moves_rate = {"name": "x", "moves": "samples_per_s"}
    assert spec.reports(moves_rate, "orbit16.capture", e2e)
    assert spec.reports(moves_rate, "tiny.capture", e2e)
    assert not spec.reports(moves_rate, "tiny.open", e2e)
    assert spec.reports({"name": "setup_s"}, "tiny.open", e2e)


def test_every_metric_named_has_a_reader_and_every_cell_its_files():
    bm = spec.load_spec(spec.BENCH_DIR.parent)
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in bm["workloads"]:
        cell = spec.find_cell(bm, w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        spec.reference(cell.config)
