"""The port's tools (``ofdm_ls_mrc_tpu_torch/utils/profiling.py`` and
``tools/{latency_probe,waterfall,ring_bench,soak,scaling_bench}.py``) on the
CPU, held where they compute against the JAX package's tools.

* profiling: ``trace`` + ``annotate`` + ``summarize_trace`` on CPU ops,
  ``device_time`` in seconds per item;
* waterfall: the port's ``run_sweep`` against the JAX ``run_sweep``
  (``tools/waterfall.py``, imported as ``tests/test_waterfall.py`` does) at
  4 x 64 x 9, cp 8, QPSK and 16-QAM, SNRs 0/10/20 dB, 2 seeds: the golden
  rows equal, the port's fused/fast/composed EVM within 0.05 dB of the JAX
  fast/composed rows and the SER within 2 symbols a row; ``ser_awgn``
  equal on a grid;
* latency_probe, ring_bench, soak and scaling_bench through their command
  lines with ``--device cpu`` (ring_bench is host-only) at 4 x 64 (x 9),
  each subprocess under its own timeout; the soak's scoring on synthetic
  files; its worst-rc rule, which the JAX tool's ``max`` breaks; its
  refusals (exit 2, as ``tests/test_soak.py``);
* every tool raises without a card unless ``--device cpu`` is given.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ofdm_ls_mrc_tpu_torch.config import FrameConfig
from ofdm_ls_mrc_tpu_torch.parallel import collectives
from ofdm_ls_mrc_tpu_torch.tools import latency_probe, scaling_bench, soak
from ofdm_ls_mrc_tpu_torch.tools import waterfall as port_waterfall
from ofdm_ls_mrc_tpu_torch.utils import profiling

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "tools"))

from waterfall import run_sweep as jax_run_sweep  # noqa: E402
from waterfall import ser_awgn as jax_ser_awgn  # noqa: E402

TIMEOUT = 120                 # every subprocess of this file
A, F, CP, S = 4, 64, 8, 9
SMALL = ["--antennas", str(A), "--fft", str(F)]
EVM_DB_TOL = 0.05
SER_SYMBOLS_TOL = 2
# The JAX latency book's fields (tools/latency_probe.py:166-176) and the
# port's one addition.
BOOK_FIELDS = {"body", "metric", "value", "best", "unit", "gs_per_s_at_ts1", "config"}
# The JAX ring_bench's JSON keys (tools/ring_bench.py:117-123, :172-181).
RING_KEYS = {"metric", "value", "unit", "shm_GB_per_s", "geometry"}
RING_LEG_KEYS = {"metric", "write_us", "write_batch_us", "read_prealloc_us", "write_GB_per_s",
                 "write_batch_GB_per_s", "read_GB_per_s", "geometry"}


def tool(name, *args, timeout=TIMEOUT):
    return subprocess.run([sys.executable, "-m", f"ofdm_ls_mrc_tpu_torch.tools.{name}",
                           *map(str, args)], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def last_json(stdout):
    return json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_lists_the_annotated_region_and_no_device_event(tmp_path):
    import torch

    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("demod-region"):
            for _ in range(3):
                x = x @ x / 64
    every = profiling.summarize_trace(str(tmp_path), device_only=False)
    assert every["demod-region"][1] == 1 and every["demod-region"][0] > 0
    assert any("matmul" in name or "mm" in name for name in every)
    assert list(every.values()) == sorted(every.values(), key=lambda v: -v[0])
    assert profiling.summarize_trace(str(tmp_path)) == {}


def test_summarize_trace_without_a_capture_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path))


def test_device_time_is_seconds_per_item_on_the_cpu():
    import time

    import torch

    items = torch.zeros(4, 8)
    s = profiling.device_time(lambda x: time.sleep(0.002), items, reps=2)
    assert 0.002 <= s < 0.05
    d = profiling.device_time(lambda x: x + 1, [items[0], items[1]], reps=2, detail=True)
    assert d["source"] == "time.perf_counter" and d["split"] == {} and not d["partial"]
    assert d["seconds_per_item"] == pytest.approx(d["ms"] / 1e3 / 2)


# ---------------------------------------------------------------------------
# waterfall against the JAX tool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["qpsk", "16qam"])
def sweeps(request):
    kw = dict(antennas=A, fft=F, symbols=S, cp=CP, scheme=request.param, snrs=[0.0, 10.0, 20.0],
              seeds=2, num_taps=8)
    port = port_waterfall.run_sweep(pipelines=["golden", "fused", "fast", "composed"],
                                    device="cpu", **kw)
    ref = jax_run_sweep(pipelines=["golden", "fast", "composed"], **kw)
    return port, ref


def test_waterfall_golden_rows_equal_jax(sweeps):
    port, ref = sweeps
    keys = ("snr_db", "n_syms", "evm_db_golden", "ser_golden", "ser_theory_golden")
    assert [{k: r[k] for k in keys} for r in port["rows"]] == \
        [{k: r[k] for k in keys} for r in ref["rows"]]
    assert port["config"] == ref["config"] and port["scheme"] == ref["scheme"]
    assert {"effective_pipelines", "pipelines_agree_db", "rows", "note"} <= set(port)


@pytest.mark.parametrize("pipe", ["fused", "fast", "composed"])
def test_waterfall_pipelines_match_jax(sweeps, pipe):
    port, ref = sweeps
    assert port["effective_pipelines"][pipe] == pipe
    for mine, theirs in zip(port["rows"], ref["rows"]):
        for jax_pipe in ("fast", "composed"):
            assert abs(mine[f"evm_db_{pipe}"] - theirs[f"evm_db_{jax_pipe}"]) <= EVM_DB_TOL
            assert (abs(mine[f"ser_{pipe}"] - theirs[f"ser_{jax_pipe}"]) * mine["n_syms"]
                    <= SER_SYMBOLS_TOL)
    assert port["pipelines_agree_db"] <= EVM_DB_TOL


@pytest.mark.parametrize("scheme", ["qpsk", "16qam", "64qam"])
def test_ser_awgn_equals_jax(scheme):
    grid = 10 ** np.linspace(-2, 3, 41)
    np.testing.assert_array_equal(port_waterfall.ser_awgn(grid, scheme),
                                  jax_ser_awgn(grid, scheme))


def test_waterfall_cli_writes_only_when_asked(tmp_path):
    args = ["--device", "cpu", "--antennas", "4", "--fft", "64", "--symbols", "9", "--cp", "8",
            "--snrs", "10", "--seeds", "1", "--pipelines", "golden,fused"]
    assert port_waterfall.build_parser().parse_args(args).out is None
    out = tmp_path / "wf.json"
    assert port_waterfall.main(args + ["--out", str(out), "--fail-above-db", "0.5"]) == 0
    assert json.loads(out.read_text())["rows"][0]["snr_db"] == 10.0


# ---------------------------------------------------------------------------
# latency_probe
# ---------------------------------------------------------------------------

def test_latency_probe_every_body_and_the_book(tmp_path):
    book = tmp_path / "book.json"
    r = tool("latency_probe", "--device", "cpu", *SMALL, "--batch", 8, "--bodies",
             ",".join(latency_probe.BODIES), "--record", book)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    for body in latency_probe.BODIES:
        line = next(ln for ln in lines if ln.split(" ")[0] == body)
        assert "us/symbol" in line and "wall p50" in line and "p99" in line, line
    entries = json.loads(book.read_text())
    assert set(entries) == {f"{b}-{A}ant-fft{F}" for b in latency_probe.BODIES}
    for key, e in entries.items():
        assert set(e) == BOOK_FIELDS | {"device"}, key
        assert e["metric"] == "device_us_per_symbol_ts1" and e["unit"] == "us"
        assert e["best"] == e["value"] > 0 and e["device"] == "cpu"
        assert {"antennas": A, "fft": F, "batch": 8}.items() <= e["config"].items()


def test_latency_book_best_ratchets(tmp_path):
    path = str(tmp_path / "book.json")
    latency_probe.record(path, "fused-4ant-fft64", "fused", 2e-5, A, F, 8, 3, "cpu")
    latency_probe.record(path, "fused-4ant-fft64", "fused", 3e-5, A, F, 8, 3, "cpu")
    e = json.loads(open(path).read())["fused-4ant-fft64"]
    assert (e["value"], e["best"]) == (30.0, 20.0)


# ---------------------------------------------------------------------------
# ring_bench (host-only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags, metric, keys", [
    ((), "ring_symbols_per_sec[complex64]", RING_KEYS),
    (("--dtype", "sc16", "--batch", "--i16"), "ring_symbols_per_sec[sc16]", RING_KEYS),
    (("--dtype", "sc16", "--batch", "--i16", "--decompose"), "ring_leg_us_per_symbol[sc16]",
     RING_LEG_KEYS),
])
def test_ring_bench_prints_the_jax_line(flags, metric, keys):
    r = tool("ring_bench", *SMALL, "--cp", CP, "--symbols", 200, *flags)
    assert r.returncode == 0, r.stdout + r.stderr
    line = last_json(r.stdout)
    assert set(line) == keys and line["metric"] == metric
    assert line["geometry"] == f"{A}x{F + CP}x101"
    assert all(v > 0 for k, v in line.items() if k not in ("metric", "unit", "geometry"))


def test_ring_bench_i16_needs_sc16_batch():
    r = tool("ring_bench", *SMALL, "--i16")
    assert r.returncode != 0 and "--i16 requires --dtype sc16 --batch" in r.stderr


# ---------------------------------------------------------------------------
# soak
# ---------------------------------------------------------------------------

def run_soak(tmp_path, *flags):
    r = subprocess.run([sys.executable, "-m", "ofdm_ls_mrc_tpu_torch.tools.soak", "--device",
                        "cpu", "--seconds", "3", "--min-frames", "2", "--dir", str(tmp_path),
                        *flags], cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr
    return last_json(r.stdout)


def test_soak_per_symbol_backpressured(tmp_path):
    rec = run_soak(tmp_path, "--consumer", "per-symbol")
    assert rec["pass"] and rec["clean_frames"] >= 2 and rec["dirty_frames"] == 0
    assert rec["clean_fraction"] == 1.0 and rec["consumer"] == "per-symbol"
    assert rec["evm_clean_db"]["max"] <= -25.0
    assert rec["rx_rc"] == 0 and rec["demod_rc"] == 0


def test_soak_attributes_each_frame_to_its_own_grid(tmp_path):
    rec = run_soak(tmp_path, "--num-frames", "3")
    assert rec["pass"] and rec["clean_frames"] >= 2 and rec["sent_frames"] == 3
    assert rec["evm_clean_db"]["max"] <= -25.0
    assert rec["clean_fraction"] == rec["clean_frames"] / (rec["clean_frames"]
                                                           + rec["dirty_frames"])
    # The same blocks against the next frame's grid: every clean frame fails.
    sent = np.fromfile(tmp_path / "sent.dat", np.complex64).reshape(3, S - 1, F - 1)
    clean, _ = soak.score(str(tmp_path / "Output_gpu.dat"), sent, F, S)
    wrong, _ = soak.score(str(tmp_path / "Output_gpu.dat"), np.roll(sent, 1, axis=0), F, S)
    assert len(clean) == rec["clean_frames"] and max(clean) <= -25.0
    assert min(wrong) > -10.0


def synthetic_output(tmp_path, n_frames, sent, wseqs):
    """Rows of frames k = sent[wseqs[k]] in the output layout (fftshifted)."""
    out = tmp_path / "out.dat"
    rows = np.concatenate([np.fft.ifftshift(sent[w], axes=-1) for w in wseqs[:n_frames]])
    rows.astype(np.complex64).tofile(out)
    return str(out)


def test_score_reads_the_index_by_writer_seq(tmp_path):
    rng = np.random.default_rng(3)
    sent = (rng.standard_normal((3, S - 1, F - 1))
            + 1j * rng.standard_normal((3, S - 1, F - 1))).astype(np.complex64)
    out = synthetic_output(tmp_path, 3, sent, [2, 0, 1])
    n = S - 1
    with open(out + ".index", "w") as fh:
        fh.write(f"0 clean 0 {n} 5\n1 dirty {n} {2 * n} 3\n2 caught-up -1 -1 -1\n"
                 f"3 clean {2 * n} {3 * n} 4\n4 clean {3 * n} {4 * n} 7\n5 cle")
    clean, dirty = soak.score(out, sent, F, S)
    # wseq 5 -> grid 2, wseq 4 -> grid 1: exact; wseq 3 -> grid 0: exact;
    # the block past the rows written and the truncated line are skipped.
    assert len(clean) == 2 and max(clean) < -100.0
    assert len(dirty) == 1 and dirty[0] < -100.0


def test_score_without_index_or_writer_seq(tmp_path):
    rng = np.random.default_rng(4)
    sent = (rng.standard_normal((1, S - 1, F - 1))
            + 1j * rng.standard_normal((1, S - 1, F - 1))).astype(np.complex64)
    out = synthetic_output(tmp_path, 2, sent, [0, 0])
    clean, dirty = soak.score(out, sent, F, S)
    assert len(clean) == 2 and dirty == [] and max(clean) < -100.0
    with open(out + ".index", "w") as fh:
        fh.write(f"0 clean 0 {S - 1}\n")          # no writer-seq column: grid 0
    assert len(soak.score(out, sent, F, S)[0]) == 1
    three = np.concatenate([sent] * 3)
    assert soak.score(out, three, F, S) == ([], [])   # several grids: unattributable
    assert soak.score(str(tmp_path / "none.dat"), sent, F, S) == ([], [])


@pytest.mark.parametrize("rcs, want", [([0, -9], -9), ([0, 0], 0), ([1, 0], 1),
                                       ([2, -15, 0, -9], -15), ([3, 1], 3), ([], 0)])
def test_worst_rc_puts_a_signal_first(rcs, want):
    assert soak.worst_rc(rcs) == want


def test_worst_rc_shows_what_the_reference_max_hides():
    # tools/soak.py:391-392 reports max(returncode): a child killed by
    # SIGKILL beside one that exited 0 reads as 0.
    assert max([0, -9]) == 0
    assert soak.worst_rc([0, -9]) == -9


@pytest.mark.parametrize("flags, words", [
    (["--consumer", "per-symbol", "--num-frames", "3"], "--num-frames 1"),
    (["--continuous-sync", "--num-frames", "3"], "--num-frames 1"),
    (["--consumer", "per-symbol", "--num-frames", "1", "--mesh", "2x2"], "ant axis only"),
    (["--sc16-native"], "--ring-dtype sc16"),
    (["--distributed", "3"], "not divisible"),
])
def test_soak_refusals_exit_2(capsys, flags, words):
    assert soak.main(flags) == 2
    assert words in capsys.readouterr().err


# ---------------------------------------------------------------------------
# scaling_bench
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["ant", "time"])
def test_scaling_bench_structure(axis):
    symbols = 9 if axis == "ant" else 5
    r = tool("scaling_bench", "--device", "cpu", "--shards", "1,2", "--axis", axis, *SMALL,
             "--symbols", symbols, "--pipeline", "fused", "--batch", 1, "--reps", 1)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = last_json(r.stdout)
    cfg = FrameConfig(num_antennas=A, fft_size=F, cyclic_prefix=0, frame_len=symbols)
    rows = rec["rows"]
    assert [row[f"{axis}_shards"] for row in rows] == [1, 2]
    assert all(row["backend"] == "gloo" and not row["one_card"] for row in rows)
    assert all(row["sec_per_frame"] > 0 and row["sec_per_call"] > 0 for row in rows)
    assert "efficiency_vs_1shard" in rows[1]
    st = rec["structure"]
    t = 2 if axis == "time" else 1
    s_local = cfg.num_data_symbols // t
    # The port's one all-reduce: 2 S_l (F-1) + F words; the JAX package's
    # (2 S_l + 1) F (parallel/structure.py's expected_psum_payload_words).
    assert st["expected_fp32_words"] == collectives.expected_payload_words(cfg, t) \
        == 2 * s_local * (F - 1) + F
    assert st["jax_payload_fp32_words"] == (2 * s_local + 1) * F
    assert st["difference_fp32_words"] == 2 * s_local
    assert (st["all_reduce_count"], st["all_reduce_fp32_words"]) == (1, st["expected_fp32_words"])
    if axis == "ant":
        assert st["payload_constant_across_shards"] is True
        assert len({(row["all_reduce_count"], row["all_reduce_fp32_words"]) for row in rows}) == 1
    else:
        assert st["time_axis_collective_free"] is True
        assert [row["all_reduce_fp32_words"] for row in rows] == [
            collectives.expected_payload_words(cfg, n) for n in (1, 2)]


def test_jax_payload_formula_matches_the_jax_package():
    from ofdm_ls_mrc_tpu.config import FrameConfig as JaxConfig
    from ofdm_ls_mrc_tpu.parallel.structure import expected_psum_payload_words

    for t in (1, 2, 4):
        cfg = FrameConfig(num_antennas=16, fft_size=1024, cyclic_prefix=0, frame_len=101)
        jcfg = JaxConfig(num_antennas=16, fft_size=1024, cyclic_prefix=0, frame_len=101)
        assert collectives.expected_payload_words(cfg, t, fast=True) == \
            expected_psum_payload_words(jcfg, t)


def test_scaling_bench_rejects_more_ranks_than_virtual():
    with pytest.raises(SystemExit, match="need 4 ranks"):
        scaling_bench.main(["--virtual", "2", "--shards", "1,4"])


# ---------------------------------------------------------------------------
# The card by default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, argv", [
    ("latency_probe", []), ("waterfall", []), ("soak", []), ("scaling_bench", ["--shards", "1"]),
])
def test_tools_default_to_the_card(name, argv):
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    main = importlib.import_module(f"ofdm_ls_mrc_tpu_torch.tools.{name}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
