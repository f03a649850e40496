"""The port's examples (``ofdm_ls_mrc_tpu_torch/examples``) run clean on the
CPU and say OK, and print what the JAX examples print.

Each runs in a subprocess with ``--device cpu`` (``sharded_mesh`` spawns
its 8 ranks over gloo), under its own timeout.  The EVM line of
``loopback_demod`` is held within 0.1 dB of the one ``examples/01_loopback_demod.py``
prints with ``--platform cpu`` (same seeds).  ``downlink_zf``'s two lines
sit at the float32 round-off floor in both packages (about -136 and -141
dB), where two sums taken in another order part by up to a dB: they are
held below -120 dB each and within 2 dB of the JAX lines.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT = 120
EXAMPLES = ("loopback_demod", "ring_pipeline", "sharded_mesh", "downlink_zf")
LOOPBACK_DB_TOL = 0.1
FLOOR_DB, FLOOR_DB_TOL = -120.0, 2.0


def run_all(names, *args):
    """Each example as a process, all at once: {name: CompletedProcess};
    every one still running at TIMEOUT is killed."""
    procs = {n: subprocess.Popen([sys.executable, "-m", f"ofdm_ls_mrc_tpu_torch.examples.{n}",
                                  *args], cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for n in names}
    try:
        done = {}
        for n, p in procs.items():
            out, err = p.communicate(timeout=TIMEOUT)
            done[n] = subprocess.CompletedProcess(p.args, p.returncode, out, err)
        return done
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def jax_example(script):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "examples", script), "--platform",
                        "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def db_values(stdout, pattern):
    return [float(m) for m in re.findall(pattern, stdout)]


@pytest.fixture(scope="module")
def runs():
    return run_all(EXAMPLES, "--device", "cpu")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_ok_on_the_cpu(runs, name):
    r = runs[name]
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines()[-1] == "OK", r.stdout


def test_examples_are_the_four():
    here = os.path.join(REPO, "ofdm_ls_mrc_tpu_torch", "examples")
    assert sorted(f[:-3] for f in os.listdir(here)
                  if f.endswith(".py") and f != "__init__.py") == sorted(EXAMPLES)


def test_loopback_evm_matches_jax(runs):
    pattern = r"EVM=(-?[\d.]+) dB"
    mine = db_values(runs["loopback_demod"].stdout, pattern)
    theirs = db_values(jax_example("01_loopback_demod.py"), pattern)
    assert len(mine) == len(theirs) == 1
    assert abs(mine[0] - theirs[0]) <= LOOPBACK_DB_TOL
    assert "pipeline=fused" in runs["loopback_demod"].stdout


def test_downlink_lines_match_jax(runs):
    pattern = r"(?:EVM|leakage:) (-?[\d.]+) dB"
    mine = db_values(runs["downlink_zf"].stdout, pattern)
    theirs = db_values(jax_example("04_downlink_zf.py"), pattern)
    assert len(mine) == len(theirs) == 2
    for a, b in zip(mine, theirs):
        assert a < FLOOR_DB and b < FLOOR_DB and abs(a - b) <= FLOOR_DB_TOL


def test_sharded_mesh_prints_the_jax_lines(runs):
    out = runs["sharded_mesh"].stdout
    assert re.search(r"mesh=\{'ant': 4, 'time': 2\} pipeline=fused  EVM=-[\d.]+ dB", out), out
    assert re.search(r"per-symbol streaming over 8 ant shards: EVM=-[\d.]+ dB", out), out


def test_ring_pipeline_reads_every_frame(runs):
    out = runs["ring_pipeline"].stdout
    assert len(re.findall(r"frame \d: 8 symbols, EVM -[\d.]+ dB", out)) == 4, out
    assert "dropped=0" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name):
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    main = importlib.import_module(f"ofdm_ls_mrc_tpu_torch.examples.{name}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
