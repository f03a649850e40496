"""The port stands without JAX, and its CPU path never touches the kernels.

* importing the package and every module of it leaves ``jax`` and the JAX
  package ``ofdm_ls_mrc_tpu`` out of sys.modules;
* no port source (nor chip_smoke.py) imports jax or anything of the JAX
  package, not even its NumPy-only modules (the port keeps its own copies);
* on CPU tensors every wrapper runs its plain version: no launch counted and
  the kernel library never built or loaded;
* the kernel library's name follows the csrc/ sources.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu_torch import FrameConfig
from ofdm_ls_mrc_tpu_torch.kernels import build
from ofdm_ls_mrc_tpu_torch.models import StreamingDemodulator, UplinkReceiver
from ofdm_ls_mrc_tpu_torch.ops import fused_mrc
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
from ofdm_ls_mrc_tpu_torch.tools import dma_probe

REPO = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted(p.relative_to(REPO).as_posix()
                      for p in (REPO / "ofdm_ls_mrc_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
PORT_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in (REPO / "ofdm_ls_mrc_tpu_torch").rglob("*.py"))
# jax, and the JAX package itself (``ofdm_ls_mrc_tpu``, which the port's own
# name only extends: ``\b`` does not end a match before ``_torch``).
JAX_IMPORT = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b"
    r"|from\s+ofdm_ls_mrc_tpu\b|import\s+ofdm_ls_mrc_tpu\b)",
    re.MULTILINE)


def test_import_leaves_jax_out():
    code = ("import sys\n"
            f"import {', '.join(PORT_MODULES)}\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'ofdm_ls_mrc_tpu' or m.startswith('ofdm_ls_mrc_tpu.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_source_imports_no_jax(path):
    text = (REPO / path).read_text()
    assert not JAX_IMPORT.search(text), JAX_IMPORT.search(text).group(0)


def test_cpu_path_never_builds_or_launches(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path tried to build or load the kernels")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(build, "build_library", refuse)
    pipe.reset_launch_counts()
    fused_mrc.reset_launch_counts()
    dma_probe.reset_launch_counts()
    rng = np.random.default_rng(0)
    cfg = FrameConfig(num_antennas=2, fft_size=256, cyclic_prefix=0, frame_len=4)
    pilot = np.exp(2j * np.pi * rng.random(255)).astype(np.complex64)
    frames = (rng.standard_normal((2, 4, 2, 256)) + 1j * rng.standard_normal((2, 4, 2, 256))
              ).astype(np.complex64)
    rx = UplinkReceiver(cfg, pilot, device="cpu")
    rx.warmup()
    rx.demod_frame(frames[0])
    rx.demod_parts(frames[0, 0], frames[0, 1:])
    rx.demod_capture(frames)
    rx.demod_data(frames[0, 1:], *rx.estimate_channel(frames[0, 0]))
    q = CArray(torch.zeros((4, 2, 256), dtype=torch.int16),
               torch.ones((4, 2, 256), dtype=torch.int16))
    pipe.demod_frame_fused(q, rx.x_full, cp=0)
    sd = StreamingDemodulator(cfg, pilot, pipeline="fused", device="cpu")
    sd.warmup(int16=True)
    sd.push_pilot(frames[0, 0])
    sd.push_symbol(frames[0, 1])
    y = torch.ones((3, 2, 256))
    for variant in ("auto", "manual2", "manual3s"):
        dma_probe.io_probe(y, y, torch.zeros(256), torch.ones((128, 128)), variant=variant,
                           compute=1)
    assert pipe.launch_counts == {"pilot_ls": 0, "fft_mrc": 0}
    assert fused_mrc.launch_counts == {"mrc_demod": 0}
    assert dma_probe.launch_counts == {"io_auto": 0, "io_manual": 0}


def test_library_name_follows_sources(tmp_path, monkeypatch):
    for src in build.CSRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path()
    assert before.parent == build.BUILD_DIR and before.suffix == ".so"
    (tmp_path / "fft_mrc.cu").write_text((tmp_path / "fft_mrc.cu").read_text() + "\n// edit\n")
    assert build.library_path() != before
    assert set(build.SOURCES) <= {p.name for p in tmp_path.iterdir()}
