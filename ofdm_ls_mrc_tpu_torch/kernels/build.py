"""Build and load the hand-written CUDA kernels (``csrc/``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``), one process per
source, all started together, and link into one shared library with a
plain C interface, loaded through ``ctypes``: a build takes seconds, where
an extension that includes PyTorch's headers takes minutes.  The library
lands in ``ofdm_ls_mrc_tpu_torch/_build/`` under a name that carries a hash
of every ``csrc/`` file, so an edited source rebuilds.

Nothing here runs at import: the first CUDA call of a kernel wrapper
(``ops/pipeline.py``, ``ops/fused_mrc.py``, ``tools/dma_probe.py``) calls
``load_library``, which builds when the library for the current sources is
missing.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("pilot_ls.cu", "fft_mrc.cu", "mrc_demod.cu", "io_probe.cu", "fft_mrc_bf16.cu",
           "fft_split.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the entry points (csrc/*.cu, extern "C"): every pointer,
# the stream included, is a c_void_p so none is cut to 32 bits.
SIGNATURES = {
    "ofdm_pilot_ls": (_P, _P, _I, _I, _LL, _LL, _F, _I, _I, _I, _I, _I, _I, _LL,
                      _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P),
    "ofdm_fft_mrc": (_P, _P, _I, _I, _LL, _LL, _LL, _F, _I, _I, _I, _I,
                     _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    "ofdm_mrc_demod": (_P, _P, _I, _I, _LL, _LL, _F, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    "ofdm_pilot_ls_bf16": (_P, _P, _I, _LL, _LL, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                           _P, _P, _P, _I, _P),
    "ofdm_fft_mrc_bf16": (_P, _P, _I, _LL, _LL, _LL, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    "ofdm_io_auto": (_P, _P, _I, _I, _I, _P, _P, _I, _F, _P, _P, _P),
    "ofdm_io_manual": (_P, _P, _I, _I, _I, _P, _P, _I, _F, _I, _I, _I, _P, _P, _P),
}


def source_hash() -> str:
    """Hash of every file under csrc/ (names and bytes), 16 hex digits."""
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libofdm_kernels_{source_hash()}.so"


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def _run_all(cmds):
    """Run the commands side by side; once every one has ended, raise with
    the output of each that failed.  Returns their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}"
              for cmd, proc, text in zip(cmds, procs, outs) if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build_library(verbose: bool = False) -> Path:
    """Compile csrc/ into the library for the current sources: one nvcc per
    source, all at once, then one link.  Objects and the library are
    written under temporary names and the library renamed into place, so a
    concurrent or interrupted build never leaves a half-written library
    behind."""
    out = library_path()
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [str(Path(tmpdir) / (Path(src).stem + ".o")) for src in SOURCES]
        outs = _run_all([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                          "-c", "-o", obj, str(CSRC_DIR / src)]
                         for src, obj in zip(SOURCES, objs)])
        if verbose:
            print("".join(outs), end="")
        tmp = str(Path(tmpdir) / out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library for the current sources, built on first use and
    loaded once per process."""
    path = library_path()
    if not path.exists():
        build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ofdm_error_string.argtypes = (ctypes.c_int,)
    lib.ofdm_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        text = lib.ofdm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
