"""Build and load the hand-written CUDA kernels (``csrc/``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded through ``ctypes``: a build takes
seconds, where an extension that includes PyTorch's headers takes minutes.
The library lands in ``ofdm_ls_mrc_tpu_torch/_build/`` under a name that
carries a hash of every ``csrc/`` file, so an edited source rebuilds.

Nothing here runs at import: the first CUDA call of a kernel wrapper
(``ops/pipeline.py``) calls ``load_library``, which builds when the library
for the current sources is missing.  A failed build raises.
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
SOURCES = ("pilot_ls.cu", "fft_mrc.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the entry points (csrc/*.cu, extern "C"): every pointer,
# the stream included, is a c_void_p so none is cut to 32 bits.
SIGNATURES = {
    "ofdm_pilot_ls": (_P, _P, _I, _LL, _LL, _F, _I, _I, _I,
                      _P, _P, _P, _P, _P, _P, _P),
    "ofdm_fft_mrc": (_P, _P, _I, _LL, _LL, _LL, _F, _I, _I, _I, _I,
                     _P, _P, _P, _P, _P, _P, _P),
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


def build_library(verbose: bool = False) -> Path:
    """Compile csrc/ into the library for the current sources.  The output
    is written under a temporary name and renamed, so a concurrent or
    interrupted build never leaves a half-written library behind."""
    out = library_path()
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
