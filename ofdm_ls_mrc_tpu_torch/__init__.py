"""ofdm_ls_mrc_tpu_torch: the OFDM LS+MRC uplink receiver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of ``ofdm_ls_mrc_tpu`` (JAX on TPU), which stays beside it as the
reference.  The NumPy-only modules of the reference are shared, not copied:
``FrameConfig``, the golden oracle (``golden``) and the channel simulator
(``sim``); importing them pulls in no JAX.

Layers (bottom-up):
  csrc/     CUDA C++ kernels: block FFT (fft.cuh), pilot LS (pilot_ls.cu),
            FFT + MRC + reference-order store (fft_mrc.cu)
  kernels/  nvcc build of csrc/ into a ctypes-loaded library, at first use
  ops/      planar complex tensors, FFT, LS, MRC, the fused path's wrappers
  models/   UplinkReceiver (nn.Module)
  convert   reference (TPU-layout) state -> port state
"""

from ofdm_ls_mrc_tpu import golden, sim
from ofdm_ls_mrc_tpu.config import FrameConfig

__version__ = "0.1.0"

__all__ = ["FrameConfig", "golden", "sim", "__version__"]
