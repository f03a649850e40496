"""ofdm_ls_mrc_tpu_torch: the OFDM LS+MRC uplink receiver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of ``ofdm_ls_mrc_tpu`` (JAX on TPU), which stays beside it as the
reference.  The port imports nothing of that package: it keeps its own
copies of the NumPy-only modules it needs (``config.FrameConfig``, the
golden oracle ``golden`` and the channel simulator ``sim``), and the tests
hold each copy equal to its original.  Entry points compute on the card
(``device="cuda"``) unless the caller asks for the CPU.

Layers (bottom-up):
  csrc/     CUDA C++ kernels: register FFT (fft_warp.cuh), pilot LS in one
            thread block cluster per frame (pilot_ls.cu),
            FFT + MRC + reference-order store (fft_mrc.cu), split-phase
            FFT + MRC (mrc_demod.cu), input-delivery probes (io_probe.cu)
  kernels/  nvcc build of csrc/ into a ctypes-loaded library, at first use
  ops/      planar complex tensors, FFT, LS, MRC, the kernels' wrappers
  models/   UplinkReceiver (nn.Module), StreamingDemodulator
  io/       estimate checkpoints (the JAX package's .npz format)
  utils/    PhaseTimer
  tools/    dma_probe (the io floor of the card)
  convert   reference (TPU-layout) state -> port state
"""

from . import golden, sim
from .config import FrameConfig

__version__ = "0.2.0"

__all__ = ["FrameConfig", "golden", "sim", "__version__"]
