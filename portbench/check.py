"""The comparison that decides ``correct``.

``out_err`` of one output: over its frames, the widest gap between the
program's value and the reference's at any bin of any data symbol, over the
root mean square of that frame's reference output.  The reference works in
float64 from the same int16 samples and the same pilot, in blocks of
frames, so that it fits beside what the run keeps.
"""

from __future__ import annotations

import torch

BLOCK_SAMPLES = 1 << 26      # complex samples the reference holds at once


def out_err(out_re: torch.Tensor, out_im: torch.Tensor, re: torch.Tensor, im: torch.Tensor,
            pilot: torch.Tensor, reference) -> float:
    """Program output [K, S - 1, F - 1] (two float planes) against the
    reference of frames [K, S, A, F] (int16 planes) and the pilot."""
    k = re.shape[0]
    per_frame = max(1, re[0].numel())
    step = max(1, BLOCK_SAMPLES // per_frame)
    worst = 0.0
    for k0 in range(0, k, step):
        ref = reference.demod(re[k0:k0 + step], im[k0:k0 + step], pilot)
        got = torch.complex(out_re[k0:k0 + step].double(), out_im[k0:k0 + step].double())
        gap = (got - ref).abs().flatten(1).amax(dim=1)
        rms = ref.abs().square().flatten(1).mean(dim=1).sqrt()
        ratio = torch.nan_to_num(gap / rms, nan=float("inf"))
        worst = max(worst, float(ratio.max()))
        del ref, got
    return worst
