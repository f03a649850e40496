"""Receiver state persistence (checkpoint/resume), the counterpart of
``ofdm_ls_mrc_tpu.io.state``.

A receiver restarted mid-capture resumes with the last good channel estimate
instead of waiting for the next pilot.  State is a single .npz with a version
tag and the frame geometry, so a mismatched restore fails loudly instead of
demodulating garbage.  The file format is the JAX package's, field for
field: a file written by either package loads in the other.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import FrameConfig
from ..ops.cplx import CArray

_VERSION = 1


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_estimate(path: str, cfg: FrameConfig, hconj: CArray,
                  hsqrd, frame_index: int = 0) -> None:
    """Persist a channel estimate (full-grid, true frequency order).

    Written to the EXACT path given (np.savez would otherwise append .npz,
    breaking save/resume roundtrips on extensionless paths)."""
    with open(path, "wb") as fh:
        np.savez(
            fh,
            version=_VERSION,
            num_antennas=cfg.num_antennas,
            fft_size=cfg.fft_size,
            cyclic_prefix=cfg.cyclic_prefix,
            frame_len=cfg.frame_len,
            frame_index=frame_index,
            hconj_re=_host(hconj.re),
            hconj_im=_host(hconj.im),
            hsqrd=_host(hsqrd),
        )


def load_estimate(path: str, cfg: FrameConfig) -> Tuple[CArray, torch.Tensor, int]:
    """Restore (hconj, hsqrd, frame_index) as CPU tensors, validating the
    geometry; the caller moves them to its device."""
    with np.load(path) as z:
        if int(z["version"]) != _VERSION:
            raise ValueError(f"state version {int(z['version'])} != {_VERSION}")
        for field in ("num_antennas", "fft_size", "cyclic_prefix", "frame_len"):
            want = getattr(cfg, field)
            got = int(z[field])
            if got != want:
                raise ValueError(f"state {field}={got} != config {want}")
        want = (cfg.num_antennas, cfg.fft_size)
        for key in ("hconj_re", "hconj_im"):
            if z[key].shape != want:
                raise ValueError(f"{path}: {key} shape {z[key].shape} != {want}")
        if z["hsqrd"].shape != (cfg.fft_size,):
            raise ValueError(f"{path}: hsqrd shape {z['hsqrd'].shape} != "
                             f"({cfg.fft_size},)")
        hconj = CArray(torch.from_numpy(np.ascontiguousarray(z["hconj_re"], np.float32)),
                       torch.from_numpy(np.ascontiguousarray(z["hconj_im"], np.float32)))
        hsqrd = torch.from_numpy(np.ascontiguousarray(z["hsqrd"], np.float32))
        return hconj, hsqrd, int(z["frame_index"])
