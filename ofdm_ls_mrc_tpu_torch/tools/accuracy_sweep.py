"""Accuracy sweep: every demod body the port's entry points select, against
the NumPy golden (the port's counterpart of the repo's
``tools/accuracy_sweep.py``, whose geometry, seed and bounds it keeps).

One frame of 4 antennas x 256 x 7 symbols, cp 16, seed 11, goes through
each body and is held to ``golden.demod_frame`` at -70 dB EVM; the bf16
speed mode (``exact=False``) at its own -35 dB (plain-bf16 numerics, about
1e-2 relative by design).  Unsharded legs: ``UplinkReceiver`` whole frame
(fused, fast, composed, fused in the speed mode) and ``StreamingDemodulator``
symbol by symbol (composed, fused).  ``--mesh-legs``: the sharded modules,
``ShardedUplinkReceiver`` on a 2x2 (ant x time) mesh and
``ShardedStreamingDemodulator`` on 2x1, each fused, fast and composed; their
ranks are processes of this tool (``--worker``) on a ``file://`` store,
gloo on the CPU or on the card (one card holds every rank: NCCL refuses two
ranks a device), every rank killed at 100 s.  Every 'fast' leg runs
``fft_impl="four_step"`` (on the default 'xla' FFT the unsharded receiver
would run 'composed'), the JAX sweep's choice for all its legs.

Exit status 0 when every leg passes, 1 otherwise.

Run:  python -m ofdm_ls_mrc_tpu_torch.tools.accuracy_sweep               # on the card
      python -m ofdm_ls_mrc_tpu_torch.tools.accuracy_sweep --mesh-legs
      python -m ofdm_ls_mrc_tpu_torch.tools.accuracy_sweep --device cpu  # without one
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

from . import ranks

EVM_DB = -70.0
EVM_BF16_DB = -35.0
A, F, CP, S, SEED = 4, 256, 16, 7, 11
WALL_S = 100                 # every rank of a mesh leg is killed at this limit
MESH_LEGS = {"2x2": "sharded-whole", "2x1": "sharded-streaming"}
PIPELINES = ("fused", "fast", "composed")


def inputs():
    """(pilot, frame) of the sweep, drawn as the JAX sweep draws them."""
    rng = np.random.default_rng(SEED)
    pilot = np.exp(2j * np.pi * rng.random(F - 1)).astype(np.complex64)
    frame = (0.1 * (rng.standard_normal((S, A, F + CP))
                    + 1j * rng.standard_normal((S, A, F + CP)))).astype(np.complex64)
    return pilot, frame


def config():
    from ..config import FrameConfig

    return FrameConfig(num_antennas=A, fft_size=F, cyclic_prefix=CP, frame_len=S)


def evm_db(got: np.ndarray, want: np.ndarray) -> float:
    err = float(np.mean(np.abs(got - want) ** 2))
    ref = float(np.mean(np.abs(want) ** 2))
    return 10.0 * math.log10(err / max(ref, 1e-30) + 1e-30)


class Sweep:
    """Checks legs against the golden and remembers the failures."""

    def __init__(self, gold: np.ndarray):
        self.gold = gold
        self.failures = []

    def check(self, name: str, got: np.ndarray, bound: float = EVM_DB) -> None:
        evm = evm_db(got, self.gold)
        ok = evm <= bound
        print(f"[sweep] {name:42s} {evm:8.1f} dB vs bound {bound:.0f}: "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(name)


def stream_rows(sd, frame) -> np.ndarray:
    sd.push_pilot(frame[0])
    return np.stack([sd.push_symbol(frame[i]).to_numpy() for i in range(1, S)])


def fft_impl(pipe: str):
    """The FFT of a leg: 'four_step' for 'fast', the default elsewhere."""
    return "four_step" if pipe == "fast" else None


def unsharded_legs(sweep: Sweep, device: str) -> None:
    from ..models import StreamingDemodulator, UplinkReceiver

    cfg, (pilot, frame) = config(), inputs()
    for pipe in PIPELINES:
        rx = UplinkReceiver(cfg, pilot, pipeline=pipe, fft_impl=fft_impl(pipe), device=device)
        sweep.check(f"whole/{pipe} ({device})", rx.demod_frame(frame).to_numpy())
    rxb = UplinkReceiver(cfg, pilot, pipeline="fused", exact=False, device=device)
    sweep.check(f"whole/fused-bf16 ({device})", rxb.demod_frame(frame).to_numpy(),
                bound=EVM_BF16_DB)
    for pipe in ("composed", "fused"):
        sd = StreamingDemodulator(cfg, pilot, pipeline=pipe, device=device)
        sweep.check(f"streaming/{pipe} ({device})", stream_rows(sd, frame))


# ---------------------------------------------------------------------------
# Mesh legs: one process a rank
# ---------------------------------------------------------------------------

def worker(args) -> int:
    """One rank of ``args.mesh``: its rows of each pipeline's leg, written to
    <out>/rank<R>.npz with the rank's mesh coordinates."""
    import torch.distributed as dist

    from .. import parallel

    a_sh, t_sh = (int(v) for v in args.mesh.split("x"))
    parallel.initialize(f"file://{args.store}", args.world, args.rank, "gloo")
    mesh = parallel.make_mesh(a_sh, t_sh)
    cfg, (pilot, frame) = config(), inputs()
    res = {"ant_index": mesh.ant_index, "time_index": mesh.time_index}
    for pipe in PIPELINES:
        if MESH_LEGS[args.mesh] == "sharded-whole":
            rx = parallel.ShardedUplinkReceiver(cfg, pilot, mesh, pipeline=pipe,
                                                fft_impl=fft_impl(pipe), device=args.device)
            res[pipe] = rx.demod_frame(frame).to_numpy()
        else:
            sd = parallel.ShardedStreamingDemodulator(cfg, pilot, mesh, pipeline=pipe,
                                                      fft_impl=fft_impl(pipe),
                                                      device=args.device)
            res[pipe] = stream_rows(sd, frame)
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_ranks(mesh: str, device: str, workdir: str) -> list:
    """Start the mesh's ranks, wait for all; at the wall limit kill them all
    and raise.  Returns each rank's results in rank order."""
    a_sh, t_sh = (int(v) for v in mesh.split("x"))
    world = a_sh * t_sh
    d = Path(workdir) / mesh
    d.mkdir()
    ranks.run_ranks([ranks.module_cmd("ofdm_ls_mrc_tpu_torch.tools.accuracy_sweep", "--worker",
                                      "--store", d / "store", "--world", world, "--rank", r,
                                      "--mesh", mesh, "--out", d, "--device", device)
                     for r in range(world)], WALL_S, f"the {mesh} mesh")
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


def mesh_legs(sweep: Sweep, device: str) -> None:
    """Each mesh leg's output as a user reads it: the time blocks of the
    first ant row in time order (whole frame), rank 0's rows (streaming);
    every rank of an ant row must hold its row's blocks."""
    if device != "cpu":
        from ..kernels import build

        build.load_library()    # once, before the ranks load it
    with tempfile.TemporaryDirectory() as workdir:
        for mesh, leg in MESH_LEGS.items():
            res = run_ranks(mesh, device, workdir)
            for pipe in PIPELINES:
                if leg == "sharded-whole":
                    row = sorted((r for r in res if int(r["ant_index"]) == 0),
                                 key=lambda r: int(r["time_index"]))
                    got = np.concatenate([r[pipe] for r in row])
                    same = all(np.array_equal(r[pipe], row[int(r["time_index"])][pipe])
                               for r in res)
                else:
                    got = res[0][pipe]
                    same = all(np.array_equal(r[pipe], got) for r in res)
                name = f"{leg}/{pipe} ({mesh} {device})"
                if not same:
                    print(f"[sweep] {name:42s} ranks of an ant row disagree: FAIL")
                    sweep.failures.append(name)
                sweep.check(name, got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="where the port computes: the card (default; raises without "
                         "one) or 'cpu'")
    ap.add_argument("--mesh-legs", action="store_true",
                    help="the sharded bodies on 2x2 and 2x1 meshes, one process a rank")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    for flag in ("--store", "--mesh", "--out"):
        ap.add_argument(flag, help=argparse.SUPPRESS)
    for flag in ("--world", "--rank"):
        ap.add_argument(flag, type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)

    from ..golden import dsp
    from ..ops.cplx import resolve_device

    device = str(resolve_device(args.device, "accuracy_sweep"))
    pilot, frame = inputs()
    sweep = Sweep(dsp.demod_frame(frame, pilot, CP))
    if args.mesh_legs:
        mesh_legs(sweep, device)
    else:
        unsharded_legs(sweep, device)
    if sweep.failures:
        print(f"[sweep] FAILED: {', '.join(sweep.failures)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
