"""Antenna-sharded MRC over a mesh of ranks: the multi-rank path on 8
processes (the port's counterpart of the repo's ``examples/03_sharded_mesh.py``,
whose geometry, seeds, lines and threshold it keeps).

The MRC reduction is the cross-rank collective: each antenna shard computes
its local FFT + LS + MRC numerator, then ONE all-reduce carries (num_re,
num_im, sum|h|^2) over the ``ant`` axis of the mesh (the reference's
antenna tree-reduction, gpuLS.cu:247-259, across processes).  The ranks are
processes of this example (``--worker``) on a ``file://`` store over gloo,
on the card (NCCL refuses two ranks a device) or the CPU, every rank killed
at a wall limit: a 4 x 2 (ant x time) mesh demodulates a 16-antenna frame,
then the same 8 ranks as an 8 x 1 mesh run the per-symbol streaming path,
one all-reduce a symbol.

  python -m ofdm_ls_mrc_tpu_torch.examples.sharded_mesh [--device cpu]
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

RANKS = 8
WALL_S = 200                 # every rank is killed at this limit


def inputs():
    """(cfg, pilot, data, rx_frame) of the example."""
    from ofdm_ls_mrc_tpu_torch import FrameConfig
    from ofdm_ls_mrc_tpu_torch.sim import ChannelModel, make_tx_frame, random_symbols

    # 4 antenna shards x 2 time shards; 16 antennas -> 4 a shard.
    cfg = FrameConfig(num_antennas=16, fft_size=256, cyclic_prefix=32, frame_len=9)
    rng = np.random.default_rng(3)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    data, _ = random_symbols(rng, (cfg.num_data_symbols, cfg.num_subcarriers))
    rx_frame = ChannelModel(cfg.num_antennas, cfg.fft_size, num_taps=8, snr_db=30.0,
                            seed=5).apply(make_tx_frame(data, pilot, cfg.cyclic_prefix),
                                          cfg.cyclic_prefix)
    return cfg, pilot, data, rx_frame


def worker(args) -> int:
    """One rank: its rows of the 4 x 2 whole frame and of the 8 x 1 stream,
    written to <out>/rank<R>.npz."""
    import torch.distributed as dist

    from ofdm_ls_mrc_tpu_torch import parallel
    from ofdm_ls_mrc_tpu_torch.utils import profiling

    parallel.initialize(f"file://{args.store}", RANKS, args.rank, "gloo")
    cfg, pilot, _, rx_frame = inputs()
    mesh = parallel.make_mesh(ant_shards=4, time_shards=2)
    rx = parallel.ShardedUplinkReceiver(cfg, pilot, mesh, device=args.device)
    res = {"ant_index": mesh.ant_index, "time_index": mesh.time_index,
           "pipeline": rx.pipeline, "whole": rx.demod_frame(rx_frame).to_numpy()}

    # Low-latency variant: the antenna-sharded per-symbol streaming path,
    # the estimate kept per shard, one all-reduce a symbol.
    sd = parallel.ShardedStreamingDemodulator(cfg, pilot, parallel.make_mesh(8, 1),
                                              pipeline="fast", fft_impl="four_step",
                                              device=args.device)
    sd.push_pilot(rx_frame[0])
    res["stream"] = np.stack([sd.push_symbol(s).to_numpy() for s in rx_frame[1:]])
    res["launches"] = json.dumps(profiling.kernel_launches())
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or 'cpu'")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)

    from ofdm_ls_mrc_tpu_torch.ops.cplx import resolve_device
    from ofdm_ls_mrc_tpu_torch.sim import evm_db
    from ofdm_ls_mrc_tpu_torch.tools import ranks
    from ofdm_ls_mrc_tpu_torch.utils import profiling

    device = resolve_device(args.device, "sharded_mesh")
    if device.type == "cuda":
        from ofdm_ls_mrc_tpu_torch.kernels import build

        build.load_library()    # once, before the ranks load it
    with tempfile.TemporaryDirectory() as d:
        ranks.run_ranks([ranks.module_cmd("ofdm_ls_mrc_tpu_torch.examples.sharded_mesh",
                                          "--worker", "--store", os.path.join(d, "store"),
                                          "--out", d, "--rank", r, "--device", device.type)
                         for r in range(RANKS)], WALL_S, "the 4 x 2 mesh")
        res = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(RANKS)]
    _, _, data, _ = inputs()
    # The whole frame as a user reads it: ant row 0's time blocks in order.
    row = sorted((r for r in res if int(r["ant_index"]) == 0), key=lambda r: int(r["time_index"]))
    out = np.concatenate([r["whole"] for r in row])
    evm = evm_db(np.fft.fftshift(out, axes=-1), data)
    print(f"mesh={{'ant': 4, 'time': 2}} pipeline={res[0]['pipeline']}  EVM={evm:.1f} dB")
    evm_s = evm_db(np.fft.fftshift(res[0]["stream"], axes=-1), data)
    print(f"per-symbol streaming over 8 ant shards: EVM={evm_s:.1f} dB")
    launches = {}
    for r in res:
        for k, v in json.loads(str(r["launches"])).items():
            launches[k] = launches.get(k, 0) + v
    print(profiling.LAUNCH_LINE + json.dumps(launches))
    ok = evm < -25.0 and evm_s < -25.0
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
