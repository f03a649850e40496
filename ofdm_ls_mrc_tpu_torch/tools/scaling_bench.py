"""Antenna- and time-scaling of the sharded receiver, with its collective
structure (BASELINE.json metric 2; the port's counterpart of the repo's
``tools/scaling_bench.py``).

Runs ``ShardedUplinkReceiver`` over a growing mesh axis, one process a rank
(``--worker``) on a ``file://`` store, and prints a row a shard count:
µs per frame (rank 0's device time through ``utils.profiling.device_time``;
on the CPU the host clock), µs per call (CUDA events around back-to-back
calls; on the CPU the host clock), total and per-rank samples/s, and the
efficiency against the first row that survived (labelled with its shard
count).  Every rank runs each call in lockstep with rank 0 (a one-word
gloo all-reduce on the host before each call, outside the device time).

Backends: NCCL at world size 1 on the card; more ranks on one card take
gloo (NCCL refuses two ranks a device), and so does the CPU
(``--device cpu``; ``--virtual N`` is ``--device cpu`` with up to N
ranks).  Rows of several ranks on one card say so (``one_card``): they
show structure, not scaling.

The structure record reads ``parallel/collectives.py``'s counts of one
call of the measured entry against ``expected_payload_words``: one
all-reduce of 2·S_l·(F−1) + F fp32 words a frame for 'fused' (the JAX
package's payload is (2·S_l + 1)·F: the port sums the numerator in
reference order, DC dropped, so 2·S_l words fewer; 'fast' sums in permuted
order and carries the JAX payload), the same at every ant-shard count,
and the time axis adds no collective (S_l = data symbols a time shard).

Run:  python -m ofdm_ls_mrc_tpu_torch.tools.scaling_bench --shards 1 --antennas 64      # NCCL
      python -m ofdm_ls_mrc_tpu_torch.tools.scaling_bench --shards 1,2 --backend gloo --antennas 64
      python -m ofdm_ls_mrc_tpu_torch.tools.scaling_bench --virtual 8 --antennas 4 --fft 64 --symbols 9
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from . import ranks

WALL_S = 300                 # every rank of a row is killed at this limit


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shards", default="1,2,4,8",
                    help="comma list of shard counts for the swept axis")
    ap.add_argument("--axis", default="ant", choices=["ant", "time"],
                    help="'ant' (antenna-sharded MRC, one all-reduce) or 'time' "
                         "(symbol blocks, no collective of its own)")
    ap.add_argument("--entry", default="split", choices=["split", "whole"],
                    help="split: demod_pilot_data on the rank's pilot and data blocks; "
                         "whole: demod_frame on the rank's pilot-headed mini-frame")
    ap.add_argument("--virtual", type=int, default=0, metavar="N",
                    help="--device cpu with up to N ranks over gloo")
    ap.add_argument("--antennas", type=int, default=16)
    ap.add_argument("--fft", type=int, default=1024)
    ap.add_argument("--symbols", type=int, default=101)
    ap.add_argument("--batch", type=int, default=2, help="device-resident frames a measurement")
    ap.add_argument("--reps", type=int, default=3,
                    help="profiled passes over the batch (on the CPU: best of)")
    ap.add_argument("--pipeline", default="fast", choices=["fast", "fused"],
                    help="shard body ('fast': fft_impl='four_step')")
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or 'cpu'")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl at world size 1 on the card, gloo otherwise")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON record to FILE (no default)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    for flag in ("--store", "--mesh", "--dir"):
        ap.add_argument(flag, help=argparse.SUPPRESS)
    for flag in ("--world", "--rank"):
        ap.add_argument(flag, type=int, help=argparse.SUPPRESS)
    return ap


def config(args):
    from ..config import FrameConfig

    return FrameConfig(num_antennas=args.antennas, fft_size=args.fft, cyclic_prefix=0,
                       frame_len=args.symbols)


def inputs(cfg, batch: int):
    """(pilot, frames [batch, S, A, F]) as the JAX bench draws them (seed 0)."""
    rng = np.random.default_rng(0)
    pilot = np.exp(2j * np.pi * rng.random(cfg.num_subcarriers)).astype(np.complex64)
    shape = (batch, cfg.frame_len, cfg.num_antennas, cfg.symbol_len)
    frames = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return pilot, frames


def worker(args) -> int:
    """One rank of ``args.mesh``; rank 0 writes the row to <dir>/row.json."""
    import torch
    import torch.distributed as dist

    from .. import parallel
    from ..ops.cplx import CArray
    from ..parallel import collectives
    from ..utils import profiling

    a_sh, t_sh = (int(v) for v in args.mesh.split("x"))
    device = torch.device(args.device)
    parallel.initialize(f"file://{args.store}", args.world, args.rank, args.backend)
    mesh = parallel.make_mesh(a_sh, t_sh)
    ctl = dist.new_group(backend="gloo") if args.world > 1 else None
    cfg = config(args)
    pilot, frames = inputs(cfg, args.batch)
    rx = parallel.ShardedUplinkReceiver(cfg, pilot, mesh, pipeline=args.pipeline,
                                        fft_impl="four_step" if args.pipeline == "fast" else None,
                                        device=device)
    blocks = frames[:, :, rx.ants]
    pilots = CArray.from_numpy(np.ascontiguousarray(blocks[:, 0]), device)
    data = CArray.from_numpy(np.ascontiguousarray(blocks[:, 1 + rx.syms.start:
                                                        1 + rx.syms.stop]), device)
    if args.entry == "whole":
        minis = CArray.from_numpy(np.ascontiguousarray(np.concatenate(
            [blocks[:, :1], blocks[:, 1 + rx.syms.start:1 + rx.syms.stop]], axis=1)), device)
        entry = lambda k: rx.demod_frame(minis[k])                       # noqa: E731
    else:
        entry = lambda k: rx.demod_pilot_data(pilots[k], data[k])        # noqa: E731

    def step(go: int) -> int:
        """Rank 0's word to the others: 1 = one more call, 0 = done."""
        flag = torch.tensor([go])
        dist.all_reduce(flag, group=ctl)
        return int(flag.item())

    if args.rank != 0:
        k = 0
        while step(0):
            entry(k % args.batch)
            k += 1
        dist.barrier()
        dist.destroy_process_group()
        return 0

    def call(k: int):
        if ctl is not None:
            step(1)
        return entry(k)

    d = profiling.device_time(call, list(range(args.batch)), reps=args.reps, device=device,
                              detail=True)
    per_call = profiling.call_time(lambda: call(0), 10 * args.batch, device)
    collectives.reset()
    call(0)
    count, words = collectives.signature()
    if ctl is not None:
        step(0)
    row = {"sec_per_frame": d["seconds_per_item"], "sec_per_call": per_call,
           "time_source": d["source"], "all_reduce_count": count,
           "all_reduce_fp32_words": words, "backend": dist.get_backend(),
           "launches": profiling.kernel_launches()}
    with open(os.path.join(args.dir, "row.json"), "w") as fh:
        json.dump(row, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_row(args, n: int, device, backend: str, workdir: str) -> dict:
    """Rank 0's row of an n-shard mesh on the swept axis."""
    mesh = f"{n}x1" if args.axis == "ant" else f"1x{n}"
    d = os.path.join(workdir, f"{args.axis}{n}")
    os.makedirs(d)
    common = ["--worker", "--store", os.path.join(d, "store"), "--world", n, "--mesh", mesh,
              "--dir", d, "--device", device, "--backend", backend,
              "--antennas", args.antennas, "--fft", args.fft, "--symbols", args.symbols,
              "--batch", args.batch, "--reps", args.reps, "--pipeline", args.pipeline,
              "--entry", args.entry]
    ranks.run_ranks([ranks.module_cmd("ofdm_ls_mrc_tpu_torch.tools.scaling_bench", *common,
                                      "--rank", r) for r in range(n)],
                    WALL_S, f"the {mesh} mesh")
    with open(os.path.join(d, "row.json")) as fh:
        return json.load(fh)


def structure_of(args, cfg, rows) -> dict:
    """The collective structure the rows counted, against the expectation."""
    from ..parallel import collectives

    key = f"{args.axis}_shards"
    n_hi = rows[-1][key]
    t_shards = n_hi if args.axis == "time" else 1
    s = {"axis": args.axis, "structure_entry": args.entry, "verified_at_shards": n_hi,
         "all_reduce_count": rows[-1]["all_reduce_count"],
         "all_reduce_fp32_words": rows[-1]["all_reduce_fp32_words"],
         "expected_fp32_words": collectives.expected_payload_words(
             cfg, t_shards, fast=args.pipeline == "fast"),
         # The JAX package's payload, (2 S_l + 1) F: 'fast''s own.
         "jax_payload_fp32_words": collectives.expected_payload_words(cfg, t_shards, fast=True)}
    s["difference_fp32_words"] = s["jax_payload_fp32_words"] - s["expected_fp32_words"]
    if args.axis == "ant":
        s["payload_constant_across_shards"] = all(
            (r["all_reduce_count"], r["all_reduce_fp32_words"])
            == (s["all_reduce_count"], s["all_reduce_fp32_words"]) for r in rows)
        s["also_verified_at_shards"] = [r[key] for r in rows[:-1]]
    else:
        s["time_axis_collective_free"] = all(r["all_reduce_count"] <= 1 for r in rows)
    return s


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker:
        return worker(args)
    from ..ops.cplx import resolve_device

    device = resolve_device("cpu" if args.virtual else args.device, "scaling_bench")
    shards = [int(s) for s in args.shards.split(",") if s]
    if args.virtual and max(shards) > args.virtual:
        raise SystemExit(f"need {max(shards)} ranks, --virtual allows {args.virtual}")
    if device.type == "cuda":
        from ..kernels import build

        build.load_library()    # once, before the ranks load it
    cfg = config(args)
    samples = cfg.frame_len * cfg.num_antennas * cfg.fft_size
    rows, t1, baseline_n = [], None, None
    with tempfile.TemporaryDirectory() as workdir:
        for n in shards:
            if args.axis == "ant" and cfg.num_antennas % n:
                print(f"skip {n} shards: {cfg.num_antennas} antennas not divisible")
                continue
            if args.axis == "time" and cfg.num_data_symbols % n:
                print(f"skip {n} shards: {cfg.num_data_symbols} data symbols not divisible")
                continue
            backend = args.backend or ("nccl" if device.type == "cuda" and n == 1 else "gloo")
            r = run_row(args, n, device.type, backend, workdir)
            t = r["sec_per_frame"]
            if not t:
                print(f"{args.axis}={n:2d}  device time not measured (no device event in "
                      f"the trace)", flush=True)
                continue
            if t1 is None:
                t1, baseline_n = t, n
            # Efficiency is labelled with the shard count of the first row
            # that survived, never taken for granted as 1.
            eff = (t1 * baseline_n) / (n * t)
            row = {f"{args.axis}_shards": n, "sec_per_frame": t, "sec_per_call": r["sec_per_call"],
                   "total_samples_per_sec": samples / t,
                   "samples_per_sec_per_rank": samples / t / n,
                   f"efficiency_vs_{baseline_n}shard": eff,
                   "all_reduce_count": r["all_reduce_count"],
                   "all_reduce_fp32_words": r["all_reduce_fp32_words"],
                   "backend": r["backend"], "one_card": device.type == "cuda" and n > 1,
                   "time_source": r["time_source"], "launches": r["launches"]}
            rows.append(row)
            print(f"{args.axis}={n:2d}  {t * 1e6:10.2f} us/frame  "
                  f"{r['sec_per_call'] * 1e6:10.2f} us/call  "
                  f"{samples / t / 1e9:8.2f} Gs/s total  {samples / t / n / 1e9:8.2f} Gs/s/rank  "
                  f"eff={eff * 100:6.1f}% (vs {baseline_n} shard)  "
                  f"all-reduce {r['all_reduce_count']} x {r['all_reduce_fp32_words']} words  "
                  f"[{r['backend']}{', one card' if row['one_card'] else ''}; "
                  f"{r['time_source']}]", flush=True)
    structure = structure_of(args, cfg, rows) if rows else None
    if structure:
        print(f"structure@{args.axis}={structure['verified_at_shards']} ({args.entry} entry): "
              f"{structure['all_reduce_count']} all-reduce, "
              f"{structure['all_reduce_fp32_words']} fp32 words (expected "
              f"{structure['expected_fp32_words']}; the JAX payload (2*S_l + 1)*F = "
              f"{structure['jax_payload_fp32_words']}: {structure['difference_fp32_words']} "
              f"words more" + (", the DC bin the port drops before the sum" if
                               structure["difference_fp32_words"] else "") + ")", flush=True)
    rec = {
        "metric": f"{'antenna' if args.axis == 'ant' else 'time'}_scaling",
        "axis": args.axis,
        "entry": args.entry,
        "pipeline": args.pipeline,
        "device": str(device),
        "virtual": bool(args.virtual),
        "config": {"antennas": args.antennas, "fft": args.fft, "symbols": args.symbols,
                   "batch": args.batch, "reps": args.reps},
        "structure": structure,
        "rows": rows,
    }
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
            fh.write("\n")
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
