"""The readings that the limit of ``out_err`` is set from, on the card.

  python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--calls N]

For each seed, in one process: the cell's inputs as a run makes them, then
``calls`` calls of the entry over the buffers in turn (as many as a run
compares), each output compared with the reference (``check.out_err``):
once with the program as the configuration states it (the lower reading)
and once with the control, the program's own bf16 speed mode
(``exact=False``), the nearest precision below float32 (the upper
reading).  One JSON line a seed, and a summary line last.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
if str(BENCH_DIR.parent) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR.parent))


def readings(cell, seed: int, calls: int, device, bench_dir: Path = BENCH_DIR) -> dict:
    """{"program": out_err, "control": out_err} of one seed of the cell."""
    import torch

    from portbench import check, harness, inputs, spec

    config, traffic = cell.config, cell.traffic
    reference = spec.reference(config, bench_dir)
    k = harness.frames_per_call(traffic)
    shape = (k, config["frame_len"], config["num_antennas"], config["fft_size"])
    gen = inputs.generator(seed, device)
    pilot = inputs.pilot(gen, config["fft_size"], device).to(torch.complex64)
    planes, _ = inputs.buffers(gen, int(traffic["buffers"]), shape,
                               float(traffic["backoff_db"]), device)
    bufs = [harness.carray(re, im) for re, im in planes]
    out = {}
    for mode, exact in (("program", bool(config["exact"])), ("control", False)):
        rx = harness.receiver(dict(config, exact=exact), pilot, device)
        outs = [(i % len(bufs), rx.demod_capture(bufs[i % len(bufs)])) for i in range(calls)]
        out[mode] = max(check.out_err(o.re, o.im, *planes[b], pilot, reference)
                        for b, o in outs)
        del rx, outs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--calls", type=int, default=None,
                    help="outputs compared a seed (default: the traffic's sample_calls)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from portbench import spec

    cell = spec.find_cell(spec.load_spec(Path.cwd()), args.workload)
    calls = args.calls or int(cell.traffic["sample_calls"])
    device = torch.device(args.device)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, calls, device)
        rows.append(r)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "program_max": max(r["program"] for r in rows),
                      "control_min": min(r["control"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
