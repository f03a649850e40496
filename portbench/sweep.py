"""The open loop's knee: the slot latency at each number of sectors a batch.

  python3 portbench/sweep.py --config nr100_64t_4096 --traffic slots_open
      --sectors 2,4,8 [--period-us P] [--slots-per-sector S] [--seconds 3]

For each count of sectors, one untraced run of the configuration under the
open-loop traffic file with ``sectors`` set to it (and the period and the
slots a sector, where given): the 95th percentile of the slot latency, its
median over the first and the last tenth of the batches due, which parts a
growing backlog from a steady one, and the batches missing; then one traced
run: the device's idle share, the generator's lag, the host's time a call.
One JSON line a count.  A cell takes about four fifths of the highest count
whose 95th percentile stays within one period with no growing backlog.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
if str(BENCH_DIR.parent) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR.parent))

E2E = [{"name": "slot_latency_p95_us", "unit": "us"}]
LAYER = [{"name": n, "unit": u} for n, u in (("device_idle_pct.slot", "%"),
                                             ("host_call_us.slot", "us"),
                                             ("generator_lag_p95_us", "us"))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True, help="an open-loop traffic file's name")
    ap.add_argument("--sectors", required=True, help="comma-separated counts of sectors")
    ap.add_argument("--period-us", type=float, default=None)
    ap.add_argument("--slots-per-sector", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spec

    cell = spec.make_cell("sweep", args.config, args.traffic, E2E, LAYER)
    device = torch.device("cuda", 0)
    for n in (int(s) for s in args.sectors.split(",")):
        override = {"sectors": n}
        if args.period_us:
            override["period_us"] = args.period_us
        if args.slots_per_sector:
            override["slots_per_sector"] = args.slots_per_sector
        row = dict(override)
        for traced in (False, True):
            out = harness.run_cell(cell, args.seed + n, args.seconds, traced, device=device,
                                   started=time.perf_counter(), traffic_override=override)
            row.update({k: v["value"] for k, v in out["result"]["metrics"].items()})
            row["correct_traced" if traced else "correct"] = out["result"]["correct"]
            if not traced:
                rec = out["record"]
                late = [(d - u) / 1e3 for u, d in zip(rec.due_ns, rec.done_ns) if d is not None]
                tenth = max(1, len(late) // 10)
                row.update(first_tenth_median_us=statistics.median(late[:tenth]),
                           last_tenth_median_us=statistics.median(late[-tenth:]),
                           missing=rec.calls - rec.done)
            else:
                dev = out["result"]["device"]
                row["busy_s"], row["window_s"] = dev.get("busy_s"), dev.get("window_s")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
