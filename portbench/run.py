"""Run one cell of the benchmark and print its result as the last line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
from a profiled window.  Without a CUDA device, or with fewer than the cell
asks for, it exits non-zero and prints no result; so it does if a module of
``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the window
has closed.  The numbers compared with the reference are the last lines on
standard error and the last key of the result.
"""

from __future__ import annotations

import time

_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ofdm_ls_mrc_tpu")
CACHE_DIR = ROOT / ".portbench_cache"     # fixed: a cache that moves never hits


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    started = _TOP - process_age_s()
    args = parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)
    if str(BENCH_DIR.parent) not in sys.path:
        sys.path.insert(0, str(BENCH_DIR.parent))
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))

    import torch

    from portbench import harness, spec

    cell = spec.find_cell(spec.load_spec(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device=torch.device("cuda", 0), started=started)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}; clipped components: {out['clipped']}; "
          f"outputs compared: {out['compared']}", file=sys.stderr)
    for line in check_lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(result_line(out))
    return 0


def check_lines(checks: dict) -> list:
    """Each number compared beside its limit, one line each."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]


def result_line(out: dict) -> str:
    """The result as one JSON line, the numbers compared under the last key."""
    return json.dumps({**out["result"], "checks": out["checks"]})


if __name__ == "__main__":
    sys.exit(main())
