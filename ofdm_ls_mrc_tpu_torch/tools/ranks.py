"""Ranks as processes: start one process a rank, wait for all of them, and
kill them all at a wall limit.

A rank that dies leaves the others blocked in a collective, so every
multi-rank run of the port's tools and examples goes through ``run_ranks``:
at the limit every rank still running is killed and the run raises.  The
ranks meet on a ``file://`` store the caller names (no TCP port to race
for).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from typing import List, Sequence

REPO = Path(__file__).resolve().parents[2]


def module_cmd(module: str, *args) -> List[str]:
    """``python -m <module> <args>`` as a command list."""
    return [sys.executable, "-m", module, *map(str, args)]


def run_ranks(cmds: Sequence[Sequence[str]], wall_s: float, what: str) -> List[str]:
    """Run each command as a process from the repo's root, all at once;
    return their outputs (stdout and stderr together) in rank order.  At
    ``wall_s`` seconds every rank still running is killed and RuntimeError
    raised; a rank that exits nonzero raises with its output."""
    procs = [subprocess.Popen(list(c), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=wall_s)[0] for p in procs]
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"a rank of {what} passed the {wall_s} s wall limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {what} exited {p.returncode}:\n{out}")
    return outs
