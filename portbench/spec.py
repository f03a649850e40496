"""Find a cell, its configuration, its traffic mix and its metrics by name.

``BENCHMARK.json`` at the root says which configuration and traffic mix a
cell runs and which metrics it reports; the files they name sit under the
benchmark's folder.  Nothing here knows a cell by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json, with "name"
    traffic: dict         # traffic/<traffic>.json, with "name"
    end_to_end: List[dict]
    per_layer: List[dict]


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_spec(root: Path) -> dict:
    """BENCHMARK.json of the checkout at ``root``."""
    return load_json(Path(root) / "BENCHMARK.json")


def reports(metric: dict, cell: str, end_to_end: List[dict]) -> bool:
    """True when ``cell`` reports ``metric``: it lists the cell under
    "workloads", or it has no such list and the cell reports what it moves
    (a per-layer metric) or it applies everywhere (an end-to-end one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = metric.get("moves")
    if moved is None:
        return True
    return any(m["name"] == moved and reports(m, cell, []) for m in end_to_end)


def make_cell(name: str, config: str, traffic: str, end_to_end: List[dict],
              per_layer: List[dict], chips: int = 1, bench_dir: Path = BENCH_DIR) -> Cell:
    """A cell of configs/<config>.json under traffic/<traffic>.json."""
    cfg = dict(load_json(Path(bench_dir) / "configs" / f"{_checked(config)}.json"), name=config)
    mix = dict(load_json(Path(bench_dir) / "traffic" / f"{_checked(traffic)}.json"), name=traffic)
    return Cell(name, int(chips), cfg, mix, end_to_end, per_layer)


def find_cell(spec: dict, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell that BENCHMARK.json names, with the metrics it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    if w["config"] not in {c["name"] for c in spec["configs"]}:
        raise KeyError(f"workload {name!r} names config {w['config']!r}, not in BENCHMARK.json")
    e2e = [m for m in spec["end_to_end"] if reports(m, name, [])]
    layer = [m for m in spec["per_layer"] if reports(m, name, spec["end_to_end"])]
    return make_cell(name, w["config"], w["traffic"], e2e, layer, w["chips"], bench_dir)


def _load_module(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod_name = "portbench_" + tag + "_" + re.sub(r"[^A-Za-z0-9_]", "_", path.stem)
    found = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(found)
    found.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read(run)`` of metrics/<name>.py."""
    return _load_module(Path(bench_dir) / "metrics" / f"{_checked(name)}.py", "metric").read


def reference(config: dict, bench_dir: Path = BENCH_DIR):
    """The plain reference module that the configuration names."""
    return _load_module(Path(bench_dir) / "references" / f"{_checked(config['reference'])}.py",
                        "reference")


def read_metrics(metrics: List[dict], run, bench_dir: Path = BENCH_DIR) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader found a value."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = metric_reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
