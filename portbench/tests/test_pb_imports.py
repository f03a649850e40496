"""No run loads ``jax`` or the JAX package, compared by whole top-level
names; the reference loads nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO
from portbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "ofdm_ls_mrc_tpu"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ofdm_ls_mrc_tpu_torch_lookalike", sys)
    assert "ofdm_ls_mrc_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ofdm_ls_mrc_tpu.ops", sys)
    assert "ofdm_ls_mrc_tpu" in run.forbidden_modules()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    for path in spec.BENCH_DIR.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_references_import_nothing_of_the_port():
    for path in (spec.BENCH_DIR / "references").glob("*.py"):
        assert "ofdm_ls_mrc_tpu_torch" not in set(_imports(path)), path


_RUN = """
import json, sys
sys.path[:0] = [{repo!r}, {tests!r}]
from conftest import run_tiny
from pathlib import Path
from portbench import run, spec
out = run_tiny(Path({root!r}), Path({bench!r}), {cell!r}, traced={traced})
ref = spec.reference({{"reference": "ls_mrc"}})
print(json.dumps({{"found": run.forbidden_modules(),
                  "loaded": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "correct": out["result"]["correct"]}}))
"""


@pytest.mark.parametrize("cell,traced", [("tiny.capture", False), ("tiny.open", True)])
def test_a_run_loads_no_jax(tiny, cell, traced):
    root, bench = tiny
    code = _RUN.format(repo=str(REPO), tests=str(Path(__file__).parent), root=str(root),
                       bench=str(bench), cell=cell, traced=traced)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["found"] == [] and got["correct"]
    assert not set(got["loaded"]) & FORBIDDEN
    assert "ofdm_ls_mrc_tpu_torch" in got["loaded"]


def test_the_reference_alone_loads_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); from portbench import spec; "
            "spec.reference({'reference': 'ls_mrc'}); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"ofdm_ls_mrc_tpu_torch"})
