"""Nothing the benchmark loads is JAX or the JAX package, top-level
names compared whole, and the reference loads nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

from kmbench import cells, run

FORBIDDEN = {"jax", "jaxlib", "flax", "kmtricks_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=cells.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_traffic, tmp_path):
    path, _t = tiny_traffic
    code = f"""
import json, os, sys
os.environ["TMPDIR"] = {str(tmp_path)!r}
from kmbench import cells, run
cell = cells.load_cell("count31.isolates")
cell.update(traffic_path={path!r}, traffic_spec=json.load(open({path!r})),
            args=["--max-memory", "1"])
r = run.run_cell(cell, 3, 0.2, True, device="cpu")
assert r["correct"], r
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _modules(code)
    assert "kmtricks_tpu_torch" in top and not top & FORBIDDEN


def test_the_run_check_compares_whole_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "kmtricks_tpu_torch_x",
                        types.ModuleType("kmtricks_tpu_torch_x"))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "kmtricks_tpu", raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kmtricks_tpu.core",
                        types.ModuleType("kmtricks_tpu.core"))
    assert run.forbidden_modules() == ["kmtricks_tpu"]


def test_reference_loads_nothing_of_the_program():
    top = _modules("import json, sys\n"
                   "import kmbench.reference, kmbench.reference.kmers\n"
                   "import kmbench.reference.layout, kmbench.control\n"
                   "print(json.dumps(sorted({m.split('.')[0] "
                   "for m in sys.modules})))")
    assert not top & (FORBIDDEN | {"kmtricks_tpu_torch"})


def test_no_source_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(cells.HERE, "**", "*.py"),
                          recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
                if os.sep + "reference" + os.sep in path:
                    assert n.split(".")[0] != "kmtricks_tpu_torch", path
