"""No module the harness loads is JAX or the JAX package, compared by whole
top-level names, and the references import nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from bench.lib import spec

PROBE = r"""
import sys
sys.argv = ["run.py"]
sys.path[:0] = [ROOT, ROOT + "/src"]
import bench.run as run
from bench.lib import spec, driver, check, trace, model, record
import repro_torch.core, repro_torch.serving, repro_torch.models
import repro_torch.data.tasks
for w in spec.load_benchmark()["workloads"]:
    spec.load_cell(w["name"])
print(run.forbidden_modules())
"""


def test_the_harness_loads_no_jax():
    code = "ROOT = %r\n" % str(spec.ROOT) + PROBE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_references_import_nothing_of_the_program():
    for path in (spec.ROOT / "bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("repro_torch", "repro", "jax"), \
                    (path.name, n)
