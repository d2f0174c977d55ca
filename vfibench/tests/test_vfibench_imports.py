"""What the harness loads: a run of it imports neither JAX nor the JAX
package fldrx (top-level names compared whole: fldrx_torch is the port),
and the plain reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "fldrx"}

_DRY_RUN = """
import json, sys, tempfile
sys.path[:0] = [{root!r}, {tests!r}]
import torch
torch.set_num_threads(2)
from conftest import make_tiny
from vfibench import run
here = make_tiny(tempfile.mkdtemp())
for cell in ("tiny_pairs", "tiny_train"):
    run.run_cell(cell, 123, 0.5, True, device="cpu", here=here)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_dry_run_imports_no_jax_and_no_fldrx():
    code = _DRY_RUN.format(root=ROOT, tests=os.path.dirname(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "fldrx_torch" in top and "vfibench" in top
    assert not top & FORBIDDEN, sorted(top & FORBIDDEN)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def _sources(sub):
    base = os.path.join(ROOT, "vfibench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name, line in _imports(path):
            assert name not in FORBIDDEN | {"fldrx_torch"}, (path, line)


def test_no_harness_source_imports_jax_or_fldrx():
    for path in _sources(""):
        for name, line in _imports(path):
            assert name not in FORBIDDEN, (path, line)
