"""No part of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program: read from the sources (every
import statement's top-level name, compared whole) and from sys.modules
after a run on the CPU."""

import ast
import os
import subprocess
import sys

import pytest

from helpers import ROOT

BENCH_DIR = os.path.join(ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "circuitscape_tpu"}
PROGRAM = "circuitscape_tpu_torch"


def _sources(folder):
    for d, _, names in os.walk(folder):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args and
              isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(BENCH_DIR)),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_sources_import_no_jax(path):
    names = set(_top_names(path))
    assert not names & JAX
    if os.sep + "reference" + os.sep in path:
        assert PROGRAM not in names


def test_whole_names_compared():
    """The program's name begins with the JAX package's: a prefix test
    would flag it."""
    sys.path.insert(0, ROOT)
    from benchmark import run
    sys.modules.setdefault("circuitscape_tpu_torch_probe", object())
    try:
        assert "circuitscape_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["circuitscape_tpu_torch_probe"]


RUN = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import pathlib
import torch
torch.set_num_threads(1)
from helpers import make_tiny_tree, run_tiny
root, bench = make_tiny_tree(pathlib.Path({tmp!r}))
result, _ = run_tiny(root, bench, "tiny.resistances")
from benchmark import run
print(json.dumps({{"correct": result["correct"],
                  "found": run.forbidden_modules(),
                  "program": "circuitscape_tpu_torch" in sys.modules}}))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import pathlib
from benchmark import inputs
from benchmark.reference import grid_pairwise as gp
from helpers import TINY
cfg = json.load(open({cfg!r}))
cfg.update(TINY)
files = inputs.JobInputs({tmp!r}, cfg, {{"scenario": "pairwise",
                                         "options": {{}}}}, 3, {base!r})
_, habitat, points = files.job(0)
gp.pairwise(habitat, points, maps=True, resistances=True, avg_res=True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_run_loads_no_jax(tmp_path):
    import json
    got = json.loads(_python(RUN.format(
        root=ROOT, tests=os.path.dirname(__file__), tmp=str(tmp_path))))
    assert got == {"correct": True, "found": [], "program": True}


def test_reference_loads_no_program(tmp_path):
    import json
    names = set(json.loads(_python(REF.format(
        root=ROOT, tests=os.path.dirname(__file__), tmp=str(tmp_path),
        base=BENCH_DIR,
        cfg=os.path.join(BENCH_DIR, "configs", "testarea1_1M.json")))))
    assert not names & (JAX | {PROGRAM})
    assert "torch" in names
