"""Helpers of the benchmark's CPU tests."""

import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# At 200^2 the program reads at most 2.3e-6 (resistances) and 6.8e-6
# (maps) and the TF32 control at least 1.56e-4 and 1.25e-4 (CPU, 8 seeds
# and 2): the cells' limits, set at 1M cells and more, would pass the
# control here, so the tiny cell states its own.
TINY = {"nrows": 200, "ncols": 200, "focal_points": 6, "landscapes": 2,
        "check_jobs": 2,
        "limits": {"resistance_rel": 2e-5, "cum_map_rel": 3e-5,
                   "max_map_rel": 3e-5}}


def make_tiny_tree(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with a 200 x 200 config
    `tiny` (6 points) and a cell per traffic mix on it:
    tiny.resistances and tiny.cum_max_maps.  Returns (root, bench)."""
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(root / "benchmark" / "configs" / "testarea1_1M.json") as f:
        cfg = json.load(f)
    cfg.update(TINY)
    with open(root / "benchmark" / "configs" / "tiny.json", "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": ["nrows", "ncols"], "why": "test"})
    for traffic in ("resistances", "cum_max_maps"):
        name = f"tiny.{traffic}"
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"testarea1_1M.{traffic}" in m.get("workloads", ()):
                m["workloads"].append(name)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f, indent=1)
    return root, bench


def run_tiny(root, bench, name, seconds=1.0, trace=False, seed=20260517):
    """run_cell of the tree at root on the CPU (no look for a card)."""
    from benchmark import run
    run.quiet_environment(str(root))
    return run.run_cell(str(root), bench, name, seed, seconds, trace, "cpu",
                        time.perf_counter(),
                        base=os.path.join(str(root), "benchmark"))
