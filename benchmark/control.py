"""The control of the comparison that decides `correct`: the plain
reference put in the program's place, computed in TF32 (the precision
below the float32 with TF32 off that the port runs), held against the
float64 reference by the same comparison and limits as a run.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3

For each seed it writes the cell's inputs as a run does, takes the
cell's first `check_jobs` jobs, and prints one JSON line with the worst
of each number compared over them, its limit, and whether the control
passed (it must not).  Runs on the card where there is one, else on the
CPU.  Benchmark runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT


def control_numbers(root, bench, name, seed, device, base=None):
    """(numbers, limits) of the control on the cell's first check_jobs
    jobs of `seed`."""
    from benchmark import cells, check, inputs
    base = base or os.path.join(root, "benchmark")
    w = cells.workload(bench, name)
    config = cells.config(bench, root, w["config"])
    traffic = cells.traffic(w["traffic"], base)
    kinds = traffic["compare"]
    limits = dict(traffic["limits"], **config.get("limits", {}))
    ref_mod = check.reference(config["reference"])
    tmp = tempfile.mkdtemp(prefix="cs-control-")
    try:
        files = inputs.JobInputs(tmp, config, traffic, seed, base)
        opts = check.graph_options(config)
        readings = []
        for k in range(config["check_jobs"]):
            _, habitat, points = files.job(k)
            maps = "cum_curmap" in kinds
            ref = ref_mod.pairwise(habitat, points, device=device, maps=maps,
                                   **opts)
            ctl = ref_mod.pairwise(habitat, points, device=device, maps=maps,
                                   control=True, **opts)
            got = {"resistances": ctl["resistances"]}
            if maps:
                got.update(cum_curmap=ctl["cum"], max_curmap=ctl["max"])
            readings.append(check.compare(got, ref, kinds))
        return check.worst(readings), limits
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    from benchmark import cells, check
    bench = cells.load_benchmark(ROOT)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers, limits = control_numbers(ROOT, bench, args.workload, seed,
                                          device)
        ok, rows = check.judge(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": device, "control_passed": ok,
                          "seconds": time.perf_counter() - t,
                          "numbers": {k: [v, lim] for k, v, lim in rows}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
