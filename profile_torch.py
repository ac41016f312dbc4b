"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 profile_torch.py [--size 1000] [--points 32] [--maps]
                             [--polygons | --regions N | --advanced |
                              --one-to-all | --all-to-one | --network |
                              --scale] [--trace PATH]

Runs the bench.py job (seed 42, size x size conductance raster with ~10%
NODATA, `points` focal points, cg+amg, single precision, shortcut mode;
with --maps, the cumulative and max current maps on, which solves every
pair; with --polygons, chip_smoke.py's 20 short-circuit polygons; with
--regions N, its focal-region job with N regions on points 1..N; with
--advanced, its advanced job on the 32 points: 16 sources, 8 finite and
8 direct grounds, voltage and current maps; with --one-to-all or
--all-to-one, that scenario on the points, maps off unless --maps;
with --network, chip_smoke.py's network pairwise job, the 100,000-node
lattice with 20 focal nodes, on the iterative tier of the general
sparse-graph path: CS_NETWORK_DIRECT_MAX=0; with --scale, chip_smoke.py's
scale job, bench_scale.py's 6930 x 6930 raster with 4 points, which
takes the host-built hierarchy unless CS_DEVICE_MG_MAX is set above its
49.6M padded cells)
through circuitscape_tpu_torch.compute(..., "cuda"): one warm run, then
one run under torch.profiler.  Prints, as JSON lines:
  - the job's wall time, host-timer sections and solver stats;
  - device time per kernel name (sum and count) over the run: the 25
    largest, and each of the port's seven kernels under its wrapper's
    name; the device's busy time (union of kernel intervals) and its
    idle share of the run's wall time;
and, given --trace, writes the Chrome trace there.  Fails without a
CUDA device.
"""

import argparse
import json
import os
import re
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402


def _busy_us(events):
    """Union length of the device kernel intervals, microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("--points", type=int, default=32)
    ap.add_argument("--maps", action="store_true",
                    help="write the cumulative and max current maps")
    ap.add_argument("--polygons", action="store_true",
                    help="add chip_smoke.py's short-circuit polygons")
    ap.add_argument("--regions", type=int, default=0,
                    help="focal regions on the first N points instead")
    ap.add_argument("--advanced", action="store_true",
                    help="chip_smoke.py's advanced job instead")
    ap.add_argument("--one-to-all", dest="scenario", action="store_const",
                    const="one-to-all", default="pairwise")
    ap.add_argument("--all-to-one", dest="scenario", action="store_const",
                    const="all-to-one")
    ap.add_argument("--network", action="store_true",
                    help="chip_smoke.py's network pairwise job instead, "
                    "on the iterative tier")
    ap.add_argument("--scale", action="store_true",
                    help="chip_smoke.py's 48M-cell scale job instead")
    ap.add_argument("--trace", default="",
                    help="write the Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device available", file=sys.stderr)
        return 2

    import circuitscape_tpu_torch as cst
    from chip_smoke import (card_line, make_advanced_job, make_job,
                            make_network_job, make_polygon_job,
                            make_regions_job, make_scale_job, SCALE_SIDE)
    from circuitscape_tpu_torch import stats
    from circuitscape_tpu_torch.solve import cuda_stencil as cs
    from circuitscape_tpu_torch.timer import CSTIMER
    from torch.profiler import ProfilerActivity, profile

    print(card_line(), flush=True)
    scratch = os.path.join(HERE, "build", "profile")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        if args.polygons:
            cfg, _, _ = make_polygon_job(d, args.size, args.size,
                                         args.points)
        elif args.regions:
            cfg = make_regions_job(d, args.size, args.size, args.regions)
        elif args.advanced:
            cfg, _, _, _ = make_advanced_job(d, args.size, args.size)
        elif args.network:
            cfg = make_network_job(d)
            os.environ["CS_NETWORK_DIRECT_MAX"] = "0"
        elif args.scale:
            cfg, _ = make_scale_job(d)
        else:
            cfg, _ = make_job(d, args.size, args.size, args.points)
            cfg["scenario"] = args.scenario
        if args.maps:
            cfg.update(write_cum_cur_map_only="True",
                       write_max_cur_maps="True")
        cst.compute(cfg, device="cuda")           # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cst.compute(cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        timers = {"/".join(p): round(t, 6)
                  for p, (n, t) in sorted(CSTIMER._data.items())}
        st = stats.finalize()

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        s = by_name.setdefault(e.name, [0.0, 0])
        s[0] += e.time_range.end - e.time_range.start
        s[1] += 1
    busy = _busy_us(kernels) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the port's own kernels, each under its wrapper's name, whatever
    # their rank (a kernel name holds "<name>_kernel" or "<name>_kernel<R>")
    port = {}
    for k, (us, n) in by_name.items():
        m = re.search(r"::(\w+)_kernel\b", k)
        if m and m.group(1) in cs.LAUNCHES:
            s = port.setdefault(m.group(1), [0.0, 0])
            s[0] += us / 1e3
            s[1] += n
    print(json.dumps({"size": SCALE_SIDE if args.scale else args.size,
                      "points": 4 if args.scale else args.points,
                      "maps": args.maps, "polygons": args.polygons,
                      "regions": args.regions,
                      "scenario": "advanced" if args.advanced else
                      "network" if args.network else
                      "scale" if args.scale else args.scenario,
                      "wall_s": wall, "timers_s": timers,
                      "cg_iters": st.get("cg_iters"),
                      "solve_s": st.get("solve_s"),
                      "mg_build": st.get("mg_build"),
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}))
    print(json.dumps({"device_busy_s": busy,
                      "device_idle_share": 1.0 - busy / wall,
                      "n_kernels": len(kernels),
                      "port_kernels_ms": {k: [round(v[0], 4), v[1]]
                                          for k, v in sorted(port.items())},
                      "kernels_ms": {k: [round(v[0] / 1e3, 4), v[1]]
                                     for k, v in top[:25]}}))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
